"""Codec constants and session configuration of the port (FORMAT.md).

The port's own copy of what it uses from `screenpressor_tpu/config.py`.
Every constant and the lane policy here are format-normative: the bytes of
every implementation derive from them. So, unlike the reference, this
module reads no environment variable: the reference's format-experiment
overrides (`SPTC_COLOR_CTX_BITS`, `SPTC_LANE_THIN`, `SPTC_MIX_*`) change
the bitstream without a version bump, and the port takes the defaults.
"""

from __future__ import annotations

import dataclasses

# Entropy coder
PROB_BITS = 14
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 23  # lower bound of the rANS normalization interval
STEP = 512  # adaptation increment
RESCALE_SHIFT = 13  # fixed-point shift of the scale-to-fill rescale factor

# Color context: ctx = ((a >> (8 - BITS_A)) << BITS_B) | (b >> (8 - BITS_B))
COLOR_CTX_BITS_A, COLOR_CTX_BITS_B = 8, 4
COLOR_CTX_ROWS = 1 << (COLOR_CTX_BITS_A + COLOR_CTX_BITS_B)
COLOR_CTX_SHIFT = 8 - COLOR_CTX_BITS_B
COLOR_CTX_SHIFT_A = 8 - COLOR_CTX_BITS_A

# Lane policy
K_MAX = 256
TARGET_PER_LANE = 256
LANE_THIN_FLOOR, LANE_THIN_MULT = 32, 16

# Frame header nibbles
SPTC_VERSION_NIBBLE = 0xA
ALG_FLAT = 1
ALG_I = 2
ALG_P = 3
ALG_RAW = 4  # uncompressed escape
ALG_FMT = 5  # pixel-format prefix chunk

# Frame types an encoder reports beside a frame's bytes (a raw escape is I)
FTYPE_I = 0
FTYPE_P = 1

BLOCK = 16  # block geometry of P frames
SEG_TILE = 1024  # I-frame segmentation tile of small frames

# Compact color-table encode buckets (shape only, not format-relevant)
COL_COMPACT_BUCKETS = (256, 1024)

# Pixel types
PT_LITERAL = 0
PT_LEFT = 1
PT_ABOVE = 2
PT_PREVFRAME = 3  # P frames only
PT_GRADIENT = 4
PT_ABOVELEFT = 5
NUM_PTYPES = 6

# Block types
BT_UNCHANGED = 0
BT_FULL_DATA = 1
BT_PARTIAL_DATA = 2
BT_FULL_MOTION = 3
BT_PARTIAL_MOTION = 4

MV_OFFSET = 256  # mv symbols are component + MV_OFFSET, alphabet 512
MAX_RUN = 255

# Table kinds: name -> (n_contexts, alphabet)
TABLE_KINDS = {
    "ptype": (NUM_PTYPES, NUM_PTYPES),
    "nrun": (NUM_PTYPES, 256),
    "color": (3 * COLOR_CTX_ROWS, 256),
    "bt": (1, 5),
    "btn": (1, 256),
    "sxy": (4, 16),
    "mvflag": (1, 2),
    "mv": (2, 512),
}

# Kinds whose rows mix with one global row per kind (FORMAT.md, SPTC3
# dynamic backoff); MIX_ESC_C sets the rows' fill target.
MIX_KINDS = ("color", "nrun")
MIX_ESC_C = 256


def kind_step(name: str) -> int:
    return STEP


def kind_mixed(name: str) -> bool:
    return name in MIX_KINDS


def kind_gstep(name: str) -> int:
    """Global-row adaptation increment of a mixed kind."""
    return kind_step(name)


def kind_globals(name: str) -> int:
    """Global rows of a mixed kind."""
    return 1


def seg_tile(n: int, w: int) -> int:
    """Segmentation tile of a frame of n pixels, width w (encoder policy):
    small frames keep SEG_TILE, large ones whole-row tiles near 16K
    pixels."""
    if n <= 128 * SEG_TILE:
        return SEG_TILE
    cap = min(16384, n // 64)
    rows = max(1, cap // w)
    return rows * w


def color_ctx(a, b):
    """Color context chain index from two conditioning bytes (ints or
    integer tensors)."""
    return ((a >> COLOR_CTX_SHIFT_A) << COLOR_CTX_BITS_B) | (b >> COLOR_CTX_SHIFT)


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def lane_count(n_records: int, k_max: int = K_MAX, target: int = TARGET_PER_LANE) -> int:
    """Interleaved rANS lanes of a section of n_records (FORMAT.md "Lane
    policy"). Sections of up to LANE_THIN_FLOOR * target records take
    next_pow2(ceil(n / target)) lanes. Larger ones thin to
    LANE_THIN_MULT * target records a lane, never below LANE_THIN_FLOOR
    lanes: each lane costs about 6 bytes of stream (state flush and size
    entry)."""
    if n_records <= 0:
        return 1
    k = next_pow2(-(-n_records // target))
    if k > LANE_THIN_FLOOR:
        k = max(LANE_THIN_FLOOR, next_pow2(-(-n_records // (LANE_THIN_MULT * target))))
    return min(k_max, k)


def lane_ranges(n_records: int, k: int) -> list[tuple[int, int]]:
    """Contiguous (start, length) per lane; lanes < n % k get one extra."""
    base, rem = divmod(n_records, k)
    out = []
    start = 0
    for i in range(k):
        ln = base + (1 if i < rem else 0)
        out.append((start, ln))
        start += ln
    return out


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Session configuration."""

    width: int
    height: int
    kf_interval: int = 500  # keyframe interval (0: first frame only)
    loss: int = 0  # bit-truncation loss 0..5
    # motion search ranges: +-axis scans and the dense window
    msr_x: int = 256
    msr_y: int = 256
    msr_low_x: int = 8
    msr_low_y: int = 8
    # lane policy (must match between encoder and decoder)
    k_max: int = K_MAX
    target_per_lane: int = TARGET_PER_LANE
    # serving profile: one lane count for every section
    k_fixed: int | None = None

    def lanes(self, n_records: int) -> int:
        if self.k_fixed is not None:
            return self.k_fixed
        return lane_count(n_records, self.k_max, self.target_per_lane)

    @property
    def nbx(self) -> int:
        return -(-self.width // BLOCK)

    @property
    def nby(self) -> int:
        return -(-self.height // BLOCK)
