"""The port's own copies of the format constants, the lane policy, the
session configuration and the container code (screenpressor_tpu_torch.config
/ .bitstream) against the reference's (screenpressor_tpu.config /
.bitstream): equal values, equal bytes, and no environment override."""

import dataclasses
import os
import subprocess
import sys

import pytest

from screenpressor_tpu import bitstream as ref_bs
from screenpressor_tpu import config as ref
from screenpressor_tpu.spec import codec as ref_codec
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import config as cfg

from tests.torch_support import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONSTANTS = sorted(n for n, v in vars(cfg).items()
                   if n.isupper() and isinstance(v, (int, tuple, dict)))


def test_constant_list_covers_the_format():
    for name in ("PROB_BITS", "RANS_L", "STEP", "COLOR_CTX_ROWS", "LANE_THIN_FLOOR",
                 "ALG_FMT", "SEG_TILE", "TABLE_KINDS", "MIX_KINDS", "MIX_ESC_C",
                 "BT_PARTIAL_MOTION", "PT_ABOVELEFT", "MV_OFFSET", "MAX_RUN"):
        assert name in CONSTANTS


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_reference(name):
    # the reference keeps the frame types beside its session (spec.codec)
    assert getattr(cfg, name) == getattr(ref_codec if name.startswith("FTYPE_") else ref, name)


@pytest.mark.parametrize("kind", sorted(ref.TABLE_KINDS))
def test_kind_policy_equals_reference(kind):
    for fn in ("kind_step", "kind_mixed", "kind_gstep", "kind_globals"):
        assert getattr(cfg, fn)(kind) == getattr(ref, fn)(kind), fn


# sizes around every tier of the lane policy, thinning (above 8,192
# records) included
SIZES = (0, 1, 2, 255, 256, 257, 511, 4096, 8191, 8192, 8193, 12000, 16384,
         65536, 65537, 90339, 131072, 262144, 1 << 20, 1 << 21, 2073600)


@pytest.mark.parametrize("n", SIZES)
def test_lane_policy_equals_reference(n):
    for k_max, target in ((256, 256), (64, 32), (512, 128)):
        assert cfg.lane_count(n, k_max, target) == ref.lane_count(n, k_max, target)
    k = cfg.lane_count(n)
    assert cfg.lane_ranges(n, k) == ref.lane_ranges(n, k)
    for k in (1, 3, 8, 32):
        assert cfg.lane_ranges(n % 5000, k) == ref.lane_ranges(n % 5000, k)
    assert cfg.next_pow2(n) == ref.next_pow2(n)


@pytest.mark.parametrize("hw", [(32, 48), (49, 67), (288, 512), (360, 640), (362, 361),
                                (720, 1280), (1080, 1920), (2160, 3840)])
def test_seg_tile_equals_reference(hw):
    h, w = hw
    assert cfg.seg_tile(h * w, w) == ref.seg_tile(h * w, w)


def test_color_ctx_equals_reference():
    for a in range(256):
        for b in range(0, 256, 7):
            assert cfg.color_ctx(a, b) == ref.color_ctx(a, b)


def test_codec_config_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(cfg.CodecConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(ref.CodecConfig)]
    assert ours == theirs
    r = ref.CodecConfig(width=1920, height=1080, k_fixed=64, msr_x=8)
    c = port_config(r)
    assert isinstance(c, cfg.CodecConfig)
    assert dataclasses.asdict(c) == dataclasses.asdict(r)
    assert (c.nbx, c.nby) == (r.nbx, r.nby)
    for n in (0, 5, 9000, 90339):
        assert c.lanes(n) == r.lanes(n)
        assert cfg.CodecConfig(1920, 1080).lanes(n) == ref.CodecConfig(1920, 1080).lanes(n)
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.width = 3


@pytest.mark.parametrize("case", [
    ("header_byte", (3,)), ("pack_format_prefix", (16, 0xF800, 0x07E0, 0x001F)),
    ("pack_format_prefix", (32,)), ("size_width", (255,)), ("size_width", (256,)),
    ("size_width", (70000,)), ("section_status_byte", (64, 2)),
    ("pack_section", ([b"ab", b"", b"c" * 300, b"d"],)), ("pack_varint", (0, 127, 128, 1 << 30)),
    ("pack_u32", (1, 0xFFFFFFFF)), ("pack_u16", (7, 65535)),
])
def test_bitstream_packers_equal_reference(case):
    fn, args = case
    assert getattr(bs, fn)(*args) == getattr(ref_bs, fn)(*args)


def test_bitstream_parsers_equal_reference():
    sec = ref_bs.pack_section([b"xy", b"", b"z" * 260, b"w"])
    assert bs.unpack_section(sec, 0, 4) == ref_bs.unpack_section(sec, 0, 4)
    v = ref_bs.pack_varint(5, 300, 1 << 28)
    assert bs.read_varint(v, 0, 3) == ref_bs.read_varint(v, 0, 3)
    u = ref_bs.pack_u32(9, 1 << 31) + ref_bs.pack_u16(4, 5)
    assert bs.read_u32(u, 0, 2) == ref_bs.read_u32(u, 0, 2)
    assert bs.read_u16(u, 8, 2) == ref_bs.read_u16(u, 8, 2)
    for pre in (ref_bs.pack_format_prefix(16, 1, 2, 3), ref_bs.pack_format_prefix(32), b"\xa2"):
        assert bs.parse_format_prefix(pre) == ref_bs.parse_format_prefix(pre)
    assert bs.parse_header_byte(0xA3) == ref_bs.parse_header_byte(0xA3) == 3
    with pytest.raises(bs.BadVersionError):
        bs.parse_header_byte(0x53)
    for bad in (sec[:5], b""):
        with pytest.raises(bs.CorruptStreamError):
            bs.unpack_section(bad, 0, 4)
    with pytest.raises(bs.CorruptStreamError):
        bs.unpack_section(sec, 0, 8)  # lane count mismatch
    with pytest.raises(bs.CorruptStreamError):
        bs.read_varint(b"\x80\x80", 0)


def test_environment_leaves_the_port_constants_unchanged():
    """The reference reads format overrides from the environment; the port
    reads none."""
    code = (
        "from screenpressor_tpu_torch import config as c\n"
        "print(c.LANE_THIN_FLOOR, c.LANE_THIN_MULT, c.COLOR_CTX_BITS_A,"
        " c.COLOR_CTX_BITS_B, c.COLOR_CTX_ROWS, c.MIX_KINDS, c.kind_globals('color'))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, SPTC_LANE_THIN="64,8",
               SPTC_COLOR_CTX_BITS="6,6", SPTC_MIX_KINDS_DEFAULT="color",
               SPTC_MIX_G3="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=60, check=True)
    assert out.stdout.split() == ["32", "16", "8", "4", "4096", "('color',", "'nrun')", "1"]
