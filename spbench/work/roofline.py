"""Roofline arithmetic of the port's kernels: the table of peaks, and the
bytes and operations that the SPTC format fixes for a call's inputs.

A frozen, reworked copy of `chip_smoke.py`'s `bound` (HBM_BYTES_PER_S,
SCALAR_OPS_PER_S) with new counts: chip_smoke's `sections_work` counted
K1's own algorithm from the port's tables, so a faster algorithm would
read a stale count. Here the count comes from the bitstream alone (the
container and section headers, FORMAT.md), and a kernel that does the
same work another way reads the same count:

- sections (K1 encodes them, K2 decodes them): each coded byte once and
  each record once (one byte a sub-symbol); one operation per alphabet
  entry of every sub-symbol a record codes, since the adaptive model's
  cumulative frequency of a symbol needs every entry below it and a
  decode's search reads them all. A motion vector record counts its
  same-as-previous flag only (whether the vector follows is not in the
  headers), so the count is a floor;
- the P analysis (K5): both frames' pixels once (3 B a pixel each), its
  outputs once (10 B a block: change flag, sub-rect, flat flag, motion
  choice) and one compare per channel byte of the frame.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, data sheet
SCALAR_OPS_PER_S = 67e12  # NVIDIA H100 SXM, float32 outside the tensor cores
BLOCK = 16

# record kind -> sub-symbol alphabets (FORMAT.md "Sections")
SUBSYMBOLS = {
    "rec": (6, 256),  # ptype, run byte
    "col": (256, 256, 256),  # R, G, B
    "bt": (5, 256),  # block type, run byte
    "sxy": (16, 16, 16, 16),
    "mv": (2,),  # same-as-previous flag (the vector itself not counted)
}
I_SECTIONS = ("rec", "col")
P_SECTIONS = ("bt", "sxy", "mv", "rec", "col")


def least_seconds(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / SCALAR_OPS_PER_S)


def _varints(data: bytes, pos: int, n: int):
    vals = []
    for _ in range(n):
        v = shift = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        vals.append(v)
    return vals, pos


def _section_bytes(data: bytes, pos: int):
    """(coded bytes of the section's lanes, position past it)."""
    status = data[pos]
    k = 1 << (status & 0x0F)
    width = (1, 2, 4)[(status >> 4) & 3]
    pos += 1
    sizes = [int.from_bytes(data[pos + i * width:pos + (i + 1) * width], "little")
             for i in range(k)]
    pos += k * width
    return sum(sizes), pos + sum(sizes)


def sections(payload: bytes):
    """The coded sections of one frame payload: [(kind, records, coded
    bytes)]; [] for a flat, raw or no-change frame."""
    data = payload
    if data and data[0] & 0x0F == 5:  # format prefix
        data = data[8 if data[1] == 16 else 2:]
    alg = data[0] & 0x0F
    if alg == 2:
        counts, pos = _varints(data, 1, 2)
        kinds = I_SECTIONS
    elif alg == 3 and len(data) > 1 and data[1] & 1:
        (_x1, _x2, *counts), pos = _varints(data, 2, 8)
        counts = counts[:5]
        kinds = P_SECTIONS
    else:
        return []
    out = []
    for kind, n in zip(kinds, counts):
        coded, pos = _section_bytes(data, pos)
        out.append((kind, n, coded))
    return out


def sections_work(payloads) -> tuple[int, int]:
    """(bytes, operations) to code every section of these payloads once."""
    nbytes = nops = 0
    for p in payloads:
        for kind, n, coded in sections(p):
            alph = SUBSYMBOLS[kind]
            nbytes += coded + n * len(alph)
            nops += n * sum(alph)
    return nbytes, nops


def analysis_work(n_frames: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, operations) of the P analysis of n_frames frame pairs."""
    blocks = -(-h // BLOCK) * -(-w // BLOCK)
    return n_frames * (2 * 3 * h * w + 10 * blocks), n_frames * 3 * h * w


def is_p(payload: bytes) -> bool:
    return bool(payload) and payload[0] & 0x0F == 3
