"""The port's SPTC container writer (screenpressor_tpu_torch/container.py
and `bitstream.write_section`) held to itself and to the reference: the
host section writer against `pack_section` (the port's and the JAX
package's), the device size rule and the device section head against the
host writer's bytes, the raw escape at its threshold on the host and on the
device, the heads against the reference's bytes, and the one-pass lane
layout (`lane_segments`, `frame_layouts`, `gather_segments`) against a
per-lane loop.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_container.py -q
"""

import numpy as np
import pytest
import torch

from screenpressor_tpu import bitstream as ref_bs
from screenpressor_tpu.config import ALG_FLAT, ALG_I, ALG_P, ALG_RAW
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import container as ct
from screenpressor_tpu_torch.config import CodecConfig

def _lane_sizes(k: int, width: int, seed: int) -> np.ndarray:
    """k seeded lane sizes whose table takes `width` bytes: every third
    lane empty, lane k // 2 at the width's largest size (k = 1 at width 1:
    one empty lane)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 200, k)
    sizes[::3] = 0
    sizes[k // 2] = {1: 255 if k > 1 else 0, 2: 65535, 4: 65536}[width]
    return sizes.astype(np.int64)


def _section_case(k: int, sizes: np.ndarray, seed: int):
    """A section's lanes in a [k, cap] buffer as the section coder leaves
    them (lane j's bytes end its row), with starts and record counts; an
    empty lane's start points anywhere."""
    rng = np.random.default_rng(seed)
    cap = int(sizes.max()) + 3
    buf = rng.integers(0, 256, (k, cap), dtype=np.uint8)
    starts = np.where(sizes > 0, cap - sizes, rng.integers(0, cap, k)).astype(np.int32)
    lens = np.where(sizes > 0, rng.integers(1, 9, k), 0).astype(np.int32)
    blobs = [buf[j, cap - s:].tobytes() if s else b"" for j, s in enumerate(sizes)]
    return buf, starts, lens, cap, blobs


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 2, 8, 64, 256])
def test_write_section_equals_pack_section(k, width):
    sizes = _lane_sizes(k, width, seed=k * 10 + width)
    assert bs.size_width(int(sizes.max())) == width
    _buf, _starts, _lens, _cap, blobs = _section_case(k, sizes, seed=k + width)
    got = bs.write_section(k, sizes, np.frombuffer(b"".join(blobs), np.uint8))
    assert got == bs.pack_section(blobs) == ref_bs.pack_section(blobs)
    lanes, end = bs.unpack_section(got, 0, k)
    assert lanes == blobs and end == len(got)


@pytest.mark.parametrize("edge", [255, 256, 65535, 65536, None])
def test_device_size_rule_equals_host_section(edge):
    """section_bytes and frame_bytes (device) and container_size (host)
    against the length of the section write_section makes from the same
    lanes."""
    rng = np.random.default_rng(7 if edge is None else edge)
    for k in (1, 4, 32):
        sizes = rng.integers(0, 300, k).astype(np.int64)
        if edge is not None:
            sizes[rng.integers(0, k)] = edge
        buf, starts, lens, cap, blobs = _section_case(k, sizes, seed=k)
        host = ct.lane_sizes(starts, lens, cap)
        np.testing.assert_array_equal(host, sizes)
        dev = ct.lane_sizes_device(torch.as_tensor(starts), torch.as_tensor(lens), cap)
        np.testing.assert_array_equal(dev.numpy(), sizes)
        want = len(bs.write_section(k, sizes, np.frombuffer(b"".join(blobs), np.uint8)))
        got = ct.section_bytes(torch.as_tensor(starts), torch.as_tensor(lens), cap, k)
        assert got.dtype == torch.int32 and int(got) == want
        head = ct.i_head(300, 7)
        frame = ct.frame_bytes(head, [torch.as_tensor(buf)] * 2, [torch.as_tensor(starts)] * 2,
                               [torch.as_tensor(lens)] * 2)
        host_total = ct.container_size([len(head)], np.stack([sizes, sizes])[None])
        assert int(frame) == int(host_total[0]) == len(head) + 2 * want


@pytest.mark.parametrize("k", [1, 8, 256])
def test_device_section_head_equals_host_section_head(k):
    """section_meta's status byte and size table, for streams at each
    width, equal write_section's head (the section without its lanes)."""
    rows = [_lane_sizes(k, width, seed=width) for width in (1, 2, 4)]
    rows += [np.zeros(k, np.int64), np.full(k, 255, np.int64), np.full(k, 256, np.int64)]
    meta, meta_len = ct.section_meta(torch.as_tensor(np.stack(rows)), k)
    for c, sizes in enumerate(rows):
        want = bs.write_section(k, sizes, np.zeros(0, np.uint8))
        assert int(meta_len[c]) == len(want)
        assert meta[c, :len(want)].numpy().tobytes() == want
        assert not meta[c, len(want):].any()


def test_raw_escape_at_the_threshold_on_the_host_and_the_device():
    cfg = CodecConfig(width=48, height=32)
    size = ct.raw_size(cfg)
    assert size == 1 + 48 * 32 * 3
    assert not ct.raw_escape(size - 1, size) and ct.raw_escape(size, size)
    dev = ct.raw_escape(torch.tensor([size - 1, size, size + 1], dtype=torch.int32), size)
    assert dev.tolist() == [False, True, True]


def test_raw_escape_of_a_coded_keyframe():
    """encode_i_raw's device flag fires where its container's exact size
    reaches the threshold, and not one byte below: the frame's own total
    as the threshold escapes, one byte more does not."""
    from screenpressor_tpu_torch.iframe import encode_i_raw, i_phase
    from screenpressor_tpu_torch.synth import synth_screencast
    from screenpressor_tpu_torch.tables import renew_tables_cached

    cfg = CodecConfig(width=64, height=48)
    frame = torch.as_tensor(synth_screencast(48, 64, 1)[0])
    records, lits, counts, _bm = i_phase(frame)
    n_rec, n_lit = (int(v) for v in counts[:2])

    def stats(threshold):
        out = encode_i_raw(records, n_rec, lits, n_lit, renew_tables_cached("cpu"), cfg,
                           threshold)
        return [int(v) for v in out[6]]

    total, _ = stats(ct.raw_size(cfg))
    assert stats(total) == [total, 1]
    assert stats(total + 1) == [total, 0]


def test_heads_equal_the_reference():
    assert ct.flat_frame((1, 2, 255)) == bytes([ref_bs.header_byte(ALG_FLAT), 1, 2, 255])
    assert ct.UNCHANGED_P == bytes([ref_bs.header_byte(ALG_P), 0])
    assert ct.RAW_HEAD == bytes([ref_bs.header_byte(ALG_RAW)])
    assert ct.i_head(300, 7) == bytes([ref_bs.header_byte(ALG_I)]) + ref_bs.pack_varint(300, 7)
    vals = [0, 5, 130, 1 << 14, 7, 1 << 21, 3, (1 << 28) - 1]
    assert ct.p_head(vals) == bytes([ref_bs.header_byte(ALG_P), 1]) + ref_bs.pack_varint(*vals)


def test_device_heads_equal_host_heads():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1 << 28, (5, 8))
    vals[0] = 0
    heads, lens = ct.heads(ct.P_HEAD, torch.as_tensor(vals))
    for c in range(5):
        want = ct.p_head([int(v) for v in vals[c]])
        assert heads[c, :int(lens[c])].numpy().tobytes() == want
    n_rec, n_lit = torch.tensor([0, 127, 128, 1 << 20]), torch.tensor([0, 1, 300, 5])
    heads, lens = ct.heads(ct.I_HEAD, torch.stack([n_rec, n_lit], dim=1))
    for c in range(4):
        want = ct.i_head(int(n_rec[c]), int(n_lit[c]))
        assert heads[c, :int(lens[c])].numpy().tobytes() == want
    flat = torch.tensor([True, False, False, False])
    nochange = torch.tensor([False, True, False, False])
    raw = torch.tensor([False, False, True, False])
    color = torch.tensor([[9, 8, 7]] * 4, dtype=torch.uint8)
    small, lens = ct.small_frames(flat, nochange, raw, color)
    assert lens.tolist() == [4, 2, 1, 0]
    for c, want in enumerate([ct.flat_frame((9, 8, 7)), ct.UNCHANGED_P, ct.RAW_HEAD]):
        assert small[c, :len(want)].numpy().tobytes() == want


def test_assemble_lays_head_sections_and_body():
    rng = np.random.default_rng(5)
    rows = [_lane_sizes(8, 1, seed=1), _lane_sizes(4, 2, seed=2)]
    blobs = [[rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in r] for r in rows]
    body = rng.integers(0, 256, 11, dtype=np.uint8).tobytes()
    tight = np.frombuffer(b"xyz" + b"".join(b"".join(b) for b in blobs) + body, np.uint8)
    head = ct.i_head(3, 4)
    want = head + b"".join(ref_bs.pack_section(b) for b in blobs) + body
    data, pos = ct.assemble(head, tight, 3, rows, body=11, total=len(want))
    assert data == want and pos == len(tight)
    with pytest.raises(RuntimeError):
        ct.assemble(head, tight, 3, rows, body=11, total=len(want) + 1)
    assert ct.assemble(b"", tight, 0, body=3) == (b"xyz", 3)


def _lane_loop(bufs, starts, sizes, raws):
    """The oracle: a Python trip a lane over R streams' S sections (bufs [R,
    K, cap] numpy, starts and sizes [R, S, K]); a stream in `raws` writes
    its frame's pixels instead. Returns (the gathered bytes, each stream's
    container size under a one-byte head, a Python sum a section)."""
    out, totals = [], []
    for r in range(sizes.shape[0]):
        totals.append(1 + sum(1 + len(sz) * bs.size_width(int(sz.max())) + int(sz.sum())
                              for sz in sizes[r]))
        if r in raws:
            out.append(raws[r].tobytes())
            continue
        for s, buf in enumerate(bufs):
            for lane in range(buf.shape[1]):
                n = int(sizes[r, s, lane])
                if n:
                    a = int(starts[r, s, lane])
                    out.append(buf[r, lane, a:a + n].tobytes())
    return b"".join(out), totals


def _streams_case(r: int, k: int, seed: int, empty: str):
    """R streams' five sections of k lanes as the stream-batched section coder
    leaves them (each lane's bytes end its row): bufs, starts, record counts
    and lane sizes; `empty`: "all" (every lane), "section" (section 2 of
    every stream) or "" (every third lane)."""
    rng = np.random.default_rng(seed)
    bufs, starts, lens = [], [], []
    for s, cap in enumerate((5, 40, 9, 300, 70)):
        sz = rng.integers(1, cap + 1, (r, k))
        sz[:, ::3] = 0
        if empty == "all" or (empty == "section" and s == 2):
            sz[:] = 0
        bufs.append(rng.integers(0, 256, (r, k, cap), dtype=np.uint8))
        starts.append(np.where(sz > 0, cap - sz, rng.integers(0, cap + 1, (r, k))).astype(np.int32))
        lens.append(np.where(sz > 0, rng.integers(1, 9, (r, k)), 0).astype(np.int32))
    sizes = np.stack([ct.lane_sizes(st, ln, b.shape[2]) for st, ln, b in zip(starts, lens, bufs)],
                     axis=1)
    return bufs, np.stack(starts, axis=1), sizes


@pytest.mark.parametrize("r, k, empty, raw_rows", [
    (6, 16, "", ()), (6, 64, "", ()), (6, 256, "", ()),
    (5, 16, "all", ()), (5, 64, "section", ()),
    (7, 16, "", (0,)), (7, 64, "", (3,)), (7, 16, "", (6,)), (7, 64, "section", (0, 3, 6)),
    (1, 64, "", ()), (1, 16, "", (0,)),
])
def test_lane_segments_equal_a_per_lane_loop(r, k, empty, raw_rows):
    """The serving writer's one numpy pass (section_rows, lane_segments, the
    raw pixels of the escaping streams in their place, gather_segments)
    gathers the bytes a per-lane loop gathers, and container_size gives
    its totals."""
    bufs, starts, sizes = _streams_case(r, k, seed=r * 1000 + k, empty=empty)
    rng = np.random.default_rng(k)
    frames = rng.integers(0, 256, (r, 4, 6, 3), dtype=np.uint8)
    raws = {j: frames[j].reshape(-1) for j in raw_rows}
    want, want_totals = _lane_loop(bufs, starts, sizes, raws)

    totals = ct.container_size(np.ones(r, np.int64), sizes)
    assert totals.tolist() == want_totals
    parts = [torch.as_tensor(b).reshape(-1) for b in bufs]
    at = sum(b.size for b in bufs)
    raw_src, raw_len = np.zeros(r, np.int64), np.zeros(r, np.int64)
    sizes = sizes.copy()
    for j in raw_rows:
        parts.append(torch.as_tensor(frames[j]).reshape(-1))
        raw_src[j], raw_len[j] = at, frames[j].size
        at += frames[j].size
        sizes[j] = 0
    src, lens = ct.lane_segments(*ct.section_rows([torch.as_tensor(b) for b in bufs]), starts,
                                 sizes, raw_src, raw_len)
    assert src.dtype == lens.dtype == np.int64 and (lens > 0).all()
    assert len(lens) == np.count_nonzero(sizes) + len(raw_rows)
    got = ct.gather_segments(parts, src, lens)
    assert got.tobytes() == want


@pytest.mark.parametrize("raw_frames", [(), (0,), (2,), (4,), (0, 2, 4)])
def test_frame_layouts_equal_a_per_lane_loop(raw_frames):
    """The desktop's and the sp path's layout (`frame_layouts`): frames of 2
    and 5 sections, each section its own lane count, in one pass; an
    escaping frame writes its pixels, or nothing when it brings none."""
    rng = np.random.default_rng(len(raw_frames))
    frames, want, kept = [], [], []
    for j in range(5):
        ks = (16, 64) if j % 2 == 0 else (8, 32, 16, 256, 64)
        secs = [_streams_case(1, kk, seed=10 * j + q, empty="")
                for q, kk in enumerate(ks)]
        bufs = [b[0][q][0] for q, b in enumerate(secs)]
        st = [b[1][0, q] for q, b in enumerate(secs)]
        sz = [b[2][0, q] for q, b in enumerate(secs)]
        ln = [np.where(x > 0, 1, 0).astype(np.int32) for x in sz]
        raw = rng.integers(0, 256, 4 * 6 * 3, dtype=np.uint8)
        escapes = j in raw_frames
        got = [np.array([1000 + j, int(escapes)], np.int32), *st, *ln]
        pixels = None if escapes and j == 4 else torch.as_tensor(raw)
        frames.append((bytes([j]), [torch.as_tensor(b) for b in bufs], got, pixels))
        if escapes:
            want.append(b"" if pixels is None else raw.tobytes())
            kept.append(None if pixels is None else (ct.RAW_HEAD, (), raw.size, None))
            continue
        for b, s0, n in zip(bufs, st, sz):
            want += [b[lane, s0[lane]:s0[lane] + n[lane]].tobytes() for lane in range(len(n))]
        kept.append((bytes([j]), sz, 0, 1000 + j))
    (parts, src, lens), lays = ct.frame_layouts(frames)
    assert ct.gather_segments(parts, src, lens).tobytes() == b"".join(want)
    for lay, w in zip(lays, kept):
        if w is None or lay is None:
            assert lay is w
            continue
        assert lay[0] == w[0] and lay[2:] == w[2:]
        assert [x.tolist() for x in lay[1]] == [x.tolist() for x in w[1]]
