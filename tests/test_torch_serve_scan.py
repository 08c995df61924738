"""The port's window serving (screenpressor_tpu_torch/parallel/serve_scan.py)
on the CPU against the JAX package's, tolerance 0: a window's bytes against
the reference's `encode_window` (the staggered mixed-kind session, and the
overflow fixture whose noisy stream takes the RAW escape) and against the
port's sequential `BatchedEncoder`; `decode_window` lossless (RAW and flat
included) with its stream check deferred; `plan_windows` and the
capacities against the reference's; the device container emitter
(`container.varint_emit` / `container_emit`, which the window uses)
against `bitstream.pack_varint` / `pack_section`.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_serve_scan.py -q
"""

import numpy as np
import pytest
import torch

from screenpressor_tpu import bitstream as jbs
from screenpressor_tpu.config import CodecConfig
from screenpressor_tpu.parallel import serve_scan as jss
from screenpressor_tpu.parallel import serving as jserving
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import container as ct
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P, ALG_RAW
from screenpressor_tpu_torch.parallel import serve_scan as ss
from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

from spbench.reference.sptc import StreamDecoder
from tests.test_serving import staggered_session_batches
from tests.torch_support import SERVING_SITE_FLIPS, damaged_serving_steps, flip, port_config
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

S, H, W = 4, 32, 48


def _cfg(**kw):
    kw.setdefault("kf_interval", 5)
    kw.setdefault("k_fixed", 8)
    kw.setdefault("msr_x", 8)
    kw.setdefault("msr_y", 8)
    return CodecConfig(width=W, height=H, **kw)


def _wcfg(mod, cfg, **kw):
    """tests/test_serve_scan.py's capacities, for either package."""
    kw.setdefault("f", 4)
    kw.setdefault("c", 2)
    kw.setdefault("rec_cap", 1024)
    kw.setdefault("col_cap", 1024)
    kw.setdefault("irec_cap", 2048)
    kw.setdefault("icol_cap", 2048)
    kw.setdefault("pack_cap", 8192)
    return mod.WindowConfig(cfg, S, **kw)


def _kinds(step):
    return [(p[0] & 0x0F, len(p)) for p, _ in step]


@pytest.fixture(scope="module")
def staggered():
    """The staggered session (keyframes inside the window, a flat
    transition, a no-change stream): one per-step keyframe step, then a
    6-step window, through the reference and the port; and the port's
    sequential session."""
    cfg = _cfg(kf_interval=3)
    offsets = [0, 1, 2, 0]
    batches = staggered_session_batches(S, H, W, steps=7, seed=11)
    jenc = jserving.BatchedEncoder(S, cfg, kf_offsets=offsets)
    ref = [jenc.encode(batches[0])] + jss.encode_window(jenc, batches[1:], _wcfg(jss, cfg, f=6))
    pcfg = port_config(cfg)
    seq = BatchedEncoder(S, pcfg, "cpu", kf_offsets=offsets)
    want = [seq.encode(b) for b in batches]
    win = BatchedEncoder(S, pcfg, "cpu", kf_offsets=offsets)
    got = [win.encode(batches[0])] + ss.encode_window(win, batches[1:], _wcfg(ss, pcfg, f=6))
    return pcfg, batches, ref, want, got


@pytest.fixture(scope="module")
def overflow():
    """tests/test_serve_scan.py's overflow fixture: stream 2 changes to
    noise far beyond rec_cap 64, stream 0 takes a small edit, stream 1 one
    in the second step."""
    cfg = _cfg(kf_interval=50)
    rng = np.random.default_rng(5)
    base = np.stack([np.full((H, W, 3), 40, np.uint8) for _ in range(S)])
    b1 = base.copy()
    b1[2] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    b1[0, 4:8, 4:8] = 200
    b2 = b1.copy()
    b2[1, 10:12, :] = 77
    caps = dict(rec_cap=64, col_cap=64, pack_cap=4096)
    jenc = jserving.BatchedEncoder(S, cfg)
    jenc.encode(base)
    ref = jss.encode_window(jenc, [b1, b2], _wcfg(jss, cfg, **caps))
    pcfg = port_config(cfg)
    enc = BatchedEncoder(S, pcfg, "cpu")
    first = enc.encode(base)
    got = ss.encode_window(enc, [b1, b2], _wcfg(ss, pcfg, **caps))
    return pcfg, [base, b1, b2], ref, [first] + got, enc


@pytest.mark.parametrize("step", range(1, 7))
def test_window_bytes_equal_reference_window(staggered, step):
    _, _, ref, _, got = staggered
    for i in range(S):
        assert got[step][i] == ref[step][i], f"step {step} stream {i}: bytes or type differ"


@pytest.mark.parametrize("step", range(7))
def test_window_bytes_equal_sequential(staggered, step):
    """Within its capacities a window emits the sequential session's bytes."""
    _, _, _, want, got = staggered
    assert got[step] == want[step], f"step {step}"


def test_window_covers_every_frame_kind(staggered):
    """The window holds keyframes beside P streams, a flat frame and a
    no-change frame."""
    _, _, _, _, got = staggered
    kinds = {kd for step in got[1:] for kd in _kinds(step)}
    assert {a for a, _ in kinds} == {ALG_FLAT, ALG_I, ALG_P}, kinds
    assert (ALG_P, 2) in kinds and (ALG_FLAT, 4) in kinds, kinds
    assert any(len({ft for _, ft in step}) == 2 for step in got[1:])


def test_window_decode_lossless(staggered):
    """decode_window over the window's steps gives the frames back, the
    flat transition included, and leaves the state a sequential decode
    continues from."""
    cfg, batches, _, _, got = staggered
    dec = BatchedDecoder(S, cfg, "cpu")
    np.testing.assert_array_equal(dec.decode([p for p, _ in got[0]]), batches[0])
    frames_fs = ss.decode_window(dec, [[p for p, _ in step] for step in got[1:4]])
    dec.validate()
    assert frames_fs.shape == (3, S, H, W, 3)
    for t in range(3):
        np.testing.assert_array_equal(frames_fs[t].numpy(), batches[1 + t], err_msg=f"step {t}")
    for t in range(4, 7):
        np.testing.assert_array_equal(dec.decode([p for p, _ in got[t]]), batches[t])


def test_overflow_bytes_equal_reference_window(overflow):
    _, _, ref, got, _ = overflow
    for t in range(2):
        for i in range(S):
            assert got[1 + t][i] == ref[t][i], f"step {t} stream {i}: bytes or type differ"
    # the noisy stream took the RAW escape; the edited one stayed coded
    kinds = (ALG_P, ALG_FLAT, ALG_RAW, ALG_FLAT)
    assert [p[0] for p, _ in got[1]] == [bs.header_byte(a) for a in kinds]


def test_overflow_decode_lossless(overflow):
    """The RAW frame and the coded ones after it decode losslessly, through
    decode_window and step by step."""
    cfg, frames, _, got, _ = overflow
    for window in (True, False):
        dec = BatchedDecoder(S, cfg, "cpu")
        dec.decode([p for p, _ in got[0]])
        if window:
            back = ss.decode_window(dec, [[p for p, _ in step] for step in got[1:]]).numpy()
            dec.validate()
        else:
            back = [dec.decode([p for p, _ in step]) for step in got[1:]]
        for t in range(2):
            np.testing.assert_array_equal(back[t], frames[1 + t], err_msg=f"step {t}")


def test_overflow_served_by_serve_windowed(overflow):
    """serve_windowed over the fixture's three steps (the session's
    keyframe step, then one window of two) gives the fixture's bytes and
    frames back, counts the RAW stream-steps in frames.raw, and the plain
    reference decoder (spbench/reference/sptc.py) gives every stream's
    frames back from those bytes."""
    cfg, frames, _, got, _ = overflow
    wcfg = _wcfg(ss, cfg, rec_cap=64, col_cap=64, pack_cap=4096)
    enc, dec = BatchedEncoder(S, cfg, "cpu"), BatchedDecoder(S, cfg, "cpu")
    before = telemetry.counts().get("frames.raw", 0)
    served = list(ss.serve_windowed(enc, iter(frames), dec, wcfg))
    dec.validate()
    assert [outs for outs, _ in served] == got
    n_raw = sum(p[0] & 0x0F == ALG_RAW for step in got for p, _ in step)
    assert n_raw == 1 and telemetry.counts()["frames.raw"] - before == n_raw
    for t, (_, back) in enumerate(served):
        np.testing.assert_array_equal(back.numpy(), frames[t], err_msg=f"step {t}")
    for i in range(S):
        ref = StreamDecoder(H, W, cfg.k_fixed)
        for t, step in enumerate(got):
            np.testing.assert_array_equal(ref.decode(step[i][0]), frames[t][i],
                                          err_msg=f"step {t} stream {i}")


def test_overflow_renews_the_raw_streams_tables(overflow):
    """The RAW escape renewed stream 2's tables (its next step codes no
    change); the coded streams' tables moved on."""
    from screenpressor_tpu_torch.tables import renew_tables_cached

    enc = overflow[4]
    fresh = renew_tables_cached("cpu")
    for i, renewed in ((0, False), (2, True)):
        same = all(torch.equal(enc.tables_b[kd][key][i], fresh[kd][key])
                   for kd in fresh for key in fresh[kd])
        assert same == renewed, f"stream {i}"


def test_one_stream_window_matches_sequential():
    """S = 1 (the single-stream window): the window's bytes equal the
    sequential session's, and decode_window gives the frames back."""
    cfg = port_config(_cfg(kf_interval=100))
    batches = [b[:1] for b in staggered_session_batches(4, H, W, steps=7)]
    seq = BatchedEncoder(1, cfg, "cpu")
    want = [seq.encode(b) for b in batches]
    win = BatchedEncoder(1, cfg, "cpu")
    got = [win.encode(batches[0])] + ss.encode_window(
        win, batches[1:], ss.WindowConfig(cfg, 1, f=6, c=1, rec_cap=1024, col_cap=1024,
                                          irec_cap=2048, icol_cap=2048, pack_cap=8192))
    assert got == want
    dec = BatchedDecoder(1, cfg, "cpu")
    dec.decode([got[0][0][0]])
    frames_fs = ss.decode_window(dec, [[g[0][0]] for g in got[1:]])
    dec.validate()
    for t in range(1, len(batches)):
        np.testing.assert_array_equal(frames_fs[t - 1, 0].numpy(), batches[t][0])


def test_decode_window_defers_the_stream_check():
    """A damaged P payload inside a window decodes without raising; the
    next decode() raises the message the per-step decoder raises at its
    deferred check (the reference's "stream i: ..." verdict)."""
    cfg, steps, payloads, _ = damaged_serving_steps()
    deferred = 0
    for pos, x in SERVING_SITE_FLIPS:
        bad = list(steps[2])
        bad[1] = flip(payloads[2], pos, x)
        seq = BatchedDecoder(4, cfg, "cpu")
        for step in steps[:2]:
            seq.decode(step)
        try:
            seq.decode(bad, device_out=True)
        except bs.CorruptStreamError:
            continue  # a parse-level verdict: not deferred
        with pytest.raises(bs.CorruptStreamError) as want:
            seq.validate()
        win = BatchedDecoder(4, cfg, "cpu")
        win.decode(steps[0])
        ss.decode_window(win, [steps[1], bad])
        with pytest.raises(bs.CorruptStreamError) as got:
            win.decode(steps[3])
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith("stream 1: ")
        deferred += 1
    assert deferred, "no damaged payload reached the deferred check"


def test_decode_window_parse_errors_name_the_step():
    cfg, steps, _, _ = damaged_serving_steps()
    dec = BatchedDecoder(4, cfg, "cpu")
    dec.decode(steps[0])
    bad = list(steps[2])
    bad[3] = b""
    with pytest.raises(bs.CorruptStreamError, match="^step 1 stream 3: empty frame$"):
        ss.decode_window(dec, [steps[1], bad])


PLAN_CASES = [(offsets, c, fn, have_prev)
              for offsets in ([0, 1, 2, 0], [0, 0, 0, 0], [0, 1, 2, 3], [2, 2, 1, 0])
              for c in (1, 2, 3) for fn, have_prev in ((0, False), (1, True), (5, True))]


@pytest.mark.parametrize("offsets,c,fn,have_prev", PLAN_CASES)
def test_plan_windows_matches_reference(offsets, c, fn, have_prev):
    cfg = _cfg(kf_interval=3)
    jenc = jserving.BatchedEncoder(S, cfg, kf_offsets=offsets)
    enc = BatchedEncoder(S, port_config(cfg), "cpu", kf_offsets=offsets)
    jenc.fn = enc.fn = fn
    if have_prev:
        jenc.prev = np.zeros(1)
        enc.prev = torch.zeros(1)
    for n_steps in (1, 6, 11):
        want = jss.plan_windows(jenc, n_steps, _wcfg(jss, cfg, c=c))
        assert ss.plan_windows(enc, n_steps, _wcfg(ss, port_config(cfg), c=c)) == want


@pytest.mark.parametrize("kw", [{}, dict(rec_cap=64, irec_cap=100000, bcap=4),
                                dict(bcap=100000, icol_cap=7)])
def test_window_config_matches_reference(kw):
    cfg = _cfg()
    want = vars(jss.WindowConfig(cfg, S, **kw))
    assert vars(ss.WindowConfig(port_config(cfg), S, **kw)) == want


VARINT_EDGES = [0, 1, 127, 128, 16383, 16384, (1 << 21) - 1, 1 << 21, (1 << 28) - 1]


def test_varint_emitter_matches_pack_varint():
    rng = np.random.default_rng(3)
    rows = [VARINT_EDGES[:8], VARINT_EDGES[1:]]
    rows += [list(rng.integers(0, 1 << 28, 8)) for _ in range(6)]
    rows += [list(rng.integers(0, 200, 8)) for _ in range(2)]
    vb, vl = ct.varint_emit(torch.as_tensor(np.asarray(rows, np.int64)))
    for r, row in enumerate(rows):
        want = jbs.pack_varint(*(int(v) for v in row))
        assert int(vl[r]) == len(want)
        assert vb[r, :len(want)].numpy().tobytes() == want


@pytest.mark.parametrize("sizes", [[0, 0, 0, 0], [3, 0, 255, 17], [256, 1, 0, 9],
                                   [65535, 2, 40, 0], [65536, 0, 70000, 5]])
def test_container_emitter_matches_pack_section(sizes):
    """A head and two sections through the device emitter equal
    pack_varint + pack_section over the same lane blobs."""
    rng = np.random.default_rng(sum(sizes))
    k, cap = len(sizes), max(sizes) + 5
    secs, want = [], jbs.pack_varint(7, 300, (1 << 28) - 1)
    for rev in (False, True):
        sz = sizes[::-1] if rev else sizes
        buf = rng.integers(0, 256, (1, k, cap), dtype=np.uint8)
        start = np.asarray([[cap - s if s else cap - 1 for s in sz]], np.int32)
        lens = np.asarray([[int(s > 0) for s in sz]], np.int32)
        secs.append((torch.as_tensor(buf), torch.as_tensor(start), torch.as_tensor(lens)))
        want += jbs.pack_section([buf[0, j, cap - s:].tobytes() if s else b""
                                  for j, s in enumerate(sz)])
    head, head_len = ct.varint_emit(torch.as_tensor([[7, 300, (1 << 28) - 1]]))
    out, total = ct.container_emit(head, head_len, secs, len(want) + 3)
    assert int(total[0]) == len(want)
    assert out[0, :len(want)].numpy().tobytes() == want
    assert not out[0, len(want):].any()
