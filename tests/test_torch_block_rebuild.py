"""The port's P-frame data-block rebuild (pframe.reconstruct_blocks_streams,
kernel K6 on the card) on the CPU against the reference: the plain version
against jx/pframe.py `reconstruct_blocks` on the fixtures of
torch_support.rebuild_fixtures, and the whole stream-batched rebuild
(pframe.rebuild_p_streams: resolve, motion apply, block rebuild) against
`rebuild_frame_device` on the block parts of serving and session decodes,
with damaged streams' verdicts held to jx's. Inputs from seeds with numpy;
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.bitstream import CorruptStreamError as RefCorrupt
from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu.jx import pframe as jp
from screenpressor_tpu.jx.codec import JaxDecoder
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder, _build
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import kernels as tk
from screenpressor_tpu_torch import pframe as tp
from screenpressor_tpu_torch.config import CodecConfig
from screenpressor_tpu_torch.parallel import serving as ts

from tests.test_spec_iframe import synth_desktop
from tests.torch_support import (INDEX_SITE_FLIPS, corrupt_payloads, rebuild_fixtures,
                                 record_index_sites)
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = rebuild_fixtures()


def _port_rebuild(fn, base, prev, rects, bsid, pt, rl, lt):
    """fn (a reconstruct_blocks_streams variant) on CPU tensors -> the
    frames [C, h, w, 3] (the sink row dropped)."""
    c, h, w, _ = prev.shape
    out = torch.cat([torch.as_tensor(base).reshape(-1, 3), torch.zeros((1, 3), dtype=torch.uint8)])
    got = fn(out, torch.as_tensor(prev), *(torch.as_tensor(a) for a in (rects, bsid, pt, rl, lt)))
    assert got is out  # in place
    return out[:-1].view(c, h, w, 3).numpy()


def _jx_rebuild(base, prev, rects, bsid, pt, rl, lt, s):
    """jx reconstruct_blocks of stream s's slots (in call order)."""
    sel = bsid == s
    if not sel.any():
        return base[s]
    h, w = prev.shape[1:3]
    return np.asarray(jp.reconstruct_blocks(
        jnp.asarray(base[s]), jnp.asarray(prev[s]), *(jnp.asarray(a[sel]) for a in (rects, pt, rl,
                                                                                   lt)),
        h, w, int(sel.sum())))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_block_rebuild_matches_jx(name, monkeypatch):
    """The plain rebuild, and reconstruct_blocks_streams on CPU tensors
    (which never reaches K6's wrapper), equal jx's reconstruct_blocks on
    every stream the reference defines alike; on the damaged fixture's
    other stream the writes stay inside that stream's frame, within each
    slot's clamped 16 x 16 window."""
    def refuse(*args):
        raise AssertionError("K6 wrapper called on CPU tensors")

    monkeypatch.setattr(tp, "rebuild_blocks_streams_kernel", refuse)
    base, prev, rects, bsid, pt, rl, lt, ref_streams = FIXTURES[name]
    got = _port_rebuild(tp.reconstruct_blocks_streams_plain, base, prev, rects, bsid, pt, rl, lt)
    np.testing.assert_array_equal(
        _port_rebuild(tp.reconstruct_blocks_streams, base, prev, rects, bsid, pt, rl, lt), got)
    for s in ref_streams:
        np.testing.assert_array_equal(got[s], _jx_rebuild(base, prev, rects, bsid, pt, rl, lt, s),
                                      err_msg=f"{name}: stream {s}")
    h, w = prev.shape[1:3]
    for s in sorted(set(range(prev.shape[0])) - set(ref_streams)):
        reach = np.zeros((h, w), bool)
        for x1, y1, x2, y2 in rects[bsid == s]:
            bw, bh = min(max(x2 - x1, 0), 16), min(max(y2 - y1, 0), 16)
            reach[max(y1, 0):max(y1 + bh, 0), max(x1, 0):max(x1 + bw, 0)] = True
        changed = (got[s] != base[s]).any(axis=-1)
        assert changed.any() and not (changed & ~reach).any(), name
    if name == "wrap":  # the gradient chains left 0..255 before the mask
        assert _int32_rows_leave_bytes(prev, rects, pt, rl, lt)


def test_kernel_wrapper_refuses_cpu_tensors():
    """K6's wrapper takes CUDA tensors only: on CPU tensors it raises
    before any build or launch."""
    base, prev, rects, bsid, pt, rl, lt, _ = FIXTURES["types"]
    out = torch.cat([torch.as_tensor(base).reshape(-1, 3), torch.zeros((1, 3), dtype=torch.uint8)])
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="kernel input on cpu"):
        tk.rebuild_blocks_streams_kernel(out, torch.as_tensor(prev),
                                         *(torch.as_tensor(a) for a in (rects, bsid, pt, rl, lt)))
    assert _build.LAUNCHES == before


def _int32_rows_leave_bytes(prev, rects, pt, rl, lt):
    """Whether the plain version's unmasked int32 rows of these slots hold
    a value outside 0..255 (the rows before `& 0xFF`)."""
    seen = []
    real = tp._row_affine

    def spy(known, reset, d):
        row = real(known, reset, d)
        seen.append(bool(((row < 0) | (row > 255)).any()))
        return row

    tp._row_affine = spy
    try:
        _port_rebuild(tp.reconstruct_blocks_streams_plain, prev, prev, rects,
                      np.zeros(len(rects), np.int64), pt, rl, lt)
    finally:
        tp._row_affine = real
    return any(seen)


# ---------------------------------------------------------------------------
# rebuild_p_streams on decoded sessions against rebuild_frame_device
# ---------------------------------------------------------------------------

H, W = 40, 56
CFG = CodecConfig(width=W, height=H, k_fixed=8, msr_x=8, msr_y=8)


def _session_frames(steps=3):
    """Three streams of 40 x 56 (partial blocks at the right and bottom
    edges): a scroll with a typed patch, typing near the right and bottom
    edges, and a motion block left of and above new content."""
    tall = synth_desktop(H + 3 * steps, W, seed=31)
    typing = synth_desktop(H, W, seed=32)
    moving = synth_desktop(H + 4, W, seed=33)
    rng = np.random.default_rng(34)
    out = []
    for t in range(steps):
        scroll = tall[3 * t:3 * t + H].copy()
        typing = typing.copy()
        motion = moving[:H].copy()
        if t:
            scroll[20:24, 30:36] = rng.integers(0, 256, (4, 6, 3))
            typing[H - 5:H - 1, W - 7 + t:W - 3 + t] = rng.integers(0, 256, 3)
            typing[35:39, 3 * t:3 * t + 4] = rng.integers(0, 256, (4, 4, 3))
            motion[0:16, 0:16] = moving[2:18, 0:16]  # motion (0, 2)
            motion[0:16, 16:32] = rng.integers(0, 256, (16, 16, 3))
            motion[16:32, 0:16] = rng.integers(0, 256, (16, 16, 3))
        out.append(np.stack([scroll, typing, motion]))
    return out


def _captured_rebuilds(monkeypatch, run):
    """run() with every rebuild_p_streams call's inputs and outputs
    recorded: [(recs, lay, prev, frames, err)]."""
    calls = []
    real = tp.rebuild_p_streams

    def spy(recs, lay, prev, cfg):
        frames, err = real(recs, lay, prev, cfg)
        calls.append((recs, lay, prev, frames, err))
        return frames, err

    monkeypatch.setattr(tp, "rebuild_p_streams", spy)
    monkeypatch.setattr(ts, "rebuild_p_streams", spy)
    run()
    return calls


def _jx_frame(parts, lay, prev, j):
    """rebuild_frame_device on stream j's motion and data-block slots."""
    mo_rects, mo_mvs, d_rects, pt, rlg, lt = (p.numpy() for p in parts)
    ms, bs_ = lay.msid.numpy() == j, lay.bsid.numpy() == j
    return np.asarray(jp.rebuild_frame_device(
        jnp.asarray(prev[j].numpy()), jnp.asarray(mo_rects[ms]), jnp.asarray(mo_mvs[ms]),
        *(jnp.asarray(a[bs_]) for a in (d_rects, pt, rlg, lt)), H, W, int(ms.sum()),
        int(bs_.sum())))


@pytest.mark.parametrize("path", ["serving", "session"])
def test_rebuild_p_streams_matches_jx(path, monkeypatch):
    """Each rebuild_p_streams call of a serving decode (three streams in a
    call) and of a session decode (one stream, C = 1) equals jx's
    rebuild_frame_device stream by stream on the block parts the port's
    resolution gives, with clean error words; the decode is lossless."""
    batches = _session_frames()
    if path == "serving":
        enc = ts.BatchedEncoder(3, CFG, "cpu")
        steps = [[p for p, _ in enc.encode(f)] for f in batches]

        def run():
            dec = ts.BatchedDecoder(3, CFG, "cpu")
            for step, f in zip(steps, batches):
                np.testing.assert_array_equal(dec.decode(step), f)
    else:
        frames = [f[2] for f in batches]
        payloads = [p for p, _ in TorchEncoder(CFG, "cpu").encode_batch(frames)]

        def run():
            out = TorchDecoder(CFG, "cpu").decode_batch(payloads)
            for o, f in zip(out, frames):
                np.testing.assert_array_equal(o, f)
    calls = _captured_rebuilds(monkeypatch, run)
    assert len(calls) == len(batches) - 1
    n_data = 0
    for recs, lay, prev, frames, err in calls:
        parts, err2 = tp.decode_p_resolve_streams(recs, lay, CFG)
        assert not err.any() and torch.equal(err, err2)
        n_data += int((parts[2][:, 2] > parts[2][:, 0]).sum())
        for j in range(prev.shape[0]):
            np.testing.assert_array_equal(frames[j].numpy(), _jx_frame(parts, lay, prev, j),
                                          err_msg=f"{path}: stream {j}")
    assert n_data >= 2 * len(calls)


def _verdict(dec, data):
    try:
        return "ok", np.asarray(dec.decode_batch([data])[0])
    except (bs.CorruptStreamError, RefCorrupt):
        return "corrupt", None


def test_damaged_rects_and_runs_verdicts_match_jx(monkeypatch):
    """The payloads of corrupt_payloads whose damage reaches the block
    rebuild with a sub-rect past its block (the INDEX_SITE_FLIPS' grid
    site) or with runs that do not tile the data blocks (error bits 64,
    128, 256): the port's verdict equals jx's (the error word decides;
    the rebuild raises nothing)."""
    cfg, _, payloads, damaged = corrupt_payloads()
    ref_cfg = RefCodecConfig(width=cfg.width, height=cfg.height)
    hits = record_index_sites(monkeypatch)
    sites = len(INDEX_SITE_FLIPS)
    calls = _captured_rebuilds(monkeypatch, lambda: None)
    kinds = set()
    for c, (i, data) in enumerate(damaged):
        hits.clear()
        calls.clear()
        tdec = TorchDecoder(cfg, "cpu")
        tdec.decode_batch(payloads[:i])
        got = _verdict(tdec, data)
        word = int(calls[-1][4][0]) if calls else 0
        runs = bool(word & (64 | 128 | 256))
        if not (runs or "grid" in hits or c >= len(damaged) - sites):
            continue
        kinds |= {got[0], "runs" if runs else "grid"}
        jdec = JaxDecoder(ref_cfg)
        jdec.decode_batch(payloads[:i])
        want = _verdict(jdec, data)
        assert got[0] == want[0], f"case {c} (frame {i}): port {got[0]}, jx {want[0]}"
        if got[0] == "ok":
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"case {c}")
    assert {"runs", "grid", "corrupt"} <= kinds
