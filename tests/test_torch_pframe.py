"""The port's P-frame path (screenpressor_tpu_torch.blocks / pframe) against
the JAX package on the CPU: typing and scroll sessions frame by frame,
block classification and record assembly, and the decoder's predictor
reads next to motion blocks. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.config import CodecConfig
from screenpressor_tpu.jx import pframe as jp
from screenpressor_tpu.jx.codec import JaxEncoder
from screenpressor_tpu.spec.codec import SpecEncoder
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch import blocks as tb
from screenpressor_tpu_torch import pframe as tp

from tests.test_spec_iframe import synth_desktop
from tests.test_spec_pframe import scrolling_sequence, typing_sequence
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import port_config

MSR = dict(msr_x=12, msr_y=12)


def _session_matches_jx(frames, cfg):
    ref = JaxEncoder(cfg).encode_batch(frames)
    got = TorchEncoder(port_config(cfg), "cpu").encode_batch(frames)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g == r, f"frame {i}: type or bytes differ from jx"
    out = TorchDecoder(port_config(cfg), "cpu").decode_batch([p for p, _ in got])
    for i, (o, f) in enumerate(zip(out, frames)):
        np.testing.assert_array_equal(o, f, err_msg=f"frame {i}")


@pytest.mark.parametrize("seq", ["typing", "scroll"])
def test_session_matches_jx(seq):
    if seq == "typing":
        frames, (h, w) = typing_sequence(32, 48, 4), (32, 48)
    else:
        frames, (h, w) = scrolling_sequence(48, 64, 4), (48, 64)
    _session_matches_jx(frames, CodecConfig(width=w, height=h, **MSR))


def test_mv_candidates_match_spec():
    from screenpressor_tpu.spec.blocks import mv_candidates

    for kw in (MSR, dict(msr_x=3, msr_y=5, msr_low_x=8, msr_low_y=8), {}):
        cfg = CodecConfig(width=64, height=48, **kw)
        assert tb.mv_candidates(port_config(cfg)) == mv_candidates(cfg)


def test_analysis_matches_spec():
    """Block types, sub-rects and motion vectors of the port's analysis are
    the normative ones (spec.blocks.analyze_p)."""
    from screenpressor_tpu.spec.blocks import analyze_p

    frames = scrolling_sequence(48, 64, 3)
    f2 = frames[2].copy()
    f2[5:9, 30:37] = (200, 30, 30)  # a data block inside the scroll
    cfg = CodecConfig(width=64, height=48, **MSR)
    for prev, cur in ((frames[0], frames[1]), (frames[1], f2)):
        bts, rects, mvs = analyze_p(cur, prev, cfg)
        cands = torch.tensor(tb.mv_candidates(port_config(cfg)), dtype=torch.int32)
        changed, rects_t, choice, _flat = (a[0] for a in tb.analyze_blocks_streams(
            torch.as_tensor(cur)[None], torch.as_tensor(prev)[None], cands))
        bts_t = tb.block_types_from(changed, changed & (choice < len(cands)), rects_t,
                                    cfg.nbx, cfg.height, cfg.width)
        np.testing.assert_array_equal(bts_t.numpy(), bts)
        for bi, rect in rects.items():
            assert tuple(rects_t[bi].tolist()) == rect
        for bi, mv in mvs.items():
            assert tuple(cands[choice[bi]].tolist()) == mv


def test_classify_assemble_matches_jx():
    rng = np.random.default_rng(3)
    h, w = 40, 56
    prev = synth_desktop(h, w, seed=4)
    cur = prev.copy()
    cur[3:14, 5:30] = rng.integers(0, 256, (11, 25, 3), dtype=np.uint8)
    cur[20:36, 16:32] = prev[21:37, 16:32]
    cur[33:40, 40:56] = (9, 9, 9)
    rects = np.asarray([[5, 3, 16, 14], [16, 3, 30, 14], [16, 20, 32, 36],
                        [40, 33, 56, 40]], np.int32)
    n_data = len(rects)
    pix_j, lit_j, cnt_j, _bm = jp.classify_assemble(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(rects), np.int32(n_data),
        h, w, n_data)
    pix_t, lit_t, cnt_t = tp.classify_assemble(
        torch.as_tensor(cur), torch.as_tensor(prev), torch.as_tensor(rects), n_data)
    n_pix, n_lit = (int(v) for v in np.asarray(cnt_j)[:2])
    assert cnt_t.tolist() == [n_pix, n_lit]
    np.testing.assert_array_equal(pix_t.numpy()[:n_pix], np.asarray(pix_j)[:n_pix])
    np.testing.assert_array_equal(lit_t.numpy()[:n_lit], np.asarray(lit_j)[:n_lit])


def test_motion_adjacent_data_block_predictors():
    """A data block next to a motion block reads its out-of-sub-rect
    predictors from the true previous frame, not the motion-applied one
    (held against the numpy spec encoder, which jx matches)."""
    rng = np.random.default_rng(11)
    h, w = 32, 48
    cfg = CodecConfig(width=w, height=h, msr_x=6, msr_y=6, kf_interval=10)
    prev = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    frame = prev.copy()
    frame[0:16, 0:16] = prev[2:18, 0:16]
    frame[0:16, 16] = prev[0:16, 15]
    frame[0:16, 17:32] = rng.integers(0, 256, (16, 15, 3), dtype=np.uint8)
    spec = SpecEncoder(cfg)
    ref = [spec.encode(f) for f in (prev, frame)]
    got = TorchEncoder(port_config(cfg), "cpu").encode_batch([prev, frame])
    assert got == ref
    out = TorchDecoder(port_config(cfg), "cpu").decode_batch([p for p, _ in got])
    np.testing.assert_array_equal(out[1], frame)
