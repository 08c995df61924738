"""The port's stream-batched P decode (pframe.rebuild_p_streams, one call for
every coded P stream of a BatchedDecoder step) on the CPU: against a loop
of per-stream pframe.rebuild_p calls (pixels and error words), against the
reference's BatchedDecoder step by step, with one damaged stream among
clean ones (its verdict equals its per-stream and jx verdicts, the other
streams' frames equal their clean decode), and coder.undeal_streams
against per-stream undeal. Tolerance 0."""

import copy
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.bitstream import CorruptStreamError as RefCorrupt
from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu.jx import coder as jc
from screenpressor_tpu.jx.codec import JaxDecoder
from screenpressor_tpu.parallel import serving as jserving
from screenpressor_tpu_torch import TorchDecoder
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import pframe
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P, CodecConfig
from screenpressor_tpu_torch.parallel import serving as ts

from tests.test_serving import staggered_session_batches
from tests.test_spec_iframe import synth_desktop
from tests.torch_support import damaged_serving_steps, rebuild_p_loop, record_index_sites
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

S, H, W, KF = 5, 32, 48, 8
# streams 0-3 never keyframe after step 0; stream 4 keyframes at step 3
OFFSETS = [1, 1, 1, 1, 5]
CFG = CodecConfig(width=W, height=H, kf_interval=KF, k_fixed=8, msr_x=8, msr_y=8)


def mixed_session_batches(steps=6):
    """Stream 0 scrolls (motion and partial blocks), 1 types (data blocks
    with literals), 2 idles, 3 is flat and 4 keyframes at step 3."""
    base = synth_desktop(H + 4 * steps, W, seed=21)
    typing = synth_desktop(H, W, seed=22)
    other = synth_desktop(H, W, seed=23)
    rng = np.random.default_rng(24)
    batches = []
    for t in range(steps):
        typing = typing.copy()
        if t:
            y, x = 3 + 5 * t, 4 + 7 * t
            typing[y:y + 4, x:x + 3] = rng.integers(0, 256, 3)
            typing[y + 1, x + 5] = rng.integers(0, 256, 3)
        kf = other.copy()
        kf[(3 * t) % H:(3 * t) % H + 5, 10:30] = (40 * t, 200, 90)
        batches.append(np.stack([base[2 * t:2 * t + H], typing, other,
                                 np.full((H, W, 3), (12, 34, 56), np.uint8), kf]))
    return batches


SESSIONS = {
    "mixed": (lambda: mixed_session_batches(), S, CFG, OFFSETS),
    "staggered": (lambda: staggered_session_batches(4, H, W),
                  4, CodecConfig(width=W, height=H, kf_interval=3, k_fixed=8, msr_x=8,
                                 msr_y=8), [0, 1, 2, 0]),
}


def _encode(name):
    make, s, cfg, offsets = SESSIONS[name]
    enc = ts.BatchedEncoder(s, cfg, "cpu", kf_offsets=offsets)
    batches = make()
    return batches, [[p for p, _ in enc.encode(f)] for f in batches]


def _checked_rebuilds(monkeypatch, cfg):
    """Hold every rebuild_p_streams call of the serving decoder to
    rebuild_p stream by stream on the same inputs; returns the list of each
    call's stream count."""
    real = ts.rebuild_p_streams
    calls = []

    def checked(recs, lay, prev, cfg_):
        frames, err = real(recs, lay, prev, cfg_)
        want_frames, want_err = rebuild_p_loop(recs, lay.hdr.numpy(), prev, cfg)
        for j in range(len(prev)):
            assert torch.equal(frames[j], want_frames[j]), f"stream {j}: pixels differ"
            assert int(err[j]) == int(want_err[j]), f"stream {j}: err {int(err[j])}"
        calls.append(len(prev))
        return frames, err

    monkeypatch.setattr(ts, "rebuild_p_streams", checked)
    return calls


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_rebuild_streams_equals_per_stream_loop(session, monkeypatch):
    """Each step's one rebuild_p_streams call covers every coded P stream
    and equals per-stream rebuild_p exactly; the decode is lossless."""
    batches, steps = _encode(session)
    cfg = SESSIONS[session][2]
    calls = _checked_rebuilds(monkeypatch, cfg)
    dec = ts.BatchedDecoder(len(steps[0]), cfg, "cpu")
    algs = set()
    for t, (f, payloads) in enumerate(zip(batches, steps)):
        n_calls = len(calls)
        np.testing.assert_array_equal(dec.decode(payloads), f, err_msg=f"step {t}")
        coded_p = [p for p in payloads if bs.parse_header_byte(p[0]) == ALG_P and p[1] & 1]
        assert calls[n_calls:] == ([len(coded_p)] if coded_p else []), f"step {t}"
        algs |= {(i, bs.parse_header_byte(p[0]), len(p) > 2) for i, p in enumerate(payloads)}
    assert max(calls) >= 2, "no step decodes two coded P streams at once"
    if session == "mixed":
        # every kind of stream the session stands for, in one run
        assert {(0, ALG_P, True), (1, ALG_P, True), (2, ALG_P, False), (3, ALG_FLAT, True),
                (4, ALG_I, True)} <= algs, algs


def test_fixture_has_motion_partial_and_literal_blocks():
    """The mixed session's P streams carry motion blocks, partial blocks
    and literals (counts from the parsed headers)."""
    _, steps = _encode("mixed")
    got = {"mv": 0, "sxy": 0, "col": 0}
    for payloads in steps[1:]:
        for i in (0, 1):
            parsed = pframe.parse_p_header(payloads[i], 1, CFG)
            if parsed is not None:
                for name in got:
                    got[name] += parsed[1][name]
    assert all(got.values()), got


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_batched_decoder_equals_reference(session):
    """The port's BatchedDecoder and the reference's give equal frames at
    every step of the same payloads."""
    batches, steps = _encode(session)
    _, s, cfg, _ = SESSIONS[session]
    ref_cfg = RefCodecConfig(width=cfg.width, height=cfg.height, kf_interval=cfg.kf_interval,
                             k_fixed=cfg.k_fixed, msr_x=cfg.msr_x, msr_y=cfg.msr_y)
    dec = ts.BatchedDecoder(s, cfg, "cpu")
    ref = jserving.BatchedDecoder(s, ref_cfg)
    for t, (f, payloads) in enumerate(zip(batches, steps)):
        got = dec.decode(payloads)
        np.testing.assert_array_equal(got, np.asarray(ref.decode(payloads)), err_msg=f"step {t}")
        np.testing.assert_array_equal(got, f, err_msg=f"step {t}")


# one damaged stream among clean ones: stream 1 of 4 (48x64, k_fixed 8)
# carries tests/test_torch_corrupt.py's damaged serving payloads
D_CFG, D_STEPS, D_PAYLOADS, D_DAMAGED = damaged_serving_steps()
D_STREAMS, D_BAD = 4, 1
D_CASES = {"flips_0_20": D_DAMAGED[:20], "flips_20_40": D_DAMAGED[20:40],
           "index_sites": D_DAMAGED[40:]}


def _outcome(fn):
    """("ok", fn()) or ("corrupt", the error's message without its stream
    or frame prefix)."""
    try:
        return "ok", fn()
    except (bs.CorruptStreamError, RefCorrupt) as e:
        return "corrupt", re.sub(r"^(stream|frame) \d+: ", "", str(e))


@pytest.mark.parametrize("damage", sorted(D_CASES))
def test_damaged_stream_among_clean_streams(damage, monkeypatch):
    """Stream 1 of a step carries a damaged payload: the step's verdict is
    the one of stream 1's per-stream decode (same message, or same pixels)
    and of jx's, and the other streams' frames equal their clean decode."""
    hits = record_index_sites(monkeypatch)
    calls = _checked_rebuilds(monkeypatch, D_CFG)
    ref_cfg = RefCodecConfig(width=D_CFG.width, height=D_CFG.height, k_fixed=8)
    before = {}
    for i in sorted({i for i, _ in D_CASES[damage]}):
        dec = ts.BatchedDecoder(D_STREAMS, D_CFG, "cpu")
        for step in D_STEPS[:i]:
            dec.decode(step)
        before[i] = dec, copy.deepcopy(dec).decode(D_STEPS[i])
    calls.clear()
    verdicts, decoded, by_err_word = set(), [], 0
    for c, (i, data) in enumerate(D_CASES[damage]):
        dec, clean = copy.deepcopy(before[i][0]), before[i][1]
        payloads = list(D_STEPS[i])
        payloads[D_BAD] = data
        hits.clear()

        def batched():
            out = dec.decode(payloads, device_out=True).numpy()
            decoded.append(c)
            for j in range(D_STREAMS):
                if j != D_BAD:
                    np.testing.assert_array_equal(out[j], clean[j], err_msg=(
                        f"case {c}: stream {j} changed beside the damaged stream"))
            dec.validate()
            return out[D_BAD]

        def single(dec1):
            dec1.decode_batch(D_PAYLOADS[:i])
            return np.asarray(dec1.decode_batch([data])[0])

        got = _outcome(batched)
        want = _outcome(lambda: single(TorchDecoder(D_CFG, "cpu")))
        jx_verdict = _outcome(lambda: single(JaxDecoder(ref_cfg)))[0]
        assert got[0] == want[0] == jx_verdict, (c, i, got[0], want[0], jx_verdict)
        if got[0] == "corrupt":
            assert got[1] == want[1], f"case {c} (frame {i})"
        else:
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"case {c}")
        verdicts.add(got[0])
        by_err_word += got[0] == "corrupt" and decoded[-1:] == [c]
        if damage == "index_sites":
            assert hits, f"case {c} reaches no index site"
    assert "corrupt" in verdicts
    assert by_err_word, "no damaged payload reached the device error word"
    assert len(calls) == len(decoded), "a decoded step skipped the stream-batched rebuild"


@pytest.mark.parametrize("k", [4, 8])
def test_undeal_streams_equals_undeal(k):
    """Counts 0, 1, k - 1, k and k + 1 in one batch: each stream's rows
    equal undeal of its own records (and jx's undeal_device); rows past a
    stream's count are zero."""
    counts = [0, 1, k - 1, k, k + 1]
    t = tc.steps_for(max(counts), k)
    rng = np.random.default_rng(k)
    cap = max(max(counts), 1)
    scan = torch.as_tensor(rng.integers(1, 1000, (len(counts), t, k, 3)), dtype=torch.int32)
    got = tc.undeal_streams(scan, torch.tensor(counts), k, cap + 2)
    assert got.shape == (len(counts), cap + 2, 3)
    for j, n in enumerate(counts):
        one = tc.undeal(scan[j], n, k, max(n, 1))
        np.testing.assert_array_equal(got[j, :max(n, 1)].numpy(), one.numpy(), err_msg=str(n))
        assert not got[j, n:].any(), n
        ref = jc.undeal_device(jnp.asarray(scan[j].numpy()), n, k, max(n, 1))
        np.testing.assert_array_equal(one.numpy(), np.asarray(ref), err_msg=str(n))
