"""The port's serving sessions on the CPU: the pinned
`procedural_serving_kfixed` golden, the per-stream `TorchEncoder` /
`TorchDecoder` sessions (the byte oracle the card uses), BatchedDecoder
round trips, serve_pipelined against step-by-step, and the deferred stream
check (tolerance 0)."""

import json
import os
import zlib

import numpy as np
import pytest

from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.config import ALG_RAW, CodecConfig
from screenpressor_tpu_torch.convert import tables_to_numpy
from screenpressor_tpu_torch.parallel.serving import (
    BatchedDecoder,
    BatchedEncoder,
    serve_pipelined,
)

from tests.test_serving import staggered_session_batches
from tests.test_spec_iframe import synth_desktop
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tools.make_goldens import serving_session_frames

S, H, W, KF = 4, 32, 48, 3
OFFSETS = [0, 1, 2, 0]
CFG = CodecConfig(width=W, height=H, kf_interval=KF, k_fixed=8, msr_x=8, msr_y=8)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def session_with_raw():
    """The staggered session plus a step where stream 0 turns to noise on a
    P step (raw escape) and a step after it."""
    batches = staggered_session_batches(S, H, W)
    rng = np.random.default_rng(5)
    noisy = batches[-1].copy()
    noisy[0] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    after = noisy.copy()
    after[:, 2:6, 3:9] = (9, 200, 40)
    return batches + [noisy, after]


def test_procedural_serving_golden():
    meta = json.load(open(os.path.join(DATA, "golden_manifest.json")))[
        "procedural_serving_kfixed"]
    enc = BatchedEncoder(4, CFG, "cpu", kf_offsets=OFFSETS)
    payloads = []
    for fr in serving_session_frames(h=H, w=W, s=4):
        payloads.extend(p for p, _ in enc.encode(fr))
    assert [len(p) for p in payloads] == meta["sizes"]
    assert zlib.crc32(b"".join(payloads)) == meta["crc32"]


def test_matches_per_stream_sessions_and_decoders():
    """Every stream's bytes equal a TorchEncoder session with the same
    keyframe phase (force_key, kf_interval 0); BatchedDecoder is lossless,
    equals per-stream TorchDecoders, and its tables equal the encoder's."""
    single = CodecConfig(width=W, height=H, kf_interval=0, k_fixed=8, msr_x=8, msr_y=8)
    enc = BatchedEncoder(S, CFG, "cpu", kf_offsets=OFFSETS)
    dec = BatchedDecoder(S, CFG, "cpu")
    encs = [TorchEncoder(single, "cpu") for _ in range(S)]
    decs = [TorchDecoder(single, "cpu") for _ in range(S)]
    raw_seen = False
    for t, f in enumerate(session_with_raw()):
        outs = enc.encode(f)
        back = dec.decode([p for p, _ in outs])
        np.testing.assert_array_equal(back, f, err_msg=f"step {t}")
        for i in range(S):
            force = t > 0 and (t + OFFSETS[i]) % KF == 0
            assert outs[i] == encs[i].encode(f[i], force_key=force), (t, i)
            np.testing.assert_array_equal(decs[i].decode(outs[i][0]), back[i])
            raw_seen |= (outs[i][0][0] & 0x0F) == ALG_RAW
        want, got = tables_to_numpy(enc.tables_b), tables_to_numpy(dec.tables_b)
        for kd in want:
            for key in want[kd]:
                np.testing.assert_array_equal(got[kd][key], want[kd][key], err_msg=(t, kd))
    assert raw_seen, "fixture lost its raw escape"
    one = tables_to_numpy(enc.tables_b)
    ref = tables_to_numpy(encs[1].tables)
    for kd in ref:
        for key in ref[kd]:
            np.testing.assert_array_equal(one[kd][key][1], ref[kd][key])


def test_serve_pipelined_matches_step_by_step():
    batches = staggered_session_batches(S, H, W)
    enc_seq = BatchedEncoder(S, CFG, "cpu", kf_offsets=OFFSETS)
    dec_seq = BatchedDecoder(S, CFG, "cpu")
    want = []
    for b in batches:
        outs = enc_seq.encode(b)
        want.append((outs, dec_seq.decode([p for p, _ in outs])))
    enc = BatchedEncoder(S, CFG, "cpu", kf_offsets=OFFSETS)
    dec = BatchedDecoder(S, CFG, "cpu")
    got = list(serve_pipelined(enc, batches, dec))
    dec.validate()
    assert len(got) == len(batches)
    for t, ((outs, back), (w_outs, w_back), b) in enumerate(zip(got, want, batches)):
        assert outs == w_outs, f"step {t}: pipelined bytes differ"
        np.testing.assert_array_equal(back.cpu().numpy(), w_back, err_msg=f"step {t}")
        np.testing.assert_array_equal(w_back, b, err_msg=f"step {t}")


def test_deferred_error_names_first_bad_stream():
    """device_out defers the stream check to the next decode() / validate(),
    which names the first failing stream."""
    cfg = CodecConfig(width=W, height=H, kf_interval=0, k_fixed=4, msr_x=8, msr_y=8)
    base = np.stack([synth_desktop(H, W, seed=i) for i in range(2)])
    payloads = [p for p, _ in BatchedEncoder(2, cfg, "cpu").encode(base)]
    dec = BatchedDecoder(2, cfg, "cpu")
    dec.decode(payloads, device_out=True)
    dec.validate()
    # one record fewer shifts the lane deal: the records no longer tile the
    # frame, which only the device-side check sees
    (n_rec, n_lit), pos = bs.read_varint(payloads[1], 1, 2)
    assert n_rec - 1 >= n_lit > 0
    bad = payloads[1][:1] + bs.pack_varint(n_rec - 1, n_lit) + payloads[1][pos:]
    dec2 = BatchedDecoder(2, cfg, "cpu")
    dec2.decode([payloads[0], bad], device_out=True)
    with pytest.raises(bs.CorruptStreamError, match="stream 1"):
        dec2.validate()
    with pytest.raises(bs.CorruptStreamError, match="stream 1"):
        BatchedDecoder(2, cfg, "cpu").decode([payloads[0], bad])
