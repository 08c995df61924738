"""The port's sessions own the frames they keep (CPU, tolerance 0): a
caller that refills one capture buffer in place for every frame gets the
bytes of fresh arrays, and a caller that writes into a decoded frame does
not change the frames decoded after it."""

import numpy as np
import pytest
import torch

from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch.config import CodecConfig
from screenpressor_tpu_torch.parallel.serving import (
    BatchedDecoder,
    BatchedEncoder,
    serve_pipelined,
)
from screenpressor_tpu_torch.synth import synth_screencast

from tests.test_serving import staggered_session_batches
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

H, W = 48, 64
CFG = CodecConfig(width=W, height=H, msr_x=8, msr_y=8)
S_CFG = CodecConfig(width=48, height=32, kf_interval=3, k_fixed=8, msr_x=8, msr_y=8)


def _refilled(frames, kind):
    """Yield every frame through one buffer refilled in place."""
    buf = np.zeros_like(frames[0]) if kind == "numpy" else torch.zeros(frames[0].shape,
                                                                       dtype=torch.uint8)
    for f in frames:
        buf[...] = f if kind == "numpy" else torch.as_tensor(f)
        yield buf


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_encoder_capture_buffer_refilled_in_place(kind):
    frames = synth_screencast(H, W, 5)
    want = TorchEncoder(CFG, "cpu").encode_batch([f.copy() for f in frames])
    enc = TorchEncoder(CFG, "cpu")
    assert [enc.encode(buf) for buf in _refilled(frames, kind)] == want


def test_batched_encoder_capture_buffer_refilled_in_place():
    """Step by step and through serve_pipelined, whose lookahead reads step
    t's frames after the caller has refilled the buffer with step t+1."""
    batches = staggered_session_batches(4, 32, 48)
    offsets = [0, 1, 2, 0]
    enc = BatchedEncoder(4, S_CFG, "cpu", kf_offsets=offsets)
    want = [enc.encode(b.copy()) for b in batches]
    enc = BatchedEncoder(4, S_CFG, "cpu", kf_offsets=offsets)
    assert [enc.encode(buf) for buf in _refilled(batches, "numpy")] == want
    enc = BatchedEncoder(4, S_CFG, "cpu", kf_offsets=offsets)
    got = [outs for outs, _ in serve_pipelined(enc, _refilled(batches, "numpy"))]
    assert got == want


@pytest.mark.parametrize("device_out", [False, True])
def test_decoder_output_written_by_the_caller(device_out):
    frames = synth_screencast(H, W, 5)
    payloads = [p for p, _ in TorchEncoder(CFG, "cpu").encode_batch(frames)]
    dec = TorchDecoder(CFG, "cpu")
    for i, p in enumerate(payloads):
        (out,) = dec.decode_batch([p], device_out=device_out)
        np.testing.assert_array_equal(np.asarray(out), frames[i], err_msg=f"frame {i}")
        out[...] = 7


@pytest.mark.parametrize("device_out", [False, True])
def test_batched_decoder_output_written_by_the_caller(device_out):
    batches = staggered_session_batches(4, 32, 48)
    enc = BatchedEncoder(4, S_CFG, "cpu", kf_offsets=[0, 1, 2, 0])
    dec = BatchedDecoder(4, S_CFG, "cpu")
    for t, b in enumerate(batches):
        out = dec.decode([p for p, _ in enc.encode(b)], device_out=device_out)
        dec.validate()
        np.testing.assert_array_equal(np.asarray(out), b, err_msg=f"step {t}")
        out[...] = 7
