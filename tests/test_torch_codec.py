"""The port's sessions (TorchEncoder / TorchDecoder) on the CPU: pinned SPTC
goldens byte for byte, the JAX session frame by frame on a mixed batch with
loss, flat frames and the raw escape, lossless decode, and stream errors."""

import json
import os
import zlib

import numpy as np
import pytest

from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu.jx.codec import JaxEncoder
from screenpressor_tpu.spec.codec import apply_loss
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.config import ALG_RAW, CodecConfig
from screenpressor_tpu_torch.convert import tables_to_numpy

from tests.test_batch import H, W, session_frames
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import port_config

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

with open(os.path.join(DATA, "golden_manifest.json")) as fh:
    MANIFEST = json.load(fh)


def _split(blob, sizes):
    out, pos = [], 0
    for s in sizes:
        out.append(blob[pos: pos + s])
        pos += s
    assert pos == len(blob)
    return out


@pytest.mark.parametrize("hw", ["48x64", "49x67"])
def test_golden_spec_stream_reencodes(hw):
    name = f"golden_spec_{hw}.bin"
    meta = MANIFEST[name]
    with open(os.path.join(DATA, name), "rb") as fh:
        blob = fh.read()
    assert zlib.crc32(blob) == meta["crc32"], "fixture corrupted on disk"
    frames = np.load(os.path.join(DATA, f"golden_frames_{hw}.npy"))
    cfg = CodecConfig(width=meta["w"], height=meta["h"], kf_interval=meta["kf_interval"])
    got = TorchEncoder(cfg, "cpu").encode_batch(list(frames))
    payloads = _split(blob, meta["sizes"])
    for i, (p, _ft) in enumerate(got):
        assert p == payloads[i], f"{name}: frame {i} bytes drifted"
    out = TorchDecoder(cfg, "cpu").decode_batch(payloads)
    for i, (o, f) in enumerate(zip(out, frames)):
        np.testing.assert_array_equal(o, f, err_msg=f"{name}: frame {i} decode")


@pytest.mark.parametrize("loss", [0, 2])
def test_mixed_batch_matches_jx(loss):
    """Scroll / typing / idle / flat / noise and a raw escape, I and P; the
    col sections go through colw. Bytes and the final tables equal jx's."""
    frames = session_frames(8 if loss else 10)
    jcfg = RefCodecConfig(width=W, height=H, kf_interval=4, loss=loss)
    cfg = port_config(jcfg)
    jenc = JaxEncoder(jcfg)
    ref = jenc.encode_batch(frames)
    enc = TorchEncoder(cfg, "cpu")
    got = enc.encode_batch(frames)
    want_t, got_t = tables_to_numpy(jenc.tables), tables_to_numpy(enc.tables)
    for kd in want_t:
        for key in want_t[kd]:
            np.testing.assert_array_equal(got_t[kd][key], want_t[kd][key], err_msg=kd)
    assert any((p[0] & 0x0F) == ALG_RAW for p, _ in got), "fixture lost its raw escape"
    assert any(len(p) == 4 for p, _ in got), "fixture lost its flat frame"
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g == r, f"frame {i}: type or bytes differ from jx"
    out = TorchDecoder(cfg, "cpu").decode_batch([p for p, _ in got])
    for i, (o, f) in enumerate(zip(out, frames)):
        np.testing.assert_array_equal(o, apply_loss(f, loss), err_msg=f"frame {i}")


def test_split_batches_match_one_batch():
    frames = session_frames(6)
    cfg = CodecConfig(width=W, height=H, kf_interval=3)
    whole = TorchEncoder(cfg, "cpu").encode_batch(frames)
    enc = TorchEncoder(cfg, "cpu")
    parts = enc.encode_batch(frames[:2]) + [enc.encode(f) for f in frames[2:]]
    assert parts == whole
    dec = TorchDecoder(cfg, "cpu")
    out = dec.decode_batch([p for p, _ in whole[:3]]) + [dec.decode(p) for p, _ in whole[3:]]
    for o, f in zip(out, frames):
        np.testing.assert_array_equal(o, f)


def test_truncated_and_corrupt_payloads_raise():
    frames = session_frames(3)
    cfg = CodecConfig(width=W, height=H)
    data = [p for p, _ in TorchEncoder(cfg, "cpu").encode_batch(frames)]
    with pytest.raises(bs.CorruptStreamError):
        TorchDecoder(cfg, "cpu").decode_batch([data[0][: len(data[0]) // 2]])
    with pytest.raises(bs.CorruptStreamError):
        TorchDecoder(cfg, "cpu").decode_batch([data[0], data[1][:-3]])
    with pytest.raises(bs.CorruptStreamError):
        TorchDecoder(cfg, "cpu").decode_batch([data[1]])  # P before any I
    with pytest.raises(bs.CorruptStreamError):
        TorchDecoder(cfg, "cpu").decode_batch([b""])
    # a P frame with a changed xx1 header field: parse or deferred flags raise
    d1 = bytearray(data[1])
    d1[2] = (d1[2] + 1) & 0x7F  # xx1 of the header
    dec = TorchDecoder(cfg, "cpu")
    with pytest.raises(bs.CorruptStreamError):
        dec.decode_batch([data[0], bytes(d1)])
    assert dec.prev is None, "a failed batch must not advance the session"
