"""The stream-axis split of the port's serving sessions (`devices=` of
BatchedEncoder / BatchedDecoder) on the CPU, tolerance 0: bytes against the
unsplit port session and the reference's dp-sharded BatchedEncoder on the
8 virtual devices of tests/conftest.py (the session of
`__graft_entry__.dryrun_multichip`: 2 streams a group at 4 groups, 48x64,
k_fixed 32, msr 16; I, scroll, typing, no change), lossless decode, the
damaged-stream message, the argument checks, and windows over a split
session against the unsplit window.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_serving_dp.py -q
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from __graft_entry__ import _synth_frame
from screenpressor_tpu.config import CodecConfig
from screenpressor_tpu.parallel import serving as jserving
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.parallel import serve_scan as ss
from screenpressor_tpu_torch.parallel.serving import (
    BatchedDecoder,
    BatchedEncoder,
    serve_pipelined,
)

from tests.test_serving import staggered_session_batches
from tests.torch_support import SERVING_SITE_FLIPS, damaged_serving_steps, flip, port_config
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

S, H, W = 8, 48, 64
CFG = CodecConfig(width=W, height=H, kf_interval=100, k_fixed=32, msr_x=16, msr_y=16)
# the staggered session's config and keyframe offsets
ST_CFG = CodecConfig(width=48, height=32, kf_interval=3, k_fixed=8, msr_x=8, msr_y=8)
ST_OFFSETS = [0, 1, 2, 0]


def graft_session():
    base = np.stack([_synth_frame(H, W, seed=i) for i in range(S)])
    typed = base.copy()
    typed[:, 20:26, 30:34] = (200, 30, 30)
    return [base, np.roll(base, 4, axis=1), typed, typed.copy()]


@pytest.fixture(scope="module")
def reference_dp4():
    """The reference's BatchedEncoder with its stream axis sharded over 4
    of the virtual devices: the bytes of every step."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    shard = NamedSharding(Mesh(np.asarray(jax.devices()[:4]), ("dp",)), PartitionSpec("dp"))
    enc = jserving.BatchedEncoder(S, CFG, sharding=shard)
    return [enc.encode(f) for f in graft_session()]


@pytest.fixture(scope="module")
def unsplit():
    enc = BatchedEncoder(S, port_config(CFG), "cpu")
    return [enc.encode(f) for f in graft_session()]


@pytest.mark.parametrize("n", [2, 4])
def test_split_bytes_equal_unsplit_and_reference(n, unsplit, reference_dp4):
    """Each step's bytes and types, split over n groups, equal the unsplit
    session's and the reference's dp-sharded session's; the decode (split
    the same way) is lossless."""
    enc = BatchedEncoder(S, port_config(CFG), kf_offsets=None, devices=["cpu"] * n)
    dec = BatchedDecoder(S, port_config(CFG), devices=["cpu"] * n)
    for t, frames in enumerate(graft_session()):
        outs = enc.encode(frames)
        assert outs == unsplit[t], f"step {t}: split != unsplit"
        assert outs == reference_dp4[t], f"step {t}: split != reference dp"
        back = dec.decode([p for p, _ in outs], device_out=t % 2 == 1)
        np.testing.assert_array_equal(np.asarray(back), frames, err_msg=f"step {t}")
    dec.validate()
    kinds = {(p[0] & 0x0F, len(p) == 2) for step in unsplit for p, _ in step}
    assert {(2, False), (3, False), (3, True)} <= kinds, kinds


@pytest.fixture(scope="module")
def staggered():
    """The staggered session (keyframes of some streams beside P streams, a
    flat transition, a no-change frame) and the unsplit session's bytes."""
    cfg = port_config(ST_CFG)
    batches = staggered_session_batches(4, 32, 48, steps=5)
    seq = BatchedEncoder(4, cfg, "cpu", kf_offsets=ST_OFFSETS)
    return cfg, batches, [seq.encode(b) for b in batches]


@pytest.mark.parametrize("n", [2, 4])
def test_split_staggered_pipelined(n, staggered):
    """The staggered session through serve_pipelined on split sessions: the
    unsplit session's bytes, lossless frames."""
    cfg, batches, want = staggered
    enc = BatchedEncoder(4, cfg, kf_offsets=ST_OFFSETS, devices=["cpu"] * n)
    dec = BatchedDecoder(4, cfg, devices=["cpu"] * n)
    for t, (outs, back) in enumerate(serve_pipelined(enc, batches, dec)):
        assert outs == want[t], f"step {t}"
        assert back.shape == (4, 32, 48, 3) and back.device.type == "cpu"
        np.testing.assert_array_equal(back.numpy(), batches[t], err_msg=f"step {t}")
    dec.validate()


@pytest.mark.parametrize("n", [2, 4])
def test_split_window_equals_unsplit_window(n, staggered):
    """encode_window / decode_window over a split session (every group's
    begin, then every group's finish) give the unsplit session's bytes (a
    window within its capacities: the sequential bytes, as
    tests/test_torch_serve_scan.py holds the unsplit window) and the
    frames."""
    cfg, batches, want = staggered
    # twice what the session needs (256, 128, 512, 256, 4 and 1024 B)
    wcfg = ss.WindowConfig(cfg, 4, f=4, rec_cap=512, col_cap=256, irec_cap=1024,
                           icol_cap=512, bcap=8, pack_cap=2048)
    enc = BatchedEncoder(4, cfg, kf_offsets=ST_OFFSETS, devices=["cpu"] * n)
    dec = BatchedDecoder(4, cfg, devices=["cpu"] * n)
    steps = [enc.encode(batches[0])]
    dec.decode([p for p, _ in steps[0]])
    steps += ss.encode_window_finish(ss.encode_window_begin(enc, batches[1:], wcfg))
    assert steps == want
    back = ss.decode_window(dec, [[p for p, _ in st] for st in steps[1:]])
    dec.validate()
    assert back.shape == (4, 4, 32, 48, 3)
    for t in range(4):
        np.testing.assert_array_equal(back[t].numpy(), batches[1 + t], err_msg=f"step {t}")


def test_split_damaged_stream_message_is_global():
    """A damaged stream of the second group raises the unsplit decoder's
    message, with the stream's global index, at the deferred check and at
    the parse."""
    cfg, steps, payloads, _ = damaged_serving_steps()
    bad = list(steps[2])
    bad[1] = flip(payloads[2], *SERVING_SITE_FLIPS[0])
    cut = list(steps[2])
    cut[3] = b""
    for damaged, label in ((bad, "stream 1: "), (cut, "stream 3: empty frame")):
        msgs = []
        for kw in ({"device": "cpu"}, {"devices": ["cpu"] * 4}):
            dec = BatchedDecoder(4, cfg, **kw)
            for step in steps[:2]:
                dec.decode(step)
            with pytest.raises(bs.CorruptStreamError) as e:
                dec.decode(damaged)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert msgs[1].startswith(label)


def test_split_rejects_bad_arguments():
    cfg = port_config(ST_CFG)
    for cls in (BatchedEncoder, BatchedDecoder):
        with pytest.raises(ValueError):
            cls(4, cfg, devices=["cpu"] * 3)
        with pytest.raises(ValueError):
            cls(4, cfg, devices=[])
        with pytest.raises(ValueError):
            cls(4, cfg, "cpu", devices=["cpu"] * 2)
        split = cls(4, cfg, devices=[torch.device("cpu")] * 2)
        assert [sl for _, sl in split.groups] == [slice(0, 2), slice(2, 4)]
