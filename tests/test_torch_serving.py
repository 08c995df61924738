"""The port's multi-stream serving encoder (parallel/serving.py) against the
JAX reference's, step by step on the staggered mixed-kind session: bytes
and every stream's table state after each step (tolerance 0)."""

import numpy as np
import pytest

from screenpressor_tpu.config import ALG_FLAT, ALG_I, ALG_P, CodecConfig
from screenpressor_tpu.parallel import serving as jserving
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.convert import tables_to_numpy
from screenpressor_tpu_torch.parallel.serving import BatchedEncoder

from tests.test_serving import staggered_session_batches
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import port_config

S, H, W = 4, 32, 48
OFFSETS = [0, 1, 2, 0]
CFG = CodecConfig(width=W, height=H, kf_interval=3, k_fixed=8, msr_x=8, msr_y=8)


@pytest.fixture(scope="module")
def jx_session():
    """(outs, tables_b as numpy) of jx's BatchedEncoder after every step."""
    enc = jserving.BatchedEncoder(S, CFG, kf_offsets=OFFSETS)
    steps = []
    for f in staggered_session_batches(S, H, W):
        outs = enc.encode(f)
        steps.append((outs, tables_to_numpy(enc.tables_b)))
    return steps


@pytest.fixture(scope="module")
def port_session(monkeypatch_module):
    """The port's session on the same batches, counting colw rewrites."""
    calls = []
    real = tc.color_compact_streams

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch_module.setattr(tc, "color_compact_streams", counted)
    enc = BatchedEncoder(S, port_config(CFG), "cpu", kf_offsets=OFFSETS)
    steps = []
    for f in staggered_session_batches(S, H, W):
        outs = enc.encode(f)
        steps.append((outs, tables_to_numpy(enc.tables_b)))
    return steps, calls


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_session_shapes_cover_every_frame_kind(jx_session):
    """The fixture mixes keyframes, P frames, a flat transition and a
    no-change frame, and a keyframe step shares a batch with P streams."""
    kinds = {(p[0] & 0x0F, len(p) == 2) for outs, _ in jx_session for p, _ in outs}
    want = {(ALG_FLAT, False), (ALG_I, False), (ALG_P, False), (ALG_P, True)}
    assert want <= kinds, kinds
    assert any(len({ft for _, ft in outs}) == 2 for outs, _ in jx_session)


@pytest.mark.parametrize("step", range(7))
def test_bytes_and_tables_match_jx_every_step(jx_session, port_session, step):
    want_outs, want_tabs = jx_session[step]
    got_outs, got_tabs = port_session[0][step]
    for i in range(S):
        assert got_outs[i] == want_outs[i], f"step {step} stream {i}: bytes or type differ"
    for kd in want_tabs:
        for key in want_tabs[kd]:
            np.testing.assert_array_equal(got_tabs[kd][key], want_tabs[kd][key],
                                          err_msg=f"step {step}: table {kd}.{key}")


def test_colw_ran_on_batched_sections(port_session):
    """The batched I and P col sections went through the colw rewrite."""
    calls = port_session[1]
    assert calls and max(calls) > 1, calls
