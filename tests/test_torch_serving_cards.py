"""The four-card conferencing host's split at a test size, on the CPU: 16
streams of 48x64 over `devices=["cpu"] * 4` (four groups of 4, one
controller), keyframes staggered as the benchmark's `conf-4x64x360p`
staggers them, `(arange(16) * kf) // 16` with kf 8 so that every group
keyframes inside 12 steps, and the `staggered` cycle (idle, scroll, a typed
box, idle; stream i rolled 3 i columns), through `serve_pipelined` with
`device_out=True`. Tolerance 0: every group's bytes against a one-device
session of that group's streams and offsets, every stream through the
NumPy reference decoder `spbench/reference/sptc.py`, the split's spans
(each group's carry its card and the step) and its byte counters.

This file imports no JAX:
    python -m pytest tests/test_torch_serving_cards.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_support import one_torch_thread  # noqa: F401 (autouse)

from screenpressor_tpu_torch import CodecConfig, telemetry
from screenpressor_tpu_torch.parallel import serving
from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder, serve_pipelined
from screenpressor_tpu_torch.synth import synth_frame
from spbench.reference.sptc import StreamDecoder

S, H, W, N_CARDS, STEPS, KF = 16, 48, 64, 4, 12, 8
CFG = CodecConfig(width=W, height=H, kf_interval=KF, k_fixed=8, msr_x=16, msr_y=16)
OFFSETS = (np.arange(S) * KF) // S
CYCLE = ("idle", "scroll", "type", "idle")
PAGE = np.concatenate([synth_frame(H, W, seed=k) for k in range(3)])
GROUP = S // N_CARDS
COUNTERS = ("serving.dp.scatter_bytes", "serving.dp.gather_bytes")


def _last(t, kinds):
    return max((j for j in range(1, t + 1) if CYCLE[j % len(CYCLE)] in kinds), default=0)


def step_frames(t):
    """Step t's [S, H, W, 3] frames: the page scrolled 8 rows a scroll step,
    a typed box shown from a type step until the next scroll, stream i
    rolled 3 i columns."""
    f = np.roll(PAGE, -8 * _last(t, ("scroll",)), axis=0)[:H].copy()
    typed = _last(t, ("scroll", "type"))
    if typed and CYCLE[typed % len(CYCLE)] == "type":
        y, x = 4 + (typed * 17) % (H - 12), 4 + (typed * 41) % (W - 10)
        f[y:y + 6, x:x + 4] = (200, 30, 30)
    return np.stack([np.roll(f, 3 * i, axis=1) for i in range(S)])


FRAMES = [step_frames(t) for t in range(STEPS)]


@pytest.fixture(scope="module")
def split():
    """The split session's payloads, decoded frames, spans and counter
    deltas over the 12 steps, recorded under a profiler."""
    enc = BatchedEncoder(S, CFG, kf_offsets=OFFSETS, devices=["cpu"] * N_CARDS)
    dec = BatchedDecoder(S, CFG, devices=["cpu"] * N_CARDS)
    first, before = len(telemetry.spans()), telemetry.counts()
    with profile(activities=[ProfilerActivity.CPU]):
        steps = [([p for p, _ in outs], back.clone())
                 for outs, back in serve_pipelined(enc, [torch.from_numpy(f) for f in FRAMES],
                                                   dec, device_out=True)]
        dec.validate()
    after = telemetry.counts()
    return {"payloads": [p for p, _ in steps], "decoded": [d for _, d in steps],
            "spans": telemetry.spans(), "first": first,
            "moved": {k: after[k] - before.get(k, 0) for k in COUNTERS}}


@pytest.mark.parametrize("card", range(N_CARDS))
def test_group_bytes_equal_one_device_session(card, split):
    """Group `card`'s payloads, every step, equal a one-device session of its
    4 streams and offsets; the group keyframes after step 0."""
    sl = slice(card * GROUP, (card + 1) * GROUP)
    enc = BatchedEncoder(GROUP, CFG, "cpu", kf_offsets=OFFSETS[sl])
    for t, (outs, _) in enumerate(serve_pipelined(enc, [f[sl] for f in FRAMES])):
        assert [p for p, _ in outs] == split["payloads"][t][sl], f"step {t}"
    later = [p[0] & 0x0F for step in split["payloads"][1:] for p in step[sl]]
    assert 2 in later, "no keyframe in the group after step 0"


@pytest.mark.parametrize("card", range(N_CARDS))
def test_reference_decodes_group_losslessly(card, split):
    """The NumPy reference decoder gives back every frame of every stream of
    the group from the split's bytes."""
    for s in range(card * GROUP, (card + 1) * GROUP):
        ref = StreamDecoder(H, W, CFG.k_fixed)
        for t in range(STEPS):
            np.testing.assert_array_equal(ref.decode(split["payloads"][t][s]), FRAMES[t][s],
                                          err_msg=f"stream {s}, step {t}")


def test_split_decodes_onto_first_device(split):
    """device_out gives one [S, H, W, 3] tensor a step, on devices[0], equal
    to the frames."""
    for t, got in enumerate(split["decoded"]):
        assert got.shape == (S, H, W, 3) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), FRAMES[t], err_msg=f"step {t}")


def test_group_spans_carry_card_and_step(split):
    """Each step's encode_begin and encode_finish hold one `sptc.serve.group`
    span a card, 0-3 in order, and its decode two (the deferred check of the
    step before, then the decode), with the step's unit; every span under a
    group span carries its card and unit; no other span carries a card, and
    the gather is one span a decode."""
    spans, first = split["spans"], split["first"]
    mine = spans[first:]

    def group_of(s):
        while s.parent >= first:
            s = spans[s.parent]
            if s.name == "sptc.serve.group":
                return s
        return None

    tops = [i for i in range(first, len(spans)) if spans[i].parent < first]
    # the session's last validate() runs outside any step: groups at the top
    assert {spans[i].name for i in tops} == {"sptc.serve.encode_begin", "sptc.serve.encode_finish",
                                             "sptc.serve.decode", "sptc.serve.group"}
    for i in (i for i in tops if spans[i].name != "sptc.serve.group"):
        top = spans[i]
        kids = [s for s in mine if s.parent == i and s.name == "sptc.serve.group"]
        rounds = 2 if top.name == "sptc.serve.decode" else 1
        assert [s.card for s in kids] == list(range(N_CARDS)) * rounds, top
        assert all(s.unit == top.unit for s in kids)
    for s in mine:
        g = s if s.name == "sptc.serve.group" else group_of(s)
        assert s.card == (None if g is None else g.card), s
        if g is not None:
            assert s.unit == g.unit and g.card in range(N_CARDS)
    gathers = [s for s in mine if s.name == "sptc.serve.decode.gather"]
    assert len(gathers) == STEPS and all(s.card is None for s in gathers)
    assert {s.name for s in mine if s.card is not None} >= {
        "sptc.serve.group", "sptc.serve.encode.p", "sptc.serve.encode.i",
        "sptc.serve.decode.parse", "sptc.serve.decode.run", "sync"}


def test_byte_counters_read_zero_on_one_device(split):
    """Groups on the frames' device move nothing between devices."""
    assert split["moved"] == {k: 0 for k in COUNTERS}


def test_byte_counters_count_device_changes():
    """A slice or a decoded group counts its bytes when it changes device
    (the meta device stands for another card) and 0 when it stays."""
    frames = torch.zeros((8, 4, 6, 3), dtype=torch.uint8)
    before = telemetry.counts()
    serving._to_group(frames, torch.device("meta"), slice(2, 4))
    serving._to_group(frames, torch.device("cpu"), slice(4, 6))
    out = serving._gather([frames[:2], frames[2:4].to("meta")], torch.device("meta"))
    after = telemetry.counts()
    assert out.shape == (4, 4, 6, 3) and out.device.type == "meta"
    assert {k: after[k] - before.get(k, 0) for k in COUNTERS} == {
        "serving.dp.scatter_bytes": 2 * 4 * 6 * 3, "serving.dp.gather_bytes": 2 * 4 * 6 * 3}
