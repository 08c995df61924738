"""The port's streaming window server (`serve_windowed`,
screenpressor_tpu_torch/parallel/serve_scan.py) on the CPU, tolerance 0:
over sources of 1 to 3F + 1 steps it serves the plan that `plan_windows`
makes over the whole sequence, with the bytes and frames of that plan run
window by window; it pulls at most 2F - 1 batches beyond the last step it
has yielded, and serves a source with no end. Its spans and counters
(`telemetry`): each window span once a window (a group) with the unit of
the window's first step and, on a `devices=` split, the group's card; the
step and frame counters; no sync added.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_serve_windowed.py -q
"""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.config import CodecConfig
from screenpressor_tpu_torch.parallel import serve_scan as ss
from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

S, H, W, F = 4, 32, 48, 3
CFG = CodecConfig(width=W, height=H, kf_interval=3, k_fixed=8, msr_x=8, msr_y=8)
# capacities that hold every stream-step of screen_steps (no RAW escape),
# small: a K1 launch takes its step count from them
WCFG = ss.WindowConfig(CFG, S, f=F, c=2, rec_cap=128, col_cap=128, irec_cap=256,
                       icol_cap=256, pack_cap=4096)
WINDOW_SPANS = ("begin", "step", "finish", "pull", "assemble", "decode", "parse", "run")


def screen_steps(seed=11):
    """An endless source of [S, H, W, 3] steps: text lines on a page, a
    typed box in every stream, stream 1 scrolling, stream 2 flat every fifth
    step, stream 3 unchanged every fifth."""
    rng = np.random.default_rng(seed)
    page = np.full((S, H, W, 3), 236, np.uint8)
    for i in range(S):
        for y in range(2, H - 4, 6):
            page[i, y:y + 3, 3:int(rng.integers(10, W - 3)):2] = (20 + 40 * i, 20, 30)
    frames = page
    for t in itertools.count():
        f = frames.copy()
        if t:
            y, x = (t * 5) % (H - 4), (t * 7) % (W - 6)
            f[:, y:y + 3, x:x + 4] = ((t * 30) % 255, 80, 10)
            f[1] = np.roll(frames[1], 4, axis=0)
            if t % 5 == 3:
                f[2] = 9
            if t % 5 == 0:
                f[3] = frames[3]
        yield f
        frames = f


def sessions(offsets, devices=None):
    kw = dict(devices=devices) if devices else dict(device="cpu")
    return (BatchedEncoder(S, CFG, kf_offsets=offsets, **kw), BatchedDecoder(S, CFG, **kw))


def by_plan(enc, dec, batches, wcfg):
    """The whole sequence planned by plan_windows, then run by run."""
    plan = ss.plan_windows(enc, len(batches), wcfg)
    served, t = [], 0
    for kind, ln in plan:
        if kind == "window":
            steps = ss.encode_window(enc, batches[t:t + ln], wcfg)
            frames = ss.decode_window(dec, [[p for p, _ in o] for o in steps])
            served += [(o, frames[j]) for j, o in enumerate(steps)]
        else:
            o = enc.encode(batches[t])
            served.append((o, dec.decode([p for p, _ in o], device_out=True)))
        t += ln
    dec.validate()
    return plan, served


def streamed(enc, dec, source, wcfg, monkeypatch):
    """serve_windowed over `source`, and the runs it made."""
    runs = []
    begin, encode = ss.encode_window_begin, enc.encode

    def counted_begin(e, frames_list, w):
        runs.append(("window", len(frames_list)))
        return begin(e, frames_list, w)

    def counted_encode(frames, force_key=False):
        runs.append(("step", 1))
        return encode(frames, force_key)

    monkeypatch.setattr(ss, "encode_window_begin", counted_begin)
    enc.encode = counted_encode
    served = list(ss.serve_windowed(enc, source, dec, wcfg))
    dec.validate()
    return runs, served


class Counted:
    """An iterator that counts the batches pulled from it."""

    def __init__(self, source):
        self.source, self.pulled = source, 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.source)
        self.pulled += 1
        return batch


# (kf offsets, c, a step encoded before the source): windows from the
# session's start (step 0 keys every stream: a fallback step); c = 1 with
# two streams keying every third step; every stream keying every third step
CASES = {"session_start": ([0, 1, 2, 0], 2, False), "c1": ([0, 1, 2, 0], 1, True),
         "all_key": ([0, 0, 0, 0], 2, True)}


@pytest.mark.parametrize("n", range(1, 3 * F + 2))
@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_plan_bytes_and_frames_equal_the_list_path(case, n, monkeypatch):
    offsets, c, warm = CASES[case]
    wcfg = ss.WindowConfig(CFG, S, **{**vars(WCFG), "c": c})
    batches = list(itertools.islice(screen_steps(), n + warm))
    sides = []
    for _ in range(2):
        enc, dec = sessions(offsets)
        if warm:
            dec.decode([p for p, _ in enc.encode(batches[0])])
        sides.append((enc, dec))
    plan, want = by_plan(*sides[0], batches[warm:], wcfg)
    runs, got = streamed(*sides[1], iter(batches[warm:]), wcfg, monkeypatch)
    assert runs == plan
    if n > F:
        assert ("step", 1) in plan and any(k == "window" for k, _ in plan)
    assert len(got) == n
    for t, ((outs, back), (ref, ref_back)) in enumerate(zip(got, want)):
        assert outs == ref, f"step {t}"
        assert torch.equal(back, ref_back), f"step {t}"
        np.testing.assert_array_equal(back.numpy(), batches[warm + t], err_msg=f"step {t}")


def test_pulls_under_2f_ahead_of_the_last_step_yielded():
    src = Counted(itertools.islice(screen_steps(), 1 + 4 * F))
    enc, dec = sessions([0, 1, 2, 0])
    ahead = [src.pulled - (k + 1) for k, _ in enumerate(ss.serve_windowed(enc, src, dec, WCFG))]
    dec.validate()
    assert len(ahead) == 1 + 4 * F
    assert max(ahead) <= 2 * F + 1
    assert max(ahead) == 2 * F - 1  # the rest of a window, and the next one begun


def test_endless_source_three_windows():
    """An endless generator: the fallback step of the session's start, then
    three windows of F, then the server is stopped."""
    src = Counted(screen_steps())
    enc, dec = sessions([0, 1, 2, 0])
    server = ss.serve_windowed(enc, src, dec, WCFG)
    want = screen_steps()
    before = telemetry.counts()
    for k, (outs, back) in enumerate(itertools.islice(server, 1 + 3 * F)):
        assert len(outs) == S
        np.testing.assert_array_equal(back.numpy(), next(want), err_msg=f"step {k}")
        assert src.pulled <= k + 1 + 2 * F + 1
    server.close()
    after = telemetry.counts()
    assert after.get("serving.window.single_steps", 0) - before.get(
        "serving.window.single_steps", 0) == 1
    # the fourth window was begun before the third was yielded
    assert after["serving.window.steps"] - before.get("serving.window.steps", 0) == 4 * F


def window_spans(first, top):
    """The window spans recorded since index `first`, grouped under their
    top span `sptc.serve.window.<top>`: [(top span, {(name, card): count})]."""
    recs = telemetry.spans()
    out = []
    for i in range(first, len(recs)):
        if recs[i].name != f"sptc.serve.window.{top}":
            continue
        names = {}
        for j in range(i + 1, len(recs)):
            p = recs[j].parent
            while p > i:
                p = recs[p].parent
            if p == i and recs[j].name.startswith("sptc.serve.window."):
                key = (recs[j].name.rsplit(".", 1)[1], recs[j].card)
                names[key] = names.get(key, 0) + 1
        out.append((recs[i], names))
    return out


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "split"])
def test_window_spans_once_a_window(devices):
    """Steps 0 (fallback), 1-3 and 4-6 (windows): begin, finish and decode
    once a window with its first step's unit; under them, each group's F
    step spans, two pulls, one assembly, one parse and one run span, with
    the group's card on a split (None otherwise)."""
    enc, dec = sessions([0, 1, 2, 0], devices)
    first = len(telemetry.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        served = list(ss.serve_windowed(enc, itertools.islice(screen_steps(), 1 + 2 * F),
                                        dec, WCFG))
        dec.validate()
    assert len(served) == 1 + 2 * F
    cards = [None] if devices is None else [0, 1]
    want = {"begin": {("step", g): F for g in cards},
            "finish": {**{("pull", g): 2 for g in cards}, **{("assemble", g): 1 for g in cards}},
            "decode": {**{("parse", g): 1 for g in cards}, **{("run", g): 1 for g in cards}}}
    for top, children in want.items():
        got = window_spans(first, top)
        assert [s.unit for s, _ in got] == [1, 1 + F], top
        assert all(s.card is None for s, _ in got)
        assert all(names == children for _, names in got), (top, got)
    recs = telemetry.spans()[first:]
    names = {s.name.rsplit(".", 1)[1] for s in recs if s.name.startswith("sptc.serve.window.")}
    assert names == set(WINDOW_SPANS)
    if devices is not None:
        groups = [s for s in recs if s.name == "sptc.serve.group"
                  and recs[s.parent - first].name.startswith("sptc.serve.window.")]
        per_card = [sum(s.card == g for s in groups) for g in (0, 1)]
        assert per_card[0] == per_card[1] >= 6 and len(groups) == sum(per_card)
    pulls = [s for s in recs if s.name == "sync"
             and recs[s.parent - first].name == "sptc.serve.window.pull"]
    assert sorted({s.site for s in pulls}) == ["codec.gather", "serving.pull"]


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "split"])
def test_window_adds_no_sync(devices):
    """A window's host syncs: none to begin it, two a group to finish it
    (the lengths and kinds, the gather), none to decode it after a checked
    step, one a group to check it; recorded or not, the same count, one
    `sync` span each while recording."""
    counts = []
    for record in (False, True):
        enc, dec = sessions([0, 1, 2, 0], devices)
        steps = list(itertools.islice(screen_steps(), 1 + F))
        dec.decode([p for p, _ in enc.encode(steps[0])])
        first = len(telemetry.spans())
        marks = [telemetry.counts()["sync"]]
        with profile(activities=[ProfilerActivity.CPU]) if record else telemetry.NOOP:
            handle = ss.encode_window_begin(enc, steps[1:], WCFG)
            marks.append(telemetry.counts()["sync"])
            outs = ss.encode_window_finish(handle)
            marks.append(telemetry.counts()["sync"])
            ss.decode_window(dec, [[p for p, _ in o] for o in outs])
            marks.append(telemetry.counts()["sync"])
            dec.validate()
            marks.append(telemetry.counts()["sync"])
        counts.append(np.diff(marks).tolist())
        if record:
            n_spans = sum(s.name == "sync" for s in telemetry.spans()[first:])
            assert n_spans == marks[-1] - marks[0]
    groups = 1 if devices is None else 2
    assert counts == [[0, 2 * groups, 0, groups]] * 2


def test_step_and_frame_counters():
    """serving.window.steps + serving.window.single_steps = the steps
    served; the frame counters of the windows' kinds add up to S a window
    step, those of the fallback steps to S a step."""
    enc, dec = sessions([0, 0, 0, 0])
    names = ("serving.window.steps", "serving.window.single_steps", "frames.I", "frames.P",
             "frames.flat", "frames.unchanged", "frames.raw")
    before = telemetry.counts()
    served = list(ss.serve_windowed(enc, itertools.islice(screen_steps(), 3 * F + 1), dec,
                                    WCFG))
    dec.validate()
    after = telemetry.counts()
    d = {n: after.get(n, 0) - before.get(n, 0) for n in names}
    assert d["serving.window.steps"] + d["serving.window.single_steps"] == len(served) == 3 * F + 1
    assert d["serving.window.single_steps"] == 4  # steps 0, 3, 6, 9: every stream keys
    assert sum(d[n] for n in names[2:]) == S * len(served)
    assert d["frames.I"] >= 3 * S and d["frames.P"] > 0 and d["frames.flat"] > 0
