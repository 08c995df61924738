"""The port's telemetry (`screenpressor_tpu_torch.telemetry`): spans that
record only under torch.profiler, the host-sync counter, the work counters,
and outputs that do not depend on recording. The `gpu` tests hold the
spans' clock to the profiler's device times and the sync counter to torch's
sync debug mode on a card.

This file imports no JAX, so its card tests also run on a machine without it:
    python -m pytest --noconftest tests/test_torch_telemetry.py -q -m gpu
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch_support import one_torch_thread  # noqa: F401 (autouse)

from screenpressor_tpu_torch import (
    CodecConfig,
    Decoder,
    Encoder,
    FormatParams,
    PixelFormat,
    TorchDecoder,
    TorchEncoder,
    telemetry,
)
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P
from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder, serve_pipelined
from screenpressor_tpu_torch.synth import synth_screencast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 176
RGB32 = FormatParams(PixelFormat.RGB32)


def desktop_frames():
    """A keyframe, then each P kind: a scroll (motion), typing (data
    blocks), an unchanged frame, a flat frame; RGB32 with alpha 7."""
    frames = synth_screencast(H, W, 4) + [np.full((H, W, 3), (9, 80, 200), np.uint8)]
    return [np.concatenate([f, np.full((H, W, 1), 7, np.uint8)], axis=-1) for f in frames]


def serving_steps(n_steps=3, n_streams=3):
    base = synth_screencast(64, 96, n_steps, seed=2)
    return [np.stack([np.roll(base[t], 5 * i, axis=1) for i in range(n_streams)])
            for t in range(n_steps)]


SERVE_CFG = CodecConfig(width=96, height=64, kf_interval=4, k_fixed=8, msr_x=16, msr_y=16)


def collecting():
    return profile(activities=[ProfilerActivity.CPU])


def new_spans(first):
    return telemetry.spans()[first:]


def by_index(spans, first, i):
    return spans[i - first] if i >= first else None


# -- (a) no profiler: nothing recorded, counters count -------------------------

def test_span_without_profiler_is_shared_and_records_nothing():
    assert telemetry.span("a") is telemetry.span("b", unit=3) is telemetry.NOOP
    before = len(telemetry.spans())
    n_sync, n_frames = telemetry.counts()["sync"], telemetry.counts().get("frames.I", 0)
    assert telemetry.sync("here") is telemetry.NOOP
    enc = Encoder(CodecConfig(width=W, height=H), RGB32, device="cpu")
    pays = [p for p, _ in enc.encode_batch(desktop_frames())]
    Decoder(CodecConfig(width=W, height=H), RGB32, device="cpu").decode_batch(pays)
    assert len(telemetry.spans()) == before
    got = telemetry.counts()
    assert got["sync"] > n_sync + 1
    assert got["frames.I"] == n_frames + 1
    assert {"launch.sptc_sections_encode", "launch.sptc_rebuild_blocks"} <= set(got)


def test_counters_count_frame_kinds_and_blocks():
    telemetry.reset()
    enc = TorchEncoder(CodecConfig(width=W, height=H), "cpu")
    outs = enc.encode_batch([f[..., :3] for f in desktop_frames()])
    got = telemetry.counts()
    assert [got.get(f"frames.{k}", 0) for k in ("I", "P", "unchanged", "flat", "raw")] == [
        1, 2, 1, 1, 0]
    assert got["blocks.data"] > 0 and got["blocks.motion"] > 0
    assert [t for _, t in outs] == [0, 1, 1, 1, 0]
    telemetry.reset()
    assert telemetry.counts()["sync"] == 0 and telemetry.spans() == []


def test_decode_lanes_counter_counts_the_step_parse():
    """`serving.decode.lanes`: sections x k_fixed x coded streams a step (5
    sections a P frame, 2 a keyframe); 0 on steps of unchanged or flat
    frames."""
    cfg = CodecConfig(width=W, height=H, kf_interval=8, k_fixed=8, msr_x=16, msr_y=16)
    enc, dec = BatchedEncoder(3, cfg, "cpu"), BatchedDecoder(3, cfg, "cpu")
    # a keyframe, a scroll, typing, an idle frame; then two flat frames
    steps = [np.stack([np.roll(f, 5 * i, axis=1) for i in range(3)])
             for f in synth_screencast(H, W, 4)]
    flat = np.full_like(steps[0], 77)
    got = []
    for frames in steps + [flat, flat]:
        pays = [p for p, _ in enc.encode(frames)]
        before = telemetry.counts().get("serving.decode.lanes", 0)
        dec.decode(pays)
        kinds = [(p[0] & 0x0F) if len(p) > 2 else "unchanged" for p in pays]
        got.append((kinds, telemetry.counts().get("serving.decode.lanes", 0) - before))
    k = cfg.k_fixed
    assert got == [([ALG_I] * 3, 2 * k * 3), ([ALG_P] * 3, 5 * k * 3), ([ALG_P] * 3, 5 * k * 3),
                   (["unchanged"] * 3, 0), ([ALG_FLAT] * 3, 0), ([ALG_FLAT] * 3, 0)], got


def test_encode_lanes_counter_counts_the_step_writer():
    """`serving.encode.lanes`: the non-empty lanes of a step's coded I and P
    sections, read back from the containers the step wrote; 0 on steps of
    unchanged or flat frames."""
    from screenpressor_tpu_torch.iframe import read_i_container
    from screenpressor_tpu_torch.pframe import read_p_container

    cfg = CodecConfig(width=W, height=H, kf_interval=8, k_fixed=8, msr_x=16, msr_y=16)
    enc = BatchedEncoder(3, cfg, "cpu")
    steps = [np.stack([np.roll(f, 5 * i, axis=1) for i in range(3)])
             for f in synth_screencast(H, W, 4)]
    flat = np.full_like(steps[0], 77)

    def written_lanes(data):
        alg = data[0] & 0x0F
        if alg == ALG_I:
            lanes = read_i_container(data, 1, enc.cfg)[:2]
        elif alg == ALG_P and len(data) > 2:
            lanes = read_p_container(data, 1, enc.cfg)[0]
        else:
            return 0
        return sum(int(np.count_nonzero(sizes)) for sizes, _, _ in lanes)

    got, want = [], []
    for frames in steps + [flat, flat]:
        before = telemetry.counts().get("serving.encode.lanes", 0)
        pays = [p for p, _ in enc.encode(frames)]
        got.append(telemetry.counts().get("serving.encode.lanes", 0) - before)
        want.append(sum(written_lanes(p) for p in pays))
    assert got == want, (got, want)
    assert all(n > 0 for n in got[:3]) and got[3:] == [0, 0, 0], got


# -- (b) the spans' names, parents and units -------------------------------------

CALLS = {"sptc.api.encode": None, "sptc.api.decode": None,
         "sptc.codec.encode": "sptc.api.encode", "sptc.codec.decode": "sptc.api.decode"}
STAGES = {"sptc.api.encode.convert": "sptc.api.encode",
          "sptc.api.decode.convert": "sptc.api.decode",
          "sptc.blocks.analysis": "sptc.codec.encode.analysis",
          "sptc.blocks.compact": "sptc.blocks.analysis",
          "sptc.pframe.resolve": "sptc.codec.decode.queue",
          **{f"sptc.codec.encode.{s}": "sptc.codec.encode"
             for s in ("upload", "analysis", "classify", "sections", "gather", "assemble")},
          **{f"sptc.codec.decode.{s}": "sptc.codec.decode" for s in ("queue", "check", "pull")}}


def test_desktop_spans_parents_and_units():
    cfg = CodecConfig(width=W, height=H)
    enc, dec = Encoder(cfg, RGB32, device="cpu"), Decoder(cfg, RGB32, device="cpu")
    frames = desktop_frames()
    first = len(telemetry.spans())
    with collecting():
        for _ in range(2):  # units 0 and 5: each batch's first frame number
            dec.decode_batch([p for p, _ in enc.encode_batch(frames)])
    spans = new_spans(first)
    names = {s.name for s in spans}
    assert names == set(CALLS) | set(STAGES) | {"sync"}
    for s in spans:
        parent = by_index(spans, first, s.parent)
        want = CALLS.get(s.name, STAGES.get(s.name))
        if s.name == "sync":
            assert parent is not None and parent.name in set(STAGES) | set(CALLS), s
            assert s.site
        else:
            assert (parent.name if parent else None) == want, s
        assert s.unit in (0, len(frames)) and s.start_ns <= s.end_ns
    assert [s.unit for s in spans if s.name == "sptc.api.encode"] == [0, len(frames)]


def test_serving_lookahead_spans_and_units():
    enc = BatchedEncoder(3, SERVE_CFG, "cpu", kf_offsets=[0, 1, 2])
    dec = BatchedDecoder(3, SERVE_CFG, "cpu")
    first = len(telemetry.spans())
    with collecting():
        for _ in serve_pipelined(enc, serving_steps(), dec):
            pass
    spans = new_spans(first)
    top = [(s.name, s.unit) for s in spans if s.parent < first]
    assert top == [("sptc.serve.encode_begin", 0), ("sptc.serve.encode_begin", 1),
                   ("sptc.serve.encode_finish", 0), ("sptc.serve.decode", 0),
                   ("sptc.serve.encode_begin", 2), ("sptc.serve.encode_finish", 1),
                   ("sptc.serve.decode", 1), ("sptc.serve.encode_finish", 2),
                   ("sptc.serve.decode", 2)]
    for s in spans:
        parent = by_index(spans, first, s.parent)
        if s.name in ("sptc.serve.encode.p", "sptc.serve.encode.i"):
            assert parent.name in ("sptc.serve.encode_begin", "sptc.serve.encode_finish")
        if s.name.startswith("sptc.serve.decode."):
            assert parent.name == "sptc.serve.decode"
        if s.name == "sync":
            assert parent is not None and parent.name.startswith("sptc."), s
        assert s.unit == (s.unit if parent is None else parent.unit)
    names = {s.name for s in spans}
    assert {"sptc.serve.encode.p", "sptc.serve.encode.i", "sptc.serve.decode.parse",
            "sptc.serve.decode.upload", "sptc.serve.decode.run", "sync"} <= names


def test_summary_self_and_sync_time():
    first = len(telemetry.spans())
    with collecting():
        with telemetry.span("outer", unit=41):
            with telemetry.span("inner"):
                with telemetry.sync("site"):
                    pass
    spans = new_spans(first)
    assert [(s.name, s.unit) for s in spans] == [("outer", 41), ("inner", 41), ("sync", 41)]
    row = telemetry.summary(units={41})
    wall = {s.name: s.end_ns - s.start_ns for s in spans}
    assert row["outer"]["self_ns"] == wall["outer"] - wall["inner"]
    assert row["outer"]["sync_ns"] == row["inner"]["sync_ns"] == wall["sync"]
    assert row["sync"]["calls"] == 1 and telemetry.syncs("outer", units={41}) == [spans[2]]
    assert telemetry.syncs("other", units={41}) == []


# -- (c) outputs identical with recording on and off -----------------------------

def _twice(run):
    off = run()
    with collecting():
        on = run()
    return off, on


def test_session_outputs_equal_recording_on_and_off():
    frames = desktop_frames()

    def torch_session():
        cfg = CodecConfig(width=W, height=H)
        pays = [p for p, _ in TorchEncoder(cfg, "cpu").encode_batch([f[..., :3] for f in frames])]
        return pays, TorchDecoder(cfg, "cpu").decode_batch(pays)

    def api_session():
        cfg = CodecConfig(width=W, height=H)
        pays = [p for p, _ in Encoder(cfg, RGB32, device="cpu").encode_batch(frames)]
        return pays, Decoder(cfg, RGB32, device="cpu").decode_batch(pays)

    for run in (torch_session, api_session):
        (p_off, f_off), (p_on, f_on) = _twice(run)
        assert p_off == p_on
        for a, b in zip(f_off, f_on):
            np.testing.assert_array_equal(a, b)


def test_serving_outputs_equal_recording_on_and_off():
    def run():
        enc = BatchedEncoder(3, SERVE_CFG, "cpu", kf_offsets=[0, 1, 2])
        dec = BatchedDecoder(3, SERVE_CFG, "cpu")
        return [([p for p, _ in outs], got.clone())
                for outs, got in serve_pipelined(enc, serving_steps(4), dec)]

    off, on = _twice(run)
    for (p_off, f_off), (p_on, f_on) in zip(off, on):
        assert p_off == p_on
        assert torch.equal(f_off, f_on)


def test_sp_path_outputs_equal_recording_on_and_off():
    from torch_support import sp_decode, sp_encode

    from screenpressor_tpu_torch.parallel.mesh import make_mesh

    cfg = CodecConfig(width=128, height=96, k_fixed=8, msr_x=16, msr_y=16)
    frames = synth_screencast(96, 128, 4)
    mesh = make_mesh(2, 2, devices=["cpu"] * 2)

    def run():
        pays = sp_encode(frames, mesh, cfg)
        return pays, sp_decode(pays, mesh, cfg)

    first = len(telemetry.spans())
    (p_off, f_off), (p_on, f_on) = _twice(run)
    assert p_off == p_on
    for a, b in zip(f_off, f_on):
        assert torch.equal(a, b)
    assert any(s.name.startswith("sptc.sp.") for s in new_spans(first))


# -- (d) the counter against the recorded sync spans -----------------------------

@pytest.mark.parametrize("path", ["session", "serving"])
def test_sync_counter_equals_sync_spans(path):
    first = len(telemetry.spans())
    before = telemetry.counts()["sync"]
    with collecting():
        if path == "session":
            cfg = CodecConfig(width=W, height=H)
            pays = [p for p, _ in Encoder(cfg, RGB32, device="cpu").encode_batch(
                desktop_frames())]
            Decoder(cfg, RGB32, device="cpu").decode_batch(pays)
        else:
            enc = BatchedEncoder(3, SERVE_CFG, "cpu", kf_offsets=[0, 1, 2])
            dec = BatchedDecoder(3, SERVE_CFG, "cpu")
            for _ in serve_pipelined(enc, serving_steps(4), dec):
                pass
            dec.validate()
    n = sum(s.name == "sync" for s in new_spans(first))
    assert n > 0 and telemetry.counts()["sync"] - before == n


# -- (e), (f) on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_clock_holds_device_interval(cuda):
    """A span around a torch.cuda._sleep launch and a synchronize contains
    the kernel's device interval in the profiler's times, and a
    record_function range opened just inside the span starts within 50 us
    of it, between the host clock's readings around its opening. The first
    ranges of a profile take hundreds of us to open (measured on an H100
    host: 100-350 us, then 20-50, then under 20), so two ranges open
    before the span."""
    for _ in range(3):
        first = len(telemetry.spans())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                with record_function(f"clock.warm{i}"):
                    pass
            with telemetry.span("clock.check"):
                t0 = time.time_ns()
                with record_function("clock.range"):
                    t1 = time.time_ns()
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
        (span,) = new_spans(first)
        events = list(prof.profiler.kineto_results.events())
        (rng,) = [e for e in events if e.name() == "clock.range"
                  and e.device_type() == torch.autograd.DeviceType.CPU]
        (kern,) = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation()]
        print(f"span {span.start_ns}..{span.end_ns}, range start {rng.start_ns()} "
              f"(host clock {t0}..{t1}), kernel {kern.name()} {kern.start_ns()}..{kern.end_ns()}")
        assert span.start_ns <= kern.start_ns() and kern.end_ns() <= span.end_ns
        assert abs(rng.start_ns() - span.start_ns) < 50_000
        assert t0 - 50_000 <= rng.start_ns() <= t1 + 50_000


def _session_and_serving(dev):
    """Warm sessions (a first call fills the table caches), then the two
    counted calls: a 1080p RGB32 encode + decode batch through the session
    API, and 5 serving steps of chip_smoke.py's profile."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    frames = synth_screencast(1080, 1920, 16)
    rgb32 = [np.concatenate([f, np.full(f.shape[:2] + (1,), 255, np.uint8)], axis=-1)
             for f in frames]
    cfg = CodecConfig(width=1920, height=1080)
    warm_e, warm_d = Encoder(cfg, RGB32, device=dev), Decoder(cfg, RGB32, device=dev)
    warm_d.decode_batch([p for p, _ in warm_e.encode_batch(rgb32)])
    enc, dec = Encoder(cfg, RGB32, device=dev), Decoder(cfg, RGB32, device=dev)

    def session():
        dec.decode_batch([p for p, _ in enc.encode_batch(rgb32)])

    s_cfg, offsets, _host, batches = chip_smoke.serving_batches(dev, synth_screencast)

    def serving():
        e = BatchedEncoder(chip_smoke.S_STREAMS, s_cfg, dev, kf_offsets=offsets)
        d = BatchedDecoder(chip_smoke.S_STREAMS, s_cfg, dev)
        for _ in serve_pipelined(e, batches, d):
            pass
        d.validate()

    serving()  # warm
    return chip_smoke.count_syncs, (("session", session), ("serving", serving))


@pytest.mark.gpu
def test_sync_counter_equals_sync_debug_mode(cuda):
    """The sync counter over a warm 1080p encode + decode batch and over 5
    serving steps equals torch's sync debug mode count: no implicit host
    sync on these paths escapes `telemetry.sync`. Switching the mode on
    warns of "synchronizing operations" (once a process on the H100
    machine's torch), which count_syncs counts: calls of nothing take that
    warning first and measure what a switch alone adds."""
    count_syncs, calls = _session_and_serving(cuda)
    _, first = count_syncs(lambda: None)
    _, switch = count_syncs(lambda: None)
    for name, call in calls:
        before = telemetry.counts()["sync"]
        _, want = count_syncs(call)
        got = telemetry.counts()["sync"] - before
        print(f"{name}: sync counter {got}, sync debug mode {want} (a switch alone: "
              f"{first} the first time, then {switch})")
        assert got == want - switch, name
