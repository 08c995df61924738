"""The window cell `conf-64x360p-w8.staggered` at a test size on the CPU (4
streams of 192x96, windows of 4 at small capacities): a sound run is
correct with every count 0, and its traced run reads the program's window
spans (the roofline reads nothing off the card); the control and each
planted fault are not correct; a program that reads its whole source
before serving stops the run. The readers on spans made in the test."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spbench import run as R

CELL = "conf-64x360p-w8.staggered"
SMALL = {"width": 192, "height": 96, "streams": 4,
         "codec": {"kf_interval": 12, "loss": 0, "k_fixed": 32},
         "window": {"f": 4, "c": 2, "rec_cap": 1024, "col_cap": 1024, "irec_cap": 4096,
                    "icol_cap": 2048, "bcap": 64, "pack_cap": 16384},
         "warmup_steps": 9, "trace_units": 8}
SEED = 2**31 + 57
FAULTS = ["stale_state", "half_batch", "altered_token"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the kernels' plain versions are loops of tiny
    ops, which a pool of threads per worker slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reader(name):
    return R.load_module(R.HERE / "layers" / f"{name}.py").read


def one(trace=False, **kw):
    """A run whose window holds at least two windows of 4 steps."""
    return R.run(CELL, SEED, 6.0, trace, devices=["cpu"], config_override=SMALL, **kw)


def test_sound_traced_run_is_correct_and_reads_window_spans(capsys):
    from screenpressor_tpu_torch import telemetry

    telemetry.reset()  # spans of an earlier run in this process share its units
    res = one(trace=True)
    assert res["correct"], res["compared"]
    assert all(c["value"] == 0 for c in res["compared"].values()), res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = res["metrics"]
    assert m["serving.window.host_ms_step"]["value"] > 0
    assert m["serving.window.sync_ms_step"]["value"] > 0
    assert "coder.window.k1k2_roofline" not in m  # no card
    err = capsys.readouterr().err
    assert "window counters: serving.window.steps " in err
    assert "serving.window.single_steps 0," in err and "frames.raw 0" in err


def test_control_reads_frames_wrong():
    res = one(control=True)
    assert not res["correct"]
    assert res["compared"]["frames_decoded_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    from screenpressor_tpu_torch.parallel import serve_scan

    real = serve_scan.encode_window_finish, serve_scan.decode_window
    assert not one(fault=fault)["correct"]
    assert (serve_scan.encode_window_finish, serve_scan.decode_window) == real


def test_reading_the_whole_source_first_stops_the_run(monkeypatch):
    """A window server that lists its source before serving (it never ends
    on the window's deadline-bound steps) ends the run with an error."""
    from screenpressor_tpu_torch.parallel import serve_scan

    real = serve_scan.serve_windowed
    monkeypatch.setattr(serve_scan, "serve_windowed",
                        lambda enc, batches, *a, **kw: real(enc, list(batches), *a, **kw))
    with pytest.raises(SystemExit, match="cannot serve this cell: step .* more than 9 steps"):
        one()


def test_span_readers_on_recorded_spans():
    """host: begin, finish and decode's wall minus their syncs; sync: the
    syncs under window spans, both over the traced steps (a window's spans
    carry its first step); None without window spans or trace."""
    import time

    from screenpressor_tpu_torch import telemetry

    first = len(telemetry.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        for step in (900, 902):
            for top in ("begin", "finish", "decode"):
                with telemetry.span(f"sptc.serve.window.{top}", unit=step):
                    with telemetry.span("sptc.serve.window.pull"):
                        with telemetry.sync("inside"):
                            time.sleep(0.001)
        with telemetry.span("sptc.serve.decode", unit=901):
            with telemetry.sync("outside"):
                time.sleep(0.001)
    spans = telemetry.spans()[first:]
    tops = [s for s in spans
            if s.name in {f"sptc.serve.window.{top}" for top in ("begin", "finish", "decode")}]
    wall = sum(s.end_ns - s.start_ns for s in tops)
    inside = sum(s.end_ns - s.start_ns for s in spans if s.name == "sync" and s.unit != 901)
    drv = types.SimpleNamespace(units=[{"step": t, "traced": True} for t in range(900, 904)])
    host, sync = reader("serving.window.host_ms_step"), reader("serving.window.sync_ms_step")
    assert host(drv, object(), None) == pytest.approx((wall - inside) / 1e6 / 4)
    assert sync(drv, object(), None) == pytest.approx(inside / 1e6 / 4)
    assert inside > 5e6 and wall > inside
    per_step = types.SimpleNamespace(units=[{"step": 901, "traced": True}])
    assert host(per_step, object(), None) is None and sync(per_step, object(), None) is None
    assert host(drv, None, None) is None  # an untraced run


def test_roofline_reader_needs_a_card_and_the_window_driver():
    read = reader("coder.window.k1k2_roofline")
    drv = types.SimpleNamespace(units=[], traced_payloads=lambda: [],
                                begun_traced_payloads=lambda: [])
    assert read(drv, object(), types.SimpleNamespace(cuda=False)) is None
    assert read(drv, None, types.SimpleNamespace(cuda=True)) is None
    serving_drv = types.SimpleNamespace(units=[], traced_payloads=lambda: [])
    assert read(serving_drv, object(), types.SimpleNamespace(cuda=True)) is None


@pytest.mark.gpu
def test_on_card_first_64_steps_equal_serve_pipelined():
    """At the cell's own size on a card, on one seed: the payloads of the
    first 64 steps after set-up equal those of the `serving` driver
    (serve_pipelined) over the same frames, each stream up to its first RAW
    escape (which renews its tables); both decode every frame right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, config, traffic = R.load_cell(CELL)
    cells = []
    for driver in ("serving_window", "serving"):
        drv = R.load_module(R.HERE / "drivers" / f"{driver}.py").Cell(
            R.Context(config, traffic, SEED, ["cuda:0"]))
        drv.setup()
        stop = drv.step + 64
        drv._serve(lambda d=drv: d.step < stop, None)
        drv.dec.validate()
        cells.append(drv)
    win, pipe = cells
    assert int(win.wrong) == 0 and int(pipe.wrong) == 0
    assert [u["step"] for u in win.units] == [u["step"] for u in pipe.units]
    assert len(win.units) == 64
    first_raw, equal = {}, 0
    for u, v in zip(win.units, pipe.units):
        for i, (a, b) in enumerate(zip(u["payloads"], v["payloads"], strict=True)):
            if i in first_raw:
                continue
            if a[0] & 0x0F == 4 and b[0] & 0x0F != 4:  # the window's RAW escape
                first_raw[i] = u["step"]
                continue
            assert a == b, f"step {u['step']} stream {i}"
            equal += 1
    print(f"window vs serve_pipelined: {equal} stream-steps equal, first RAW by stream "
          f"{first_raw}")
