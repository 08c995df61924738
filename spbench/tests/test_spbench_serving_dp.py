"""The four-card cell `conf-4x64x360p.staggered` at a test size on the CPU
(4 streams of 192x96 over `devices=["cpu"] * 4`): the `serving_dp`
driver's reference draws streams from every group, deterministically from
the seed; a sound run is correct and its traced run reads the program's
split spans and counters; the control and the planted faults are not
correct. The four readers of the split on spans, counters and device
intervals made in the test."""

import types

import numpy as np
import pytest
from test_spbench_trace import CUDA, event, trace
from torch.profiler import ProfilerActivity, profile

from spbench import run as R

CELL = "conf-4x64x360p.staggered"
SMALL = {"width": 192, "height": 96, "streams": 4,
         "codec": {"kf_interval": 12, "loss": 0, "k_fixed": 8}}
SEED = 2**31 + 41
FAULTS = ["stale_state", "half_batch", "altered_token"]


def reader(name):
    return R.load_module(R.HERE / "layers" / f"{name}.py").read


def driver(seed, streams=256, n_cards=4):
    _, _, config, traffic = R.load_cell(CELL)
    ctx = R.Context({**config, "streams": streams}, traffic, seed, ["cuda:0"] * n_cards)
    return R.load_module(R.HERE / "drivers" / "serving_dp.py").Cell(ctx)


@pytest.mark.parametrize("seed", [SEED, 7])
def test_reference_picks_every_group(seed):
    """reference_streams / n streams of each group, the same for the same
    seed, another draw for another seed."""
    n_ref = R.load_cell(CELL)[3]["reference_streams"]
    picks = driver(seed).reference_picks(n_ref)
    assert picks == driver(seed).reference_picks(n_ref)
    assert np.bincount(np.asarray(picks) // 64, minlength=4).tolist() == [n_ref // 4] * 4
    assert len(set(picks)) == n_ref
    assert picks != driver(seed + 1).reference_picks(n_ref)
    assert driver(seed, streams=8).reference_picks(n_ref) == list(range(8))


def test_sound_traced_run_reads_the_split(capsys):
    from screenpressor_tpu_torch import telemetry

    telemetry.reset()  # spans of an earlier run in this process share its units
    res = R.run(CELL, SEED, 4.0, True, devices=["cpu"] * 4, config_override=SMALL)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    err = capsys.readouterr().err
    assert "of streams [0, 1, 2, 3] (4 groups)" in err, err
    m = res["metrics"]
    assert m["serving.dp.host_ms_step"]["value"] > 0
    assert m["serving.dp.sync_ms_step"]["value"] >= 0
    assert m["serving.dp.cross_card_mb_step"]["value"] == 0  # one device: nothing moves
    assert "device.serve.card_idle_max" not in m  # no card


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_control_and_faults_are_not_correct(fault):
    """A window of a few steps: a stale frame shows from its second step."""
    res = R.run(CELL, SEED, 4.0, False, devices=["cpu"] * 4, config_override=SMALL,
                control=fault is None, fault=fault)
    assert not res["correct"]


def test_span_readers_on_recorded_spans():
    """host: the group spans' wall minus their syncs; sync: the syncs under
    group spans, both over the traced steps; None without group spans."""
    import time

    from screenpressor_tpu_torch import telemetry

    first = len(telemetry.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        for step in (900, 901):
            with telemetry.span("sptc.serve.decode", unit=step):
                with telemetry.sync("outside"):
                    time.sleep(0.001)
                for card in range(4):
                    with telemetry.span("sptc.serve.group", card=card):
                        with telemetry.sync("inside"):
                            time.sleep(0.001)
    spans = telemetry.spans()[first:]
    wall = sum(s.end_ns - s.start_ns for s in spans if s.name == "sptc.serve.group")
    inside = sum(s.end_ns - s.start_ns for s in spans if s.name == "sync" and s.card is not None)
    drv = types.SimpleNamespace(units=[{"step": 900, "traced": True},
                                       {"step": 901, "traced": True},
                                       {"step": 902, "traced": False}])
    host, sync = reader("serving.dp.host_ms_step"), reader("serving.dp.sync_ms_step")
    assert host(drv, object(), None) == pytest.approx((wall - inside) / 1e6 / 2)
    assert sync(drv, object(), None) == pytest.approx(inside / 1e6 / 2)
    assert inside > 8e6 and wall > inside
    unsplit = types.SimpleNamespace(units=[{"step": 902, "traced": True}])
    assert host(unsplit, object(), None) is None and sync(unsplit, object(), None) is None
    assert host(drv, None, None) is None  # an untraced run


def test_counter_reader_on_window_counts():
    read = reader("serving.dp.cross_card_mb_step")
    units = [{"step": t} for t in range(4)]
    counts = ({"serving.dp.scatter_bytes": 10, "serving.dp.gather_bytes": 0},
              {"serving.dp.scatter_bytes": 4 * 132_710_400 + 10,
               "serving.dp.gather_bytes": 4 * 132_710_400})
    drv = types.SimpleNamespace(units=units, window_counts=counts)
    assert read(drv, None, None) == pytest.approx(265.4208)
    parent = types.SimpleNamespace(units=units, window_counts=({}, {"sync": 3}))
    assert read(parent, None, None) is None
    assert read(types.SimpleNamespace(units=units), None, None) is None


def test_card_idle_max_reads_the_idlest_card():
    t = trace([event("spbench.window", 0, 100),
               event("k", 10, 40, CUDA, 0), event("k", 20, 10, CUDA, 1),
               event("k", 0, 100, CUDA, 2), event("k", 50, 50, CUDA, 3)])
    read = reader("device.serve.card_idle_max")
    ctx = types.SimpleNamespace(cuda=True, devices=[f"cuda:{i}" for i in range(4)])
    assert read(None, t, ctx) == pytest.approx(0.9)
    assert read(None, None, ctx) is None
    assert read(None, t, types.SimpleNamespace(cuda=False, devices=["cpu"] * 4)) is None
