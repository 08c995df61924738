#!/usr/bin/env python3
"""Where the port's time goes, read from its own spans
(`screenpressor_tpu_torch.telemetry`), on one CUDA card.

    python3 tools/telemetry_report.py --workload <cell> --seed <n> [--seconds 20]
    python3 tools/telemetry_report.py --syncs --workload <cell> --seed <n> [--units 3]
    python3 tools/telemetry_report.py --cost

The first makes one traced run of a benchmark cell (`spbench/run.py`'s
`run`, as `--trace 1`) and prints, over the traced units: the run's
per-layer metrics and its rates, program spans a unit, self time by
program span (top 8), and the card's idle time inside the harness's
`window` span, outside its `frames` and `fingerprints` spans, by the
innermost program span open during it (top 5), with the shares that fall
under a stage-level span (any span but the call spans `CALLS`), directly
under a call span, and under none; the traced units' times beside the
untraced units' of the same run; and, for a `devices=` split, the same by
card (`by_card`: each card's busy seconds, its group spans' host and sync
seconds, self time by program span of its spans (top 5), and its idle time
by the innermost program span open, whichever card's that is (top 5)).

The second (`--syncs`) runs the cell's set-up, then `--units` units with
torch's sync debug mode on and the profiler collecting, and lists every
host sync that no `telemetry.sync` span holds and every `sync` span that
held none, by source line.

The third (`--cost`) times `telemetry.span` and `telemetry.sync` with and
without a profiler collecting, and the same loop over a shared no-op
context manager (`bare_with_ns`), in ns a call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CALLS = {"sptc.api.encode", "sptc.api.decode", "sptc.codec.encode", "sptc.codec.decode",
         "sptc.serve.encode_begin", "sptc.serve.encode_finish", "sptc.serve.decode",
         "sptc.serve.window.begin", "sptc.serve.window.finish", "sptc.serve.window.decode"}


def traced_units(drv) -> set:
    if hasattr(drv, "n"):
        return {u["batch"] * drv.n for u in drv.units if u["traced"]}
    return {u["step"] for u in drv.units if u["traced"]}


def label_segments(spans):
    """The innermost program span open at each moment: (change times [K],
    labels [K]) of a step function, times in seconds, label None where no
    span is open."""
    events = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                    + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
    stack, times, labels = [], [], []
    for t, opening, i in events:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        times.append(t * 1e-9)
        labels.append(spans[stack[-1]].name if stack else None)
    return np.array(times), labels


def idle_by_span(trace, spans, device=0):
    """{label: idle seconds} of the card inside the harness's window,
    outside its frames and fingerprints spans."""
    (w0, w1), = trace.spans["window"]
    sel = (trace.dev_index == device) & (trace.dev_end > w0) & (trace.dev_start < w1)
    busy = sorted(zip(trace.dev_start[sel], trace.dev_end[sel]))
    busy += [se for name in ("frames", "fingerprints") for se in trace.spans.get(name, ())]
    busy.sort()
    idle, t = [], w0
    for s, e in busy:
        if s > t:
            idle.append((t, min(s, w1)))
        t = max(t, e)
    if t < w1:
        idle.append((t, w1))
    times, labels = label_segments(spans)
    out: dict = {}
    for a, b in idle:
        if b <= a:
            continue
        if not len(times):
            out[None] = out.get(None, 0.0) + float(b - a)
            continue
        k = max(int(np.searchsorted(times, a, side="right")) - 1, 0)
        cut = a
        while cut < b:
            nxt = times[k + 1] if k + 1 < len(times) else np.inf
            end = min(b, nxt)
            lab = labels[k] if times[k] <= cut else None
            out[lab] = out.get(lab, 0.0) + float(end - cut)
            cut, k = end, k + 1
    return out


def traced_against_untraced(drv) -> dict:
    """Per-unit times of the traced units against the untraced ones of the
    same run (means of a desktop batch's encode and decode seconds, the
    first batch, which holds the keyframe, left out; medians of the
    serving steps' latency)."""
    if hasattr(drv, "n"):
        units = drv.units[1:]
        return {k: [float(np.mean([u[k] for u in units if u["traced"] == t] or [np.nan]))
                    for t in (True, False)] for k in ("encode_s", "decode_s")}
    return {"latency_s_median": [
        float(np.median([u["latency_s"] for u in drv.units if u["traced"] == t] or [np.nan]))
        for t in (True, False)]}


def report(args, **run_kw) -> dict:
    from spbench import run as R

    from screenpressor_tpu_torch import telemetry

    grabbed = {}
    real = R.layer_metrics

    def grab(bench, cell, drv, tracer, ctx):
        grabbed.update(drv=drv, tracer=tracer)
        return real(bench, cell, drv, tracer, ctx)

    R.layer_metrics = grab
    R._cache_env()
    res = R.run(args.workload, args.seed, args.seconds, True, **run_kw)
    drv, trace = grabbed["drv"], grabbed["tracer"].trace
    units = traced_units(drv)
    spans = [s for s in telemetry.spans() if s.unit in units]
    rows = telemetry.summary(units)
    self_top = sorted(((n, r["self_ns"] * 1e-9, r["calls"]) for n, r in rows.items()),
                      key=lambda x: -x[1])[:8]
    idle = idle_by_span(trace, telemetry.spans())
    total = sum(idle.values())
    stage = sum(v for k, v in idle.items() if k is not None and k not in CALLS)
    call = sum(v for k, v in idle.items() if k in CALLS)
    out = {
        "workload": args.workload, "seed": args.seed, "device": res["device"],
        "correct": res["correct"], "metrics": res["metrics"], "rates": drv.end_to_end(),
        "traced_vs_untraced": traced_against_untraced(drv),
        "traced_units": len(units), "spans_per_unit": len(spans) / max(len(units), 1),
        "syncs_per_unit": rows.get("sync", {}).get("calls", 0) / max(len(units), 1),
        "self_s_top8": self_top,
        "idle_s_top5": sorted(((k or "(no program span)", v) for k, v in idle.items()),
                              key=lambda x: -x[1])[:5],
        "idle_s": total, "idle_share_stage": stage / total if total else None,
        "idle_share_call": call / total if total else None,
        "idle_share_none": idle.get(None, 0.0) / total if total else None,
    }
    cards = sorted({s.card for s in spans if s.card is not None})
    if cards:
        out["by_card"] = {c: by_card(trace, units, c) for c in cards}
    return out


def by_card(trace, units, card) -> dict:
    """One card of a split: its busy seconds in the window, its group
    spans' host (wall less syncs) and sync seconds, self time by program span
    (top 5) and its idle time by the program span open (top 5)."""
    from screenpressor_tpu_torch import telemetry

    rows = telemetry.summary(units, cards={card})
    group = rows.get("sptc.serve.group", {"wall_ns": 0, "sync_ns": 0})
    idle = idle_by_span(trace, telemetry.spans(), device=card)
    return {
        "busy_s": trace.busy_seconds("window", card),
        "group_host_s": (group["wall_ns"] - group["sync_ns"]) * 1e-9,
        "group_sync_s": group["sync_ns"] * 1e-9,
        "self_s_top5": sorted(((n, r["self_ns"] * 1e-9, r["calls"]) for n, r in rows.items()),
                              key=lambda x: -x[1])[:5],
        "idle_s_top5": sorted(((k or "(no program span)", v) for k, v in idle.items()),
                              key=lambda x: -x[1])[:5],
    }


def syncs(args) -> dict:
    """Host syncs (torch's sync debug mode) against the sync spans, by
    source line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spbench import run as R

    from screenpressor_tpu_torch import telemetry
    from screenpressor_tpu_torch.parallel.serving import serve_pipelined

    R._cache_env()
    _, _cell, config, traffic = R.load_cell(args.workload)
    ctx = R.Context(config, traffic, args.seed, ["cuda:0"])
    drv = R.load_module(R.HERE / "drivers" / f"{config['driver']}.py").Cell(ctx)
    drv.setup()
    if hasattr(drv, "n"):
        batches = [drv.batch(b) for b in range(args.units)]

        def work():
            for frames in batches:
                drv.dec.decode_batch([p for p, _ in drv.enc.encode_batch(frames)])
    else:
        steps = [drv.frames(drv.step + t).clone() for t in range(args.units)]

        def work():
            for _ in serve_pipelined(drv.enc, steps, drv.dec):
                pass
            drv.dec.validate()
    torch.cuda.synchronize()
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        stack = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                 for f in frames if "screenpressor_tpu_torch" in f.filename
                 and "telemetry.py" not in f.filename]
        if not stack:  # outside the port: its innermost Python frames
            stack = [f"{f.filename}:{f.lineno} {f.name}" for f in frames]
        seen.append((time.time_ns(), " <- ".join(reversed(stack[-3:]))))

    first = len(telemetry.spans())
    before = telemetry.counts()["sync"]
    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                work()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    sync_spans = [s for s in telemetry.spans()[first:] if s.name == "sync"]
    held = np.zeros(len(sync_spans), int)
    free: dict = {}
    for t, site in seen:
        hit = [i for i, s in enumerate(sync_spans) if s.start_ns <= t <= s.end_ns]
        if hit:
            held[hit[-1]] += 1
        else:
            free[site] = free.get(site, 0) + 1
    empty: dict = {}
    for s, n in zip(sync_spans, held):
        if not n:
            empty[s.site] = empty.get(s.site, 0) + 1
    return {"workload": args.workload, "units": args.units, "debug_mode_syncs": len(seen),
            "counter": telemetry.counts()["sync"] - before, "sync_spans": len(sync_spans),
            "unheld_syncs": free, "spans_without_sync": empty,
            "spans_with_several": int((held > 1).sum())}


def cost(_args) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from screenpressor_tpu_torch import telemetry

    def per_call(fn, n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with fn("sptc.cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    shared = telemetry.NOOP
    out = {"bare_with_ns": per_call(lambda _name: shared, 1_000_000),
           "span_off_ns": per_call(telemetry.span, 1_000_000),
           "sync_off_ns": per_call(telemetry.sync, 1_000_000)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_ns"] = per_call(telemetry.span, 100_000)
        out["sync_on_ns"] = per_call(telemetry.sync, 100_000)
    telemetry.reset()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=2**31 + 1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--units", type=int, default=3)
    p.add_argument("--syncs", action="store_true")
    p.add_argument("--cost", action="store_true")
    p.add_argument("--out", help="also write the result as JSON to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available() and not args.cost:
        print("telemetry_report: no CUDA device", file=sys.stderr)
        return 2
    out = cost(args) if args.cost else syncs(args) if args.syncs else report(args)
    text = json.dumps(out, default=str)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
