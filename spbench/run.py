#!/usr/bin/env python3
"""The benchmark of screenpressor_tpu_torch: one run of one cell.

    python3 spbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell (an entry of `workloads` in
BENCHMARK.json) names a configuration (`spbench/configs/<config>.json`,
found through BENCHMARK.json's `configs`) and a traffic mix
(`spbench/traffic/<traffic>.json`, which names its generator,
`spbench/generators/<generator>.py`); the configuration names its driver
(`spbench/drivers/<driver>.py`). Each per-layer metric is read by
`spbench/layers/<metric>.py`. A run:

1. loads the port and its kernels (built once into the checkout's
   `build/`), makes the cell's frames from the seed and warms the cell's
   shapes up: that is `setup_s`, counted from the start of the process;
2. runs the window for `--seconds` (with `--trace 1` under torch.profiler
   for the first units of the window, reduced in the process);
3. reads the device's peak memory, frees the program's sessions and
   judges the window's outputs against the inputs and the plain
   reference decoder in `spbench/reference/`;
4. prints the numbers compared (standard error, last lines) and one JSON
   line (standard output, last line).

It exits 2 with no result when no CUDA card (or fewer than the cell's
chips) is visible, and 3 when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "screenpressor_tpu"}
CACHE = ROOT / "build" / "spbench_cache"


def _cache_env() -> None:
    """Every compile cache at a fixed path inside the checkout (the port's
    own kernel library is built into build/torch_kernels/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "spbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT):
    """(benchmark, cell, configuration, traffic) of a workload name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "spbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


class NoDevice(Exception):
    pass


class _Counter:
    count = 0


class Context:
    """What a driver gets: the cell's files, the seed, the device(s), and
    the switches of the harness's own checks (control, fault)."""

    def __init__(self, config, traffic, seed, devices, control=False, fault=None):
        self.config, self.traffic = config, traffic
        self.seed_key = int(seed) % (1 << 64)
        self.devices = devices
        self.device = devices[0]
        self.cuda = str(self.device).startswith("cuda")
        self.control, self.fault = control, fault
        self._count = None

    def screen(self, h, w):
        """The traffic's generator (`spbench/generators/<generator>.py`,
        named by the traffic file) for an h x w screen and this seed."""
        gen = load_module(HERE / "generators" / f"{self.traffic['generator']}.py")
        return gen.Screen(self.traffic, h, w, self.seed_key)

    def synchronize(self):
        if self.cuda:
            import torch

            for d in self.devices:
                torch.cuda.synchronize(d)

    @contextlib.contextmanager
    def sync_count(self, enabled: bool):
        """Count the program's host syncs (torch's sync debug mode, one
        warning a sync) while the block runs, when enabled on a card."""
        counter = _Counter()
        if not (enabled and self.cuda):
            yield counter
            return
        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            self._count = True
            try:
                yield counter
            finally:
                self._count = None
                torch.cuda.set_sync_debug_mode("default")
        counter.count = sum("synchroniz" in str(w.message) for w in caught)

    @contextlib.contextmanager
    def no_sync_count(self):
        """The harness's own syncs inside a counted block are not counted."""
        if self._count is None:
            yield
            return
        import torch

        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("warn")


def smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def layer_metrics(bench, cell, drv, tracer, ctx) -> dict:
    """The cell's per-layer metrics: each read by spbench/layers/<name>.py;
    a reader that finds nothing returns None and the metric is left out."""
    out = {}
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]}
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell["name"] not in m["workloads"]:
                continue
        elif m["moves"] not in e2e:
            continue
        reader = load_module(HERE / "layers" / f"{m['name']}.py")
        v = reader.read(drv, tracer.trace, ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *, devices=None,
        control=False, fault=None, config_override=None, root: Path = ROOT):
    """One run -> the result line's dict. devices=None takes the
    cell's chips on CUDA; a list of "cpu" runs the plain versions (the
    harness's CPU tests; no device metrics)."""
    bench, cell, config, traffic = load_cell(workload, root)
    if config_override:
        config = {**config, **config_override}
    import torch

    from spbench.trace import Tracer

    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA device(s); {visible} visible")
        devices = [f"cuda:{i}" for i in range(cell["chips"])]
    ctx = Context(config, traffic, seed, devices, control=control, fault=fault)
    drv = load_module(HERE / "drivers" / f"{config['driver']}.py").Cell(ctx)
    drv.setup()
    setup_s = time.perf_counter() - T_START
    tracer = Tracer(trace, config["trace_units"], ctx.cuda)
    if ctx.cuda:
        print(f"spbench: before the window: {smi()}", file=sys.stderr)
    drv.window(seconds, tracer)
    if ctx.cuda:
        print(f"spbench: after the window: {smi()}", file=sys.stderr)
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    else:
        peak = 0
    if trace:
        metrics = layer_metrics(bench, cell, drv, tracer, ctx)
    else:
        metrics = {k: {"value": v, "unit": _unit(bench, k)}
                   for k, v in drv.end_to_end().items() if v is not None}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    drv.release()
    ctx.synchronize()
    t_check = time.perf_counter()
    compared, attempted, failed = drv.check()
    print(f"spbench: units {len(drv.units)}, check {time.perf_counter() - t_check:.3f} s, "
          f"failure: {drv.failure}", file=sys.stderr)
    correct = drv.failure is None and all(v <= lim for v, lim in compared.values())
    device = {"platform": "gpu" if ctx.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if ctx.cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if trace and tracer.trace is not None:
        idx = [int(str(d).split(":")[1]) if ":" in str(d) else 0 for d in devices]
        device["busy_s"] = float(sum(tracer.trace.busy_seconds("window", i) for i in idx)
                                 / len(idx))
        device["window_s"] = tracer.window_s
        result["breakdown"] = tracer.trace.breakdown("window", idx)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def _unit(bench, name):
    return next(m["unit"] for m in bench["end_to_end"] if m["name"] == name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the program with loss 1 (the lower-precision control): "
                        "correct must come out false")
    args = p.parse_args(argv)
    _cache_env()
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     control=args.control)
    except NoDevice as e:
        print(f"spbench: {e}", file=sys.stderr)
        return 2
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"spbench: modules of JAX or the JAX package loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
