"""The traced run: torch.profiler over a fixed schedule of the window,
reduced in the process to device intervals and the harness's spans.

No trace file is written. The profile's raw events (Kineto's, one per CPU
op, runtime call, user range, kernel and copy) are read once; device
events become (name, start, end, device) rows and the harness's own
`record_function` ranges (names starting with "spbench.") become spans.
Every time is in seconds on the profiler's clock.
"""

from __future__ import annotations

import contextlib

import numpy as np

PREFIX = "spbench."


def kernel_name(name: str) -> str:
    """A device function's bare name: "void encode_kernel<16>(Params)" ->
    "encode_kernel"."""
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip()


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1000


def union_seconds(starts, ends, lo=None, hi=None) -> float:
    """Length of the union of [starts, ends), clipped to [lo, hi)."""
    s, e = np.asarray(starts, float), np.asarray(ends, float)
    if lo is not None:
        s, e = np.maximum(s, lo), np.minimum(e, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if not s.size:
        return 0.0
    order = np.argsort(s)
    s, e = s[order], np.maximum.accumulate(e[order])
    # a new run of the union starts where an interval begins after every
    # earlier one has ended
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    run_start = s[new]
    run_end = np.append(e[np.nonzero(new)[0][1:] - 1], e[-1])
    return float((run_end - run_start).sum())


class Trace:
    """Device events and harness spans of one profiled schedule."""

    def __init__(self, prof):
        import torch

        cpu, dev, annot = [], [], set()
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = _ns(e, "start") * 1e-9
            end = start + _ns(e, "duration") * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CPU:
                cpu.append((name, start, end))
                if name.startswith(PREFIX):
                    annot.add(name)
            else:
                dev.append((name, start, end, e.device_index()))
        # GPU-side copies of the harness's ranges are not device work
        dev = [d for d in dev if d[0] not in annot and not d[0].startswith(PREFIX)]
        self.dev_name = [d[0] for d in dev]
        self.dev_start = np.array([d[1] for d in dev], float)
        self.dev_end = np.array([d[2] for d in dev], float)
        self.dev_index = np.array([d[3] for d in dev], int)
        self.kernel = np.array([not (n.startswith("Memcpy") or n.startswith("Memset"))
                                for n in self.dev_name], bool)
        self.spans: dict[str, list[tuple[float, float]]] = {}
        for name, s, e in cpu:
            if name.startswith(PREFIX):
                self.spans.setdefault(name[len(PREFIX):], []).append((s, e))
        cpu.sort(key=lambda r: r[1])
        self.cpu_name = [c[0] for c in cpu]
        self.cpu_start = np.array([c[1] for c in cpu], float)
        self.cpu_end = np.array([c[2] for c in cpu], float)

    # -- selections ------------------------------------------------------------

    def span_seconds(self, name: str) -> float:
        return float(sum(e - s for s, e in self.spans.get(name, ())))

    def within(self, name: str, kernels_only=False, kernel=None) -> np.ndarray:
        """Mask of device events that start inside a span `name` (kernels
        only; of the device function `kernel`)."""
        m = np.zeros(len(self.dev_name), bool)
        for s, e in self.spans.get(name, ()):
            m |= (self.dev_start >= s) & (self.dev_start < e)
        if kernels_only:
            m &= self.kernel
        if kernel is not None:
            m &= np.array([kernel_name(n) == kernel for n in self.dev_name], bool)
        return m

    def busy_seconds(self, name: str, device=None) -> float:
        """Union of device intervals (of one device, or of all) inside the
        spans `name`."""
        busy = 0.0
        sel = np.ones(len(self.dev_name), bool) if device is None else self.dev_index == device
        for s, e in self.spans.get(name, ()):
            busy += union_seconds(self.dev_start[sel], self.dev_end[sel], s, e)
        return busy

    def idle_share(self, name: str, devices) -> float | None:
        wall = self.span_seconds(name)
        if wall <= 0:
            return None
        return float(np.mean([1 - self.busy_seconds(name, d) / wall for d in devices]))

    def device_seconds(self, name: str, kernel: str) -> float:
        """Summed device time of the device function `kernel` in the spans."""
        m = self.within(name, kernels_only=True, kernel=kernel)
        return float((self.dev_end[m] - self.dev_start[m]).sum())

    # -- the breakdown ---------------------------------------------------------

    def breakdown(self, name: str, devices) -> dict:
        """Top device ops by time, and the idle time of the first device
        by what the host was doing: each of the 200 longest gaps is cut at
        the harness's span edges and each piece goes to the innermost span
        and host event open at its middle."""
        m = self.within(name)
        tot: dict[str, float] = {}
        for n, s, e in zip(np.array(self.dev_name, object)[m], self.dev_start[m], self.dev_end[m]):
            tot[n] = tot.get(n, 0.0) + (e - s)
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        edges = np.unique([t for spans in self.spans.values() for se in spans for t in se])
        gaps: dict[str, float] = {}
        sel = m & (self.dev_index == devices[0])
        for s_win, e_win in self.spans.get(name, ()):
            inside = sel & (self.dev_start >= s_win) & (self.dev_start < e_win)
            order = np.argsort(self.dev_start[inside])
            s = self.dev_start[inside][order]
            e = np.maximum.accumulate(self.dev_end[inside][order])
            gs = np.concatenate([[s_win], e])
            ge = np.concatenate([s, [e_win]])
            for i in np.argsort(gs - ge)[:200]:
                if ge[i] <= gs[i]:
                    break
                cuts = edges[(edges > gs[i]) & (edges < ge[i])]
                pts = np.concatenate([[gs[i]], cuts, [ge[i]]])
                for a, b in zip(pts[:-1], pts[1:]):
                    label = self._host_at((a + b) / 2)
                    gaps[label] = gaps.get(label, 0.0) + float(b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], float(v)] for n, v in ops],
                "idle_gaps": [[n, float(v)] for n, v in idle]}

    def _host_at(self, t: float) -> str:
        """What the host was doing at time t: the innermost harness span
        and the innermost host event (op or runtime call) open in it, or
        "python" when the span has no event open (Python and numpy work)."""
        open_ = np.nonzero((self.cpu_start <= t) & (self.cpu_end >= t))[0]
        if not open_.size:
            return "outside the harness's spans"
        names = [self.cpu_name[i] for i in open_]
        spans = [n[len(PREFIX):] for n in names if n.startswith(PREFIX)]
        inner = "python" if names[-1].startswith(PREFIX) else names[-1]
        return f"{spans[-1] if spans else '-'} / {inner}"


class Tracer:
    """The harness's spans (record_function ranges, only in the traced
    run) and the profiler over the first `units` units of the window."""

    def __init__(self, enabled: bool, units: int, use_cuda: bool):
        self.enabled, self.units, self.use_cuda = enabled, units, use_cuda
        self.prof = None
        self.done = 0
        self.trace = None
        self.window_s = 0.0

    def span(self, name: str):
        if not (self.enabled and self.prof is not None):
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.use_cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._outer = self.span("window")
        self._outer.__enter__()

    def unit_done(self):
        """Count one unit of the window; stop profiling after `units`."""
        if self.prof is None:
            return
        self.done += 1
        if self.done >= self.units:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        self._outer.__exit__(None, None, None)
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.trace = Trace(prof)
        self.window_s = self.trace.span_seconds("window")
