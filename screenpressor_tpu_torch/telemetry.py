"""Spans and counters inside the port, on the profiler's clock.

Spans record only while a torch profiler collects (`torch.profiler.profile`
sets `torch.autograd.profiler._is_profiler_enabled`); otherwise `span`
returns one shared no-op context manager, so an untraced run records
nothing and allocates nothing a call. A recorded span is
(name, start_ns, end_ns, parent, unit, card, site) in a list in memory, not a
`record_function` range: Kineto would copy such a range onto the device
timeline as a GPU annotation, where it would read as device work. The
clock is `time.time_ns()` (CLOCK_REALTIME), the clock of the profiler's
host events, so a span can be laid over a trace's launches and kernels.

- `parent` is the index (in `spans()`) of the recorded span open when the
  span began, -1 for none; `unit` is the request a span belongs to (a
  desktop call's first frame number, a serving step) and is inherited
  from the parent when not given; `card` is the stream group of a split
  serving session (`devices=`, group g on devices[g]) that a span's work
  belongs to, inherited the same way, None outside a split session.
- `sync(site)` wraps every point where the host waits on the device (a
  device-to-host read, a blocking upload): it adds one to the counter
  `sync` always, and while recording opens a span `sync` carrying `site`.
- `count(name, n)` adds to a counter; counters stay on, as the kernels'
  launch counts (`_build.LAUNCHES`, read here as `launch.<C entry>`) do.

Readers: `spans()`, `counts()`, `summary()`, `syncs()`; `reset()` clears
spans and counters. Call `reset()` with no span open.
"""

from __future__ import annotations

import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

from screenpressor_tpu_torch import _build


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index in spans(), -1 at the top
    unit: int | None
    card: int | None  # the stream group of a split serving session
    site: str | None  # where a `sync` span waited


_SPANS: list[list] = []  # [name, start_ns, end_ns, parent, unit, card, site]
_OPEN: list[int] = []  # indices of the recorded spans open now, innermost last
_COUNTS: dict[str, int] = {"sync": 0}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Recorded:
    __slots__ = ("rec",)

    def __init__(self, name, unit, card, site):
        self.rec = [name, 0, 0, -1, unit, card, site]

    def __enter__(self):
        rec = self.rec
        if _OPEN:
            rec[3] = _OPEN[-1]
            parent = _SPANS[rec[3]]
            if rec[4] is None:
                rec[4] = parent[4]
            if rec[5] is None:
                rec[5] = parent[5]
        _OPEN.append(len(_SPANS))
        _SPANS.append(rec)
        rec[1] = time.time_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec[2] = time.time_ns()
        if _OPEN and _SPANS[_OPEN[-1]] is rec:
            _OPEN.pop()
        return False


def span(name: str, unit: int | None = None, card: int | None = None):
    """A context manager timing the block as span `name` while a profiler
    collects; NOOP otherwise."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Recorded(name, unit, card, None)


def sync(site: str):
    """Count one host wait on the device at `site` (the block holds the
    read or blocking copy); while a profiler collects, time it as a span
    `sync` under the open span."""
    _COUNTS["sync"] += 1
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Recorded("sync", None, None, site)


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counts() -> dict[str, int]:
    """A snapshot of the counters: `sync`, `launch.<C entry>`, the work
    counts (`frames.I`, `frames.P`, `frames.flat`, `frames.unchanged`,
    `frames.raw`, `blocks.data`, `blocks.motion`) and where the session
    API converted its frames (`api.convert.device_frames`,
    `api.convert.host_frames`), the bytes a split serving session moves
    between devices (`serving.dp.scatter_bytes`, `serving.dp.gather_bytes`),
    the lanes a serving decode step's parse cut, over its coded streams'
    sections (`serving.decode.lanes`), the non-empty lanes a serving
    encode step's writer laid out over its coded streams' sections
    (`serving.encode.lanes`), and the steps window serving coded inside
    windows and as fallback steps (`serving.window.steps`,
    `serving.window.single_steps`)."""
    out = dict(_COUNTS)
    out.update({f"launch.{k}": v for k, v in _build.LAUNCHES.items()})
    return out


def spans() -> list[Span]:
    """The recorded spans, in the order they began (not cleared)."""
    return [Span(*rec) for rec in _SPANS]


def reset() -> None:
    """Clear the spans and every counter (the launch counts too)."""
    _SPANS.clear()
    _OPEN.clear()
    _COUNTS.clear()
    _COUNTS["sync"] = 0
    _build.reset_counts()


def _ancestors(recs, i):
    p = recs[i].parent
    while p >= 0:
        yield p
        p = recs[p].parent


def summary(units=None, cards=None) -> dict[str, dict[str, int]]:
    """Per span name over the spans of `units` and `cards` (all when None):
    calls, wall_ns, self_ns (wall minus the time its child spans cover) and
    sync_ns (the time of its `sync` descendants; wall minus it is the
    host's own time)."""
    recs = spans()
    keep = [(units is None or s.unit in units) and (cards is None or s.card in cards)
            for s in recs]
    out: dict[str, dict[str, int]] = {}

    def row(name):
        return out.setdefault(name, {"calls": 0, "wall_ns": 0, "self_ns": 0, "sync_ns": 0})

    for i, s in enumerate(recs):
        if not keep[i]:
            continue
        wall = s.end_ns - s.start_ns
        r = row(s.name)
        r["calls"] += 1
        r["wall_ns"] += wall
        r["self_ns"] += wall
        if s.parent >= 0 and keep[s.parent]:
            row(recs[s.parent].name)["self_ns"] -= wall
        if s.name == "sync":
            for name in {recs[j].name for j in _ancestors(recs, i) if keep[j]}:
                row(name)["sync_ns"] += wall
    return out


def syncs(under: str, units=None) -> list[Span]:
    """The `sync` spans of `units` with an ancestor whose name starts with
    `under`."""
    recs = spans()
    return [s for i, s in enumerate(recs)
            if s.name == "sync" and (units is None or s.unit in units)
            and any(recs[j].name.startswith(under) for j in _ancestors(recs, i))]
