"""Driver `serving_dp`: the `serving` driver over a `devices=` split of
the streams (one group of S / n streams a card, one controller), with the
plain reference drawing its streams from every group.

What differs from `serving`:
- the reference decodes `reference_streams / n` streams of each of the n
  groups, drawn from the seed, so that every card's bytes are checked;
- a stream with no keyframe in the window is decoded from the session's
  first step, where every stream keyframes: set-up keeps its warm-up
  steps' payloads. At a few steps a second most of 256 streams keyframe
  only hundreds of steps after the window;
- the window keeps the program's counters (`telemetry.counts()`) at its
  start and end, for the readers of what the split moves between cards.

Every decoded frame of every stream is still compared with its input on
the card, as in `serving`.
"""

from __future__ import annotations

import sys

import numpy as np

from spbench.drivers import serving
from spbench.reference.sptc import CorruptStreamError, StreamDecoder


def _counts():
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return {}
    return telemetry.counts()


class Cell(serving.Cell):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.warm_units = []  # the warm-up's steps (set-up clears `units`)
        self.window_counts = None  # the program's counters at the window's start and end

    def _serve(self, more, tracer):
        first = len(self.units)
        super()._serve(more, tracer)
        if tracer is None:
            self.warm_units = self.units[first:]

    def window(self, seconds: float, tracer):
        before = _counts()
        super().window(seconds, tracer)
        self.window_counts = (before, _counts())

    def reference_picks(self, n_streams: int) -> list[int]:
        """n_streams / n streams of each of the n groups (at least one),
        drawn from the seed, in stream order."""
        n = len(self.ctx.devices)
        size = self.s // n
        per = min(size, max(1, n_streams // n))
        rng = np.random.default_rng([self.ctx.seed_key, 4])
        return [int(s) for g in range(n)
                for s in np.sort(rng.choice(np.arange(g * size, (g + 1) * size), per,
                                            replace=False))]

    def _reference(self, n_streams: int, n_steps: int):
        kf = self.cfg.kf_interval
        units = self.warm_units + self.units
        first = units[0]["step"] if units else 0
        last = first + len(units)
        opened = self.units[0]["step"] if self.units else last
        pick = self.reference_picks(n_streams)
        bad = n = 0
        for s in pick:
            # its first keyframe in the window, else the session's first step
            key = next((t for t in range(opened, last) if (t + self.offsets[s]) % kf == 0),
                       first) if kf else first
            ref = StreamDecoder(self.h, self.w, self.ctx.config["codec"].get("k_fixed"))
            for t in range(key, min(key + n_steps, last)):
                pays = units[t - first]["payloads"]
                n += 1
                if s >= len(pays):
                    bad += 1
                    continue
                try:
                    got = ref.decode(pays[s])
                except CorruptStreamError:
                    bad += 1
                    break
                bad += not np.array_equal(got, self.screen.stream_frame(t, s))
        print(f"spbench: the reference decoded {n} stream-frames of streams {pick} "
              f"({len(self.ctx.devices)} groups)", file=sys.stderr)
        return bad
