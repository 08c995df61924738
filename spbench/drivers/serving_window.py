"""Driver `serving_window`: the `serving` driver through the port's window
server, `serve_windowed(BatchedEncoder, steps, BatchedDecoder, wcfg)`
(`screenpressor_tpu_torch/parallel/serve_scan.py`): F steps of all S
streams coded and decoded at a time on the card, with the configuration's
`window` capacities (`WindowConfig`).

What differs from `serving`:
- the steps go to `serve_windowed`, which reads at most F steps ahead of
  those it has begun: a step whose frames are pulled more than 2F + 1
  steps beyond the last step yielded stops the run, since a recorder
  cannot hold an unbounded backlog (in set-up, or after the window, the
  run ends with an error and no result);
- a step's latency still runs from its frames being handed over until its
  decoded frames are synchronised on the card, so it holds the window's
  fill;
- the planted faults break the window's finish and decode
  (`encode_window_finish`, `decode_window`) for the window's steps;
- each unit records whether its frames were pulled while the profiler
  collected (`begun_traced`): the window begun after the last traced one
  runs its K1 launches inside the trace;
- the window prints the program's window and frame counters over the
  window (standard error).

Set-up runs `warmup_steps` steps: the session's keyframe step (a fallback
step), then whole windows, so that every window shape is built and warm.
`check`, the reference and `--control` are `serving`'s.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager, nullcontext

from spbench.drivers import serving

COUNTERS = ("serving.window.steps", "serving.window.single_steps", "frames.I", "frames.P",
            "frames.flat", "frames.unchanged", "frames.raw")


class ReadAhead(RuntimeError):
    """The program pulled steps further ahead than a window server needs."""


class Cell(serving.Cell):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.planted = None  # the fault planted under the window's steps
        self.overrun = None  # how the program pulled too far ahead, if it did

    def _serve(self, more, tracer):
        """Run steps while more() holds when a step's frames are due."""
        from screenpressor_tpu_torch.parallel.serve_scan import WindowConfig, serve_windowed

        ctx = self.ctx
        wcfg = WindowConfig(self.cfg, self.s, **ctx.config["window"])
        handed, begun_traced = {}, {}
        first = self.step
        limit = 2 * wcfg.f + 1
        yielded = [first]  # the steps yielded so far end before this one

        def steps():
            while more():
                if self.step - yielded[0] >= limit:
                    self.overrun = (f"step {self.step} pulled before step {yielded[0]} was "
                                    f"served: more than {limit} steps ahead")
                    raise ReadAhead(self.overrun)
                with ctx.no_sync_count(), (tracer.span("frames") if tracer else nullcontext()):
                    f = self.frames(self.step)
                handed[self.step] = time.perf_counter()
                begun_traced[self.step] = tracer is not None and tracer.prof is not None
                self.step += 1
                yield f

        with self._plant():
            for k, (outs, decoded) in enumerate(serve_windowed(self.enc, steps(), self.dec,
                                                               wcfg, device_out=True)):
                with ctx.no_sync_count():
                    ctx.synchronize()
                t = first + k
                yielded[0] = t + 1
                self.units.append({"step": t, "payloads": [p for p, _ in outs],
                                   "latency_s": time.perf_counter() - handed[t],
                                   "traced": tracer is not None and tracer.prof is not None,
                                   "begun_traced": begun_traced[t]})
                with ctx.no_sync_count():
                    self.wrong += serving._streams_wrong(decoded, self.frames(t))
                del decoded
                if tracer is not None:
                    tracer.unit_done()

    def window(self, seconds: float, tracer):
        from screenpressor_tpu_torch import telemetry

        before = telemetry.counts()
        super().window(seconds, tracer)
        after = telemetry.counts()
        print("spbench: window counters: " + ", ".join(
            f"{n} {after.get(n, 0) - before.get(n, 0)}" for n in COUNTERS), file=sys.stderr)
        if self.overrun is not None:
            raise SystemExit(f"spbench: the program cannot serve this cell: {self.overrun}")

    def fault(self, name: str):
        if name not in ("stale_state", "half_batch", "altered_token"):
            raise ValueError(f"no fault {name}")
        self.planted = name

    @contextmanager
    def _plant(self):
        """Break the window's finish or decode while the block runs (the
        harness's tests); the program's functions are restored after it."""
        if self.planted is None:
            yield
            return
        from screenpressor_tpu_torch.parallel import serve_scan

        real_f, real_d = serve_scan.encode_window_finish, serve_scan.decode_window
        half = self.s // 2
        if self.planted == "stale_state":  # decode hands back the window before's frames
            last = []

            def decode_window(dec, payload_lists):
                last.append(real_d(dec, payload_lists))
                return last[-2] if len(last) > 1 else last[-1]
            serve_scan.decode_window = decode_window
        elif self.planted == "half_batch":  # half of the streams' payloads left out
            serve_scan.encode_window_finish = lambda h: [outs[:half] for outs in real_f(h)]
        else:  # one byte of one payload a step altered

            def finish(handle):
                steps = real_f(handle)
                for outs in steps:
                    i = max(range(len(outs)), key=lambda j: len(outs[j][0]))
                    p = bytearray(outs[i][0])
                    p[len(p) // 2] ^= 0x5A
                    outs[i] = (bytes(p), outs[i][1])
                return steps
            serve_scan.encode_window_finish = finish
        try:
            yield
        finally:
            serve_scan.encode_window_finish, serve_scan.decode_window = real_f, real_d

    def begun_traced_payloads(self):
        """The payloads of the steps pulled while the profiler collected:
        those whose K1 launches lie in the trace."""
        return [p for u in self.units if u.get("begun_traced") for p in u["payloads"]]
