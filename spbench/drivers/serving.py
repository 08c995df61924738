"""Driver `serving`: S same-sized screen-share streams a step through the
port's serving loop, `serve_pipelined(BatchedEncoder, steps,
BatchedDecoder)` with device frames in and `device_out=True` (one step of
encoder lookahead), on one card or split over `devices` cards by the
`devices=` argument (one stream group a card, one controller).

A step's frames are rendered on the card by the traffic's generator from
a page uploaded in set-up (a few gathers a step, no host frame, no upload).
Set-up runs the first `warmup_steps` steps (all keyframes, then each P
kind and a step where one stream keyframes among P streams) through the
same sessions, untimed; the window goes on from there. A unit of the
window is one step; its latency runs from the frames being handed to
`encode_begin` until its decoded frames are synchronised on the card.
Each step's decoded frames are then compared on the card with the step's
frames rendered again, into a count that is read once the window has
closed; no decoded frame is kept.
"""

from __future__ import annotations

import sys
import time
from contextlib import nullcontext

import numpy as np

from spbench.reference.sptc import CorruptStreamError, StreamDecoder

class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.h, self.w, self.s = c["height"], c["width"], c["streams"]
        self.units = []  # per step: step, payloads, latency s
        self.wrong = None  # device count of streams decoded wrong
        self.failure = None
        self.syncs = 0

    def setup(self):
        import torch

        from screenpressor_tpu_torch import CodecConfig
        from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

        ctx, c = self.ctx, self.ctx.config
        self.screen = ctx.screen(self.h, self.w)
        codec = dict(c["codec"])
        if ctx.control:
            codec["loss"] = 1
        self.cfg = CodecConfig(width=self.w, height=self.h, **codec)
        offsets = None
        if ctx.traffic.get("kf_stagger"):
            offsets = (np.arange(self.s) * self.cfg.kf_interval) // self.s
        self.offsets = np.zeros(self.s, np.int64) if offsets is None else offsets
        devs = ctx.devices
        split = dict(devices=devs) if len(devs) > 1 else dict(device=devs[0])
        self.enc = BatchedEncoder(self.s, self.cfg, kf_offsets=offsets, **split)
        self.dec = BatchedDecoder(self.s, self.cfg, **split)
        self.home = torch.device(devs[0])
        self.screen.to_device(self.s, self.home)
        self.step = 0
        self.wrong = torch.zeros((), dtype=torch.int64, device=self.home)
        warm = ctx.config["warmup_steps"]
        self._serve(lambda: self.step < warm, None)
        self.dec.validate()
        ctx.synchronize()
        self.units.clear()
        self.wrong.zero_()  # the warm-up's steps were compared too; the window's count
        if ctx.fault:
            self.fault(ctx.fault)

    def frames(self, t: int):
        return self.screen.streams(t)

    def _serve(self, more, tracer):
        """Run steps while more() holds when a step's frames are due."""
        from screenpressor_tpu_torch.parallel.serving import serve_pipelined

        ctx = self.ctx
        handed = {}
        first = self.step

        def steps():
            while more():
                with ctx.no_sync_count(), (tracer.span("frames") if tracer else nullcontext()):
                    f = self.frames(self.step)
                handed[self.step] = time.perf_counter()
                self.step += 1
                yield f

        for k, (outs, decoded) in enumerate(serve_pipelined(self.enc, steps(), self.dec,
                                                            device_out=True)):
            with ctx.no_sync_count():
                ctx.synchronize()
            t = first + k
            self.units.append({"step": t, "payloads": [p for p, _ in outs],
                               "latency_s": time.perf_counter() - handed[t],
                               "traced": tracer is not None and tracer.prof is not None})
            with ctx.no_sync_count():
                self.wrong += _streams_wrong(decoded, self.frames(t))
            del decoded
            if tracer is not None:
                tracer.unit_done()

    def window(self, seconds: float, tracer):
        tracer.start()
        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        try:
            with self.ctx.sync_count(tracer.enabled) as counter:
                self._serve(lambda: time.perf_counter() < deadline, tracer)
            self.syncs = counter.count
            self.dec.validate()
        except Exception as e:  # the program failed: the run is not correct
            self.failure = f"step {self.step}: {type(e).__name__}: {e}"
        self.t1 = time.perf_counter()
        tracer.stop()
        lat = np.array([u["latency_s"] for u in self.units]) * 1e3
        if lat.size >= 5:
            print(f"spbench: steps {lat.size}, latency ms min {lat.min():.3f} median "
                  f"{np.median(lat):.3f} p95 {np.percentile(lat, 95):.3f} max {lat.max():.3f}; "
                  "median by fifth of the window: "
                  + " ".join(f"{np.median(q):.1f}" for q in np.array_split(lat, 5)),
                  file=sys.stderr)

    def end_to_end(self) -> dict:
        lat = [u["latency_s"] for u in self.units]
        wall = self.t1 - self.t0
        return {"serve_stream_fps": self.s * len(self.units) / wall if wall > 0 else None,
                "serve_step_p95_ms": 1e3 * p95(lat) if lat else None}

    def fault(self, name: str):
        """Break the timed path underneath (the harness's tests)."""
        enc, dec = self.enc, self.dec
        if name == "stale_state":  # decode hands back the step before's frames
            real, last = dec.decode, []

            def decode(payloads, device_out=False):
                out = real(payloads, device_out=device_out)
                last.append(out)
                return last[-2] if len(last) > 1 else out
            dec.decode = decode
        elif name == "half_batch":  # half of the streams' payloads left out
            real_f = enc.encode_finish
            enc.encode_finish = lambda pend: real_f(pend)[: self.s // 2]
        elif name == "altered_token":  # one byte of one payload altered
            real_f = enc.encode_finish

            def finish(pend):
                outs = real_f(pend)
                i = max(range(len(outs)), key=lambda j: len(outs[j][0]))
                p = bytearray(outs[i][0])
                p[len(p) // 2] ^= 0x5A
                outs[i] = (bytes(p), outs[i][1])
                return outs
            enc.encode_finish = finish
        else:
            raise ValueError(f"no fault {name}")

    def release(self):
        self.enc = self.dec = None

    def traced_payloads(self):
        return [p for u in self.units if u["traced"] for p in u["payloads"]]

    # -- correct -------------------------------------------------------------------

    def check(self) -> tuple[dict, int, int]:
        """Every step's decoded frames against their inputs (every stream,
        compared on the card during the window); the reference decodes
        `reference_streams` streams drawn from the seed from their first
        keyframe in the window for up to `reference_steps` steps and holds
        them to their inputs."""
        t = self.ctx.traffic
        missing = sum(max(0, self.s - len(u["payloads"])) for u in self.units)
        bad = int(self.wrong) if self.wrong is not None else self.s * len(self.units)
        ref_bad = self._reference(t["reference_streams"], t["reference_steps"])
        attempted = self.s * len(self.units) + (self.s if self.failure else 0)
        failed = missing + bad + (self.s if self.failure else 0)
        compared = {"program_errors": (int(self.failure is not None), 0),
                    "frames_missing": (missing, 0), "frames_decoded_wrong": (bad, 0),
                    "reference_frames_wrong": (ref_bad, 0)}
        return compared, attempted, failed

    def _reference(self, n_streams: int, n_steps: int):
        kf = self.cfg.kf_interval
        first = self.units[0]["step"] if self.units else 0
        last = first + len(self.units)
        # a stream's first keyframe step in the window
        key = [next((t for t in range(first, last) if (t + self.offsets[s]) % kf == 0), None)
               if kf else None for s in range(self.s)]
        ok = [s for s in range(self.s) if key[s] is not None]
        rng = np.random.default_rng([self.ctx.seed_key, 4])
        pick = rng.choice(ok, size=min(n_streams, len(ok)), replace=False) if ok else []
        bad = n = 0
        for s in pick:
            ref = StreamDecoder(self.h, self.w, self.ctx.config["codec"].get("k_fixed"))
            for t in range(key[s], min(key[s] + n_steps, last)):
                pays = self.units[t - first]["payloads"]
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
        print(f"spbench: the reference decoded {n} stream-frames of streams "
              f"{[int(s) for s in pick]}", file=sys.stderr)
        return bad


def _streams_wrong(decoded, want):
    """How many streams' decoded frames differ from `want` (a device
    count; decoded frames of another shape count every stream)."""
    if tuple(decoded.shape) != tuple(want.shape):
        return want.shape[0]
    return (decoded.to(want.device) != want).flatten(1).any(dim=1).sum()


def p95(xs) -> float:
    """The 95th percentile, linear between order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(xs, float), 95))
