"""Driver `session`: one screen-capture stream through the port's session
API, `Encoder.encode_batch` / `Decoder.decode_batch` on host frames in the
configuration's pixel format, a batch of `batch_frames` frames a call
(a recorder hands a second of frames at a time).

Set-up warms a session of its own on one batch of the traffic (a keyframe
and every P-frame kind), then builds the timed session, whose first
batch, in the window, holds its keyframe. A unit of the window is one
batch: encode it, then decode its payloads.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from spbench.reference.sptc import CorruptStreamError, StreamDecoder


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.h, self.w = c["height"], c["width"]
        self.n = c["batch_frames"]
        self.rgb32 = c["pixel_format"] == "RGB32"
        self.units = []  # per batch: payloads, decoded fingerprints, encode s, decode s
        self.failure = None
        self._buf = None  # the RGB32 input batch, reused

    # -- set-up ------------------------------------------------------------------

    def setup(self):
        from screenpressor_tpu_torch import CodecConfig, Decoder, Encoder, FormatParams, PixelFormat

        ctx = self.ctx
        self.screen = ctx.screen(self.h, self.w)
        codec = dict(ctx.config["codec"])
        if ctx.control:
            codec["loss"] = 1
        cfg = CodecConfig(width=self.w, height=self.h, **codec)
        fmt = FormatParams(PixelFormat[ctx.config["pixel_format"]])

        def session():
            return Encoder(cfg, fmt, device=ctx.device), Decoder(cfg, fmt, device=ctx.device)

        enc, dec = session()
        warm = enc.encode_batch(self.batch(0))
        dec.decode_batch([p for p, _ in warm])
        del enc, dec, warm
        ctx.synchronize()
        self.enc, self.dec = session()
        if ctx.fault:
            self.fault(ctx.fault)

    def batch(self, b: int):
        """Batch b's input frames. RGB32 frames are written into one
        buffer that every batch reuses (the session copies what it keeps)."""
        idx = range(b * self.n, (b + 1) * self.n)
        if not self.rgb32:
            return [self.screen.frame(i) for i in idx]
        if self._buf is None:
            self._buf = np.empty((self.n, self.h, self.w, 4), np.uint8)
        for j, i in enumerate(idx):
            self.screen.fill_rgb32(self._buf[j], i)
        return list(self._buf)

    # -- the window --------------------------------------------------------------

    def window(self, seconds: float, tracer):
        enc, dec = self.enc, self.dec
        if tracer.enabled:
            _wrap(enc._session, "encode_batch", tracer, "TorchEncoder.encode_batch")
            _wrap(dec._session, "decode_batch", tracer, "TorchDecoder.decode_batch")
        tracer.start()
        deadline = time.perf_counter() + seconds
        b = 0
        while time.perf_counter() < deadline:
            with tracer.span("frames"):
                frames = self.batch(b)
            try:
                with tracer.span("Encoder.encode_batch"):
                    t0 = time.perf_counter()
                    res = enc.encode_batch(frames)
                    t1 = time.perf_counter()
                pays = [p for p, _ in res]
                with tracer.span("Decoder.decode_batch"):
                    t2 = time.perf_counter()
                    out = dec.decode_batch(pays)
                    t3 = time.perf_counter()
            except Exception as e:  # the program failed: the run is not correct
                self.failure = f"batch {b}: {type(e).__name__}: {e}"
                break
            # the answers are held as fingerprints, taken outside the timed
            # calls, so that no frame outlives its batch (as in a player)
            with tracer.span("fingerprints"):
                prints = [fingerprint(o) for o in out]
            self.units.append({"batch": b, "payloads": pays, "decoded": prints,
                               "traced": tracer.prof is not None,
                               "encode_s": t1 - t0, "decode_s": t3 - t2})
            del frames, res, out
            tracer.unit_done()
            b += 1
        tracer.stop()
        print("spbench: batches (encode s, decode s): " + " ".join(
            f"{u['encode_s']:.3f},{u['decode_s']:.3f}" for u in self.units), file=sys.stderr)

    def end_to_end(self) -> dict:
        mpix = self.n * len(self.units) * self.h * self.w / 1e6
        enc_s = sum(u["encode_s"] for u in self.units)
        dec_s = sum(u["decode_s"] for u in self.units)
        return {"encode_mpix_s": mpix / enc_s if enc_s else None,
                "decode_mpix_s": mpix / dec_s if dec_s else None}

    def fault(self, name: str):
        """Break the timed path underneath (the harness's tests)."""
        enc, dec = self.enc, self.dec
        if name == "stale_state":  # decode hands back its state, unchanged
            real = dec.decode_batch

            def decode_batch(datas, **kw):
                out = real(datas, **kw)
                return [out[0]] * len(out)
            dec.decode_batch = decode_batch
        elif name == "half_batch":  # half of the batch left out
            real_e = enc.encode_batch
            enc.encode_batch = lambda frames, **kw: real_e(frames[: len(frames) // 2], **kw)
        elif name == "altered_token":  # one byte of one payload altered
            real_e = enc.encode_batch

            def encode_batch(frames, **kw):
                out = real_e(frames, **kw)
                i = max(range(len(out)), key=lambda j: len(out[j][0]) if out[j][1] else 0)
                p = bytearray(out[i][0])
                p[len(p) // 2] ^= 0x5A
                out[i] = (bytes(p), out[i][1])
                return out
            enc.encode_batch = encode_batch
        else:
            raise ValueError(f"no fault {name}")

    def release(self):
        self.enc = self.dec = None

    # -- the layers' inputs --------------------------------------------------------

    def traced_payloads(self):
        return [p for u in self.units if u["traced"] for p in u["payloads"]]

    # -- correct -------------------------------------------------------------------

    def check(self) -> tuple[dict, int, int]:
        """The numbers compared, each (value, limit), and (attempted,
        failed) frames. Every frame the window decoded is held to its
        input (by fingerprint). The reference decodes a stretch of the
        encoder's payloads from each keyframe of the window in turn, the
        traffic's `reference_frames[k]` frames from the k-th (the session's
        first keyframe, then the one at `kf_interval`, which lies batches
        into the window, with the state carried across batch ends), and
        holds them to their inputs."""
        missing = bad = 0
        for u in self.units:
            frames = self.batch(u["batch"])
            missing += max(0, len(frames) - len(u["payloads"]), len(frames) - len(u["decoded"]))
            for want, got in zip(frames, u["decoded"]):
                bad += got != fingerprint(_expected(want, self.rgb32))
        pays = [p for u in self.units for p in u["payloads"]]
        kf = self.ctx.config["codec"]["kf_interval"]
        ref_bad = ref_n = 0
        for k, n_ref in enumerate(self.ctx.traffic["reference_frames"]):
            start = k * kf
            if (k and not kf) or start >= len(pays):
                break
            ref = StreamDecoder(self.h, self.w)
            for i in range(start, min(start + n_ref, len(pays))):
                ref_n += 1
                try:
                    got = ref.decode(pays[i])
                except CorruptStreamError:
                    ref_bad += 1
                    continue
                fmt_ok = ref.bpp == (32 if self.rgb32 else 24)
                ref_bad += not (fmt_ok and np.array_equal(got, self.screen.frame(i)))
        print(f"spbench: the reference decoded {ref_n} frames", file=sys.stderr)
        attempted = self.n * len(self.units) + (self.n if self.failure else 0)
        failed = missing + bad + (self.n if self.failure else 0)
        compared = {"program_errors": (int(self.failure is not None), 0),
                    "frames_missing": (missing, 0), "frames_decoded_wrong": (bad, 0),
                    "reference_frames_wrong": (ref_bad, 0)}
        return compared, attempted, failed


def _expected(frame, rgb32: bool) -> np.ndarray:
    """What the decoder owes for an input frame: the same pixels; RGB32
    output carries alpha 255 (the upstream `ScreenCodec` output rule)."""
    if not rgb32:
        return frame
    out = frame.copy()
    out[..., 3] = 255
    return out


_WEIGHTS = {}


def fingerprint(frame) -> tuple:
    """(shape, dtype, two 64-bit sums of the frame's 8-byte words under
    fixed random odd weights, and its tail bytes): any change of the
    bytes moves a sum except with odds near 2**-64, at memory speed."""
    a = np.ascontiguousarray(frame)
    raw = a.reshape(-1).view(np.uint8)
    n8 = raw.size // 8
    if n8 not in _WEIGHTS:
        rng = np.random.default_rng(20261017)
        _WEIGHTS[n8] = rng.integers(0, 2**63, (2, n8), dtype=np.uint64) * 2 + 1
    words = raw[:n8 * 8].view(np.uint64)
    sums = tuple(int((words * w).sum(dtype=np.uint64)) for w in _WEIGHTS[n8])
    return a.shape, str(a.dtype), sums, raw[n8 * 8:].tobytes()


def _wrap(obj, name, tracer, span):
    real = getattr(obj, name)

    def wrapped(*a, **k):
        with tracer.span(span):
            return real(*a, **k)

    setattr(obj, name, wrapped)
