"""Per-stream codec session — PyTorch port of `screenpressor_tpu/jx/codec.py`.

The same state machine as the JAX session (flat shortcut, keyframe policy,
table renew on I / flat / raw frames, loss 0..5, raw escape, prev buffer,
deferred validity checks), with the heavy passes on the session's device.
`encode_batch` runs a batch phase by phase so that it pays a fixed number
of device-to-host copies per batch: the analysis counts (A), the data-block
record counts (B), the section sizes (C) and one gather of every payload
byte of the batch (D); the host then assembles the containers (E) with the
container writer (`container`, which also lays out phase D's gather).
Phase A analyses every P frame of the batch in one stream-batched call
(`blocks.analyze_compact_streams`), phase B classifies the data blocks of
all of them in one (`pframe.classify_assemble_streams`); phase C chains
the tables frame by frame.
`decode_batch` copies the stream-consistency flags of a batch back once.

Every tensor of a session lives on `device`: "cuda" unless the caller asks
for the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import container as ct
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.colorspace import apply_loss, rgb24_to_rgb32_batch
from screenpressor_tpu_torch.config import (ALG_FLAT, ALG_I, ALG_P, ALG_RAW, FTYPE_I, FTYPE_P,
                                            CodecConfig)
from screenpressor_tpu_torch.blocks import AREA, analyze_compact_streams, mv_candidates
from screenpressor_tpu_torch.coder import col_compact_bucket
from screenpressor_tpu_torch.iframe import (
    decode_i_device,
    encode_i_raw,
    i_phase,
    parse_i_header,
)
from screenpressor_tpu_torch.pframe import (
    SECTION_NAMES,
    classify_assemble_streams,
    decode_p_device,
    encode_p_sections,
    parse_p_header,
    payloads_to_device,
    raise_p_error,
)
from screenpressor_tpu_torch.tables import renew_tables_cached
from screenpressor_tpu_torch.transfer import owned_frames, pull, to_device, to_host


class ReusedBuffer:
    """A uint8 buffer that a session reuses call after call and never hands
    out: on `device`, or page-locked on the host (`device` None), where a
    copy to or from a card runs at the link's rate. It grows to the largest
    call. A page-locked block comes from PyTorch's caching host allocator,
    which rounds it up to a power of two (a 64-frame 1080p RGB32 batch,
    531 MB, takes 1 GiB) and keeps it for a later session when this one
    goes."""

    def __init__(self, device=None):
        self.device = device
        self._buf = None

    def take(self, shape) -> torch.Tensor:
        n = math.prod(shape)
        if self._buf is None or self._buf.numel() < n:
            self._buf = None  # the old block goes before the new one is made
            if self.device is None:
                self._buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            else:
                self._buf = torch.empty(n, dtype=torch.uint8, device=self.device)
        return self._buf[:n].view(shape)


def own_frames(outs, prev) -> list:
    """outs with every slot in storage of its own: the caller may write into
    what it gets, and idle P frames repeat a tensor (their previous frame,
    or `prev`, which the session keeps)."""
    seen = {id(prev)}
    owned = []
    for o in outs:
        owned.append(o.clone() if id(o) in seen else o)
        seen.add(id(o))
    return owned


class TorchEncoder:
    def __init__(self, cfg: CodecConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tables = renew_tables_cached(self.device)
        self.prev = None  # [H, W, 3] uint8 on device (lossy domain)
        self.fn = 0
        self.last_was_flat = False
        self.last_flat_color: tuple | None = None
        self.cands = to_device(mv_candidates(cfg), self.device, "codec.cands",
                               torch.int32).reshape(-1, 2)

    def encode(self, frame, force_key: bool = False):
        return self.encode_batch([frame], force_key=force_key)[0]

    def encode_batch(self, frames, force_key: bool = False, owned: bool = False):
        """Encode a list of frames -> list of (payload bytes, ftype),
        byte-identical to encoding them one by one. owned: the frames are
        uint8 [H, W, 3] tensors on the session's device, each in storage of
        its own that nothing else writes (the session API's converted
        frames), taken without owned_frames' copy."""
        with telemetry.span("sptc.codec.encode", unit=self.fn):
            return self._encode_batch(frames, force_key, owned)

    def _encode_batch(self, frames, force_key, owned):
        cfg = self.cfg
        n = len(frames)
        if n == 0:
            return []
        with telemetry.span("sptc.codec.encode.upload"):
            devs = [apply_loss(f if owned else owned_frames(f, self.device), cfg.loss)
                    for f in frames]
        prev_chain = [self.prev] + devs[:-1]

        # ---- phase A: analysis of every frame, one pull of the counts ----
        with telemetry.span("sptc.codec.encode.analysis"):
            # every P frame of the batch goes through one stream-batched
            # analysis against its own previous frame (a keyframe mid-batch
            # breaks the chain: the pairs need not be contiguous)
            kinds = []
            for i in range(n):
                fn = self.fn + i
                keyframe = (
                    (force_key and i == 0)
                    or prev_chain[i] is None
                    or fn == 0
                    or (cfg.kf_interval > 0 and fn % cfg.kf_interval == 0)
                )
                kinds.append("I" if keyframe else "P")
            p_idx = [i for i in range(n) if kinds[i] == "P"]
            row_of = {i: j for j, i in enumerate(p_idx)}
            counts, plans = [], []
            if p_idx:
                p_frames = torch.stack([devs[i] for i in p_idx])
                p_prevs = torch.stack([prev_chain[i] for i in p_idx])
                p_arrs, p_counts, p_flat = analyze_compact_streams(p_frames, p_prevs,
                                                                   self.cands, cfg)
                counts.append(torch.cat([p_counts, p_flat], dim=1))
            for i in range(n):
                if kinds[i] == "I":
                    records, lits, c, bm = i_phase(devs[i])
                    plans.append(("I", (records, lits, bm)))
                    counts.append(c)
                else:
                    plans.append(("P", {name: a[row_of[i]] for name, a in p_arrs.items()}))
            pulled = pull([counts], "codec.pull")[0]
            p_rows = pulled.pop(0).astype(np.int64) if p_idx else np.zeros((0, 11), np.int64)
            counts_host = [p_rows[row_of[i]] if kinds[i] == "P" else pulled.pop(0)
                           for i in range(n)]

        def flat_of(kind, ch):
            if kind == "I":
                return bool(ch[2]), (int(ch[3]), int(ch[4]), int(ch[5]))
            return bool(ch[7]), (int(ch[8]), int(ch[9]), int(ch[10]))

        # ---- phase B: one classification of the data blocks of every
        # changed P frame ----
        with telemetry.span("sptc.codec.encode.classify"):
            phase_b: list = [None] * n
            pl_host = {}
            n_data = np.where((p_rows[:, 0] != 0) & (p_rows[:, 7] == 0), p_rows[:, 6], 0)
            if n_data.any():
                pix, lit, pl, bms, roff = classify_assemble_streams(
                    p_frames, p_prevs, p_arrs["data_rects"], n_data)
                (pl_rows,) = pull([[pl]], "codec.pull")[0]
                for j in np.nonzero(n_data)[0]:
                    rows = slice(int(roff[j]), int(roff[j] + n_data[j] * AREA))
                    i = p_idx[j]
                    phase_b[i] = (pix[rows], lit[rows], pl[j], bms[j])
                    pl_host[i] = pl_rows[j]

        # ---- phase C: section encode, tables chained in frame order ----
        with telemetry.span("sptc.codec.encode.sections"):
            tables = self.tables
            last_flat, last_color = self.last_was_flat, self.last_flat_color
            results: list = [None] * n
            coded, small = [], []  # the coded frames, and what each pulls
            for i, (kind, payload) in enumerate(plans):
                ch = counts_host[i]
                flat, color = flat_of(kind, ch)
                if flat:
                    if not (last_flat and color == last_color):
                        tables = renew_tables_cached(self.device)
                        last_color = color
                    last_flat = True
                    results[i] = (ct.flat_frame(color), FTYPE_I)
                    telemetry.count("frames.flat")
                    continue
                last_flat = False
                if kind == "I":
                    n_rec, n_lit = int(ch[0]), int(ch[1])
                    records, lits, bm = payload
                    out = encode_i_raw(records, n_rec, lits, n_lit,
                                       renew_tables_cached(self.device), cfg, ct.raw_size(cfg),
                                       col_compact_bucket(int(ch[6])), bm)
                    tables = out[7]
                    coded.append((i, "I", ct.i_head(n_rec, n_lit), [out[0], out[3]]))
                    small.append([out[6], out[1], out[4], out[2], out[5]])
                elif not ch[0]:
                    results[i] = (ct.UNCHANGED_P, FTYPE_P)
                    telemetry.count("frames.unchanged")
                else:
                    telemetry.count("blocks.motion", ch[5])
                    telemetry.count("blocks.data", ch[6])
                    handle, tables = encode_p_sections(
                        payload, ch, phase_b[i], pl_host.get(i), tables, cfg)
                    _kts, nums, (xx1, xx2, n_data), bufs, starts, lens_l, stats = handle
                    head = ct.p_head([xx1, xx2, *(nums[s] for s in SECTION_NAMES), n_data])
                    coded.append((i, "P", head, bufs))
                    small.append([stats, *starts, *lens_l])
            pulled = pull(small, "codec.pull")

        # ---- phase D: one gather of every payload byte of the batch ----
        with telemetry.span("sptc.codec.encode.gather"):
            kept, frames = [], []
            for (i, kind, head, bufs), got in zip(coded, pulled):
                raw = bool(got[0][1])
                telemetry.count("frames.raw" if raw else "frames." + kind)
                kept.append((i, FTYPE_P if kind == "P" and not raw else FTYPE_I))
                frames.append((head, bufs, got, devs[i].reshape(-1)))
            (parts, src, lens), lays = ct.frame_layouts(frames)
            tight = ct.gather_segments(parts, src, lens)

        # ---- phase E: container assembly on the host ----
        with telemetry.span("sptc.codec.encode.assemble"):
            pos = 0
            for (i, ftype), (head, sizes_l, body, total) in zip(kept, lays):
                data, pos = ct.assemble(head, tight, pos, sizes_l, body, total)
                results[i] = (data, ftype)

        # ---- commit session state ----
        self.tables = tables
        self.prev = devs[-1]
        self.fn += n
        self.last_was_flat = last_flat
        self.last_flat_color = last_color
        return results


class TorchDecoder:
    def __init__(self, cfg: CodecConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tables = renew_tables_cached(self.device)
        self.prev = None  # [H, W, 3] uint8 on device
        self.fn = 0
        self.last_was_flat = False
        self.last_flat_color: tuple | None = None
        self._host = ReusedBuffer()  # page-locked: a card's decoded batch on its way out

    def decode(self, data: bytes) -> np.ndarray:
        return self.decode_batch([data])[0]

    def decode_batch(self, datas, device_out: bool = False, channels: int = 3):
        """Decode a list of frame payloads with one deferred validity copy.
        Host frames come back as arrays of their own: channels 3 the RGB24
        frames, 4 the RGB32 frames of the session API (alpha 255, K7 on the
        card). A card's batch leaves it in one copy.

        Stream-consistency violations raise CorruptStreamError after the
        batch's device work is queued; the session state then does not
        advance."""
        if channels not in (3, 4):
            raise ValueError(f"channels must be 3 or 4, not {channels}")
        with telemetry.span("sptc.codec.decode", unit=self.fn):
            return self._decode_batch(datas, device_out, channels)

    def _decode_batch(self, datas, device_out, channels):
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        dev = self.device
        outs: list = [None] * len(datas)
        checks = []
        tables = self.tables
        prev = self.prev
        last_flat, last_color = self.last_was_flat, self.last_flat_color
        with telemetry.span("sptc.codec.decode.queue"):
            for i, data in enumerate(datas):
                if not data:
                    raise bs.CorruptStreamError("empty frame")
                alg = bs.parse_header_byte(data[0])
                if alg == ALG_FLAT:
                    if len(data) < 4:
                        raise bs.CorruptStreamError("truncated flat frame")
                    color = (data[1], data[2], data[3])
                    frame = to_device(color, dev, "codec.decode.flat",
                                      torch.uint8).expand(h, w, 3).contiguous()
                    if not (last_flat and color == last_color):
                        prev = frame
                        tables = renew_tables_cached(dev)
                        last_color = color
                    last_flat = True
                    outs[i] = frame
                    continue
                last_flat = False
                if alg == ALG_I:
                    pay_rec, pay_col, n_rec, n_lit = parse_i_header(data, 1, cfg)
                    rec_d = to_device(pay_rec, dev, "codec.decode.i_payload")
                    col_d = to_device(pay_col, dev, "codec.decode.i_payload")
                    frame, total, tables = decode_i_device(
                        rec_d, col_d, n_rec, n_lit, renew_tables_cached(dev), cfg)
                    checks.append((i, (total != w * h).to(torch.int32)))
                    prev = frame
                    outs[i] = frame
                    continue
                if alg == ALG_RAW:
                    npix = h * w * 3
                    if len(data) < ct.raw_size(cfg):
                        raise bs.CorruptStreamError("truncated raw frame")
                    arr = np.frombuffer(data, np.uint8, npix, 1).reshape(h, w, 3)
                    frame = to_device(arr.copy(), dev, "codec.decode.raw")
                    tables = renew_tables_cached(dev)
                    prev = frame
                    outs[i] = frame
                    continue
                if alg != ALG_P:
                    raise bs.CorruptStreamError(f"unknown frame algorithm {alg}")
                if prev is None:
                    raise bs.CorruptStreamError("P-frame before any I-frame")
                parsed = parse_p_header(data, 1, cfg)
                if parsed is None:
                    outs[i] = prev
                    continue
                payloads, ns, kts, (xx1, xx2, _n_mv, n_data) = parsed
                frame, err, tables = decode_p_device(
                    payloads_to_device(payloads, dev), ns, kts, xx1, xx2, n_data,
                    prev, tables, cfg)
                checks.append((i, err))
                prev = frame
                outs[i] = frame

        with telemetry.span("sptc.codec.decode.check"):
            if checks:
                errs = to_host(torch.stack([e for _, e in checks]), "codec.decode.check")
                for (i, _), err in zip(checks, errs):
                    if int(err):
                        if bs.parse_header_byte(datas[i][0]) == ALG_I:
                            raise bs.CorruptStreamError(
                                f"frame {i}: records do not tile frame")
                        try:
                            raise_p_error(int(err))
                        except bs.CorruptStreamError as e:
                            raise bs.CorruptStreamError(f"frame {i}: {e}") from None
        self.tables = tables
        self.prev = prev
        self.last_was_flat = last_flat
        self.last_flat_color = last_color
        self.fn += len(datas)
        if device_out:
            return own_frames(outs, prev)
        if not outs:
            return []
        with telemetry.span("sptc.codec.decode.pull"):
            return self._pull(outs, prev, channels)

    def _pull(self, outs, prev, channels) -> list:
        """The decoded frames as host arrays, each of its own, so that a
        frame the caller keeps holds one frame's bytes. From a card: K7 (or,
        for RGB24, a stack) writes the batch into one buffer there, which
        comes into the session's page-locked buffer in one copy, one host
        sync; each frame is then cloned out of it (torch's copy runs on its
        CPU threads; numpy's on one)."""
        if self.device.type == "cpu":
            if channels == 4:
                return [rgb24_to_rgb32_batch([o])[0].numpy() for o in outs]
            return [o.numpy() for o in own_frames(outs, prev)]
        batch = rgb24_to_rgb32_batch(outs) if channels == 4 else torch.stack(outs)
        host = self._host.take(batch.shape)
        with telemetry.sync("codec.decode.pull"):
            host.copy_(batch)
        return [f.clone().numpy() for f in host]
