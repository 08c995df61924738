"""Per-stream codec session — PyTorch port of `screenpressor_tpu/jx/codec.py`.

The same state machine as the JAX session (flat shortcut, keyframe policy,
table renew on I / flat / raw frames, loss 0..5, raw escape, prev buffer,
deferred validity checks), with the heavy passes on the session's device.
`encode_batch` runs a batch phase by phase so that it pays a fixed number
of device-to-host copies per batch: the analysis counts (A), the data-block
record counts (B), the section sizes (C) and one gather of every payload
byte of the batch (D); the host then assembles the containers (E). Phase A
analyses every P frame of the batch in one stream-batched call
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
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.colorspace import rgb24_to_rgb32_batch
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P, ALG_RAW, CodecConfig
from screenpressor_tpu_torch.blocks import AREA, analyze_compact_streams, mv_candidates
from screenpressor_tpu_torch.coder import col_compact_bucket, upload
from screenpressor_tpu_torch.iframe import (
    decode_i_device,
    encode_i_raw,
    i_geometry,
    i_phase,
    parse_i_header,
)
from screenpressor_tpu_torch.pframe import (
    classify_assemble_streams,
    decode_p_device,
    encode_p_sections,
    p_header,
    parse_p_header,
    payloads_to_device,
    raise_p_error,
)
from screenpressor_tpu_torch.tables import renew_tables_cached

FTYPE_I = 0
FTYPE_P = 1


def apply_loss(frame: torch.Tensor, loss: int) -> torch.Tensor:
    """Bit-truncation loss with half-step correction (spec.codec.apply_loss)."""
    if loss <= 0:
        return frame
    mask = 0xFF & ~((1 << loss) - 1)
    corr = (1 << loss) >> 1
    return (frame & mask) | corr


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """t as a numpy array: one device-to-host copy, a host sync at `site`."""
    with telemetry.sync(site):
        return t.cpu().numpy()


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


def _pull(tensors):
    """One device-to-host copy of a list of small int tensors -> list of
    numpy arrays."""
    if not tensors:
        return []
    flat = to_host(torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]), "codec.pull")
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos: pos + t.numel()])
        pos += t.numel()
    return out


def owned_frames(frames, device) -> torch.Tensor:
    """Frames (numpy or tensor) as uint8 on `device`, in storage of their
    own: a session keeps the last ones as `prev`, which must not change when
    the caller refills its capture buffer. One copy, contiguous (the kernels
    take raw pointers; an RGB32 frame's RGB view is strided)."""
    if not isinstance(frames, torch.Tensor):
        with telemetry.sync("codec.owned_frames"):
            return torch.tensor(np.ascontiguousarray(frames, np.uint8), device=device)
    crossing = frames.device.type != torch.device(device).type  # host <-> card
    with telemetry.sync("codec.owned_frames") if crossing else telemetry.NOOP:
        return frames.to(device, torch.uint8, copy=True, memory_format=torch.contiguous_format)


def gather_segments_device(parts, segs, device) -> torch.Tensor:
    """One torch.cat + index on the device: parts are flat uint8 tensors,
    segs (part, offset, length) byte ranges. Returns the concatenated bytes
    as a uint8 tensor. The ranges go up in one non-blocking upload and are
    expanded into byte indices on the device."""
    if not segs:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    bases = np.cumsum([0] + [p.numel() for p in parts])
    seg = np.asarray(segs, np.int64).reshape(-1, 3)
    lens = seg[:, 2]
    total = int(lens.sum())
    flat = torch.cat(parts)
    if not total:
        return flat[:0]
    # each byte's source is its range's start minus the range's output
    # offset, plus its own output position
    shift = bases[seg[:, 0]] + seg[:, 1] - (np.cumsum(lens) - lens)
    meta = upload(np.concatenate([shift, lens]), flat.device)
    idx = torch.repeat_interleave(meta[:len(seg)], meta[len(seg):], output_size=total)
    return flat[idx + torch.arange(total, device=flat.device)]


def gather_segments(parts, segs):
    """gather_segments_device + one device-to-host copy -> numpy bytes."""
    dev = parts[0].device if parts else "cpu"
    return to_host(gather_segments_device(parts, segs, dev), "codec.gather")


class TorchEncoder:
    def __init__(self, cfg: CodecConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tables = renew_tables_cached(self.device)
        self.prev = None  # [H, W, 3] uint8 on device (lossy domain)
        self.fn = 0
        self.last_was_flat = False
        self.last_flat_color: tuple | None = None
        with telemetry.sync("codec.cands"):
            self.cands = torch.tensor(mv_candidates(cfg), dtype=torch.int32,
                                      device=self.device).reshape(-1, 2)

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
        h, w = cfg.height, cfg.width
        raw_size = 1 + w * h * 3
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
            pulled = _pull(counts)
            p_rows = pulled.pop(0).reshape(len(p_idx), -1) if p_idx else np.zeros((0, 11))
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
                (pl_rows,) = _pull([pl])
                pl_rows = pl_rows.reshape(len(p_idx), 3)
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
            handles: list = [None] * n
            small = []
            for i, (kind, payload) in enumerate(plans):
                ch = counts_host[i]
                flat, color = flat_of(kind, ch)
                if flat:
                    if not (last_flat and color == last_color):
                        tables = renew_tables_cached(self.device)
                        last_color = color
                    last_flat = True
                    results[i] = (bytes([bs.header_byte(ALG_FLAT), *color]), FTYPE_I)
                    telemetry.count("frames.flat")
                    continue
                last_flat = False
                if kind == "I":
                    n_rec, n_lit = int(ch[0]), int(ch[1])
                    records, lits, bm = payload
                    out = encode_i_raw(records, n_rec, lits, n_lit,
                                       renew_tables_cached(self.device), cfg, raw_size,
                                       col_compact_bucket(int(ch[6])), bm)
                    tables = out[7]
                    k_rec, _, k_col, _ = i_geometry(n_rec, n_lit, cfg)
                    handles[i] = ("I", (n_rec, n_lit),
                                  [(out[0], k_rec), (out[3], k_col)])
                    small.append([out[1], out[2], out[4], out[5], out[6]])
                elif not ch[0]:
                    results[i] = (bytes([bs.header_byte(ALG_P), 0]), FTYPE_P)
                    telemetry.count("frames.unchanged")
                else:
                    telemetry.count("blocks.motion", ch[5])
                    telemetry.count("blocks.data", ch[6])
                    handle, tables = encode_p_sections(
                        payload, ch, phase_b[i], pl_host.get(i), tables, cfg)
                    kts, _nums, _hdr, bufs, starts, lens_l, stats = handle
                    handles[i] = ("P", handle,
                                  [(buf, k) for buf, (_, k, _) in zip(bufs, kts)])
                    pieces = []
                    for start, lens in zip(starts, lens_l):
                        pieces.extend([start, lens])
                    small.append(pieces + [stats])
            flat_small = _pull([t for pieces in small for t in pieces])

        # ---- phase D: one gather of every payload byte of the batch ----
        with telemetry.span("sptc.codec.encode.gather"):
            parts, segs, layouts = [], [], [None] * n
            cursor = 0
            for i, hnd in enumerate(handles):
                if hnd is None:
                    continue
                sections = hnd[2]
                got = flat_small[cursor: cursor + 2 * len(sections) + 1]
                cursor += 2 * len(sections) + 1
                total, is_raw = int(got[-1][0]), bool(got[-1][1])
                telemetry.count("frames.raw" if is_raw else "frames." + hnd[0])
                sizes_l = []
                if is_raw:
                    parts.append(devs[i].reshape(-1))
                    segs.append((len(parts) - 1, 0, h * w * 3))
                for (buf, k), start, lens in zip(sections, got[0::2], got[1::2]):
                    cap = buf.shape[1]
                    sizes = np.where(lens > 0, cap - start, 0).astype(np.int64)
                    sizes_l.append(sizes)
                    if is_raw:
                        continue
                    parts.append(buf.reshape(-1))
                    segs.extend((len(parts) - 1, lane * cap + int(start[lane]),
                                 int(sizes[lane])) for lane in range(k) if sizes[lane])
                layouts[i] = (total, is_raw, sizes_l)
            tight = gather_segments(parts, segs)

        # ---- phase E: container assembly on the host ----
        with telemetry.span("sptc.codec.encode.assemble"):
            pos = 0
            for i, lay in enumerate(layouts):
                if lay is None:
                    continue
                total, is_raw, sizes_l = lay
                if is_raw:
                    data = bytes([bs.header_byte(ALG_RAW)]) + tight[pos:pos + h * w * 3].tobytes()
                    pos += h * w * 3
                    results[i] = (data, FTYPE_I)
                    continue
                chunks = []
                for sizes in sizes_l:
                    width = bs.size_width(int(sizes.max(initial=0)))
                    end = pos + int(sizes.sum())
                    chunks.append(bytes([bs.section_status_byte(len(sizes), width)])
                                  + sizes.astype(f"<u{width}").tobytes()
                                  + tight[pos:end].tobytes())
                    pos = end
                if handles[i][0] == "I":
                    n_rec, n_lit = handles[i][1]
                    head = bytes([bs.header_byte(ALG_I)]) + bs.pack_varint(n_rec, n_lit)
                    ftype = FTYPE_I
                else:
                    head = p_header(handles[i][1])
                    ftype = FTYPE_P
                data = head + b"".join(chunks)
                if len(data) != total:
                    raise RuntimeError(f"frame {i}: container {len(data)} B, "
                                       f"device size rule {total} B")
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
                    with telemetry.sync("codec.decode.flat"):
                        frame = torch.tensor(color, dtype=torch.uint8,
                                             device=dev).expand(h, w, 3).contiguous()
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
                    with telemetry.sync("codec.decode.i_payload"):
                        rec_d = torch.as_tensor(pay_rec, device=dev)
                    with telemetry.sync("codec.decode.i_payload"):
                        col_d = torch.as_tensor(pay_col, device=dev)
                    frame, total, tables = decode_i_device(
                        rec_d, col_d, n_rec, n_lit, renew_tables_cached(dev), cfg)
                    checks.append((i, (total != w * h).to(torch.int32)))
                    prev = frame
                    outs[i] = frame
                    continue
                if alg == ALG_RAW:
                    npix = h * w * 3
                    if len(data) < 1 + npix:
                        raise bs.CorruptStreamError("truncated raw frame")
                    arr = np.frombuffer(data, np.uint8, npix, 1).reshape(h, w, 3)
                    with telemetry.sync("codec.decode.raw"):
                        frame = torch.as_tensor(arr.copy(), device=dev)
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
