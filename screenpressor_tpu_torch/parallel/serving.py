"""Multi-stream serving — PyTorch port of `screenpressor_tpu/parallel/serving.py`
(the conferencing configuration: S same-sized streams per call).

`BatchedEncoder` / `BatchedDecoder` keep every stream's state on the
device: the previous frames [S, H, W, 3] and one table set per stream
([S, ...] tensors, `tables.renew_tables_streams`), which the stream-batched
section kernels update in place. Each section group of a step is one K1 or
K2 launch over all the streams that code it (an index list of stream ids,
not a skip mask); the keyframing streams share one K3 run walk and, on
decode, one K4 launch. On encode the P streams share one change analysis,
motion search (one K5 launch, no host sync) and record compaction
(`blocks.analyze_compact_streams`) and one classification of all their
data blocks (`pframe.classify_assemble_streams`, one K3 launch); each
section is dealt for all of them in one gather (`coder.deal_streams`). On
decode the coded P streams share one block resolution, motion apply and
block rebuild (`pframe.rebuild_p_streams`).

Streams use a fixed lane count (`CodecConfig.k_fixed`, default
min(k_max, 256)); the bitstreams are standard SPTC and decode with any
decoder configured with the same k_fixed. Record arrays, step counts and
payload buffers take the exact sizes of the pulled counts.

An encode step is a set of generator stages (the P streams' and the I
streams'); each `yield` is a request for device values, and `_drain` copies
the requests of all live stages to the host in ONE device-to-host copy per
round (`transfer.pull`). The last round gathers every used lane byte of the
stage, and the container writer (`container`) assembles the streams'
frames from them. `encode_begin` runs the stages up to their first request
(the analysis, which reads no table), so `serve_pipelined` can queue step
t+1's analysis before it finishes step t.

`devices=` splits a session along the stream axis (the reference's dp
sharding): stream group g, the contiguous range [g * S / n, (g + 1) * S / n),
is a one-device session of its own on devices[g]. Every group's front half
is queued before any group's back half, outputs come back in global stream
order, and a damaged stream's message carries its global index. One
controller runs the groups in turn: each group's part of `encode_begin`,
`encode_finish`, `decode` and `validate` is a span `sptc.serve.group`
whose `card` is g; `decode(device_out=True)` gathers the groups' frames
onto devices[0] (span `sptc.serve.decode.gather`). The counters
`serving.dp.scatter_bytes` and `serving.dp.gather_bytes` add the bytes of
frames that change device on the way to a group and in that gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import container as ct
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.colorspace import apply_loss
from screenpressor_tpu_torch.config import (ALG_FLAT, ALG_I, ALG_P, ALG_RAW, FTYPE_I, FTYPE_P,
                                            CodecConfig)
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.blocks import analyze_compact_streams, mv_candidates
from screenpressor_tpu_torch.classify import classify_i_streams
from screenpressor_tpu_torch.iframe import read_i_container
from screenpressor_tpu_torch.pframe import (
    SECTION_NAMES,
    classify_assemble_streams,
    header_row,
    raise_p_error,
    read_p_container,
    rebuild_p_streams,
    step_layout_from,
    step_layout_host,
    undeal_sections_streams,
)
from screenpressor_tpu_torch.recon import reconstruct_i_streams
from screenpressor_tpu_torch.tables import renew_rows, renew_rows_at, renew_tables_streams
from screenpressor_tpu_torch.transfer import (on_device, owned_frames, pull, to_device,
                                              to_host, upload, upload_all)

I32 = torch.int32


class _Default(str):
    """The default device "cuda", told apart from a caller's "cuda"."""


_CUDA = _Default("cuda")


def _groups_of(n_streams: int, device, devices):
    """The stream groups of a devices= split: [(device, slice)], or None."""
    if devices is None:
        return None
    if device is not _CUDA:
        raise ValueError("give device or devices, not both")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0 or n_streams % n:
        raise ValueError(f"{n_streams} streams do not split into {n} equal groups")
    g = n_streams // n
    return [(d, slice(j * g, (j + 1) * g)) for j, d in enumerate(devices)]


def _moved_bytes(t: torch.Tensor, dev: torch.device) -> int:
    """t's bytes if copying it to `dev` changes its device, else 0."""
    same = t.device.type == dev.type and dev.index in (None, t.device.index)
    return 0 if same else t.numel() * t.element_size()


def _to_group(frames, dev, sl):
    """A group's slice of a step's frames, on its device (non-blocking)."""
    if isinstance(frames, torch.Tensor):
        part = frames[sl]
        telemetry.count("serving.dp.scatter_bytes", _moved_bytes(part, dev))
        return part.to(dev, non_blocking=True)
    return upload(np.asarray(frames)[sl], dev)


def _gather(outs, dev) -> torch.Tensor:
    """The groups' decoded frames as one tensor on `dev`."""
    with telemetry.span("sptc.serve.decode.gather"):
        telemetry.count("serving.dp.gather_bytes", sum(_moved_bytes(o, dev) for o in outs))
        return torch.cat([o.to(dev) for o in outs])


def _k_fixed(cfg: CodecConfig) -> CodecConfig:
    if cfg.k_fixed is None:
        cfg = dataclasses.replace(cfg, k_fixed=min(cfg.k_max, 256))
    return cfg


def _deal_ragged(srcs, ns, k: int):
    """Deal the sections of C streams in one gather per section.

    srcs: per section a ragged record array [N, W] and the row offset of
    each stream's records in it; ns: per section the C record counts (host
    ints). Returns per section (dealt [C, T, K, W], lens [C, K] on the
    device, lens on the host, T) with T the largest step count of the
    streams; the offsets, counts and lane lengths go up in one upload."""
    ns = [np.asarray(n, np.int64) for n in ns]
    c = len(ns[0])
    lens_h = [n[:, None] // k + (np.arange(k) < n[:, None] % k) for n in ns]
    meta = upload(np.concatenate(
        [np.concatenate([np.asarray(off, np.int64), n, ln.reshape(-1)])
         for (_, off), n, ln in zip(srcs, ns, lens_h)]), srcs[0][0].device)
    out = []
    for ((src, _), n, ln, part) in zip(srcs, ns, lens_h,
                                       meta.split([2 * c + c * k] * len(ns))):
        off_d, n_d, lens_d = part.split([c, c, c * k])
        t = max(tc.steps_for(int(v), k) for v in n)
        out.append((tc.deal_streams(src, off_d, n_d, k, t), lens_d.view(c, k).to(I32),
                    ln, t))
    return out


class BatchedEncoder:
    """Encode S streams in lockstep (staggered keyframes, flat / no-change /
    raw shortcuts per stream) with device-resident per-stream state."""

    def __init__(self, n_streams: int, cfg: CodecConfig, device=_CUDA,
                 kf_offsets=None, devices=None):
        """kf_offsets: optional [S] ints staggering the keyframe phase:
        stream i keyframes when (fn + kf_offsets[i]) % kf_interval == 0.
        devices: n devices to split the streams over (S % n == 0), instead
        of `device`; on one card, the same device n times."""
        self.cfg = _k_fixed(cfg)
        self.s = n_streams
        self.kf_offsets = (np.zeros(n_streams, np.int64) if kf_offsets is None
                           else np.asarray(kf_offsets, np.int64))
        assert self.kf_offsets.shape == (n_streams,)
        self.fn = 0
        split = _groups_of(n_streams, device, devices)
        self.groups = None if split is None else [
            (BatchedEncoder(sl.stop - sl.start, cfg, d, self.kf_offsets[sl]), sl)
            for d, sl in split]
        self.device = torch.device(device if split is None else split[0][0])
        self.prev = None  # [S, H, W, 3] uint8 on the device (lossy domain)
        self.last_flat = np.zeros(n_streams, bool)
        self.flat_color = np.zeros((n_streams, 3), np.uint8)
        # the flat bookkeeping a window left on the device (last_flat,
        # flat_color tensors), taken to the host by the next step
        self.flat_dev = None
        if self.groups is not None:
            return
        self.tables_b = renew_tables_streams(n_streams, self.device)
        self.cands = to_device(mv_candidates(self.cfg), self.device, "serving.cands",
                               I32).reshape(-1, 2)

    def has_prev(self) -> bool:
        """Whether a step has been encoded (P frames can follow)."""
        return (self.prev if self.groups is None else self.groups[0][0].prev) is not None

    def encode(self, frames, force_key: bool = False):
        """frames: [S, H, W, 3] uint8 (numpy or tensor) -> list of S
        (payload bytes, ftype)."""
        return self.encode_finish(self.encode_begin(frames, force_key))

    def encode_begin(self, frames, force_key: bool = False):
        """Queue the table-free front half of a step (the analysis of the P
        streams, the classification of the I streams) and return a pending
        handle for encode_finish. At most one encode may be pending."""
        step = self.fn
        with telemetry.span("sptc.serve.encode_begin", unit=step):
            return step, self._begin(frames, force_key)

    def _begin(self, frames, force_key):
        if self.groups is not None:
            self.fn += 1
            pend = []
            for card, (g, sl) in enumerate(self.groups):
                with telemetry.span("sptc.serve.group", card=card), on_device(g.device):
                    pend.append(g._begin(_to_group(frames, g.device, sl), force_key))
            return pend
        self.take_flat()
        cfg = self.cfg
        s = self.s
        frames = apply_loss(owned_frames(frames, self.device), cfg.loss)
        assert frames.shape == (s, cfg.height, cfg.width, 3)
        if force_key or self.prev is None or self.fn == 0:
            key_mask = np.ones(s, bool)
        elif cfg.kf_interval > 0:
            key_mask = ((self.fn + self.kf_offsets) % cfg.kf_interval) == 0
        else:
            key_mask = np.zeros(s, bool)
        self.fn += 1
        # the P stage first: each round resumes the stages in this order
        stages = []
        if (~key_mask).any() and self.prev is not None:
            stages.append(("sptc.serve.encode.p",
                           self._p_stages(frames, self.prev, np.nonzero(~key_mask)[0])))
        if key_mask.any():
            stages.append(("sptc.serve.encode.i", self._i_stages(frames, np.nonzero(key_mask)[0])))
        pend = self._prime(stages)
        self.prev = frames
        return pend

    def encode_finish(self, pend):
        """Run a pending step to the end: the host copies, the section
        launches and the container assembly. Returns the encode() list."""
        step, pend = pend
        with telemetry.span("sptc.serve.encode_finish", unit=step):
            return self._finish(pend)

    def _finish(self, pend):
        if self.groups is not None:
            outs = []
            for card, ((g, _), p) in enumerate(zip(self.groups, pend)):
                with telemetry.span("sptc.serve.group", card=card), on_device(g.device):
                    outs += g._finish(p)
            return outs
        outs = self._drain(*pend)
        return [next((o[i] for o in outs if o[i] is not None), None)
                for i in range(self.s)]

    def take_flat(self):
        """Take the flat bookkeeping a window left on the device to the
        host (one copy)."""
        if self.flat_dev is not None:
            last_flat, color = pull([list(self.flat_dev)], "serving.pull")[0]
            self.last_flat, self.flat_color = last_flat.copy(), color.copy()
            self.flat_dev = None

    @staticmethod
    def _prime(stages):
        """Run each stage (span name, generator) to its first request
        (device work only)."""
        names = [name for name, _ in stages]
        stages = [st for _, st in stages]
        outs, reqs = [None] * len(stages), [[] for _ in stages]
        for j, st in enumerate(stages):
            try:
                with telemetry.span(names[j]):
                    reqs[j] = st.send(None)
            except StopIteration as e:
                outs[j], stages[j] = e.value, None
        return names, stages, reqs, outs

    @staticmethod
    def _drain(names, stages, reqs, outs):
        """Advance primed stages to the end, one host copy per round."""
        while any(st is not None for st in stages):
            got = pull([r if st is not None else [] for st, r in zip(stages, reqs)],
                       "serving.pull")
            for j, st in enumerate(stages):
                if st is None:
                    continue
                try:
                    with telemetry.span(names[j]):
                        reqs[j] = st.send(got[j])
                except StopIteration as e:
                    outs[j], stages[j], reqs[j] = e.value, None, []
        return outs

    def _flat(self, i: int, color) -> tuple:
        """Flat-frame shortcut of stream i (renews its tables when the
        color changes). Returns (payload, renew)."""
        color = tuple(int(v) for v in color)
        renew = not (self.last_flat[i] and tuple(self.flat_color[i]) == color)
        if renew:
            self.flat_color[i] = color
        self.last_flat[i] = True
        return (ct.flat_frame(color), FTYPE_I), renew

    # ------------------------------------------------------------------ I --
    def _i_stages(self, frames, own):
        """I-encode the streams `own`; other entries stay None and their
        state is untouched."""
        cfg, k = self.cfg, self.cfg.k_fixed
        fr = frames[to_device(own, self.device, "serving.i_ids")]
        cls = classify_i_streams(fr)
        bms = [tc.color_touched_bitmap(lits, n_lit) for _, _, lits, n_lit in cls]
        flat = (fr == fr[:, :1, :1]).flatten(1).all(dim=1)
        counts = torch.stack([
            torch.cat([torch.stack([n_rec, n_lit, fl.to(I32)]), fr[j, 0, 0].to(I32),
                       bm.sum(dtype=I32).reshape(1)])
            for j, ((_, n_rec, _, n_lit), fl, bm) in enumerate(zip(cls, flat, bms))])
        (ch,) = yield [counts]

        out = [None] * self.s
        renew = np.zeros(self.s, bool)
        coded = []
        for j, i in enumerate(own):
            if ch[j, 2]:
                out[i], renew[i] = self._flat(i, ch[j, 3:6])
                telemetry.count("frames.flat")
            else:
                self.last_flat[i] = False
                coded.append(j)
                renew[i] = True  # a keyframe codes from renewed tables
        renew_rows(self.tables_b, renew)
        if not coded:
            return out
        ids = [int(own[j]) for j in coded]
        telemetry.count("frames.I", len(ids))
        n_rec = [int(ch[j, 0]) for j in coded]
        n_lit = [int(ch[j, 1]) for j in coded]
        npx = cfg.height * cfg.width
        offs = np.arange(len(coded)) * npx
        (rec, lens_rec, lr_h, t_rec), (col, lens_col, lc_h, t_col) = _deal_ragged(
            [(torch.cat([cls[j][0] for j in coded]), offs),
             (torch.cat([cls[j][2] for j in coded]), offs)], [n_rec, n_lit], k)
        col_w = tc.col_compact_bucket(max(int(ch[j, 6]) for j in coded))
        bufs, starts = tc.encode_sections_streams(
            [rec, col], [lens_rec, lens_col], self.tables_b,
            (("rec", k, t_rec), ("col", k, t_col)), ids, col_w,
            torch.stack([bms[j] for j in coded]))
        starts_h = yield starts

        sizes = np.stack([ct.lane_sizes(st, ln, b.shape[2])
                          for st, ln, b in zip(starts_h, [lr_h, lc_h], bufs)], axis=1)
        src, lens = ct.lane_segments(*ct.section_rows(bufs), np.stack(starts_h, axis=1), sizes)
        telemetry.count("serving.encode.lanes", len(lens))
        (tight,) = yield [ct.gather_segments_device([b.reshape(-1) for b in bufs], src, lens,
                                                    self.device)]

        pos = 0
        for j, i in enumerate(ids):
            data, pos = ct.assemble(ct.i_head(n_rec[j], n_lit[j]), tight, pos, sizes[j])
            out[i] = (data, FTYPE_I)
        return out

    # ------------------------------------------------------------------ P --
    def _p_stages(self, frames, prevs, own):
        """P-encode the streams `own` against prevs; other entries stay None
        and their state is untouched."""
        cfg, k = self.cfg, self.cfg.k_fixed
        h, w = cfg.height, cfg.width
        dev = self.device
        if len(own) < self.s:
            own_t = upload(np.asarray(own, np.int64), dev)
            frames_o, prevs_o = frames[own_t], prevs[own_t]
        else:
            frames_o, prevs_o = frames, prevs
        arrs, counts, flat = analyze_compact_streams(frames_o, prevs_o, self.cands, cfg)
        (ch,) = yield [torch.cat([counts, flat], dim=1)]

        out = [None] * self.s
        renew = np.zeros(self.s, bool)
        active = []
        for j, i in enumerate(own):
            if ch[j, 7]:
                out[i], renew[i] = self._flat(i, ch[j, 8:11])
                telemetry.count("frames.flat")
                continue
            self.last_flat[i] = False
            if not ch[j, 0]:
                out[i] = (ct.UNCHANGED_P, FTYPE_P)
                telemetry.count("frames.unchanged")
                continue
            active.append(j)
        renew_rows(self.tables_b, renew)
        if not active:
            return out

        # data blocks of the active streams: one classification + touched rows
        n_data = np.zeros(len(own), np.int64)
        n_data[active] = ch[active, 6]
        telemetry.count("blocks.data", n_data.sum())
        telemetry.count("blocks.motion", ch[active, 5].sum())
        if n_data.any():
            pix, lit, plc_d, bms, roff = classify_assemble_streams(
                frames_o, prevs_o, arrs["data_rects"], n_data)
            (plc,) = yield [plc_d]
        else:  # no literals: each stream's touched rows are row 0 alone
            pix = torch.zeros((0, 2), dtype=I32, device=dev)
            lit = torch.zeros((0, 3), dtype=I32, device=dev)
            bms = tc.color_touched_bitmap(lit, 0)[None].expand(len(own), -1)
            roff = np.zeros(len(own), np.int64)
            plc = np.zeros((len(own), 3), np.int64)
            plc[:, 2] = 1

        ids = [int(own[j]) for j in active]
        nbp = arrs["bt"].shape[1]
        a_off = np.asarray(active, np.int64) * nbp
        srcs = [(arrs[name].reshape(-1, arrs[name].shape[2]), a_off)
                for name in ("bt", "sxy", "mv")]
        srcs += [(pix, roff[active]), (lit, roff[active])]
        nums = {name: [int(v) for v in col] for name, col in zip(
            SECTION_NAMES, (ch[active, 3], ch[active, 4], ch[active, 5], plc[active, 0],
                            plc[active, 1]))}
        dealt = _deal_ragged(srcs, [nums[name] for name in SECTION_NAMES], k)
        kts = tuple((name, k, t) for name, (_, _, _, t) in zip(SECTION_NAMES, dealt))
        col_w = tc.col_compact_bucket(int(plc[active, 2].max()))
        a_t = upload(np.asarray(active, np.int64), dev)
        bufs, starts = tc.encode_sections_streams([d for d, _, _, _ in dealt],
                                                  [ln for _, ln, _, _ in dealt], self.tables_b,
                                                  kts, ids, col_w, bms[a_t])
        starts_h = yield starts

        # container sizes on the host; raw escape per stream
        lens_h = [ln for _, _, ln, _ in dealt]
        sizes = np.stack([ct.lane_sizes(st, ln, b.shape[2])
                          for st, ln, b in zip(starts_h, lens_h, bufs)], axis=1)
        hdrs = [ct.p_head([int(ch[j, 1]), int(ch[j, 2]), *(nums[name][r] for name in SECTION_NAMES),
                           int(ch[j, 6])]) for r, j in enumerate(active)]
        totals = ct.container_size([len(hd) for hd in hdrs], sizes)
        is_raw = ct.raw_escape(totals, ct.raw_size(cfg))
        n_raw = int(is_raw.sum())
        telemetry.count("frames.raw", n_raw)
        telemetry.count("frames.P", len(ids) - n_raw)
        raw_mask = np.zeros(self.s, bool)
        raw_mask[np.asarray(ids)[is_raw]] = True
        renew_rows(self.tables_b, raw_mask)
        # one gather: the coded streams' lanes and, in their place, the
        # escaping streams' pixels
        parts = [b.reshape(-1) for b in bufs]
        at = sum(b.numel() for b in bufs)
        raw_src, raw_len = np.zeros(len(ids), np.int64), np.zeros(len(ids), np.int64)
        for r in np.flatnonzero(is_raw):
            parts.append(frames[ids[r]].reshape(-1))
            raw_src[r], raw_len[r] = at, h * w * 3
            at += h * w * 3
        sizes[is_raw] = 0
        src, lens = ct.lane_segments(*ct.section_rows(bufs), np.stack(starts_h, axis=1), sizes,
                                     raw_src, raw_len)
        telemetry.count("serving.encode.lanes", len(lens) - n_raw)
        (tight,) = yield [ct.gather_segments_device(parts, src, lens, dev)]

        pos = 0
        for r, i in enumerate(ids):
            if is_raw[r]:
                data, pos = ct.assemble(ct.RAW_HEAD, tight, pos, body=h * w * 3)
                out[i] = (data, FTYPE_I)
            else:
                data, pos = ct.assemble(hdrs[r], tight, pos, sizes[r], total=int(totals[r]))
                out[i] = (data, FTYPE_P)
        return out


class BatchedDecoder:
    """Decode S streams per call with device-resident per-stream state. A
    batch may mix flat, raw, no-change, coded I and coded P frames; the
    coded I streams share one K2 launch per section group and one K4
    launch, the coded P streams one K2 launch per section group and one
    stream-batched rebuild. A step's host inputs go to the device in one
    upload."""

    def __init__(self, n_streams: int, cfg: CodecConfig, device=_CUDA, devices=None):
        """devices: n devices to split the streams over (S % n == 0), as
        BatchedEncoder's."""
        self.cfg = _k_fixed(cfg)
        self.s = n_streams
        self.base = 0  # the global index of stream 0 (a group of a split)
        split = _groups_of(n_streams, device, devices)
        self.groups = None
        if split is not None:
            self.groups = []
            for d, sl in split:
                g = BatchedDecoder(sl.stop - sl.start, cfg, d)
                g.base = sl.start
                self.groups.append((g, sl))
        self.device = torch.device(device if split is None else split[0][0])
        self.prev = None  # [S, H, W, 3] uint8 on the device
        self.last_flat = np.zeros(n_streams, bool)
        self.flat_color = np.zeros((n_streams, 3), np.uint8)
        self._pending_err = None  # (device error words [S] or [F, S], P mask)
        self.fn = 0  # steps decoded
        if split is None:
            self.tables_b = renew_tables_streams(n_streams, self.device)

    def decode(self, payloads, device_out: bool = False):
        """payloads: S frame byte strings -> [S, H, W, 3] frames (numpy, or
        the device tensor with device_out, whose stream check is then
        deferred to the next decode() / validate())."""
        step, self.fn = self.fn, self.fn + 1
        with telemetry.span("sptc.serve.decode", unit=step):
            return self._decode(payloads, device_out)

    def _decode(self, payloads, device_out):
        self.validate()
        assert len(payloads) == self.s
        if self.groups is not None:
            outs = []
            for card, (g, sl) in enumerate(self.groups):
                with telemetry.span("sptc.serve.group", card=card), on_device(g.device):
                    outs.append(g._decode(payloads[sl], device_out=True))
            if device_out:
                return _gather(outs, self.device)
            self.validate()
            return np.concatenate([to_host(o, "serving.decode.pull") for o in outs])
        with telemetry.span("sptc.serve.decode.parse"):
            plan, host = self._parse(payloads, lambda i: f"stream {self.base + i}")
        with telemetry.span("sptc.serve.decode.upload"):
            dev = upload_all(host, self.device)
        with telemetry.span("sptc.serve.decode.run"):
            frames, err = self._run(plan, dev)
        if plan["checked"]:
            if device_out:
                self._pending_err = (err, plan["p_mask"])
            else:
                self._raise_errs(to_host(err, "serving.decode.check"), plan["p_mask"])
        # the caller may write into what it gets: never hand out prev itself
        # (.cpu() of a CUDA tensor is a copy already)
        out = frames.clone() if device_out or not frames.is_cuda else frames
        return out if device_out else to_host(out, "serving.decode.pull")

    def _parse(self, payloads, where, have_prev=None):
        """The host half of a step: parse and check every payload (a
        CorruptStreamError names stream i as where(i)), advance the flat
        bookkeeping, and lay out what the device half needs: each section
        of the coded streams is cut into one [C, K, L] array. have_prev:
        whether P frames may come (default: a step was decoded). Returns
        (plan, the host arrays of its one upload, in the order _run takes
        them)."""
        cfg, s = self.cfg, self.s
        if have_prev is None:
            have_prev = self.prev is not None
        h, w = cfg.height, cfg.width
        renew = np.zeros(s, bool)
        raws, flats = {}, {}
        i_parse, p_parse = {}, {}
        for i, data in enumerate(payloads):
            if not data:
                raise bs.CorruptStreamError(f"{where(i)}: empty frame")
            alg = bs.parse_header_byte(data[0])
            if alg == ALG_FLAT:
                if len(data) < 4:
                    raise bs.CorruptStreamError(f"{where(i)}: truncated flat")
                color = np.frombuffer(data[1:4], np.uint8)
                if not (self.last_flat[i] and (self.flat_color[i] == color).all()):
                    renew[i] = True
                    self.flat_color[i] = color
                self.last_flat[i] = True
                flats[i] = color
                continue
            self.last_flat[i] = False
            if alg == ALG_RAW:
                if len(data) < ct.raw_size(cfg):
                    raise bs.CorruptStreamError(f"{where(i)}: truncated raw")
                raws[i] = np.frombuffer(data, np.uint8, h * w * 3, 1).reshape(h, w, 3)
                renew[i] = True
            elif alg == ALG_I:
                renew[i] = True
                i_parse[i] = _read_container(read_i_container, data, cfg, where, i)
            elif alg != ALG_P:
                raise bs.CorruptStreamError(f"{where(i)}: unknown algorithm {alg}")
            elif not have_prev:
                raise bs.CorruptStreamError(f"{where(i)}: P-frame before keyframe")
            else:
                p_parse[i] = _read_container(read_p_container, data, cfg, where, i)
        coded_p = [i for i, x in p_parse.items() if x is not None]
        p_mask = np.zeros(s, bool)
        p_mask[coded_p] = True
        plan = {"renew": bool(renew.any()), "i_ids": list(i_parse), "p_ids": coded_p,
                "raw": bool(raws), "flat": bool(flats), "p_mask": p_mask,
                "checked": bool(i_parse or coded_p)}
        host = [np.nonzero(renew)[0]] if plan["renew"] else []
        if i_parse:
            ids = plan["i_ids"]
            plan["i_n"] = [(i_parse[i][2], i_parse[i][3]) for i in ids]
            host += [np.asarray(ids, np.int64)]
            host += [_stack_lanes(payloads, ids, [i_parse[i][j] for i in ids]) for j in (0, 1)]
        if coded_p:
            rows = []
            for i in coded_p:
                _lanes, ns, _kts, (xx1, xx2, _n_mv, n_data) = p_parse[i]
                rows.append(header_row(ns, xx1, xx2, n_data))
            lay_host, plan["p_layout"] = step_layout_host(rows)
            host += [np.asarray(coded_p, np.int64), lay_host]
            host += [_stack_lanes(payloads, coded_p, [p_parse[i][0][j] for i in coded_p])
                     for j in range(len(SECTION_NAMES))]
        if raws:
            host += [np.asarray(list(raws), np.int64), np.stack(list(raws.values()))]
        if flats:
            host += [np.asarray(list(flats), np.int64), np.stack(list(flats.values()))]
        return plan, host

    def _run(self, plan, dev):
        """The device half of a step from its uploaded arrays. Returns
        (frames [S, H, W, 3] uint8, error words [S] int32); the frames
        become prev."""
        cfg, k, s, device = self.cfg, self.cfg.k_fixed, self.s, self.device
        h, w = cfg.height, cfg.width
        dev = iter(dev)
        if plan["renew"]:
            renew_rows_at(self.tables_b, next(dev))
        if self.prev is None:
            self.prev = torch.zeros((s, h, w, 3), dtype=torch.uint8, device=device)
        frames = self.prev.clone()
        err = torch.zeros(s, dtype=I32, device=device)

        if plan["i_ids"]:
            ids_t, pay_rec, pay_col = next(dev), next(dev), next(dev)
            n_rec = [n for n, _ in plan["i_n"]]
            n_lit = [n for _, n in plan["i_n"]]
            lens = [torch.stack([tc.lane_lens(n, k, device) for n in ns]) for ns in (n_rec, n_lit)]
            kts = (("rec", k, max(tc.steps_for(n, k) for n in n_rec)),
                   ("col", k, max(tc.steps_for(n, k) for n in n_lit)))
            recs, lits = tc.decode_sections_streams([pay_rec, pay_col], lens, self.tables_b,
                                                    kts, plan["i_ids"])
            records = [tc.undeal(recs[j], n, k, max(n, 1)) for j, n in enumerate(n_rec)]
            literals = [tc.undeal(lits[j], n, k, max(n, 1)) for j, n in enumerate(n_lit)]
            frames[ids_t] = reconstruct_i_streams(records, literals, h, w)
            totals = torch.stack([r[:, 1].sum(dtype=I32) for r in records])
            err[ids_t] = (totals != h * w).to(I32)

        if plan["p_ids"]:
            ids_t = next(dev)
            lay = step_layout_from(next(dev), plan["p_layout"])
            pays = [next(dev) for _ in SECTION_NAMES]
            lens = [tc.lane_lens_streams(lay.hdr[:, j], k) for j in range(len(SECTION_NAMES))]
            kts = tuple((name, k, tc.steps_for(cap, k))
                        for name, cap in zip(SECTION_NAMES, lay.caps))
            recs_l = tc.decode_sections_streams(pays, lens, self.tables_b, kts, plan["p_ids"])
            frames[ids_t], err[ids_t] = rebuild_p_streams(
                undeal_sections_streams(recs_l, lay, kts), lay, self.prev[ids_t], self.cfg)
        if plan["raw"]:
            ids_t = next(dev)
            frames[ids_t] = next(dev)
        if plan["flat"]:
            ids_t = next(dev)
            frames[ids_t] = next(dev)[:, None, None, :].expand(-1, h, w, 3)
        self.prev = frames
        return frames, err

    def _raise_errs(self, errs: np.ndarray, p_mask: np.ndarray):
        """Raise for the first failing stream by index (errs [S], or [F, S]
        over a window's steps: a stream's largest word)."""
        errs = errs.reshape(-1, self.s)
        if not errs.any():
            return
        sidx = int(np.nonzero(errs.any(axis=0))[0][0])
        bad = int(errs[:, sidx].max())
        label = f"stream {self.base + sidx}"
        if bad == 1 and not p_mask[sidx]:
            raise bs.CorruptStreamError(f"{label}: records do not tile frame")
        try:
            raise_p_error(bad)
        except bs.CorruptStreamError as e:
            raise bs.CorruptStreamError(f"{label}: {e}") from None

    def validate(self):
        """Resolve the deferred stream check of a device_out decode. Called
        by the next decode(); call it after the last step of a session."""
        for card, (g, _) in enumerate(self.groups or ()):
            with telemetry.span("sptc.serve.group", card=card):
                g.validate()
        pend, self._pending_err = self._pending_err, None
        if pend is not None:
            self._raise_errs(to_host(pend[0], "serving.validate"), pend[1])


def _read_container(read, data: bytes, cfg: CodecConfig, where, i: int):
    """read(data, 1, cfg), a CorruptStreamError naming stream i as where(i)."""
    try:
        return read(data, 1, cfg)
    except bs.CorruptStreamError as e:
        raise bs.CorruptStreamError(f"{where(i)}: {e}") from None


def _stack_lanes(payloads, ids, lanes) -> np.ndarray:
    """One section of the streams `ids`, lanes holding each one's
    bitstream.read_section (sizes, first, end) in its payload -> [C, K, L]
    uint8, L = max(largest lane, 4): one join and one masked copy."""
    sizes = np.stack([sz for sz, _, _ in lanes])
    joined = b"".join([memoryview(payloads[i])[a:b] for i, (_, a, b) in zip(ids, lanes)])
    telemetry.count("serving.decode.lanes", sizes.size)
    return tc.pad_lanes(joined, sizes)


def serve_pipelined(enc: BatchedEncoder, batches, dec: BatchedDecoder | None = None,
                    device_out: bool = True):
    """Serving loop with one step of encoder lookahead: yields, per batch and
    in order, (outs, decoded) with `outs` the encode() list and `decoded`
    dec's frames for it (None without dec). Step t+1's analysis is queued
    before step t's host copies and assembly; the bytes equal step-by-step
    encode() / decode() (the lookahead reads no table)."""
    pend = None
    for frames in batches:
        nxt = enc.encode_begin(frames)
        if pend is not None:
            outs = enc.encode_finish(pend)
            yield outs, (None if dec is None else
                         dec.decode([p for p, _ in outs], device_out=device_out))
        pend = nxt
    if pend is not None:
        outs = enc.encode_finish(pend)
        yield outs, (None if dec is None else
                     dec.decode([p for p, _ in outs], device_out=device_out))
