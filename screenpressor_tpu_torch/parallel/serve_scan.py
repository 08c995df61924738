"""Window serving — PyTorch port of `screenpressor_tpu/parallel/serve_scan.py`.

A window advances F serving steps of a `BatchedEncoder` (all S streams) on
the device with no host read between its steps: analysis, data-block
classification at a fixed capacity, the section encode (K1) with the raw
escape, the keyframe slots, the flat / no-change bookkeeping and the
container bytes (the container writer's device emitter,
`container.container_emit`) all stay on the device, with fixed capacities
throughout (`WindowConfig`). The steps are a Python loop (torch has no
scan); every K1 launch takes its step count from a capacity, not from
pulled counts; the block analysis (change map, sub-rects, flat flags,
motion search) is one K5 launch a step (`blocks.analyze_blocks_streams`),
which reads nothing back. `encode_window_finish` then makes two pulls: the
[F, S] lengths and kinds, then one gather of exactly the used bytes (RAW
bodies included), which `container.assemble` cuts into the frames.

Capacities are part of the bytes. Within them a window emits exactly the
sequential `BatchedEncoder.encode()` bytes; a stream-step beyond them is
emitted as a RAW frame of its lossy input, and its tables are renewed (the
reference's rule, serve_scan.py:250-252, 283, 302, 328):
  P: n_data > bcap, n_pix > rec_cap or n_lit > col_cap;
  I: n_rec > irec_cap or n_lit > icol_cap;
  either: the size rule's raw escape (`container.raw_escape`) or
  total > pack_cap.
The keyframe slots code from renewed tables over the full color table (no
colw), which changes no byte.

`decode_window` decodes F steps through a `BatchedDecoder`: every payload
is parsed first (a CorruptStreamError names "step t stream i"), the
window's host arrays go up in one upload, each payload tensor sized exactly
to its step, and the stream check is deferred to the next decode() /
validate().

A `devices=` session (serving.py) runs a window per stream group: every
group's begin, then every group's finish; the bytes equal the unsplit
window's.

`serve_windowed` serves any iterable of steps, one with no end included:
it reads ahead only the F steps that the next run's plan needs.

Spans (`telemetry`), each with the unit of its window's first step:
`sptc.serve.window.begin` (a child `sptc.serve.window.step` a step
queued), `sptc.serve.window.finish` (children `sptc.serve.window.pull`,
once for the lengths and kinds and once for the gather of the used bytes,
and `sptc.serve.window.assemble`), `sptc.serve.window.decode` (children
`sptc.serve.window.parse`, the F `_parse` calls, and
`sptc.serve.window.run`, the one upload and the F `_run` calls). On a
`devices=` split each group's part is a `sptc.serve.group` span with the
group's `card`, as in serving.py. Counters: `serving.window.steps` (steps
coded inside windows), `serving.window.single_steps` (serve_windowed's
fallback steps), and from the pulled kinds `frames.I`, `frames.P`,
`frames.flat`, `frames.unchanged`, `frames.raw`.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import container as ct
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.blocks import analyze_compact_streams
from screenpressor_tpu_torch.classify import classify_i_streams
from screenpressor_tpu_torch.colorspace import apply_loss
from screenpressor_tpu_torch.config import FTYPE_I, FTYPE_P, next_pow2
from screenpressor_tpu_torch.pframe import SECTION_NAMES, classify_assemble_fixed
from screenpressor_tpu_torch.tables import renew_rows_at, renew_where
from screenpressor_tpu_torch.transfer import on_device, pull, upload, upload_all

# kind codes of the pulled [F, S] matrix
K_FLAT, K_I, K_NOCHANGE, K_P, K_RAW = 0, 1, 2, 3, 4
# the frame counters the per-step path keeps, by kind code
KIND_COUNTERS = (("frames.flat", K_FLAT), ("frames.I", K_I), ("frames.unchanged", K_NOCHANGE),
                 ("frames.P", K_P), ("frames.raw", K_RAW))

U8 = torch.uint8
I64 = torch.int64


# ---------------------------------------------------------------------------
# The window's steps
# ---------------------------------------------------------------------------


class WindowConfig:
    """Static capacities of a window (shapes only: overflow takes the raw
    escape, never corrupts)."""

    def __init__(self, cfg, n_streams: int, f: int = 8, c: int = 2,
                 rec_cap: int = 8192, col_cap: int = 8192,
                 irec_cap: int = 32768, icol_cap: int = 16384,
                 bcap: int = 512, pack_cap: int = 65536):
        self.f, self.c = f, c
        self.rec_cap, self.col_cap = rec_cap, col_cap
        self.irec_cap = min(irec_cap, next_pow2(cfg.width * cfg.height))
        self.icol_cap = min(icol_cap, next_pow2(cfg.width * cfg.height))
        self.bcap = min(bcap, next_pow2(cfg.nbx * cfg.nby))
        self.pack_cap = pack_cap
        # the device varint emitter writes at most 4 LEB128 bytes a field;
        # every header field is bounded by the pixel count
        assert cfg.width * cfg.height < 1 << 28, (
            "window programs require frame fields < 2^28 (device varint "
            "emitter is 4-byte LEB128)"
        )


def _p_slots(enc, wcfg, frames, prevs, ids):
    """The P streams `ids` (host ints; frames, prevs theirs) of one window
    step. Returns (out [C, pack_cap], lens [C], raw [C], flat [C], color
    [C, 3], nochange [C])."""
    cfg, k = enc.cfg, enc.cfg.k_fixed
    c = frames.shape[0]
    dev = frames.device
    arrs, counts, flat4 = analyze_compact_streams(frames, prevs, enc.cands, cfg)
    counts = counts.to(I64)
    is_flat = flat4[:, 0] != 0
    active = (counts[:, 0] != 0) & ~is_flat
    nochange = ~is_flat & (counts[:, 0] == 0)

    # data blocks at a fixed capacity, no host read
    n_data = torch.where(active, counts[:, 6], 0)
    pix, lit, plc = classify_assemble_fixed(frames, prevs, arrs["data_rects"],
                                            n_data.clamp(max=wcfg.bcap), wcfg.bcap)
    n_pix = torch.where(active, plc[:, 0].to(I64), 0)
    n_lit = torch.where(active, plc[:, 1].to(I64), 0)
    overflow = active & ((counts[:, 6] > wcfg.bcap) | (n_pix > wcfg.rec_cap)
                         | (n_lit > wcfg.col_cap))
    keep = active & ~overflow
    ns = [torch.where(active, counts[:, 3], 0), torch.where(active, counts[:, 4], 0),
          torch.where(active, counts[:, 5], 0), torch.where(keep, n_pix, 0),
          torch.where(keep, n_lit, 0)]
    hdr_vals = torch.stack([counts[:, 1], counts[:, 2], *ns, n_data], dim=1)

    # the five sections, each T from its capacity
    caps = [arrs["bt"].shape[1]] * 3 + [min(wcfg.rec_cap, pix.shape[1]),
                                        min(wcfg.col_cap, lit.shape[1])]
    kts = tuple((name, k, tc.steps_for(cap, k)) for name, cap in zip(SECTION_NAMES, caps))
    srcs = (arrs["bt"], arrs["sxy"], arrs["mv"], pix, lit)
    dealt, lens = [], []
    for (_, _, t), src, n in zip(kts, srcs, ns):
        off = torch.arange(c, device=dev) * src.shape[1]
        dealt.append(tc.deal_streams(src.reshape(-1, src.shape[2]), off, n, k, t))
        lens.append(tc.lane_lens_streams(n, k))
    bufs, starts = tc.encode_sections_streams(dealt, lens, enc.tables_b, kts, ids)
    out, total = ct.container_emit(*ct.heads(ct.P_HEAD, hdr_vals), list(zip(bufs, starts, lens)),
                                   wcfg.pack_cap)
    raw = active & (overflow | ct.raw_escape(total, ct.raw_size(cfg)) | (total > wcfg.pack_cap))
    return out, total, raw, is_flat, flat4[:, 1:4].to(U8), nochange


def _i_slots(enc, wcfg, frames, ids, ids_t):
    """The keyframing streams `ids` (host ints; ids_t on the device) of one
    window step: coded from renewed tables with the full color table.
    Returns (out [C, pack_cap], lens [C], raw [C], flat [C], color [C, 3])."""
    cfg, k = enc.cfg, enc.cfg.k_fixed
    h, w = cfg.height, cfg.width
    npx = h * w
    dev = frames.device
    cls = classify_i_streams(frames)
    is_flat = (frames == frames[:, :1, :1]).flatten(1).all(dim=1)
    n_rec = torch.stack([n for _, n, _, _ in cls]).to(I64)
    n_lit = torch.stack([n for _, _, _, n in cls]).to(I64)
    overflow = (n_rec > wcfg.irec_cap) | (n_lit > wcfg.icol_cap)
    use = ~is_flat & ~overflow
    n_rec = torch.where(use, n_rec, 0)
    n_lit = torch.where(use, n_lit, 0)
    # a keyframe codes from renewed tables; a flat one keeps its tables
    # for the flat bookkeeping
    renew_rows_at(enc.tables_b, ids_t, ~is_flat)
    off = torch.arange(len(ids), device=dev) * npx
    kts = (("rec", k, tc.steps_for(min(wcfg.irec_cap, npx), k)),
           ("col", k, tc.steps_for(min(wcfg.icol_cap, npx), k)))
    dealt = [tc.deal_streams(torch.cat([r for r, _, _, _ in cls]), off, n_rec, k, kts[0][2]),
             tc.deal_streams(torch.cat([lt for _, _, lt, _ in cls]), off, n_lit, k, kts[1][2])]
    lens = [tc.lane_lens_streams(n_rec, k), tc.lane_lens_streams(n_lit, k)]
    bufs, starts = tc.encode_sections_streams(dealt, lens, enc.tables_b, kts, ids)
    out, total = ct.container_emit(*ct.heads(ct.I_HEAD, torch.stack([n_rec, n_lit], dim=1)),
                                   list(zip(bufs, starts, lens)), wcfg.pack_cap)
    raw = ~is_flat & (overflow | ct.raw_escape(total, ct.raw_size(cfg)) | (total > wcfg.pack_cap))
    return out, total, raw, is_flat, frames[:, 0, 0]


def encode_window_steps(enc, frames_fs, key_fs, idx, wcfg):
    """F window steps over a one-device BatchedEncoder's state, queued with
    no host read, a span `sptc.serve.window.step` each. frames_fs
    [F, S, H, W, 3] uint8 (lossy) on the device; key_fs [F, S] host bools;
    idx: per step the device index tensors of its P streams (None when all
    S are) and of its keyframing streams. Commits prev, the tables and the
    flat bookkeeping (on the device, enc.flat_dev). Returns (outs
    [F, S, pack_cap] uint8, lens [F, S], kinds [F, S])."""
    s = enc.s
    dev = enc.device
    pc = wcfg.pack_cap
    if enc.flat_dev is None:
        enc.flat_dev = tuple(upload_all([enc.last_flat, enc.flat_color], dev))
    last_flat, flat_color = enc.flat_dev
    prev = enc.prev
    outs, lens, kinds = [], [], []
    for t in range(frames_fs.shape[0]):
        with telemetry.span("sptc.serve.window.step"):
            frames = frames_fs[t]
            own_p, own_i = np.nonzero(~key_fs[t])[0], np.nonzero(key_fs[t])[0]
            idx_p, idx_i = idx[t]
            out = torch.zeros((s, pc), dtype=U8, device=dev)
            out_len = torch.zeros(s, dtype=I64, device=dev)
            kind = torch.zeros(s, dtype=I64, device=dev)
            raw = torch.zeros(s, dtype=torch.bool, device=dev)
            flat = torch.zeros(s, dtype=torch.bool, device=dev)
            nochange = torch.zeros(s, dtype=torch.bool, device=dev)
            color = torch.zeros((s, 3), dtype=U8, device=dev)
            if own_p.size:
                sel = slice(None) if idx_p is None else idx_p
                o, n, r, fl, col, nc = _p_slots(enc, wcfg, frames[sel], prev[sel], own_p)
                out[sel], out_len[sel], raw[sel], flat[sel], color[sel], nochange[sel] = (
                    o, n, r, fl, col, nc)
                kind[sel] = torch.where(fl, K_FLAT, torch.where(nc, K_NOCHANGE, K_P))
            if own_i.size:
                o, n, r, fl, col = _i_slots(enc, wcfg, frames[idx_i], own_i, idx_i)
                out[idx_i], out_len[idx_i], raw[idx_i], flat[idx_i], color[idx_i] = (
                    o, n, r, fl, col)
                kind[idx_i] = torch.where(fl, K_FLAT, K_I)

            # flat bookkeeping; raw escapes and flat color changes renew
            same = last_flat & (flat_color == color).all(dim=1)
            renew_where(enc.tables_b, raw | (flat & ~same))
            last_flat = flat
            flat_color = torch.where(flat[:, None], color, flat_color)

            # small frames: flat (4 B), no-change (2 B), raw header (1 B + body)
            kind = torch.where(raw, K_RAW, kind)
            small, small_len = ct.small_frames(flat, nochange, raw, color)
            is_small = flat | nochange | raw
            out[:, :4] = torch.where(is_small[:, None], small, out[:, :4])
            out_len = torch.where(is_small, small_len, out_len)
            outs.append(out)
            lens.append(out_len)
            kinds.append(kind)
            prev = frames
    enc.prev = frames_fs[-1].clone()
    enc.flat_dev = (last_flat, flat_color)
    return torch.stack(outs), torch.stack(lens), torch.stack(kinds)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _window_frames(frames_list, device, loss: int) -> torch.Tensor:
    """A window's frame batches -> [F, S, H, W, 3] uint8 on `device`, lossy,
    in storage of their own (one upload for host frames)."""
    if all(isinstance(f, np.ndarray) for f in frames_list):
        frames = upload(np.stack([np.asarray(f, np.uint8) for f in frames_list]), device)
    else:
        frames = torch.stack([torch.as_tensor(f).to(device, torch.uint8) for f in frames_list])
    return apply_loss(frames, loss)


def encode_window(enc, frames_list, wcfg: WindowConfig):
    """Run one window of len(frames_list) steps through a BatchedEncoder's
    device state. Caller must ensure: a step was encoded before, no step
    force-keys all streams, and each step keyframes at most wcfg.c streams
    (use plan_windows). Returns a list of per-step encode() result lists."""
    return encode_window_finish(encode_window_begin(enc, frames_list, wcfg))


def encode_window_begin(enc, frames_list, wcfg: WindowConfig):
    """Queue a window's device work and commit the encoder's device state
    (prev, tables, flat bookkeeping) with no pull; returns a handle for
    encode_window_finish. The next window's begin may be issued before this
    one's finish."""
    step = enc.fn
    with telemetry.span("sptc.serve.window.begin", unit=step):
        telemetry.count("serving.window.steps", len(frames_list))
        return step, _begin(enc, frames_list, wcfg)


def _begin(enc, frames_list, wcfg):
    f = len(frames_list)
    if enc.groups is not None:
        handles = []
        for card, (g, sl) in enumerate(enc.groups):
            with telemetry.span("sptc.serve.group", card=card), on_device(g.device):
                handles.append(_begin(
                    g, [f_[sl] if isinstance(f_, np.ndarray)
                        else f_[sl].to(g.device, non_blocking=True) for f_ in frames_list],
                    wcfg))
        enc.fn += f
        return enc, handles
    cfg = enc.cfg
    s = enc.s
    assert enc.prev is not None
    key_fs = np.zeros((f, s), bool)
    for t in range(f):
        if cfg.kf_interval > 0:
            key_fs[t] = ((enc.fn + t + enc.kf_offsets) % cfg.kf_interval) == 0
        assert key_fs[t].sum() <= wcfg.c, "keyframe schedule exceeds window slots"
    enc.fn += f
    # the steps' stream index lists, in one upload
    host = []
    for t in range(f):
        own_p = np.nonzero(~key_fs[t])[0]
        host += [own_p if 0 < own_p.size < s else None, np.nonzero(key_fs[t])[0]]
    got = iter(upload_all([a for a in host if a is not None], enc.device))
    dev_idx = [None if a is None else next(got) for a in host]
    idx = list(zip(dev_idx[0::2], dev_idx[1::2]))
    frames_fs = _window_frames(frames_list, enc.device, cfg.loss)
    outs, lens, kinds = encode_window_steps(enc, frames_fs, key_fs, idx, wcfg)
    return enc, (frames_fs, outs, lens, kinds)


def encode_window_finish(handle):
    """Pull a begun window's results (two pulls) and assemble the
    containers. Returns a list of per-step encode() result lists."""
    step, body = handle
    with telemetry.span("sptc.serve.window.finish", unit=step):
        return _finish(body)


def _finish(handle):
    enc, body = handle
    if enc.groups is not None:
        parts = []
        for card, ((g, _), h) in enumerate(zip(enc.groups, body)):
            with telemetry.span("sptc.serve.group", card=card), on_device(g.device):
                parts.append(_finish(h))
        return [[o for p in parts for o in p[t]] for t in range(len(parts[0]))]
    frames_fs, outs, lens, kinds = body
    f, s, pc = outs.shape
    npx3 = frames_fs[0, 0].numel()
    # pull 1: the [F, S] lengths and kinds
    with telemetry.span("sptc.serve.window.pull"):
        lens_h, kinds_h = pull([[lens, kinds]], "serving.pull")[0]
    for name, code in KIND_COUNTERS:
        telemetry.count(name, np.count_nonzero(kinds_h == code))
    # pull 2: exactly the used container bytes, RAW bodies after their header
    with telemetry.span("sptc.serve.window.pull"):
        rows = outs.reshape(f * s, 1, pc)
        parts, at = [rows.reshape(-1)], outs.numel()
        raw_src, raw_len = np.zeros(f * s, np.int64), np.zeros(f * s, np.int64)
        for r in np.flatnonzero(kinds_h.reshape(-1) == K_RAW):
            parts.append(frames_fs[r // s, r % s].reshape(-1))
            raw_src[r], raw_len[r] = at, npx3
            at += npx3
        src, seg_lens = ct.lane_segments(*ct.section_rows([rows]),
                                         np.zeros((f * s, 1, 1), np.int64),
                                         lens_h.reshape(f * s, 1, 1), raw_src, raw_len)
        tight = ct.gather_segments(parts, src, seg_lens)
    with telemetry.span("sptc.serve.window.assemble"):
        results, pos = [], 0
        for t in range(f):
            out_t = []
            for i in range(s):
                kd = int(kinds_h[t, i])
                data, pos = ct.assemble(b"", tight, pos,
                                        body=int(lens_h[t, i]) + (npx3 if kd == K_RAW else 0))
                out_t.append((data, FTYPE_P if kd in (K_NOCHANGE, K_P) else FTYPE_I))
            results.append(out_t)
    return results


def plan_windows(enc, n_steps: int, wcfg: WindowConfig):
    """Split the next n_steps into runs eligible for encode_window (>= 2
    steps, every step keyframing <= c streams, prev exists) and single
    fallback steps. Returns a list of ('window', length) / ('step', 1)."""
    cfg = enc.cfg
    fn0 = enc.fn
    have_prev = enc.has_prev()

    def keys_at(f):
        if f == 0:
            return enc.s  # session start keyframes every stream
        if cfg.kf_interval > 0:
            return int((((f + enc.kf_offsets) % cfg.kf_interval) == 0).sum())
        return 0

    eligible = [
        (have_prev or i > 0) and keys_at(fn0 + i) <= wcfg.c
        for i in range(n_steps)
    ]
    plan = []
    t = 0
    while t < n_steps:
        run = 0
        while t + run < n_steps and run < wcfg.f and eligible[t + run]:
            run += 1
        if run >= 2:
            plan.append(("window", run))
            t += run
        else:
            plan.append(("step", 1))
            t += 1
    return plan


def serve_windowed(enc, batches, dec=None, wcfg: WindowConfig | None = None,
                   device_out: bool = True):
    """Window serving driver: like serve_pipelined, but F-step windows on
    both sides (encode_window + decode_window). Yields (outs, decoded) per
    step, each as soon as its window is decoded.

    `batches` may be any iterable, one with no end included. Each next run
    is the one plan_windows plans over the whole sequence: a step's
    eligibility is fixed by its step number, so the run starting at a step
    needs only the next F batches. A window is begun before the previous
    one is finished, so at most 2F - 1 batches are pulled beyond the last
    step yielded."""
    if wcfg is None:
        wcfg = WindowConfig(enc.cfg, enc.s)
    source = iter(batches)
    ahead = deque()  # batches pulled, not yet begun
    pend = None  # a begun, unfinished window (device work in flight)

    def emit_window(handle):
        steps = encode_window_finish(handle)
        if dec is None:
            return [(outs, None) for outs in steps]
        frames_fs = decode_window(dec, [[p for p, _ in outs] for outs in steps])
        return [(outs, frames_fs[j]) for j, outs in enumerate(steps)]

    while True:
        for frames in source:
            ahead.append(frames)
            if len(ahead) == wcfg.f:
                break
        if not ahead:
            break
        kind, ln = plan_windows(enc, len(ahead), wcfg)[0]
        if kind == "window":
            # queue this window BEFORE pulling the previous one: its device
            # work then overlaps the host's pulls and assembly
            handle = encode_window_begin(enc, [ahead.popleft() for _ in range(ln)], wcfg)
            if pend is not None:
                yield from emit_window(pend)
            pend = handle
        else:
            if pend is not None:
                yield from emit_window(pend)
                pend = None
            telemetry.count("serving.window.single_steps")
            outs = enc.encode(ahead.popleft())
            decoded = (None if dec is None else
                       dec.decode([p for p, _ in outs], device_out=device_out))
            yield outs, decoded
    if pend is not None:
        yield from emit_window(pend)


# ---------------------------------------------------------------------------
# Decode window
# ---------------------------------------------------------------------------


def decode_window(dec, payload_lists):
    """Decode F steps of S payloads each through a BatchedDecoder's device
    state, with one upload of the window's host arrays. Returns the frames
    [F, S, H, W, 3] on the device; the stream check is deferred like
    decode(device_out=True)'s, to the next decode() / validate()."""
    step, dec.fn = dec.fn, dec.fn + len(payload_lists)
    with telemetry.span("sptc.serve.window.decode", unit=step):
        return _decode(dec, payload_lists)


def _decode(dec, payload_lists):
    dec.validate()
    if dec.groups is not None:
        outs = []
        for card, (g, sl) in enumerate(dec.groups):
            with telemetry.span("sptc.serve.group", card=card), on_device(g.device):
                outs.append(_decode(g, [list(p[sl]) for p in payload_lists]))
        return torch.cat([o.to(dec.device) for o in outs], dim=1)
    plans, host, counts = [], [], []
    with telemetry.span("sptc.serve.window.parse"):
        for t, payloads in enumerate(payload_lists):
            assert len(payloads) == dec.s
            plan, arrays = dec._parse(payloads,
                                      lambda i, t=t: f"step {t} stream {dec.base + i}",
                                      have_prev=t > 0 or dec.prev is not None)
            plans.append(plan)
            host += arrays
            counts.append(len(arrays))
    with telemetry.span("sptc.serve.window.run"):
        got = iter(upload_all(host, dec.device))
        frames, errs = [], []
        for plan, n in zip(plans, counts):
            fr, err = dec._run(plan, [next(got) for _ in range(n)])
            frames.append(fr)
            errs.append(err)
        dec._pending_err = (torch.stack(errs), np.any([p["p_mask"] for p in plans], axis=0))
        return torch.stack(frames)
