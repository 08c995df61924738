"""Wrappers of the fused section kernels K1 (encode) and K2 (decode),
`csrc/sections.cu`, replacing the Pallas kernels of
`screenpressor_tpu/jx/kernels.py` (`encode_sections_fused`,
`decode_sections_fused`), and of K5, the P analysis's block front end
(change map, sub-rects, flat flags, first-match motion search),
`csrc/motion_search.cu` (the reference's jitted `jx/blocks.py`
`analyze_compact` up to its record compaction, which has no Pallas site;
its plain version is `blocks.analyze_blocks_streams_plain`), and of K6,
the P decode's data-block rebuild, `csrc/block_rebuild.cu` (the
reference's `jx/pframe.py` `reconstruct_blocks`, no Pallas site either;
its plain version is `pframe.reconstruct_blocks_streams_plain`), and of
K7, the session API's RGB32 <-> RGB24 conversion of a batch of frames,
`csrc/pixels.cu` (the reference's `colorspace.rgb32_to_rgb24_device` /
`rgb24_to_rgb32_device`, no Pallas site; its plain versions are
`colorspace.rgb32_to_rgb24_batch` / `rgb24_to_rgb32_batch` on the CPU), and
of K8, the P decode's block resolution, `csrc/resolve.cu` (the reference's
`jx/pframe.py` `decode_p_resolve` after its section scans, no Pallas site;
its plain version is `pframe.decode_p_resolve_streams_plain`).

Same contracts as the stream loops of the plain coder in `coder.py`
(`encode_sections_streams_plain`: `model_scan` + `rans_pack`;
`decode_sections_streams_plain`: `decode_section_scan`), which are their
plain versions. A launch runs one thread block per (section, stream); the sections
of one launch must use disjoint table kinds (a frame's sections do:
ptype/nrun, color, bt/btn, sxy, mvflag/mv), so consecutive sections are
grouped greedily by that rule, and the streams of a launch are distinct.

The wrappers update the [S, ...] tables they are given in place: a
64-stream serving session's color tables alone are 805 MB, and a copy per
launch would double that (a single-stream session passes [1, ...] copies,
`coder.encode_sections`). The per-stream arrays (records, lens, outputs,
stream ids) live in device buffers; the launch parameters hold only their
base pointers.
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu_torch.config import (
    BLOCK,
    COLOR_CTX_BITS_A,
    COLOR_CTX_BITS_B,
    MIX_ESC_C,
    STEP,
    TABLE_KINDS,
    kind_gstep,
    kind_step,
)
from screenpressor_tpu_torch import _build
from screenpressor_tpu_torch.coder import pack_cap
from screenpressor_tpu_torch.substeps import SUBSTEP_CODECS as CODECS
from screenpressor_tpu_torch.transfer import upload

AREA = BLOCK * BLOCK
KIND_ORDER = ("ptype", "nrun", "color", "bt", "btn", "sxy", "mvflag", "mv")
MAX_LANES = 512
MAX_SECTIONS = 8
I32 = torch.int32

assert tuple(TABLE_KINDS) == KIND_ORDER, "csrc/sections.cu kind order"
assert all(kind_step(kd) == STEP and kind_gstep(kd) == STEP for kd in KIND_ORDER)


def _groups(kts):
    """Greedy runs of consecutive sections with pairwise disjoint kinds."""
    groups, cur, used = [], [], set()
    for i, (name, _k, _t) in enumerate(kts):
        kinds = set(CODECS[name].kinds)
        if cur and (kinds & used or len(cur) == MAX_SECTIONS):
            groups.append(cur)
            cur, used = [], set()
        cur.append(i)
        used |= kinds
    groups.append(cur)
    return groups


def _table_desc(tables: dict, kinds, slot_kinds, n_slots: int, n_streams: int) -> list:
    """The table part of the launch descriptor: tables [S, rows, alpha]
    (slot-indexed kinds: [C, rows, alpha]) of the kinds the launch touches."""
    desc = [STEP, STEP, MIX_ESC_C, COLOR_CTX_BITS_A, COLOR_CTX_BITS_B]
    tabs = []
    for kd in KIND_ORDER:
        if kd not in kinds:
            tabs += [0, 0, 0, 0, 0, 0, 0]
            continue
        tab = tables[kd]
        by_slot = kd in slot_kinds
        need = n_slots if by_slot else n_streams
        rows, alpha = tab["cnt"].shape[1:]
        mixed = "gcnt" in tab
        want = {"cnt": (rows, alpha), "cntsum": (rows,), "gcnt": (alpha,), "gsum": ()}
        for key, v in tab.items():
            _build.require_cuda(v)
            if v.dtype != I32 or v.shape[1:] != want[key] or v.shape[0] < need:
                raise ValueError(f"table {kd}.{key}: int32 [{need}, ...] expected, "
                                 f"got {v.dtype} {tuple(v.shape)}")
        tabs += [tab["cnt"].data_ptr(), tab["cntsum"].data_ptr(),
                 tab["gcnt"].data_ptr() if mixed else 0,
                 tab["gsum"].data_ptr() if mixed else 0, rows, alpha, int(by_slot)]
    return desc, tabs


def _check_section(name, k, t, c, arr, lens):
    if not 1 <= k <= MAX_LANES or t < 1:
        raise ValueError(f"section {name}: k={k}, t={t} outside the kernel's range")
    _build.require_cuda(arr, lens)
    if lens.dtype != I32 or lens.shape != (c, k):
        raise ValueError(f"section {name}: lens must be int32 [{c}, {k}]")


def _slots(sidx, dev):
    if len(set(sidx)) != len(sidx) or min(sidx) < 0:
        raise ValueError(f"stream ids must be distinct and >= 0: {sidx}")
    return upload(np.asarray(sidx, np.int32), dev)  # non-blocking: no wait on the queue


def encode_sections_streams_kernel(dealt_list, lens_list, tables_b: dict, kts, sidx,
                                   slot_kinds=(), clocks=None):
    """K1 over C streams: dealt [C, T, K, W] int32 records + lens [C, K] per
    section -> (bufs [C, K, cap] uint8, starts [C, K] int32). Updates the
    tables of streams sidx in `tables_b` [S, ...] in place (slot_kinds:
    kinds whose tables are [C, ...], one per launch slot). clocks: a list
    that receives, per section, an int64 [C, 3] tensor of each block's
    device nanosecond timer at its start, after its forward (modeling)
    phase and at its end (after the rANS pack)."""
    dev = dealt_list[0].device
    c = len(sidx)
    slots = _slots(sidx, dev)
    n_streams = max(sidx) + 1
    bufs, starts = [None] * len(kts), [None] * len(kts)
    for group in _groups(kts):
        kinds = {kd for i in group for kd in CODECS[kts[i][0]].kinds}
        desc, tabs = _table_desc(tables_b, kinds, slot_kinds, c, n_streams)
        secs, keep = [], []  # keep: temporaries alive until the launch is queued
        for i in group:
            name, k, t = kts[i]
            codec = CODECS[name]
            recs = dealt_list[i].to(I32).contiguous()
            _check_section(name, k, t, c, recs, lens_list[i])
            if recs.shape != (c, t, k, codec.rec_width):
                raise ValueError(f"section {name}: records {tuple(recs.shape)}")
            cap = pack_cap(name, t)
            iv = torch.empty((c, k, t * len(codec.kinds)), dtype=I32, device=dev)
            bufs[i] = torch.zeros((c, k, cap), dtype=torch.uint8, device=dev)
            starts[i] = torch.empty((c, k), dtype=I32, device=dev)
            clk = None
            if clocks is not None:
                clk = torch.zeros((c, 3), dtype=torch.int64, device=dev)
                clocks.append(clk)
            secs += [codec.cid, k, t, cap, recs.data_ptr(), lens_list[i].data_ptr(),
                     iv.data_ptr(), bufs[i].data_ptr(), starts[i].data_ptr(), 0,
                     0 if clk is None else clk.data_ptr()]
            keep += [recs, iv]
        d = np.asarray(desc + [slots.data_ptr()] + tabs + secs, np.int64)
        colw = any(kts[i][0].startswith("colw") for i in group)
        _build.launch("sptc_sections_encode", d.ctypes.data, len(group), c, device=dev,
                      counts=("sptc_sections_encode", "sptc_sections_encode_colw")
                      if colw else None)
    return bufs, starts


def decode_sections_streams_kernel(pay_list, lens_list, tables_b: dict, kts, sidx):
    """K2 over C streams: payload [C, K, L] uint8 (L >= 4) + lens [C, K] per
    section -> records [C, T, K, W] int32 per section. Updates the tables of
    streams sidx in `tables_b` [S, ...] in place."""
    dev = pay_list[0].device
    c = len(sidx)
    slots = _slots(sidx, dev)
    n_streams = max(sidx) + 1
    recs = [None] * len(kts)
    for group in _groups(kts):
        kinds = {kd for i in group for kd in CODECS[kts[i][0]].kinds}
        desc, tabs = _table_desc(tables_b, kinds, (), c, n_streams)
        secs, keep = [], []  # keep: temporaries alive until the launch is queued
        for i in group:
            name, k, t = kts[i]
            pay = pay_list[i].contiguous()
            keep.append(pay)
            _check_section(name, k, t, c, pay, lens_list[i])
            if (name.startswith("colw") or pay.dtype != torch.uint8
                    or pay.shape[:2] != (c, k) or pay.shape[2] < 4):
                raise ValueError(f"section {name}: payload {tuple(pay.shape)}")
            recs[i] = torch.empty((c, t, k, CODECS[name].rec_width), dtype=I32,
                                  device=dev)
            secs += [CODECS[name].cid, k, t, pay.shape[2], recs[i].data_ptr(),
                     lens_list[i].data_ptr(), 0, 0, 0, pay.data_ptr(), 0]
        d = np.asarray(desc + [slots.data_ptr()] + tabs + secs, np.int64)
        _build.launch("sptc_sections_decode", d.ctypes.data, len(group), c, device=dev)
    return recs


def analyze_blocks_streams_kernel(frames: torch.Tensor, prevs: torch.Tensor,
                                  cands: torch.Tensor, row0: int, nby: int):
    """K5: the block front end of the P analysis of C streams in one launch,
    with no host sync. frames, prevs [C, H, W, 3] uint8 (read where they
    lie: no packed copy); cands [n_cand, 2] int32 (mx, my) in
    mv_candidates order; block rows [row0, row0 + nby) (rows past the frame
    have no pixel). Returns, nb = nby * nbx: changed [C, nb] bool, rects
    [C, nb, 4] int32 absolute exclusive sub-rects (x1, y1, x2, y2) (an
    unchanged block's (bx + 16, by + 16, bx, by)), choice [C, nb] int32
    (the first matching candidate, n_cand where a block is unchanged or
    nothing matches) and flat [C, nb] bool (every in-frame pixel of the
    block equals the frame's pixel (0, 0))."""
    c, h, w = frames.shape[:3]
    nbx = -(-w // BLOCK)
    n_cand = cands.shape[0]
    frames, prevs = frames.contiguous(), prevs.contiguous()
    cands = cands.to(I32).contiguous()
    _build.require_cuda(frames, prevs, cands)
    if (frames.dtype != torch.uint8 or prevs.dtype != torch.uint8 or frames.dim() != 4
            or frames.shape[3] != 3 or prevs.shape != frames.shape
            or cands.shape != (n_cand, 2) or row0 < 0 or nby < 1):
        raise ValueError(f"block analysis: frames {tuple(frames.shape)} {frames.dtype}, prevs "
                         f"{tuple(prevs.shape)} {prevs.dtype}, cands {tuple(cands.shape)}, "
                         f"rows {row0} + {nby}")
    if 3 * h * w >= 2 ** 31:
        raise ValueError(f"block analysis: a {h}x{w} frame has over 2^31 bytes")
    dev = frames.device
    nb = nby * nbx
    changed = torch.empty((c, nb), dtype=torch.bool, device=dev)
    rects = torch.empty((c, nb, 4), dtype=I32, device=dev)
    choice = torch.empty((c, nb), dtype=I32, device=dev)
    flat = torch.empty((c, nb), dtype=torch.bool, device=dev)
    if c:
        _build.launch("sptc_analyze_blocks", frames.data_ptr(), prevs.data_ptr(),
                      cands.data_ptr(), changed.data_ptr(), rects.data_ptr(), choice.data_ptr(),
                      flat.data_ptr(), c, h, w, row0, nby, n_cand, device=dev)
    return changed, rects, choice, flat


def rebuild_blocks_streams_kernel(out: torch.Tensor, prev: torch.Tensor, rects: torch.Tensor,
                                  bsid: torch.Tensor, ptypes: torch.Tensor, rlens: torch.Tensor,
                                  lits: torch.Tensor) -> torch.Tensor:
    """K6: every data-block slot of a P decode call rebuilt in one launch,
    with no host sync. out [C * h * w + 1, 3] uint8, the motion-applied
    frames, updated in place (its last row, the sink, is not written);
    prev [C, h, w, 3] uint8, the true previous frames; rects [B, 4] int32
    absolute exclusive sub-rects; bsid [B] int64 each slot's stream;
    ptypes, rlens [B, 256] and lits [B, 256, 3] int32, the slots' records.
    Returns out."""
    c, h, w = prev.shape[:3]
    nblk = rects.shape[0]
    prev = prev.contiguous()
    rects, ptypes, rlens, lits = (t.to(I32).contiguous() for t in (rects, ptypes, rlens, lits))
    bsid = bsid.to(torch.int64).contiguous()
    _build.require_cuda(out, prev, rects, bsid, ptypes, rlens, lits)
    if (out.dtype != torch.uint8 or prev.dtype != torch.uint8 or prev.dim() != 4
            or prev.shape[3] != 3 or out.shape != (c * h * w + 1, 3)
            or rects.shape != (nblk, 4) or bsid.shape != (nblk,)
            or ptypes.shape != (nblk, AREA) or rlens.shape != (nblk, AREA)
            or lits.shape != (nblk, AREA, 3)):
        raise ValueError(f"block rebuild: out {tuple(out.shape)} {out.dtype}, prev "
                         f"{tuple(prev.shape)} {prev.dtype}, rects {tuple(rects.shape)}, bsid "
                         f"{tuple(bsid.shape)}, ptypes {tuple(ptypes.shape)}, rlens "
                         f"{tuple(rlens.shape)}, lits {tuple(lits.shape)}")
    if nblk:
        _build.launch("sptc_rebuild_blocks", out.data_ptr(), prev.data_ptr(), rects.data_ptr(),
                      bsid.data_ptr(), ptypes.data_ptr(), rlens.data_ptr(), lits.data_ptr(),
                      nblk, c, h, w, device=out.device)
    return out


RESOLVE_TILE = 4096  # records a thread block of K8's record pass (csrc/resolve.cu TILE)
RESOLVE_SECTIONS = ("bt", "sxy", "mv", "rec", "col")  # csrc/resolve.cu's order


def resolve_blocks_streams_kernel(records: dict, lay, nbx: int, nby: int, h: int, w: int):
    """K8: the block resolution of a P decode call's C streams in one C call
    of three kernels, with no host sync. records: {section: [C, cap, W]
    int32} in record order (bt, sxy, mv, rec, col; W the codec's record
    width); lay: the
    call's pframe.StepLayout (hdr, mcap, bcap, moff, boff, bsid int64 on the
    card; b_max and the slot counts on the host); a frame of h x w pixels,
    nbx x nby blocks. Returns ((mo_rects [M, 4], mo_mvs [M, 2], d_rects
    [B, 4], pt [B, 256], rlg [B, 256], lt [B, 256, 3]), err [C]), int32,
    each written whole: pframe.decode_p_resolve_streams_plain's outputs."""
    recs = [records[name].to(I32).contiguous() for name in RESOLVE_SECTIONS]
    layout = (lay.hdr, lay.mcap, lay.bcap, lay.moff, lay.boff, lay.bsid)
    _build.require_cuda(*recs, *layout)
    c, b_max = lay.hdr.shape[0], lay.b_max
    m, b = lay.msid.shape[0], lay.bsid.shape[0]
    if (c < 1 or b_max < 1 or lay.hdr.shape != (c, 8)
            or any(t.dtype != torch.int64 for t in layout)
            or any(t.shape != (c,) for t in layout[1:5])
            or any(r.dim() != 3 or r.shape[0] != c or r.shape[1] < 1
                   or r.shape[2] != CODECS[name].rec_width
                   for r, name in zip(recs, RESOLVE_SECTIONS))):
        raise ValueError(f"block resolution: records {[tuple(r.shape) for r in recs]}, "
                         f"layout {[(tuple(t.shape), t.dtype) for t in layout]}, b_max {b_max}")
    caps = [r.shape[1] for r in recs]
    cap_bt, cap_rec = caps[0], caps[3]
    n_tiles = -(-cap_rec // RESOLVE_TILE)
    dev = lay.hdr.device
    out = [torch.empty(shape, dtype=I32, device=dev)
           for shape in ((m, 4), (m, 2), (b, 4), (b, AREA), (b, AREA), (b, AREA, 3), (c,))]
    s64 = torch.empty(c * (cap_bt + b_max + 1 + 2 * n_tiles), dtype=torch.int64, device=dev)
    s32 = torch.empty(c * (cap_bt + b_max + 2 * cap_rec), dtype=I32, device=dev)
    bstart, astart, tsum = s64.split([c * cap_bt, c * (b_max + 1), 2 * c * n_tiles])
    nzc, first_rec, jbs, litrow = s32.split([c * cap_bt, c * b_max, c * cap_rec, c * cap_rec])
    scratch = (bstart, nzc, astart, first_rec, tsum, jbs, litrow)
    d = np.asarray([t.data_ptr() for t in (*recs, *layout, *out, *scratch)]
                   + [c, *caps, b_max, n_tiles, nbx, nby, h, w, b], np.int64)
    _build.launch("sptc_resolve_blocks", d.ctypes.data, device=dev)
    return tuple(out[:6]), out[6]


def _frame_pointers(frames, shape, dev) -> torch.Tensor:
    """The frames' base addresses as an int64 tensor on `dev` (uploaded
    without waiting for the queue); every frame uint8, contiguous, `shape`,
    on `dev`."""
    _build.require_cuda(*frames)
    for f in frames:
        if f.dtype != torch.uint8 or tuple(f.shape) != shape or f.device != dev:
            raise ValueError(f"pixel frame {f.dtype} {tuple(f.shape)} on {f.device}: "
                             f"uint8 {shape} on {dev} expected")
    return upload(np.asarray([f.data_ptr() for f in frames], np.int64), dev)


def rgb32_to_rgb24_frames_kernel(batch: torch.Tensor) -> list:
    """K7, alpha dropped: batch [N, H, W, 4] uint8 on the card -> N frames
    [H, W, 3] uint8, each in storage of its own, in one launch with no host
    sync (N up to 65,535, the grid's y; the launch raises beyond)."""
    _build.require_cuda(batch)
    if batch.dtype != torch.uint8 or batch.dim() != 4 or batch.shape[3] != 4:
        raise ValueError(f"RGB32 batch {batch.dtype} {tuple(batch.shape)}: uint8 "
                         f"[N, H, W, 4] expected")
    n, h, w = batch.shape[:3]
    dev = batch.device
    frames = [torch.empty((h, w, 3), dtype=torch.uint8, device=dev) for _ in range(n)]
    if n:
        ptrs = _frame_pointers(frames, (h, w, 3), dev)
        _build.launch("sptc_rgb32_to_rgb24", batch.data_ptr(), ptrs.data_ptr(), h * w, n,
                      device=dev)
    return frames


def rgb24_to_rgb32_frames_kernel(frames) -> torch.Tensor:
    """K7, alpha 255: N frames [H, W, 3] uint8 on one card (a frame may
    appear in several slots) -> [N, H, W, 4] uint8, in one launch with no
    host sync."""
    frames = [f.contiguous() for f in frames]
    h, w = frames[0].shape[:2]
    dev = frames[0].device
    out = torch.empty((len(frames), h, w, 4), dtype=torch.uint8, device=dev)
    ptrs = _frame_pointers(frames, (h, w, 3), dev)
    _build.launch("sptc_rgb24_to_rgb32", ptrs.data_ptr(), out.data_ptr(), h * w, len(frames),
                  device=dev)
    return out
