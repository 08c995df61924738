"""P-frame encode/decode — PyTorch port of `screenpressor_tpu/jx/pframe.py`.

Per-block work (classification, segmentation, reconstruction) runs batched
over a list of data blocks; blocks are independent by format design
(out-of-sub-rect neighbours read the previous frame). On encode the data
blocks of every P stream of a serving step, or every P frame of a batch,
form one ragged list with stream ids (`classify_assemble_streams`; one
frame is its case of one stream). The segmentation of a block's sub-rect
sequence is the same greedy walk as the I-frame's with one 256-position
tile per block, so it runs through kernel K3 (`classify.run_walk`), one
launch over all the blocks. The five sections go through the section coder
(`coder.encode_sections` / `decode_sections`, kernels K1/K2 on the card).
Over all the coded P streams of a step at once, the block resolution is
one call of kernel K8 on the card (three kernels), the motion apply plain
tensor ops (one gather), and the data-block rebuild one launch of kernel K6
(`rebuild_p_streams`; one frame is its case of one stream).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.config import (
    BLOCK,
    BT_FULL_DATA,
    BT_FULL_MOTION,
    BT_PARTIAL_DATA,
    BT_PARTIAL_MOTION,
    NUM_PTYPES,
    PT_ABOVE,
    PT_ABOVELEFT,
    PT_GRADIENT,
    PT_LEFT,
    PT_LITERAL,
    PT_PREVFRAME,
    CodecConfig,
)
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.classify import fits_bits, run_walk
from screenpressor_tpu_torch.container import frame_bytes, p_head, raw_escape, raw_size
from screenpressor_tpu_torch.kernels import (rebuild_blocks_streams_kernel,
                                            resolve_blocks_streams_kernel)
from screenpressor_tpu_torch.tables import renew_tables_cached, select_tables
from screenpressor_tpu_torch.transfer import to_device, upload

AREA = BLOCK * BLOCK
I32 = torch.int32
SECTION_NAMES = ("bt", "sxy", "mv", "rec", "col")


# ---------------------------------------------------------------------------
# Per-block classification (encoder)
# ---------------------------------------------------------------------------


def _block_fits(cw, pw, rects):
    """cw/pw: [B, 17, 17, 3] windows. Returns (fits [B, 256, 6], start
    types [B, 256], cur [B, 256, 3], valid [B, 256]) in sub-rect raster
    order."""
    nblk = cw.shape[0]
    dev = cw.device
    x1, y1 = rects[:, 0].long()[:, None], rects[:, 1].long()[:, None]
    bw = (rects[:, 2] - rects[:, 0]).long()[:, None]
    bh = (rects[:, 3] - rects[:, 1]).long()[:, None]
    p = torch.arange(AREA, device=dev)[None, :]
    ry = p // bw.clamp_min(1)
    rx = p % bw.clamp_min(1)
    valid = p < bw * bh
    ryc = ry.clamp(max=BLOCK - 1)
    b = torch.arange(nblk, device=dev)[:, None]

    def at(win, yy, xx):
        return win[b, yy, xx]

    cur = at(cw, 1 + ryc, 1 + rx)
    c_left, p_left = at(cw, 1 + ryc, rx), at(pw, 1 + ryc, rx)
    c_above, p_above = at(cw, ryc, 1 + rx), at(pw, ryc, 1 + rx)
    c_tl, p_tl = at(cw, ryc, rx), at(pw, ryc, rx)
    prevv = at(pw, 1 + ryc, 1 + rx)
    left = torch.where((rx > 0)[..., None], c_left, p_left)
    above = torch.where((ry > 0)[..., None], c_above, p_above)
    tl = torch.where(((rx > 0) & (ry > 0))[..., None], c_tl, p_tl)
    avail_l = (x1 + rx) > 0
    avail_a = (y1 + ry) > 0
    avail_al = avail_l & avail_a
    # scan-prev: the previous pixel in sub-rect raster order
    sp = torch.where((rx > 0)[..., None], c_left,
                     at(cw, ryc, bw.expand_as(ryc)))

    def eq(a, c):
        return (a == c).all(dim=-1)

    f = torch.zeros((nblk, AREA, NUM_PTYPES), dtype=torch.bool, device=dev)
    f0 = eq(cur, sp)
    f0[:, 0] = False
    f[..., PT_LITERAL] = f0 & valid
    f[..., PT_LEFT] = eq(cur, left) & avail_l & valid
    f[..., PT_ABOVE] = eq(cur, above) & avail_a & valid
    f[..., PT_PREVFRAME] = eq(cur, prevv) & valid
    f[..., PT_GRADIENT] = eq(cur, left + above - tl) & avail_al & valid
    f[..., PT_ABOVELEFT] = eq(cur, tl) & avail_al & valid
    st = torch.full((nblk, AREA), PT_LITERAL, dtype=I32, device=dev)
    for pt in (PT_GRADIENT, PT_ABOVE, PT_ABOVELEFT, PT_PREVFRAME, PT_LEFT):
        st = torch.where(f[..., pt], pt, st)
    return f, st, cur, valid


def _segment_seq(fits, st, n_valid):
    """Greedy segmentation of each block's 256-position sequence (the
    run-walk state machine, one tile per block). Returns (starts [B, 256],
    ptypes, run lengths, n_records [B]); slots past a block's record count
    hold (AREA, 0, 0)."""
    nblk = fits.shape[0]
    dev = fits.device
    is_start = run_walk(fits_bits(fits.reshape(-1, NUM_PTYPES)),
                        st.reshape(-1), AREA).reshape(nblk, AREA)
    pos = torch.arange(AREA, device=dev)[None, :]
    is_start = is_start & (pos < n_valid[:, None])
    rank = torch.cumsum(is_start.to(I32), dim=1) - 1
    n_records = is_start.sum(dim=1, dtype=I32)
    path = torch.full((nblk, AREA + 1), AREA, dtype=torch.int64, device=dev)
    b = torch.arange(nblk, device=dev)[:, None].expand(nblk, AREA)
    path.index_put_((b, torch.where(is_start, rank, AREA).long()),
                    pos.expand(nblk, AREA))
    path = path[:, :AREA]
    is_rec = pos < n_records[:, None]
    nxt = torch.cat([path[:, 1:], path.new_full((nblk, 1), AREA)], dim=1)
    nxt = torch.where(pos + 1 < n_records[:, None], nxt, n_valid[:, None].long())
    pc = path.clamp(max=AREA - 1)
    ptypes = torch.where(is_rec, st.gather(1, pc), 0)
    rlens = torch.where(is_rec, nxt - path, 0).to(I32)
    return path, ptypes, rlens, n_records


# data blocks classified a launch group: bounds the peak memory of the
# windows, fit planes and records (about 40 KB a block); one K3 launch a group
CLASSIFY_CAP = 32768


def classify_blocks_streams(frames: torch.Tensor, prevs: torch.Tensor, rects: torch.Tensor,
                            bsid: torch.Tensor):
    """Blocks of C streams: rects [B, 4] absolute sub-rects of the streams
    bsid [B] of frames / prevs [C, H, W, 3]. Returns per-block record
    arrays (ptypes [B, 256], rlens, n_records [B], lits [B, 256, 3],
    is_lit), with one K3 launch over the B blocks' 256-position tiles."""
    cw = _windows_streams(frames, rects, bsid)
    pw = _windows_streams(prevs, rects, bsid)
    fits, st, cur, _valid = _block_fits(cw, pw, rects)
    n_valid = (rects[:, 2] - rects[:, 0]) * (rects[:, 3] - rects[:, 1])
    path, ptypes, rlens, n_records = _segment_seq(fits, st, n_valid)
    pc = path.clamp(max=AREA - 1)
    lits = cur.gather(1, pc[..., None].expand(-1, -1, 3))
    is_lit = (path < n_valid[:, None]) & (ptypes == PT_LITERAL)
    return ptypes, rlens, n_records, lits, is_lit


def classify_assemble_streams(frames: torch.Tensor, prevs: torch.Tensor,
                              data_rects: torch.Tensor, n_data):
    """Classify the data blocks of C streams and assemble each stream's
    PIX / COL record arrays: the counterpart of the reference's
    `_batched_classify_eager` (without its grow-only bucket) and of a
    session batch's classification.

    frames, prevs [C, H, W, 3]; data_rects [C, nbp, 4] (the analysis'
    output); n_data [C] host ints, stream c's first n_data[c] rects (0 skips
    the stream). The blocks of all streams form one ragged list with stream
    ids, classified in groups of at most CLASSIFY_CAP blocks (one K3 launch
    each). Returns (pix [B * 256, 2], lit [B * 256, 3], counts [C, 3] =
    (n_pix, n_lit, touched color rows), bm [C, 3 * COLOR_CTX_ROWS] the
    touched-row bitmaps, off [C] host ints): stream c's records and
    literals, in record order, start at row off[c] of pix and lit."""
    c = frames.shape[0]
    dev = frames.device
    nbp = data_rects.shape[1]
    nd = np.asarray(n_data, np.int64).reshape(c)
    boff = np.cumsum(nd) - nd
    n_blk = int(nd.sum())
    blk = np.repeat(np.arange(c) * nbp - boff, nd) + np.arange(n_blk)
    meta = upload(np.concatenate([blk, boff]), dev)
    blk_d, boff_d = meta.split([n_blk, c])
    bsid = blk_d // nbp
    rects = data_rects.reshape(-1, 4)[blk_d]
    pcap = n_blk * AREA
    pix = torch.zeros((pcap + 1, 2), dtype=I32, device=dev)
    lit = torch.zeros((pcap + 1, 3), dtype=I32, device=dev)
    nrec = torch.zeros(n_blk, dtype=torch.int64, device=dev)
    nlit = torch.zeros(n_blk, dtype=torch.int64, device=dev)
    slot = torch.arange(AREA, device=dev)[None, :]
    for lo in range(0, n_blk, CLASSIFY_CAP):
        hi = min(n_blk, lo + CLASSIFY_CAP)
        sid = bsid[lo:hi]
        ptypes, rlens, n_recs, lits, is_lit = classify_blocks_streams(
            frames, prevs, rects[lo:hi], sid)
        valid_slot = slot < n_recs[:, None]
        is_lit = is_lit & valid_slot
        nrec[lo:hi] = n_recs
        nlit[lo:hi] = is_lit.sum(dim=1)
        first = boff_d[sid]  # the first block of each block's stream

        def offsets(cnt):
            """Each block's first row: its stream's first row plus the
            counts of the stream's blocks before it."""
            ex = torch.cumsum(cnt[:hi], dim=0) - cnt[:hi]
            return first * AREA + ex[lo:hi] - ex[first]

        tgt = torch.where(valid_slot, offsets(nrec)[:, None] + slot, pcap)
        pix.index_put_((tgt,), torch.stack([ptypes, rlens], dim=-1).to(I32))
        lit_rank = torch.cumsum(is_lit.to(I32), dim=1) - 1
        tgt_l = torch.where(is_lit, offsets(nlit)[:, None] + lit_rank, pcap)
        lit.index_put_((tgt_l,), lits.to(I32))
    n_pix = torch.zeros(c, dtype=torch.int64, device=dev).index_add_(0, bsid, nrec)
    n_lit = torch.zeros(c, dtype=torch.int64, device=dev).index_add_(0, bsid, nlit)
    row_sid = bsid[:, None].expand(n_blk, AREA).reshape(-1)
    bm = tc.color_touched_bitmap_streams(lit[:pcap], row_sid, boff_d * AREA, n_lit)
    counts = torch.stack([n_pix, n_lit, bm.sum(dim=1)], dim=1).to(I32)
    return pix[:pcap], lit[:pcap], counts, bm, boff * AREA


def classify_assemble_fixed(frames: torch.Tensor, prevs: torch.Tensor,
                            data_rects: torch.Tensor, n_data: torch.Tensor, bcap: int):
    """classify_assemble_streams at a fixed block capacity, with no host
    copy: stream c's first n_data[c] rects (n_data a device tensor, at most
    bcap), each stream bcap block slots, the slots past its count empty
    rects (no records). Returns (pix [C, bcap * 256, 2], lit [C, bcap *
    256, 3], counts [C, 2] = (n_pix, n_lit)), each stream's records and
    literals in record order."""
    c = frames.shape[0]
    dev = frames.device
    take = torch.arange(bcap, device=dev)[None, :] < n_data[:, None]
    rects = torch.where(take[..., None], data_rects[:, :bcap], 0).reshape(-1, 4)
    bsid = torch.arange(c, device=dev).repeat_interleave(bcap)
    n_blk = c * bcap
    nrec = torch.zeros(n_blk, dtype=torch.int64, device=dev)
    nlit = torch.zeros(n_blk, dtype=torch.int64, device=dev)
    parts = []
    for lo in range(0, n_blk, CLASSIFY_CAP):
        hi = min(n_blk, lo + CLASSIFY_CAP)
        ptypes, rlens, n_recs, lits, is_lit = classify_blocks_streams(
            frames, prevs, rects[lo:hi], bsid[lo:hi])
        is_lit = is_lit & (torch.arange(AREA, device=dev)[None, :] < n_recs[:, None])
        nrec[lo:hi] = n_recs
        nlit[lo:hi] = is_lit.sum(dim=1)
        parts.append((lo, hi, ptypes, rlens, lits, is_lit))
    pcap = bcap * AREA
    pix = torch.zeros((c * pcap + 1, 2), dtype=I32, device=dev)
    lit = torch.zeros((c * pcap + 1, 3), dtype=I32, device=dev)
    # each block's first row: its stream's first row plus the counts of the
    # stream's blocks before it
    first_rec = (bsid * pcap + nrec.view(c, bcap).cumsum(dim=1).view(-1) - nrec)
    first_lit = (bsid * pcap + nlit.view(c, bcap).cumsum(dim=1).view(-1) - nlit)
    slot = torch.arange(AREA, device=dev)[None, :]
    for lo, hi, ptypes, rlens, lits, is_lit in parts:
        tgt = torch.where(slot < nrec[lo:hi, None], first_rec[lo:hi, None] + slot, c * pcap)
        pix.index_put_((tgt,), torch.stack([ptypes, rlens], dim=-1).to(I32))
        rank = torch.cumsum(is_lit.to(I32), dim=1) - 1
        tgt_l = torch.where(is_lit, first_lit[lo:hi, None] + rank, c * pcap)
        lit.index_put_((tgt_l,), lits.to(I32))
    counts = torch.stack([nrec.view(c, bcap).sum(dim=1), nlit.view(c, bcap).sum(dim=1)],
                         dim=1).to(I32)
    return pix[:c * pcap].view(c, pcap, 2), lit[:c * pcap].view(c, pcap, 3), counts


def classify_assemble(frame: torch.Tensor, prev: torch.Tensor,
                      rects: torch.Tensor, n_data: int):
    """Classify the n_data data blocks of one frame and assemble the global
    PIX/COL record arrays (classify_assemble_streams of one stream).
    Returns (pix_cap [n_data*256, 2], lit_cap [n_data*256, 3], counts [2]
    = n_pix, n_lit)."""
    pix, lit, counts, _bm, _off = classify_assemble_streams(
        frame[None], prev[None], rects[None], [n_data])
    return pix, lit, counts[0, :2]


# ---------------------------------------------------------------------------
# Section encode (encoder)
# ---------------------------------------------------------------------------


def encode_sections_raw(sources: dict, hdr_vals, tables: dict, cfg: CodecConfig,
                        raw_threshold: int, col_w=None, col_bm=None):
    """Encode the five sections (col as colw when col_w is set) + exact
    container size + raw-escape table select on the device.

    sources: name -> capacity record arrays; hdr_vals: the 8 host header
    values (xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data). Returns
    (kts, bufs, starts, lens, stats [2] = total, is_raw, tables')."""
    nums = dict(zip(SECTION_NAMES, hdr_vals[2:7]))
    dealt, lens_l, kts = [], [], []
    for name in SECTION_NAMES:
        n = nums[name]
        k = cfg.lanes(n)
        t = tc.steps_for(n, k)
        src = sources[name]
        dealt.append(tc.deal(src, n, k, t))
        lens_l.append(tc.lane_lens(n, k, src.device))
        kts.append((name, k, t))
    kts = tuple(kts)
    bufs, starts, tables2 = tc.encode_sections(dealt, lens_l, tables, kts, col_w, col_bm)
    total = frame_bytes(p_head([int(v) for v in hdr_vals]), bufs, starts, lens_l)
    is_raw = raw_escape(total, raw_threshold)
    sel = select_tables(is_raw, renew_tables_cached(bufs[0].device), tables2)
    stats = torch.stack([total, is_raw.to(I32)])
    return kts, bufs, starts, lens_l, stats, sel


def encode_p_sections(arrs: dict, counts_host, phase_b, pl_counts_host,
                      tables: dict, cfg: CodecConfig):
    """Phase C of a changed P frame. phase_b: (pix_cap, lit_cap, counts,
    touched-row bitmap) of its data blocks, or None; pl_counts_host: their
    pulled counts (n_pix, n_lit, touched color rows). Returns (handle,
    tables') where handle = (kts, nums, (xx1, xx2, n_data), bufs, starts,
    lens, stats)."""
    _any, xx1, xx2, n_bt, n_sxy, n_mv, n_data = (int(v) for v in counts_host[:7])
    dev = arrs["bt"].device
    col_w = col_bm = None
    if phase_b is not None:
        pix_cap, lit_cap, _counts, col_bm = phase_b
        n_pix, n_lit, n_touch = (int(v) for v in pl_counts_host[:3])
        col_w = tc.col_compact_bucket(n_touch)
    else:
        pix_cap = torch.zeros((1, 2), dtype=I32, device=dev)
        lit_cap = torch.zeros((1, 3), dtype=I32, device=dev)
        n_pix = n_lit = 0
    sources = {"bt": arrs["bt"], "sxy": arrs["sxy"], "mv": arrs["mv"],
               "rec": pix_cap, "col": lit_cap}
    hdr_vals = [xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data]
    kts, bufs, starts, lens_l, stats, tables = encode_sections_raw(
        sources, hdr_vals, tables, cfg, raw_size(cfg), col_w, col_bm)
    nums = dict(zip(SECTION_NAMES, hdr_vals[2:7]))
    handle = (kts, nums, (xx1, xx2, n_data), bufs, starts, lens_l, stats)
    return handle, tables


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def read_p_container(data: bytes, pos: int, cfg: CodecConfig):
    """Host-side container parse + validation, the payload bytes left where
    they lie. Returns None for a no-change frame, else (lanes, ns, kts,
    (xx1, xx2, n_mv, n_data)), lanes holding each section's
    bitstream.read_section (sizes, first, end) in SECTION_NAMES order."""
    if pos >= len(data):
        raise bs.CorruptStreamError("truncated P-frame")
    flags = data[pos]
    pos += 1
    if not flags & 1:
        return None
    (xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data), pos = bs.read_varint(
        data, pos, 8)
    nb = cfg.nbx * cfg.nby
    if not xx1 <= xx2 < nb:
        raise bs.CorruptStreamError("xx block range out of bounds")
    if max(n_bt, n_sxy, n_mv, n_data) > nb or n_pix > nb * AREA or n_lit > n_pix:
        raise bs.CorruptStreamError("section counts out of bounds")
    if n_bt == 0:
        raise bs.CorruptStreamError("empty block-type section")
    ns = {"bt": n_bt, "sxy": n_sxy, "mv": n_mv, "rec": n_pix, "col": n_lit}
    kts, lanes = [], []
    for name in SECTION_NAMES:
        k = cfg.lanes(ns[name])
        lanes.append(bs.read_section(data, pos, k))
        pos = lanes[-1][2]
        kts.append((name, k, tc.steps_for(ns[name], k)))
    return lanes, ns, tuple(kts), (xx1, xx2, n_mv, n_data)


def parse_p_header(data: bytes, pos: int, cfg: CodecConfig):
    """read_p_container with each section's lanes as a [K, L] uint8 array.
    Returns None for a no-change frame, else (payloads {name: [K, L]
    uint8}, ns, kts, (xx1, xx2, n_mv, n_data))."""
    got = read_p_container(data, pos, cfg)
    if got is None:
        return None
    lanes, ns, kts, rest = got
    view = memoryview(data)
    payloads = {name: tc.pad_lanes(view[first:end], sizes)
                for name, (sizes, first, end) in zip(SECTION_NAMES, lanes)}
    return payloads, ns, kts, rest


def decode_p_sections(payloads: dict, ns: dict, kts, tables: dict):
    """The five section decodes of one P frame -> (records {name: [n, W]}
    in record order, tables')."""
    dev = payloads["bt"].device
    lens_l = [tc.lane_lens(ns[name], k, dev) for name, k, _ in kts]
    recs_l, tables = tc.decode_sections(
        [payloads[name] for name, _, _ in kts], lens_l, tables, kts)
    return undeal_sections(recs_l, ns, kts), tables


def undeal_sections(recs_l, ns: dict, kts) -> dict:
    return {name: tc.undeal(r, ns[name], k, max(ns[name], 1))
            for (name, k, _), r in zip(kts, recs_l)}


# ---------------------------------------------------------------------------
# Block resolution, motion apply and block rebuild over a step's P streams
# ---------------------------------------------------------------------------
#
# The coded P streams s = 0..C-1 of a step go through one resolve, one
# motion apply and one block rebuild; one stream is the case C = 1.
# Per-stream arrays carry a leading stream axis. Motion and data blocks lie
# on ragged axes (each stream's own slots, stream after stream, each slot
# with its stream id), so one fully changed stream does not pad the others.
# Stream s owns max(n_mv, 1) motion and max(n_data, 1) data-block slots, and
# every index the resolve clamps is clamped to the stream's own range, so a
# stream's pixels and error word do not depend on the other streams of its
# step. Pixels are flattened with the offset s * h * w; whatever lies
# outside a stream's own frame goes to the sink row C * h * w.

HEADER_COLS = SECTION_NAMES + ("xx1", "xx2", "n_data")
_ABOVE_ALL = 1 << 62  # a search key past every area prefix sum


class StepLayout(NamedTuple):
    """The header values of a step's coded P streams on the device and the
    ragged slot axes they imply."""

    hdr: torch.Tensor    # [C, 8] int64, the columns HEADER_COLS
    mcap: torch.Tensor   # [C] motion slots of each stream: max(n_mv, 1)
    bcap: torch.Tensor   # [C] data-block slots: max(n_data, 1)
    moff: torch.Tensor   # [C] each stream's first motion slot
    boff: torch.Tensor   # [C] each stream's first data-block slot
    msid: torch.Tensor   # [M] the stream of each motion slot
    bsid: torch.Tensor   # [B] the stream of each data-block slot
    caps: tuple          # per section: the step's largest count, at least 1
    b_max: int           # the largest bcap


def header_row(ns: dict, xx1: int, xx2: int, n_data: int) -> list:
    """One stream's parsed P header as a row of HEADER_COLS."""
    return [ns[name] for name in SECTION_NAMES] + [xx1, xx2, n_data]


def step_layout_host(rows):
    """The host half of step_layout: (the int64 array its tensors come
    from, the rest of the layout for step_layout_from)."""
    hdr = np.asarray(rows, np.int64).reshape(-1, len(HEADER_COLS))
    c = hdr.shape[0]
    mcap = np.maximum(hdr[:, SECTION_NAMES.index("mv")], 1)
    bcap = np.maximum(hdr[:, HEADER_COLS.index("n_data")], 1)
    sid = np.arange(c)
    host = np.concatenate([hdr.reshape(-1), mcap, bcap, np.cumsum(mcap) - mcap,
                           np.cumsum(bcap) - bcap, np.repeat(sid, mcap),
                           np.repeat(sid, bcap)])
    split = [hdr.size, c, c, c, c, int(mcap.sum()), int(bcap.sum())]
    caps = tuple(int(max(hdr[:, j].max(), 1)) for j in range(len(SECTION_NAMES)))
    return host, (c, split, caps, int(bcap.max()))


def step_layout_from(dev: torch.Tensor, rest) -> StepLayout:
    """StepLayout from step_layout_host's array on the device."""
    c, split, caps, b_max = rest
    parts = dev.split(split)
    return StepLayout(parts[0].view(c, -1), *parts[1:], caps, b_max)


def step_layout(rows, device) -> StepLayout:
    """rows: C header rows (header_row) -> StepLayout, in one upload."""
    host, rest = step_layout_host(rows)
    return step_layout_from(to_device(host, device, "pframe.step_layout"), rest)


def undeal_sections_streams(recs_l, lay: StepLayout, kts) -> dict:
    """The stream-batched K2 outputs ([C, t, k, W] a section) -> {name:
    [C, cap, W]} in record order; the rows past a stream's count are zero."""
    return {name: tc.undeal_streams(r, lay.hdr[:, j], k, cap)
            for j, ((name, k, _), r, cap) in enumerate(zip(kts, recs_l, lay.caps))}


def _to_slots(mask, idx, vals, cap, off, total):
    """vals [C, N, ...] where mask -> slots off + idx of a [total, ...]
    axis. A corrupt bt section can hold more blocks than the header's count
    (bit 4 or 8 is set): those past the stream's own cap [C, 1] go to the
    sink slot."""
    out = torch.zeros((total + 1,) + vals.shape[2:], dtype=I32, device=vals.device)
    out.index_put_((torch.where(mask & (idx < cap), off + idx, total),), vals.to(I32))
    return out[:total]


def _own_rows(rows, idx, n):
    """rows [C, cap, W] at idx [C, N] clamped to each stream's own rows
    (max(n, 1) of them; n [C, 1])."""
    sid = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return rows[sid, torch.minimum(idx.long().clamp_min(0), n.clamp_min(1) - 1)]


def decode_p_resolve_streams(recs: dict, lay: StepLayout, cfg: CodecConfig):
    """BT-run expansion + per-block rect / record resolution of each
    stream's decoded section records ({name: [C, cap, W]}). Returns
    ((mo_rects [M, 4], mo_mvs [M, 2], d_rects [B, 4], pt [B, 256],
    rlg [B, 256], lt [B, 256, 3]), err [C]): stream-consistency violations
    set bits of a stream's error word (device int32) instead of raising.
    K8 on CUDA tensors (one C call of three kernels, no host sync; raises
    if the launch fails), the plain version on CPU tensors."""
    if not lay.hdr.is_cuda:
        return decode_p_resolve_streams_plain(recs, lay, cfg)
    return resolve_blocks_streams_kernel(recs, lay, cfg.nbx, cfg.nby, cfg.height, cfg.width)


def decode_p_resolve_streams_plain(recs: dict, lay: StepLayout, cfg: CodecConfig):
    """The plain version of K8 (decode_p_resolve_streams' contract): a chain
    of tensor ops over all the streams at once (cumsums, index_put_,
    searchsorted, gathers)."""
    h, w, nbx, nby = cfg.height, cfg.width, cfg.nbx, cfg.nby
    hdr = lay.hdr
    c = hdr.shape[0]
    dev = hdr.device
    hv = {name: hdr[:, j, None] for j, name in enumerate(HEADER_COLS)}  # [C, 1]
    bt, sxy, mv = recs["bt"], recs["sxy"], recs["mv"]
    pix, lit = recs["rec"], recs["col"]
    nb = nbx * nby
    sid = torch.arange(c, device=dev)[:, None]
    err = torch.zeros(c, dtype=I32, device=dev)

    def flag(cond, bit):
        return err | torch.where(cond, bit, 0).to(I32)

    # --- expand BT runs over xx1..xx2 (relative scatter + cumsum) ---
    lenr = hv["xx2"] - hv["xx1"] + 1
    nvals = bt[..., 1].long()
    bstarts = torch.cumsum(nvals, dim=1) - nvals
    marks = torch.zeros((c, nb + 1), dtype=I32, device=dev)
    marks.index_put_((sid.expand_as(nvals),
                      torch.where((nvals > 0) & (bstarts < nb), bstarts, nb)),
                     torch.ones_like(nvals, dtype=I32), accumulate=True)
    ridx = torch.cumsum(marks[:, :nb], dim=1) - 1
    relpos = torch.arange(nb, device=dev)[None, :]
    inr = (relpos < lenr) & (ridx >= 0)
    bts_rel = torch.where(inr, _own_rows(bt, ridx, hv["bt"])[..., 0], 0)
    err = flag(nvals.sum(dim=1) != lenr[:, 0], 1)
    rel_of_abs = relpos - hv["xx1"]
    bts = torch.where((rel_of_abs >= 0) & (rel_of_abs < lenr),
                      bts_rel.gather(1, rel_of_abs.clamp(0, nb - 1)), 0)

    # --- per-block resolution ---
    is_partial = (bts == BT_PARTIAL_DATA) | (bts == BT_PARTIAL_MOTION)
    is_motion = (bts == BT_FULL_MOTION) | (bts == BT_PARTIAL_MOTION)
    is_data = (bts == BT_FULL_DATA) | (bts == BT_PARTIAL_DATA)
    err = flag(is_partial.sum(dim=1) != hv["sxy"][:, 0], 2)
    err = flag(is_motion.sum(dim=1) != hv["mv"][:, 0], 4)
    err = flag(is_data.sum(dim=1) != hv["n_data"][:, 0], 8)

    x_lo, y_lo = (relpos % nbx) * BLOCK, (relpos // nbx) * BLOCK
    x_hi, y_hi = (x_lo + BLOCK).clamp(max=w), (y_lo + BLOCK).clamp(max=h)
    pidx = torch.cumsum(is_partial.to(I32), dim=1) - 1
    s = _own_rows(sxy, pidx, hv["sxy"]).long()
    x1 = torch.where(is_partial, x_lo + s[..., 0], x_lo)
    y1 = torch.where(is_partial, y_lo + s[..., 1], y_lo)
    x2 = torch.where(is_partial, x_lo + s[..., 2] + 1, x_hi)
    y2 = torch.where(is_partial, y_lo + s[..., 3] + 1, y_hi)
    rect_ok = (x1 < x2) & (x2 <= x_hi) & (y1 < y2) & (y2 <= y_hi)
    err = flag((is_partial & ~rect_ok).any(dim=1), 16)

    midx = torch.cumsum(is_motion.to(I32), dim=1) - 1
    m = _own_rows(mv, midx, hv["mv"]).long()
    mv_ok = ((x1 + m[..., 0] >= 0) & (y1 + m[..., 1] >= 0)
             & (x2 + m[..., 0] <= w) & (y2 + m[..., 1] <= h))
    err = flag((is_motion & ~mv_ok).any(dim=1), 32)

    rects_all = torch.stack([x1, y1, x2, y2], dim=-1).to(I32)
    m_slots = (lay.mcap[:, None], lay.moff[:, None], lay.msid.shape[0])
    mo_rects = _to_slots(is_motion, midx, rects_all, *m_slots)
    mo_mvs = _to_slots(is_motion, midx, m, *m_slots)
    didx = torch.cumsum(is_data.to(I32), dim=1) - 1
    n_blk = lay.bsid.shape[0]
    d_rects = _to_slots(is_data, didx, rects_all, lay.bcap[:, None], lay.boff[:, None], n_blk)
    # areas on a [C, b_max] axis for the searches; a stream's slots past
    # its own are never found
    b_max = lay.b_max
    areas_nb = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    areas = _to_slots(is_data, didx, areas_nb[..., None], lay.bcap[:, None], sid * b_max,
                      c * b_max).view(c, b_max).long()
    a_start = torch.cumsum(areas, dim=1) - areas
    a_end = a_start + areas
    total_area = areas.sum(dim=1, keepdim=True)
    own_b = lay.bcap[:, None] - 1
    a_key = torch.where(torch.arange(b_max, device=dev)[None, :] <= own_b, a_start,
                        _ABOVE_ALL)

    # --- record -> block assignment (searchsorted over area prefix sums) ---
    rec_i = torch.arange(pix.shape[1], device=dev)[None, :]
    valid_rec = rec_i < hv["rec"]
    rl = torch.where(valid_rec, pix[..., 1], 0).long()
    rstart = torch.cumsum(rl, dim=1) - rl
    rl_total = rl.sum(dim=1, keepdim=True)
    err = flag(rl_total[:, 0] != total_area[:, 0], 64)
    j = torch.searchsorted(a_key, rstart, right=True) - 1
    jb = torch.minimum(j.clamp_min(0), own_b)
    err = flag((valid_rec & (rstart + rl > a_end.gather(1, jb))).any(dim=1), 128)
    # invalid records sort after every valid one and every own block start
    rstart_s = torch.where(valid_rec, rstart,
                           torch.maximum(total_area, rl_total) + 1 + rec_i)
    first_rec = torch.searchsorted(rstart_s, a_start, right=False)
    slot = rec_i - first_rec.gather(1, jb)
    slot_ok = (slot >= 0) & (slot < AREA)
    err = flag((valid_rec & ~slot_ok).any(dim=1), 256)
    keep = valid_rec & slot_ok
    tgt_j = torch.where(keep, lay.boff[:, None] + jb, n_blk)
    tgt_s = torch.where(keep, slot, 0)

    def to_grid(vals):
        out = torch.zeros((n_blk + 1, AREA) + vals.shape[2:], dtype=I32, device=dev)
        out.index_put_((tgt_j, tgt_s), vals.to(I32))
        return out[:n_blk]

    pt = to_grid(pix[..., 0])
    rlg = to_grid(rl)
    is_lit_rec = valid_rec & (pix[..., 0] == PT_LITERAL)
    err = flag(is_lit_rec.sum(dim=1) > hv["col"][:, 0], 512)
    lit_idx = torch.cumsum(is_lit_rec.to(I32), dim=1) - 1
    litv = _own_rows(lit, lit_idx, hv["col"])
    lt = to_grid(torch.where(is_lit_rec[..., None], litv, 0))
    return (mo_rects, mo_mvs, d_rects, pt, rlg, lt), err


def _pixel_index(sid, ys, xs, inside, c, h, w):
    """Flat pixel index of (stream, y, x), the sink C * h * w where not
    inside the stream's own frame."""
    inside = inside & (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return torch.where(inside, sid.long() * (h * w) + ys * w + xs, c * h * w)


def apply_motion_streams(prev: torch.Tensor, rects: torch.Tensor, mvs: torch.Tensor,
                         msid: torch.Tensor) -> torch.Tensor:
    """prev [C, h, w, 3] -> [C * h * w + 1, 3] (the last row the sink): a
    copy of prev with each motion slot's sub-rect copied from its own
    stream's prev shifted by its MV (one gather + one scatter). Empty slots
    have x2 <= x1."""
    c, h, w, _ = prev.shape
    flat = prev.reshape(c * h * w, 3)
    out = torch.cat([flat, flat.new_zeros((1, 3))])
    ar = torch.arange(BLOCK, device=prev.device)
    x1, y1, x2, y2 = (rects[:, i].long()[:, None, None] for i in range(4))
    ys = y1 + ar[None, :, None]
    xs = x1 + ar[None, None, :]
    base = msid.long()[:, None, None] * (h * w)
    src = base + ((ys + mvs[:, 1].long()[:, None, None]) * w
                  + xs + mvs[:, 0].long()[:, None, None]).clamp(0, h * w - 1)
    dst = _pixel_index(msid[:, None, None], ys, xs, (ys < y2) & (xs < x2), c, h, w)
    out[dst.reshape(-1)] = flat[src.reshape(-1)]
    return out


def _windows_streams(prev: torch.Tensor, rects: torch.Tensor,
                     bsid: torch.Tensor) -> torch.Tensor:
    """[B, 17, 17, 3] int32 windows of each block's own stream's frame of
    prev [C, h, w, 3] (the previous frames on decode; the current or the
    previous frames on encode) with origin (y1 - 1, x1 - 1), zero outside
    the frame: a window of the frame with a 1-pixel zero apron top / left
    and BLOCK + 1 bottom / right. A corrupt stream's rect (its error bit
    set) reads clamped to that apron."""
    c, h, w, _ = prev.shape
    ar = torch.arange(BLOCK + 1, device=rects.device)
    ys = (rects[:, 1].long()[:, None] + ar).clamp(0, h + BLOCK + 1) - 1
    xs = (rects[:, 0].long()[:, None] + ar).clamp(0, w + BLOCK + 1) - 1
    idx = _pixel_index(bsid[:, None, None], ys[:, :, None], xs[:, None, :], True, c, h, w)
    inside = idx < c * h * w
    vals = prev.reshape(c * h * w, 3)[idx.clamp(max=c * h * w - 1)]
    return torch.where(inside[..., None], vals.to(I32), 0)


def _row_affine(known, reset, d):
    """Resolve v[x] = (reset ? known : v[x-1] + d) along dim 1 of [B, X, 3]
    with v[-1] = 0."""
    xs = torch.arange(reset.shape[1], device=reset.device)
    last, _ = torch.cummax(torch.where(reset, xs, -1), dim=1)
    # scan along the innermost dimension ([B, 3, X]): PyTorch's CUDA scan
    # over a middle dimension of a small tensor is far slower
    dm = torch.where(reset[..., None], 0, d).transpose(1, 2).contiguous()
    cs = torch.cumsum(dm, dim=2, dtype=I32).transpose(1, 2)
    lc = last.clamp_min(0)[..., None].expand_as(cs)
    base = torch.where((last >= 0)[..., None], known.gather(1, lc) - cs.gather(1, lc), 0)
    return base + cs


def reconstruct_blocks_streams(out: torch.Tensor, prev: torch.Tensor, rects: torch.Tensor,
                               bsid: torch.Tensor, ptypes: torch.Tensor,
                               rlens: torch.Tensor, lits: torch.Tensor) -> torch.Tensor:
    """Rebuild the data-block slots (rects [B, 4] of the streams bsid [B])
    into out [C * h * w + 1, 3], the motion-applied frames, in place.
    Out-of-sub-rect neighbour reads (left edge, above row at ry = 0,
    aboveleft column, PT_PREVFRAME) come from `prev` [C, h, w, 3], the
    true previous frames. Empty slots (x2 <= x1) write nothing; the sink
    row is garbage. K6 on CUDA tensors (one launch, no host sync; raises if
    the launch fails), the plain version on CPU tensors."""
    if not out.is_cuda:
        return reconstruct_blocks_streams_plain(out, prev, rects, bsid, ptypes, rlens, lits)
    return rebuild_blocks_streams_kernel(out, prev, rects, bsid, ptypes, rlens, lits)


def reconstruct_blocks_streams_plain(out: torch.Tensor, prev: torch.Tensor,
                                     rects: torch.Tensor, bsid: torch.Tensor,
                                     ptypes: torch.Tensor, rlens: torch.Tensor,
                                     lits: torch.Tensor) -> torch.Tensor:
    """The plain version of K6 (reconstruct_blocks_streams' contract): the
    records expanded to the sequence positions and laid out on a 16 x 16
    grid, then the 16 rows in a Python loop, each row a chain of masked
    selects and an affine scan (_row_affine) over every slot at once."""
    c, h, w, _ = prev.shape
    nblk = rects.shape[0]
    dev = prev.device
    pw = _windows_streams(prev, rects, bsid)  # [B, 17, 17, 3]
    # per-sequence-position (ptype, literal) from the block's records
    starts = torch.cumsum(rlens, dim=1) - rlens
    marks = torch.zeros((nblk, AREA + 1), dtype=I32, device=dev)
    b = torch.arange(nblk, device=dev)[:, None].expand(nblk, AREA)
    marks.index_put_((b, torch.where((rlens > 0) & (starts < AREA), starts, AREA).long()),
                     torch.ones_like(rlens), accumulate=True)
    rec_id = (torch.cumsum(marks[:, :AREA], dim=1) - 1).clamp(0, AREA - 1).long()
    pt_seq = ptypes.gather(1, rec_id)
    lit_seq = lits.gather(1, rec_id[..., None].expand(-1, -1, 3))
    # a corrupt sub-rect (bit 16 set) can be wider than a block or negative
    bw = (rects[:, 2] - rects[:, 0]).long()[:, None].clamp(0, BLOCK)
    bh = (rects[:, 3] - rects[:, 1]).long()[:, None].clamp(0, BLOCK)
    p = torch.arange(AREA, device=dev)[None, :]
    ry = torch.where(p < bw * bh, p // bw.clamp_min(1), BLOCK)
    rx = p % bw.clamp_min(1)
    pt_grid = torch.zeros((nblk, BLOCK + 1, BLOCK), dtype=I32, device=dev)
    pt_grid[b, ry, rx] = pt_seq.to(I32)
    lit_grid = torch.zeros((nblk, BLOCK + 1, BLOCK, 3), dtype=I32, device=dev)
    lit_grid[b, ry, rx] = lit_seq.to(I32)

    rxs = torch.arange(BLOCK, device=dev)[None, :]
    prev_row = torch.zeros((nblk, BLOCK, 3), dtype=I32, device=dev)
    rows = []
    for r in range(BLOCK):
        pt, lit = pt_grid[:, r], lit_grid[:, r]
        above = pw[:, 0, 1:] if r == 0 else prev_row
        if r == 0:
            tl = pw[:, 0, :BLOCK]
        else:
            tl_cur = torch.cat([prev_row[:, :1], prev_row[:, :-1]], dim=1)
            tl = torch.where((rxs == 0)[..., None], pw[:, r, :BLOCK], tl_cur)
        prow = pw[:, r + 1, 1:]
        left_edge = pw[:, r + 1, 0][:, None, :]
        reset = ((pt == PT_LITERAL) | (pt == PT_ABOVE) | (pt == PT_PREVFRAME)
                 | (pt == PT_ABOVELEFT))
        known = torch.where((pt == PT_ABOVE)[..., None], above,
                            torch.where((pt == PT_PREVFRAME)[..., None], prow,
                                        torch.where((pt == PT_ABOVELEFT)[..., None],
                                                    tl, lit)))
        d = torch.where((pt == PT_GRADIENT)[..., None], above - tl, 0)
        at0_left = (rxs == 0) & (pt == PT_LEFT)
        at0_grad = (rxs == 0) & (pt == PT_GRADIENT)
        known = torch.where(at0_left[..., None], left_edge, known)
        known = torch.where(at0_grad[..., None], left_edge + above - tl, known)
        reset = reset | at0_left | at0_grad
        prev_row = _row_affine(known, reset, d)
        rows.append(prev_row)
    grids = torch.stack(rows, dim=1)  # [B, 16, 16, 3]

    ry2 = torch.arange(BLOCK, device=dev)[None, :, None]
    rx2 = torch.arange(BLOCK, device=dev)[None, None, :]
    ys = rects[:, 1].long()[:, None, None] + ry2
    xs = rects[:, 0].long()[:, None, None] + rx2
    inside = (ry2 < bh[:, :, None]) & (rx2 < bw[:, :, None])
    flat_idx = _pixel_index(bsid[:, None, None], ys, xs, inside, c, h, w)
    out[flat_idx.reshape(-1)] = (grids.reshape(-1, 3) & 0xFF).to(out.dtype)
    return out


def rebuild_p_streams(recs: dict, lay: StepLayout, prev: torch.Tensor, cfg: CodecConfig):
    """Block resolution, motion apply and data-block rebuild of a step's
    coded P streams from their decoded section records ({name: [C, cap,
    W]}) against their previous frames prev [C, h, w, 3] -> (frames
    [C, h, w, 3] uint8, err [C] int32)."""
    c, h, w, _ = prev.shape
    with telemetry.span("sptc.pframe.resolve"):
        parts, err = decode_p_resolve_streams(recs, lay, cfg)
    mo_rects, mo_mvs, d_rects, pt, rlg, lt = parts
    out = apply_motion_streams(prev, mo_rects, mo_mvs, lay.msid)
    out = reconstruct_blocks_streams(out, prev, d_rects, lay.bsid, pt, rlg, lt)
    return out[: c * h * w].view(c, h, w, 3), err


def decode_p_device(payloads: dict, ns: dict, kts, xx1: int, xx2: int,
                    n_data: int, prev: torch.Tensor, tables: dict,
                    cfg: CodecConfig):
    """Whole P-frame decode on the device: sections, block resolution,
    motion apply and data-block rebuild. Returns (frame, err, tables')."""
    recs, tables = decode_p_sections(payloads, ns, kts, tables)
    frame, err = rebuild_p(recs, ns, xx1, xx2, n_data, prev, cfg)
    return frame, err, tables


def rebuild_p(recs: dict, ns: dict, xx1: int, xx2: int, n_data: int,
              prev: torch.Tensor, cfg: CodecConfig):
    """rebuild_p_streams of one P frame (records {name: [n, W]}) -> (frame,
    err)."""
    lay = step_layout([header_row(ns, xx1, xx2, n_data)], prev.device)
    frames, err = rebuild_p_streams({name: r[None] for name, r in recs.items()}, lay,
                                    prev[None], cfg)
    return frames[0], err[0]


_P_ERRORS = (
    (1, "block-type runs do not cover xx range"),
    (2, "sub-rect record count mismatch"),
    (4, "motion record count mismatch"),
    (8, "data block count mismatch"),
    (16, "sub-rect outside block"),
    (32, "motion vector out of bounds"),
    (64, "pixel records do not tile data blocks"),
    (128, "pixel record crosses block boundary"),
    (256, "pixel record slot out of range"),
    (512, "pixel records exhausted literals"),
)


def raise_p_error(err: int):
    for bit, msg in _P_ERRORS:
        if err & bit:
            raise bs.CorruptStreamError(msg)
    if err:
        raise bs.CorruptStreamError(f"corrupt P-frame (err={err:#x})")


def payloads_to_device(payloads: dict, device) -> dict:
    """A P frame's section payloads on `device`: one blocking upload each."""
    return {name: to_device(np.ascontiguousarray(p), device, "pframe.payloads_to_device")
            for name, p in payloads.items()}
