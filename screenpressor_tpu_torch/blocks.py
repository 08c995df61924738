"""P-frame block analysis — PyTorch port of `screenpressor_tpu/jx/blocks.py`.

Change map over 16x16 blocks, minimal changed sub-rects, flat flags,
exact-match motion search and compaction of the block-level record arrays,
over a leading axis of C streams or frames (`analyze_compact_streams`, the
counterpart of the reference's vmapped `analyze_compact`); one frame is the
case C = 1 (`analyze_compact`).

The motion vector of a changed block is the first candidate, in
`mv_candidates` order (FORMAT.md "Motion search"), whose shifted
previous-frame region equals the block's changed sub-rect byte for byte
and lies inside the frame. On the card the whole block front end (change
map, sub-rects, flat flags, search) is K5
(`kernels.analyze_blocks_streams_kernel`, `csrc/motion_search.cu`): one
launch over every block of every stream that reads the uint8 frames where
they lie, no host sync, so `analyze_compact_streams` on a CUDA tensor reads
nothing back, as the reference's jitted `analyze_compact` does. On the CPU
it is the plain version, `analyze_blocks_streams_plain`: the change map
and flat flags as tensor ops, then `motion_search_streams_plain`, which
packs pixels to int32 (r | g << 8 | b << 16, one compare a pixel) and
takes the changed blocks of every stream as one flat list (one `nonzero`
a call), each block reading its own previous frame through its stream's
offset; per chunk of candidates it gathers each open block's shifted 16x16
windows, tests the sub-rect for zero mismatch, records the lowest matching
candidate and drops the blocks it resolved from later chunks (one host
sync a chunk).
"""

from __future__ import annotations

import torch

from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.config import (
    BLOCK,
    BT_FULL_DATA,
    BT_FULL_MOTION,
    BT_PARTIAL_DATA,
    BT_PARTIAL_MOTION,
    MAX_RUN,
    CodecConfig,
    next_pow2,
)
from screenpressor_tpu_torch.kernels import analyze_blocks_streams_kernel

I32 = torch.int32
AREA = BLOCK * BLOCK

# block x candidate windows tested per chunk of the motion search
SEARCH_CHUNK = 65536


def mv_candidates(cfg: CodecConfig) -> list[tuple[int, int]]:
    """Static prioritized candidate list (FORMAT.md 'Motion search'):
    vertical, then horizontal displacements by growing distance, then the
    rest of the low window in raster order. Negative displacements reach
    -msr, positive ones stop at msr - 1."""
    cands = []
    for d in range(1, cfg.msr_y + 1):
        cands.append((0, -d))
        if d < cfg.msr_y:
            cands.append((0, d))
    for d in range(1, cfg.msr_x + 1):
        cands.append((-d, 0))
    for d in range(1, cfg.msr_x):
        cands.append((d, 0))
    seen = {(0, 0)} | set(cands)
    for dy in range(-cfg.msr_low_y, cfg.msr_low_y + 1):
        for dx in range(-cfg.msr_low_x, cfg.msr_low_x + 1):
            if (dx, dy) not in seen:
                cands.append((dx, dy))
                seen.add((dx, dy))
    return cands


def _rows(h: int, nby: int, row0: int):
    """Pixel rows [y0, y1) of block rows [row0, row0 + nby) inside a frame
    of h rows."""
    y0 = row0 * BLOCK
    return y0, max(y0, min(y0 + nby * BLOCK, h))


def change_analysis_streams(frames: torch.Tensor, prevs: torch.Tensor, nby: int, nbx: int,
                            row0: int = 0):
    """frames, prevs [C, H, W, 3], block rows [row0, row0 + nby) (rows past
    the frame unchanged) -> (changed [C, nb] bool, rects [C, nb, 4]
    absolute sub-rects (x1, y1, x2, y2), exclusive; (bx + 16, by + 16, bx,
    by) for unchanged blocks)."""
    c, h, w, _ = frames.shape
    dev = frames.device
    y0, y1 = _rows(h, nby, row0)
    diff = torch.zeros((c, nby * BLOCK, nbx * BLOCK), dtype=torch.bool, device=dev)
    diff[:, :y1 - y0, :w] = (frames[:, y0:y1] != prevs[:, y0:y1]).any(dim=-1)
    d4 = diff.reshape(c, nby, BLOCK, nbx, BLOCK)
    r = torch.arange(BLOCK, device=dev)
    rows_any = d4.any(dim=4)  # [C, nby, 16, nbx]
    cols_any = d4.any(dim=2)  # [C, nby, nbx, 16]
    y1 = torch.where(rows_any, r[:, None], BLOCK).amin(dim=2)
    y2 = torch.where(rows_any, r[:, None] + 1, 0).amax(dim=2)
    x1 = torch.where(cols_any, r, BLOCK).amin(dim=3)
    x2 = torch.where(cols_any, r + 1, 0).amax(dim=3)
    bx = torch.arange(nbx, device=dev)[None, :] * BLOCK
    by = (row0 + torch.arange(nby, device=dev)[:, None]) * BLOCK
    rects = torch.stack([bx + x1, by + y1, bx + x2, by + y2], dim=-1).to(I32)
    return (y2 > 0).reshape(c, -1), rects.reshape(c, -1, 4)


def flat_blocks_streams(frames: torch.Tensor, nby: int, nbx: int, row0: int = 0):
    """[C, nb] bool: every in-frame pixel of the block (block rows [row0,
    row0 + nby)) equals its frame's pixel (0, 0)."""
    c, h, w, _ = frames.shape
    y0, y1 = _rows(h, nby, row0)
    eq = torch.ones((c, nby * BLOCK, nbx * BLOCK), dtype=torch.bool, device=frames.device)
    eq[:, :y1 - y0, :w] = (frames[:, y0:y1] == frames[:, :1, :1]).all(dim=-1)
    return eq.reshape(c, nby, BLOCK, nbx, BLOCK).all(dim=4).all(dim=2).reshape(c, -1)


def analyze_blocks_streams(frames: torch.Tensor, prevs: torch.Tensor, cands: torch.Tensor,
                           row0: int = 0, nby: int | None = None):
    """The block front end of the P analysis of C streams (frames, prevs
    [C, H, W, 3] uint8; cands [n_cand, 2]) over block rows [row0, row0 +
    nby) (default: to the frame's last): (changed [C, nb] bool, rects [C,
    nb, 4] int32 in frame coordinates, choice [C, nb] int32 (n_cand = no
    match), flat [C, nb] bool). A row shard reads its candidates from the
    full frames. K5 on CUDA tensors (one launch, no host sync; raises if
    the launch fails), the plain version on CPU tensors."""
    if nby is None:
        nby = -(-frames.shape[1] // BLOCK) - row0
    if not frames.is_cuda:
        return analyze_blocks_streams_plain(frames, prevs, cands, row0, nby)
    return analyze_blocks_streams_kernel(frames, prevs, cands.to(frames.device), row0, nby)


def analyze_blocks_streams_plain(frames: torch.Tensor, prevs: torch.Tensor,
                                 cands: torch.Tensor, row0: int = 0, nby: int | None = None):
    """The plain version of K5 (analyze_blocks_streams' contract):
    change_analysis_streams, motion_search_streams_plain on the full frames,
    flat_blocks_streams."""
    if nby is None:
        nby = -(-frames.shape[1] // BLOCK) - row0
    nbx = -(-frames.shape[2] // BLOCK)
    changed, rects = change_analysis_streams(frames, prevs, nby, nbx, row0)
    choice = motion_search_streams_plain(frames, prevs, rects, changed, cands)
    return changed, rects, choice, flat_blocks_streams(frames, nby, nbx, row0)


def pack_pixels(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [...] int32 r | g << 8 | b << 16 (the reference's
    channel packing, jx/blocks.py motion_search_pruned)."""
    return (img[..., 0].to(I32) | (img[..., 1].to(I32) << 8)
            | (img[..., 2].to(I32) << 16))


def motion_search_streams_plain(frames: torch.Tensor, prevs: torch.Tensor,
                                rects: torch.Tensor, changed: torch.Tensor,
                                cands: torch.Tensor) -> torch.Tensor:
    """First matching candidate index of each block of each stream ([C, nb]
    int32; n_cand = none) in chunks of candidates: frames, prevs [C, H, W,
    3]; rects [C, nb, 4] in frame coordinates; changed [C, nb]; cands
    [n_cand, 2]. Host syncs: the call's `nonzero`, then one a candidate
    chunk but the last.

    A window position is read at its coordinate clamped into the stream's
    own frame: only the sub-rect's positions are compared, and a candidate
    that moves the sub-rect out of the frame is rejected by its bounds
    test, so a clamped read never decides a match."""
    c, h, w, _ = frames.shape
    nb = rects.shape[1]
    dev = frames.device
    n_cand = cands.shape[0]
    choice = torch.full((c * nb,), n_cand, dtype=I32, device=dev)
    todo = torch.nonzero(changed.reshape(-1)).reshape(-1)
    if todo.numel() == 0 or n_cand == 0:
        return choice.view(c, nb)
    # flat pixel indices fit int32 unless the call holds over 2^31 pixels
    idt = I32 if c * h * w < 2 ** 31 else torch.int64
    fpk = pack_pixels(frames).reshape(-1)
    ppk = pack_pixels(prevs).reshape(-1)
    cands = cands.to(device=dev, dtype=idt)
    ar = torch.arange(BLOCK, device=dev, dtype=idt)
    r = rects.reshape(-1, 4)[todo].to(idt)
    x1, y1, x2, y2 = r.unbind(1)
    base = (todo // nb).to(idt) * (h * w)

    def windows(img, b, ys0, xs0):
        """Packed 16x16 windows [..., 256] with origins (ys0, xs0) [...] of
        the frames at pixel offsets b [...]."""
        ys = (ys0[..., None] + ar).clamp(0, h - 1)
        xs = (xs0[..., None] + ar).clamp(0, w - 1)
        idx = (b[..., None, None] + ys[..., :, None] * w) + xs[..., None, :]
        return img.index_select(0, idx.reshape(-1)).view(*idx.shape[:-2], AREA)

    cur = windows(fpk, base, y1, x1)  # [m, 256]
    mask = ((ar[:, None] < (y2 - y1)[:, None, None])
            & (ar[None, :] < (x2 - x1)[:, None, None])).reshape(-1, AREA)
    c0 = 0
    while True:
        m = todo.numel()
        nc = max(1, min(n_cand - c0, SEARCH_CHUNK // m))
        mx, my = cands[c0:c0 + nc, 0], cands[c0:c0 + nc, 1]
        # blocks a launch group: a chunk of one candidate may hold more
        # blocks than SEARCH_CHUNK; the groups need no sync between them
        step = max(1, SEARCH_CHUNK // nc)
        hits, firsts = [], []
        for lo in range(0, m, step):
            s = slice(lo, lo + step)
            win = windows(ppk, base[s, None], y1[s, None] + my, x1[s, None] + mx)
            bad = ((win != cur[s, None]) & mask[s, None]).any(dim=2)
            inb = ((x1[s, None] + mx >= 0) & (x2[s, None] + mx <= w)
                   & (y1[s, None] + my >= 0) & (y2[s, None] + my <= h))
            match = inb & ~bad  # [ms, nc]
            hits.append(match.any(dim=1))
            firsts.append(match.to(torch.int8).argmax(dim=1))
        hit = torch.cat(hits)
        choice[todo] = torch.where(hit, c0 + torch.cat(firsts), n_cand).to(I32)
        c0 += nc
        if c0 >= n_cand:
            break
        keep = torch.nonzero(~hit).reshape(-1)  # the chunk's host sync
        if keep.numel() == 0:
            break
        todo, base, x1, y1, x2, y2, cur, mask = (
            a[keep] for a in (todo, base, x1, y1, x2, y2, cur, mask))
    return choice.view(c, nb)


def block_types_from(valid: torch.Tensor, found: torch.Tensor,
                     rects: torch.Tensor, nbx: int, h: int, w: int,
                     lin0: int = 0) -> torch.Tensor:
    """Block types [..., nb] (one frame, or [C, nb] for C streams) from the
    change map, motion verdicts and sub-rects [..., nb, 4]. lin0: the
    raster index of the first block (a row shard's blocks)."""
    nb = valid.shape[-1]
    lin = lin0 + torch.arange(nb, device=valid.device)
    x_lo, y_lo = (lin % nbx) * BLOCK, (lin // nbx) * BLOCK
    full = ((rects[..., 0] == x_lo) & (rects[..., 1] == y_lo)
            & (rects[..., 2] == (x_lo + BLOCK).clamp(max=w))
            & (rects[..., 3] == (y_lo + BLOCK).clamp(max=h)))
    bt = torch.where(full, BT_FULL_DATA, BT_PARTIAL_DATA) + 2 * found.to(I32)
    return torch.where(valid, bt, 0).to(I32)


def compact_block_records(bts: torch.Tensor, rects: torch.Tensor,
                          mvs: torch.Tensor, nbx: int, nbp: int):
    """Block-level arrays of C streams (bts [C, nb], rects [C, nb, 4], mvs
    [C, nb, 2]) -> (bt [C, nbp, 2], sxy [C, nbp, 4], mv [C, nbp, 2],
    data_rects [C, nbp, 4], counts [C, 7] = any, xx1, xx2, n_bt, n_sxy,
    n_mv, n_data). BT records are greedy runs over each stream's own
    xx1..xx2, capped at MAX_RUN; each kind compacts into the stream's own
    nbp rows."""
    c, nb = bts.shape
    dev = bts.device
    valid = bts > 0
    lin = torch.arange(nb, device=dev)
    x_lo, y_lo = (lin % nbx) * BLOCK, (lin // nbx) * BLOCK
    sid = torch.arange(c, device=dev)[:, None]
    xx1 = torch.where(valid, lin, nb).amin(dim=1)
    xx2 = torch.where(valid, lin, -1).amax(dim=1)

    linp = torch.arange(nbp, device=dev)
    v = bts.gather(1, (linp + xx1[:, None]).clamp(0, nb - 1))
    lenr = (xx2 - xx1 + 1)[:, None]
    inr = linp < lenr
    vm = torch.where(inr, v, -1)
    prev_v = torch.cat([vm.new_full((c, 1), -2), vm[:, :-1]], dim=1)
    bnd = (vm != prev_v) & inr
    run_start, _ = torch.cummax(torch.where(bnd, linp, -1), dim=1)
    new_rec = (bnd | ((linp - run_start) % MAX_RUN == 0)) & inr
    rid = torch.cumsum(new_rec.to(I32), dim=1) - 1
    starts = torch.zeros((c, nbp + 1), dtype=torch.int64, device=dev)
    starts.index_put_((sid.expand(c, nbp), torch.where(new_rec, rid, nbp).long()),
                      linp.expand(c, nbp))
    n_bt = new_rec.sum(dim=1, dtype=I32)
    starts = torch.where(linp < n_bt[:, None], starts[:, :nbp], lenr)
    ends = torch.minimum(torch.cat([starts[:, 1:], lenr], dim=1), lenr)
    bt_vals = v.gather(1, starts.clamp(0, nbp - 1))
    bt_recs = torch.stack([bt_vals, ends - starts], dim=2).to(I32)

    is_partial = (bts == BT_PARTIAL_DATA) | (bts == BT_PARTIAL_MOTION)
    is_motion = (bts == BT_FULL_MOTION) | (bts == BT_PARTIAL_MOTION)
    is_data = (bts == BT_FULL_DATA) | (bts == BT_PARTIAL_DATA)
    rel = torch.stack([rects[..., 0] - x_lo, rects[..., 1] - y_lo,
                       rects[..., 2] - 1 - x_lo, rects[..., 3] - 1 - y_lo], dim=2)

    def compact(mask, vals):
        idx = torch.cumsum(mask.to(I32), dim=1) - 1
        out = torch.zeros((c * nbp + 1, vals.shape[2]), dtype=I32, device=dev)
        tgt = torch.where(mask, sid * nbp + idx, c * nbp).long()
        out.index_put_((tgt.reshape(-1),), vals.reshape(c * nb, -1).to(I32))
        return out[:c * nbp].view(c, nbp, -1)

    counts = torch.stack([
        valid.any(dim=1).to(torch.int64), xx1, xx2, n_bt.long(),
        is_partial.sum(dim=1), is_motion.sum(dim=1), is_data.sum(dim=1),
    ], dim=1).to(I32)
    return (bt_recs, compact(is_partial, rel), compact(is_motion, mvs),
            compact(is_data, rects), counts)


def analyze_compact_streams(frames: torch.Tensor, prevs: torch.Tensor,
                            cands: torch.Tensor, cfg: CodecConfig):
    """Full P-frame analysis + record compaction of C frames against their
    previous frames (frames, prevs [C, H, W, 3]): the counterpart of the
    reference's `_batched_analyze_dense` / `_batched_analyze` (serving) and
    `encode_p_dispatch_batch` (a session's batch).

    Returns (arrs, counts, flat): arrs holds the capacity-nbp (next_pow2 of
    the block count) record arrays bt [C, nbp, 2], sxy [C, nbp, 4], mv
    [C, nbp, 2] and data_rects [C, nbp, 4]; counts [C, 7] = (any_change,
    xx1, xx2, n_bt, n_sxy, n_mv, n_data); flat [C, 4] = (is_flat, r, g, b)
    of pixel (0, 0)."""
    _, h, w, _ = frames.shape
    nbx, nby = cfg.nbx, cfg.nby
    with telemetry.span("sptc.blocks.analysis"):
        changed, rects, choice, flat_blk = analyze_blocks_streams(frames, prevs, cands, 0, nby)
        n_cand = cands.shape[0]
        found = changed & (choice < n_cand)
        if n_cand:
            mvs = cands[choice.clamp(0, n_cand - 1).long()]
        else:
            mvs = torch.zeros(changed.shape + (2,), dtype=I32, device=frames.device)
        bts = block_types_from(changed, found, rects, nbx, h, w)
        with telemetry.span("sptc.blocks.compact"):
            bt, sxy, mv, data_rects, counts = compact_block_records(
                bts, rects, mvs, nbx, next_pow2(nbx * nby))
        flat = torch.cat([flat_blk.all(dim=1).to(I32)[:, None], frames[:, 0, 0].to(I32)], dim=1)
    arrs = {"bt": bt, "sxy": sxy, "mv": mv, "data_rects": data_rects}
    return arrs, counts, flat


def analyze_compact(frame: torch.Tensor, prev: torch.Tensor, cands: torch.Tensor,
                    cfg: CodecConfig):
    """analyze_compact_streams of one frame -> (arrs {name: [nbp, W]},
    counts [7], flat [4])."""
    arrs, counts, flat = analyze_compact_streams(frame[None], prev[None], cands, cfg)
    return {name: a[0] for name, a in arrs.items()}, counts[0], flat[0]
