"""P-frame block analysis — PyTorch port of `screenpressor_tpu/jx/blocks.py`.

Change map over 16x16 blocks, minimal changed sub-rects, exact-match motion
search and compaction of the block-level record arrays, as plain tensor ops.

The motion vector of a changed block is the first candidate, in
`mv_candidates` order (FORMAT.md "Motion search"), whose shifted
previous-frame region equals the block's changed sub-rect byte for byte
and lies inside the frame. The search works on the changed blocks only:
per chunk of candidates it gathers each open block's shifted 16x16 windows,
tests the sub-rect for zero mismatch, records the lowest matching candidate
and drops the blocks it resolved from later chunks.
"""

from __future__ import annotations

import torch

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

I32 = torch.int32

# block x candidate windows tested per chunk of the motion search
SEARCH_CHUNK = 16384


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


def change_analysis(frame: torch.Tensor, prev: torch.Tensor, nby: int, nbx: int):
    """-> (changed [nb] bool, rects [nb, 4] absolute sub-rects (x1, y1, x2,
    y2), exclusive; garbage for unchanged blocks)."""
    h, w, _ = frame.shape
    dev = frame.device
    diff = torch.zeros((nby * BLOCK, nbx * BLOCK), dtype=torch.bool, device=dev)
    diff[:h, :w] = (frame != prev).any(dim=-1)
    d4 = diff.reshape(nby, BLOCK, nbx, BLOCK)
    r = torch.arange(BLOCK, device=dev)
    rows_any = d4.any(dim=3)  # [nby, 16, nbx]
    cols_any = d4.any(dim=1)  # [nby, nbx, 16]
    y1 = torch.where(rows_any, r[None, :, None], BLOCK).amin(dim=1)
    y2 = torch.where(rows_any, r[None, :, None] + 1, 0).amax(dim=1)
    x1 = torch.where(cols_any, r, BLOCK).amin(dim=2)
    x2 = torch.where(cols_any, r + 1, 0).amax(dim=2)
    bx = torch.arange(nbx, device=dev)[None, :] * BLOCK
    by = torch.arange(nby, device=dev)[:, None] * BLOCK
    rects = torch.stack([bx + x1, by + y1, bx + x2, by + y2], dim=-1).to(I32)
    return (y2 > 0).reshape(-1), rects.reshape(-1, 4)


def motion_search(frame: torch.Tensor, prev: torch.Tensor, rects: torch.Tensor,
                  changed: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """First matching candidate index per block ([nb] int32; C = none)."""
    h, w, _ = frame.shape
    dev = frame.device
    n_cand = cands.shape[0]
    choice = torch.full((rects.shape[0],), n_cand, dtype=I32, device=dev)
    todo = torch.nonzero(changed).reshape(-1)
    if todo.numel() == 0 or n_cand == 0:
        return choice
    rmax = int(cands.abs().max()) + BLOCK
    fpad = torch.full((h + BLOCK, w + BLOCK, 3), -2, dtype=torch.int16, device=dev)
    fpad[:h, :w] = frame
    ppad = torch.full((h + 2 * rmax, w + 2 * rmax, 3), -1, dtype=torch.int16,
                      device=dev)
    ppad[rmax:rmax + h, rmax:rmax + w] = prev
    ar = torch.arange(BLOCK, device=dev)
    x1, y1, x2, y2 = (rects[todo, i].long() for i in range(4))
    cur = fpad[(y1[:, None] + ar)[:, :, None], (x1[:, None] + ar)[:, None, :]]
    mask = (ar[None, :, None] < (y2 - y1)[:, None, None]) & (
        ar[None, None, :] < (x2 - x1)[:, None, None])
    c0 = 0
    while todo.numel() and c0 < n_cand:
        m = todo.numel()
        cc = cands[c0:c0 + max(1, min(n_cand - c0, SEARCH_CHUNK // m))].long()
        mx, my = cc[:, 0], cc[:, 1]
        ys = rmax + y1[:, None, None] + my[None, :, None] + ar  # [m, c, 16]
        xs = rmax + x1[:, None, None] + mx[None, :, None] + ar
        win = ppad[ys[:, :, :, None], xs[:, :, None, :]]  # [m, c, 16, 16, 3]
        bad = ((win != cur[:, None]).any(dim=-1) & mask[:, None]).flatten(2).any(dim=2)
        inb = ((x1[:, None] + mx >= 0) & (x2[:, None] + mx <= w)
               & (y1[:, None] + my >= 0) & (y2[:, None] + my <= h))
        match = inb & ~bad  # [m, c]
        hit = match.any(dim=1)
        first = match.to(torch.int8).argmax(dim=1)
        choice[todo] = torch.where(hit, c0 + first, choice[todo].long()).to(I32)
        keep = ~hit
        todo, x1, y1, x2, y2, cur, mask = (
            a[keep] for a in (todo, x1, y1, x2, y2, cur, mask))
        c0 += cc.shape[0]
    return choice


def block_types_from(valid: torch.Tensor, found: torch.Tensor,
                     rects: torch.Tensor, nbx: int, h: int, w: int) -> torch.Tensor:
    """Block types [nb] from the change map, motion verdicts and sub-rects."""
    nb = valid.shape[0]
    lin = torch.arange(nb, device=valid.device)
    x_lo, y_lo = (lin % nbx) * BLOCK, (lin // nbx) * BLOCK
    full = ((rects[:, 0] == x_lo) & (rects[:, 1] == y_lo)
            & (rects[:, 2] == (x_lo + BLOCK).clamp(max=w))
            & (rects[:, 3] == (y_lo + BLOCK).clamp(max=h)))
    bt = torch.where(full, BT_FULL_DATA, BT_PARTIAL_DATA) + 2 * found.to(I32)
    return torch.where(valid, bt, 0).to(I32)


def compact_block_records(bts: torch.Tensor, rects: torch.Tensor,
                          mvs: torch.Tensor, nbx: int, nbp: int):
    """Block-level arrays -> (bt [nbp, 2], sxy [nbp, 4], mv [nbp, 2],
    data_rects [nbp, 4], counts [7] = any, xx1, xx2, n_bt, n_sxy, n_mv,
    n_data). BT records are greedy runs over xx1..xx2, capped at MAX_RUN."""
    nb = bts.shape[0]
    dev = bts.device
    valid = bts > 0
    lin = torch.arange(nb, device=dev)
    x_lo, y_lo = (lin % nbx) * BLOCK, (lin // nbx) * BLOCK
    xx1 = torch.where(valid, lin, nb).min()
    xx2 = torch.where(valid, lin, -1).max()

    linp = torch.arange(nbp, device=dev)
    v = bts[(linp + xx1).clamp(0, nb - 1)]
    lenr = xx2 - xx1 + 1
    inr = linp < lenr
    vm = torch.where(inr, v, -1)
    prev_v = torch.cat([vm.new_full((1,), -2), vm[:-1]])
    bnd = (vm != prev_v) & inr
    run_start, _ = torch.cummax(torch.where(bnd, linp, -1), dim=0)
    new_rec = (bnd | ((linp - run_start) % MAX_RUN == 0)) & inr
    rid = torch.cumsum(new_rec.to(I32), dim=0) - 1
    starts = torch.full((nbp + 1,), 0, dtype=torch.int64, device=dev)
    starts.index_put_((torch.where(new_rec, rid, nbp).long(),), linp)
    n_bt = new_rec.sum(dtype=I32)
    slot = torch.arange(nbp, device=dev)
    starts = torch.where(slot < n_bt, starts[:nbp], lenr)
    ends = torch.cat([starts[1:], lenr.reshape(1)]).clamp(max=lenr)
    bt_vals = v[starts.clamp(0, nbp - 1)]
    bt_recs = torch.stack([bt_vals, ends - starts], dim=1).to(I32)

    is_partial = (bts == BT_PARTIAL_DATA) | (bts == BT_PARTIAL_MOTION)
    is_motion = (bts == BT_FULL_MOTION) | (bts == BT_PARTIAL_MOTION)
    is_data = (bts == BT_FULL_DATA) | (bts == BT_PARTIAL_DATA)
    rel = torch.stack([rects[:, 0] - x_lo, rects[:, 1] - y_lo,
                       rects[:, 2] - 1 - x_lo, rects[:, 3] - 1 - y_lo], dim=1)

    def compact(mask, vals):
        idx = torch.cumsum(mask.to(I32), dim=0) - 1
        out = torch.zeros((nbp + 1, vals.shape[1]), dtype=I32, device=dev)
        out.index_put_((torch.where(mask, idx, nbp).long(),), vals.to(I32))
        return out[:nbp]

    counts = torch.stack([
        valid.any().to(torch.int64), xx1, xx2, n_bt.long(),
        is_partial.sum(), is_motion.sum(), is_data.sum(),
    ]).to(I32)
    return (bt_recs, compact(is_partial, rel), compact(is_motion, mvs),
            compact(is_data, rects), counts)


def analyze_compact(frame: torch.Tensor, prev: torch.Tensor, cands: torch.Tensor,
                    cfg: CodecConfig):
    """Full P-frame analysis + record compaction.

    Returns (arrs, counts, flat): arrs holds the capacity-nbp (next_pow2 of
    the block count) record arrays bt [nbp, 2], sxy [nbp, 4], mv [nbp, 2]
    and data_rects [nbp, 4]; counts [7] = (any_change, xx1, xx2, n_bt,
    n_sxy, n_mv, n_data); flat [4] = (is_flat, r, g, b) of pixel (0, 0)."""
    h, w = cfg.height, cfg.width
    nbx, nby = cfg.nbx, cfg.nby
    changed, rects = change_analysis(frame, prev, nby, nbx)
    choice = motion_search(frame, prev, rects, changed, cands)
    n_cand = cands.shape[0]
    found = changed & (choice < n_cand)
    if n_cand:
        mvs = cands[choice.clamp(0, n_cand - 1).long()]
    else:
        mvs = torch.zeros((changed.shape[0], 2), dtype=I32, device=frame.device)
    bts = block_types_from(changed, found, rects, nbx, h, w)
    bt, sxy, mv, data_rects, counts = compact_block_records(
        bts, rects, mvs, nbx, next_pow2(nbx * nby))
    c0 = frame.reshape(-1, 3)[0]
    flat = torch.cat([(frame == c0).all().to(I32).reshape(1), c0.to(I32)])
    arrs = {"bt": bt, "sxy": sxy, "mv": mv, "data_rects": data_rects}
    return arrs, counts, flat
