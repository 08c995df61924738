"""I-frame pixel classification and greedy RLE segmentation — PyTorch port
of `screenpressor_tpu/jx/classify.py`.

Predicate planes and start types are plain tensor ops. The segmentation walk
is kernel K3 (`csrc/run_walk.cu`, replacing `jx/classify.py:_run_walk`): a
state machine per seg tile, which the kernel runs as a jump walk (every
position finds the record start that would follow it; one thread hops from
start to start), a thread block per tile. `run_walk_plain` is its plain
version. Record and literal compaction is a cumsum + scatter
that yields the JAX package's record and literal order.
"""

from __future__ import annotations

import torch

from screenpressor_tpu_torch.config import (
    MAX_RUN,
    NUM_PTYPES,
    PT_ABOVE,
    PT_ABOVELEFT,
    PT_GRADIENT,
    PT_LEFT,
    PT_LITERAL,
    seg_tile,
)
from screenpressor_tpu_torch import _build

I32 = torch.int32


def fits_planes_i(frame: torch.Tensor) -> torch.Tensor:
    """frame [H, W, 3] uint8 -> fits [N, 6] bool (raster layout)."""
    h, w, _ = frame.shape
    n = h * w
    dev = frame.device
    pix = frame.reshape(n, 3).to(I32)
    zero = torch.zeros((1, 3), dtype=I32, device=dev)
    left = torch.cat([zero, pix[:-1]])
    above = torch.cat([torch.zeros((w, 3), dtype=I32, device=dev), pix[:-w]])
    idx = torch.arange(n, device=dev)
    inner = (idx >= w + 1) & (idx % w > 0)
    al_idx = torch.where(inner, idx - w - 1, (idx - 1).clamp_min(0))
    aboveleft = pix[al_idx]
    aboveleft[0] = 0
    has_above = idx >= w

    def eq(a, b):
        return (a == b).all(dim=1)

    f_left = eq(pix, left) & (idx > 0)  # a mask, not an indexed store: no host sync
    fits = torch.zeros((n, NUM_PTYPES), dtype=torch.bool, device=dev)
    fits[:, PT_LITERAL] = f_left
    fits[:, PT_LEFT] = f_left
    fits[:, PT_ABOVE] = eq(pix, above) & has_above
    fits[:, PT_GRADIENT] = eq(pix, left + above - aboveleft) & has_above
    fits[:, PT_ABOVELEFT] = eq(pix, aboveleft) & has_above
    return fits


def start_types_i(fits: torch.Tensor) -> torch.Tensor:
    t = torch.full((fits.shape[0],), PT_LITERAL, dtype=I32, device=fits.device)
    for p in (PT_GRADIENT, PT_ABOVE, PT_ABOVELEFT, PT_LEFT):
        t = torch.where(fits[:, p], p, t)
    return t


def fits_bits(fits: torch.Tensor) -> torch.Tensor:
    """[N, T] bool predicate planes -> [N] int32 bit set."""
    weights = 1 << torch.arange(fits.shape[1], dtype=I32, device=fits.device)
    return (fits.to(I32) * weights).sum(dim=1, dtype=I32)


def run_walk_plain(bits: torch.Tensor, st: torch.Tensor, tile: int) -> torch.Tensor:
    """Plain version of K3: per tile, extend the current ptype while its
    fits bit holds and the run is < MAX_RUN; tile position 0 always starts.
    The walk is serial in the tile position and vectorised across tiles.
    bits/st: [n] int32 -> is_start [n] bool."""
    n = bits.shape[0]
    dev = bits.device
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    fb = torch.cat([bits, torch.zeros(pad, dtype=I32, device=dev)]).reshape(n_tiles, tile)
    sb = torch.cat([st, torch.zeros(pad, dtype=I32, device=dev)]).reshape(n_tiles, tile)
    out = torch.zeros((n_tiles, tile), dtype=torch.bool, device=dev)
    cur = torch.zeros(n_tiles, dtype=I32, device=dev)
    run = torch.zeros(n_tiles, dtype=I32, device=dev)
    for p in range(tile):
        fits_cur = ((fb[:, p] >> cur) & 1) == 1
        start = ~(fits_cur & (run < MAX_RUN)) if p else torch.ones_like(fits_cur)
        out[:, p] = start
        cur = torch.where(start, sb[:, p], cur)
        run = torch.where(start, 1, run + 1)
    return out.reshape(-1)[:n]


def run_walk(bits: torch.Tensor, st: torch.Tensor, tile: int) -> torch.Tensor:
    """Record-start mask of the greedy walk: K3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not bits.is_cuda:
        return run_walk_plain(bits, st, tile)
    bits = bits.to(I32).contiguous()
    st = st.to(I32).contiguous()
    _build.require_cuda(bits, st)
    n = bits.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=bits.device)
    if n:
        _build.launch("sptc_run_walk", bits.data_ptr(), st.data_ptr(),
                      out.data_ptr(), n, tile, device=bits.device)
    return out


def _compact(mask: torch.Tensor, vals: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows of `vals` where `mask` holds, in order, into a zero-filled
    [cap, C] array (slots past the count stay 0)."""
    pos = torch.cumsum(mask.to(I32), dim=0) - 1
    tgt = torch.where(mask, pos, cap).long()
    out = torch.zeros((cap + 1, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    out.index_put_((tgt,), vals)
    return out[:cap]


def classify_from_starts(is_start: torch.Tensor, st: torch.Tensor,
                         pix: torch.Tensor):
    """Start mask + start types + pixels [n, 3] -> (records [n, 2] int32,
    n_records, lits [n, 3] int32, n_literals) with device counts."""
    n = is_start.shape[0]
    idx = torch.arange(n, dtype=I32, device=is_start.device)
    starts = _compact(is_start, idx[:, None], n)[:, 0]
    n_records = is_start.sum(dtype=I32)
    nxt = torch.cat([starts[1:], starts.new_zeros(1)])
    slot = torch.arange(n, device=is_start.device)
    nxt = torch.where(slot + 1 < n_records, nxt, n)
    valid = slot < n_records
    ptypes = torch.where(valid, st[starts.long()], 0)
    rlens = torch.where(valid, nxt - starts, 0)
    records = torch.stack([ptypes, rlens], dim=1).to(I32)
    is_lit = is_start & (st == PT_LITERAL)
    lits = _compact(is_lit, pix.to(I32), n)
    return records, n_records, lits, is_lit.sum(dtype=I32)


def classify_i(frame: torch.Tensor):
    """Device classification of a keyframe: (records [n, 2] (ptype, run),
    n_records, lits [n, 3], n_literals); counts stay on the device."""
    return classify_i_streams(frame[None])[0]


def walk_inputs_streams(frames: torch.Tensor):
    """The run walk's inputs for the frames of [C, H, W, 3]: fits bits and
    start types [C, n_pad] int32, each frame's positions padded to a whole
    number of seg tiles so that no tile straddles two frames, and the tile."""
    c, h, w, _ = frames.shape
    n = h * w
    tile = seg_tile(n, w)
    n_pad = -(-n // tile) * tile
    bits = torch.zeros((c, n_pad), dtype=I32, device=frames.device)
    sts = torch.zeros((c, n_pad), dtype=I32, device=frames.device)
    for i in range(c):
        fits = fits_planes_i(frames[i])
        sts[i, :n] = start_types_i(fits)
        bits[i, :n] = fits_bits(fits)
    return bits, sts, tile


def classify_i_streams(frames: torch.Tensor):
    """classify_i of each frame of [C, H, W, 3], with one run walk (K3) over
    all of them (`walk_inputs_streams`). Returns a list of C results."""
    c, h, w, _ = frames.shape
    n = h * w
    bits, sts, tile = walk_inputs_streams(frames)
    is_start = run_walk(bits.reshape(-1), sts.reshape(-1), tile).reshape(c, -1)
    return [classify_from_starts(is_start[i, :n], sts[i, :n], frames[i].reshape(n, 3))
            for i in range(c)]
