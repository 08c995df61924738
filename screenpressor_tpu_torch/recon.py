"""I-frame reconstruction — PyTorch port of `screenpressor_tpu/jx/recon.py`.

Records guarantee exact predictor matches inside runs, so each row obeys
v[x] = a[x] * v[x-1] + b[x] with a in {0, 1}: literal, above and aboveleft
reset the recurrence, left carries it, gradient adds above - aboveleft.
Rows chain through the above row. Kernel K4 (`csrc/recon.cu`, replacing
`jx/recon.py:_recon_kernel`) walks the rows of a frame in one thread block,
a batch of frames (the keyframing streams of a serving step) in one launch;
`recon_rows_plain` is its plain version, a Python loop over rows.

Padding columns are left-runs, so the last pixel of row y-1 carries
through them into column 0 of row y, and column 0's aboveleft is the last
slot of the previous padded row (`jx/recon.py:96`).
"""

from __future__ import annotations

import torch

from screenpressor_tpu_torch.config import (
    PT_ABOVE,
    PT_ABOVELEFT,
    PT_GRADIENT,
    PT_LEFT,
    PT_LITERAL,
)
from screenpressor_tpu_torch import _build

I32 = torch.int32


def expand_records(records: torch.Tensor, lits: torch.Tensor, n: int):
    """records [R, 2] (ptype, run) + lits [L, 3] -> per-pixel ptype [n] and
    literal value [n, 3] of the covering record. Padded records have run 0.
    Values spread over runs as a delta scatter at run starts + cumsum, so a
    malformed record list cannot index out of range."""
    rec_pt = records[:, 0].to(I32)
    rec_n = records[:, 1].to(I32)
    starts = torch.cumsum(rec_n, dim=0, dtype=I32) - rec_n
    valid = rec_n > 0
    tgt = torch.where(valid & (starts < n), starts, n).long()

    def spread(vals):
        prev = torch.cat([torch.zeros_like(vals[:1]), vals[:-1]])
        first = torch.arange(vals.shape[0], device=vals.device)[:, None] == 0
        delta = torch.where(valid[:, None], vals - torch.where(first, 0, prev), 0)
        out = torch.zeros((n + 1, vals.shape[1]), dtype=I32, device=vals.device)
        out.index_put_((tgt,), delta, accumulate=True)
        # scan each channel along its innermost dimension ([C, n] layout)
        return torch.cumsum(out[:n].t().contiguous(), dim=1, dtype=I32).t()

    pt_pix = spread(rec_pt[:, None])[:, 0]
    lit_idx = torch.cumsum((rec_pt == PT_LITERAL).to(I32), dim=0) - 1
    lit_rec = lits[lit_idx.clamp(0, lits.shape[0] - 1).long()].to(I32)
    return pt_pix, spread(lit_rec)


def padded_width(w: int) -> int:
    return max(128, 1 << (w - 1).bit_length())


def recon_rows_plain(pt_rows: torch.Tensor, lit_rows: torch.Tensor,
                     w: int) -> torch.Tensor:
    """Plain version of K4. pt_rows [H, Wp] int32, lit_rows [H, Wp, 3]
    int32 -> frame [H, w, 3] uint8. Within a row, v[x] is the value at the
    last reset r <= x plus the gradient deltas after it (or the carry pixel
    plus all deltas when no reset precedes x)."""
    h, wp = pt_rows.shape
    dev = pt_rows.device
    xs = torch.arange(wp, device=dev)
    prev = torch.zeros((wp, 3), dtype=I32, device=dev)
    out = torch.empty((h, wp, 3), dtype=I32, device=dev)
    for y in range(h):
        pt = pt_rows[y]
        above = prev
        aboveleft = torch.roll(prev, 1, dims=0)
        carry = prev[wp - 1]
        reset = (pt == PT_LITERAL) | (pt == PT_ABOVE) | (pt == PT_ABOVELEFT)
        known = torch.where((pt == PT_ABOVE)[:, None], above,
                            torch.where((pt == PT_ABOVELEFT)[:, None], aboveleft,
                                        lit_rows[y]))
        d = torch.where(((pt == PT_GRADIENT) & ~reset)[:, None],
                        above - aboveleft, 0)
        cs = torch.cumsum(d, dim=0, dtype=I32)
        last, _ = torch.cummax(torch.where(reset, xs, -1), dim=0)
        lc = last.clamp_min(0)
        base = torch.where((last >= 0)[:, None], known[lc] - cs[lc], carry[None, :])
        row = base + cs
        out[y] = row
        prev = row
    return (out[:, :w] & 0xFF).to(torch.uint8)


def recon_rows(pt_rows: torch.Tensor, lit_rows: torch.Tensor, w: int) -> torch.Tensor:
    """Row reconstruction of one frame ([H, Wp] rows) or a batch ([N, H,
    Wp]): K4 on CUDA tensors, the plain version (per frame) on CPU."""
    if not pt_rows.is_cuda:
        if pt_rows.dim() == 2:
            return recon_rows_plain(pt_rows, lit_rows, w)
        return torch.stack([recon_rows_plain(p, lt, w) for p, lt in zip(pt_rows, lit_rows)])
    pt_rows = pt_rows.to(I32).contiguous()
    lit_rows = lit_rows.to(I32).contiguous()
    _build.require_cuda(pt_rows, lit_rows)
    lead = pt_rows.shape[:-1]
    wp = pt_rows.shape[-1]
    if wp & (wp - 1) or not 128 <= wp <= 8192 or lit_rows.shape != (*lead, wp, 3):
        raise ValueError(f"recon kernel takes pow2 widths 128..8192, got {wp}")
    out = torch.empty((*lead, w, 3), dtype=torch.uint8, device=pt_rows.device)
    n, h = (lead[0], lead[1]) if pt_rows.dim() == 3 else (1, lead[0])
    if n and h:
        _build.launch("sptc_recon_rows", pt_rows.data_ptr(), lit_rows.data_ptr(),
                      out.data_ptr(), n, h, w, wp)
    return out


def pad_rows(pt_pix: torch.Tensor, lit_pix: torch.Tensor, h: int, w: int):
    """Per-pixel arrays -> padded rows [H, Wp] / [H, Wp, 3]; padding
    columns are left-runs."""
    wp = padded_width(w)
    dev = pt_pix.device
    pt_rows = torch.full((h, wp), PT_LEFT, dtype=I32, device=dev)
    pt_rows[:, :w] = pt_pix.reshape(h, w)
    lit_rows = torch.zeros((h, wp, 3), dtype=I32, device=dev)
    lit_rows[:, :w] = lit_pix.reshape(h, w, 3)
    return pt_rows, lit_rows


def reconstruct_i(records: torch.Tensor, lits: torch.Tensor, h: int, w: int):
    """I-frame reconstruction -> [h, w, 3] uint8."""
    pt_pix, lit_pix = expand_records(records, lits, h * w)
    return recon_rows(*pad_rows(pt_pix, lit_pix, h, w), w)


def reconstruct_i_streams(records_l, lits_l, h: int, w: int):
    """reconstruct_i of C keyframes (lists of record / literal arrays) with
    one K4 launch -> [C, h, w, 3] uint8."""
    rows = [pad_rows(*expand_records(r, lt, h * w), h, w) for r, lt in zip(records_l, lits_l)]
    return recon_rows(torch.stack([p for p, _ in rows]), torch.stack([lt for _, lt in rows]), w)
