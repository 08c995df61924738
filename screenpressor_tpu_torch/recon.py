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

The rows reach K4 as one int32 word per padded position (`pack_rows`): the
low byte of each channel in a 10-bit field (R bits 0-7, G 10-17, B 20-27)
and a type code in bits 28-30 whose bits select K4's map (`_CODE_OF`).
The recurrence only copies, adds and subtracts, and the frame keeps the
low byte of each channel, so each channel's low byte depends only on low
bytes: the kernel works mod 256 per field, exactly as the reference's
int32 arithmetic does on those bytes.
"""

from __future__ import annotations

import functools

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


FIELD_SHIFTS = (0, 10, 20)  # R, G, B in the packed word
TYPE_SHIFT = 28
# ptype -> K4's type code: bit 2 "adds to v[x-1]" (gradient, and every
# type that carries), bit 1 "from the row before" (above, aboveleft,
# gradient), bit 0 "aboveleft". A literal's code is 0.
CODE_CARRY = 4
# indexed by ptype + 1 for ptypes clamped to -1..6 (-1 and 6: outside 0..5)
_CODE_OF = (CODE_CARRY, 0, CODE_CARRY, 2, CODE_CARRY, 6, 3, CODE_CARRY)
# indexed by code 0..7 (the unused codes carry)
_TYPE_OF = (PT_LITERAL, PT_LEFT, PT_ABOVE, PT_ABOVELEFT, PT_LEFT, PT_LEFT, PT_GRADIENT, PT_LEFT)


@functools.lru_cache(maxsize=None)
def _table(values: tuple, device: torch.device) -> torch.Tensor:
    """A lookup table on the device, made once: a host-to-device copy per
    call would stall the queue of the launches around it."""
    return torch.tensor(values, dtype=I32, device=device)


def pack_rows(pt: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """Per-position ptype [...] and literal [..., 3] (int32) -> packed words
    [...]. A ptype outside 0..5 is carried like left, as the recurrence
    treats it."""
    dev = pt.device
    code = _table(_CODE_OF, dev)[(pt.clamp(-1, PT_ABOVELEFT + 1) + 1).long()]
    fields = ((lit.to(I32) & 0xFF) << _table(FIELD_SHIFTS, dev)).sum(dim=-1, dtype=I32)
    return fields | (code << TYPE_SHIFT)


def unpack_rows(rows: torch.Tensor):
    """Packed words [...] -> (ptype [...], literal [..., 3]) int32."""
    lit = torch.stack([(rows >> sh) & 0xFF for sh in FIELD_SHIFTS], dim=-1)
    code = ((rows >> TYPE_SHIFT) & 7).long()
    return _table(_TYPE_OF, rows.device)[code], lit


def recon_rows_plain(rows: torch.Tensor, w: int) -> torch.Tensor:
    """Plain version of K4. rows [H, Wp] packed int32 -> frame [H, w, 3]
    uint8. Within a row, v[x] is the value at the last reset r <= x plus the
    gradient deltas after it (or the carry pixel plus all deltas when no
    reset precedes x)."""
    pt_rows, lit_rows = unpack_rows(rows)
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


def recon_rows(rows: torch.Tensor, w: int) -> torch.Tensor:
    """Row reconstruction of one frame ([H, Wp] packed rows) or a batch
    ([N, H, Wp]): K4 on CUDA tensors, the plain version (per frame) on CPU."""
    if not rows.is_cuda:
        if rows.dim() == 2:
            return recon_rows_plain(rows, w)
        return torch.stack([recon_rows_plain(r, w) for r in rows])
    rows = rows.to(I32).contiguous()
    if rows.data_ptr() % 16:  # K4 stages rows with 16-byte copies
        rows = rows.clone()
    _build.require_cuda(rows)
    lead = rows.shape[:-1]
    wp = rows.shape[-1]
    if wp & (wp - 1) or not 128 <= wp <= 8192 or not 1 <= w <= wp:
        raise ValueError(f"recon kernel takes pow2 widths 128..8192 and 1 <= w <= Wp, "
                         f"got Wp {wp}, w {w}")
    out = torch.empty((*lead, w, 3), dtype=torch.uint8, device=rows.device)
    n, h = (lead[0], lead[1]) if rows.dim() == 3 else (1, lead[0])
    if n and h:
        _build.launch("sptc_recon_rows", rows.data_ptr(), out.data_ptr(), n, h, w, wp,
                      device=rows.device)
    return out


def _padding(n: int, h: int, w: int, device) -> torch.Tensor:
    """[n, H, Wp] packed rows of left-runs."""
    return torch.full((n, h, padded_width(w)), CODE_CARRY << TYPE_SHIFT, dtype=I32,
                      device=device)


def pad_rows(pt_pix: torch.Tensor, lit_pix: torch.Tensor, h: int, w: int):
    """Per-pixel arrays -> packed rows [H, Wp]; padding columns are
    left-runs."""
    rows = _padding(1, h, w, pt_pix.device)[0]
    rows[:, :w] = pack_rows(pt_pix, lit_pix).reshape(h, w)
    return rows


def reconstruct_i(records: torch.Tensor, lits: torch.Tensor, h: int, w: int):
    """I-frame reconstruction -> [h, w, 3] uint8."""
    pt_pix, lit_pix = expand_records(records, lits, h * w)
    return recon_rows(pad_rows(pt_pix, lit_pix, h, w), w)


def reconstruct_i_streams(records_l, lits_l, h: int, w: int):
    """reconstruct_i of C keyframes (lists of record / literal arrays) with
    one K4 launch -> [C, h, w, 3] uint8. Each frame packs into its slot of
    the batch: packing all at once would hold every frame's per-pixel
    literals and their packing temporaries at the same time, which raises
    the serving session's peak device memory."""
    rows = _padding(len(records_l), h, w, records_l[0].device)
    for j, (r, lt) in enumerate(zip(records_l, lits_l)):
        rows[j, :, :w] = pack_rows(*expand_records(r, lt, h * w)).reshape(h, w)
    return recon_rows(rows, w)
