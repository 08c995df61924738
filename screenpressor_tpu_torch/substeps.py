"""Per-record substep schedules of the record codecs — PyTorch port of
`screenpressor_tpu/jx/substeps.py` (format-normative).

For each substep j of a record a codec names a (table kind, row) pair and a
symbol, derived from the record fields and the lane state. The plain
section coder (`coder.py`) runs these on [K] lane tensors. The CUDA section
kernels (`csrc/sections.cu`, `codec_*` device functions) carry the same
schedule in C++ and are held to these functions by the kernel-vs-plain
checks. `rec`/`partial` are lists of per-field lane tensors, `state` a
tuple of lane tensors.
"""

from __future__ import annotations

import torch

from screenpressor_tpu_torch.config import (
    COL_COMPACT_BUCKETS,
    COLOR_CTX_ROWS,
    MV_OFFSET,
    color_ctx,
)


def _where(c, a, b):
    return torch.where(c, a, b)


class Rec:
    """(ptype, run): ptype conditioned on the lane's previous ptype; the
    run length (n-1) conditioned on the ptype."""

    name = "rec"
    kinds = ("ptype", "nrun")
    rec_width = 2
    cid = 0  # codec id in csrc/sections.cu

    def init_state(self, z):
        return (z,)

    def enc_syms(self, j, rec, state):
        if j == 0:
            return state[0], rec[0], None
        return rec[0], rec[1] - 1, None

    def dec_row(self, j, partial, state):
        return (state[0] if j == 0 else partial[0]), None

    def dec_finish(self, partial, state, active):
        rec = [partial[0], partial[1] + 1]
        return rec, (_where(active, partial[0], state[0]),)

    def enc_next_state(self, rec, state, active):
        return (_where(active, rec[0], state[0]),)


class Col:
    """RGB literal triples with the stream-local context chain
    (FORMAT.md "Color context"): R | (prevG, prevB), G | (prevB, R),
    B | (R, G); each plane's rows live in its own COLOR_CTX_ROWS window."""

    name = "col"
    kinds = ("color", "color", "color")
    rec_width = 3
    cid = 1

    def init_state(self, z):
        return (z, z)  # (prevg, prevb)

    def _row(self, j, parts, state):
        prevg, prevb = state
        if j == 0:
            return color_ctx(prevg, prevb)
        if j == 1:
            return COLOR_CTX_ROWS + color_ctx(prevb, parts[0])
        return 2 * COLOR_CTX_ROWS + color_ctx(parts[0], parts[1])

    def enc_syms(self, j, rec, state):
        return self._row(j, rec, state), rec[j], None

    def dec_row(self, j, partial, state):
        return self._row(j, partial, state), None

    def dec_finish(self, partial, state, active):
        new = (partial[1], partial[2])
        return list(partial), tuple(
            _where(active, n, s) for n, s in zip(new, state))

    def enc_next_state(self, rec, state, active):
        new = (rec[1], rec[2])
        return tuple(_where(active, n, s) for n, s in zip(new, state))


class BT:
    """(block type, run): both on fixed rows."""

    name = "bt"
    kinds = ("bt", "btn")
    rec_width = 2
    cid = 2

    def init_state(self, z):
        return (z,)

    def enc_syms(self, j, rec, state):
        zero = torch.zeros_like(state[0])
        return (zero, rec[0], None) if j == 0 else (zero, rec[1] - 1, None)

    def dec_row(self, j, partial, state):
        return torch.zeros_like(state[0]), None

    def dec_finish(self, partial, state, active):
        return [partial[0], partial[1] + 1], state

    def enc_next_state(self, rec, state, active):
        return state


class Sxy:
    """Sub-rect coordinates: component i on row i."""

    name = "sxy"
    kinds = ("sxy", "sxy", "sxy", "sxy")
    rec_width = 4
    cid = 3

    def init_state(self, z):
        return (z,)

    def enc_syms(self, j, rec, state):
        return torch.full_like(state[0], j), rec[j], None

    def dec_row(self, j, partial, state):
        return torch.full_like(state[0], j), None

    def dec_finish(self, partial, state, active):
        return list(partial), state

    def enc_next_state(self, rec, state, active):
        return state


class MV:
    """(mx, my) with the lane-local same-as-previous flag; the component
    substeps are conditional on the flag."""

    name = "mv"
    kinds = ("mvflag", "mv", "mv")
    rec_width = 2
    cid = 4

    def init_state(self, z):
        return (z, z)  # last (mx, my)

    def enc_syms(self, j, rec, state):
        same = (rec[0] == state[0]) & (rec[1] == state[1])
        if j == 0:
            return torch.zeros_like(state[0]), same.to(torch.int32), None
        return torch.full_like(state[0], j - 1), rec[j - 1] + MV_OFFSET, ~same

    def dec_row(self, j, partial, state):
        if j == 0:
            return torch.zeros_like(state[0]), None
        skip = partial[0] == 1
        return torch.full_like(state[0], j - 1), ~skip

    def dec_finish(self, partial, state, active):
        same = partial[0] == 1
        mx = _where(same, state[0], partial[1] - MV_OFFSET)
        my = _where(same, state[1], partial[2] - MV_OFFSET)
        return [mx, my], (
            _where(active, mx, state[0]),
            _where(active, my, state[1]),
        )

    def enc_next_state(self, rec, state, active):
        return (
            _where(active, rec[0], state[0]),
            _where(active, rec[1], state[1]),
        )


class ColW(Col):
    """Encoder-internal compact-color variant of `Col` (not a format
    change): records carry 3 extra fields, this section's color rows
    remapped into a compact touched-row table (`coder.color_compact_streams`).
    The coding distributions, and so the bytes, are those of `Col` over the
    full table; only the table indexing changes. Encode-only: a decoder's
    rows depend on the symbols it decodes, so decoders run `Col`."""

    rec_width = 6
    cid = 5
    compact_rows = 0  # set per registered bucket

    def init_state(self, z):
        return ()

    def enc_syms(self, j, rec, state):
        return rec[3 + j], rec[j], None

    def enc_next_state(self, rec, state, active):
        return ()

    def dec_row(self, j, partial, state):
        raise NotImplementedError("colw is encode-only; decoders use 'col'")

    def dec_finish(self, partial, state, active):
        raise NotImplementedError("colw is encode-only; decoders use 'col'")


SUBSTEP_CODECS = {"rec": Rec(), "col": Col(), "bt": BT(), "sxy": Sxy(),
                  "mv": MV()}
for _rows in COL_COMPACT_BUCKETS:
    SUBSTEP_CODECS[f"colw{_rows}"] = type(
        f"ColW{_rows}", (ColW,), {"name": f"colw{_rows}", "compact_rows": _rows})()
