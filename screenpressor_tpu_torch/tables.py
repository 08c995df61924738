"""BSAC adaptive tables — PyTorch port of `screenpressor_tpu/jx/tables.py`.

State is a plain dict {kind: {"cnt" [R, A], "cntsum" [R], ["gcnt" [A],
"gsum" []]}} of int32 tensors, keyed exactly like the JAX pytree (the g
entries exist for mixed kinds, config.MIX_KINDS). The single-stream
functions here are functional: they return new tensors and never write
their inputs, so one renewed table set can be shared by every session on a
device.

A table set for S streams (the serving sessions, `parallel/serving.py`) is
the same dict with a leading [S] axis on every tensor. The session owns it
and updates it in place: `renew_rows` here, the stream-batched section
coder in `coder.py`, which selects the streams of a launch by an index
list of stream ids.
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.config import (
    MIX_ESC_C,
    PROB_SCALE,
    RESCALE_SHIFT,
    STEP,
    TABLE_KINDS,
    kind_gstep,
    kind_mixed,
    kind_step,
)

I32 = torch.int32


def renew_table(rows: int, alphabet: int, device, step: int = STEP,
                name: str = "") -> dict:
    if kind_mixed(name):
        # mixed-kind rows start EMPTY; the global row prices unseen symbols
        g = max((PROB_SCALE - kind_gstep(name) - alphabet) // alphabet, 1)
        return {
            "cnt": torch.zeros((rows, alphabet), dtype=I32, device=device),
            "cntsum": torch.zeros((rows,), dtype=I32, device=device),
            "gcnt": torch.full((alphabet,), g, dtype=I32, device=device),
            "gsum": torch.tensor(g * alphabet, dtype=I32, device=device),
        }
    f = max((PROB_SCALE - step - alphabet) // alphabet, 1)
    return {
        "cnt": torch.full((rows, alphabet), f, dtype=I32, device=device),
        "cntsum": torch.full((rows,), f * alphabet, dtype=I32, device=device),
    }


def renew_tables(device, kinds=TABLE_KINDS) -> dict:
    return {
        name: renew_table(r, a, device, kind_step(name), name)
        for name, (r, a) in kinds.items()
    }


_RENEW_CACHE: dict = {}


def renew_tables_cached(device) -> dict:
    """One renewed table set per device, shared by every session (table
    functions never write their inputs)."""
    key = str(torch.device(device))
    tabs = _RENEW_CACHE.get(key)
    if tabs is None:
        tabs = renew_tables(device)
        _RENEW_CACHE[key] = tabs
    return tabs


def effective_rows(tab: dict, rows: torch.Tensor) -> torch.Tensor:
    """[K, A] coding distribution of the gathered context rows.

    Non-mixed kinds: the live counts. Mixed kinds: the row scaled to a fill
    target that grows with its observation mass, plus the global row scaled
    into the space left. int32 throughout: s <= PROB_SCALE - STEP at read
    time, so (PROB_SCALE - 2A) * s < 2^28 and every `x * scale` product is
    bounded by target << 13 < 2^27."""
    idx = rows.long()
    g = tab["cnt"][idx]
    if "gcnt" not in tab:
        return g
    alphabet = g.shape[1]
    s_obs = tab["cntsum"][idx]
    target = ((PROB_SCALE - 2 * alphabet) * s_obs) // (s_obs + MIX_ESC_C)
    sc_r = (target << RESCALE_SHIFT) // s_obs.clamp_min(1)
    row_eff = (g * sc_r[:, None]) >> RESCALE_SHIFT
    spare = (PROB_SCALE - alphabet) - row_eff.sum(dim=1, dtype=I32)
    sc = (spare << RESCALE_SHIFT) // tab["gsum"].clamp_min(1)
    g_eff = ((tab["gcnt"][None, :] * sc[:, None]) >> RESCALE_SHIFT).clamp_min(1)
    return row_eff + g_eff


def update_batch(tab: dict, rows: torch.Tensor, syms: torch.Tensor,
                 active: torch.Tensor, step: int = STEP,
                 gstep: int = 0, inplace: bool = False) -> dict:
    """One sub-step's batched update of one table kind: every active lane
    adds `step`, then each touched row rescales once from its post-add
    counts. Inactive lanes are parked on row 0 with add 0; the rescale
    predicate is per row, so duplicate writers of a row write identical
    values. inplace writes `tab`'s count tensors (a section scan's own
    copies) instead of copying a whole table each substep."""
    alphabet = tab["cnt"].shape[1]
    rows = torch.where(active, rows, 0).long()
    syms = torch.where(active, syms, 0).long()
    add = active.to(I32) * step
    put = torch.Tensor.index_put_ if inplace else torch.Tensor.index_put
    cnt = put(tab["cnt"], (rows, syms), add, accumulate=True)
    cntsum = put(tab["cntsum"], (rows,), add, accumulate=True)

    c = cnt[rows]
    s = cntsum[rows]
    need = s > PROB_SCALE - step
    target = PROB_SCALE - step - alphabet
    sc = (target << RESCALE_SHIFT) // s.clamp_min(1)
    new_cnt = ((c * sc[:, None]) >> RESCALE_SHIFT).clamp_min(1)
    cnt = put(cnt, (rows,), torch.where(need[:, None], new_cnt, c))
    cntsum = put(cntsum, (rows,), torch.where(need, new_cnt.sum(dim=1, dtype=I32), s))
    out = {"cnt": cnt, "cntsum": cntsum}
    if "gcnt" in tab:
        gadd = active.to(I32) * gstep
        gcnt = tab["gcnt"].index_put((syms,), gadd, accumulate=True)
        gsum = tab["gsum"] + gadd.sum(dtype=I32)
        gneed = gsum > PROB_SCALE - gstep
        gtarget = PROB_SCALE - gstep - alphabet
        gsc = (gtarget << RESCALE_SHIFT) // gsum.clamp_min(1)
        gnew = ((gcnt * gsc) >> RESCALE_SHIFT).clamp_min(1)
        out["gcnt"] = torch.where(gneed, gnew, gcnt)
        out["gsum"] = torch.where(gneed, gnew.sum(dtype=I32), gsum)
    return out


def select_tables(cond: torch.Tensor, a: dict, b: dict) -> dict:
    """Per-tensor where(cond, a, b) over two table sets (device-side
    raw-escape select)."""
    return {
        kd: {key: torch.where(cond, a[kd][key], b[kd][key]) for key in b[kd]}
        for kd in b
    }


# ---------------------------------------------------------------------------
# Stream-batched table sets [S, ...]
# ---------------------------------------------------------------------------


def renew_tables_streams(n_streams: int, device) -> dict:
    """A renewed table set for each of n_streams streams (own memory)."""
    return {kd: {key: v.expand((n_streams,) + v.shape).clone()
                 for key, v in tab.items()}
            for kd, tab in renew_tables_cached(device).items()}


def renew_rows(tables_b: dict, mask) -> None:
    """Renew, in place, the tables of the streams where `mask` [S] holds
    (keyframes, flat transitions, raw escapes)."""
    idx = [int(i) for i in np.nonzero(np.asarray(mask, bool))[0]]
    if not idx:
        return
    fresh = renew_tables_cached(next(iter(tables_b["color"].values())).device)
    for kd, tab in tables_b.items():
        for key, v in tab.items():
            with telemetry.sync("tables.renew_rows"):  # the index list goes up
                v[idx] = fresh[kd][key]


def renew_rows_at(tables_b: dict, idx: torch.Tensor, mask=None) -> None:
    """renew_rows of the streams idx (an index tensor on the tables'
    device), or of those of them where the device mask [len(idx)] holds:
    no host copy."""
    fresh = renew_tables_cached(idx.device)
    for kd, tab in tables_b.items():
        for key, v in tab.items():
            if mask is None:
                v[idx] = fresh[kd][key]
            else:
                m = mask.view((-1,) + (1,) * (v.dim() - 1))
                v[idx] = torch.where(m, fresh[kd][key], v[idx])


def renew_where(tables_b: dict, mask: torch.Tensor) -> None:
    """Renew, in place, the tables of the streams where the device mask
    [S] holds: no host copy."""
    fresh = renew_tables_cached(mask.device)
    for kd, tab in tables_b.items():
        for key, v in tab.items():
            m = mask.view((-1,) + (1,) * (v.dim() - 1))
            torch.where(m, fresh[kd][key], v, out=v)
