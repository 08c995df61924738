"""Wrappers of the fused section kernels K1 (encode) and K2 (decode),
`csrc/sections.cu`, replacing the Pallas kernels of
`screenpressor_tpu/jx/kernels.py` (`encode_sections_fused`,
`decode_sections_fused`).

Same contracts as the plain coder in `coder.py` (`model_scan` +
`rans_pack`, `decode_section_scan`), which is their plain version. A launch
runs one thread block per section; the sections of one launch must use
disjoint table kinds (a frame's sections do: ptype/nrun, color, bt/btn,
sxy, mvflag/mv), so consecutive sections are grouped greedily by that rule.
The kernels update copies of the tables they touch in place; the input
tables are never written.
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu.config import (
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


def _tables_copy(tables: dict, kinds) -> tuple[dict, list]:
    """Copies of the tables of `kinds` (the kernel's in-place targets) and
    the table part of the launch descriptor."""
    out = dict(tables)
    desc = [STEP, STEP, MIX_ESC_C, COLOR_CTX_BITS_A, COLOR_CTX_BITS_B]
    for kd in KIND_ORDER:
        if kd not in kinds:
            desc += [0, 0, 0, 0, 0, 0]
            continue
        tab = {key: v.clone() for key, v in tables[kd].items()}
        for v in tab.values():
            if v.dtype != I32 or not v.is_cuda:
                raise ValueError(f"table {kd}: int32 CUDA tensors expected")
        out[kd] = tab
        rows, alpha = tab["cnt"].shape
        mixed = "gcnt" in tab
        desc += [tab["cnt"].data_ptr(), tab["cntsum"].data_ptr(),
                 tab["gcnt"].data_ptr() if mixed else 0,
                 tab["gsum"].data_ptr() if mixed else 0, rows, alpha]
    return out, desc


def _check_section(name, k, t, recs_or_pay, lens):
    if not 1 <= k <= MAX_LANES or t < 1:
        raise ValueError(f"section {name}: k={k}, t={t} outside the kernel's range")
    _build.require_cuda(recs_or_pay, lens)
    if lens.dtype != I32 or lens.shape != (k,):
        raise ValueError(f"section {name}: lens must be int32 [{k}]")


def encode_sections_kernel(dealt_list, lens_list, tables: dict, kts):
    """K1: dealt [T, K, W] int32 records + lens [K] per section ->
    (bufs [K, cap] uint8, starts [K] int32, tables')."""
    bufs, starts = [None] * len(kts), [None] * len(kts)
    for group in _groups(kts):
        kinds = {kd for i in group for kd in CODECS[kts[i][0]].kinds}
        tables, desc = _tables_copy(tables, kinds)
        keep = []
        for i in group:
            name, k, t = kts[i]
            codec = CODECS[name]
            recs = dealt_list[i].to(I32).contiguous()
            lens = lens_list[i]
            _check_section(name, k, t, recs, lens)
            if recs.shape != (t, k, codec.rec_width):
                raise ValueError(f"section {name}: records {tuple(recs.shape)}")
            cap = pack_cap(name, t)
            iv = torch.empty((t, k, len(codec.kinds)), dtype=I32, device=recs.device)
            bufs[i] = torch.zeros((k, cap), dtype=torch.uint8, device=recs.device)
            starts[i] = torch.empty(k, dtype=I32, device=recs.device)
            desc += [codec.cid, k, t, cap, recs.data_ptr(), lens.data_ptr(),
                     iv.data_ptr(), bufs[i].data_ptr(), starts[i].data_ptr(), 0]
            keep += [recs, iv]
        d = np.asarray(desc, np.int64)
        _build.launch("sptc_sections_encode", d.ctypes.data, len(group))
    return bufs, starts, tables


def decode_sections_kernel(pay_list, lens_list, tables: dict, kts):
    """K2: payload [K, L] uint8 (L >= 4) + lens [K] per section ->
    (records [T, K, W] int32 list, tables')."""
    recs = [None] * len(kts)
    for group in _groups(kts):
        kinds = {kd for i in group for kd in CODECS[kts[i][0]].kinds}
        tables, desc = _tables_copy(tables, kinds)
        keep = []
        for i in group:
            name, k, t = kts[i]
            pay = pay_list[i].contiguous()
            lens = lens_list[i]
            _check_section(name, k, t, pay, lens)
            if pay.dtype != torch.uint8 or pay.shape[0] != k or pay.shape[1] < 4:
                raise ValueError(f"section {name}: payload {tuple(pay.shape)}")
            recs[i] = torch.empty((t, k, CODECS[name].rec_width), dtype=I32,
                                  device=pay.device)
            desc += [CODECS[name].cid, k, t, pay.shape[1], recs[i].data_ptr(),
                     lens.data_ptr(), 0, 0, 0, pay.data_ptr()]
            keep.append(pay)
        d = np.asarray(desc, np.int64)
        _build.launch("sptc_sections_decode", d.ctypes.data, len(group))
    return recs, tables
