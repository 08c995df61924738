"""K-lane BSAC section coder — PyTorch port of `screenpressor_tpu/jx/coder.py`.

Lane geometry (format-normative contiguous chunking), the plain section
coder and the kernel dispatch. The plain coder is a Python loop over the T
steps of a section: `model_scan` + `rans_pack` is the plain version of the
fused encode kernel K1, `decode_section_scan` that of the fused decode
kernel K2 (`kernels.py`). `encode_sections_streams` /
`decode_sections_streams` code the sections of a batch of streams, whose
[S, ...] tables they update in place: the plain coder's stream loop on CPU
tensors, the kernels on CUDA tensors; there is no other switch.
`encode_sections` / `decode_sections` (one stream, functional) are their
one-stream case on copies of the tables.

The col section may be encoded over a compact touched-row color table
(`colw256` / `colw1024`, `color_compact_streams`) whenever the rows it can
touch fit a bucket: same bytes and same table state as `col` over the full
table.

Shapes: records are dealt to [T, K, W] int32 with T = ceil(n / K) (masked
padding steps never change a stream, so any T >= ceil(n / K) gives the same
bytes; a batch of streams takes the largest T; `deal_streams` deals the
ragged records of C streams to [C, T, K, W] in one gather, `undeal_streams`
takes them back); payloads are [K, L] uint8 with L >= 4.
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu_torch.config import (
    COL_COMPACT_BUCKETS,
    COLOR_CTX_ROWS,
    PROB_BITS,
    PROB_SCALE,
    RANS_L,
    color_ctx,
    kind_gstep,
    kind_step,
)
from screenpressor_tpu_torch.substeps import SUBSTEP_CODECS as CODECS
from screenpressor_tpu_torch.tables import effective_rows, update_batch
from screenpressor_tpu_torch.transfer import to_device

MASK = PROB_SCALE - 1
X_MAX_SHIFT = 23 - PROB_BITS + 8
U32_MASK = 0xFFFFFFFF
I32 = torch.int32


# ---------------------------------------------------------------------------
# Lane geometry (mirrors config.lane_ranges)
# ---------------------------------------------------------------------------


def steps_for(n: int, k: int) -> int:
    """Scan steps of a section of n records over k lanes (shape only)."""
    return max(-(-n // k), 1)


def lane_lens(n: int, k: int, device) -> torch.Tensor:
    base, rem = divmod(n, k)
    return (base + (torch.arange(k, device=device) < rem)).to(I32)


def gather_order(n: int, k: int):
    """Global record index -> (lane, step) under contiguous chunking."""
    base, rem = divmod(n, k)
    g = np.arange(n)
    cut = rem * (base + 1)
    lane = np.where(g < cut, g // (base + 1), rem + (g - cut) // max(base, 1))
    t = np.where(g < cut, g % (base + 1), (g - cut) % max(base, 1))
    return lane.astype(np.int64), t.astype(np.int64)


def deal(records_cap: torch.Tensor, n: int, k: int, t: int) -> torch.Tensor:
    """[N, W] records (first n valid) -> [t, k, W]; padding slots are 0: the
    one-stream case of deal_streams."""
    dev = records_cap.device
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    return deal_streams(records_cap, zero, torch.full((1,), n, device=dev), k, t)[0]


def deal_streams(records: torch.Tensor, off: torch.Tensor, n: torch.Tensor, k: int,
                 t: int) -> torch.Tensor:
    """Ragged records [N, W] of C streams (stream c's n[c] records from row
    off[c]; off, n [C] tensors) -> [C, t, k, W] in one gather, each stream
    dealt over k lanes by contiguous chunking; padding slots are 0 (the
    counterpart of undeal_streams)."""
    total, width = records.shape
    c = off.shape[0]
    dev = records.device
    if total == 0:
        return torch.zeros((c, t, k, width), dtype=I32, device=dev)
    n = n.to(device=dev, dtype=torch.int64)[:, None]
    base, rem = n // k, n % k
    lane = torch.arange(k, device=dev)[None, :]
    start = off.to(device=dev, dtype=torch.int64)[:, None] + lane * base + torch.minimum(lane, rem)
    lens = base + (lane < rem)  # [C, k]
    step = torch.arange(t, device=dev)[None, :, None]
    src = start[:, None, :] + step  # [C, t, k]
    valid = step < lens[:, None, :]
    rows = records[src.clamp(0, total - 1)]
    return torch.where(valid[..., None], rows, 0).to(I32)


def lane_lens_streams(n: torch.Tensor, k: int) -> torch.Tensor:
    """Record counts n [C] (a tensor) -> lane lengths [C, k] int32."""
    n = n.long()[:, None]
    return (n // k + (torch.arange(k, device=n.device) < n % k)).to(I32)


def undeal(scan_out: torch.Tensor, n: int, k: int, cap: int) -> torch.Tensor:
    """[t, k, W] scan outputs -> [cap, W] in global record order (rows >= n
    are zero): the one-stream case of undeal_streams."""
    n_t = torch.full((1,), n, dtype=torch.int64, device=scan_out.device)
    return undeal_streams(scan_out[None], n_t, k, cap)[0]


def undeal_streams(scan_out: torch.Tensor, n: torch.Tensor, k: int,
                   cap: int) -> torch.Tensor:
    """Stream-batched [C, t, k, W] scan outputs and record counts n [C] (a
    tensor) -> [C, cap, W] in global record order; the rows at or past a
    stream's own n are zero."""
    c, t = scan_out.shape[:2]
    dev = scan_out.device
    n = n.to(device=dev, dtype=torch.int64)[:, None]
    base, rem = n // k, n % k
    g = torch.arange(cap, device=dev)[None, :]
    cut = rem * (base + 1)
    head = g < cut
    tail = (g - cut).clamp_min(0)
    lane = torch.where(head, g // (base + 1), rem + tail // base.clamp_min(1))
    step = torch.where(head, g % (base + 1), tail % base.clamp_min(1))
    sid = torch.arange(c, device=dev)[:, None]
    vals = scan_out[sid, step.clamp(0, t - 1), lane.clamp(0, k - 1)]
    return torch.where((g < n)[..., None], vals, 0)


# ---------------------------------------------------------------------------
# Plain section coder (the plain versions of K1 and K2)
# ---------------------------------------------------------------------------


def _exclusive_cum(freq_rows):
    return torch.cumsum(freq_rows, dim=1, dtype=I32) - freq_rows


def _own_tables(tables: dict, kinds) -> dict:
    """The table set with copies of `kinds`, which a scan then updates in
    place (the caller's tables are never written)."""
    out = dict(tables)
    for kd in set(kinds):
        out[kd] = {key: v.clone() for key, v in tables[kd].items()}
    return out


def model_scan(recs: torch.Tensor, lens: torch.Tensor, tables: dict,
               codec_name: str):
    """Forward modeling pass: records [T, K, W] -> (cum, freq, act)
    [T, K, S] and the updated tables."""
    codec = CODECS[codec_name]
    t_steps, k, _ = recs.shape
    state = codec.init_state(torch.zeros(k, dtype=I32, device=recs.device))
    tables = _own_tables(tables, codec.kinds)
    cums, freqs, acts = [], [], []
    for t in range(t_steps):
        rec_l = [recs[t, :, j] for j in range(codec.rec_width)]
        lane_active = t < lens
        for j, kind in enumerate(codec.kinds):
            tab = tables[kind]
            row, sym, extra = codec.enc_syms(j, rec_l, state)
            active = lane_active if extra is None else (lane_active & extra)
            row = row.clamp(0, tab["cnt"].shape[0] - 1)
            symc = sym.clamp(0, tab["cnt"].shape[1] - 1)
            freq_rows = effective_rows(tab, row)
            cum_rows = _exclusive_cum(freq_rows)
            sidx = symc.long()[:, None]
            cums.append(cum_rows.gather(1, sidx)[:, 0])
            freqs.append(freq_rows.gather(1, sidx)[:, 0])
            acts.append(active)
            tables[kind] = update_batch(tab, row, symc, active,
                                        kind_step(kind), kind_gstep(kind), inplace=True)
        state = codec.enc_next_state(rec_l, state, lane_active)
    s = len(codec.kinds)

    def stack(v):
        return torch.stack(v).reshape(t_steps, s, k).transpose(1, 2).contiguous()

    return stack(cums), stack(freqs), stack(acts), tables


def rans_pack(cum: torch.Tensor, freq: torch.Tensor, act: torch.Tensor,
              cap: int):
    """Reverse rANS pack: intervals [T, K, S] -> (buf [K, cap] uint8,
    start [K] int32). Lane blob = buf[k, start[k]:], state flush first.
    The coder state is uint32; int64 holds it exactly."""
    t_steps, k, s = cum.shape
    dev = cum.device
    x = torch.full((k,), RANS_L, dtype=torch.int64, device=dev)
    pos = torch.full((k,), cap, dtype=torch.int64, device=dev)
    buf = torch.zeros((k, cap + 1), dtype=torch.uint8, device=dev)
    lanes = torch.arange(k, device=dev)

    def emit(byte, do):
        nonlocal pos
        pos = torch.where(do, pos - 1, pos)
        # lanes not emitting write the spare column `cap`, cut below
        buf[lanes, torch.where(do, pos, cap)] = (byte & 0xFF).to(torch.uint8)

    cum64, freq64 = cum.long(), freq.long()
    for t in range(t_steps - 1, -1, -1):
        for j in range(s - 1, -1, -1):
            a = act[t, :, j]
            f = freq64[t, :, j]
            c = cum64[t, :, j]
            x_max = torch.where(a, f << X_MAX_SHIFT, U32_MASK)
            for _ in range(2):
                do = x >= x_max
                emit(x, do)
                x = torch.where(do, x >> 8, x)
            fx = f.clamp_min(1)
            nx = ((x // fx) << PROB_BITS) + (x % fx) + c
            x = torch.where(a, nx & U32_MASK, x)
    for i in (3, 2, 1, 0):
        emit(x >> (8 * i), torch.ones(k, dtype=torch.bool, device=dev))
    return buf[:, :cap].contiguous(), pos.to(I32)


def decode_section_scan(payload: torch.Tensor, lens: torch.Tensor,
                        tables: dict, codec_name: str, t_steps: int):
    """payload [K, L] uint8 lane blobs (zero padded); lens [K] records per
    lane. Returns (records [T, K, W] int32, tables')."""
    codec = CODECS[codec_name]
    k, plen = payload.shape
    dev = payload.device
    lanes = torch.arange(k, device=dev)
    p = payload[:, :4].long()
    x = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | (p[:, 3] << 24)
    pos = torch.full((k,), 4, dtype=torch.int64, device=dev)
    state = codec.init_state(torch.zeros(k, dtype=I32, device=dev))
    tables = _own_tables(tables, codec.kinds)
    out = []
    for t in range(t_steps):
        lane_active = t < lens
        partial = []
        for j, kind in enumerate(codec.kinds):
            tab = tables[kind]
            row, extra = codec.dec_row(j, partial, state)
            active = lane_active if extra is None else (lane_active & extra)
            row = row.clamp(0, tab["cnt"].shape[0] - 1)
            freq_rows = effective_rows(tab, row)
            cum_rows = _exclusive_cum(freq_rows)
            sf = (x & MASK).to(I32)
            sym = (cum_rows[:, 1:] <= sf[:, None]).sum(dim=1, dtype=I32)
            sidx = sym.long()[:, None]
            cum = cum_rows.gather(1, sidx)[:, 0].long()
            freq = freq_rows.gather(1, sidx)[:, 0].long()
            xx = (freq * (x >> PROB_BITS) + (x & MASK) - cum) & U32_MASK
            for _ in range(2):
                need = (xx < RANS_L) & active
                b = payload[lanes, pos.clamp(max=plen - 1)].long()
                xx = torch.where(need, ((xx << 8) | b) & U32_MASK, xx)
                pos = torch.where(need, pos + 1, pos)
            x = torch.where(active, xx, x)
            sym = torch.where(active, sym, 0)
            partial.append(sym)
            tables[kind] = update_batch(tab, row, sym, active,
                                        kind_step(kind), kind_gstep(kind), inplace=True)
        rec_l, state = codec.dec_finish(partial, state, lane_active)
        out.append(torch.stack(rec_l, dim=1))
    return torch.stack(out).to(I32), tables


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors -> plain coder, CUDA tensors -> kernels K1/K2
# ---------------------------------------------------------------------------


def pack_cap(codec_name: str, t_steps: int) -> int:
    """Bytes a lane can emit: <= 2 per substep plus the 4-byte flush."""
    return 2 * t_steps * len(CODECS[codec_name].kinds) + 8


# ---------------------------------------------------------------------------
# A batch of streams: the serving sessions' section coder
# ---------------------------------------------------------------------------


def _stream_tables(tables_b: dict, j: int, s: int, slot_kinds, kinds) -> dict:
    """Views of one stream's tables of `kinds` (slot j's for slot_kinds)."""
    return {kd: {key: v[j if kd in slot_kinds else s] for key, v in tables_b[kd].items()}
            for kd in kinds}


def _write_back(views: dict, tables: dict) -> None:
    for kd, tab in views.items():
        for key, v in tab.items():
            v.copy_(tables[kd][key])


def encode_sections_streams(dealt_list, lens_list, tables_b: dict, kts, sidx,
                            col_w=None, col_bm=None):
    """Encode the sections of C streams, one launch per section group.

    dealt_list: [C, T, K, W] per section; lens_list: [C, K]; sidx: the C
    (distinct) stream ids of `tables_b` [S, ...], whose tables are updated in
    place; col_bm: [C, 3 * COLOR_CTX_ROWS] touched-row bitmaps when col_w is
    set. Returns (bufs [C, K, cap] uint8, starts [C, K] int32) per section.
    The plain version (CPU tensors) is the stream loop of `model_scan` +
    `rans_pack`."""
    sidx = [int(v) for v in sidx]
    tabs, slot_kinds, compact = tables_b, (), None
    if col_w is not None and any(name == "col" for name, _, _ in kts):
        i = next(j for j, (name, _, _) in enumerate(kts) if name == "col")
        recs_c, ctab_c, maps = color_compact_streams(
            dealt_list[i], lens_list[i], col_bm, tables_b["color"], sidx, col_w)
        dealt_list = list(dealt_list)
        dealt_list[i] = recs_c
        kts = tuple((f"colw{col_w}", k, t) if j == i else (name, k, t)
                    for j, (name, k, t) in enumerate(kts))
        tabs, slot_kinds, compact = {**tables_b, "color": ctab_c}, ("color",), (ctab_c, maps)
    if dealt_list[0].is_cuda:
        from screenpressor_tpu_torch import kernels

        bufs, starts = kernels.encode_sections_streams_kernel(
            dealt_list, lens_list, tabs, kts, sidx, slot_kinds)
    else:
        bufs, starts = encode_sections_streams_plain(dealt_list, lens_list, tabs, kts,
                                                     sidx, slot_kinds)
    if compact is not None:
        color_restore_streams(tables_b["color"], sidx, *compact)
    return bufs, starts


def decode_sections_streams(pay_list, lens_list, tables_b: dict, kts, sidx):
    """Decode the sections of C streams, one launch per section group.

    pay_list: [C, K, L] uint8 per section; lens_list: [C, K]; the tables of
    streams `sidx` in `tables_b` [S, ...] are updated in place. Returns
    records [C, T, K, W] per section. The plain version (CPU tensors) is the
    stream loop of `decode_section_scan`."""
    sidx = [int(v) for v in sidx]
    if pay_list[0].is_cuda:
        from screenpressor_tpu_torch import kernels

        return kernels.decode_sections_streams_kernel(pay_list, lens_list, tables_b,
                                                      kts, sidx)
    return decode_sections_streams_plain(pay_list, lens_list, tables_b, kts, sidx)


def encode_sections_streams_plain(dealt_list, lens_list, tables_b: dict, kts, sidx,
                                  slot_kinds=()):
    """Plain version of the stream-batched K1 launch (any device): the
    stream loop of model_scan + rans_pack, each stream's tables written back
    in place (slot_kinds: kinds whose tables are per slot)."""
    kinds = {kd for name, _, _ in kts for kd in CODECS[name].kinds}
    per = []
    for j, s in enumerate(sidx):
        views = _stream_tables(tables_b, j, s, slot_kinds, kinds)
        tabs, out = views, []
        for (name, _k, t), recs, lens in zip(kts, dealt_list, lens_list):
            cum, freq, act, tabs = model_scan(recs[j], lens[j], tabs, name)
            out.append(rans_pack(cum, freq, act, pack_cap(name, t)))
        _write_back(views, tabs)
        per.append(out)
    return ([torch.stack([p[i][0] for p in per]) for i in range(len(kts))],
            [torch.stack([p[i][1] for p in per]) for i in range(len(kts))])


def decode_sections_streams_plain(pay_list, lens_list, tables_b: dict, kts, sidx):
    """Plain version of the stream-batched K2 launch (any device): the
    stream loop of decode_section_scan, each stream's tables written back in
    place."""
    kinds = {kd for name, _, _ in kts for kd in CODECS[name].kinds}
    per = []
    for j, s in enumerate(sidx):
        views = _stream_tables(tables_b, j, s, (), kinds)
        tabs, out = views, []
        for (name, _k, t), pay, lens in zip(kts, pay_list, lens_list):
            recs, tabs = decode_section_scan(pay[j], lens[j], tabs, name, t)
            out.append(recs)
        _write_back(views, tabs)
        per.append(out)
    return [torch.stack([p[i] for p in per]) for i in range(len(kts))]


def _one_stream(tables: dict, kts) -> dict:
    """Copies [1, ...] of the tables the sections touch, for the
    stream-batched coder to update."""
    kinds = {kd for name, _, _ in kts for kd in CODECS[name].kinds}
    return {kd: {key: v[None].clone() for key, v in tables[kd].items()} for kd in kinds}


def _from_one_stream(tables: dict, tabs: dict) -> dict:
    return {**tables, **{kd: {key: v[0] for key, v in tab.items()} for kd, tab in tabs.items()}}


def encode_sections(dealt_list, lens_list, tables: dict, kts, col_w=None,
                    col_bm=None):
    """Encode the sections of one stream in order with chained tables: the
    one-stream case of `encode_sections_streams`.

    kts: tuple of (codec_name, k, t_steps). col_w / col_bm: a compact color
    bucket (`col_compact_bucket`) and the col section's touched-row bitmap
    (`color_touched_bitmap`), to encode that section as colw. Returns (bufs
    [K, cap] uint8, starts [K] int32, tables') as lists aligned with kts;
    the input tables are not written."""
    tabs = _one_stream(tables, kts)
    bufs, starts = encode_sections_streams(
        [d[None] for d in dealt_list], [ln[None] for ln in lens_list], tabs, kts, [0],
        col_w, None if col_bm is None else col_bm[None])
    return [b[0] for b in bufs], [st[0] for st in starts], _from_one_stream(tables, tabs)


def decode_sections(pay_list, lens_list, tables: dict, kts):
    """Decode the sections of one stream in order with chained tables (the
    one-stream case of `decode_sections_streams`) -> (records [T, K, W]
    list, tables'); the input tables are not written."""
    tabs = _one_stream(tables, kts)
    recs = decode_sections_streams([p[None] for p in pay_list],
                                   [ln[None] for ln in lens_list], tabs, kts, [0])
    return [r[0] for r in recs], _from_one_stream(tables, tabs)


# ---------------------------------------------------------------------------
# Compact color-table encode (colw)
# ---------------------------------------------------------------------------


def color_touched_bitmap(lits: torch.Tensor, n_lit) -> torch.Tensor:
    """[3 * COLOR_CTX_ROWS] bool superset of the color rows a col section
    over these literals can touch, for any lane count (jx/coder.py
    color_touched_bitmap): the global previous-literal chain covers every
    lane-interior step; a lane's first step sees state (0, 0), so row 0 and
    plane 1's color_ctx(0, R) are included; row 0 is also where padding
    steps park. lits: [cap, 3] in record order, the first n_lit valid. The
    one-stream case of color_touched_bitmap_streams."""
    dev = lits.device
    sid = torch.zeros(lits.shape[0], dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    n = (n_lit.reshape(1) if isinstance(n_lit, torch.Tensor)
         else torch.full((1,), n_lit, device=dev))
    return color_touched_bitmap_streams(lits, sid, zero, n)[0]


def color_touched_bitmap_streams(lits: torch.Tensor, sid: torch.Tensor, off: torch.Tensor,
                                 n: torch.Tensor) -> torch.Tensor:
    """color_touched_bitmap of C streams' ragged literals: lits [N, 3], the
    stream sid [N] of each row, stream c's n[c] literals in record order
    from row off[c] (off, n [C] tensors) -> [C, 3 * COLOR_CTX_ROWS] bool.
    A stream's previous-literal chain starts at (0, 0) on its first row."""
    c = off.shape[0]
    dev = lits.device
    lits = lits.to(I32)
    r, g, b = lits[:, 0], lits[:, 1], lits[:, 2]
    pos = torch.arange(lits.shape[0], device=dev) - off.to(dev)[sid]
    z = torch.zeros(1, dtype=I32, device=dev)
    first = pos == 0
    pg = torch.where(first, 0, torch.cat([z, g[:-1]]))
    pb = torch.where(first, 0, torch.cat([z, b[:-1]]))
    valid = pos < n.to(dev)[sid]
    nrows = 3 * COLOR_CTX_ROWS
    bm = torch.zeros((c, nrows), dtype=torch.bool, device=dev)
    flat = bm.view(-1)
    for rows in (color_ctx(pg, pb), COLOR_CTX_ROWS + color_ctx(pb, r),
                 COLOR_CTX_ROWS + color_ctx(torch.zeros_like(r), r),
                 2 * COLOR_CTX_ROWS + color_ctx(r, g)):
        # index_fill_: an indexed store of a Python scalar synchronises with the card
        flat.index_fill_(0, sid * nrows + torch.where(valid, rows, 0).long(), True)
    bm[:, 0] = True
    return bm


def col_compact_bucket(n_touch: int):
    """Smallest compact bucket that holds n_touch rows and is smaller than
    a plane's row window, or None (full table)."""
    for b in COL_COMPACT_BUCKETS:
        if n_touch <= b < COLOR_CTX_ROWS:
            return b
    return None


def _col_rows_exact(recs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Color rows `Col` reads for dealt records [..., T, K, 3] with lens
    [..., K]; padding steps park on row 0."""
    r, g, b = recs[..., 0], recs[..., 1], recs[..., 2]
    z = torch.zeros_like(g[..., :1, :])
    pg = torch.cat([z, g[..., :-1, :]], dim=-2)
    pb = torch.cat([z, b[..., :-1, :]], dim=-2)
    rows = torch.stack([color_ctx(pg, pb), COLOR_CTX_ROWS + color_ctx(pb, r),
                        2 * COLOR_CTX_ROWS + color_ctx(r, g)], dim=-1)
    t = torch.arange(recs.shape[-3], device=recs.device)[:, None]
    active = t < lens[..., None, :]
    return torch.where(active[..., None], rows, 0).to(I32)


def color_compact_streams(recs: torch.Tensor, lens: torch.Tensor, bm: torch.Tensor,
                          ctab_b: dict, sidx, col_w: int):
    """Rewrite the col sections of C streams to the colw form.

    recs [C, T, K, 3], lens [C, K], bm [C, 3 * COLOR_CTX_ROWS] touched-row
    bitmaps (at most col_w rows each, row 0 included), ctab_b the color
    tables [S, ...] of which streams sidx are encoded. Returns (records
    [C, T, K, 6] with each color row remapped to its compact slot, the
    compact tables {cnt [C, col_w, A], cntsum [C, col_w], gcnt, gsum} per
    slot, maps for `color_restore_streams`).

    Slot i of a stream holds its i-th touched row in ascending order; the
    slots past its touched count are filler that no record indexes. Only the
    touched rows write the row -> slot table, so a touched row never maps to
    a filler slot (the reference's clamp of the filler to the last row,
    jx/coder.py:549, does, when that row is touched)."""
    nrows = 3 * COLOR_CTX_ROWS
    c = recs.shape[0]
    dev = recs.device
    perm = torch.where(bm, torch.arange(nrows, device=dev), nrows).sort(dim=1).values
    perm = perm[:, :col_w]
    valid = perm < nrows
    lut = torch.zeros((c, nrows + 1), dtype=I32, device=dev)  # column nrows: sink
    lut.scatter_(1, perm, torch.arange(col_w, dtype=I32, device=dev).expand(c, col_w))
    rows = _col_rows_exact(recs, lens)
    slots = lut.gather(1, rows.reshape(c, -1).long()).reshape(rows.shape)
    recs_c = torch.cat([recs.to(I32), slots], dim=-1)
    st = to_device(sidx, dev, "coder.color_compact").long()
    src = torch.where(valid, perm, 0)  # filler reads row 0 (never indexed)
    ctab_c = {"cnt": ctab_b["cnt"][st[:, None], src],
              "cntsum": ctab_b["cntsum"][st[:, None], src]}
    for key in ("gcnt", "gsum"):
        if key in ctab_b:
            ctab_c[key] = ctab_b[key][st]
    return recs_c, ctab_c, (st, src, valid)


def color_restore_streams(ctab_b: dict, sidx, ctab_c: dict, maps) -> None:
    """Write compact tables back into the full color tables [S, ...] of
    streams sidx, in place. Filler slots write row 0 with slot 0's values
    (slot 0 always holds row 0), so duplicate writes agree."""
    st, src, valid = maps
    slot = torch.where(valid, torch.arange(src.shape[1], device=src.device), 0)
    cidx = torch.arange(src.shape[0], device=src.device)[:, None]
    sv = st[:, None].expand_as(src)
    ctab_b["cnt"][sv, src] = ctab_c["cnt"][cidx, slot]
    ctab_b["cntsum"][sv, src] = ctab_c["cntsum"][cidx, slot]
    for key in ("gcnt", "gsum"):
        if key in ctab_c:
            ctab_b[key][st] = ctab_c[key]


def pad_lanes(payload, sizes: np.ndarray) -> np.ndarray:
    """Lanes of `sizes` [..., k] bytes, back to back in `payload` in that
    order -> [..., k, L] zero-padded uint8, L = max(largest lane, 4): one
    masked copy."""
    pay = np.zeros(sizes.shape + (max(int(sizes.max(initial=0)), 4),), np.uint8)
    pay[np.arange(pay.shape[-1]) < sizes[..., None]] = np.frombuffer(payload, np.uint8)
    return pay


def pad_payload(blobs, k: int) -> np.ndarray:
    """Lane blobs -> [k, L] zero-padded uint8 (L >= 4)."""
    sizes = np.zeros(k, np.int64)
    sizes[:len(blobs)] = [len(b) for b in blobs]
    return pad_lanes(b"".join(blobs), sizes)


def blobs_from_buf(buf: np.ndarray, start: np.ndarray, lens: np.ndarray):
    return [bytes(buf[i, start[i]:].tobytes()) if lens[i] > 0 else b""
            for i in range(buf.shape[0])]


def encode_section(records: np.ndarray, k: int, tables: dict,
                   codec_name: str, device=None):
    """Host wrapper. records: [n, W] int array. Returns (blobs, tables').
    Runs on the card (`tables` on it) unless `device` says otherwise."""
    device = "cuda" if device is None else device
    codec = CODECS[codec_name]
    n = len(records)
    if n == 0:
        return [b""] * k, tables
    t = steps_for(n, k)
    recs = np.zeros((t, k, codec.rec_width), np.int32)
    lane, step = gather_order(n, k)
    recs[step, lane] = np.asarray(records, np.int32).reshape(n, codec.rec_width)
    lens = lane_lens(n, k, device)
    bufs, starts, tables = encode_sections(
        [torch.as_tensor(recs, device=device)], [lens], tables,
        ((codec_name, k, t),))
    return blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(),
                          lens.cpu().numpy()), tables


def decode_section(blobs, n: int, k: int, tables: dict, codec_name: str,
                   device=None):
    """Host wrapper: returns (records [n, W] np.ndarray, tables'). Runs on
    the card (`tables` on it) unless `device` says otherwise."""
    device = "cuda" if device is None else device
    codec = CODECS[codec_name]
    if n == 0:
        return np.zeros((0, codec.rec_width), np.int32), tables
    t = steps_for(n, k)
    pay = torch.as_tensor(pad_payload(blobs, k), device=device)
    recs, tables = decode_sections([pay], [lane_lens(n, k, device)], tables,
                                   ((codec_name, k, t),))
    lane, step = gather_order(n, k)
    return recs[0].cpu().numpy()[step, lane], tables
