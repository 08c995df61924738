"""K-lane BSAC section coder — PyTorch port of `screenpressor_tpu/jx/coder.py`.

Lane geometry (format-normative contiguous chunking), the plain section
coder and the kernel dispatch. The plain coder is a Python loop over the T
steps of a section: `model_scan` + `rans_pack` is the plain version of the
fused encode kernel K1, `decode_section_scan` that of the fused decode
kernel K2 (`kernels.py`). `encode_sections` / `decode_sections` run the
plain coder on CPU tensors and the kernels on CUDA tensors; there is no
other switch.

Shapes: records are dealt to [T, K, W] int32 with T = ceil(n / K) (masked
padding steps never change a stream, so any T >= ceil(n / K) gives the same
bytes); payloads are [K, L] uint8 with L >= 4.
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu.config import PROB_BITS, PROB_SCALE, RANS_L, kind_gstep, kind_step

from screenpressor_tpu_torch.substeps import SUBSTEP_CODECS as CODECS
from screenpressor_tpu_torch.tables import effective_rows, update_batch

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
    """[N, W] records (first n valid) -> [t, k, W]; padding slots are 0."""
    cap, width = records_cap.shape
    dev = records_cap.device
    if cap == 0:
        return torch.zeros((t, k, width), dtype=I32, device=dev)
    base, rem = divmod(n, k)
    lane = torch.arange(k, device=dev)
    start = lane * base + torch.clamp(lane, max=rem)
    lens = base + (lane < rem)
    step = torch.arange(t, device=dev)
    src = start[None, :] + step[:, None]
    valid = step[:, None] < lens[None, :]
    rows = records_cap[src.clamp(0, cap - 1)]
    return torch.where(valid[..., None], rows, 0).to(I32)


def undeal(scan_out: torch.Tensor, n: int, k: int, cap: int) -> torch.Tensor:
    """[t, k, W] scan outputs -> [cap, W] in global record order (rows >= n
    are zero)."""
    t = scan_out.shape[0]
    dev = scan_out.device
    base, rem = divmod(n, k)
    g = torch.arange(cap, device=dev)
    cut = rem * (base + 1)
    lane = torch.where(g < cut, g // max(base + 1, 1),
                       rem + (g - cut) // max(base, 1))
    step = torch.where(g < cut, g % max(base + 1, 1), (g - cut) % max(base, 1))
    vals = scan_out[step.clamp(0, t - 1), lane.clamp(0, k - 1)]
    return torch.where((g < n)[:, None], vals, 0)


# ---------------------------------------------------------------------------
# Plain section coder (the plain versions of K1 and K2)
# ---------------------------------------------------------------------------


def _exclusive_cum(freq_rows):
    return torch.cumsum(freq_rows, dim=1, dtype=I32) - freq_rows


def model_scan(recs: torch.Tensor, lens: torch.Tensor, tables: dict,
               codec_name: str):
    """Forward modeling pass: records [T, K, W] -> (cum, freq, act)
    [T, K, S] and the updated tables."""
    codec = CODECS[codec_name]
    t_steps, k, _ = recs.shape
    state = codec.init_state(torch.zeros(k, dtype=I32, device=recs.device))
    tables = dict(tables)
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
                                        kind_step(kind), kind_gstep(kind))
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
    tables = dict(tables)
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
                                        kind_step(kind), kind_gstep(kind))
        rec_l, state = codec.dec_finish(partial, state, lane_active)
        out.append(torch.stack(rec_l, dim=1))
    return torch.stack(out).to(I32), tables


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors -> plain coder, CUDA tensors -> kernels K1/K2
# ---------------------------------------------------------------------------


def pack_cap(codec_name: str, t_steps: int) -> int:
    """Bytes a lane can emit: <= 2 per substep plus the 4-byte flush."""
    return 2 * t_steps * len(CODECS[codec_name].kinds) + 8


def encode_sections(dealt_list, lens_list, tables: dict, kts):
    """Encode sections in order with chained tables.

    kts: tuple of (codec_name, k, t_steps). Returns (bufs [K, cap] uint8,
    starts [K] int32, tables') as lists aligned with kts."""
    if dealt_list[0].is_cuda:
        from screenpressor_tpu_torch import kernels

        return kernels.encode_sections_kernel(dealt_list, lens_list, tables, kts)
    bufs, starts = [], []
    for (name, _k, t), recs, lens in zip(kts, dealt_list, lens_list):
        cum, freq, act, tables = model_scan(recs, lens, tables, name)
        buf, start = rans_pack(cum, freq, act, pack_cap(name, t))
        bufs.append(buf)
        starts.append(start)
    return bufs, starts, tables


def decode_sections(pay_list, lens_list, tables: dict, kts):
    """Decode sections in order with chained tables -> (records [T, K, W]
    list, tables')."""
    if pay_list[0].is_cuda:
        from screenpressor_tpu_torch import kernels

        return kernels.decode_sections_kernel(pay_list, lens_list, tables, kts)
    recs = []
    for (name, _k, t), pay, lens in zip(kts, pay_list, lens_list):
        r, tables = decode_section_scan(pay, lens, tables, name, t)
        recs.append(r)
    return recs, tables


def pad_payload(blobs, k: int) -> np.ndarray:
    """Lane blobs -> [k, L] zero-padded uint8 (L >= 4)."""
    max_len = max(max((len(b) for b in blobs), default=0), 4)
    pay = np.zeros((k, max_len), np.uint8)
    for i, b in enumerate(blobs):
        pay[i, : len(b)] = np.frombuffer(b, np.uint8)
    return pay


def blobs_from_buf(buf: np.ndarray, start: np.ndarray, lens: np.ndarray):
    return [bytes(buf[i, start[i]:].tobytes()) if lens[i] > 0 else b""
            for i in range(buf.shape[0])]


def encode_section(records: np.ndarray, k: int, tables: dict,
                   codec_name: str, device="cpu"):
    """Host wrapper. records: [n, W] int array. Returns (blobs, tables')."""
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
                   device="cpu"):
    """Host wrapper: returns (records [n, W] np.ndarray, tables')."""
    codec = CODECS[codec_name]
    if n == 0:
        return np.zeros((0, codec.rec_width), np.int32), tables
    t = steps_for(n, k)
    pay = torch.as_tensor(pad_payload(blobs, k), device=device)
    recs, tables = decode_sections([pay], [lane_lens(n, k, device)], tables,
                                   ((codec_name, k, t),))
    lane, step = gather_order(n, k)
    return recs[0].cpu().numpy()[step, lane], tables
