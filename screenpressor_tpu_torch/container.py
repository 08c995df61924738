"""The SPTC container writer (FORMAT.md), the only code that lays out a
frame's bytes. A frame is a head (header byte, then the flat color, the
no-change flag, or the I / P record counts as varints) and, if coded, one
lane section per entropy section (`bitstream.write_section`); a coded
container of `raw_size` bytes or more takes the raw escape (the raw head
and the RGB24 pixels). The size rule is written once a side
(`container_size`, `frame_bytes`). The host writers pull each section's
lane starts and counts, gather the used lane bytes in one copy
(`lane_segments`, `gather_segments`) and `assemble` the containers; window
serving emits them on the device (`container_emit`).
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P, ALG_RAW
from screenpressor_tpu_torch.transfer import pull, to_host, upload

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

RAW_HEAD = bytes([bs.header_byte(ALG_RAW)])
UNCHANGED_P = bytes([bs.header_byte(ALG_P), 0])  # a P frame with no changed block
I_HEAD = bytes([bs.header_byte(ALG_I)])
P_HEAD = bytes([bs.header_byte(ALG_P), 1])  # a coded P frame: its varints follow


def flat_frame(color) -> bytes:
    return bytes([bs.header_byte(ALG_FLAT), *(int(v) for v in color)])


def i_head(n_rec: int, n_lit: int) -> bytes:
    return I_HEAD + bs.pack_varint(n_rec, n_lit)


def p_head(vals) -> bytes:
    """vals: (xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data)."""
    return P_HEAD + bs.pack_varint(*vals)


def raw_size(cfg) -> int:
    """Bytes of a raw frame; a coded container this long or longer escapes."""
    return 1 + cfg.width * cfg.height * 3


def raw_escape(total, size: int):
    """Whether a container of `total` bytes (ints or tensors) takes the raw
    escape, `size` the raw frame's bytes."""
    return total >= size


def lane_sizes(starts: np.ndarray, lens: np.ndarray, cap: int) -> np.ndarray:
    """Each lane's bytes from its pulled start in a [..., cap] buffer and its
    record count: a lane with no records writes none."""
    return np.where(lens > 0, cap - starts.astype(np.int64), 0)


def container_size(head: bytes, sizes_rows) -> int:
    """The host's size rule: bytes of `head` and a section a row of lane sizes."""
    return len(head) + sum(1 + len(s) * bs.size_width(int(s.max(initial=0))) + int(s.sum())
                           for s in sizes_rows)


def lane_sizes_device(starts: torch.Tensor, lens: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.where(lens > 0, cap - starts, 0)


def _width_codes(sizes: torch.Tensor) -> torch.Tensor:
    """Width code (2^code bytes an entry) of the lane sizes [..., k] -> [...]."""
    m = sizes.max(dim=-1).values
    return torch.where(m < 1 << 8, 0, torch.where(m < 1 << 16, 1, 2))


def section_bytes(starts: torch.Tensor, lens: torch.Tensor, cap: int,
                  k: int) -> torch.Tensor:
    """The device's size rule: one section's bytes, int32."""
    sizes = lane_sizes_device(starts, lens, cap)
    return (1 + (k << _width_codes(sizes)) + sizes.sum(dim=-1)).to(I32)


def frame_bytes(head: bytes, bufs, starts, lens_l) -> torch.Tensor:
    """The device's size rule for a coded frame: `head` and its sections
    (bufs [K, cap], lane starts, record counts), int32."""
    total = len(head)
    for buf, start, lens in zip(bufs, starts, lens_l):
        total = total + section_bytes(start, lens, buf.shape[1], buf.shape[0])
    return total


def lane_segments(parts, segs, buf, starts_h, sizes):
    """Append the used lane bytes of buf [C, K, cap] to a gather list."""
    parts.append(buf.reshape(-1))
    c, k, cap = buf.shape
    for j in range(c):
        for lane in range(k):
            if sizes[j, lane]:
                segs.append((len(parts) - 1, (j * k + lane) * cap + int(starts_h[j, lane]),
                             int(sizes[j, lane])))


def frame_layout(parts, segs, head: bytes, bufs, got, raw=None):
    """One coded frame's share of a gather list, from its sections' bufs
    [K, cap] and its pulled [stats, *starts, *lens] (stats: the device size
    rule's total and raw flag): its used lane bytes or, if it escapes, the
    pixels `raw` (flat uint8). Returns assemble's (head, sizes_rows, body,
    total) for it; None if it escapes and raw is None."""
    if got[0][1]:
        if raw is None:
            return None
        parts.append(raw)
        segs.append((len(parts) - 1, 0, raw.numel()))
        return RAW_HEAD, (), raw.numel(), None
    n = len(bufs)
    sizes_l = []
    for buf, start, lens in zip(bufs, got[1:1 + n], got[1 + n:]):
        sizes_l.append(lane_sizes(start, lens, buf.shape[1]))
        lane_segments(parts, segs, buf[None], start[None], sizes_l[-1][None])
    return head, sizes_l, 0, int(got[0][0])


def gather_segments_device(parts, segs, device) -> torch.Tensor:
    """One torch.cat + index on the device: parts are flat uint8 tensors,
    segs (part, offset, length) byte ranges. Returns the concatenated bytes
    as a uint8 tensor. The ranges go up in one non-blocking upload and are
    expanded into byte indices on the device."""
    if not segs:
        return torch.zeros(0, dtype=U8, device=device)
    bases = np.cumsum([0] + [p.numel() for p in parts])
    seg = np.asarray(segs, np.int64).reshape(-1, 3)
    lens = seg[:, 2]
    total = int(lens.sum())
    flat = torch.cat(parts)
    if not total:
        return flat[:0]
    # each byte's source is its range's start minus the range's output
    # offset, plus its own output position
    shift = bases[seg[:, 0]] + seg[:, 1] - (np.cumsum(lens) - lens)
    meta = upload(np.concatenate([shift, lens]), flat.device)
    idx = torch.repeat_interleave(meta[:len(seg)], meta[len(seg):], output_size=total)
    return flat[idx + torch.arange(total, device=flat.device)]


def gather_segments(parts, segs):
    """gather_segments_device + one device-to-host copy -> numpy bytes."""
    dev = parts[0].device if parts else "cpu"
    return to_host(gather_segments_device(parts, segs, dev), "codec.gather")


def assemble(head: bytes, tight: np.ndarray, pos: int, sizes_rows=(), body: int = 0,
             total=None):
    """A container from the gathered bytes `tight` at `pos`: `head`, a
    section a row of lane sizes, then `body` bytes as they lie (raw pixels,
    or a container the device emitted). `total`: the size rule's length,
    checked. Returns (bytes, the position past them)."""
    chunks = [head]
    for sizes in sizes_rows:
        end = pos + int(sizes.sum())
        chunks.append(bs.write_section(len(sizes), sizes, tight[pos:end]))
        pos = end
    if body:
        chunks.append(tight[pos:pos + body].tobytes())
        pos += body
    data = b"".join(chunks)
    if total is not None and len(data) != total:
        raise RuntimeError(f"container {len(data)} B, size rule {total} B")
    return data, pos


def write_frame(head: bytes, bufs, starts, lens_l, stats):
    """One coded frame's container from its section encode: one copy of the
    sizes, one gather of the lane bytes; None if it takes the raw escape."""
    parts, segs = [], []
    lay = frame_layout(parts, segs, head, bufs, pull([[stats, *starts, *lens_l]], "codec.pull")[0])
    return None if lay is None else assemble(lay[0], gather_segments(parts, segs), 0, *lay[1:])[0]


# ---------------------------------------------------------------------------
# Device writer (window serving)
# ---------------------------------------------------------------------------


def varint_emit(vals: torch.Tensor):
    """vals [C, n] (each < 2^28) -> (bytes [C, 4n] uint8: the n fields'
    LEB128 concatenated, lens [C]). Mirrors bs.pack_varint."""
    c, n = vals.shape
    v = vals.to(I64)
    ln = 1 + (v >= 1 << 7).long() + (v >= 1 << 14).long() + (v >= 1 << 21).long()
    offs = ln.cumsum(dim=1) - ln
    j = torch.arange(4, device=v.device)
    byts = ((v[..., None] >> (7 * j)) & 0x7F) | torch.where(ln[..., None] > j + 1, 0x80, 0)
    cap = 4 * n
    pos = torch.where(j < ln[..., None], offs[..., None] + j, cap)  # column cap: a sink
    buf = torch.zeros((c, cap + 1), dtype=I64, device=v.device)
    buf.scatter_(1, pos.reshape(c, -1), byts.reshape(c, -1))
    return buf[:, :cap].to(U8), ln.sum(dim=1)


def section_meta(sizes: torch.Tensor, k: int):
    """write_section's head (status byte, size table) of C streams' lane
    sizes [C, k] -> (meta [C, 1 + 4k] uint8, meta lens [C])."""
    klog = bs.section_status_byte(k, 1)  # width code 0: log2(k) alone
    c = sizes.shape[0]
    dev = sizes.device
    wcode = _width_codes(sizes)
    wid = (1 << wcode)[:, None, None]
    j = torch.arange(4, device=dev)
    sb = (sizes[..., None] >> (8 * j)) & 0xFF  # [C, k, 4] little endian
    cap = 1 + 4 * k
    pos = torch.where(j < wid, 1 + torch.arange(k, device=dev)[None, :, None] * wid + j, cap)
    meta = torch.zeros((c, cap + 1), dtype=I64, device=dev)
    meta[:, 0] = klog | (wcode << 4)
    meta.scatter_(1, pos.reshape(c, -1), sb.reshape(c, -1))
    return meta[:, :cap].to(U8), 1 + k * wid[:, 0, 0]


def _seg_gather(flat: torch.Tensor, src: torch.Tensor, lens: torch.Tensor, cap: int):
    """Per stream c, the segments flat[src[c, g]: src[c, g] + lens[c, g]]
    concatenated in order into [C, cap] uint8 (cut at cap) -> (out, total
    lens [C])."""
    c, g = src.shape
    ends = lens.cumsum(dim=1)
    p = torch.arange(cap, device=flat.device).expand(c, cap).contiguous()
    seg = torch.searchsorted(ends, p, right=True).clamp(max=g - 1)
    idx = src.gather(1, seg) + p - (ends.gather(1, seg) - lens.gather(1, seg))
    out = torch.where(p < ends[:, -1:], flat[idx.clamp(0, flat.numel() - 1)], 0)
    return out.to(U8), ends[:, -1]


def container_emit(head: torch.Tensor, head_len: torch.Tensor, secs, pack_cap: int):
    """C streams' whole containers on the device: head [C, hc] uint8
    (head_len [C] bytes valid), then per section (bufs [C, K, cap], starts
    [C, K], lens [C, K]) its status byte, size table and lane payloads.
    Returns (out [C, pack_cap] uint8, total lens [C])."""
    c, hc = head.shape
    dev = head.device
    cid = torch.arange(c, device=dev)[:, None]
    parts, srcs, lens = [head.reshape(-1)], [cid * hc], [head_len.to(I64)[:, None]]
    base = c * hc
    for buf, start, ln in secs:
        _, k, cap = buf.shape
        sizes = lane_sizes_device(start, ln, cap)
        meta, meta_len = section_meta(sizes, k)
        parts.append(meta.reshape(-1))
        srcs.append(base + cid * meta.shape[1])
        lens.append(meta_len[:, None])
        base += meta.numel()
        parts.append(buf.reshape(-1))
        srcs.append(base + (cid * k + torch.arange(k, device=dev)) * cap + start.to(I64))
        lens.append(sizes)
        base += buf.numel()
    return _seg_gather(torch.cat(parts), torch.cat(srcs, dim=1), torch.cat(lens, dim=1),
                       pack_cap)


def heads(prefix: bytes, vals: torch.Tensor):
    """C streams' heads, I_HEAD or P_HEAD + varint(vals [C, n]), as i_head and
    p_head write them -> ([C, len(prefix) + 4n] uint8, lens [C])."""
    vb, vl = varint_emit(vals)
    pre = [torch.full((vb.shape[0], 1), v, dtype=U8, device=vb.device) for v in prefix]
    return torch.cat([*pre, vb], dim=1), len(prefix) + vl


def small_frames(flat: torch.Tensor, nochange: torch.Tensor, raw: torch.Tensor,
                 color: torch.Tensor):
    """flat_frame, UNCHANGED_P or RAW_HEAD (its body follows on the host) of
    C streams -> ([C, 4] uint8, lens [C], 0 where none applies)."""
    head = torch.where(raw, RAW_HEAD[0], torch.where(
        nochange, UNCHANGED_P[0], bs.header_byte(ALG_FLAT)))
    out = torch.cat([head[:, None], torch.where(flat[:, None], color, 0)], dim=1)
    return out.to(U8), torch.where(flat, 4, torch.where(nochange, 2, torch.where(raw, 1, 0)))
