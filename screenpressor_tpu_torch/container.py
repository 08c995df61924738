"""The SPTC container writer (FORMAT.md), the only code that lays out a
frame's bytes. A frame is a head (header byte, then the flat color, the
no-change flag, or the I / P record counts as varints) and, if coded, one
lane section per entropy section (`bitstream.write_section`); a coded
container of `raw_size` bytes or more takes the raw escape (the raw head
and the RGB24 pixels). The size rule is written once a side
(`container_size`, `frame_bytes`). The host writers pull each section's
lane starts and counts, lay out the used lane bytes of a whole call in one
numpy pass (`lane_segments`: byte ranges as arrays, no Python trip a lane),
gather them in one copy (`gather_segments`) and `assemble` the containers;
window serving emits them on the device (`container_emit`).
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


def container_size(head_len, sizes: np.ndarray) -> np.ndarray:
    """The host's size rule for R containers: head_len [R] head bytes, then
    a section of K lanes for each row of sizes [R, S, K] (its status byte,
    size table at the width of its largest lane, lanes) -> int64 [R]."""
    m = sizes.max(axis=2, initial=0)
    width = np.where(m < 1 << 8, 1, np.where(m < 1 << 16, 2, 4))
    return np.asarray(head_len, np.int64) + (1 + sizes.shape[2] * width
                                             + sizes.sum(axis=2)).sum(axis=1)


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


def section_rows(bufs):
    """Where S section buffers [R, K_s, cap_s], laid end to end in a flat
    source, hold each row's section: (base [R, S], cap [R, S]) int64, as
    lane_segments takes them."""
    r = bufs[0].shape[0]
    cap = np.asarray([b.shape[2] for b in bufs], np.int64)
    at = np.cumsum([0] + [b.numel() for b in bufs[:-1]], dtype=np.int64)
    row = np.asarray([b.shape[1] for b in bufs], np.int64) * cap
    return at + np.arange(r, dtype=np.int64)[:, None] * row, np.broadcast_to(cap, (r, len(bufs)))


def lane_segments(base, cap, starts, sizes, raw_src=None, raw_len=None):
    """The byte ranges a writer gathers, in row (stream or frame), then
    section, then lane order: lane k of section s of row r starts at
    base[r, s] + k * cap[r, s] + starts[r, s, k] of the flat source and
    holds sizes[r, s, k] bytes (sizes and starts [R, S, K]); after row r's
    lanes come its raw pixels, raw_len[r] bytes at raw_src[r]. Empty ranges
    drop out. Returns (src, lens), int64 arrays."""
    r, s, k = sizes.shape
    src = (base[..., None] + np.arange(k, dtype=np.int64) * cap[..., None]
           + starts).reshape(r, s * k)
    lens = sizes.reshape(r, s * k)
    if raw_len is not None:
        src = np.concatenate([src, np.reshape(raw_src, (r, 1))], axis=1)
        lens = np.concatenate([lens, np.reshape(raw_len, (r, 1))], axis=1)
    keep = lens > 0
    return src[keep].astype(np.int64, copy=False), lens[keep].astype(np.int64, copy=False)


def frame_layouts(frames):
    """Coded frames' share of one gather. frames: per frame (head, bufs,
    got, raw), bufs its sections' [K, cap] buffers, got its pulled [stats,
    *starts, *lens] (stats: the device size rule's total and raw flag), raw
    the flat uint8 pixels it writes if it escapes (None: it is left out).
    Returns (parts, src, lens) for gather_segments and, a frame, assemble's
    (head, sizes_rows, body, total), None where it escapes without raw."""
    n_sec = max((len(bufs) for _, bufs, _, _ in frames), default=0)
    k = max((b.shape[0] for _, bufs, _, _ in frames for b in bufs), default=0)
    base = np.zeros((len(frames), n_sec), np.int64)
    cap = np.zeros_like(base)
    starts = np.zeros((len(frames), n_sec, k), np.int64)
    sizes = np.zeros_like(starts)
    raw_src, raw_len = np.zeros(len(frames), np.int64), np.zeros(len(frames), np.int64)
    parts, lays, at = [], [], 0
    for r, (head, bufs, got, raw) in enumerate(frames):
        if got[0][1]:
            if raw is not None:
                parts.append(raw)
                raw_src[r], raw_len[r] = at, raw.numel()
                at += raw.numel()
            lays.append(None if raw is None else (RAW_HEAD, (), raw.numel(), None))
            continue
        n = len(bufs)
        sizes_l = []
        for s, (buf, start, lens) in enumerate(zip(bufs, got[1:1 + n], got[1 + n:])):
            kb, cb = buf.shape
            sizes_l.append(lane_sizes(start, lens, cb))
            parts.append(buf.reshape(-1))
            base[r, s], cap[r, s] = at, cb
            starts[r, s, :kb], sizes[r, s, :kb] = start, sizes_l[-1]
            at += buf.numel()
        lays.append((head, sizes_l, 0, int(got[0][0])))
    return (parts, *lane_segments(base, cap, starts, sizes, raw_src, raw_len)), lays


def gather_segments_device(parts, src, lens, device) -> torch.Tensor:
    """One torch.cat + index on the device: parts are flat uint8 tensors,
    src / lens (lane_segments) byte ranges of their concatenation. Returns
    the ranges' bytes back to back as a uint8 tensor. The ranges go up in
    one non-blocking upload and are expanded into byte indices on the
    device."""
    if not len(lens):
        return torch.zeros(0, dtype=U8, device=device)
    total = int(lens.sum())
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    # each byte's source is its range's start minus the range's output
    # offset, plus its own output position
    shift = src - (np.cumsum(lens) - lens)
    meta = upload(np.concatenate([shift, lens]), flat.device)
    idx = torch.repeat_interleave(meta[:len(lens)], meta[len(lens):], output_size=total)
    return flat[idx + torch.arange(total, device=flat.device)]


def gather_segments(parts, src, lens):
    """gather_segments_device + one device-to-host copy -> numpy bytes."""
    dev = parts[0].device if parts else "cpu"
    return to_host(gather_segments_device(parts, src, lens, dev), "codec.gather")


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
    got = pull([[stats, *starts, *lens_l]], "codec.pull")[0]
    (parts, src, lens), (lay,) = frame_layouts([(head, bufs, got, None)])
    return None if lay is None else assemble(lay[0], gather_segments(parts, src, lens), 0,
                                             *lay[1:])[0]


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
