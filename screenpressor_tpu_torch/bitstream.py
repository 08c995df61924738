"""SPTC container packing and parsing (host side, FORMAT.md): the port's
own copy of `screenpressor_tpu/bitstream.py`. Every entropy section
carries explicit per-lane sizes for parallel decode.
"""

from __future__ import annotations

import struct

import numpy as np

from screenpressor_tpu_torch.config import ALG_FMT, SPTC_VERSION_NIBBLE


def header_byte(alg: int) -> int:
    return (SPTC_VERSION_NIBBLE << 4) | alg


def parse_header_byte(b: int) -> int:
    if (b >> 4) != SPTC_VERSION_NIBBLE:
        raise BadVersionError(b >> 4)
    return b & 0x0F


class BadVersionError(Exception):
    """A frame whose header nibble is not SPTC's version."""

    def __init__(self, version: int):
        super().__init__(f"unsupported bitstream version nibble {version:#x}")
        self.version = version


class CorruptStreamError(Exception):
    pass


def pack_format_prefix(bpp: int, rmask: int = 0, gmask: int = 0, bmask: int = 0) -> bytes:
    """Format-extension chunk before a keyframe whose source pixel format is
    not RGB24: header byte (version nibble | ALG_FMT), one bpp byte (16/32)
    and, for bpp 16, three little-endian u16 channel masks."""
    if bpp == 16:
        return bytes([header_byte(ALG_FMT), 16]) + struct.pack("<3H", rmask, gmask, bmask)
    if bpp == 32:
        return bytes([header_byte(ALG_FMT), 32])
    raise ValueError(f"format prefix only for bpp 16/32, got {bpp}")


def parse_format_prefix(data: bytes):
    """((bpp, rmask, gmask, bmask), position past the prefix) if `data`
    starts with a format-extension chunk, else (None, 0)."""
    if not data or (data[0] >> 4) != SPTC_VERSION_NIBBLE or (data[0] & 0x0F) != ALG_FMT:
        return None, 0
    if len(data) < 2:
        raise CorruptStreamError("truncated format prefix")
    bpp = data[1]
    if bpp == 16:
        if len(data) < 8:
            raise CorruptStreamError("truncated format prefix masks")
        rmask, gmask, bmask = struct.unpack_from("<3H", data, 2)
        return (16, rmask, gmask, bmask), 8
    if bpp == 32:
        return (32, 0, 0, 0), 2
    raise CorruptStreamError(f"bad format prefix bpp {bpp}")


_WIDTHS = (1, 2, 4)
_WIDTH_DTYPE = {1: np.dtype("<u1"), 2: np.dtype("<u2"), 4: np.dtype("<u4")}


def size_width(max_size: int) -> int:
    """Minimal stored width (1/2/4 bytes) of a lane size table."""
    if max_size < 1 << 8:
        return 1
    if max_size < 1 << 16:
        return 2
    return 4


def section_status_byte(k: int, width: int) -> int:
    """Status byte: bits 0-3 log2(k), bits 4-5 width code (0/1/2 -> 1/2/4)."""
    klog = max(0, (k - 1).bit_length())
    if (1 << klog) != k:
        raise ValueError(f"lane count {k} not a power of two")
    return klog | (_WIDTHS.index(width) << 4)


def write_section(k: int, sizes: np.ndarray, payload: np.ndarray) -> bytes:
    """Lane container of k lanes: status byte + minimal-width size table of
    `sizes` [k] + the lanes' bytes back to back (`payload`, uint8). The
    inverse of read_section."""
    w = size_width(int(sizes.max(initial=0)))
    return (bytes([section_status_byte(k, w)]) + sizes.astype(_WIDTH_DTYPE[w]).tobytes()
            + payload.tobytes())


def pack_section(blobs: list[bytes]) -> bytes:
    """Lane container: status byte + minimal-width size table + payloads."""
    return write_section(len(blobs), np.asarray([len(b) for b in blobs], np.int64),
                         np.frombuffer(b"".join(blobs), np.uint8))


def read_section(data: bytes, pos: int, expected_k: int):
    """The lane container at `pos` (write_section's layout), checked whole:
    (sizes [k] int64, the position of its first payload byte, the position
    past it). Its lanes lie back to back from that first byte."""
    if pos >= len(data):
        raise CorruptStreamError("truncated section header")
    status = data[pos]
    k = 1 << (status & 0x0F)
    wcode = (status >> 4) & 0x03
    if wcode >= len(_WIDTHS):
        raise CorruptStreamError(f"bad section width code {wcode}")
    w = _WIDTHS[wcode]
    if k != expected_k:
        raise CorruptStreamError(f"lane count mismatch: stream {k}, policy {expected_k}")
    pos += 1
    if pos + w * k > len(data):
        raise CorruptStreamError("truncated lane size table")
    sizes = np.frombuffer(data, _WIDTH_DTYPE[w], k, pos).astype(np.int64)
    pos += w * k
    # sizes are not negative: the last lane's end is the only one to check
    end = pos + int(sizes.sum())
    if end > len(data):
        raise CorruptStreamError("truncated lane payload")
    return sizes, pos, end


def unpack_section(data: bytes, pos: int, expected_k: int) -> tuple[list[bytes], int]:
    """The lane container at `pos` -> (its lanes' payloads, the position
    past it)."""
    sizes, pos, end = read_section(data, pos, expected_k)
    blobs = []
    for s in sizes.tolist():
        blobs.append(data[pos: pos + s])
        pos += s
    return blobs, end


def pack_varint(*vals: int) -> bytes:
    """Unsigned LEB128 (7 bits per byte, high bit continues)."""
    out = bytearray()
    for v in vals:
        if v < 0:
            raise ValueError("varint values must be non-negative")
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
    return bytes(out)


def read_varint(data: bytes, pos: int, n: int = 1):
    vals = []
    for _ in range(n):
        v = 0
        shift = 0
        while True:
            if pos >= len(data):
                raise CorruptStreamError("truncated varint header")
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 35:
                raise CorruptStreamError("varint overflow")
        vals.append(v)
    return (vals[0] if n == 1 else tuple(vals)), pos


def pack_u32(*vals: int) -> bytes:
    return struct.pack(f"<{len(vals)}I", *vals)


def read_u32(data: bytes, pos: int, n: int = 1):
    if pos + 4 * n > len(data):
        raise CorruptStreamError("truncated header")
    vals = struct.unpack_from(f"<{n}I", data, pos)
    return (vals[0] if n == 1 else vals), pos + 4 * n


def pack_u16(*vals: int) -> bytes:
    return struct.pack(f"<{len(vals)}H", *vals)


def read_u16(data: bytes, pos: int, n: int = 1):
    if pos + 2 * n > len(data):
        raise CorruptStreamError("truncated header")
    vals = struct.unpack_from(f"<{n}H", data, pos)
    return (vals[0] if n == 1 else vals), pos + 2 * n
