"""Pixel-format conversion: RGB16 (arbitrary 555/565 masks), RGB24, RGB32
<-> internal RGB24 planes [H, W, 3] uint8 — the port's copy of
`screenpressor_tpu/colorspace.py`.

Every conversion has a host (numpy) and a device (torch) variant; the
RGB16 `*_any` dispatchers keep a `torch.Tensor` on its device and send
anything else through numpy, so format conversion lives inside the codec
session (the reference's `ScreenCodec`, `screencap.cpp:1652-1678` inbound,
`:1711-1738` outbound; mask->shift extraction `:1575-1583`; alpha forced
to 255 on RGB32 output `:1721`). RGB16 carries the raw masked channel
bits, with no scaling. The session API converts RGB32 a batch at a time
with the `*_batch` functions: K7 (`csrc/pixels.cu`, one launch) on the
card, their plain versions on the CPU. `apply_loss` is the lossy modes'
bit truncation of RGB24 frames.
"""

from __future__ import annotations

import numpy as np
import torch

from screenpressor_tpu_torch.kernels import (
    rgb24_to_rgb32_frames_kernel,
    rgb32_to_rgb24_frames_kernel,
)


def mask_shift(mask: int) -> int:
    if mask == 0:
        raise ValueError("zero channel mask")
    s = 0
    while not (mask >> s) & 1:
        s += 1
    return s


def rgb16_to_rgb24(frame16: np.ndarray, rmask: int, gmask: int, bmask: int) -> np.ndarray:
    """[H, W] uint16 -> [H, W, 3] uint8 (raw channel bits, no scaling —
    matches the reference, which round-trips the masked bits verbatim)."""
    rs, gs, bs = mask_shift(rmask), mask_shift(gmask), mask_shift(bmask)
    w = frame16.astype(np.uint32)
    out = np.empty(frame16.shape + (3,), np.uint8)
    out[..., 0] = (w & rmask) >> rs
    out[..., 1] = (w & gmask) >> gs
    out[..., 2] = (w & bmask) >> bs
    return out


def rgb24_to_rgb16(frame: np.ndarray, rmask: int, gmask: int, bmask: int) -> np.ndarray:
    rs, gs, bs = mask_shift(rmask), mask_shift(gmask), mask_shift(bmask)
    r = frame[..., 0].astype(np.uint32) << rs
    g = frame[..., 1].astype(np.uint32) << gs
    b = frame[..., 2].astype(np.uint32) << bs
    return (r + g + b).astype(np.uint16)


def rgb32_to_rgb24(frame32: np.ndarray) -> np.ndarray:
    """[H, W, 4] -> [H, W, 3]; alpha dropped."""
    return np.ascontiguousarray(frame32[..., :3])


def rgb24_to_rgb32(frame: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H, W, 4]; alpha forced to 255."""
    out = np.empty(frame.shape[:2] + (4,), np.uint8)
    out[..., :3] = frame
    out[..., 3] = 255
    return out


def _is_device(a) -> bool:
    return isinstance(a, torch.Tensor)


def _to_uint16(x: torch.Tensor) -> torch.Tensor:
    """int32 x mod 2**16 as uint16: the wrap numpy's astype does, narrowed
    in range to int16 and viewed (casts to uint16 are not implemented on
    every device)."""
    x = x & 0xFFFF
    return torch.where(x >= 0x8000, x - 0x10000, x).to(torch.int16).view(torch.uint16)


def rgb16_to_rgb24_device(frame16: torch.Tensor, rmask: int, gmask: int,
                          bmask: int) -> torch.Tensor:
    """The torch counterpart of rgb16_to_rgb24. The uint16 input is widened
    to int32 first (through an int16 view: shifts and masks on uint16 are
    not implemented on every device)."""
    rs, gs, bs = mask_shift(rmask), mask_shift(gmask), mask_shift(bmask)
    w = frame16.view(torch.int16).to(torch.int32) & 0xFFFF
    return (torch.stack(
        [(w & rmask) >> rs, (w & gmask) >> gs, (w & bmask) >> bs], dim=-1
    ) & 0xFF).to(torch.uint8)


def rgb24_to_rgb16_device(frame: torch.Tensor, rmask: int, gmask: int,
                          bmask: int) -> torch.Tensor:
    rs, gs, bs = mask_shift(rmask), mask_shift(gmask), mask_shift(bmask)
    w = frame.to(torch.int32)
    return _to_uint16((w[..., 0] << rs) + (w[..., 1] << gs) + (w[..., 2] << bs))


def rgb32_to_rgb24_device(frame32: torch.Tensor) -> torch.Tensor:
    """A strided view (alpha skipped)."""
    return frame32[..., :3]


def rgb24_to_rgb32_device(frame: torch.Tensor) -> torch.Tensor:
    alpha = torch.full(frame.shape[:2] + (1,), 255, dtype=torch.uint8,
                       device=frame.device)
    return torch.cat([frame, alpha], dim=-1)


def rgb32_to_rgb24_batch(batch: torch.Tensor) -> list:
    """[N, H, W, 4] uint8 -> N frames [H, W, 3] uint8, each in storage of its
    own (a session keeps one as its previous frame); alpha dropped. K7 on a
    CUDA tensor (one launch), a slice and a copy a frame on the CPU."""
    if batch.device.type == "cuda":
        return rgb32_to_rgb24_frames_kernel(batch)
    return [f[..., :3].contiguous() for f in batch]


def rgb24_to_rgb32_batch(frames) -> torch.Tensor:
    """N frames [H, W, 3] uint8 (a frame may appear in several slots) -> one
    [N, H, W, 4] uint8 tensor; alpha 255. K7 on CUDA tensors (one launch),
    a copy into the channels on the CPU."""
    if frames[0].device.type == "cuda":
        return rgb24_to_rgb32_frames_kernel(frames)
    out = torch.empty((len(frames),) + tuple(frames[0].shape[:2]) + (4,), dtype=torch.uint8)
    out[..., 3] = 255
    for dst, f in zip(out, frames):
        dst[..., :3] = f
    return out


def rgb16_to_rgb24_any(frame16, rmask, gmask, bmask):
    if _is_device(frame16):
        return rgb16_to_rgb24_device(frame16, rmask, gmask, bmask)
    return rgb16_to_rgb24(np.asarray(frame16), rmask, gmask, bmask)


def rgb24_to_rgb16_any(frame, rmask, gmask, bmask):
    if _is_device(frame):
        return rgb24_to_rgb16_device(frame, rmask, gmask, bmask)
    return rgb24_to_rgb16(np.asarray(frame), rmask, gmask, bmask)


# ---------------------------------------------------------------------------
# Raw DIB buffers (the reference's host-facing representation): bottom-up
# rows, BGR channel order, DWORD-aligned stride `(w*bpp + 3) & ~3`
# (`screencap.cpp:1569`). `to_dib` accepts an arbitrary output pitch — the
# analog of the reference's decode pitch adaptation (`screencap.cpp:1704-1708`)
# where the host's target buffer stride differs from the natural one.
# ---------------------------------------------------------------------------


def dib_stride(width: int, bpp: int) -> int:
    return (width * (bpp // 8) + 3) & ~3


def from_dib(buf: bytes, width: int, height: int, bpp: int = 24,
             stride: int | None = None) -> np.ndarray:
    """Bottom-up BGR DIB bytes -> internal [H, W, 3] uint8 RGB planes
    (bpp 24 or 32; 32 drops alpha)."""
    ch = bpp // 8
    stride = stride if stride is not None else dib_stride(width, bpp)
    if len(buf) < stride * height:
        raise ValueError(f"DIB buffer too short: {len(buf)} < {stride * height}")
    rows = np.frombuffer(buf, np.uint8)[: stride * height].reshape(height, stride)
    px = rows[:, : width * ch].reshape(height, width, ch)
    bgr = px[::-1, :, :3]  # bottom-up -> top-down
    return np.ascontiguousarray(bgr[..., ::-1])  # BGR -> RGB


def to_dib(frame: np.ndarray, bpp: int = 24, stride: int | None = None) -> bytes:
    """Internal [H, W, 3] uint8 RGB -> bottom-up BGR DIB bytes at the given
    pitch (defaults to DWORD alignment); bpp 32 emits alpha=255
    (`screencap.cpp:1721`)."""
    h, w = frame.shape[:2]
    ch = bpp // 8
    stride = stride if stride is not None else dib_stride(w, bpp)
    if stride < w * ch:
        raise ValueError(f"stride {stride} < row bytes {w * ch}")
    rows = np.zeros((h, stride), np.uint8)
    px = frame[::-1, :, ::-1]  # top-down RGB -> bottom-up BGR
    if ch == 4:
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = px
        out[..., 3] = 255
        px = out
    rows[:, : w * ch] = px.reshape(h, w * ch)
    return rows.tobytes()


def apply_loss(frame: torch.Tensor, loss: int) -> torch.Tensor:
    """Bit-truncation loss with half-step correction (spec.codec.apply_loss)."""
    if loss <= 0:
        return frame
    mask = 0xFF & ~((1 << loss) - 1)
    corr = (1 << loss) >> 1
    return (frame & mask) | corr
