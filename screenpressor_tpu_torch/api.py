"""Host-facing codec API — the port's copy of `screenpressor_tpu/api.py`.

Reference analog: `ScreenCodec` (format adaptation, `screencap.cpp:1560-1743`)
plus the session semantics of the VfW layer `CodecInst` (keyframe decision and
quality->loss mapping, `screenpressor.cpp:392-439`). Pixel formats RGB16
(arbitrary masks), RGB24, RGB32 are converted to/from internal RGB24 planes.

The sessions run on `TorchEncoder` / `TorchDecoder` on `device` ("cuda"
unless the caller asks for the CPU). A torch frame stays on its device: its
format conversion runs as torch ops there; a numpy frame is converted in
numpy and uploaded once. The encoder writes SPTC only. The decoder routes
frames of the reference's SCPR v2/v3/v4 formats (another version nibble) to
an injected `legacy` factory, `version -> session` with `.decode(bytes) ->
[H, W, 3] uint8`; without one such a frame raises `BadVersionError`.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import colorspace as cs
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.codec import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch.config import ALG_P, SPTC_VERSION_NIBBLE, CodecConfig


class PixelFormat(enum.Enum):
    RGB16 = 16
    RGB24 = 24
    RGB32 = 32


@dataclasses.dataclass(frozen=True)
class FormatParams:
    pixel_format: PixelFormat = PixelFormat.RGB24
    # 16-bit channel masks (reference supports 555/565 and arbitrary
    # BI_BITFIELDS masks, `screenpressor.cpp:276-339`)
    rmask: int = 0xF800
    gmask: int = 0x07E0
    bmask: int = 0x001F


def max_compressed_size(width: int, height: int) -> int:
    """Worst-case output buffer bound per frame (reference `CompressGetSize`
    returns X*Y*6, `screenpressor.cpp:386-388`; ours adds section headers)."""
    return width * height * 6 + 4096


def infer_frame_type(data: bytes) -> int:
    """0 = I-frame (incl. flat), 1 = P-frame — derived from the payload, not
    trusted container flags (reference `InferFrameType`,
    `screenpressor.cpp:579-613`)."""
    if not data:
        raise bs.CorruptStreamError("empty frame")
    return 1 if bs.parse_header_byte(data[0]) == ALG_P else 0


def quality_to_loss(quality: int) -> int:
    """VfW quality 0..10000 -> loss bits 4..0
    (`screenpressor.cpp:411-422`)."""
    if quality >= 9000:
        return 0
    if quality >= 7000:
        return 1
    if quality >= 5000:
        return 2
    if quality >= 3000:
        return 3
    return 4


def stream_version(data: bytes) -> int | None:
    """SCPR codec version from an I-frame header byte; None for P frames
    (the session keeps the version of the last keyframe,
    `screencap.cpp:1698-1702`). A copy of the native package's
    `legacy_ans.stream_version`."""
    if not data:
        raise ValueError("empty frame")
    b0 = data[0]
    if b0 in (0, 1) and not (b0 == 1 and len(data) <= 4):
        return None
    if b0 == 1:  # 4-byte flat frame without a version nibble: v2 legacy form
        return 2
    ver = (b0 >> 4) + 1
    if 2 <= ver <= 4 and (b0 & 0x0F) in (1, 2):
        return ver
    raise ValueError(f"unrecognized SCPR header byte {b0:#x}")


def _is_uint16(frame) -> bool:
    if isinstance(frame, torch.Tensor):
        return frame.dtype == torch.uint16
    return np.dtype(frame.dtype) == np.uint16


class _FormatAdapter:
    def __init__(self, fmt: FormatParams):
        self.fmt = fmt

    def to_internal(self, frame):
        """Device-resident frames stay on device (torch conversions inside
        the codec session, the reference's `ScreenCodec` conversion
        placement)."""
        pf = self.fmt.pixel_format
        if pf is PixelFormat.RGB24:
            if frame.ndim != 3 or frame.shape[2] != 3:
                raise ValueError("RGB24 frame must be [H, W, 3]")
            if not isinstance(frame, np.ndarray):
                return frame  # device-resident frame: pass through untouched
            return np.ascontiguousarray(frame, np.uint8)
        if pf is PixelFormat.RGB32:
            if frame.ndim != 3 or frame.shape[2] != 4:
                raise ValueError("RGB32 frame must be [H, W, 4]")
            return cs.rgb32_to_rgb24_any(frame)
        if frame.ndim != 2 or not _is_uint16(frame):
            raise ValueError("RGB16 frame must be [H, W] uint16")
        return cs.rgb16_to_rgb24_any(
            frame, self.fmt.rmask, self.fmt.gmask, self.fmt.bmask)

    def from_internal(self, frame):
        pf = self.fmt.pixel_format
        if pf is PixelFormat.RGB24:
            return frame
        if pf is PixelFormat.RGB32:
            return cs.rgb24_to_rgb32_any(frame)
        return cs.rgb24_to_rgb16_any(
            frame, self.fmt.rmask, self.fmt.gmask, self.fmt.bmask)


def _format_of(parsed) -> FormatParams:
    """FormatParams of a parsed format prefix (bpp, rmask, gmask, bmask)."""
    bpp, rmask, gmask, bmask = parsed
    if bpp == 32:
        return FormatParams(pixel_format=PixelFormat.RGB32)
    return FormatParams(pixel_format=PixelFormat.RGB16,
                        rmask=rmask, gmask=gmask, bmask=bmask)


class Encoder:
    """Per-stream encoder session.

    >>> enc = Encoder(CodecConfig(width=W, height=H))
    >>> payload, ftype = enc.encode(frame)          # ftype 0 = I, 1 = P
    """

    def __init__(
        self,
        cfg: CodecConfig,
        fmt: FormatParams = FormatParams(),
        device="cuda",
    ):
        self.cfg = cfg
        self.fmt = fmt
        self._adapter = _FormatAdapter(fmt)
        self._session = TorchEncoder(cfg, device)
        self.frames_encoded = 0
        self.bytes_out = 0

    def encode(self, frame, force_key: bool = False, quality: int | None = None):
        if quality is not None:
            loss = quality_to_loss(quality)
            if loss != self.cfg.loss:
                self.cfg = dataclasses.replace(self.cfg, loss=loss)
                self._session.cfg = self.cfg
        with telemetry.span("sptc.api.encode", unit=self.frames_encoded):
            with telemetry.span("sptc.api.encode.convert"):
                internal = self._adapter.to_internal(frame)
            data, ftype = self._session.encode(internal, force_key=force_key)
            data = self._with_format_prefix(data, ftype)
        self.frames_encoded += 1
        self.bytes_out += len(data)
        return data, ftype

    def _with_format_prefix(self, data: bytes, ftype: int) -> bytes:
        """Prefix keyframes with the format-extension chunk for non-RGB24
        sources so decoders self-configure from the stream alone
        (reference: `CompressGetFormat` mask embedding,
        `screenpressor.cpp:317-339`). RGB24 streams are unchanged."""
        if ftype != 0 or self.fmt.pixel_format is PixelFormat.RGB24:
            return data
        if self.fmt.pixel_format is PixelFormat.RGB32:
            return bs.pack_format_prefix(32) + data
        return bs.pack_format_prefix(
            16, self.fmt.rmask, self.fmt.gmask, self.fmt.bmask) + data

    def encode_batch(self, frames, force_key: bool = False):
        """Encode a list of frames through the session's batched path (a
        fixed number of device-to-host copies per batch). Returns a list of
        (payload, ftype)."""
        with telemetry.span("sptc.api.encode", unit=self.frames_encoded):
            with telemetry.span("sptc.api.encode.convert"):
                internals = [self._adapter.to_internal(f) for f in frames]
            results = self._session.encode_batch(internals, force_key=force_key)
            if self.fmt.pixel_format is not PixelFormat.RGB24:
                results = [(self._with_format_prefix(d, t), t) for d, t in results]
        for data, _ in results:
            self.frames_encoded += 1
            self.bytes_out += len(data)
        return results

    @property
    def stats(self) -> dict:
        raw = self.frames_encoded * self.cfg.width * self.cfg.height * 3
        return {
            "frames": self.frames_encoded,
            "bytes": self.bytes_out,
            "ratio": (raw / self.bytes_out) if self.bytes_out else float("inf"),
        }


class Decoder:
    """Per-stream decoder session with unified version dispatch.

    Like the reference's `ScreenCodec::DecompressFrame`
    (`screencap.cpp:1695-1702`), the decoder routes each frame by its stream
    version nibble: SPTC (0xA) frames go to the `TorchDecoder` session; SCPR
    v2/v3/v4 reference-format frames go to a session of the `legacy`
    factory, created at the stream's first keyframe (and at a keyframe of
    another version) and reused for its P frames. One Decoder instance can
    decode a mixed corpus.
    """

    def __init__(
        self,
        cfg: CodecConfig,
        fmt: FormatParams = FormatParams(),
        device="cuda",
        legacy=None,
    ):
        self.cfg = cfg
        self.fmt = fmt
        self._adapter = _FormatAdapter(fmt)
        self._session = TorchDecoder(cfg, device)
        self._legacy_factory = legacy
        self._legacy = None
        self._legacy_version: int | None = None
        # crash latch: a failed decode poisons the instance until the next
        # keyframe (reference `crashed`, `screencap.cpp:1621-1710`)
        self.crashed = False
        self.frames_decoded = 0

    def _strip_format_prefix(self, data: bytes) -> bytes:
        """Consume a leading format-extension chunk, reconfiguring this
        decoder's output pixel format from the stream (FORMAT.md; reference
        `screenpressor.cpp:317-339`)."""
        parsed, pos = bs.parse_format_prefix(data)
        if parsed is None:
            return data
        fmt = _format_of(parsed)
        if fmt != self.fmt:
            self.fmt = fmt
            self._adapter = _FormatAdapter(fmt)
        return data[pos:]

    def _decode_one(self, data: bytes) -> np.ndarray:
        if not data:
            raise bs.CorruptStreamError("empty frame")
        data = self._strip_format_prefix(data)
        if not data:
            raise bs.CorruptStreamError("format prefix without frame payload")
        if (data[0] >> 4) == SPTC_VERSION_NIBBLE:
            return self._session.decode(data)
        # reference-format SCPR stream
        if self._legacy_factory is None:
            raise bs.BadVersionError(data[0] >> 4)
        try:
            ver = stream_version(data)
        except ValueError as e:
            raise bs.BadVersionError(data[0] >> 4) from e
        if ver is not None and (self._legacy is None or self._legacy_version != ver):
            self._legacy = self._legacy_factory(ver)
            self._legacy_version = ver
        if self._legacy is None:
            raise bs.CorruptStreamError("SCPR P-frame before any keyframe")
        return self._legacy.decode(data)

    def decode(self, data: bytes):
        with telemetry.span("sptc.api.decode", unit=self.frames_decoded):
            if self.crashed and (not data or (data[0] & 0x0F) == ALG_P):
                raise bs.CorruptStreamError("decoder poisoned; keyframe required")
            try:
                frame = self._decode_one(data)
            except Exception:
                self.crashed = True
                raise
            self.crashed = False
            self.frames_decoded += 1
            with telemetry.span("sptc.api.decode.convert"):
                return self._adapter.from_internal(frame)

    def decode_batch(self, datas, device_out: bool = False):
        """Decode a list of payloads with one deferred validity copy per
        batch. device_out=True returns device-resident frames (RGB24 only)
        without pulling them to the host."""
        with telemetry.span("sptc.api.decode", unit=self.frames_decoded):
            return self._decode_batch(datas, device_out)

    def _decode_batch(self, datas, device_out):
        if device_out and self.fmt.pixel_format is not PixelFormat.RGB24:
            raise ValueError("device_out requires RGB24")
        if self.crashed and datas and (not datas[0] or (datas[0][0] & 0x0F) == ALG_P):
            raise bs.CorruptStreamError("decoder poisoned; keyframe required")
        # Parse format prefixes WITHOUT committing the fmt/adapter mutation:
        # a validation failure below must not leave the decoder
        # reconfigured, and a mid-batch format change must convert each
        # frame with the format in effect at ITS position, not the last.
        stripped, fmts = [], []
        fmt = self.fmt
        for d in datas:
            parsed, pos = bs.parse_format_prefix(d)
            if parsed is not None:
                fmt = _format_of(parsed)
                d = d[pos:]
                if not d:
                    raise bs.CorruptStreamError(
                        "format prefix without frame payload")
            stripped.append(d)
            fmts.append(fmt)
        if device_out and any(
            f.pixel_format is not PixelFormat.RGB24 for f in fmts
        ):
            raise ValueError("device_out requires RGB24 (stream carries a format prefix)")
        datas = stripped
        all_sptc = all(d and (d[0] >> 4) == SPTC_VERSION_NIBBLE for d in datas)
        try:
            if all_sptc:
                frames = self._session.decode_batch(datas, device_out=device_out)
            else:
                frames = [self._decode_one(d) for d in datas]
        except Exception:
            self.crashed = True
            raise
        self.crashed = False
        self.frames_decoded += len(datas)
        if fmts and fmts[-1] != self.fmt:
            self.fmt = fmts[-1]
            self._adapter = _FormatAdapter(fmts[-1])
        if device_out:
            return frames
        with telemetry.span("sptc.api.decode.convert"):
            return [
                (_FormatAdapter(f).from_internal(fr) if f != self.fmt
                 else self._adapter.from_internal(fr))
                for f, fr in zip(fmts, frames)
            ]
