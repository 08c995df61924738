"""Host-facing codec API — the port's copy of `screenpressor_tpu/api.py`.

Reference analog: `ScreenCodec` (format adaptation, `screencap.cpp:1560-1743`)
plus the session semantics of the VfW layer `CodecInst` (keyframe decision and
quality->loss mapping, `screenpressor.cpp:392-439`). Pixel formats RGB16
(arbitrary masks), RGB24, RGB32 are converted to/from internal RGB24 planes.

The sessions run on `TorchEncoder` / `TorchDecoder` on `device` ("cuda"
unless the caller asks for the CPU). RGB32 frames are converted a batch at
a time where the session runs: a batch's frames go as they are into one
staging buffer there (host frames through the session's page-locked
buffer when that is a card) and one conversion (K7 on a card) drops alpha
into the session's own RGB24 frames; a decoded batch gets alpha from one
conversion into one buffer, which leaves a card in one copy, and the
caller gets an array of its own a frame. An RGB16 torch frame stays on its
device and is converted by torch ops there, a numpy one in numpy. The
encoder writes SPTC only. The decoder routes
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
from screenpressor_tpu_torch.codec import ReusedBuffer, TorchDecoder, TorchEncoder
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
        if frame.ndim != 2 or not _is_uint16(frame):
            raise ValueError("RGB16 frame must be [H, W] uint16")
        return cs.rgb16_to_rgb24_any(
            frame, self.fmt.rmask, self.fmt.gmask, self.fmt.bmask)

    def from_internal(self, frame):
        pf = self.fmt.pixel_format
        if pf is PixelFormat.RGB24:
            return frame
        if pf is PixelFormat.RGB32:
            # an RGB24 host frame of a legacy session or of a batch that
            # changes format: the batch conversion's host version
            return cs.rgb24_to_rgb32_batch([torch.from_numpy(frame)])[0].numpy()
        return cs.rgb24_to_rgb16_any(
            frame, self.fmt.rmask, self.fmt.gmask, self.fmt.bmask)


def _on_card(frame) -> bool:
    return isinstance(frame, torch.Tensor) and frame.device.type == "cuda"


def _host_tensor(frame: np.ndarray) -> torch.Tensor:
    """A numpy frame as a CPU tensor over its memory, so that one torch copy
    (on torch's CPU threads) takes its bytes; a copy of it where torch
    cannot view it (negative strides, read-only memory)."""
    if frame.flags.writeable and all(st >= 0 for st in frame.strides):
        return torch.from_numpy(frame)
    return torch.from_numpy(np.array(frame))


def _count_converted(on_card: int, on_host: int) -> None:
    """Count converted frames by where the conversion ran."""
    if on_card:
        telemetry.count("api.convert.device_frames", on_card)
    if on_host:
        telemetry.count("api.convert.host_frames", on_host)


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
        dev = self._session.device
        # RGB32 frames as they come, [N, H, W, 4] uint8: where the session
        # runs, and host frames on their way to a card
        self._staging = ReusedBuffer(dev)
        self._host = ReusedBuffer() if dev.type == "cuda" else None
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
                internals, owned = self._to_session([frame])
            (data, ftype), = self._session.encode_batch(internals, force_key=force_key,
                                                        owned=owned)
            data = self._with_format_prefix(data, ftype)
        self.frames_encoded += 1
        self.bytes_out += len(data)
        return data, ftype

    def _to_session(self, frames):
        """The frames as the session takes them, and whether they are the
        session's own already (the RGB32 conversion's output)."""
        if self.fmt.pixel_format is PixelFormat.RGB32:
            return self._rgb32_to_session(frames), True
        internals = [self._adapter.to_internal(f) for f in frames]
        if self.fmt.pixel_format is PixelFormat.RGB16:
            card = sum(map(_on_card, frames))
            _count_converted(card, len(frames) - card)
        return internals, False

    def _rgb32_to_session(self, frames):
        """Each frame's bytes as they are into the staging buffer on the
        session's device (a host frame bound for a card through the
        session's page-locked buffer, the upload not waited for), then one
        conversion of the batch (K7 on a card): N RGB24 frames of the
        session's own. A host frame's bytes have left it when the call
        returns, so the caller may refill it. The page-locked buffer is
        free again by the next call: this call's encode reads its payloads
        back, which waits on the uploads queued before."""
        dev = self._session.device
        shape = (self.cfg.height, self.cfg.width, 4)
        for f in frames:
            if tuple(f.shape) != shape:
                raise ValueError(f"RGB32 frame must be [H, W, 4] = {list(shape)}, "
                                 f"not {list(f.shape)}")
        n = len(frames)
        staging = self._staging.take((n,) + shape)
        via_host = [dev.type == "cuda" and not _on_card(f) for f in frames]
        host = self._host.take((n,) + shape) if any(via_host) else None
        for i, (f, up) in enumerate(zip(frames, via_host)):
            dst = host[i] if up else staging[i]
            dst.copy_(f if isinstance(f, torch.Tensor) else _host_tensor(f))
            if up:
                staging[i].copy_(dst, non_blocking=True)
        on_card = dev.type == "cuda"
        _count_converted(n if on_card else 0, 0 if on_card else n)
        return cs.rgb32_to_rgb24_batch(staging)

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
                internals, owned = self._to_session(frames)
            results = self._session.encode_batch(internals, force_key=force_key, owned=owned)
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

    def _decode_one(self, data: bytes, rgb32_out: bool = False) -> np.ndarray:
        """One frame, RGB24; with rgb32_out an SPTC frame of an RGB32 stream
        comes as RGB32 from the session's batch conversion."""
        if not data:
            raise bs.CorruptStreamError("empty frame")
        data = self._strip_format_prefix(data)
        if not data:
            raise bs.CorruptStreamError("format prefix without frame payload")
        if (data[0] >> 4) == SPTC_VERSION_NIBBLE:
            rgb32 = rgb32_out and self.fmt.pixel_format is PixelFormat.RGB32
            return self._session.decode_batch([data], channels=4 if rgb32 else 3)[0]
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

    def _to_caller(self, frames, fmts) -> list:
        """Frames in the caller's formats: the RGB32 conversion's frames
        (four channels) and RGB24 frames as they are, the rest through their
        format's adapter; counted by where they were converted."""
        out, card, host = [], 0, 0
        for fr, fmt in zip(frames, fmts):
            if fr.shape[-1] == 4:
                where = self._session.device.type == "cuda"
            elif fmt.pixel_format is PixelFormat.RGB24:
                out.append(fr)
                continue
            else:
                where = _on_card(fr)
                fr = (self._adapter if fmt == self.fmt else _FormatAdapter(fmt)).from_internal(fr)
            card, host = card + where, host + (not where)
            out.append(fr)
        _count_converted(card, host)
        return out

    def decode(self, data: bytes):
        with telemetry.span("sptc.api.decode", unit=self.frames_decoded):
            if self.crashed and (not data or (data[0] & 0x0F) == ALG_P):
                raise bs.CorruptStreamError("decoder poisoned; keyframe required")
            try:
                frame = self._decode_one(data, rgb32_out=True)
            except Exception:
                self.crashed = True
                raise
            self.crashed = False
            self.frames_decoded += 1
            with telemetry.span("sptc.api.decode.convert"):
                return self._to_caller([frame], [self.fmt])[0]

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
        rgb32 = all_sptc and all(f.pixel_format is PixelFormat.RGB32 for f in fmts)
        try:
            if all_sptc:
                frames = self._session.decode_batch(datas, device_out=device_out,
                                                    channels=4 if rgb32 else 3)
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
            return self._to_caller(frames, fmts)
