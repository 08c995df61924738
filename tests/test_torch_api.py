"""The port's session API (screenpressor_tpu_torch.api) against the
reference's (screenpressor_tpu.api) on the CPU, exactly: encoder bytes for
every pixel format over a sequence with a keyframe, a flat frame, scroll,
typing, force_key and a quality change; decoder output of the reference's
streams with self-configuration from the format prefix; the crash latch;
decode_batch's format-commit rules; legacy (SCPR v2/v3/v4) routing through
an injected factory; and the small functions."""

import functools
import inspect

import numpy as np
import pytest
import torch

from screenpressor_tpu import api as ref
from screenpressor_tpu import bitstream as ref_bs
from screenpressor_tpu import colorspace as ref_cs
from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu_torch import api
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.codec import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch.config import CodecConfig
from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder
from screenpressor_tpu_torch.synth import synth_screencast

from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import INDEX_SITE_FLIPS, flip, port_config

H, W = 32, 48
REF_CFG = RefCodecConfig(width=W, height=H, kf_interval=0)
CFG = port_config(REF_CFG)
# pixel formats: name -> (masks or None); RGB16 masks 565, 555 and 444
FORMATS = {"rgb24": None, "rgb32": None, "rgb16_565": (0xF800, 0x07E0, 0x001F),
           "rgb16_555": (0x7C00, 0x03E0, 0x001F), "rgb16_444": (0x0F00, 0x00F0, 0x000F)}


def _fmt(mod, name):
    if name == "rgb24":
        return mod.FormatParams()
    if name == "rgb32":
        return mod.FormatParams(pixel_format=mod.PixelFormat.RGB32)
    return mod.FormatParams(mod.PixelFormat.RGB16, *FORMATS[name])


def rgb24_sequence(seed=0):
    """A desktop keyframe, a flat frame, the desktop again, a scroll, four
    typing frames and a sideways scroll (9 frames)."""
    rng = np.random.default_rng(seed)
    desk = np.empty((H, W, 3), np.uint8)
    desk[:] = (30, 40, 50)
    desk[4: H - 4, 6: W - 6] = (250, 250, 250)
    for y in range(7, H - 6, 5):
        n = int(rng.integers(10, W - 16))
        desk[y: y + 2, 8: 8 + n] = rng.integers(0, 80, (2, n, 3), dtype=np.uint8)
    flat = np.full((H, W, 3), (12, 200, 7), np.uint8)
    scroll = np.roll(desk, -3, axis=0)
    typing = [scroll.copy()]
    for i in range(4):
        f = typing[-1].copy()
        f[20: 23, 10 + 5 * i: 14 + 5 * i] = rng.integers(0, 256, (3, 4, 3), dtype=np.uint8)
        typing.append(f)
    return [desk, flat, desk, scroll] + typing[1:] + [np.roll(typing[-1], 2, axis=1)]


def source_frames(name, seed=0):
    """The sequence in the pixel format `name` (RGB32 with a random alpha;
    RGB16 with each channel cut to its mask's width)."""
    frames = rgb24_sequence(seed)
    rng = np.random.default_rng(seed + 100)
    if name == "rgb24":
        return frames
    if name == "rgb32":
        return [np.dstack([f, rng.integers(0, 256, (H, W), dtype=np.uint8)]) for f in frames]
    masks = FORMATS[name]
    cut = np.array([8 - bin(m).count("1") for m in masks], np.uint8)
    return [ref_cs.rgb24_to_rgb16(f >> cut, *masks) for f in frames]


def drive(enc, frames, mode):
    """The sequence through an encoder of either package: keyframe, flat,
    P frames; force_key at frame 6; quality 5000 (loss 2) from frame 7,
    quality 10000 (loss 0) at frame 8. Returns every (payload, ftype)."""
    if mode == "encode":
        out = [enc.encode(f) for f in frames[:6]]
        out.append(enc.encode(frames[6], force_key=True))
        out.append(enc.encode(frames[7], quality=5000))
        out.append(enc.encode(frames[8], quality=10000))
        return out
    out = enc.encode_batch(frames[:3])
    out += enc.encode_batch(frames[3:6])
    out += enc.encode_batch(frames[6:7], force_key=True)
    out.append(enc.encode(frames[7], quality=5000))
    out.append(enc.encode(frames[8], quality=10000))
    return out


@functools.lru_cache(maxsize=None)
def reference_stream(name):
    """The reference's JAX session over the sequence, frame by frame (its
    encode_batch gives the same bytes)."""
    enc = ref.Encoder(REF_CFG, _fmt(ref, name), backend="jax")
    return tuple(drive(enc, source_frames(name), "encode")), enc.stats


@pytest.mark.parametrize("mode", ["encode", "encode_batch"])
@pytest.mark.parametrize("name", list(FORMATS))
def test_encoder_bytes_equal_reference(name, mode):
    want, want_stats = reference_stream(name)
    enc = api.Encoder(CFG, _fmt(api, name), device="cpu")
    got = drive(enc, source_frames(name), mode)
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        assert g == r, f"{name} {mode}: frame {i} type or bytes differ from the reference"
    assert enc.stats == want_stats
    assert enc.cfg.loss == 0
    # the fixture holds what it claims: a flat frame, force_key, a loss step
    types = [t for _, t in got]
    assert types[0] == 0 and types[6] == 0 and types.count(1) >= 4
    assert any(t == 0 and len(p) - bs.parse_format_prefix(p)[1] == 4 for p, t in got)


@pytest.mark.parametrize("name", list(FORMATS))
def test_keyframes_carry_the_format_prefix(name):
    got, _ = reference_stream(name)
    for p, t in got:
        parsed, _ = bs.parse_format_prefix(p)
        if t == 1 or name == "rgb24":
            assert parsed is None
        elif name == "rgb32":
            assert p.startswith(bs.pack_format_prefix(32))
        else:
            assert p.startswith(bs.pack_format_prefix(16, *FORMATS[name]))


@pytest.mark.parametrize("name", list(FORMATS))
def test_tensor_frames_equal_host_frames(name):
    """Frames handed in as torch tensors (converted by the torch functions
    on their device) give the bytes of the same frames handed in as numpy."""
    frames = source_frames(name, seed=1)
    host = api.Encoder(CFG, _fmt(api, name), device="cpu")
    dev = api.Encoder(CFG, _fmt(api, name), device="cpu")
    assert drive(dev, [torch.as_tensor(f) for f in frames], "encode_batch") == \
        drive(host, frames, "encode_batch")


@pytest.mark.parametrize("name", list(FORMATS))
def test_decoder_equals_reference_and_configures_itself(name):
    """A decoder made with the default format decodes the reference's
    stream to the reference decoder's frames, and takes the stream's format
    from its keyframe prefix (alpha 255 for RGB32)."""
    stream = [p for p, _ in reference_stream(name)[0]]
    want = ref.Decoder(REF_CFG)
    dec = api.Decoder(CFG, device="cpu")
    for i, p in enumerate(stream):
        got, exp = dec.decode(p), want.decode(p)
        assert isinstance(got, np.ndarray) and got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp, err_msg=f"{name}: frame {i}")
    assert dec.fmt == _fmt(api, name)
    if name == "rgb32":
        assert (got[..., 3] == 255).all()
    src = source_frames(name)[-1]
    np.testing.assert_array_equal(got[..., :3] if name == "rgb32" else got,
                                  src[..., :3] if name == "rgb32" else src)
    outs = api.Decoder(CFG, device="cpu").decode_batch(stream)
    for i, (o, r) in enumerate(zip(outs, ref.Decoder(REF_CFG).decode_batch(stream),
                                   strict=True)):
        np.testing.assert_array_equal(o, r, err_msg=f"{name}: batch frame {i}")
    np.testing.assert_array_equal(outs[-1], got)


def _outcome(dec, data, batch):
    """('ok', frames) or (exception class name, None) of one decode call."""
    try:
        out = dec.decode_batch(data) if batch else dec.decode(data)
    except Exception as e:  # noqa: BLE001 (the class is what is compared)
        return type(e).__name__, None
    return "ok", [np.asarray(o) for o in out] if batch else np.asarray(out)


def _latch_stream(name):
    """A 6-frame 48x64 stream from the port with a keyframe at 0 and 4, and
    a damaged copy of frame 2 whose flip surely fails the decode."""
    frames24 = synth_screencast(48, 64, 6)
    cfg = CodecConfig(width=64, height=48)
    if name == "rgb32":
        frames = [np.dstack([f, np.full(f.shape[:2], 9, np.uint8)]) for f in frames24]
    else:
        frames = frames24
    enc = api.Encoder(cfg, _fmt(api, name), device="cpu")
    payloads = [p for p, _ in enc.encode_batch(frames[:4])]
    payloads += [p for p, _ in enc.encode_batch(frames[4:], force_key=True)]
    i, pos, x = INDEX_SITE_FLIPS[0]
    assert i == 2
    return cfg, payloads, flip(payloads[2], pos, x)


@pytest.mark.parametrize("batch", [False, True], ids=["decode", "decode_batch"])
@pytest.mark.parametrize("name", ["rgb24", "rgb32"])
def test_crash_latch_equals_reference(name, batch):
    """A damaged P frame poisons the decoder; P frames are refused until a
    keyframe (with or without a format prefix) clears it; the decode then
    recovers. Every call's outcome equals the reference decoder's."""
    cfg, p, bad = _latch_stream(name)
    want = ref.Decoder(RefCodecConfig(width=64, height=48))
    dec = api.Decoder(cfg, device="cpu")
    steps = [p[0], p[1], bad, p[2], p[3], b"", p[4], p[5]]
    outcomes = []
    for i, data in enumerate(steps):
        arg = [data] if batch else data
        got, exp = _outcome(dec, arg, batch), _outcome(want, arg, batch)
        assert got[0] == exp[0], f"step {i}: port {got[0]}, reference {exp[0]}"
        if got[0] == "ok":
            np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(exp[1]))
        outcomes.append(got[0])
        assert dec.crashed == want.crashed, f"step {i}"
    assert outcomes == ["ok", "ok", "CorruptStreamError", "CorruptStreamError",
                        "CorruptStreamError", "CorruptStreamError", "ok", "ok"]


def _two_format_stream():
    """An RGB32 keyframe and P frame, then an RGB16 565 keyframe and P
    frame (a new session), as the port's encoders write them."""
    frames = rgb24_sequence(3)
    f32 = [np.dstack([f, np.zeros((H, W), np.uint8)]) for f in frames[2:4]]
    f16 = source_frames("rgb16_565", 3)[2:4]
    p32 = [p for p, _ in api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu").encode_batch(f32)]
    p16 = [p for p, _ in api.Encoder(CFG, _fmt(api, "rgb16_565"),
                                     device="cpu").encode_batch(f16)]
    return p32 + p16, f32, f16


def test_decode_batch_mid_batch_format_change():
    """Each frame is converted with the format in effect at its own
    position; the last one is committed. Equal to the reference."""
    stream, f32, f16 = _two_format_stream()
    dec = api.Decoder(CFG, device="cpu")
    outs = dec.decode_batch(stream)
    want = ref.Decoder(REF_CFG).decode_batch(stream)
    for o, r in zip(outs, want, strict=True):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(outs[1][..., :3], f32[1][..., :3])
    np.testing.assert_array_equal(outs[3], f16[1])
    assert dec.fmt == _fmt(api, "rgb16_565")


def test_failed_batch_commits_no_format():
    """A batch that fails after a prefixed keyframe leaves the decoder's
    format as it was, as the reference's, and latches it."""
    stream, _, _ = _two_format_stream()
    damaged = stream[3][:-3]
    dec = api.Decoder(CFG, device="cpu")
    want = ref.Decoder(REF_CFG)
    for d in (dec, want):
        with pytest.raises(Exception) as e:
            d.decode_batch([stream[2], damaged])
        assert type(e.value).__name__ == "CorruptStreamError"
        assert d.crashed
    assert dec.fmt == api.FormatParams() and want.fmt == ref.FormatParams()
    # a prefix without a payload fails before any decode, committing nothing
    with pytest.raises(bs.CorruptStreamError):
        dec.decode_batch([stream[2], bs.pack_format_prefix(32)])
    assert dec.fmt == api.FormatParams()


@pytest.mark.parametrize("case", ["rgb16_session", "prefixed_stream", "rgb24_stream"])
def test_decode_batch_device_out(case):
    """device_out is RGB24 only: a non-RGB24 session or a batch with a
    format prefix raises ValueError (committing nothing); an RGB24 stream
    comes back as tensors on the session's device."""
    stream, _, _ = _two_format_stream()
    if case == "rgb16_session":
        dec = api.Decoder(CFG, _fmt(api, "rgb16_565"), device="cpu")
        with pytest.raises(ValueError):
            dec.decode_batch(stream[2:], device_out=True)
    elif case == "prefixed_stream":
        dec = api.Decoder(CFG, device="cpu")
        with pytest.raises(ValueError):
            dec.decode_batch(stream[:2], device_out=True)
        assert dec.fmt == api.FormatParams() and not dec.crashed
    else:
        frames = rgb24_sequence(4)[:3]
        pay = [p for p, _ in api.Encoder(CFG, device="cpu").encode_batch(frames)]
        outs = api.Decoder(CFG, device="cpu").decode_batch(pay, device_out=True)
        assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu" for o in outs)
        for o, f in zip(outs, frames, strict=True):
            np.testing.assert_array_equal(o.numpy(), f)


def _legacy_factory(cfg):
    return lambda version: ref._LegacySession(cfg, version, encoder=False)


def _legacy_stream(version, frames):
    enc = ref.Encoder(RefCodecConfig(width=W, height=H, kf_interval=100),
                      backend=f"scpr{version}")
    return [enc.encode(f)[0] for f in frames]


@pytest.mark.parametrize("version", [2, 3, 4])
def test_legacy_streams_through_an_injected_factory(version):
    frames = rgb24_sequence(5)[2:6]
    stream = _legacy_stream(version, frames)
    dec = api.Decoder(CFG, device="cpu", legacy=_legacy_factory(REF_CFG))
    want = ref.Decoder(REF_CFG)
    for i, (p, f) in enumerate(zip(stream, frames)):
        out = dec.decode(p)
        np.testing.assert_array_equal(out, want.decode(p), err_msg=f"frame {i}")
        np.testing.assert_array_equal(out, f, err_msg=f"frame {i}")
    outs = api.Decoder(CFG, device="cpu", legacy=_legacy_factory(REF_CFG)).decode_batch(stream)
    for o, f in zip(outs, frames, strict=True):
        np.testing.assert_array_equal(o, f)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_legacy_stream_without_a_factory_raises_bad_version(version):
    stream = _legacy_stream(version, rgb24_sequence(5)[2:4])
    dec = api.Decoder(CFG, device="cpu")
    with pytest.raises(bs.BadVersionError) as e:
        dec.decode(stream[0])
    assert e.value.version == stream[0][0] >> 4
    assert dec.crashed


def test_legacy_p_frame_before_its_keyframe():
    stream = _legacy_stream(3, rgb24_sequence(5)[2:4])
    assert api.stream_version(stream[1]) is None
    dec = api.Decoder(CFG, device="cpu", legacy=_legacy_factory(REF_CFG))
    with pytest.raises(bs.CorruptStreamError):
        dec.decode(stream[1])
    with pytest.raises(ref_bs.CorruptStreamError):
        ref.Decoder(REF_CFG).decode(stream[1])


def test_mixed_sptc_and_scpr_corpus():
    """One decoder over SPTC (the port's), v2, v3 and v4 streams, three
    frames each, then SPTC again."""
    frames = rgb24_sequence(6)[2:5]
    corpus = [p for p, _ in api.Encoder(CFG, device="cpu").encode_batch(frames)]
    for v in (2, 3, 4):
        corpus += _legacy_stream(v, frames)
    corpus += [p for p, _ in api.Encoder(CFG, device="cpu").encode_batch(frames)]
    dec = api.Decoder(CFG, device="cpu", legacy=_legacy_factory(REF_CFG))
    for i, p in enumerate(corpus):
        np.testing.assert_array_equal(dec.decode(p), frames[i % 3], err_msg=f"item {i}")
    outs = api.Decoder(CFG, device="cpu", legacy=_legacy_factory(REF_CFG)).decode_batch(corpus)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, frames[i % 3], err_msg=f"batch item {i}")


@pytest.mark.parametrize("data", [bytes([0x11, 1, 2, 3, 4, 5]), bytes([0x31, 0]),
                                  bytes([0x22]), bytes([0x41]), bytes([0x12]), bytes([0]),
                                  bytes([1, 0, 0, 0]), bytes([1, 0, 0, 0, 0]),
                                  bytes([0x35]), b""])
def test_stream_version_equals_native(data):
    from screenpressor_tpu.native.legacy_ans import stream_version

    try:
        want = stream_version(data)
    except ValueError:
        with pytest.raises(ValueError):
            api.stream_version(data)
        return
    assert api.stream_version(data) == want


@pytest.mark.parametrize("quality", [0, 1, 2999, 3000, 4999, 5000, 6999, 7000, 8999,
                                     9000, 9999, 10000])
def test_quality_to_loss(quality):
    assert api.quality_to_loss(quality) == ref.quality_to_loss(quality)


@pytest.mark.parametrize("kind", ["flat", "i", "p", "idle_p", "raw", "prefixed", "empty",
                                  "bad_version"])
def test_infer_frame_type(kind):
    payloads = {
        "flat": bytes([bs.header_byte(1), 1, 2, 3]),
        "i": reference_stream("rgb24")[0][0][0],
        "p": reference_stream("rgb24")[0][3][0],
        "idle_p": bytes([bs.header_byte(3), 0]),
        "raw": bytes([bs.header_byte(4)]) + bytes(H * W * 3),
        "prefixed": reference_stream("rgb32")[0][0][0],
        "empty": b"",
        "bad_version": bytes([0x31, 0, 0]),
    }
    data = payloads[kind]
    try:
        want = ref.infer_frame_type(data)
    except Exception as e:  # noqa: BLE001 (the class is what is compared)
        with pytest.raises(Exception) as got:
            api.infer_frame_type(data)
        assert type(got.value).__name__ == type(e).__name__
        return
    assert api.infer_frame_type(data) == want == (1 if kind.endswith("p") else 0)


@pytest.mark.parametrize("wh", [(1, 1), (48, 32), (641, 359), (1920, 1080), (3840, 2160)])
def test_max_compressed_size(wh):
    assert api.max_compressed_size(*wh) == ref.max_compressed_size(*wh)


def test_rgb16_frame_type_is_checked():
    enc = api.Encoder(CFG, _fmt(api, "rgb16_565"), device="cpu")
    for bad in (np.zeros((H, W), np.int16), torch.zeros((H, W), dtype=torch.int32),
                np.zeros((H, W, 3), np.uint8)):
        with pytest.raises(ValueError):
            enc.encode(bad)
    with pytest.raises(ValueError):
        api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu").encode(np.zeros((H, W, 3), np.uint8))
    with pytest.raises(ValueError):
        api.Encoder(CFG, device="cpu").encode(np.zeros((H, W, 4), np.uint8))


SESSIONS = {"Encoder": (api.Encoder, (CFG,)), "Decoder": (api.Decoder, (CFG,)),
            "TorchEncoder": (TorchEncoder, (CFG,)), "TorchDecoder": (TorchDecoder, (CFG,)),
            "BatchedEncoder": (BatchedEncoder, (2, CFG)),
            "BatchedDecoder": (BatchedDecoder, (2, CFG))}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_sessions_default_to_the_card(name):
    """Every entry point's device defaults to "cuda"; without a card the
    constructor raises instead of running on the CPU."""
    cls, args = SESSIONS[name]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        session = cls(*args)
        assert getattr(session, "_session", session).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        cls(*args)


# -- RGB32 frames through the batch conversion (K7's plain versions here) ----

@pytest.fixture(params=["numpy", "tensor"])
def frames_as(request):
    """How the caller hands in its RGB32 frames: numpy arrays, or CPU torch
    tensors over the same memory."""
    if request.param == "numpy":
        return lambda frames: list(frames)
    return lambda frames: [torch.from_numpy(f) for f in frames]


def _convert_counts():
    c = telemetry.counts()
    return c.get("api.convert.device_frames", 0), c.get("api.convert.host_frames", 0)


@pytest.mark.parametrize("mode", ["encode", "encode_batch"])
def test_rgb32_round_trip_equals_reference(frames_as, mode):
    """An RGB32 Encoder writes the reference's bytes and a Decoder gives the
    reference decoder's frames (alpha 255), frame by frame and in a batch;
    the counters say where each frame was converted (the host, for a CPU
    session)."""
    want, want_stats = reference_stream("rgb32")
    dev0, host0 = _convert_counts()
    enc = api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu")
    got = drive(enc, frames_as(source_frames("rgb32")), mode)
    assert got == list(want) and enc.stats == want_stats
    stream = [p for p, _ in got]
    ref_frames = ref.Decoder(REF_CFG).decode_batch(stream)
    one = api.Decoder(CFG, device="cpu")
    singles = [one.decode(p) for p in stream]
    batch = api.Decoder(CFG, device="cpu").decode_batch(stream)
    for i, (s, b, r) in enumerate(zip(singles, batch, ref_frames, strict=True)):
        assert s.dtype == b.dtype == r.dtype == np.uint8 and s.shape == (H, W, 4)
        np.testing.assert_array_equal(s, r, err_msg=f"frame {i}")
        np.testing.assert_array_equal(b, r, err_msg=f"batch frame {i}")
    n = 3 * len(stream)  # encoded, decoded one by one, decoded in a batch
    dev1, host1 = _convert_counts()
    assert (dev1 - dev0, host1 - host0) == (0, n)


def _idle_stream(name):
    """Two calls' payloads: a keyframe, two idle P frames, a scroll and an
    idle P frame, then two idle P frames (each decodes to its previous
    frame)."""
    desk, scroll = rgb24_sequence(5)[2:4]
    frames = [desk, desk, desk, scroll, scroll, scroll, scroll]
    if name == "rgb32":
        frames = [np.dstack([f, np.full((H, W), 9, np.uint8)]) for f in frames]
    pays = [p for p, _ in api.Encoder(CFG, _fmt(api, name), device="cpu").encode_batch(frames)]
    return pays[:5], pays[5:], frames


@pytest.mark.parametrize("call", ["decode_batch", "decode"])
@pytest.mark.parametrize("name", ["rgb24", "rgb32"])
def test_decoded_frames_own_their_storage(call, name):
    """No decoded frame shares memory with another of its call or of a
    later call, though idle P frames decode to their previous frame; a
    caller writing into a frame changes nothing that comes after."""
    first, second, frames = _idle_stream(name)
    dec = api.Decoder(CFG, device="cpu")

    def run(pays):
        return dec.decode_batch(pays) if call == "decode_batch" else [dec.decode(p) for p in pays]

    out1 = run(first)
    for o in out1:
        o[...] = 77  # the caller reuses what it got
    out2 = run(second)
    outs = out1 + out2
    assert not any(np.shares_memory(a, b) for i, a in enumerate(outs) for b in outs[i + 1:])
    want = [f.copy() for f in frames[5:]]
    if name == "rgb32":
        for w in want:
            w[..., 3] = 255
    for o, w in zip(out2, want, strict=True):
        np.testing.assert_array_equal(o, w)


@pytest.mark.parametrize("layout", ["reused_buffer", "strided"])
def test_caller_may_refill_its_rgb32_buffer(frames_as, layout):
    """Frames handed in from one buffer the caller refills after each
    encode_batch (as a capture loop does), or as strided views, give the
    bytes of fresh contiguous frames: the session's previous frame is its
    own, so the next batch's first P frame is coded against it."""
    frames = source_frames("rgb32", seed=2)
    fresh = api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu")
    want = fresh.encode_batch([f.copy() for f in frames[:4]])
    want += fresh.encode_batch([f.copy() for f in frames[4:8]])
    enc = api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu")
    if layout == "strided":
        wide = [np.repeat(f, 2, axis=1) for f in frames[:8]]
        got = enc.encode_batch([f[:, ::2] for f in frames_as(wide[:4])])
        got += enc.encode_batch([f[:, ::2] for f in frames_as(wide[4:])])
    else:
        buf = np.empty((4, H, W, 4), np.uint8)
        buf[:] = frames[:4]
        got = enc.encode_batch(frames_as(buf))
        buf[:] = 200  # refilled: the next frames are not ready yet
        buf[:] = frames[4:8]
        got += enc.encode_batch(frames_as(buf))
    assert got == want
    assert [t for _, t in got[4:]].count(1) >= 3  # P frames coded against the previous


def test_rgb32_frames_torch_cannot_view_give_the_same_bytes():
    """Numpy frames with negative strides (a bottom-up DIB's rows) or in
    read-only memory are copied first and give the bytes of plain frames."""
    frames = source_frames("rgb32", seed=3)[:4]
    want = api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu").encode_batch(frames)
    flipped = [np.ascontiguousarray(f[::-1])[::-1] for f in frames[:2]]
    readonly = [f.copy() for f in frames[2:]]
    for f in readonly:
        f.setflags(write=False)
    assert all(f.strides[0] < 0 for f in flipped)
    got = api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu").encode_batch(flipped + readonly)
    assert got == want


def test_rgb32_frame_shape_is_checked_on_the_card_path():
    """The batch path (the one every RGB32 session takes) refuses a frame
    of another shape."""
    enc = api.Encoder(CFG, _fmt(api, "rgb32"), device="cpu")
    for bad in (np.zeros((H, W, 3), np.uint8), np.zeros((H, W + 1, 4), np.uint8),
                np.zeros((1, W, 4), np.uint8)):
        with pytest.raises(ValueError):
            enc.encode_batch([bad])


def test_own_frames_gives_each_slot_its_storage():
    """codec.own_frames: a tensor repeated in several slots, or the session's
    previous frame, is copied; every other slot is handed out as it is."""
    from screenpressor_tpu_torch.codec import own_frames

    a, b, prev = (torch.full((2, 3, 3), v, dtype=torch.uint8) for v in (1, 2, 3))
    got = own_frames([a, a, b, prev, a, prev], prev)
    assert got[0] is a and got[2] is b
    ptrs = [g.data_ptr() for g in got]
    assert len(set(ptrs)) == len(ptrs) and prev.data_ptr() not in ptrs
    for g, want in zip(got, (1, 1, 2, 3, 1, 3)):
        assert (g == want).all()


def test_reused_buffer_grows_and_is_reused():
    """codec.ReusedBuffer hands out views of one block, which grows only
    when a call needs more."""
    from screenpressor_tpu_torch.codec import ReusedBuffer

    buf = ReusedBuffer(torch.device("cpu"))
    small = buf.take((2, 3))
    again = buf.take((3, 2))
    assert again.data_ptr() == small.data_ptr() and again.shape == (3, 2)
    big = buf.take((4, 5))
    assert big.shape == (4, 5) and big.dtype == torch.uint8
    assert buf.take((2, 2)).data_ptr() == big.data_ptr()
