"""The port's colorspace.py against the reference's, exactly: the host
(numpy) conversions, the torch conversions on CPU tensors (and the
reference's jnp ones), the RGB16 `*_any` dispatch, the RGB32 batch
functions' plain versions, and the DIB helpers with pitch adaptation."""

import numpy as np
import pytest
import torch

from screenpressor_tpu import colorspace as ref
from screenpressor_tpu_torch import colorspace as cs

# 565, 555, 444, BGR565, and masks wider than 8 bits (the uint8 wrap) or
# overlapping (the uint16 wrap of the packed sum)
MASKS = [(0xF800, 0x07E0, 0x001F), (0x7C00, 0x03E0, 0x001F), (0x0F00, 0x00F0, 0x000F),
         (0x001F, 0x07E0, 0xF800), (0xFF80, 0x0070, 0x000F), (0xFFFF, 0x0FF0, 0x0001)]
MASK_IDS = ["565", "555", "444", "bgr565", "wide_red", "overlap"]


def _frames(seed, h=17, w=23):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, (h, w), dtype=np.uint16),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 4), dtype=np.uint8))


@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
def test_rgb16_conversions_equal_reference(masks):
    import jax.numpy as jnp

    f16, f24, _ = _frames(1)
    want24 = ref.rgb16_to_rgb24(f16, *masks)
    want16 = ref.rgb24_to_rgb16(f24, *masks)
    np.testing.assert_array_equal(cs.rgb16_to_rgb24(f16, *masks), want24)
    np.testing.assert_array_equal(cs.rgb24_to_rgb16(f24, *masks), want16)
    got24 = cs.rgb16_to_rgb24_device(torch.as_tensor(f16), *masks)
    got16 = cs.rgb24_to_rgb16_device(torch.as_tensor(f24), *masks)
    assert got24.dtype == torch.uint8 and got16.dtype == torch.uint16
    np.testing.assert_array_equal(got24.numpy(), want24)
    np.testing.assert_array_equal(got16.numpy(), want16)
    np.testing.assert_array_equal(
        got24.numpy(), np.asarray(ref.rgb16_to_rgb24_device(jnp.asarray(f16), *masks)))
    np.testing.assert_array_equal(
        got16.numpy(), np.asarray(ref.rgb24_to_rgb16_device(jnp.asarray(f24), *masks)))


@pytest.mark.parametrize("masks", MASKS[:3], ids=MASK_IDS[:3])
def test_rgb16_round_trip_in_mask_range(masks):
    """The raw masked bits round-trip, no scaling."""
    f16 = _frames(2)[0] & np.uint16(masks[0] | masks[1] | masks[2])
    back = cs.rgb24_to_rgb16_device(cs.rgb16_to_rgb24_device(torch.as_tensor(f16), *masks),
                                    *masks)
    np.testing.assert_array_equal(back.numpy(), f16)
    np.testing.assert_array_equal(cs.rgb24_to_rgb16(cs.rgb16_to_rgb24(f16, *masks), *masks),
                                  f16)


def test_rgb32_conversions_equal_reference():
    import jax.numpy as jnp

    _, f24, f32 = _frames(3)
    np.testing.assert_array_equal(cs.rgb32_to_rgb24(f32), ref.rgb32_to_rgb24(f32))
    np.testing.assert_array_equal(cs.rgb24_to_rgb32(f24), ref.rgb24_to_rgb32(f24))
    got24 = cs.rgb32_to_rgb24_device(torch.as_tensor(f32))
    got32 = cs.rgb24_to_rgb32_device(torch.as_tensor(f24))
    np.testing.assert_array_equal(got24.numpy(), ref.rgb32_to_rgb24(f32))
    np.testing.assert_array_equal(got32.numpy(), ref.rgb24_to_rgb32(f24))
    np.testing.assert_array_equal(
        got32.numpy(), np.asarray(ref.rgb24_to_rgb32_device(jnp.asarray(f24))))
    assert (got32[..., 3] == 255).all() and got32.dtype == torch.uint8


@pytest.mark.parametrize("fn", ["rgb16_to_rgb24", "rgb24_to_rgb16"])
def test_any_keeps_tensors_tensors_and_numpy_numpy(fn):
    f16, f24, _ = _frames(4, 5, 7)
    src = {"rgb16_to_rgb24": f16, "rgb24_to_rgb16": f24}[fn]
    args = MASKS[0] if "16" in fn else ()
    host = getattr(cs, fn + "_any")(src, *args)
    dev = getattr(cs, fn + "_any")(torch.as_tensor(src), *args)
    assert isinstance(host, np.ndarray) and isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(host, getattr(ref, fn + "_any")(src, *args))


def test_mask_shift_equals_reference():
    for m in (0x1, 0x8000, 0x07E0, 0x00F0, 0xFF80):
        assert cs.mask_shift(m) == ref.mask_shift(m)
    with pytest.raises(ValueError):
        cs.mask_shift(0)


@pytest.mark.parametrize("bpp", [24, 32])
@pytest.mark.parametrize("w", [23, 24])
@pytest.mark.parametrize("pad", [None, 5, 40])
def test_dib_round_trips_equal_reference(bpp, w, pad):
    """to_dib at the natural pitch or a wider output pitch, and from_dib
    back: the reference's bytes and planes."""
    h = 17
    f = np.random.default_rng(11 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    stride = None if pad is None else cs.dib_stride(w, bpp) + pad
    buf = cs.to_dib(f, bpp, stride=stride)
    assert buf == ref.to_dib(f, bpp, stride=stride)
    assert len(buf) == (stride or cs.dib_stride(w, bpp)) * h
    back = cs.from_dib(buf, w, h, bpp, stride=stride)
    np.testing.assert_array_equal(back, ref.from_dib(buf, w, h, bpp, stride=stride))
    np.testing.assert_array_equal(back, f)
    if bpp == 32:
        raw = np.frombuffer(buf, np.uint8).reshape(h, -1)
        assert (raw[:, 3: w * 4: 4] == 255).all()


def test_dib_errors():
    f = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError):
        cs.to_dib(f, 24, stride=14)
    with pytest.raises(ValueError):
        cs.from_dib(b"\0" * 10, 5, 4, 24)


# -- the batch conversions (K7's plain versions) ------------------------------

K7_WIDTHS = [1, 7, 1918, 1920]


def _batch(seed, n, w, ch, h=3):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, ch), dtype=np.uint8)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("w", K7_WIDTHS)
@pytest.mark.parametrize("direction", ["rgb32_to_rgb24", "rgb24_to_rgb32"])
def test_batch_conversions_equal_reference(direction, w, layout):
    """The batch functions on CPU tensors give the reference's frames byte
    for byte (its numpy and jnp conversions), from contiguous input and
    from strided views (every other frame of a batch; every other column of
    a frame); every RGB24 frame they make is in storage of its own, and an
    RGB24 frame may fill several slots."""
    import jax.numpy as jnp

    n = 3
    if direction == "rgb32_to_rgb24":
        src = _batch(w, n, w, 4)
        t = torch.as_tensor(src if layout == "contiguous" else np.repeat(src, 2, axis=0))
        if layout == "strided":
            t = t[::2]
            assert not t.is_contiguous()
        got = cs.rgb32_to_rgb24_batch(t)
        assert len(got) == n
        for g, f in zip(got, src, strict=True):
            assert g.is_contiguous() and g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), ref.rgb32_to_rgb24(f))
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(ref.rgb32_to_rgb24_device(jnp.asarray(f))))
        arrays = [g.numpy() for g in got] + [t.numpy()]
        assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays)
                       for b in arrays[i + 1:])
        return
    src = _batch(w, n, w, 3)
    frames = [torch.as_tensor(f if layout == "contiguous" else np.repeat(f, 2, axis=1))
              for f in src]
    if layout == "strided":
        frames = [f[:, ::2] for f in frames]
        assert w == 1 or not any(f.is_contiguous() for f in frames)
    got = cs.rgb24_to_rgb32_batch(frames + [frames[0]])
    assert got.shape == (n + 1, 3, w, 4) and got.dtype == torch.uint8
    for g, f in zip(got, list(src) + [src[0]], strict=True):
        np.testing.assert_array_equal(g.numpy(), ref.rgb24_to_rgb32(f))
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(ref.rgb24_to_rgb32_device(jnp.asarray(f))))
