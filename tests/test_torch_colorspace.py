"""The port's colorspace.py against the reference's, exactly: the host
(numpy) conversions, the torch conversions on CPU tensors (and the
reference's jnp ones), the `*_any` dispatch, and the DIB helpers with pitch
adaptation."""

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


@pytest.mark.parametrize("fn", ["rgb16_to_rgb24", "rgb24_to_rgb16", "rgb32_to_rgb24",
                                "rgb24_to_rgb32"])
def test_any_keeps_tensors_tensors_and_numpy_numpy(fn):
    f16, f24, f32 = _frames(4, 5, 7)
    src = {"rgb16_to_rgb24": f16, "rgb24_to_rgb16": f24, "rgb32_to_rgb24": f32,
           "rgb24_to_rgb32": f24}[fn]
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
