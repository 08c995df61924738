"""The traffic generator: deterministic per seed, and the frame-kind cycle
each traffic file states."""

import numpy as np
import pytest
from spbench_support import traffic

from spbench.generators.screen import TYPED, Screen


@pytest.mark.parametrize("mix", ["browse", "pages", "staggered"])
def test_same_seed_same_frames(mix):
    a = Screen(traffic(mix), 120, 200, 2**31 + 7)
    b = Screen(traffic(mix), 120, 200, 2**31 + 7)
    c = Screen(traffic(mix), 120, 200, 2**31 + 8)
    for i in (0, 1, 2, 5, 37):
        assert np.array_equal(a.frame(i), b.frame(i))
    assert not np.array_equal(a.frame(0), c.frame(0))


@pytest.mark.parametrize("mix", ["browse", "pages"])
def test_cycle(mix):
    t = traffic(mix)
    s = Screen(t, 120, 200, 5)
    moving = "scroll" if mix == "browse" else "flip"
    assert [s.kind(i) for i in range(9)] == [
        "key", moving, "type", "idle", "idle", moving, "type", "idle", "idle"]
    f = [s.frame(i) for i in range(10)]
    for i in range(1, 10):
        kind = s.kind(i)
        changed = not np.array_equal(f[i], f[i - 1])
        assert changed == (kind in ("scroll", "flip", "type")), (i, kind)
        typed = (f[i] == np.array(TYPED, np.uint8)).all(axis=-1)
        # the typed box stays from a typing frame until the next scroll or flip
        assert typed.any() == (kind in ("type", "idle") and i >= 2), (i, kind)
    # a scroll shows page rows 8 * i further down; a flip the next page
    inner = s.inner_h
    off5 = s.offset(5)
    assert off5 == (8 * 5 if mix == "browse" else 2 * inner) % s.page_rows
    assert np.array_equal(f[5][s.top:s.top + inner, s.left:s.w - s.left],
                          s.page[(off5 + np.arange(inner)) % s.page_rows])


def test_endless_page_wraps():
    s = Screen(traffic("browse"), 120, 200, 5)
    i = 4 * (s.page_rows // 32) + 1  # the scroll that wraps to the top
    assert s.offset(i) == (8 * i) % s.page_rows
    assert s.frame(i).shape == (120, 200, 3)


def test_rgb32_fill_matches_rgb24():
    s = Screen(traffic("browse"), 120, 200, 9)
    for i in range(8):
        f = s.frame_rgb32(i)
        assert np.array_equal(f[..., :3], s.frame(i))
        assert np.array_equal(f[..., 3], s.alpha)


def test_streams_rolled():
    t = traffic("staggered")
    s = Screen(t, 120, 200, 3)
    cols = s.stream_cols(4)
    for k in range(4):
        assert np.array_equal(s.frame(6)[:, cols[k]],
                              np.roll(s.frame(6), t["stream_roll_cols"] * k, axis=1))


@pytest.mark.parametrize("mix", ["browse", "pages", "staggered"])
def test_device_streams_match_host(mix):
    """The card's rendering of a step (here on the CPU) equals the host's
    frame of every stream, for every frame kind and across the page's end."""
    s = Screen(traffic(mix), 120, 200, 2**31 + 5)
    s.to_device(3, "cpu")
    wrap = 4 * (s.page_rows // 32) + 1
    for i in (0, 1, 2, 3, 5, 6, wrap, wrap + 1):
        got = s.streams(i).numpy()
        for k in range(3):
            assert np.array_equal(got[k], s.stream_frame(i, k)), (i, k)
