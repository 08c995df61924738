"""Synthetic screen frames (numpy only): the screencast of the port's smoke
run and of the JAX package's benchmark (`bench.synth_screencast`), and the
keyframe of its multi-device dryrun (`synth_frame`), whose pixels these
reproduce exactly."""

from __future__ import annotations

import numpy as np


def synth_screencast(h, w, n_frames, seed=0):
    """Desktop-like content: a window with text lines, then frames that
    cycle through scroll, typing (a small local change) and idle."""
    rng = np.random.default_rng(seed)
    base = np.full((h + 16 * n_frames, w, 3), (40, 44, 52), np.uint8)
    base[40: h - 40, 60: w - 60] = (250, 250, 250)
    for y in range(48, h - 48, 14):
        lo, hi = w // 4, max(w - 140, w // 4 + 2)
        ln = int(rng.integers(lo, hi))
        base[y: y + 8, 70: min(70 + ln, w - 1): 2] = (20, 20, 24)
    frames = [base[:h].copy()]
    for i in range(1, n_frames):
        kind = i % 4
        if kind == 1:  # scroll
            frames.append(base[8 * i: 8 * i + h].copy())
        elif kind == 2:  # typing
            f = frames[-1].copy()
            y = 20 + (i * 17) % max(h - 40, 1)
            x = 20 + (i * 41) % max(w - 40, 1)
            f[y: min(y + 10, h), x: min(x + 8, w)] = (200, 30, 30)
            frames.append(f)
        else:  # idle
            frames.append(frames[-1].copy())
    return frames


def synth_frame(h, w, seed=0):
    """One desktop-like keyframe (a window with text strokes): the frame of
    the JAX package's multi-device dryrun (`__graft_entry__._synth_frame`),
    whose pixels this reproduces exactly."""
    rng = np.random.default_rng(seed)
    f = np.full((h, w, 3), (40, 44, 52), np.uint8)
    f[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = (250, 250, 250)
    for i in range(h // 8):
        y = h // 4 + 3 * i
        if y + 1 < 3 * h // 4:
            f[y, w // 4 + 2: w // 4 + 2 + int(rng.integers(4, w // 2))] = (20, 20, 20)
    return f
