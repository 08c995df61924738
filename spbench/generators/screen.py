"""Traffic generator `screen`: seeded, endless screen-capture frames whose
cycle a traffic file (`spbench/traffic/<mix>.json`, `"generator":
"screen"`) sets. A generator is a module `spbench/generators/<name>.py`
with a class `Screen(traffic, h, w, seed)`; the drivers use `frame`,
`fill_rgb32`, `stream_frame`, `to_device` and `streams` (see below), so a
new kind of content is a new module (which may subclass this one).

A frozen, extended copy of `screenpressor_tpu_torch/synth.py`
`synth_screencast` (the screencast of every earlier smoke run): the same
desktop background (40, 44, 52), a white window inset 60 columns and 40
rows, text lines every 14 rows starting 10 columns in, seeded line lengths of w / 4 to w - 140, the same cycle of frame kinds
by frame index (`i % 4`), a scroll that shows page rows from `8 * i` at
frame i, and the typing change of synth_screencast (an 8 x 10 red box at
`20 + (i * 17) % (h - 40)`, `20 + (i * 41) % (w - 40)`). What differs:

- the page is endless: a band of page rows, a multiple of the window's
  height and of the line pitch, that the window scrolls through and wraps
  around, and only the window's inside scrolls (the background and the
  window frame stay, as in a browser);
- the text is drawn with a seeded bitmap font of stroke glyphs (words of
  2 to 8 glyphs, one in ten words in link blue), not as dashed bars, so
  that neither the coder nor the motion search meets a pattern that
  repeats every two columns;
- a `flip` kind shows the next page (page height = the window's inside:
  PageDown through a document), where the motion search finds little.

Frames are pure functions of (traffic, size, seed, frame index), so a run
rebuilds any input after its window to judge the output. The multi-stream
form (`chip_smoke.serving_batches`) rolls stream i's frame by
`stream_roll_cols * i` columns; `streams` renders a step of all streams on
the card from the page uploaded once by `to_device` (no host frame and no
upload a step).
"""

from __future__ import annotations

import math

import numpy as np

BACKGROUND = (40, 44, 52)
WINDOW = (250, 250, 250)
INK = (20, 20, 24)
LINK = (30, 80, 200)
TYPED = (200, 30, 30)


def _pack(rgb) -> int:
    return rgb[0] | (rgb[1] << 8) | (rgb[2] << 16)


def _font(n: int, gh: int, gw: int, seed: int) -> np.ndarray:
    """n stroke glyphs of gh x gw: each the union of two to four strokes
    (full or half verticals, horizontals at top / middle / bottom, one
    diagonal), so that rows and columns repeat as in real type."""
    rng = np.random.default_rng(seed)
    font = np.zeros((n, gh, gw), bool)
    for g in font:
        for _ in range(int(rng.integers(2, 5))):
            kind = int(rng.integers(0, 4))
            if kind == 0:  # vertical
                x = int(rng.integers(0, gw))
                y0 = int(rng.integers(0, gh // 2))
                g[y0:, x] = True
            elif kind == 1:  # horizontal
                y = (0, gh // 2, gh - 1)[int(rng.integers(0, 3))]
                g[y, int(rng.integers(0, 2)):gw - int(rng.integers(0, 2))] = True
            elif kind == 2:  # half vertical
                x = int(rng.integers(0, gw))
                g[:gh // 2 + 1, x] = True
            else:  # diagonal
                for y in range(gh):
                    g[y, min(gw - 1, y * gw // gh)] = True
    return font


class Screen:
    """One screen of the traffic at h x w for one seed."""

    def __init__(self, traffic: dict, h: int, w: int, seed: int):
        self.t, self.h, self.w = traffic, h, w
        self.cycle = traffic["cycle"]
        self.top, self.left = 40, 60
        self.inner_h, self.inner_w = h - 2 * self.top, w - 2 * self.left
        pitch = traffic["line_pitch"]
        unit = self.inner_h * pitch // math.gcd(self.inner_h, pitch)
        self.page_rows = unit * max(1, -(-traffic["page_min_rows"] // unit))
        self.page = self._page(pitch, np.random.default_rng([seed, 1]))
        self.scroll = traffic["scroll_rows_per_frame"]
        self.alpha = None
        if traffic.get("alpha") == "seeded":
            self.alpha = np.random.default_rng([seed, 2]).integers(
                0, 256, (h, w), dtype=np.uint8)

    def _page(self, pitch: int, rng) -> np.ndarray:
        t = self.t
        gh, gw = t["glyph_h"], t["glyph_w"]
        font = _font(t["font_glyphs"], gh, gw, t["font_seed"])
        cell = gw + 1
        lines = self.page_rows // pitch
        cols = (self.inner_w - 20) // cell
        lo, hi = self.w // 4, max(self.w - 140, self.w // 4 + 2)
        # glyph index per (line, cell), -1 blank; one colour a word
        grid = np.full((lines, cols), -1, np.int64)
        blue = np.zeros((lines, cols), bool)
        for ln in range(lines):
            end = min(cols, int(rng.integers(lo, hi)) // cell)
            c = 0
            while c < end:
                stop = min(c + int(rng.integers(2, 9)), end)
                grid[ln, c:stop] = rng.integers(0, len(font), stop - c)
                blue[ln, c:stop] = rng.random() < 0.1
                c = stop + 1
        ink = np.zeros((lines, cols, gh, cell), bool)
        ink[..., :gw] = font[np.maximum(grid, 0)] & (grid >= 0)[..., None, None]
        ink = ink.transpose(0, 2, 1, 3).reshape(lines, gh, cols * cell)
        colour = np.where(blue[..., None], np.array(LINK, np.uint8), np.array(INK, np.uint8))
        colour = np.repeat(colour, cell, axis=1)[:, None]  # [lines, 1, cols * cell, 3]
        page = np.empty((lines, pitch, self.inner_w, 3), np.uint8)
        page[:] = WINDOW
        y0 = (pitch - gh) // 2
        page[:, y0:y0 + gh, 10:10 + cols * cell] = np.where(
            ink[..., None], colour, np.array(WINDOW, np.uint8))
        return page.reshape(self.page_rows, self.inner_w, 3)

    # -- frames --------------------------------------------------------------

    def kind(self, i: int) -> str:
        return "key" if i == 0 else self.cycle[i % len(self.cycle)]

    def _last(self, i: int, kinds) -> int:
        """The last frame index <= i of one of `kinds` (0 when none)."""
        n = len(self.cycle)
        for back in range(n):
            j = i - back
            if j <= 0:
                return 0
            if self.cycle[j % n] in kinds:
                return j
        return 0

    def offset(self, i: int) -> int:
        moved = self._last(i, ("scroll", "flip"))
        if moved == 0:
            return 0
        n = len(self.cycle)
        if self.cycle[moved % n] == "flip":
            flips = (moved // n) * self.cycle.count("flip") + sum(
                1 for j in range(moved // n * n, moved + 1) if j and self.cycle[j % n] == "flip")
            return (flips * self.inner_h) % self.page_rows
        return (self.scroll * moved) % self.page_rows

    def _typed_at(self, i: int):
        """(y, x) of the typed box frame i shows, or None."""
        typed = self._last(i, ("type", "scroll", "flip"))
        if typed and self.cycle[typed % len(self.cycle)] == "type":
            return (20 + (typed * 17) % max(self.h - 40, 1),
                    20 + (typed * 41) % max(self.w - 40, 1))
        return None

    def _window(self, i: int, out, page) -> None:
        """Write the window's inside of frame i into out[top:.., left:..]
        from `page` (rows wrap around the page's end)."""
        off = self.offset(i)
        region = out[self.top:self.h - self.top, self.left:self.w - self.left]
        k = min(self.inner_h, self.page_rows - off)
        region[:k] = page[off:off + k]
        region[k:] = page[:self.inner_h - k]

    def frame(self, i: int) -> np.ndarray:
        """Frame i as [h, w, 3] uint8 RGB."""
        f = np.empty((self.h, self.w, 3), np.uint8)
        f[:] = BACKGROUND
        self._window(i, f, self.page)
        at = self._typed_at(i)
        if at is not None:
            f[at[0]:at[0] + 10, at[1]:at[1] + 8] = TYPED
        return f

    def fill_rgb32(self, out: np.ndarray, i: int) -> None:
        """Write frame i into out ([h, w, 4] uint8) with the seeded alpha
        plane (255 without one): one pass of 32-bit words."""
        if not hasattr(self, "_bg32"):
            alpha = (np.full((self.h, self.w), 255, np.uint32) if self.alpha is None
                     else self.alpha.astype(np.uint32)) << 24
            self._bg32 = np.uint32(_pack(BACKGROUND)) | alpha
            self._alpha_win = alpha[self.top:self.h - self.top, self.left:self.w - self.left]
            p = self.page.astype(np.uint32)
            self._page32 = p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)
        o32 = out.view(np.uint32)[..., 0]
        o32[:] = self._bg32
        self._window(i, o32, self._page32)
        o32[self.top:self.h - self.top, self.left:self.w - self.left] |= self._alpha_win
        at = self._typed_at(i)
        if at is not None:
            out[at[0]:at[0] + 10, at[1]:at[1] + 8, :3] = TYPED

    def frame_rgb32(self, i: int) -> np.ndarray:
        """Frame i as [h, w, 4] uint8."""
        f = np.empty((self.h, self.w, 4), np.uint8)
        self.fill_rgb32(f, i)
        return f

    def stream_frame(self, i: int, s: int) -> np.ndarray:
        """Stream s's frame i as [h, w, 3] uint8 RGB (on the host)."""
        roll = self.t.get("stream_roll_cols", 0)
        return self.frame(i)[:, (np.arange(self.w) - roll * s) % self.w]

    def to_device(self, n: int, device) -> None:
        """Upload what `streams` renders n streams from: the page with the
        window's margins (row 0 the background, the first window of rows
        again at the end, so that no index wraps) and the column rolls."""
        import torch

        ext = np.empty((1 + self.page_rows + self.inner_h, self.w, 3), np.uint8)
        ext[:] = BACKGROUND
        inside = ext[:, self.left:self.w - self.left]
        inside[1:1 + self.page_rows] = self.page
        inside[1 + self.page_rows:] = self.page[:self.inner_h]
        self._dev_page = torch.as_tensor(ext, device=device)
        self._dev_cols = torch.as_tensor(self.stream_cols(n), device=device)
        rows = torch.arange(self.h, device=device)
        self._dev_rows = rows - self.top + 1
        self._dev_inside = (rows >= self.top) & (rows < self.h - self.top)
        self._dev_typed = torch.tensor(TYPED, dtype=torch.uint8, device=device)

    def streams(self, i: int):
        """Frame i of the n streams of `to_device` as a [n, h, w, 3] uint8
        tensor on the card: a row gather from the page, the typed box,
        then each stream's column roll (a few kernels, no host sync)."""
        import torch

        rows = torch.where(self._dev_inside, self._dev_rows + self.offset(i), 0)
        base = self._dev_page.index_select(0, rows)
        at = self._typed_at(i)
        if at is not None:
            base[at[0]:at[0] + 10, at[1]:at[1] + 8] = self._dev_typed
        return base[:, self._dev_cols].permute(1, 0, 2, 3).contiguous()

    def stream_cols(self, n: int) -> np.ndarray:
        """[n, w]: stream s's column x shows frame() column cols[s, x], a
        roll by stream_roll_cols * s columns."""
        roll = self.t.get("stream_roll_cols", 0)
        return (np.arange(self.w)[None, :] - roll * np.arange(n)[:, None]) % self.w
