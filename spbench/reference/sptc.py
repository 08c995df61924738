"""A plain NumPy decoder of the SPTC bitstream (FORMAT.md, revision 4).

The benchmark's judge of the encoder's bytes: it reads a stream's payloads
and gives back RGB24 frames, independent of the code under test. It is a
frozen copy of the format's executable specification (the numpy `spec`
package beside the JAX package: `tables.Table`, `coder.decode_section` and
its record codecs, `classify.reconstruct_i`, `pframe.decode_p`,
`bitstream.unpack_section` / `read_varint` / `parse_format_prefix`), with
the experiment switches taken out and two loops vectorised so that a
1080p session decodes in seconds:

- a section's K lanes decode one sub-step at a time as NumPy arrays over
  the lanes (the same lookups, rANS advances and batched table updates,
  in the same order);
- a P frame's data blocks rebuild row by row over all blocks at once, and
  its motion blocks copy in one gather.

It imports nothing but NumPy.
"""

from __future__ import annotations

import struct

import numpy as np

PROB_BITS = 14
PROB_SCALE = 1 << PROB_BITS
MASK = PROB_SCALE - 1
RANS_L = 1 << 23
STEP = 512
SHIFT = 13  # RESCALE_SHIFT
MIX_ESC_C = 256
K_MAX = 256
TARGET_PER_LANE = 256
LANE_THIN_FLOOR, LANE_THIN_MULT = 32, 16
BLOCK = 16
MV_OFFSET = 256
COLOR_ROWS = 1 << 12  # 8 + 4 context bits a plane

VERSION = 0xA
ALG_FLAT, ALG_I, ALG_P, ALG_RAW, ALG_FMT = 1, 2, 3, 4, 5
PT_LITERAL, PT_LEFT, PT_ABOVE, PT_PREVFRAME, PT_GRADIENT, PT_ABOVELEFT = range(6)

# kind -> (context rows, alphabet, mixed with a global row)
KINDS = {
    "ptype": (6, 6, False),
    "nrun": (6, 256, True),
    "color": (3 * COLOR_ROWS, 256, True),
    "bt": (1, 5, False),
    "btn": (1, 256, False),
    "sxy": (4, 16, False),
    "mvflag": (1, 2, False),
    "mv": (2, 512, False),
}


class CorruptStreamError(Exception):
    pass


# ---------------------------------------------------------------------------
# adaptive tables


class Table:
    """One table kind: `rows` contexts over an alphabet of `a` symbols, live
    counts, scale-to-fill rescale; a mixed kind backs off to one global
    row with the escalating weight of FORMAT.md."""

    def __init__(self, rows: int, a: int, mixed: bool):
        self.a, self.mixed = a, mixed
        self.cnt = np.zeros((rows, a), np.int64)
        self.cntsum = np.zeros(rows, np.int64)
        self.gcnt = np.zeros(a, np.int64)
        self.gsum = 0
        self.renew()

    def renew(self) -> None:
        fill = max((PROB_SCALE - STEP - self.a) // self.a, 1)
        if self.mixed:
            self.gcnt[:] = fill
            self.gsum = fill * self.a
            fill = 0
        self.cnt[:] = fill
        self.cntsum[:] = fill * self.a

    def eff(self, rows: np.ndarray) -> np.ndarray:
        """[m, a] coding frequencies of the rows."""
        c = self.cnt[rows]
        if not self.mixed:
            return c
        a = self.a
        s = self.cntsum[rows]
        target = ((PROB_SCALE - 2 * a) * s) // (s + MIX_ESC_C)
        sc_r = (target << SHIFT) // np.maximum(s, 1)
        row_eff = (c * sc_r[:, None]) >> SHIFT
        spare = (PROB_SCALE - a) - row_eff.sum(axis=1)
        sc = (spare << SHIFT) // self.gsum
        return row_eff + np.maximum((self.gcnt[None, :] * sc[:, None]) >> SHIFT, 1)

    def update(self, rows: np.ndarray, syms: np.ndarray) -> None:
        """One sub-step's batched update, then the rescales it triggers."""
        np.add.at(self.cnt, (rows, syms), STEP)
        np.add.at(self.cntsum, rows, STEP)
        ur = np.unique(rows)
        hot = ur[self.cntsum[ur] > PROB_SCALE - STEP]
        if hot.size:
            sc = ((PROB_SCALE - STEP - self.a) << SHIFT) // self.cntsum[hot]
            c = np.maximum((self.cnt[hot] * sc[:, None]) >> SHIFT, 1)
            self.cnt[hot] = c
            self.cntsum[hot] = c.sum(axis=1)
        if self.mixed:
            np.add.at(self.gcnt, syms, STEP)
            self.gsum += STEP * len(syms)
            if self.gsum > PROB_SCALE - STEP:
                sc = ((PROB_SCALE - STEP - self.a) << SHIFT) // self.gsum
                self.gcnt[:] = np.maximum((self.gcnt * sc) >> SHIFT, 1)
                self.gsum = int(self.gcnt.sum())


class Tables:
    def __init__(self):
        self.t = {name: Table(*spec) for name, spec in KINDS.items()}

    def renew(self) -> None:
        for t in self.t.values():
            t.renew()


# ---------------------------------------------------------------------------
# lanes and sections


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def lane_count(n: int, k_fixed: int | None = None) -> int:
    """FORMAT.md "Lane policy" (or the serving profile's fixed count)."""
    if k_fixed is not None:
        return k_fixed
    if n <= 0:
        return 1
    k = next_pow2(-(-n // TARGET_PER_LANE))
    if k > LANE_THIN_FLOOR:
        k = max(LANE_THIN_FLOOR, next_pow2(-(-n // (LANE_THIN_MULT * TARGET_PER_LANE))))
    return min(K_MAX, k)


def read_varints(data: bytes, pos: int, n: int):
    vals = []
    for _ in range(n):
        v = shift = 0
        while True:
            if pos >= len(data):
                raise CorruptStreamError("truncated varint header")
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 35:
                raise CorruptStreamError("varint overflow")
        vals.append(v)
    return vals, pos


_WIDTHS = (1, 2, 4)
_WIDTH_FMT = {1: "B", 2: "H", 4: "I"}


def unpack_section(data: bytes, pos: int, k_expected: int):
    """-> (lane sizes, lane blobs joined, position past the section)."""
    if pos >= len(data):
        raise CorruptStreamError("truncated section header")
    status = data[pos]
    k = 1 << (status & 0x0F)
    wcode = (status >> 4) & 0x03
    if wcode >= len(_WIDTHS):
        raise CorruptStreamError(f"bad section width code {wcode}")
    if k != k_expected:
        raise CorruptStreamError(f"lane count mismatch: stream {k}, policy {k_expected}")
    w = _WIDTHS[wcode]
    pos += 1
    if pos + w * k > len(data):
        raise CorruptStreamError("truncated lane size table")
    sizes = np.asarray(struct.unpack_from(f"<{k}{_WIDTH_FMT[w]}", data, pos), np.int64)
    pos += w * k
    end = pos + int(sizes.sum())
    if end > len(data):
        raise CorruptStreamError("truncated lane payload")
    return sizes, data[pos:end], end


class _Lanes:
    """K rANS decoders advanced together as arrays."""

    def __init__(self, sizes: np.ndarray, blob: bytes, lens: np.ndarray):
        if ((lens > 0) & (sizes < 4)).any():
            raise CorruptStreamError("lane blob shorter than its state")
        self.buf = np.frombuffer(blob + bytes(8), np.uint8).astype(np.int64)
        self.end = np.cumsum(sizes)
        start = self.end - sizes
        b = self.buf
        s = np.minimum(start, len(b) - 4)
        self.x = b[s] | (b[s + 1] << 8) | (b[s + 2] << 16) | (b[s + 3] << 24)
        self.pos = start + 4

    def decode(self, table: Table, lanes: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """One symbol for each of `lanes` from its context row; advances
        those lanes and applies the sub-step's table update."""
        x = self.x[lanes]
        f = x & MASK
        eff = table.eff(rows)
        cum = np.cumsum(eff, axis=1) - eff
        sym = (cum <= f[:, None]).sum(axis=1) - 1
        ar = np.arange(len(lanes))
        x = eff[ar, sym] * (x >> PROB_BITS) + f - cum[ar, sym]
        pos = self.pos[lanes]
        for _ in range(4):
            need = x < RANS_L
            if not need.any():
                break
            if (pos[need] >= self.end[lanes][need]).any():
                raise CorruptStreamError("lane blob exhausted")
            x = np.where(need, (x << 8) | self.buf[pos], x)
            pos = pos + need
        self.x[lanes] = x
        self.pos[lanes] = pos
        table.update(rows, sym)
        return sym


def decode_section(data: bytes, pos: int, n: int, kind: str, tables: Tables,
                   k_fixed: int | None):
    """Decode one section of n records of `kind` (rec, col, bt, sxy, mv).
    -> ([n, fields] int64 records in stream order, position past it)."""
    k = lane_count(n, k_fixed)
    sizes, blob, pos = unpack_section(data, pos, k)
    width = {"rec": 2, "col": 3, "bt": 2, "sxy": 4, "mv": 2}[kind]
    if n == 0:
        return np.zeros((0, width), np.int64), pos
    base, rem = divmod(n, k)
    lens = base + (np.arange(k) < rem)
    steps = base + (rem > 0)
    lanes = _Lanes(sizes, blob, lens)
    t = tables.t
    out = np.zeros((k, steps, width), np.int64)
    state = np.zeros((k, 2), np.int64)  # prev ptype / (prev g, prev b) / prev mv
    for step in range(steps):
        act = np.arange(k if step < base else rem)
        if kind == "rec":
            pt = lanes.decode(t["ptype"], act, state[act, 0])
            nb = lanes.decode(t["nrun"], act, pt)
            out[act, step] = np.stack([pt, nb + 1], 1)
            state[act, 0] = pt
        elif kind == "col":
            pg, pb = state[act, 0], state[act, 1]
            r = lanes.decode(t["color"], act, (pg << 4) | (pb >> 4))
            g = lanes.decode(t["color"], act, COLOR_ROWS + ((pb << 4) | (r >> 4)))
            b = lanes.decode(t["color"], act, 2 * COLOR_ROWS + ((r << 4) | (g >> 4)))
            out[act, step] = np.stack([r, g, b], 1)
            state[act] = np.stack([g, b], 1)
        elif kind == "bt":
            zero = np.zeros(len(act), np.int64)
            bt = lanes.decode(t["bt"], act, zero)
            nb = lanes.decode(t["btn"], act, zero)
            out[act, step] = np.stack([bt, nb + 1], 1)
        elif kind == "sxy":
            for j in range(4):
                out[act, step, j] = lanes.decode(t["sxy"], act, np.full(len(act), j))
        else:  # mv
            flag = lanes.decode(t["mvflag"], act, np.zeros(len(act), np.int64))
            new = act[flag == 0]
            if new.size:
                mx = lanes.decode(t["mv"], new, np.zeros(new.size, np.int64))
                my = lanes.decode(t["mv"], new, np.ones(new.size, np.int64))
                state[new] = np.stack([mx, my], 1) - MV_OFFSET
            out[act, step] = state[act]
    valid = np.arange(steps)[None, :] < lens[:, None]
    return out[valid], pos


# ---------------------------------------------------------------------------
# pixels


def _runs(records: np.ndarray):
    """(ptype per pixel, literal index per pixel (-1 where none), record
    start per pixel) of a record list, every pixel of a literal run
    carrying its record's literal."""
    types, runs = records[:, 0], records[:, 1]
    lit_of = np.cumsum(types == PT_LITERAL) - 1
    pt = np.repeat(types, runs)
    lit = np.repeat(np.where(types == PT_LITERAL, lit_of, -1), runs)
    return pt, lit


def reconstruct_i(records: np.ndarray, lits: np.ndarray, h: int, w: int) -> np.ndarray:
    """The I-frame pixel model, as an affine scan along each row with the
    raster wrap carried from the row before."""
    pt, lit = _runs(records)
    start = np.zeros(h * w, bool)
    start[np.cumsum(records[:, 1]) - records[:, 1]] = True
    out = np.zeros((h, w, 3), np.int64)
    carry = np.zeros(3, np.int64)
    xs = np.arange(w)
    for y in range(h):
        rp = pt[y * w:(y + 1) * w]
        rl = lit[y * w:(y + 1) * w]
        above = out[y - 1] if y > 0 else np.zeros((w, 3), np.int64)
        al = np.empty_like(above)
        al[1:] = above[:-1]
        al[0] = carry
        known = np.zeros((w, 3), np.int64)
        m0 = (rp == PT_LITERAL) & start[y * w:(y + 1) * w]
        known[m0] = lits[rl[m0]]
        m2, m5 = rp == PT_ABOVE, rp == PT_ABOVELEFT
        known[m2] = above[m2]
        known[m5] = al[m5]
        reset = m0 | m2 | m5
        d = np.where((rp == PT_GRADIENT)[:, None], above - al, 0)
        d[reset] = 0
        lr = np.maximum.accumulate(np.where(reset, xs, -1))
        cs = np.cumsum(d, axis=0)
        has = (lr >= 0)[:, None]
        lrc = np.maximum(lr, 0)
        row = np.where(has, known[lrc], carry[None, :]) + cs - np.where(has, cs[lrc], 0)
        out[y] = row
        carry = row[-1]
    return (out & 0xFF).astype(np.uint8)


def decode_i(data: bytes, pos: int, tables: Tables, h: int, w: int,
             k_fixed: int | None) -> np.ndarray:
    (n_rec, n_lit), pos = read_varints(data, pos, 2)
    records, pos = decode_section(data, pos, n_rec, "rec", tables, k_fixed)
    lits, pos = decode_section(data, pos, n_lit, "col", tables, k_fixed)
    if int(records[:, 1].sum()) != h * w:
        raise CorruptStreamError("records do not tile the frame")
    if int((records[:, 0] == PT_LITERAL).sum()) != n_lit:
        raise CorruptStreamError("literal count mismatch")
    return reconstruct_i(records, lits, h, w)


def decode_p(data: bytes, pos: int, prev: np.ndarray, tables: Tables,
             k_fixed: int | None) -> np.ndarray:
    h, w, _ = prev.shape
    if pos >= len(data):
        raise CorruptStreamError("truncated P frame")
    flags = data[pos]
    pos += 1
    if not flags & 1:
        return prev.copy()
    (xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data), pos = read_varints(data, pos, 8)
    secs = []
    for n, kind in ((n_bt, "bt"), (n_sxy, "sxy"), (n_mv, "mv"), (n_pix, "rec"),
                    (n_lit, "col")):
        recs, pos = decode_section(data, pos, n, kind, tables, k_fixed)
        secs.append(recs)
    bt_recs, sxy, mvs, pix, lits = secs
    nbx, nby = -(-w // BLOCK), -(-h // BLOCK)
    if int(bt_recs[:, 1].sum()) != xx2 - xx1 + 1 or xx2 >= nbx * nby or xx1 > xx2:
        raise CorruptStreamError("block-type runs do not cover the xx range")
    bts = np.zeros(nbx * nby, np.int64)
    bts[xx1:xx2 + 1] = np.repeat(bt_recs[:, 0], bt_recs[:, 1])
    if (bts > 4).any():
        raise CorruptStreamError("bad block type")
    blk = np.nonzero(bts)[0]
    bt = bts[blk]
    bx, by = blk % nbx, blk // nbx
    x_lo, y_lo = bx * BLOCK, by * BLOCK
    rect = np.stack([x_lo, y_lo, np.minimum(x_lo + BLOCK, w), np.minimum(y_lo + BLOCK, h)], 1)
    part = (bt == 2) | (bt == 4)
    if part.sum() != n_sxy:
        raise CorruptStreamError("sub-rect count mismatch")
    rect[part] = np.stack([x_lo[part] + sxy[:, 0], y_lo[part] + sxy[:, 1],
                           x_lo[part] + sxy[:, 2] + 1, y_lo[part] + sxy[:, 3] + 1], 1)
    x1, y1, x2, y2 = rect.T
    if not ((x_lo <= x1) & (x1 < x2) & (x2 <= np.minimum(x_lo + BLOCK, w))
            & (y_lo <= y1) & (y1 < y2) & (y2 <= np.minimum(y_lo + BLOCK, h))).all():
        raise CorruptStreamError("sub-rect outside block")
    prev64 = prev.astype(np.int64)
    out = prev64.copy()
    ry, rx = np.arange(BLOCK)[:, None], np.arange(BLOCK)[None, :]
    moving = (bt == 3) | (bt == 4)
    if moving.sum() != n_mv:
        raise CorruptStreamError("motion vector count mismatch")
    if moving.any():
        mx1, my1, mx2, my2 = rect[moving].T
        sx, sy = mx1 + mvs[:, 0], my1 + mvs[:, 1]
        if ((sx < 0) | (sy < 0) | (sx + mx2 - mx1 > w) | (sy + my2 - my1 > h)).any():
            raise CorruptStreamError("motion vector out of bounds")
        inside = ((ry[None] < (my2 - my1)[:, None, None])
                  & (rx[None] < (mx2 - mx1)[:, None, None]))
        b, yy, xx = np.nonzero(inside)
        out[my1[b] + yy, mx1[b] + xx] = prev64[sy[b] + yy, sx[b] + xx]
    data_blk = (bt == 1) | (bt == 2)
    if int(data_blk.sum()) != n_data:
        raise CorruptStreamError("data block count mismatch")
    if data_blk.any():
        _rebuild_blocks(out, prev64, rect[data_blk], pix, lits)
    return (out & 0xFF).astype(np.uint8)


def _rebuild_blocks(out, prev, rect, pix, lits) -> None:
    """The P-frame pixel model over every data block at once: row ry of
    each block's sub-rect in turn, an affine scan along it; neighbours
    outside the sub-rect from the previous frame, 0 outside the frame."""
    h, w, _ = prev.shape
    x1, y1, x2, y2 = rect.T
    bw, bh = x2 - x1, y2 - y1
    area = bw * bh
    nb = len(rect)
    ends = np.cumsum(pix[:, 1])
    if ends.size == 0 or ends[-1] != area.sum() or not np.isin(np.cumsum(area), ends).all():
        raise CorruptStreamError("pixel records do not tile the data blocks")
    if int((pix[:, 0] == PT_LITERAL).sum()) != len(lits):
        raise CorruptStreamError("literal count mismatch")
    pt, lit = _runs(pix)
    bstart = np.cumsum(area) - area
    b = np.repeat(np.arange(nb), area)
    p = np.arange(len(pt)) - bstart[b]
    py, px = p // bw[b], p % bw[b]
    types = np.full((nb, BLOCK, BLOCK), -1, np.int64)
    lidx = np.zeros((nb, BLOCK, BLOCK), np.int64)
    types[b, py, px] = pt
    lidx[b, py, px] = lit
    lits = lits if len(lits) else np.zeros((1, 3), np.int64)
    cols = np.arange(BLOCK)
    xs = np.minimum(x1[:, None] + cols[None, :], w - 1)  # [nb, 16]
    left_x = np.maximum(x1 - 1, 0)
    rows = np.zeros((nb, BLOCK, BLOCK, 3), np.int64)
    for r in range(BLOCK):
        y = np.minimum(y1 + r, h - 1)
        live = r < bh
        if r == 0:
            above = np.where((y1 > 0)[:, None, None], prev[np.maximum(y1 - 1, 0)[:, None], xs], 0)
        else:
            above = rows[:, r - 1]
        al = np.empty_like(above)
        al[:, 1:] = above[:, :-1]
        al[:, 0] = np.where(((x1 > 0) & (y > 0) & live)[:, None],
                            prev[np.maximum(y - 1, 0), left_x], 0)
        left_edge = np.where((x1 > 0)[:, None], prev[y, left_x], 0)
        tp = types[:, r]
        known = np.zeros((nb, BLOCK, 3), np.int64)
        m0 = tp == PT_LITERAL
        known[m0] = lits[lidx[:, r][m0]]
        m2, m3, m5 = tp == PT_ABOVE, tp == PT_PREVFRAME, tp == PT_ABOVELEFT
        known[m2] = above[m2]
        known[m3] = prev[y[:, None], xs][m3]
        known[m5] = al[m5]
        reset = m0 | m2 | m3 | m5 | (tp < 0)
        d = np.where((tp == PT_GRADIENT)[..., None], above - al, 0)
        first_left, first_grad = tp[:, 0] == PT_LEFT, tp[:, 0] == PT_GRADIENT
        known[first_left, 0] = left_edge[first_left]
        known[first_grad, 0] = (left_edge + above[:, 0] - al[:, 0])[first_grad]
        reset[:, 0] = True
        d[reset] = 0
        lr = np.maximum.accumulate(np.where(reset, cols[None, :], -1), axis=1)
        cs = np.cumsum(d, axis=1)
        bi = np.arange(nb)[:, None]
        rows[:, r] = known[bi, lr] + cs - cs[bi, lr]
    bb, yy, xx = np.nonzero(types >= 0)
    out[y1[bb] + yy, x1[bb] + xx] = rows[bb, yy, xx]


# ---------------------------------------------------------------------------
# the stream


class StreamDecoder:
    """One stream's decoder state: tables, previous frame, flat latch.
    decode(payload) -> [H, W, 3] uint8 RGB24. A keyframe's format prefix
    is read and recorded in `bpp`."""

    def __init__(self, h: int, w: int, k_fixed: int | None = None):
        self.h, self.w, self.k_fixed = h, w, k_fixed
        self.tables = Tables()
        self.prev = None
        self.flat = None  # colour of the last frame when it was flat
        self.bpp = 24

    def decode(self, data: bytes) -> np.ndarray:
        h, w = self.h, self.w
        if not data or data[0] >> 4 != VERSION:
            raise CorruptStreamError("not an SPTC frame")
        if data[0] & 0x0F == ALG_FMT:
            if len(data) < 2 or data[1] not in (16, 32):
                raise CorruptStreamError("bad format prefix")
            self.bpp = data[1]
            data = data[8 if data[1] == 16 else 2:]
            if not data or data[0] >> 4 != VERSION:
                raise CorruptStreamError("format prefix without a frame")
        alg = data[0] & 0x0F
        if alg == ALG_FLAT:
            if len(data) < 4:
                raise CorruptStreamError("truncated flat frame")
            color = tuple(data[1:4])
            frame = np.empty((h, w, 3), np.uint8)
            frame[:] = color
            if self.flat != color:
                self.tables.renew()
            self.flat = color
            self.prev = frame
            return frame.copy()
        self.flat = None
        if alg == ALG_I:
            self.tables.renew()
            frame = decode_i(data, 1, self.tables, h, w, self.k_fixed)
        elif alg == ALG_RAW:
            if len(data) < 1 + h * w * 3:
                raise CorruptStreamError("truncated raw frame")
            frame = np.frombuffer(data, np.uint8, h * w * 3, 1).reshape(h, w, 3).copy()
            self.tables.renew()
        elif alg == ALG_P:
            if self.prev is None:
                raise CorruptStreamError("P frame before any keyframe")
            frame = decode_p(data, 1, self.prev, self.tables, self.k_fixed)
        else:
            raise CorruptStreamError(f"unknown frame algorithm {alg}")
        self.prev = frame
        return frame.copy()
