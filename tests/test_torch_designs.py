"""The facts the Hopper designs of K1, K3, K4 and K6 rest on, pinned on the
CPU against the plain versions and, through them, against jx. Tolerance 0.

K1 (csrc/sections.cu, encode_kernel) takes the lookups of all substeps of a
step before any update of that step (rec, bt, sxy, mv), and for col computes
the three substeps' row parts at the step start and chains only the global
row. K3 (csrc/run_walk.cu) takes the start mask as the orbit of each tile's
position 0 under next(p). K4 (csrc/recon.cu) runs the row recurrence mod
256 per channel in 10-bit fields of one word, as a scan of affine maps over
thread chunks, warps and warp totals, with the row before kept per thread.
K6 (csrc/block_rebuild.cu) expands a block's records by two warp prefix
sums (run lengths, then marks) and runs each row in 8-bit lanes of one word
a pixel, as a scan of (reset, add) maps over 16 lanes. K7
(csrc/pixels.cu) packs a thread's 4 RGB32 pixels (one 16-byte word) into
3 words of RGB24 with __byte_perm, and back with alpha 255, through a
tile's 96 16-byte words of shared memory. K8 (csrc/resolve.cu) resolves a
P decode call's blocks in three passes whose every output entry is written
once: a block a stream over its runs and blocks, a block a tile of records,
a block a data-block slot gathering its records. Inputs are made from a
seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.jx import classify as jcl
from screenpressor_tpu.jx import coder as jc
from screenpressor_tpu.jx import pframe as jp
from screenpressor_tpu.jx import recon as jr
from screenpressor_tpu.jx.tables import renew_tables as jx_renew
from screenpressor_tpu_torch import classify as tcl
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import pframe as tp
from screenpressor_tpu_torch import recon as tr
from screenpressor_tpu_torch.config import (
    MAX_RUN,
    PT_ABOVE,
    PT_ABOVELEFT,
    PT_GRADIENT,
    PT_LEFT,
    PT_LITERAL,
    PT_PREVFRAME,
    kind_gstep,
    kind_step,
)
from screenpressor_tpu_torch.substeps import SUBSTEP_CODECS as CODECS
from screenpressor_tpu_torch.tables import effective_rows, renew_tables, update_batch

from tests.test_jx_coder import _spec_records
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import rebuild_fixtures

I32 = torch.int32


def merged_scan(recs, lens, tables, name):
    """model_scan with K1's schedule: per step, every substep's lookup reads
    the count rows as they were before the step; of a mixed kind's global
    row it reads the state after the substeps before it (col: three
    substeps chain it; nrun has one substep a step). Then the updates, in
    substep order."""
    codec = CODECS[name]
    t_steps, k, _ = recs.shape
    state = codec.init_state(torch.zeros(k, dtype=I32))
    tables = dict(tables)
    cums, freqs, acts = [], [], []
    for t in range(t_steps):
        rec_l = [recs[t, :, j] for j in range(codec.rec_width)]
        lane_active = t < lens
        at_start = dict(tables)  # the tables are functional: a snapshot
        for j, kind in enumerate(codec.kinds):
            row, sym, extra = codec.enc_syms(j, rec_l, state)
            active = lane_active if extra is None else (lane_active & extra)
            row = row.clamp(0, tables[kind]["cnt"].shape[0] - 1)
            symc = sym.clamp(0, tables[kind]["cnt"].shape[1] - 1)
            look = dict(at_start[kind])
            for key in ("gcnt", "gsum"):  # the global row is chained
                if key in look:
                    look[key] = tables[kind][key]
            freq_rows = effective_rows(look, row)
            cum_rows = torch.cumsum(freq_rows, dim=1, dtype=I32) - freq_rows
            sidx = symc.long()[:, None]
            cums.append(cum_rows.gather(1, sidx)[:, 0])
            freqs.append(freq_rows.gather(1, sidx)[:, 0])
            acts.append(active)
            tables[kind] = update_batch(tables[kind], row, symc, active,
                                        kind_step(kind), kind_gstep(kind))
        state = codec.enc_next_state(rec_l, state, lane_active)
    s = len(codec.kinds)

    def stack(v):
        return torch.stack(v).reshape(t_steps, s, k).transpose(1, 2).contiguous()

    return stack(cums), stack(freqs), stack(acts), tables


def orbit_walk(bits, st, tile):
    """K3's jump walk in numpy: next(p) = min(p + MAX_RUN, first q > p with
    bit st[p] of bits[q] clear, tile end); the start mask is the orbit of
    each tile's position 0."""
    n = len(bits)
    out = np.zeros(n, bool)
    for base in range(0, n, tile):
        end = min(base + tile, n)
        p = base
        while p < end:
            out[p] = True
            limit = min(p + MAX_RUN, end)
            clear = np.nonzero(((bits[p + 1: limit] >> st[p]) & 1) == 0)[0]
            p = p + 1 + int(clear[0]) if len(clear) else limit
    return out


_jx_walk = jax.jit(jcl._run_walk, static_argnums=(2, 3))

DESIGN_CASES = [("k1", name, n, k) for name, n, k in (
    ("rec", 700, 4), ("bt", 300, 4), ("sxy", 300, 2), ("mv", 500, 4), ("col", 700, 4),
    ("col", 96, 32))]
DESIGN_CASES += [("k3", "walk", n, tile) for n, tile in (
    (3000, 1024), (700, 256), (2100, 1000), (5 * 256 + 9, 256))]


@pytest.mark.parametrize("kernel,name,n,k", DESIGN_CASES)
def test_design_fact_matches_plain_and_jx(kernel, name, n, k):
    rng = np.random.default_rng(sum(map(ord, name)) + n + k)
    if kernel == "k3":
        tile = k
        bits = rng.integers(0, 64, n).astype(np.int32)
        bits[rng.random(n) < 0.8] = 63
        bits[50:50 + 2 * MAX_RUN + 7] = 63  # a streak that crosses MAX_RUN twice
        st = rng.integers(0, 6, n).astype(np.int32)
        got = orbit_walk(bits, st, tile)
        plain = tcl.run_walk_plain(torch.as_tensor(bits), torch.as_tensor(st), tile).numpy()
        np.testing.assert_array_equal(got, plain)
        ref = np.asarray(_jx_walk(jnp.asarray(bits), jnp.asarray(st), n, tile))
        np.testing.assert_array_equal(got, ref)
        return
    records = np.asarray([list(r) for r in _spec_records(name, n, rng)], np.int32)
    t = tc.steps_for(n, k)
    dealt = tc.deal(torch.as_tensor(records), n, k, t)
    lens = tc.lane_lens(n, k, "cpu")
    tabs = renew_tables("cpu")
    cum_p, freq_p, act_p, tab_p = tc.model_scan(dealt, lens, tabs, name)
    cum_m, freq_m, act_m, tab_m = merged_scan(dealt, lens, tabs, name)
    assert torch.equal(act_m, act_p)
    # the intervals of inactive lanes never reach the bytes
    assert torch.equal(torch.where(act_p, cum_m, 0), torch.where(act_p, cum_p, 0))
    assert torch.equal(torch.where(act_p, freq_m, 0), torch.where(act_p, freq_p, 0))
    for kd in tab_p:
        for key in tab_p[kd]:
            assert torch.equal(tab_m[kd][key], tab_p[kd][key]), (kd, key)
    buf, start = tc.rans_pack(cum_m, freq_m, act_m, tc.pack_cap(name, t))
    blobs = tc.blobs_from_buf(buf.numpy(), start.numpy(), lens.numpy())
    blobs_j, _ = jc.encode_section(records, k, jx_renew(), name)
    assert blobs == blobs_j


FIELDS, BORROW, A_BIT = np.uint32(0x0FF3FCFF), np.uint32(0x10040100), np.uint32(0x80000000)


def k4_compose(f1, f2):
    """f1 then f2 on packed maps (a in bit 31, b in the channel fields)."""
    return np.where(f2 & A_BIT, ((f1 + (f2 & FIELDS)) & (FIELDS | A_BIT)), f2)


def k4_apply(g, v):
    return np.where(g & A_BIT, (v + g) & FIELDS, g)


def k4_emulation(words, w, per):
    """K4's arithmetic and schedule in numpy: words [H, Wp] packed (uint32),
    Wp / per threads of per positions, warps of 32 threads. Per row: each
    position's map from the row before (kept per thread, with the value
    entering the chunk as the first aboveleft and the carry at Wp - 1), the
    chunk's inclusive maps, a Hillis-Steele scan over the warp's lanes, the
    composed warp totals, then the values. -> [H, w, 3] uint8."""
    h, wp = words.shape
    nt = wp // per
    nw = nt // 32
    prev = np.zeros((nt, per), np.uint32)
    al0 = np.zeros(nt, np.uint32)
    carry = np.uint32(0)
    out = np.zeros((h, wp), np.uint32)
    for y in range(h):
        wd = words[y].reshape(nt, per)
        above, aboveleft = prev, np.concatenate([al0[:, None], prev[:, :-1]], axis=1)
        grad = (((above | BORROW) - aboveleft) & FIELDS) | A_BIT
        from_row = (wd >> np.uint32(29)) & np.uint32(1)
        known = np.where(from_row, np.where((wd >> np.uint32(28)) & np.uint32(1), aboveleft,
                                            above), wd)
        f = np.where((wd >> np.uint32(30)) & np.uint32(1), np.where(from_row, grad, A_BIT),
                     known).astype(np.uint32)
        g = f.copy()
        for i in range(1, per):
            g[:, i] = k4_compose(g[:, i - 1], f[:, i])
        incl = g[:, -1].reshape(nw, 32).copy()
        o = 1
        while o < 32:
            nxt = incl.copy()
            nxt[:, o:] = k4_compose(incl[:, :-o], incl[:, o:])
            incl, o = nxt, 2 * o
        excl = np.concatenate([np.full((nw, 1), A_BIT, np.uint32), incl[:, :-1]], axis=1)
        pre = [A_BIT]
        for j in range(nw):
            pre.append(k4_compose(pre[-1], incl[j, 31]))
        v_in = k4_apply(excl.reshape(-1), k4_apply(np.asarray(pre[:nw])[:, None].repeat(32, 1)
                                                   .reshape(-1), carry))
        carry = k4_apply(pre[nw], carry)
        al0 = v_in.copy()
        al0[0] = carry
        prev = k4_apply(g, v_in[:, None]).astype(np.uint32)
        out[y] = prev.reshape(-1)
    rgb = np.stack([(out >> np.uint32(sh)) & np.uint32(0xFF) for sh in tr.FIELD_SHIFTS], -1)
    return rgb[:, :w].astype(np.uint8)


# (h, w, positions a thread, gradients forced at column 0, share of resets)
K4_CASES = [(5, 128, 4, False, 0.5), (7, 100, 4, True, 0.5), (1, 200, 8, False, 0.5),
            (6, 256, 4, True, 0.5), (4, 300, 8, True, 0.5), (3, 512, 4, False, 0.5),
            (3, 2048, 8, True, 0.002)]


@pytest.mark.parametrize("h,w,per,grad0,resets", K4_CASES)
def test_k4_packed_recurrence_matches_plain_and_jx(h, w, per, grad0, resets):
    """Arbitrary ptypes 0..5, int32 literals over the full range (only the
    low bytes reach the frame), w == Wp and w < Wp, one row, gradients at
    column 0 (their aboveleft is the last padded slot of the row before),
    and rows so poor in resets that whole warps carry (their totals compose
    with a = 1)."""
    rng = np.random.default_rng(h * 1000 + w + per)
    n = h * w
    carried = rng.choice([1, 3, PT_GRADIENT], n)
    reset = rng.choice([PT_LITERAL, PT_ABOVE, PT_ABOVELEFT], n)
    pt = np.where(rng.random(n) < resets, reset, carried).astype(np.int32)
    if grad0:
        pt.reshape(h, w)[1:, 0] = PT_GRADIENT
    records = np.stack([pt, np.ones(n, np.int32)], axis=1)
    lits = rng.integers(-2**31, 2**31, (n, 3), dtype=np.int64).astype(np.int32)
    ref = np.asarray(jr.reconstruct_i(jnp.asarray(records), jnp.asarray(lits), h, w))
    words = tr.pad_rows(*tr.expand_records(torch.as_tensor(records), torch.as_tensor(lits), n),
                        h, w)
    got = k4_emulation(words.numpy().view(np.uint32), w, per)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tr.recon_rows_plain(words, w).numpy(), ref)


def _bytewise(op, a, b):
    a1, b1 = (np.atleast_1d(np.asarray(x, np.uint32)) for x in (a, b))
    out = op(a1.view(np.uint8), b1.view(np.uint8)).view(np.uint32)
    return out if np.ndim(a) or np.ndim(b) else out[0]


def vadd4(a, b):
    """__vadd4: per-byte add mod 256 of uint32 words."""
    return _bytewise(np.add, a, b)


def vsub4(a, b):
    """__vsub4: per-byte subtract mod 256."""
    return _bytewise(np.subtract, a, b)


def k6_emulation(base, prev, rects, bsid, pt, rl, lt):
    """K6's arithmetic and schedule in numpy, a warp (32 lanes) a slot:
    lane l's 8 run lengths summed, a warp prefix sum places the marks, a
    second one over the marks gives each position its record (only
    positions < bw * bh); then per row each lane's (reset, a) map from the
    row before (kept per lane: above its own, aboveleft its left
    neighbour's) and prev's apron, a Hillis-Steele scan over the lanes by
    offsets 1, 2, 4, 8, the row's words written where they lie in the
    frame. -> frames [C, h, w, 3]."""
    c, h, w, _ = prev.shape
    out = base.copy()

    def pixel(s, y, x):
        if 0 <= y < h and 0 <= x < w:
            return np.uint32(int(prev[s, y, x, 0]) | int(prev[s, y, x, 1]) << 8
                             | int(prev[s, y, x, 2]) << 16)
        return np.uint32(0)

    lanes = np.arange(32)
    for b in range(len(rects)):
        x1, y1, x2, y2 = (int(v) for v in rects[b])
        bw, bh, s = min(max(x2 - x1, 0), 16), min(max(y2 - y1, 0), 16), int(bsid[b])
        if bw == 0 or bh == 0 or not 0 <= s < c:
            continue
        own = rl[b].astype(np.int64).reshape(32, 8)
        start = np.cumsum(own.sum(1)) - own.sum(1)
        mark = np.zeros(256, np.int64)
        for lane in lanes:
            st = start[lane]
            for j in range(8):
                if own[lane, j] > 0 and 0 <= st < 256:
                    mark[st] += 1
                st += own[lane, j]
        cnt = np.cumsum(mark.reshape(32, 8), axis=1)
        rid = np.clip((np.cumsum(cnt[:, -1]) - cnt[:, -1])[:, None] + cnt - 1, 0, 255).reshape(-1)
        n_pos = bw * bh
        spt = np.where((pt[b][rid] >= 0) & (pt[b][rid] <= 5), pt[b][rid], 6)[:n_pos]
        lw = lt[b][rid].astype(np.int64) & 0xFF
        slit = (lw[:, 0] | lw[:, 1] << 8 | lw[:, 2] << 16).astype(np.uint32)[:n_pos]
        v = np.zeros(32, np.uint32)
        for r in range(bh):
            left_of = np.concatenate([v[:1], v[:-1]])  # __shfl_up by 1
            a = np.zeros(32, np.uint32)
            rs = np.ones(32, bool)
            for x in range(bw):
                y, xx = y1 + r, x1 + x
                t = spt[r * bw + x]
                above = pixel(s, y - 1, xx) if r == 0 else v[x]
                tl = pixel(s, y - 1, xx - 1) if r == 0 or x == 0 else left_of[x]
                if t == PT_LITERAL:
                    a[x] = slit[r * bw + x]
                elif t == PT_ABOVE:
                    a[x] = above
                elif t == PT_PREVFRAME:
                    a[x] = pixel(s, y, xx)
                elif t == PT_ABOVELEFT:
                    a[x] = tl
                elif t == PT_LEFT and x == 0:
                    a[x] = pixel(s, y, xx - 1)
                elif t == PT_GRADIENT and x == 0:
                    a[x] = vsub4(vadd4(pixel(s, y, xx - 1), above), tl)
                else:
                    rs[x] = False
                    a[x] = vsub4(above, tl) if t == PT_GRADIENT else 0
            o = 1
            while o < 16:
                pa, prs = np.roll(a, o), np.roll(rs, o)
                take = (lanes >= o) & ~rs
                a = np.where(take, vadd4(pa, a), a)
                rs = np.where(take, prs, rs)
                o *= 2
            v = a
            for x in range(bw):
                y, xx = y1 + r, x1 + x
                if 0 <= y < h and 0 <= xx < w:
                    out[s, y, xx] = [(int(v[x]) >> sh) & 0xFF for sh in (0, 8, 16)]
    return out


@pytest.mark.parametrize("name", sorted(rebuild_fixtures()))
def test_k6_byte_lane_rows_match_plain_and_jx(name):
    """K6's schedule in 8-bit lanes equals the plain int32 rows masked at
    the scatter (the wrap fixture's rows leave 0..255), on every stream,
    and jx's reconstruct_blocks on the streams the reference defines
    alike."""
    base, prev, rects, bsid, pt, rl, lt, ref_streams = rebuild_fixtures()[name]
    got = k6_emulation(base, prev, rects, bsid, pt, rl, lt)
    c, h, w, _ = prev.shape
    out = torch.cat([torch.as_tensor(base).reshape(-1, 3), torch.zeros((1, 3), dtype=torch.uint8)])
    tp.reconstruct_blocks_streams_plain(out, torch.as_tensor(prev),
                                        *(torch.as_tensor(a) for a in (rects, bsid, pt, rl, lt)))
    np.testing.assert_array_equal(got, out[:-1].view(c, h, w, 3).numpy())
    for s in ref_streams:
        sel = bsid == s
        if sel.any():
            ref = jp.reconstruct_blocks(jnp.asarray(base[s]), jnp.asarray(prev[s]),
                                        *(jnp.asarray(a[sel]) for a in (rects, pt, rl, lt)),
                                        h, w, int(sel.sum()))
            np.testing.assert_array_equal(got[s], np.asarray(ref))


# -- K8 ------------------------------------------------------------------------

POISON = -(2 ** 40)  # an output entry no kernel wrote


def _upper_bound(a, n, x):
    """The kernel's binary search: keys of a[0 .. n) at or below x."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def k8_emulation(recs, lay, cfg, nt=1024, ipt=8, ript=4):
    """K8's three kernels in numpy, thread by thread where a thread's
    order matters: kernel 1's stream pass (runs' starts, each thread's
    search cursor over its ipt consecutive blocks, the class counts packed
    in 21-bit fields, slots and areas written, the rest of each stream's
    slots zeroed, the area prefix, first_rec set to the valid records) and
    its tile sums; kernel 2 per tile of nt * ript records (the tiles before
    it, each thread's slot cursor over its ript records, first_rec
    scattered, bits 64, 128, 512); kernel 3 per slot position (the record
    first_rec + k if it belongs to the slot, bit 256 from record
    first_rec + 256). Every output starts as POISON and must be written
    exactly once (first_rec once by kernel 1, at most once more by kernel 2).
    -> ((mo_rects, mo_mvs, d_rects, pt, rlg, lt), err) as numpy int64."""
    bt, sxy, mv, rec, col = (recs[n].numpy().astype(np.int64) for n in tp.SECTION_NAMES)
    hdr = lay.hdr.numpy()
    mcap, bcap, moff, boff, bsid = (t.numpy() for t in (lay.mcap, lay.bcap, lay.moff, lay.boff,
                                                         lay.bsid))
    c, b_max = hdr.shape[0], lay.b_max
    nbx, nby, h, w = cfg.nbx, cfg.nby, cfg.height, cfg.width
    nb = nbx * nby
    cap_bt, cap_sxy, cap_mv, cap_rec, cap_col = (a.shape[1] for a in (bt, sxy, mv, rec, col))
    chunk, tile = nt * ipt, nt * ript
    n_tiles = -(-cap_rec // tile)
    m_all, b_all = lay.msid.shape[0], bsid.shape[0]
    mo_rects, mo_mvs = np.full((m_all, 4), POISON), np.full((m_all, 2), POISON)
    d_rects = np.full((b_all, 4), POISON)
    pt, rlg, lt = (np.full(shape, POISON) for shape in ((b_all, 256), (b_all, 256),
                                                         (b_all, 256, 3)))
    err = np.full(c, POISON)
    astart = np.full((c, b_max + 1), POISON)
    first_rec = np.full((c, b_max), POISON)
    jbs, litrow = np.full((c, cap_rec), POISON), np.full((c, cap_rec), POISON)
    tsum = np.zeros((c, n_tiles, 2), np.int64)
    field, fmask = 21, (1 << 21) - 1

    def put(arr, idx, val):
        assert arr[idx] == POISON if np.ndim(arr[idx]) == 0 else (arr[idx] == POISON).all()
        arr[idx] = val

    def own_last(n, cap):
        return min(max(int(n), 1), cap) - 1

    def n_valid(s):
        return min(max(int(hdr[s, 3]), 0), cap_rec)

    for s in range(c):  # kernel 1, the stream blocks
        n_sxy, n_mv, n_data, xx1 = (int(hdr[s, j]) for j in (1, 2, 7, 5))
        lenr = int(hdr[s, 6]) - xx1 + 1
        nv = bt[s, :, 1]
        bstart = np.cumsum(nv) - nv
        nzc = np.cumsum(nv > 0)
        bits = 1 if int(nv.sum()) != lenr else 0
        own_bt, own_sxy, own_mv = (own_last(hdr[s, j], cap) for j, cap in
                                   ((0, cap_bt), (1, cap_sxy), (2, cap_mv)))
        area = astart[s]
        carry, bad16, bad32 = 0, False, False
        for base in range(0, nb, chunk):
            cls = {}
            for t in range(nt):
                kb = -1
                for k in range(ipt):
                    pos = base + t * ipt + k
                    q, bts = pos - xx1, 0
                    if pos < nb and 0 <= q < lenr:
                        qq = min(q, nb - 1)
                        if kb < 0:
                            kb = _upper_bound(bstart, cap_bt, qq)
                        else:
                            while kb < cap_bt and bstart[kb] <= qq:
                                kb += 1
                        ridx = (int(nzc[kb - 1]) if kb else 0) - 1
                        if ridx >= 0:
                            bts = int(bt[s, min(ridx, own_bt), 0])
                    cls[pos] = (bts in (2, 4), bts in (3, 4), bts in (1, 2))
            for pos in range(base, base + chunk):  # the scan, then each item
                part, mot, dat = cls[pos]
                carry += int(part) | int(mot) << field | int(dat) << 2 * field
                if pos >= nb or not (part or mot or dat):
                    continue
                x_lo, y_lo = (pos % nbx) * 16, (pos // nbx) * 16
                x_hi, y_hi = min(x_lo + 16, w), min(y_lo + 16, h)
                x1, y1, x2, y2 = x_lo, y_lo, x_hi, y_hi
                if part:
                    r = sxy[s, min(max((carry & fmask) - 1, 0), own_sxy)]
                    x1, y1, x2, y2 = x_lo + r[0], y_lo + r[1], x_lo + r[2] + 1, y_lo + r[3] + 1
                    bad16 |= not (x1 < x2 <= x_hi and y1 < y2 <= y_hi)
                if mot:
                    mi = ((carry >> field) & fmask) - 1
                    m0, m1 = (int(v) for v in mv[s, min(mi, own_mv)])
                    bad32 |= not (x1 + m0 >= 0 and y1 + m1 >= 0 and x2 + m0 <= w
                                  and y2 + m1 <= h)
                    if mi < mcap[s]:
                        put(mo_rects, moff[s] + mi, [x1, y1, x2, y2])
                        put(mo_mvs, moff[s] + mi, [m0, m1])
                if dat:
                    di = (carry >> 2 * field) - 1
                    if di < bcap[s]:
                        put(d_rects, boff[s] + di, [x1, y1, x2, y2])
                        put(area, di, int(np.int32(max(x2 - x1, 0) * max(y2 - y1, 0))))
        n_part, n_mot, n_dat = carry & fmask, (carry >> field) & fmask, carry >> 2 * field
        bits |= (2 if n_part != n_sxy else 0) | (4 if n_mot != n_mv else 0)
        bits |= (8 if n_dat != n_data else 0) | (16 if bad16 else 0) | (32 if bad32 else 0)
        for j in range(min(n_mot, mcap[s]), mcap[s]):
            put(mo_rects, moff[s] + j, 0)
            put(mo_mvs, moff[s] + j, 0)
        for j in range(min(n_dat, bcap[s]), bcap[s]):
            put(d_rects, boff[s] + j, 0)
            put(area, j, 0)
        a = area[:bcap[s]].copy()
        area[:bcap[s]] = np.cumsum(a) - a
        area[bcap[s]] = a.sum()
        first_rec[s, :bcap[s]] = n_valid(s)
        put(err, s, bits)
    for s in range(c):  # kernel 1, the tile blocks
        nvr = n_valid(s)
        for tl in range(n_tiles):
            i = np.arange(tl * tile, min((tl + 1) * tile, nvr))
            tsum[s, tl] = rec[s, i, 1].sum(), (rec[s, i, 0] == PT_LITERAL).sum()
    for s in range(c):  # kernel 2
        nvr, nslot, a_s = n_valid(s), int(bcap[s]), astart[s]
        own_col = own_last(hdr[s, 4], cap_col)
        for tl in range(n_tiles):
            if tl == 0:
                tot = tsum[s].sum(0)
                err[s] |= (64 if tot[0] != a_s[nslot] else 0) | (512 if tot[1] > hdr[s, 4] else 0)
            if tl * tile >= nvr:
                continue
            rl_pre, lit_pre = tsum[s, :tl].sum(0) if tl else (0, 0)
            i = np.arange(tl * tile, (tl + 1) * tile)
            ok = i < nvr
            rl = np.where(ok, rec[s, np.minimum(i, cap_rec - 1), 1], 0)
            lit = ok & (rec[s, np.minimum(i, cap_rec - 1), 0] == PT_LITERAL)
            rstarts = rl_pre + np.cumsum(rl) - rl
            nlits = lit_pre + np.cumsum(lit) - lit
            bad = False
            for t in range(nt):
                ub = -1
                for k in range(ript):
                    j = t * ript + k
                    ii = int(i[j])
                    if ii >= nvr:
                        break
                    rstart = int(rstarts[j])
                    if ub < 0:
                        ub = _upper_bound(a_s, nslot,
                                          rstart - int(rec[s, ii - 1, 1]) if ii else -1)
                    lo = ub
                    while ub < nslot and a_s[ub] <= rstart:
                        ub += 1
                    jb = min(max(ub - 1, 0), nslot - 1)
                    bad |= rstart + int(rl[j]) > a_s[jb + 1]
                    for jj in range(lo, ub):
                        first_rec[s, jj] = ii
                    put(jbs, (s, ii), jb)
                    put(litrow, (s, ii), min(max(int(nlits[j]), 0), own_col) if lit[j] else -1)
            if bad:
                err[s] |= 128
    for b in range(b_all):  # kernel 3
        s = int(bsid[b])
        bl, nvr = b - int(boff[s]), n_valid(s)
        f = int(first_rec[s, bl])
        for k in range(256):
            i = f + k
            vals = (0, 0, 0, 0, 0)
            if i < nvr and jbs[s, i] == bl:
                lr = int(litrow[s, i])
                vals = (rec[s, i, 0], rec[s, i, 1], *(col[s, lr] if lr >= 0 else (0, 0, 0)))
            put(pt, (b, k), vals[0])
            put(rlg, (b, k), vals[1])
            put(lt, (b, k), vals[2:])
        if f + 256 < nvr and jbs[s, f + 256] == bl:
            err[s] |= 256
    parts = (mo_rects, mo_mvs, d_rects, pt, rlg, lt)
    assert all((p != POISON).all() for p in (*parts, err))
    return parts, err


def _resolve_cases():
    from tests.torch_support import resolve_fixtures

    cases = [(name, 1024, 8, 4) for name in sorted(resolve_fixtures())]
    # small blocks of threads: several chunks of blocks and tiles of records
    return cases + [("chunks", 4, 8, 4), ("damaged", 2, 8, 4), ("garbage", 3, 2, 2),
                    ("rebuild_damaged", 2, 8, 2)]


@pytest.mark.parametrize("name,nt,ipt,ript", _resolve_cases())
def test_k8_passes_match_plain(name, nt, ipt, ript):
    """K8's three kernels (k8_emulation) equal the plain resolve bit for
    bit, outputs and error words, on the resolve fixtures (clean, damaged
    and garbage streams beside clean ones), also with blocks of 2-4
    threads, so that frames take several chunks of blocks and streams
    several tiles of records; every output entry is written exactly once,
    so the kernels need no zeroed buffer."""
    from tests.torch_support import resolve_fixtures, resolve_inputs

    recs, lay, cfg = resolve_inputs(*resolve_fixtures()[name])
    parts, err = k8_emulation(recs, lay, cfg, nt, ipt, ript)
    want, want_err = tp.decode_p_resolve_streams_plain(recs, lay, cfg)
    for got, ref in zip(parts, want):
        np.testing.assert_array_equal(got, ref.numpy().astype(np.int64))
    np.testing.assert_array_equal(err, want_err.numpy())


def test_k8_passes_match_plain_on_decodes():
    """k8_emulation equals the plain resolve on every rebuild_p_streams call
    of real decodes on the CPU: the 48 x 64 stream of corrupt_payloads
    (C = 1) and each of its damaged payloads, and the four-stream serving
    steps of damaged_serving_steps with stream 1 damaged beside three clean
    ones (C = 4)."""
    from screenpressor_tpu_torch import TorchDecoder
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder
    from tests.torch_support import corrupt_payloads, damaged_serving_steps, resolve_calls

    cfg, _, payloads, damaged = corrupt_payloads()
    s_cfg, steps, _, cases = damaged_serving_steps()
    calls = []
    with resolve_calls(calls):
        TorchDecoder(cfg, "cpu").decode_batch(payloads)
        for i, data in damaged:
            dec = TorchDecoder(cfg, "cpu")
            dec.decode_batch(payloads[:i])
            try:
                dec.decode_batch([data])
            except bs.CorruptStreamError:
                pass
        for i, data in cases[::4]:
            dec = BatchedDecoder(len(steps[0]), s_cfg, "cpu")
            for st in steps[:i]:
                dec.decode(st)
            try:
                dec.decode([data if j == 1 else p for j, p in enumerate(steps[i])])
            except bs.CorruptStreamError:
                pass
    n_damaged = 0
    for recs, lay, c_ in calls:
        parts, err = k8_emulation(recs, lay, c_)
        want, want_err = tp.decode_p_resolve_streams_plain(recs, lay, c_)
        for got, ref in zip(parts, want):
            np.testing.assert_array_equal(got, ref.numpy().astype(np.int64))
        np.testing.assert_array_equal(err, want_err.numpy())
        n_damaged += bool(err.any())
    assert n_damaged >= 10 and any(lay.hdr.shape[0] == 4 for _, lay, _ in calls)


# -- K7 ------------------------------------------------------------------------

def byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays (selector bit 3, the
    sign-replicate mode, unused): byte i of the result is byte sel[i] of
    the 8 bytes y:x."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


K7_TILE = 512  # pixels a thread block: 128 threads x 4


@pytest.mark.parametrize("seed", [0, 1])
def test_k7_tile_packing_matches_plain_and_reference(seed):
    """One whole tile through K7's vector path both ways: each thread's
    RGB32 word (v.x .. v.w) packed into its 3 shared words at 3t, the
    tile's shared words stored in order, and back (alpha 255); equal to the
    plain batch functions and the reference's conversions."""
    from screenpressor_tpu import colorspace as ref_cs
    from screenpressor_tpu_torch import colorspace as cs

    rng = np.random.default_rng(seed)
    f32 = rng.integers(0, 256, (1, 1, K7_TILE, 4), dtype=np.uint8)
    v = f32.reshape(-1).view("<u4").reshape(128, 4).astype(np.uint32)  # thread t: v.x .. v.w
    w = np.stack([byte_perm(v[:, 0], v[:, 1], 0x4210), byte_perm(v[:, 1], v[:, 2], 0x5421),
                  byte_perm(v[:, 2], v[:, 3], 0x6542)], axis=1)  # shared words 3t .. 3t + 2
    rgb = w.astype("<u4").reshape(-1).view(np.uint8)  # the 96 stored 16-byte words
    want24 = cs.rgb32_to_rgb24_batch(torch.as_tensor(f32))[0].numpy()
    np.testing.assert_array_equal(rgb, want24.reshape(-1))
    np.testing.assert_array_equal(want24, ref_cs.rgb32_to_rgb24(f32[0]))

    w0, w1, w2 = (rgb.view("<u4").reshape(128, 3)[:, j].astype(np.uint32) for j in range(3))
    back = np.stack([w0 | 0xFF000000, byte_perm(w0, w1, 0x7543) | 0xFF000000,
                     byte_perm(w1, w2, 0x7432) | 0xFF000000, (w2 >> 8) | 0xFF000000], axis=1)
    got32 = back.astype("<u4").reshape(-1).view(np.uint8).reshape(1, K7_TILE, 4)
    want32 = cs.rgb24_to_rgb32_batch([torch.as_tensor(want24)])[0].numpy()
    np.testing.assert_array_equal(got32, want32)
    np.testing.assert_array_equal(want32, ref_cs.rgb24_to_rgb32(want24))
