"""One large stream row-sharded over a mesh of devices — PyTorch port of
`screenpressor_tpu/parallel/mesh.py`.

A single controller drives a [dp, sp] grid of `torch.device`s (`Mesh`):
streams split over dp, the rows of a frame over sp. The collectives are
plain functions over lists of per-shard tensors (`ppermute_down`,
`all_gather`, `psum`), each a `.to(device, non_blocking=True)` plus a
`torch.cat` or a sum: `.to()` onto the device a tensor is on moves
nothing, so shards that share one card exchange nothing.

What is row-sharded, as in the reference: the fit planes of an I frame
(one-row halo from the shard above), its classification and K3 run walk
(seams at multiples of lcm(seg tile, width) pixels, so each shard emits
exactly the global records of its range: no stitching), the P change
analysis, the motion search of a shard's changed blocks against the full
previous frame, block types and the data-block classification (one-row
halo). Per-shard record chunks join in global order on the stream's home
device (`compact_rows`). The section scans (K1 / K2) then run unsharded on
the home device, shard 0: the reference's lane-sharded scans exchange every
substep's (row, sym, active) to keep the table replicas equal, tens of
thousands of exchanges a keyframe, each dearer than the 1.6-1.8 us substep
it serves; the same full-K update on one device gives the same bytes and
tables by construction. Reconstruction (K4) and the P rebuild run on the
home device too.

The entry points take frames as numpy arrays or tensors; their outputs live
on the home device. `make_mesh` places shards on CUDA devices unless the
caller passes others (`devices=["cpu"] * n` on a machine without a card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import container as ct
from screenpressor_tpu_torch import telemetry
from screenpressor_tpu_torch.blocks import (
    analyze_blocks_streams,
    block_types_from,
    compact_block_records,
    mv_candidates,
)
from screenpressor_tpu_torch.classify import (
    classify_from_starts,
    classify_i_streams,
    fits_bits,
    run_walk,
    start_types_i,
)
from screenpressor_tpu_torch.config import (
    ALG_FLAT,
    ALG_I,
    ALG_P,
    BLOCK,
    BT_FULL_DATA,
    BT_PARTIAL_DATA,
    FTYPE_I,
    FTYPE_P,
    NUM_PTYPES,
    PT_LEFT,
    PT_LITERAL,
    CodecConfig,
    lane_ranges,
    next_pow2,
    seg_tile,
)
from screenpressor_tpu_torch.iframe import decode_i_device, encode_i_raw, parse_i_header
from screenpressor_tpu_torch.pframe import (
    classify_assemble_streams,
    decode_p_device,
    encode_sections_raw,
    parse_p_header,
    payloads_to_device,
    raise_p_error,
)
from screenpressor_tpu_torch.tables import renew_tables_cached
from screenpressor_tpu_torch.transfer import on_device, pull, to_device, to_host, upload

I32 = torch.int32
REC_KINDS = ("ptype", "nrun")  # the tables the rec section updates


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------


class Mesh:
    """A [dp, sp] grid of devices. `devices[d][i]` holds row shard i of
    the streams of dp shard d; `home` (shard (0, 0)) holds a single
    stream's sections, reconstruction and outputs."""

    def __init__(self, grid):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        if not self.devices or len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty [dp, sp] grid of devices")
        self.shape = {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, devices={self.devices})"


def make_mesh(n_devices: int, sp: int = 1, devices=None) -> Mesh:
    """A mesh of n_devices as [n_devices // sp, sp]. By default the first
    n_devices CUDA devices; raises if fewer are visible (it never repeats a
    card or falls back to the CPU on its own). `devices`: the n_devices
    devices to use instead, in order (a card may be repeated there to
    put several shards on it)."""
    if sp < 1 or n_devices < 1 or n_devices % sp:
        raise ValueError(f"make_mesh: sp={sp} must divide n_devices={n_devices}")
    if devices is None:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < n_devices:
            raise RuntimeError(
                f"make_mesh: {n_devices} CUDA devices asked for, {seen} visible; pass "
                "devices= to place the shards (a card may be listed more than once)")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"make_mesh: {len(devices)} devices given for n_devices={n_devices}")
    return Mesh([devices[r * sp:(r + 1) * sp] for r in range(n_devices // sp)])


def ppermute_down(xs):
    """Shard i receives xs[i - 1] on its own device; shard 0 receives zeros
    (the halo of the top shard)."""
    return [torch.zeros_like(xs[0])] + [
        xs[i - 1].to(xs[i].device, non_blocking=True) for i in range(1, len(xs))]


def all_gather(xs, device, dim: int = 0) -> torch.Tensor:
    """The shards' tensors joined along `dim` on `device`."""
    return torch.cat([x.to(device, non_blocking=True) for x in xs], dim=dim)


def psum(xs, device) -> torch.Tensor:
    """The sum of the shards' tensors on `device`."""
    out = xs[0].to(device, non_blocking=True)
    for x in xs[1:]:
        out = out + x.to(device, non_blocking=True)
    return out


def _stage(name: str):
    """The span of one stage of the sp pipelines ("sptc.sp." + name,
    `telemetry.span`): recorded only while a profiler collects."""
    return telemetry.span("sptc.sp." + name)


def _part(x, index, device) -> torch.Tensor:
    """x[index] of frames (numpy or tensor) as contiguous uint8 on
    `device`: a host array uploads only that part."""
    if isinstance(x, torch.Tensor):
        return x[index].to(device, torch.uint8).contiguous()
    return upload(np.asarray(x, np.uint8)[index], device)


def _rows(frame, r0: int, r1: int, rows: int, device) -> torch.Tensor:
    """Rows [r0, r1) of a frame [H, W, 3] on `device`, zero-padded at the
    bottom to `rows` rows."""
    part = _part(frame, slice(r0, r1), device)
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_zeros((rows - part.shape[0],) + part.shape[1:])])
    return part


def _host_bytes(frame) -> bytes:
    if isinstance(frame, torch.Tensor):
        frame = to_host(frame, "mesh.host_bytes")
    return np.ascontiguousarray(frame, np.uint8).tobytes()


# ---------------------------------------------------------------------------
# Fit planes with a halo, and the dp x sp analysis step
# ---------------------------------------------------------------------------


def _halo_fits(shard: torch.Tensor, halo_row: torch.Tensor) -> torch.Tensor:
    """Fit planes [..., rows, w, 6] of a row shard [..., rows, w, 3] int32
    given the last row of the shard above [..., w, 3] (zeros for the top
    shard). Raster wrap: left(y, 0) = aboveleft(y, 0) = pix(y - 1, w - 1)
    (FORMAT.md)."""
    ext = torch.cat([halo_row.unsqueeze(-3), shard], dim=-3)
    cur, above = ext[..., 1:, :, :], ext[..., :-1, :, :]
    aboveleft = torch.cat([above[..., -1:, :], above[..., :-1, :]], dim=-2)
    left = torch.cat([above[..., -1:, :], cur[..., :-1, :]], dim=-2)

    def eq(a, b):
        return (a == b).all(dim=-1)

    f_left = eq(cur, left)
    return torch.stack([f_left, f_left, eq(cur, above), torch.zeros_like(f_left),
                        eq(cur, left + above - aboveleft), eq(cur, aboveleft)], dim=-1)


def _top_row(fits: torch.Tensor) -> torch.Tensor:
    """The global row 0 of the top shard's fits [..., rows, w, 6]: no row
    above, so only the left / literal predicate holds, from pixel 1 on."""
    row0 = torch.zeros_like(fits[..., :1, :, :])
    row0[..., 0, 1:, PT_LITERAL] = fits[..., 0, 1:, PT_LITERAL]
    row0[..., 0, 1:, PT_LEFT] = fits[..., 0, 1:, PT_LEFT]
    return torch.cat([row0, fits[..., 1:, :, :]], dim=-3)


def even_rows(h: int, sp: int):
    """[r0, r1) of each of sp row shards of h rows, as even as it goes."""
    if h < sp:
        raise ValueError(f"{h} rows cannot give each of {sp} shards a row")
    return [(r0, r0 + ln) for r0, ln in lane_ranges(h, sp)]


def sharded_analysis_step(frames, prevs, mesh: Mesh, loss: int = 0):
    """One analysis step over a batch of streams [S, H, W, 3] uint8 (numpy
    or tensors), S divisible by dp: streams split over dp, rows over sp.
    Per shard: the fit planes with a halo row from the shard above
    (`ppermute_down`), a changed flag and a flat flag; `psum` reduces them
    over sp, `all_gather` joins the fits. Returns (fits [S, H, W, 6] bool,
    changed [S] int32 (the number of the stream's row shards with a changed
    pixel), flat [S] bool) on the home device. loss > 0 truncates the
    frames (not the previous frames) before the compares."""
    s, h, w, _ = frames.shape
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if s % dp:
        raise ValueError(f"{s} streams do not split over dp={dp}")
    c = s // dp
    bounds = even_rows(h, sp)
    mask, corr = 0xFF & ~((1 << loss) - 1), (1 << loss) >> 1
    fits_d, changed_d, flat_d = [], [], []
    for d, devs in enumerate(mesh.devices):
        fr, pv = [], []
        for (r0, r1), dev in zip(bounds, devs):
            index = (slice(d * c, (d + 1) * c), slice(r0, r1))
            f = _part(frames, index, dev).to(I32)
            if loss > 0:
                f = (f & mask) | corr
            fr.append(f)
            pv.append(_part(prevs, index, dev).to(I32))
        halos = ppermute_down([f[:, -1] for f in fr])
        first = fr[0][:, 0, 0]
        fits, changed, flat = [], [], []
        for i, (f, p, halo, dev) in enumerate(zip(fr, pv, halos, devs)):
            with on_device(dev):
                fi = _halo_fits(f, halo)
                fits.append(_top_row(fi) if i == 0 else fi)
                changed.append((f != p).reshape(c, -1).any(dim=1).to(I32))
                c0 = first.to(dev, non_blocking=True)
                flat.append((f == c0[:, None, None]).reshape(c, -1).all(dim=1).to(I32))
        row_home = devs[0]
        fits_d.append(all_gather(fits, row_home, dim=1))
        changed_d.append(psum(changed, row_home))
        flat_d.append(psum(flat, row_home) == sp)
    home = mesh.home
    return all_gather(fits_d, home), all_gather(changed_d, home), all_gather(flat_d, home)


# ---------------------------------------------------------------------------
# Shard chunks into global record order
# ---------------------------------------------------------------------------


def compact_rows(stacked: torch.Tensor, counts: torch.Tensor, bases: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Per-shard compact chunks -> global record order, on the device.

    stacked [N, W]: chunk i starts at row bases[i] and its first counts[i]
    rows are valid (counts, bases [sp] tensors). Shard ranges are
    contiguous in global order, so one searchsorted over the count prefix
    sums and one gather suffice. Returns [cap, W]; rows at or past
    counts.sum() are zero."""
    dev = stacked.device
    counts = counts.to(dev, torch.int64)
    bases = bases.to(dev, torch.int64)
    offs = torch.cumsum(counts, 0) - counts
    g = torch.arange(cap, device=dev)
    i = (torch.searchsorted(offs, g, right=True) - 1).clamp(0, counts.shape[0] - 1)
    src = bases[i] + (g - offs[i])
    rows = stacked[src.clamp(0, max(stacked.shape[0] - 1, 0))]
    return torch.where((g < counts.sum())[:, None], rows, 0)


def compact_device(stacked: torch.Tensor, counts: torch.Tensor, cap_loc: int,
                   cap: int) -> torch.Tensor:
    """The reference's layout: shard i's chunk at rows [i * cap_loc, (i + 1)
    * cap_loc) of stacked, the first counts[i] valid -> [cap, W]."""
    bases = torch.arange(counts.shape[0], device=stacked.device) * cap_loc
    return compact_rows(stacked, counts, bases, cap)


def _join(chunks, counts: torch.Tensor, device, cap: int) -> torch.Tensor:
    """all_gather of per-shard chunks [n_i, W], compacted with their valid
    counts [sp] into global order [cap, W] on `device`."""
    sizes = np.asarray([ch.shape[0] for ch in chunks], np.int64)
    bases = torch.as_tensor(np.cumsum(sizes) - sizes)
    return compact_rows(all_gather(chunks, device), counts, bases, cap)


# ---------------------------------------------------------------------------
# I frames
# ---------------------------------------------------------------------------


def i_seams(h: int, w: int, sp: int):
    """[r0, r1) of the sp row shards of an I frame's classification. The
    seams sit at multiples of lcm(seg_tile, w) pixels, as even as that
    allows, so that no seg tile (a run never crosses one) straddles two
    shards. Raises ValueError when the frame has fewer such units than
    shards."""
    tile = seg_tile(h * w, w)
    unit = math.lcm(tile, w) // w
    n_units = -(-h // unit)
    if n_units < sp:
        raise ValueError(
            f"a {h}x{w} frame has {n_units} seam units of {unit} rows (lcm of the seg "
            f"tile {tile} and the width {w} pixels); sp={sp} needs one a shard")
    return [(u0 * unit, min((u0 + n) * unit, h)) for u0, n in lane_ranges(n_units, sp)]


def _classify_shard(shard: torch.Tensor, halo: torch.Tensor, top: bool, tile: int):
    """I classification of one row shard with the global seg tile ->
    (records [n_loc, 2], n_records, lits [n_loc, 3], n_literals) in the
    shard's own order, counts on the device."""
    fits = _halo_fits(shard.to(I32), halo.to(I32))
    if top:
        fits = _top_row(fits)
    fits = fits.reshape(-1, NUM_PTYPES)
    st = start_types_i(fits)
    is_start = run_walk(fits_bits(fits), st, tile)
    return classify_from_starts(is_start, st, shard.reshape(-1, 3))


def _flat_shards(shards, rows, home):
    """(flat [1] int32, first pixel [3] int32) of a frame split in row
    shards, of which the first rows[i] rows of shard i are the frame's (the
    rest padding), on `home`: every shard compares with the top shard's
    first pixel, `psum` counts the flat ones."""
    c0 = shards[0][0, 0]
    flats = [(s[:r] == c0.to(s.device, non_blocking=True)).all().to(I32)
             for s, r in zip(shards, rows)]
    flat = (psum(flats, home) == len(shards)).to(I32).reshape(1)
    return flat, c0.to(home, I32)


def _lossless(cfg: CodecConfig) -> None:
    if cfg.loss:
        raise ValueError("the sp pipelines code lossless frames (cfg.loss must be 0)")


def encode_i_sp(frame, mesh: Mesh, cfg: CodecConfig, tables=None):
    """I-frame encode of one stream over the mesh's sp shards (the first dp
    row): row-sharded classification (`i_seams`), chunks joined in global
    order on the home device, the rec and col sections there (K1).
    Byte-identical to a session encoder's keyframe.

    Returns (bytes, ftype, tables'). A single-keyframe helper: the flat
    shortcut returns `tables` unchanged (a session renews them when a flat
    frame's color differs from the last flat frame's; the caller owns
    that)."""
    _lossless(cfg)
    h, w = cfg.height, cfg.width
    devs = mesh.devices[0]
    home = devs[0]
    bounds = i_seams(h, w, len(devs))
    tile = seg_tile(h * w, w)
    shards = [_rows(frame, r0, r1, r1 - r0, dev) for (r0, r1), dev in zip(bounds, devs)]
    halos = ppermute_down([s[-1] for s in shards])
    outs = []
    for i, (s, halo, dev) in enumerate(zip(shards, halos, devs)):
        with on_device(dev), _stage(f"classify shard {i}"):
            outs.append(_classify_shard(s, halo, i == 0, tile))
    flat, c0 = _flat_shards(shards, [r1 - r0 for r0, r1 in bounds], home)
    cnt_rec = all_gather([o[1].reshape(1) for o in outs], home)
    cnt_lit = all_gather([o[3].reshape(1) for o in outs], home)
    flat_h, c0_h, rec_h, lit_h = pull([[flat, c0, cnt_rec, cnt_lit]], "codec.pull")[0]
    if flat_h[0]:
        return ct.flat_frame(c0_h), FTYPE_I, tables
    n_rec, n_lit = int(rec_h.sum()), int(lit_h.sum())
    with on_device(home), _stage("compaction"):
        records = _join([o[0] for o in outs], cnt_rec, home, max(n_rec, 1))
        lits = _join([o[2] for o in outs], cnt_lit, home, max(n_lit, 1))
    with on_device(home), _stage("sections"):
        out = encode_i_raw(records, n_rec, lits, n_lit, renew_tables_cached(home), cfg,
                           ct.raw_size(cfg))
        buf_rec, start_rec, lens_rec, buf_col, start_col, lens_col, stats, tables = out
        data = ct.write_frame(ct.i_head(n_rec, n_lit), [buf_rec, buf_col],
                              [start_rec, start_col], [lens_rec, lens_col], stats)
        if data is None:
            data = ct.RAW_HEAD + _host_bytes(frame)
    return data, FTYPE_I, tables


def decode_i_sp(data: bytes, mesh: Mesh, cfg: CodecConfig, tables=None):
    """Decode of an I frame (flat or coded) of one stream on the mesh's home
    device: the host parses, K2 decodes the two sections, K4 rebuilds the
    rows. Returns (frame [H, W, 3] uint8, tables'), pixels and tables equal
    to the session decoder's; a flat frame returns `tables` unchanged.
    Raises CorruptStreamError where the session decoder does."""
    h, w = cfg.height, cfg.width
    home = mesh.home
    if not data:
        raise bs.CorruptStreamError("empty frame")
    alg = bs.parse_header_byte(data[0])
    if alg == ALG_FLAT:
        if len(data) < 4:
            raise bs.CorruptStreamError("truncated flat frame")
        color = to_device(list(data[1:4]), home, "mesh.decode_i.flat", torch.uint8)
        return color.expand(h, w, 3).contiguous(), tables
    if alg != ALG_I:
        raise bs.CorruptStreamError("decode_i_sp expects a coded I frame")
    pay_rec, pay_col, n_rec, n_lit = parse_i_header(data, 1, cfg)
    with on_device(home), _stage("decode"):
        frame, total, tables = decode_i_device(
            upload(pay_rec, home), upload(pay_col, home), n_rec, n_lit,
            renew_tables_cached(home), cfg)
        with telemetry.sync("mesh.decode_i.check"):
            tiled = int(total) == w * h
        if not tiled:
            raise bs.CorruptStreamError("records do not tile frame")
    return frame, tables


# ---------------------------------------------------------------------------
# P frames
# ---------------------------------------------------------------------------


def _cands(cfg: CodecConfig, device) -> torch.Tensor:
    return to_device(mv_candidates(cfg), device, "mesh.cands", I32).reshape(-1, 2)


def _analyze_shard(full_f, full_p, cands, i: int, h_loc: int, cfg: CodecConfig):
    """P analysis of row shard i (block rows i * h_loc / 16 on, h_loc / 16 of
    them, rows past the frame unchanged) in one call on the full frames
    (full_f, full_p [H, W, 3]): change map and sub-rects in frame
    coordinates, the first-match motion search of its changed blocks
    against the full frames, block types. Returns (bts [nb_loc], rects
    [nb_loc, 4], mvs [nb_loc, 2], data blocks [1], flat [1]: 1 where every
    pixel of its rows equals the frame's pixel (0, 0))."""
    nby_loc, nbx = h_loc // BLOCK, cfg.nbx
    changed, rects, choice, flat = (a[0] for a in analyze_blocks_streams(
        full_f[None], full_p[None], cands, i * nby_loc, nby_loc))
    n_cand = cands.shape[0]
    found = changed & (choice < n_cand)
    if n_cand:
        mvs = cands[choice.clamp(0, n_cand - 1).long()]
    else:
        mvs = torch.zeros(changed.shape + (2,), dtype=I32, device=full_f.device)
    bts = block_types_from(changed, found, rects, nbx, cfg.height, cfg.width,
                           lin0=i * nby_loc * nbx)
    nd = ((bts == BT_FULL_DATA) | (bts == BT_PARTIAL_DATA)).sum(dtype=I32).reshape(1)
    return bts, rects, mvs, nd, flat.all().to(I32).reshape(1)


def encode_p_sp(frame, prev, mesh: Mesh, cfg: CodecConfig, tables: dict):
    """P-frame encode of one stream over the mesh's sp shards (the first dp
    row) against `prev` (the previous frame as coded). Block rows pad to a
    multiple of sp and split evenly; each shard analyses its blocks
    (motion against the full frames) and classifies the data blocks whose
    sub-rect starts in its rows, with a one-row halo; the block records
    compact and the five sections code on the home device (K1).
    Byte-identical to a session encoder's P frame for the same (frame,
    prev, tables).

    Returns (bytes, ftype, tables'): the no-change frame (2 bytes); a raw
    escape with renewed tables (ftype I); a flat frame with `tables`
    unchanged (single-frame helper, as `encode_i_sp`)."""
    _lossless(cfg)
    h = cfg.height
    devs = mesh.devices[0]
    home = devs[0]
    sp = len(devs)
    h_loc = -(-cfg.nby // sp) * BLOCK  # block rows padded to a multiple of sp
    nb = cfg.nbx * cfg.nby
    fs = [_rows(frame, i * h_loc, min((i + 1) * h_loc, h), h_loc, dev)
          for i, dev in enumerate(devs)]
    ps = [_rows(prev, i * h_loc, min((i + 1) * h_loc, h), h_loc, dev)
          for i, dev in enumerate(devs)]
    full = {}  # device -> (frame, prev, candidates): one all_gather a device
    for dev in devs:
        if dev not in full:
            full[dev] = (all_gather(fs, dev)[:h], all_gather(ps, dev)[:h], _cands(cfg, dev))
    shard_out = []
    for i, dev in enumerate(devs):
        with on_device(dev), _stage(f"analysis shard {i}"):
            shard_out.append(_analyze_shard(*full[dev], i, h_loc, cfg))
    flat = (psum([o[4] for o in shard_out], home) == sp).to(I32).reshape(1)
    c0 = fs[0][0, 0].to(home, I32)
    with on_device(home), _stage("block records"):
        bts, rects, mvs = (all_gather([o[j] for o in shard_out], home)[:nb][None]
                           for j in range(3))
        bt, sxy, mv, data_rects, counts = compact_block_records(bts, rects, mvs, cfg.nbx,
                                                                next_pow2(nb))
        nd_sh = all_gather([o[3] for o in shard_out], home)
    flat_h, c0_h, ch, nd_h = pull([[flat, c0, counts[0], nd_sh]], "codec.pull")[0]
    if flat_h[0]:
        return ct.flat_frame(c0_h), FTYPE_I, tables
    if not ch[0]:
        return ct.UNCHANGED_P, FTYPE_P, tables
    _any, xx1, xx2, n_bt, n_sxy, n_mv, n_data = (int(v) for v in ch)

    if n_data:
        halos_f = ppermute_down([f[-1] for f in fs])
        halos_p = ppermute_down([p[-1] for p in ps])
        offs = np.cumsum(nd_h) - nd_h
        pix_ch, lit_ch, cnt_ch = [], [], []
        for i, dev in enumerate(devs):
            nd = int(nd_h[i])
            if not nd:
                continue
            with on_device(dev), _stage(f"data blocks shard {i}"):
                # shard i > 0: its frame with the halo row on top, rows from
                # i * h_loc - 1, so the rects shift by 1 - i * h_loc and every
                # local y1 stays > 0 as the global one is. The top shard keeps
                # its rows and the global rects: a rect at y1 = 0 must find
                # no row above available (its window's zero apron is that row)
                r = data_rects[0, int(offs[i]):int(offs[i]) + nd].to(dev, non_blocking=True)
                f_loc, p_loc = fs[i], ps[i]
                if i:
                    f_loc = torch.cat([halos_f[i][None], f_loc])
                    p_loc = torch.cat([halos_p[i][None], p_loc])
                    r = r - to_device([0, i * h_loc - 1, 0, i * h_loc - 1], dev,
                                      "mesh.rect_shift", I32)
                pix, lit, cnt, _bm, _off = classify_assemble_streams(
                    f_loc[None], p_loc[None], r[None], [nd])
            pix_ch.append(pix)
            lit_ch.append(lit)
            cnt_ch.append(cnt[0, :2])
        with on_device(home), _stage("compaction"):
            cnt = all_gather([c[None] for c in cnt_ch], home)
            cap = int(sum(p.shape[0] for p in pix_ch))
            pix_cap = _join(pix_ch, cnt[:, 0], home, cap)
            lit_cap = _join(lit_ch, cnt[:, 1], home, cap)
        n_pix, n_lit = (int(v) for v in pull([[cnt.sum(dim=0)]], "codec.pull")[0][0])
    else:
        n_pix = n_lit = 0
        pix_cap = torch.zeros((1, 2), dtype=I32, device=home)
        lit_cap = torch.zeros((1, 3), dtype=I32, device=home)

    hdr_vals = [xx1, xx2, n_bt, n_sxy, n_mv, n_pix, n_lit, n_data]
    sources = {"bt": bt[0], "sxy": sxy[0], "mv": mv[0], "rec": pix_cap, "col": lit_cap}
    with on_device(home), _stage("sections"):
        _kts, bufs, starts, lens_l, stats, tables2 = encode_sections_raw(
            sources, hdr_vals, tables, cfg, ct.raw_size(cfg))
        data = ct.write_frame(ct.p_head(hdr_vals), bufs, starts, lens_l, stats)
        ftype = FTYPE_P
        if data is None:
            data, ftype = ct.RAW_HEAD + _host_bytes(frame), FTYPE_I
    return data, ftype, tables2


def decode_p_sp(data: bytes, prev, mesh: Mesh, cfg: CodecConfig, tables: dict):
    """Decode of a P frame of one stream on the mesh's home device: the
    host parses, K2 decodes the five sections, block resolution, motion
    apply and block rebuild follow (`pframe.decode_p_device`). Returns
    (frame, tables'), equal to the session decoder's; a no-change frame
    returns prev. A damaged frame raises the session decoder's
    CorruptStreamError."""
    home = mesh.home
    if not data:
        raise bs.CorruptStreamError("empty frame")
    if bs.parse_header_byte(data[0]) != ALG_P:
        raise bs.CorruptStreamError("decode_p_sp expects a P frame")
    prev = _rows(prev, 0, cfg.height, cfg.height, home)
    parsed = parse_p_header(data, 1, cfg)
    if parsed is None:
        return prev, tables
    payloads, ns, kts, (xx1, xx2, _n_mv, n_data) = parsed
    with on_device(home), _stage("decode"):
        frame, err, tables = decode_p_device(payloads_to_device(payloads, home), ns, kts,
                                             xx1, xx2, n_data, prev, tables, cfg)
        with telemetry.sync("mesh.decode_p.check"):
            err = int(err)
    if err:
        raise_p_error(err)
    return frame, tables


# ---------------------------------------------------------------------------
# Fixed-capacity device encode step and the dp x sp dryrun step
# ---------------------------------------------------------------------------


def _deal_capacity(records: torch.Tensor, n_rec: torch.Tensor, k: int):
    """Capacity dealing of [..., n, 2] records: record g to lane g // t_cap,
    step g % t_cap (t_cap = n // k) -> ([..., t_cap, k, 2], lens [..., k]
    = clip(n_rec - lane * t_cap, 0, t_cap))."""
    n = records.shape[-2]
    t_cap = n // k
    dealt = records.reshape(records.shape[:-2] + (k, t_cap, 2)).transpose(-3, -2)
    lane = torch.arange(k, device=records.device) * t_cap
    lens = (n_rec.long()[..., None] - lane).clamp(0, t_cap).to(I32)
    return dealt.contiguous(), lens, t_cap


def _check_k(h: int, w: int, k: int) -> None:
    if (h * w) % k:
        raise ValueError(f"capacity dealing needs k={k} to divide h * w = {h * w}")


def _encode_step_streams(frames: torch.Tensor, tabs: dict, k: int):
    """Fixed-capacity keyframe encode of C streams [C, h, w, 3] on their
    device: one K3 walk over their classifications, records dealt by
    capacity, one stream-batched K1 launch of their rec sections. tabs: the
    REC_KINDS tables [C, ...], updated in place. Returns (payload [C, k,
    cap], starts [C, k], n_records [C])."""
    res = classify_i_streams(frames)
    records = torch.stack([r[0] for r in res])
    n_rec = torch.stack([r[1] for r in res])
    dealt, lens, t_cap = _deal_capacity(records, n_rec, k)
    (buf,), (start,) = tc.encode_sections_streams(
        [dealt], [lens], tabs, (("rec", k, t_cap),), range(frames.shape[0]))
    return buf, start, n_rec


def device_encode_step(frame, tables: dict, h: int, w: int, k: int):
    """Fixed-capacity keyframe modeling and rANS pack of one stream, shaped
    by (h, w, k) alone: classification (K3), records dealt by capacity
    (`lane = g // t_cap`, t_cap = h * w // k), the rec section through K1
    (`_encode_step_streams` of one stream). Runs on the tables' device.
    Returns (payload [k, cap] uint8, lane starts [k], n_records, tables');
    lane j's bytes are payload[j, start[j]:]; the input tables are not
    written."""
    _check_k(h, w, k)
    dev = tables["ptype"]["cnt"].device
    tabs = {kd: {key: v[None].clone() for key, v in tables[kd].items()} for kd in REC_KINDS}
    with on_device(dev):
        buf, start, n_rec = _encode_step_streams(_rows(frame, 0, h, h, dev)[None], tabs, k)
    out = dict(tables)
    out.update({kd: {key: v[0] for key, v in tabs[kd].items()} for kd in REC_KINDS})
    return buf[0], start[0], n_rec[0], out


def dryrun_step(frames, prevs, tables_b: dict, mesh: Mesh, k: int = 8):
    """The multi-device dryrun step: `sharded_analysis_step`, then on each
    dp shard the fixed-capacity keyframe encode of its streams
    (`_encode_step_streams`: one K3 walk and one stream-batched K1 launch
    over them; `device_encode_step` is its one-stream case). frames, prevs
    [S, H, W, 3]; tables_b: [S, ...] table sets (not written). Returns ((fits, changed, flat),
    (payload [S, k, cap], starts [S, k], n_records [S]), tables_b') on the
    home device; tables_b' shares the tensors of the kinds the step does
    not touch."""
    s, h, w, _ = frames.shape
    _check_k(h, w, k)
    analysis = sharded_analysis_step(frames, prevs, mesh)
    dp = mesh.shape["dp"]
    c = s // dp
    home = mesh.home
    bufs, starts, n_recs, tabs_out = [], [], [], []
    for d, devs in enumerate(mesh.devices):
        dev = devs[0]
        tabs = {kd: {key: v[d * c:(d + 1) * c].to(dev, copy=True)
                     for key, v in tables_b[kd].items()} for kd in REC_KINDS}
        with on_device(dev):
            buf, start, n_rec = _encode_step_streams(
                _part(frames, slice(d * c, (d + 1) * c), dev), tabs, k)
        bufs.append(buf)
        starts.append(start)
        n_recs.append(n_rec)
        tabs_out.append(tabs)
    tables_out = dict(tables_b)
    for kd in REC_KINDS:
        tables_out[kd] = {key: all_gather([t[kd][key] for t in tabs_out], home)
                          for key in tables_b[kd]}
    return (analysis, (all_gather(bufs, home), all_gather(starts, home),
                       all_gather(n_recs, home)), tables_out)
