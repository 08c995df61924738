"""The port's CUDA kernels (K1-K4, their stream-batched launches and K1's
colw variant; K5, the P analysis's block front end; K6, the P decode's
data-block rebuild; K7, the session API's RGB32 conversion; K8, the P
decode's block resolution) against their plain PyTorch versions, on the
card. Skips where there is no CUDA device.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from screenpressor_tpu_torch import TorchDecoder, TorchEncoder, _build
from screenpressor_tpu_torch import classify as tcl
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import recon as tr
from screenpressor_tpu_torch.config import CodecConfig, lane_count, seg_tile
from screenpressor_tpu_torch.tables import renew_tables, renew_tables_streams

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def section_records(name, n, rng):
    """Random records of one codec (same ranges as the format allows)."""
    if name == "rec":
        return np.stack([rng.integers(0, 6, n), rng.integers(1, 256, n)], 1)
    if name == "col":
        pal = rng.integers(0, 256, (6, 3))
        return pal[rng.choice(6, n, p=[0.5, 0.2, 0.1, 0.1, 0.05, 0.05])]
    if name == "bt":
        return np.stack([rng.integers(0, 5, n), rng.integers(1, 256, n)], 1)
    if name == "sxy":
        return rng.integers(0, 16, (n, 4))
    mv = rng.integers(-64, 65, (n, 2))
    same = rng.random(n) < 0.5
    for i in range(1, n):
        if same[i]:
            mv[i] = mv[i - 1]
    return mv


def _dealt(records, n, k, dev):
    t = tc.steps_for(n, k)
    return tc.deal(torch.as_tensor(records, dtype=torch.int32, device=dev), n, k, t), t


def _assert_tables_equal(a, b):
    for kd in b:
        for key in b[kd]:
            assert torch.equal(a[kd][key].cpu(), b[kd][key].cpu()), (kd, key)


@pytest.mark.parametrize("name", ["rec", "col", "bt", "sxy", "mv"])
@pytest.mark.parametrize("n", [5, 700, 9000])
def test_section_kernels_match_plain(cuda, name, n):
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    records = section_records(name, n, rng)
    k = lane_count(n)
    dealt, t = _dealt(records, n, k, cuda)
    lens = tc.lane_lens(n, k, cuda)
    kts = ((name, k, t),)
    tabs = renew_tables(cuda)
    cum, freq, act, tab_p = tc.model_scan(dealt, lens, tabs, name)
    buf_p, start_p = tc.rans_pack(cum, freq, act, tc.pack_cap(name, t))
    bufs, starts, tab_k = tc.encode_sections([dealt], [lens], tabs, kts)
    lens_np = lens.cpu().numpy()
    blobs_p = tc.blobs_from_buf(buf_p.cpu().numpy(), start_p.cpu().numpy(), lens_np)
    blobs_k = tc.blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(), lens_np)
    assert blobs_k == blobs_p
    _assert_tables_equal(tab_k, tab_p)

    pay = torch.as_tensor(tc.pad_payload(blobs_k, k), device=cuda)
    rec_p, dtab_p = tc.decode_section_scan(pay, lens, tabs, name, t)
    recs, dtab_k = tc.decode_sections([pay], [lens], tabs, kts)
    assert torch.equal(recs[0], rec_p)
    _assert_tables_equal(dtab_k, dtab_p)
    _assert_tables_equal(dtab_k, tab_k)
    got = tc.undeal(recs[0], n, k, n).cpu().numpy()
    np.testing.assert_array_equal(got, records)


def test_fused_launch_matches_sequential(cuda):
    """All five P sections in one launch (disjoint kinds) chain tables like
    five separate launches."""
    rng = np.random.default_rng(4)
    names, dealt, lens_l, kts = ["bt", "sxy", "mv", "rec", "col"], [], [], []
    for name, n in zip(names, [40, 30, 20, 600, 300]):
        k = lane_count(n)
        d, t = _dealt(section_records(name, n, rng), n, k, cuda)
        dealt.append(d)
        lens_l.append(tc.lane_lens(n, k, cuda))
        kts.append((name, k, t))
    b1, s1, t1 = tc.encode_sections(dealt, lens_l, renew_tables(cuda), tuple(kts))
    tabs = renew_tables(cuda)
    for i in range(5):
        b, s, tabs = tc.encode_sections([dealt[i]], [lens_l[i]], tabs, (kts[i],))
        assert torch.equal(b[0], b1[i]) and torch.equal(s[0], s1[i])
    _assert_tables_equal(t1, tabs)


@pytest.mark.parametrize("tile", [256, 1024])
def test_run_walk_kernel_matches_plain(cuda, tile):
    rng = np.random.default_rng(tile)
    n = 5 * tile + 77
    bits = torch.as_tensor(rng.integers(0, 64, n, dtype=np.int32), device=cuda)
    st = torch.as_tensor(rng.integers(0, 6, n, dtype=np.int32), device=cuda)
    # long true streaks so MAX_RUN breaks occur
    bits[100:700] = 63
    got = tcl.run_walk(bits, st, tile)
    assert torch.equal(got, tcl.run_walk_plain(bits, st, tile))


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    f = np.full((h, w, 3), (32, 64, 96), np.uint8)
    f[h // 4: h // 2, w // 5: w // 2] = (250, 250, 250)
    f[h // 3: h // 3 + 6][rng.random((6, w)) < 0.3] = (10, 10, 10)
    gw = min(w, 64)
    f[h - 17: h - 1, :gw, 0] = (np.arange(16)[:, None] + np.arange(gw)[None]) % 256
    return f


@pytest.mark.parametrize("hw", [(48, 64), (272, 512)])
def test_recon_and_classify_kernels_match_plain(cuda, hw):
    h, w = hw
    frame = torch.as_tensor(_frame(h, w, h), device=cuda)
    fits = tcl.fits_planes_i(frame)
    st = tcl.start_types_i(fits)
    bits = tcl.fits_bits(fits)
    tile = seg_tile(h * w, w)
    assert torch.equal(tcl.run_walk(bits, st, tile), tcl.run_walk_plain(bits, st, tile))
    records, n_rec, lits, n_lit = tcl.classify_i(frame)
    pt_pix, lit_pix = tr.expand_records(records[: int(n_rec)], lits[: max(int(n_lit), 1)], h * w)
    rows = tr.pad_rows(pt_pix, lit_pix, h, w)
    got = tr.recon_rows(rows, w)
    assert torch.equal(got, tr.recon_rows_plain(rows, w))
    assert torch.equal(got, frame)


def test_golden_session_on_card(cuda):
    with open(os.path.join(DATA, "golden_manifest.json")) as fh:
        meta = json.load(fh)["golden_spec_48x64.bin"]
    with open(os.path.join(DATA, "golden_spec_48x64.bin"), "rb") as fh:
        blob = fh.read()
    frames = np.load(os.path.join(DATA, "golden_frames_48x64.npy"))
    cfg = CodecConfig(width=64, height=48, kf_interval=meta["kf_interval"])
    _build.reset_counts()
    got = TorchEncoder(cfg, cuda).encode_batch(list(frames))
    assert b"".join(p for p, _ in got) == blob
    assert zlib.crc32(blob) == meta["crc32"]
    out = TorchDecoder(cfg, cuda).decode_batch([p for p, _ in got])
    for f, o in zip(frames, out):
        np.testing.assert_array_equal(o, f)
    single = ("sptc_sections_encode", "sptc_sections_decode", "sptc_run_walk",
              "sptc_recon_rows")
    assert all(_build.LAUNCHES[k] > 0 for k in single), _build.LAUNCHES


def _clone(tables_b):
    return {kd: {key: v.clone() for key, v in tab.items()} for kd, tab in tables_b.items()}


def _streams_input(names, ns, k, dev, seed):
    """Per section: dealt [C, T, K, W] records of C streams (n per stream,
    some 0) and lens [C, K]."""
    rng = np.random.default_rng(seed)
    dealt, lens, kts = [], [], []
    for name in names:
        t = max(tc.steps_for(n, k) for n in ns)
        dealt.append(torch.stack([
            tc.deal(torch.as_tensor(section_records(name, max(n, 1), rng), dtype=torch.int32,
                                    device=dev), n, k, t) for n in ns]))
        lens.append(torch.stack([tc.lane_lens(n, k, dev) for n in ns]))
        kts.append((name, k, t))
    return dealt, lens, tuple(kts)


def test_stream_batched_sections_match_plain(cuda):
    """K1 / K2 over 4 of 6 streams (stream ids out of order, one stream
    with no records in some sections) against the stream loop of the plain
    coder: bytes, starts, records and every stream's tables; the streams
    left out keep their tables bit for bit."""
    names = ["bt", "sxy", "mv", "rec", "col"]
    ns = [300, 0, 41, 1200]
    sidx = [5, 0, 3, 2]
    k = 16
    dealt, lens, kts = _streams_input(names, ns, k, cuda, 9)
    base = renew_tables_streams(6, cuda)
    base["color"]["cnt"][4] += 1  # a stream left out, with its own state
    tk_, tp_ = _clone(base), _clone(base)
    bufs, starts = tc.encode_sections_streams(dealt, lens, tk_, kts, sidx)
    plain = {kd: {key: v.cpu() for key, v in tab.items()} for kd, tab in tp_.items()}
    bufs_p, starts_p = tc.encode_sections_streams(
        [d.cpu() for d in dealt], [ln.cpu() for ln in lens], plain, kts, sidx)
    pays = []
    for i, (name, _, t) in enumerate(kts):
        blobs = [tc.blobs_from_buf(bufs[i][j].cpu().numpy(), starts[i][j].cpu().numpy(),
                                   lens[i][j].cpu().numpy()) for j in range(len(sidx))]
        blobs_p = [tc.blobs_from_buf(bufs_p[i][j].numpy(), starts_p[i][j].numpy(),
                                     lens[i][j].cpu().numpy()) for j in range(len(sidx))]
        assert blobs == blobs_p, name
        arrs = [tc.pad_payload(bl, k) for bl in blobs]
        width = max(a.shape[1] for a in arrs)
        pays.append(torch.as_tensor(
            np.stack([np.pad(a, ((0, 0), (0, width - a.shape[1]))) for a in arrs]),
            device=cuda))
    _assert_tables_equal(tk_, plain)
    for key, v in base["color"].items():
        assert torch.equal(tk_["color"][key][4], v[4]), key
        assert torch.equal(tk_["color"][key][1], v[1]), key

    dk_, dp_ = _clone(base), _clone(base)
    recs = tc.decode_sections_streams(pays, lens, dk_, kts, sidx)
    plain_d = {kd: {key: v.cpu() for key, v in tab.items()} for kd, tab in dp_.items()}
    recs_p = tc.decode_sections_streams([p.cpu() for p in pays], [ln.cpu() for ln in lens],
                                        plain_d, kts, sidx)
    for i, (name, _, _) in enumerate(kts):
        assert torch.equal(recs[i].cpu(), recs_p[i]), name
        valid = (torch.arange(recs[i].shape[1], device=cuda)[None, :, None]
                 < lens[i][:, None, :])[..., None]
        assert torch.equal(torch.where(valid, recs[i], 0), torch.where(valid, dealt[i], 0))
    _assert_tables_equal(dk_, plain_d)
    _assert_tables_equal(dk_, tk_)


def _row_last_section(c, dev):
    """C streams' col sections whose literals touch color row 12287 (R 255,
    G >= 240) and fit the 256-row compact bucket."""
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (5, 3))
    pal[0] = (255, 250, 17)
    ns = [900, 60, 333][:c]
    lits = [torch.as_tensor(pal[rng.integers(0, 5, n)], dtype=torch.int32, device=dev)
            for n in ns]
    k = 32
    t = max(tc.steps_for(n, k) for n in ns)
    dealt = torch.stack([tc.deal(lt, n, k, t) for lt, n in zip(lits, ns)])
    lens = torch.stack([tc.lane_lens(n, k, dev) for n in ns])
    bm = torch.stack([tc.color_touched_bitmap(lt, n) for lt, n in zip(lits, ns)])
    return dealt, lens, bm, (("col", k, t),)


def test_colw_kernel_matches_full_col_kernel(cuda):
    """K1-colw (compact table gathered and restored in torch) against
    full-table K1 col and against the plain colw coder: bytes, starts and
    the restored full tables, on sections that touch row 12287."""
    dealt, lens, bm, kts = _row_last_section(3, cuda)
    assert tc.col_compact_bucket(int(bm.sum(dim=1).max())) == 256
    sidx = [2, 0, 1]
    base = renew_tables_streams(3, cuda)
    full, colw = _clone(base), _clone(base)
    _build.reset_counts()
    b_full, s_full = tc.encode_sections_streams([dealt], [lens], full, kts, sidx)
    b_w, s_w = tc.encode_sections_streams([dealt], [lens], colw, kts, sidx, 256, bm)
    assert _build.LAUNCHES["sptc_sections_encode_colw"] == 1
    assert torch.equal(s_w[0], s_full[0])
    for j in range(3):
        ln = lens[j].cpu().numpy()
        assert (tc.blobs_from_buf(b_w[0][j].cpu().numpy(), s_w[0][j].cpu().numpy(), ln)
                == tc.blobs_from_buf(b_full[0][j].cpu().numpy(), s_full[0][j].cpu().numpy(), ln))
    _assert_tables_equal(colw, full)
    plain = {kd: {key: v.cpu() for key, v in tab.items()} for kd, tab in base.items()}
    b_p, s_p = tc.encode_sections_streams([dealt.cpu()], [lens.cpu()], plain, kts, sidx, 256,
                                          bm.cpu())
    assert torch.equal(s_p[0], s_w[0].cpu())
    _assert_tables_equal(colw, plain)


def test_recon_streams_match_plain(cuda):
    frames = torch.stack([torch.as_tensor(_frame(48, 64, s), device=cuda) for s in (1, 2, 3)])
    cls = tcl.classify_i_streams(frames)
    records = [r[: int(n)] for r, n, _, _ in cls]
    lits = [lt[: max(int(n), 1)] for _, _, lt, n in cls]
    got = tr.reconstruct_i_streams(records, lits, 48, 64)
    assert torch.equal(got, frames)
    rows = torch.stack([tr.pad_rows(*tr.expand_records(r, lt, 48 * 64), 48, 64)
                        for r, lt in zip(records, lits)])
    assert torch.equal(tr.recon_rows(rows, 64),
                       torch.stack([tr.recon_rows_plain(r, 64) for r in rows]))


def k4_rows(n, h, wp, seed, dev):
    """[n, h, wp] packed rows of arbitrary ptypes 0..5 (resets rare, so
    whole warps carry; gradients at column 0) and int32 literals over the
    full range, padding columns included."""
    rng = np.random.default_rng(seed)
    size = (n, h, wp)
    carried = rng.choice([1, 3, 4], size)
    pt = np.where(rng.random(size) < 0.01, rng.choice([0, 2, 5], size), carried)
    pt[:, 1:, 0] = 4
    lit = rng.integers(-2**31, 2**31, size + (3,), dtype=np.int64).astype(np.int32)
    return tr.pack_rows(torch.as_tensor(pt, dtype=torch.int32, device=dev),
                        torch.as_tensor(lit, device=dev))


# Wp -> w: rows leave with 16-byte stores (Wp 128, 2048), 1-byte (1024), 4-byte
K4_WIDTHS = {128: 128, 512: 504, 1024: 1021, 2048: 1920, 4096: 4092, 8192: 8188}


@pytest.mark.parametrize("wp", sorted(K4_WIDTHS))
@pytest.mark.parametrize("n", [1, 64, 200])
def test_k4_matches_plain(cuda, wp, n):
    """K4 against recon_rows_plain on arbitrary packed rows: every width
    class (4, 8, 16 and 32 positions a thread) and store width, one frame (37 rows, deeper than
    the staging ring) and batches of 64 and 200 frames (5 and 2 rows)."""
    h = {1: 37, 64: 5, 200: 2}[n]
    w = K4_WIDTHS[wp]
    rows = k4_rows(n, h, wp, wp + n, cuda)
    _build.reset_counts()
    got = tr.recon_rows(rows if n > 1 else rows[0], w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sptc_recon_rows"] == 1
    want = torch.stack([tr.recon_rows_plain(r, w) for r in rows])
    assert torch.equal(got.reshape(want.shape), want)


def test_corrupt_p_frames_on_card(cuda):
    """The damaged payloads of the CPU test (tests/test_torch_corrupt.py):
    the CUDA decoder's verdict equals the CPU port's on each, nothing but
    CorruptStreamError is raised, and a clean stream still decodes on the
    same device afterwards (no device-side assert). The last payloads are
    the INDEX_SITE_FLIPS, which once took indices past their tensors."""
    from screenpressor_tpu_torch import bitstream as bs

    from torch_support import INDEX_SITE_FLIPS, corrupt_payloads  # tests/ is on the path

    cfg, frames, payloads, damaged = corrupt_payloads()

    def verdict(device, i, data):
        dec = TorchDecoder(cfg, device)
        dec.decode_batch(payloads[:i])
        try:
            return "ok", np.asarray(dec.decode_batch([data])[0])
        except bs.CorruptStreamError:
            return "corrupt", None

    for c, (i, data) in enumerate(damaged):
        got, frame = verdict(cuda, i, data)
        want, ref = verdict("cpu", i, data)
        assert got == want, f"case {c}: card {got}, CPU {want}"
        if got == "ok":
            np.testing.assert_array_equal(frame, ref)
        assert c < len(damaged) - len(INDEX_SITE_FLIPS) or got == "corrupt"
    torch.cuda.synchronize()
    out = TorchDecoder(cfg, cuda).decode_batch(payloads)
    for f, o in zip(frames, out):
        np.testing.assert_array_equal(o, f)


def test_batched_decoder_corrupt_stream_on_card(cuda):
    """One stream of a BatchedDecoder step damaged: CorruptStreamError, and
    the next keyframe step decodes losslessly on the same device. The
    SERVING_SITE_FLIPS, which once took indices past their tensors, fail."""
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

    from torch_support import SERVING_SITE_FLIPS, corrupt_payloads, flip  # tests/ is on the path

    cfg, frames, _, damaged = corrupt_payloads(seed=8, k_fixed=8)
    enc = BatchedEncoder(4, cfg, cuda)
    steps = [[p for p, _ in enc.encode(np.stack([f] * 4))] for f in frames[:3]]
    key = [p for p, _ in BatchedEncoder(4, cfg, cuda).encode(np.stack([frames[2]] * 4))]
    sites = [flip(steps[2][1], pos, x) for pos, x in SERVING_SITE_FLIPS]
    failed = 0
    for c, data in enumerate([d for _, d in damaged[:12]] + sites):
        dec = BatchedDecoder(4, cfg, cuda)
        for step in steps[:2]:
            dec.decode(step)
        try:
            dec.decode([steps[2][0], data, steps[2][2], steps[2][3]])
            assert c < 12, f"serving site flip {c - 12} decoded"
        except bs.CorruptStreamError:
            failed += 1
            np.testing.assert_array_equal(dec.decode(key), np.stack([frames[2]] * 4))
    assert failed > len(sites)


def _k2_matches_plain(pay, lens, tabs, name, k, t):
    """K2 against decode_section_scan on one payload: records and every
    table tensor equal; returns the kernel's records."""
    rec_p, tab_p = tc.decode_section_scan(pay, lens, tabs, name, t)
    _build.reset_counts()
    recs, tab_k = tc.decode_sections([pay], [lens], tabs, ((name, k, t),))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sptc_sections_decode"] == 1
    assert torch.equal(recs[0], rec_p)
    _assert_tables_equal(tab_k, tab_p)
    return recs[0]


def _encoded(name, records, k, dev, tabs=None):
    n = len(records)
    dealt, t = _dealt(records, n, k, dev)
    lens = tc.lane_lens(n, k, dev)
    tabs = renew_tables(dev) if tabs is None else tabs
    bufs, starts, _ = tc.encode_sections([dealt], [lens], tabs, ((name, k, t),))
    blobs = tc.blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(),
                              lens.cpu().numpy())
    return blobs, lens, t, tabs


@pytest.mark.parametrize("case", ["k512_col", "k512_rec", "mv_full_range", "window_col",
                                  "window_mv", "k64_mixed_rescale"])
def test_k2_shared_memory_cases(cuda, case):
    """K2's shared-memory design on the shapes the main path does not
    reach: 512 lanes (warps striding over lanes, rows re-read in phase
    (b)), the mv alphabet of 512, payloads too large to stage whole (the
    sliding window), and 64 lanes whose adds push a mixed kind's global
    row over the rescale threshold in one substep."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("k512"):
        name, n, k = case[5:], 512 * 21 + 77, 512
        records = section_records(name, n, rng)
    elif case == "mv_full_range":
        name, k = "mv", 32
        records = rng.integers(-255, 256, (4000, 2))
        records[1::3] = records[0::3][: len(records[1::3])]
        n = len(records)
    elif case == "window_col":
        name, n, k = "col", 32 * 700, 32
        records = rng.integers(0, 256, (n, 3))
    elif case == "window_mv":
        name, n, k = "mv", 32 * 900, 32
        records = rng.integers(-255, 256, (n, 2))
    else:
        name, n, k = "rec", 64 * 40, 64
        records = section_records(name, n, rng)
    blobs, lens, t, tabs = _encoded(name, records, k, cuda)
    pay = torch.as_tensor(tc.pad_payload(blobs, k), device=cuda)
    if case.startswith("window"):
        assert k * pay.shape[1] > 48 * 1024, "the payload must exceed the staged budget"
    recs = _k2_matches_plain(pay, lens, tabs, name, k, t)
    np.testing.assert_array_equal(tc.undeal(recs, n, k, n).cpu().numpy(), records)
    if case == "k64_mixed_rescale":
        g0 = int(tabs["nrun"]["gsum"])
        _, tab_p = tc.decode_section_scan(pay, lens, tabs, name, 1)
        assert g0 + 64 * 512 > 16384 - 512 >= int(tab_p["nrun"]["gsum"])


@pytest.mark.parametrize("name", ["rec", "col", "mv"])
@pytest.mark.parametrize("damage", ["truncated", "corrupt"])
def test_k2_damaged_payload_matches_plain_clamp(cuda, name, damage):
    """A truncated or corrupt payload finishes, never reads out of bounds,
    and decodes to the plain version's clamped records and tables."""
    rng = np.random.default_rng(len(name) + len(damage))
    n, k = 2000, 16
    blobs, lens, t, tabs = _encoded(name, section_records(name, n, rng), k, cuda)
    if damage == "truncated":
        blobs = [b[: max(4, len(b) // 3)] for b in blobs]
        pay = torch.as_tensor(tc.pad_payload(blobs, k), device=cuda)
        pay = pay[:, : max(4, pay.shape[1] // 2)].contiguous()
    else:
        arr = tc.pad_payload(blobs, k)
        hit = rng.random(arr.shape) < 0.05
        arr[hit] = rng.integers(0, 256, int(hit.sum()))
        pay = torch.as_tensor(arr, device=cuda)
    _k2_matches_plain(pay, lens, tabs, name, k, t)


def _k1_matches_plain(names, records_l, k, dev, tabs=None, col_w=None):
    """K1 on the sections of one stream (one fused launch per group of
    disjoint kinds) against model_scan + rans_pack chained over the
    sections: bytes, starts and every table tensor equal. Returns the
    plain version's tables."""
    tabs = renew_tables(dev) if tabs is None else tabs
    dealt, lens_l, kts = [], [], []
    for name, records in zip(names, records_l):
        n = len(records)
        d, t = _dealt(records, n, k, dev)
        dealt.append(d)
        lens_l.append(tc.lane_lens(n, k, dev))
        kts.append((name, k, t))
    bm = None
    if col_w is not None:
        i = names.index("col")
        bm = tc.color_touched_bitmap(
            torch.as_tensor(records_l[i], dtype=torch.int32, device=dev), len(records_l[i]))
        assert tc.col_compact_bucket(int(bm.sum())) == col_w, int(bm.sum())
    _build.reset_counts()
    bufs, starts, tab_k = tc.encode_sections(dealt, lens_l, tabs, tuple(kts), col_w, bm)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sptc_sections_encode"] >= 1
    assert (_build.LAUNCHES["sptc_sections_encode_colw"] > 0) == (col_w is not None)
    tab_p = tabs
    for (name, _, t), d, ln, b, st in zip(kts, dealt, lens_l, bufs, starts):
        cum, freq, act, tab_p = tc.model_scan(d, ln, tab_p, name)
        buf_p, start_p = tc.rans_pack(cum, freq, act, tc.pack_cap(name, t))
        ln = ln.cpu().numpy()
        assert torch.equal(st, start_p), name
        assert (tc.blobs_from_buf(b.cpu().numpy(), st.cpu().numpy(), ln)
                == tc.blobs_from_buf(buf_p.cpu().numpy(), start_p.cpu().numpy(), ln)), name
    _assert_tables_equal(tab_k, tab_p)
    return tab_p


@pytest.mark.parametrize("case", ["k512_col", "k512_rec", "k512_mv", "mv_full_range",
                                  "k64_nrun_rescale", "k64_color_rescale", "col_one_row",
                                  "colw256_row_last", "colw1024_row_last", "fused_five",
                                  "long_pack"])
def test_k1_shared_memory_cases(cuda, case):
    """K1's on-chip design on the shapes the main path does not reach: 512
    lanes (warps striding over lanes, color rows re-read in phase (b)), the
    mv alphabet of 512 over its full range, 64 lanes whose adds push a mixed
    kind's global row over the rescale threshold in one substep, a col
    section in which every lane hits one row in one substep, the compact
    color table in shared memory (colw256, 16-bit counts) and in L2
    (colw1024) on literals that touch color row 12287, five sections in one
    launch, and a section long enough for hundreds of pack passes."""
    rng = np.random.default_rng(sum(map(ord, case)))
    col_w = None
    if case.startswith("k512"):
        names, k = [case[5:]], 512
        records_l = [section_records(names[0], 512 * 9 + 77, rng)]
    elif case == "mv_full_range":
        names, k = ["mv"], 32
        records = rng.integers(-255, 256, (4000, 2))
        records[1::3] = records[0::3][: len(records[1::3])]
        records_l = [records]
    elif case == "k64_nrun_rescale":
        names, k = ["rec"], 64
        records_l = [section_records("rec", 64 * 40, rng)]
    elif case == "k64_color_rescale":
        names, k = ["col"], 64
        records_l = [section_records("col", 64 * 40, rng)]
    elif case == "col_one_row":
        names, k = ["col"], 32
        records = np.tile(np.array([[200, 100, 50]]), (32 * 60, 1))
        records[rng.random(len(records)) < 0.1] = (7, 100, 50)
        records_l = [records]
    elif case.startswith("colw"):
        col_w = int(case[4:].split("_")[0])
        names, k = ["col"], 32
        pal = rng.integers(0, 256, (5 if col_w == 256 else 24, 3))
        pal[0] = (255, 250, 17)  # R 255, G >= 240: color row 12287
        records_l = [pal[rng.integers(0, len(pal), 3000)]]
    elif case == "fused_five":
        names, k = ["bt", "sxy", "mv", "rec", "col"], 16
        records_l = [section_records(nm, n, rng)
                     for nm, n in zip(names, [400, 300, 200, 6000, 3000])]
    else:
        names, k = ["rec"], 4
        records_l = [section_records("rec", 4 * 3000, rng)]
    tab_p = _k1_matches_plain(names, records_l, k, cuda, col_w=col_w)
    if case == "k64_nrun_rescale":
        # one substep of 64 adds crosses the global row's threshold
        g0 = int(renew_tables(cuda)["nrun"]["gsum"])
        assert g0 + 64 * 512 > 16384 - 512 >= int(tab_p["nrun"]["gsum"])
    if case == "colw256_row_last":
        assert int(tab_p["color"]["cntsum"][12287]) > 0


def test_k1_stream_batched_colw_unequal_t(cuda):
    """Stream-batched K1 with unequal T (each stream's lens mask the padding
    steps), 64 lanes and one stream without records, full-table col and the
    colw path, against the plain coder's stream loop: bytes, starts and
    every stream's tables."""
    ns = [2500, 0, 64, 777, 5]
    sidx = [4, 1, 0, 6, 3]
    k = 64
    rng = np.random.default_rng(21)
    pal = rng.integers(0, 256, (7, 3))
    lits = [torch.as_tensor(pal[rng.integers(0, 7, max(n, 1))], dtype=torch.int32, device=cuda)
            for n in ns]
    t = max(tc.steps_for(n, k) for n in ns)
    dealt = [torch.stack([tc.deal(lt, n, k, t) for lt, n in zip(lits, ns)])]
    lens = [torch.stack([tc.lane_lens(n, k, cuda) for n in ns])]
    bm = torch.stack([tc.color_touched_bitmap(lt, n) for lt, n in zip(lits, ns)])
    kts = (("col", k, t),)
    base = renew_tables_streams(7, cuda)
    plain = {kd: {key: v.cpu() for key, v in tab.items()} for kd, tab in base.items()}
    b_p, s_p = tc.encode_sections_streams([dealt[0].cpu()], [lens[0].cpu()], plain, kts, sidx)
    for col_w in (None, 256):
        tabs = _clone(base)
        b_k, s_k = tc.encode_sections_streams(dealt, lens, tabs, kts, sidx, col_w,
                                              None if col_w is None else bm)
        assert torch.equal(s_k[0].cpu(), s_p[0])
        for j in range(len(ns)):
            ln = lens[0][j].cpu().numpy()
            assert (tc.blobs_from_buf(b_k[0][j].cpu().numpy(), s_k[0][j].cpu().numpy(), ln)
                    == tc.blobs_from_buf(b_p[0][j].numpy(), s_p[0][j].numpy(), ln)), (col_w, j)
        _assert_tables_equal(tabs, plain)


def walk_case(case, tile, rng):
    """fits bits and start types [n] for one K3 case."""
    n = 5 * tile + 77 if tile <= 3200 else 2 * tile + 1234  # a short last tile
    bits = rng.integers(0, 64, n, dtype=np.int32)
    st = rng.integers(0, 6, n, dtype=np.int32)
    if case == "random":
        bits[rng.random(n) < 0.9] = 63  # long runs with breaks in between
    elif case == "all_fits":
        bits[:] = 63
    elif case == "never_fits":
        bits[:] = 0
    elif case == "runs_255_256":
        # type-2 runs of exactly 255 and 256 fitting positions after a start
        bits[:] = 0
        st[:] = 2
        for start, run in ((3, 255), (300, 256), (tile - 100, 255), (tile + 7, 256)):
            bits[start + 1: start + run] = 4
    elif case == "short_tile":
        n = tile + 5
        bits, st = bits[:n].copy(), st[:n].copy()
        bits[-40:] = 63
    return bits, st


@pytest.mark.parametrize("tile", [256, 1000, 1024, 3200, 15360])
@pytest.mark.parametrize("case", ["random", "all_fits", "never_fits", "runs_255_256",
                                  "short_tile"])
def test_k3_jump_walk_cases(cuda, case, tile):
    """K3's jump walk against the plain walk: every tile size of the main
    paths (256: P-frame data blocks; 1,024; 3,200: 360p serving; 15,360:
    1080p) and one that is no multiple of 32, with a short last tile, runs
    of exactly MAX_RUN and MAX_RUN + 1, tiles where every bit fits and
    where none does."""
    bits, st = walk_case(case, tile, np.random.default_rng(tile + len(case)))
    bits, st = torch.as_tensor(bits, device=cuda), torch.as_tensor(st, device=cuda)
    _build.reset_counts()
    got = tcl.run_walk(bits, st, tile)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sptc_run_walk"] == 1
    assert torch.equal(got, tcl.run_walk_plain(bits, st, tile))


# masks of the session API's RGB16 cases: 565, 555, 444, and two wider
# than a byte or overlapping (the uint8 and uint16 wraps)
COLOR_MASKS = [(0xF800, 0x07E0, 0x001F), (0x7C00, 0x03E0, 0x001F), (0x0F00, 0x00F0, 0x000F),
               (0xFF80, 0x0070, 0x000F), (0xFFFF, 0x0FF0, 0x0001)]


@pytest.mark.parametrize("masks", COLOR_MASKS)
def test_rgb16_conversions_on_card_equal_numpy(cuda, masks):
    """The torch RGB16 conversions on CUDA tensors (uint16 widened through
    an int16 view, narrowed in range) equal the port's numpy ones."""
    from screenpressor_tpu_torch import colorspace as cs

    rng = np.random.default_rng(masks[0])
    f16 = rng.integers(0, 1 << 16, (270, 481), dtype=np.uint16)
    f24 = rng.integers(0, 256, (270, 481, 3), dtype=np.uint8)
    got24 = cs.rgb16_to_rgb24_any(torch.as_tensor(f16, device=cuda), *masks)
    got16 = cs.rgb24_to_rgb16_any(torch.as_tensor(f24, device=cuda), *masks)
    assert got24.device.type == "cuda" and got16.device.type == "cuda"
    assert got24.dtype == torch.uint8 and got16.dtype == torch.uint16
    np.testing.assert_array_equal(got24.cpu().numpy(), cs.rgb16_to_rgb24(f16, *masks))
    np.testing.assert_array_equal(got16.cpu().numpy(), cs.rgb24_to_rgb16(f24, *masks))


def test_rgb32_conversions_on_card_equal_numpy(cuda):
    from screenpressor_tpu_torch import colorspace as cs

    rng = np.random.default_rng(32)
    f32 = rng.integers(0, 256, (270, 481, 4), dtype=np.uint8)
    f24 = rng.integers(0, 256, (270, 481, 3), dtype=np.uint8)
    got24 = cs.rgb32_to_rgb24_device(torch.as_tensor(f32, device=cuda))
    got32 = cs.rgb24_to_rgb32_device(torch.as_tensor(f24, device=cuda))
    assert got24.device.type == "cuda" and got32.device.type == "cuda"
    np.testing.assert_array_equal(got24.cpu().numpy(), cs.rgb32_to_rgb24(f32))
    np.testing.assert_array_equal(got32.cpu().numpy(), cs.rgb24_to_rgb32(f24))


@pytest.mark.parametrize("fmt", ["rgb32", "rgb16_565", "rgb16_555"])
def test_device_frame_session_equals_host_frame_session(cuda, fmt):
    """An Encoder session fed CUDA frames (converted on the card; RGB32's
    strided RGB view made contiguous by the session's copy) writes the
    bytes of one fed the same frames from the host, and a default Decoder
    configures itself from the stream and gives the frames back."""
    from screenpressor_tpu_torch import Decoder, Encoder, FormatParams, PixelFormat
    from screenpressor_tpu_torch import colorspace as cs
    from screenpressor_tpu_torch.synth import synth_screencast

    h, w = 96, 160
    frames24 = synth_screencast(h, w, 6)
    rng = np.random.default_rng(7)
    if fmt == "rgb32":
        params = FormatParams(pixel_format=PixelFormat.RGB32)
        frames = [np.dstack([f, rng.integers(0, 256, (h, w), dtype=np.uint8)])
                  for f in frames24]
    else:
        masks = (0xF800, 0x07E0, 0x001F) if fmt == "rgb16_565" else (0x7C00, 0x03E0, 0x001F)
        params = FormatParams(PixelFormat.RGB16, *masks)
        cut = np.array([3, 2, 3] if fmt == "rgb16_565" else [3, 3, 3], np.uint8)
        frames = [cs.rgb24_to_rgb16(f >> cut, *masks) for f in frames24]
    cfg = CodecConfig(width=w, height=h)
    host = Encoder(cfg, params).encode_batch(frames)
    dev = Encoder(cfg, params).encode_batch([torch.as_tensor(f, device=cuda) for f in frames])
    assert dev == host
    one = Encoder(cfg, params)
    assert [one.encode(torch.as_tensor(f, device=cuda)) for f in frames] == host
    dec = Decoder(cfg)
    out = dec.decode_batch([p for p, _ in host])
    assert dec.fmt == params
    for o, f in zip(out, frames, strict=True):
        if fmt == "rgb32":
            np.testing.assert_array_equal(o[..., :3], f[..., :3])
            assert (o[..., 3] == 255).all()
        else:
            np.testing.assert_array_equal(o, f)


def _encode_front_batches(s=6, h=40, w=56, steps=4):
    """Serving steps for the stream-batched P encode: scrolling and typing
    synth_screencast streams (each rolled its own way), a noise stream and
    a flat one. [steps] arrays [s, h, w, 3]."""
    from screenpressor_tpu_torch.synth import synth_screencast

    rng = np.random.default_rng(12)
    base = synth_screencast(h, w, steps + 1, seed=5)
    out = []
    for t in range(steps):
        f = [np.roll(base[t + 1 if i % 2 else t], 5 * i, axis=1) for i in range(s - 2)]
        f.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        f.append(np.full((h, w, 3), 17 * t, np.uint8))
        out.append(np.stack(f))
    return out


@pytest.mark.parametrize("chunk", [None, 7])
def test_stream_encode_front_matches_cpu(cuda, monkeypatch, chunk):
    """analyze_compact_streams, classify_assemble_streams and deal_streams
    on the card equal the CPU port on the serving steps (chunk: a small
    SEARCH_CHUNK, many candidate chunks)."""
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import pframe as tp

    if chunk:
        monkeypatch.setattr(tb, "SEARCH_CHUNK", chunk)
    batches = _encode_front_batches()
    cfg = CodecConfig(width=56, height=40, k_fixed=8, msr_x=24, msr_y=24)
    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32).reshape(-1, 2)
    for t in range(1, len(batches)):
        res = {}
        for dev in ("cpu", cuda):
            fr = torch.as_tensor(batches[t], device=dev)
            pv = torch.as_tensor(batches[t - 1], device=dev)
            arrs, counts, flat = tb.analyze_compact_streams(fr, pv, cands.to(dev), cfg)
            ch = torch.cat([counts, flat], dim=1).cpu().numpy()
            n_data = np.where((ch[:, 0] != 0) & (ch[:, 7] == 0), ch[:, 6], 0)
            cls = tp.classify_assemble_streams(fr, pv, arrs["data_rects"], n_data)
            dealt = tc.deal_streams(cls[0], torch.as_tensor(cls[4], device=dev),
                                    cls[2][:, 0], 8, 40)
            res[str(dev)] = ({k: v.cpu() for k, v in arrs.items()}, ch,
                             [c.cpu() if isinstance(c, torch.Tensor) else c for c in cls],
                             dealt.cpu())
        (a0, ch0, c0, d0), (a1, ch1, c1, d1) = res["cpu"], res[str(cuda)]
        np.testing.assert_array_equal(ch1, ch0)
        for j in range(ch0.shape[0]):
            for nm, col in (("bt", 3), ("sxy", 4), ("mv", 5), ("data_rects", 6)):
                n = ch0[j, col] if ch0[j, 0] else 0
                assert torch.equal(a1[nm][j, :n], a0[nm][j, :n]), (t, j, nm)
        for x0, x1 in zip(c0, c1):
            np.testing.assert_array_equal(np.asarray(x1), np.asarray(x0))
        assert torch.equal(d1, d0)
        assert ch0[:, 6].sum() > 0


def test_batched_encoder_stream_front_on_card(cuda):
    """BatchedEncoder (one stream-batched analysis and classification a
    step) and TorchEncoder.encode_batch (one a batch) write on the card the
    bytes they write on the CPU."""
    from screenpressor_tpu_torch.parallel.serving import BatchedEncoder

    batches = _encode_front_batches()
    cfg = CodecConfig(width=56, height=40, k_fixed=8, kf_interval=3, msr_x=24, msr_y=24)
    got = {}
    for dev in ("cpu", cuda):
        enc = BatchedEncoder(6, cfg, dev, kf_offsets=[0, 1, 2, 0, 1, 2])
        one = TorchEncoder(cfg, dev)
        got[str(dev)] = ([enc.encode(f) for f in batches],
                         one.encode_batch([f[1] for f in batches]))
    assert got[str(cuda)] == got["cpu"]


@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("name", ["rec", "col"])
def test_section_kernels_wide_lanes(cuda, name, k):
    """K1 and K2 at the lane counts of a 4K keyframe's sections (K > 64)
    against their plain versions: bytes, records and tables."""
    rng = np.random.default_rng(k + len(name))
    n = 37 * k + 5
    records = section_records(name, n, rng)
    dealt, t = _dealt(records, n, k, cuda)
    lens = tc.lane_lens(n, k, cuda)
    tabs = renew_tables(cuda)
    cum, freq, act, tab_p = tc.model_scan(dealt, lens, tabs, name)
    buf_p, start_p = tc.rans_pack(cum, freq, act, tc.pack_cap(name, t))
    bufs, starts, tab_k = tc.encode_sections([dealt], [lens], tabs, ((name, k, t),))
    lens_np = lens.cpu().numpy()
    blobs = tc.blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(), lens_np)
    assert blobs == tc.blobs_from_buf(buf_p.cpu().numpy(), start_p.cpu().numpy(), lens_np)
    _assert_tables_equal(tab_k, tab_p)
    pay = torch.as_tensor(tc.pad_payload(blobs, k), device=cuda)
    rec_p, dtab_p = tc.decode_section_scan(pay, lens, tabs, name, t)
    recs, dtab_k = tc.decode_sections([pay], [lens], tabs, ((name, k, t),))
    assert torch.equal(recs[0], rec_p)
    _assert_tables_equal(dtab_k, dtab_p)
    np.testing.assert_array_equal(tc.undeal(recs[0], n, k, n).cpu().numpy(), records)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_session_on_card_equals_cpu(cuda, sp):
    """The row-sharded session (parallel/mesh.py) with sp shards on the one
    card: the bytes of the CPU port's sp session, and its decode."""
    from screenpressor_tpu_torch.parallel import mesh as tm

    cfg = CodecConfig(width=64, height=64, k_fixed=8, msr_x=16, msr_y=16)
    f0 = _frame(64, 64, 3)
    f1 = np.roll(f0, 8, axis=0)
    f2 = f1.copy()
    f2[20:27, 30:39] = np.random.default_rng(5).integers(0, 256, (7, 9, 3))
    frames = [f0, f1, f2, f2.copy()]

    def session(mesh):
        data, _, tabs = tm.encode_i_sp(f0, mesh, cfg)
        out = [data]
        for prev, f in zip(frames, frames[1:]):
            data, _, tabs = tm.encode_p_sp(f, prev, mesh, cfg, tabs)
            out.append(data)
        return out

    got = session(tm.make_mesh(sp, sp=sp, devices=[cuda] * sp))
    assert got == session(tm.make_mesh(sp, sp=sp, devices=["cpu"] * sp))
    assert got == [p for p, _ in TorchEncoder(cfg, "cpu").encode_batch(frames)]
    mesh = tm.make_mesh(sp, sp=sp, devices=[cuda] * sp)
    frame, tabs = tm.decode_i_sp(got[0], mesh, cfg)
    for data, f in zip(got[1:], frames[1:]):
        frame, tabs = tm.decode_p_sp(data, frame, mesh, cfg, tabs)
        np.testing.assert_array_equal(frame.cpu().numpy(), f)


def _window_session(dev, devices=None, steps=5):
    """_encode_front_batches' streams (keyframe offsets 0, 1, 2) through a
    per-step keyframe step, then one window (parallel/serve_scan.py) whose
    capacities the noise stream exceeds (RAW); returns (steps' outputs,
    the window's decoded frames)."""
    from screenpressor_tpu_torch.parallel import serve_scan as ss
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

    batches = _encode_front_batches(steps=steps)
    cfg = CodecConfig(width=56, height=40, k_fixed=8, kf_interval=3, msr_x=24, msr_y=24)
    kw = {"device": dev} if devices is None else {"devices": devices}
    enc = BatchedEncoder(6, cfg, kf_offsets=[0, 1, 2, 0, 1, 2], **kw)
    dec = BatchedDecoder(6, cfg, **kw)
    wcfg = ss.WindowConfig(cfg, 6, f=steps - 1, c=2, rec_cap=1024, col_cap=1024,
                           irec_cap=2048, icol_cap=2048, pack_cap=8192)
    outs = [enc.encode(batches[0])]
    dec.decode([p for p, _ in outs[0]])
    outs += ss.encode_window(enc, batches[1:], wcfg)
    back = ss.decode_window(dec, [[p for p, _ in o] for o in outs[1:]])
    dec.validate()
    for t in range(steps - 1):
        np.testing.assert_array_equal(back[t].cpu().numpy(), batches[t + 1], err_msg=str(t))
    return outs


def test_window_on_card_equals_cpu(cuda):
    """A window (K1-K4 on the card, the RAW escape of the noise stream)
    writes the CPU port's bytes, and decode_window gives the frames back."""
    got = _window_session(cuda)
    assert got == _window_session("cpu")
    assert any(p[0] & 0x0F == 4 for o in got[1:] for p, _ in o)  # a RAW escape


@pytest.mark.parametrize("n", [2, 3])
def test_split_on_card_equals_unsplit(cuda, n):
    """The serving sessions split over n stream groups on the one card
    (devices=[cuda] * n), per step and through a window: the unsplit
    session's bytes and frames."""
    from screenpressor_tpu_torch.parallel.serving import (
        BatchedDecoder,
        BatchedEncoder,
        serve_pipelined,
    )

    batches = _encode_front_batches()
    cfg = CodecConfig(width=56, height=40, k_fixed=8, kf_interval=3, msr_x=24, msr_y=24)
    got = {}
    for label, kw in (("unsplit", {"device": cuda}), ("split", {"devices": [cuda] * n})):
        enc = BatchedEncoder(6, cfg, kf_offsets=[0, 1, 2, 0, 1, 2], **kw)
        dec = BatchedDecoder(6, cfg, **kw)
        steps = []
        for t, (outs, back) in enumerate(serve_pipelined(enc, batches, dec)):
            assert back.device.type == "cuda"
            np.testing.assert_array_equal(back.cpu().numpy(), batches[t], err_msg=str(t))
            steps.append(outs)
        dec.validate()
        got[label] = steps
    assert got["split"] == got["unsplit"]
    assert _window_session(cuda, [cuda] * n) == _window_session(cuda)


def _k5_vs_plain(frames, prevs, cfg, dev, row0=0, nby=None):
    """K5 (analyze_blocks_streams on the card) and the plain version on the
    same device tensors -> (K5's (changed, rects, choice, flat), plain's,
    K5's launches)."""
    from screenpressor_tpu_torch import blocks as tb

    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev).reshape(-1, 2)
    fr, pv = torch.as_tensor(frames, device=dev), torch.as_tensor(prevs, device=dev)
    n0 = _build.LAUNCHES["sptc_analyze_blocks"]
    got = tb.analyze_blocks_streams(fr, pv, cands, row0, nby)
    launches = _build.LAUNCHES["sptc_analyze_blocks"] - n0
    want = tb.analyze_blocks_streams_plain(fr, pv, cands, row0, nby)
    return [a.cpu() for a in got], [a.cpu() for a in want], launches


def _assert_k5_equal(got, want, what=""):
    for g, w, name in zip(got, want, ("changed", "rects", "choice", "flat")):
        assert g.shape == w.shape and torch.equal(g, w), f"{what}: {name}"


@pytest.mark.parametrize("name", ["noise", "last", "edges", "streams", "idle", "flat"])
def test_motion_search_kernel_matches_plain(cuda, name):
    """K5 equals the plain version (on the card and on the CPU) on the
    motion search fixtures (40x56: partial edge blocks; 3W = 168, so the
    strip rows alternate 16-byte and 4-byte staging), all four outputs,
    in one launch."""
    from torch_support import MS_CFG, motion_search_fixtures  # tests/ is on the path

    frames, prevs, _ = motion_search_fixtures()[name]
    cfg = CodecConfig(**MS_CFG)
    got, want, launches = _k5_vs_plain(frames, prevs, cfg, cuda)
    _assert_k5_equal(got, want, name)
    assert launches == 1
    cpu, _, _ = _k5_vs_plain(frames, prevs, cfg, "cpu")
    _assert_k5_equal(got, cpu, f"{name} against the CPU")


def test_motion_search_kernel_on_1080p_batch(cuda):
    """K5 equals the plain version on the 1080p synth_screencast batch's 63
    (frame, prev) pairs in one call, as encode_batch makes it."""
    from screenpressor_tpu_torch.synth import synth_screencast

    frames = np.stack(synth_screencast(1080, 1920, 64))
    got, want, launches = _k5_vs_plain(frames[1:], frames[:-1],
                                       CodecConfig(width=1920, height=1080), cuda)
    _assert_k5_equal(got, want, "1080p batch")
    assert launches == 1
    assert (got[2] < 1278).sum() > 0 and got[0].sum() > 0


@pytest.mark.parametrize("sp", [2, 4])
def test_motion_search_kernel_row_ranges(cuda, sp):
    """K5 over the block rows of each sp shard (1080p: 68 block rows, the
    last shard of sp 4 ends at the frame; 4 of the batch's pairs) equals
    the plain version, rects in frame coordinates."""
    from screenpressor_tpu_torch.synth import synth_screencast

    frames = np.stack(synth_screencast(1080, 1920, 5))
    cfg = CodecConfig(width=1920, height=1080)
    nby_loc = -(-cfg.nby // sp)
    for i in range(sp):
        got, want, launches = _k5_vs_plain(frames[1:], frames[:-1], cfg, cuda,
                                           i * nby_loc, nby_loc)
        _assert_k5_equal(got, want, f"sp {sp} shard {i}")
        assert launches == 1 and got[0].shape == (4, nby_loc * cfg.nbx)


def test_motion_search_kernel_on_noise_pair(cuda):
    """A noise frame against a noise prev: every block changed, none
    matching (every candidate of every block tested); equal to plain."""
    rng = np.random.default_rng(73)
    pair = rng.integers(0, 256, (2, 2, 96, 200, 3), dtype=np.uint8)
    got, want, launches = _k5_vs_plain(pair[1], pair[0], CodecConfig(width=200, height=96),
                                       cuda)
    _assert_k5_equal(got, want, "noise")
    assert launches == 1 and bool(got[0].all()) and not bool(got[3].any())
    assert bool((got[2] == got[2].max()).all())


@pytest.mark.parametrize("h, w", [(37, 131), (45, 20), (33, 130)])
def test_motion_search_kernel_odd_widths(cuda, h, w):
    """Widths whose 3W is no multiple of 16 or of 4 (strip rows staged by
    single bytes, streams at unaligned offsets), partial edge blocks: a
    scrolled desktop with a typed patch and a moved region, three streams,
    equal to plain."""
    from torch_support import _ms_desktop  # tests/ is on the path

    rng = np.random.default_rng(h * w)
    tall = np.stack([_ms_desktop(rng, h + 4, w) for _ in range(3)])
    prevs = tall[:, :h].copy()
    frames = tall[:, 2:h + 2].copy()
    frames[0, 5:11, 3:9] = (200, 30, 30)
    frames[1] = prevs[1]
    frames[2, h // 2:, w // 2:] = rng.integers(0, 256, (h - h // 2, w - w // 2, 3))
    cfg = CodecConfig(width=w, height=h, msr_x=8, msr_y=8)
    got, want, launches = _k5_vs_plain(frames, prevs, cfg, cuda)
    _assert_k5_equal(got, want, f"{h}x{w}")
    assert launches == 1 and int((got[2] < got[2].max()).sum()) > 0


def _serving_steps(n=5):
    """chip_smoke.py's serving profile: 64 streams of 360x640, stream i
    rolled 3 i columns, n steps."""
    from screenpressor_tpu_torch.synth import synth_screencast

    base = synth_screencast(360, 640, n, seed=3)
    return [np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(64)]) for t in range(n)]


def test_motion_search_kernel_on_serving_steps(cuda):
    """K5 equals the plain version on every step of the serving session
    (64 streams of 360x640, msr 256), each step's 64 pairs in one call."""
    steps = _serving_steps()
    cfg = CodecConfig(width=640, height=360, k_fixed=64, msr_x=256, msr_y=256)
    for t in range(1, len(steps)):
        got, want, launches = _k5_vs_plain(steps[t], steps[t - 1], cfg, cuda)
        _assert_k5_equal(got, want, f"step {t}")
        assert launches == 1


def test_analyze_compact_streams_makes_no_host_sync(cuda, monkeypatch):
    """analyze_compact_streams on CUDA tensors makes one K5 launch, calls
    neither pack_pixels nor change_analysis_streams and makes no host sync
    (torch's sync debug mode set to raise), on the serving scroll step and
    on the noise fixture, and its outputs equal the CPU port's."""
    from torch_support import MS_CFG, motion_search_fixtures  # tests/ is on the path

    from screenpressor_tpu_torch import blocks as tb

    steps = _serving_steps(3)
    noise = motion_search_fixtures()["noise"]
    for (frames, prevs), cfg in (
            ((steps[1], steps[0]), CodecConfig(width=640, height=360, msr_x=256, msr_y=256)),
            (noise[:2], CodecConfig(**MS_CFG))):
        cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32).reshape(-1, 2)
        want = tb.analyze_compact_streams(torch.as_tensor(frames), torch.as_tensor(prevs),
                                          cands, cfg)
        fr, pv, cd = (torch.as_tensor(x, device=cuda) for x in (frames, prevs, cands))
        tb.analyze_compact_streams(fr, pv, cd, cfg)  # builds and loads K5 first
        torch.cuda.synchronize()

        def banned(*args, **kw):
            raise AssertionError("a plain analysis stage ran on the card")

        with monkeypatch.context() as mp:
            mp.setattr(tb, "pack_pixels", banned)
            mp.setattr(tb, "change_analysis_streams", banned)
            n0 = _build.LAUNCHES["sptc_analyze_blocks"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                arrs, counts, flat = tb.analyze_compact_streams(fr, pv, cd, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert _build.LAUNCHES["sptc_analyze_blocks"] - n0 == 1
        assert torch.equal(counts.cpu(), want[1]) and torch.equal(flat.cpu(), want[2])
        for nm, a in arrs.items():
            assert torch.equal(a.cpu(), want[0][nm]), nm


def test_motion_search_kernel_past_2_31_pixels(cuda):
    """A call of 2,049 streams of 1024x1024 (C * H * W * 3 bytes > 2^31, and
    C * H * W > 2^31 too): the last stream's blocks, whose byte offsets
    pass 2^31, get the plain version's outputs on that stream alone; the
    other streams (zero frames) are unchanged and flat."""
    from torch_support import _ms_shift  # tests/ is on the path

    from screenpressor_tpu_torch import blocks as tb

    c, h, w = 2049, 1024, 1024
    cfg = CodecConfig(width=w, height=h, msr_x=16, msr_y=16)
    rng = np.random.default_rng(71)
    prev = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    cur = prev.copy()
    for i, box in enumerate(((1008, 1008, 1024, 1024), (3, 5, 12, 16), (512, 40, 520, 48))):
        _ms_shift(cur, prev, box, *((-i - 1, 0), (0, 1), (2, 2))[i])
    cur[600:610, 700:710] = 9  # two data blocks
    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=cuda).reshape(-1, 2)
    one_f = torch.as_tensor(cur, device=cuda)[None]
    one_p = torch.as_tensor(prev, device=cuda)[None]
    want = [a[0] for a in tb.analyze_blocks_streams_plain(one_f, one_p, cands)]
    fr = torch.zeros((c, h, w, 3), dtype=torch.uint8, device=cuda)
    pv = torch.zeros_like(fr)
    fr[-1], pv[-1] = one_f[0], one_p[0]
    del one_f, one_p
    changed, rects, choice, flat = tb.analyze_blocks_streams(fr, pv, cands)
    _assert_k5_equal([changed[-1], rects[-1], choice[-1], flat[-1]], want, "last stream")
    assert bool((choice[:-1] == cands.shape[0]).all())
    assert not bool(changed[:-1].any()) and bool(flat[:-1].all())
    assert torch.equal(rects[:-1], rects[:1].expand(c - 1, -1, -1))
    assert int((want[2] < cands.shape[0]).sum()) == 3


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_shard_analysis_one_launch_no_sync(cuda, monkeypatch, sp):
    """parallel/mesh.py's _analyze_shard on the card: one K5 launch over the
    shard's block rows of the full frames, neither pack_pixels nor
    change_analysis_streams, no host sync (sync debug mode "error"), and
    the CPU port's outputs (1080p, the batch's scroll pair; at sp 4 the
    last shard ends at the frame)."""
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch.parallel import mesh as tm
    from screenpressor_tpu_torch.synth import synth_screencast

    frames = synth_screencast(1080, 1920, 2)
    cfg = CodecConfig(width=1920, height=1080)
    h_loc = -(-cfg.nby // sp) * 16
    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32).reshape(-1, 2)
    full = [torch.as_tensor(frames[1]), torch.as_tensor(frames[0])]
    want = [tm._analyze_shard(*full, cands, i, h_loc, cfg) for i in range(sp)]
    on_card, cd = [t.to(cuda) for t in full], cands.to(cuda)
    tm._analyze_shard(*on_card, cd, 0, h_loc, cfg)  # builds and loads K5 first
    torch.cuda.synchronize()

    def banned(*args, **kw):
        raise AssertionError("a plain analysis stage ran on the card")

    monkeypatch.setattr(tb, "pack_pixels", banned)
    monkeypatch.setattr(tb, "change_analysis_streams", banned)
    for i in range(sp):
        n0 = _build.LAUNCHES["sptc_analyze_blocks"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tm._analyze_shard(*on_card, cd, i, h_loc, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _build.LAUNCHES["sptc_analyze_blocks"] - n0 == 1
        for g, w in zip(got, want[i]):
            assert torch.equal(g.cpu(), w), i


def _k6_vs_plain(args, check=None):
    """K6 (reconstruct_blocks_streams on the card) and the plain version on
    the same inputs (out, prev, rects, bsid, ptypes, rlens, lits; out is
    not written) -> (K6's frames, plain's, both [C * h * w, 3] without the
    sink row, K6's launches). check: a callable run on K6's call alone
    (the launch counted inside it)."""
    from screenpressor_tpu_torch import pframe as tp

    out, rest = args[0], args[1:]
    got, want = out.clone(), out.clone()
    n0 = _build.LAUNCHES["sptc_rebuild_blocks"]
    (check or (lambda fn: fn()))(lambda: tp.reconstruct_blocks_streams(got, *rest))
    launches = _build.LAUNCHES["sptc_rebuild_blocks"] - n0
    tp.reconstruct_blocks_streams_plain(want, *rest)
    return got[:-1], want[:-1], launches


def _fixture_args(name, dev):
    from torch_support import rebuild_fixtures  # tests/ is on the path

    base, prev, rects, bsid, pt, rl, lt, _ = rebuild_fixtures()[name]
    out = torch.cat([torch.as_tensor(base).reshape(-1, 3), torch.zeros((1, 3), dtype=torch.uint8)])
    return [t.to(dev) for t in (out, *(torch.as_tensor(a) for a in (prev, rects, bsid, pt, rl,
                                                                   lt)))]


@pytest.mark.parametrize("name", ["damaged", "edges", "empty", "motion", "partial", "streams",
                                  "types", "wrap"])
def test_block_rebuild_kernel_matches_plain(cuda, name):
    """K6 equals the plain version on the card and on the CPU on the
    rebuild fixtures (every predictor type, wrapping gradients, frame
    edges, partial blocks of a 37 x 53 frame, neighbours from prev beside
    motion, empty slots, three streams, damaged rects and runs whose slots
    do not overlap), in one launch."""
    args = _fixture_args(name, cuda)
    got, want, launches = _k6_vs_plain(args)
    assert launches == 1 and torch.equal(got, want), name
    cpu, _, _ = _k6_vs_plain([a.cpu() for a in args])
    assert torch.equal(got.cpu(), cpu), f"{name} against the CPU"


def _decode_rebuild_calls(run):
    """The inputs of the reconstruct_blocks_streams calls run() makes."""
    from torch_support import rebuild_calls  # tests/ is on the path

    store = []
    with rebuild_calls(store):
        run()
    return store


def test_block_rebuild_kernel_on_serving_steps(cuda):
    """K6 equals the plain version on the serving session's scroll and
    typing steps (64 streams of 360x640, as BatchedDecoder hands them)."""
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

    steps = _serving_steps(3)
    cfg = CodecConfig(width=640, height=360, k_fixed=64, msr_x=256, msr_y=256)
    enc = BatchedEncoder(64, cfg, cuda)
    payloads = [[p for p, _ in enc.encode(torch.as_tensor(f, device=cuda))] for f in steps]

    def run():
        dec = BatchedDecoder(64, cfg, cuda)
        for step, f in zip(payloads, steps):
            assert np.array_equal(dec.decode(step), f)

    calls = _decode_rebuild_calls(run)
    assert len(calls) == 2
    for args in calls:
        got, want, launches = _k6_vs_plain(args)
        assert launches == 1 and torch.equal(got, want)
    assert int((calls[1][2][:, 2] > calls[1][2][:, 0]).sum()) > 0  # typing: data blocks


def test_block_rebuild_kernel_on_1080p_session(cuda):
    """K6 equals the plain version on every coded P frame of the 1080p
    session's decode (one call a frame, C = 1)."""
    from screenpressor_tpu_torch.synth import synth_screencast

    frames = synth_screencast(1080, 1920, 64)
    cfg = CodecConfig(width=1920, height=1080)
    payloads = [p for p, _ in TorchEncoder(cfg, cuda).encode_batch(frames)]
    calls = _decode_rebuild_calls(lambda: TorchDecoder(cfg, cuda).decode_batch(payloads))
    assert len(calls) == 32
    for j, args in enumerate(calls):
        got, want, launches = _k6_vs_plain(args)
        assert launches == 1 and torch.equal(got, want), j


def test_block_rebuild_kernel_past_2_31_bytes(cuda):
    """A call of 700 streams of 1024 x 1024 (C * h * w * 3 > 2^31): slots of
    the last stream, whose byte offsets pass 2^31, give the plain version's
    pixels on that stream alone; the other streams are not written."""
    from screenpressor_tpu_torch import pframe as tp

    _, _, rects, _, pt, rl, lt = _fixture_args("types", "cpu")
    c, h, w = 700, 1024, 1024
    rng = np.random.default_rng(75)
    one_prev = torch.as_tensor(rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8), device=cuda)
    one_out = torch.as_tensor(rng.integers(0, 256, (h * w + 1, 3), dtype=np.uint8), device=cuda)
    rects = torch.cat([rects, torch.tensor([[1008, 1008, 1024, 1024], [512, 40, 520, 48]],
                                           dtype=torch.int32)]).to(cuda)
    pt, rl, lt = (torch.cat([a, a[:2]]).to(cuda) for a in (pt, rl, lt))
    want = one_out.clone()
    tp.reconstruct_blocks_streams_plain(want, one_prev, rects,
                                        torch.zeros(rects.shape[0], dtype=torch.int64,
                                                    device=cuda), pt, rl, lt)
    prev = torch.zeros((c, h, w, 3), dtype=torch.uint8, device=cuda)
    prev[-1] = one_prev[0]
    out = torch.zeros((c * h * w + 1, 3), dtype=torch.uint8, device=cuda)
    out[(c - 1) * h * w:] = one_out
    del one_prev
    sid = torch.full((rects.shape[0],), c - 1, dtype=torch.int64, device=cuda)
    n0 = _build.LAUNCHES["sptc_rebuild_blocks"]
    tp.reconstruct_blocks_streams(out, prev, rects, sid, pt, rl, lt)
    assert _build.LAUNCHES["sptc_rebuild_blocks"] - n0 == 1
    assert torch.equal(out[(c - 1) * h * w:-1], want[:-1])
    assert not bool(out[:(c - 1) * h * w].any())
    assert not torch.equal(want[:-1], one_out[:-1])


def test_block_rebuild_one_launch_no_sync(cuda, monkeypatch):
    """reconstruct_blocks_streams on the card makes no host sync (torch's
    sync debug mode set to raise) and never runs the plain row loop; a
    rebuild_p_streams call (the serving typing step, then a 1080p P frame)
    makes exactly one K6 launch, and its frames equal the CPU port's."""
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.parallel import serving as ts
    from screenpressor_tpu_torch.synth import synth_screencast

    captured = []
    real = ts.rebuild_p_streams

    def spy(recs, lay, prev, cfg_):
        captured.append((recs, lay, prev, cfg_))
        return real(recs, lay, prev, cfg_)

    steps = _serving_steps(3)
    cfg = CodecConfig(width=640, height=360, k_fixed=64, msr_x=256, msr_y=256)
    enc = ts.BatchedEncoder(64, cfg, cuda)
    payloads = [[p for p, _ in enc.encode(torch.as_tensor(f, device=cuda))] for f in steps]
    frames = synth_screencast(1080, 1920, 3)
    big = CodecConfig(width=1920, height=1080)
    single = [p for p, _ in TorchEncoder(big, cuda).encode_batch(frames)]
    with monkeypatch.context() as mp:
        mp.setattr(ts, "rebuild_p_streams", spy)
        mp.setattr(tp, "rebuild_p_streams", spy)
        dec = ts.BatchedDecoder(64, cfg, cuda)
        for step in payloads:
            dec.decode(step)
        TorchDecoder(big, cuda).decode_batch(single[:3])
    assert len(captured) == 4
    calls = _decode_rebuild_calls(lambda: [real(*a) for a in captured])

    def no_sync(fn):
        torch.cuda.synchronize()
        with monkeypatch.context() as mp:
            mp.setattr(tp, "_row_affine", None)  # the plain row loop's scan
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")

    for args in calls:
        got, want, launches = _k6_vs_plain(args, no_sync)
        assert launches == 1 and torch.equal(got, want)
    for recs, lay, prev, cfg_ in (captured[1], captured[3]):
        n0 = _build.LAUNCHES["sptc_rebuild_blocks"]
        fr, err = real(recs, lay, prev, cfg_)
        assert _build.LAUNCHES["sptc_rebuild_blocks"] - n0 == 1
        cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
        lay_cpu = type(lay)(*(cpu(f) for f in lay))
        fr_c, err_c = real({k: v.cpu() for k, v in recs.items()}, lay_cpu, prev.cpu(), cfg_)
        assert torch.equal(fr.cpu(), fr_c) and torch.equal(err.cpu(), err_c)


def test_block_rebuild_kernel_on_damaged_streams(cuda):
    """The damaged payloads of tests/test_torch_corrupt.py and the
    damaged serving steps (torch_support.damaged_serving_steps), decoded on
    the card: every rebuild call's K6 output equals the plain version's
    wherever the plain version is deterministic (pixels that at most one
    slot writes); the verdicts and clean streams' frames are held to the
    CPU port's by test_corrupt_p_frames_on_card and chip_smoke.py phase 7."""
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder

    from torch_support import (corrupt_payloads, damaged_serving_steps,  # tests/ is on the path
                               rebuild_single_writer)

    cfg, _, payloads, damaged = corrupt_payloads()
    runs = []
    for i, data in damaged:
        def one(i=i, data=data):
            dec = TorchDecoder(cfg, cuda)
            dec.decode_batch(payloads[:i])
            try:
                dec.decode_batch([data])
            except bs.CorruptStreamError:
                pass
        runs.append(one)
    s_cfg, steps, _, cases = damaged_serving_steps(cuda)
    for i, data in cases:
        def step(i=i, data=data):
            dec = BatchedDecoder(len(steps[0]), s_cfg, cuda)
            for st in steps[:i]:
                dec.decode(st)
            pays = list(steps[i])
            pays[1] = data
            try:
                dec.decode(pays)
            except bs.CorruptStreamError:
                pass
        runs.append(step)
    n_calls = 0
    for run in runs:
        for args in _decode_rebuild_calls(run):
            got, want, launches = _k6_vs_plain(args)
            keep = rebuild_single_writer(args[1], args[2], args[3])
            assert launches == 1 and torch.equal(got[keep], want[keep])
            n_calls += 1
    assert n_calls >= len(runs) // 2


# ---- K8: the P decode's block resolution (csrc/resolve.cu) ----


def _k8_vs_plain(recs, lay, cfg, check=None):
    """K8 (decode_p_resolve_streams on the card) and the plain version on
    the same inputs, on the card and on the CPU: every output and the
    error word equal bit for bit; returns (K8's outputs, err, K8's C calls).
    check: a callable run on K8's call alone (the count taken inside it)."""
    from screenpressor_tpu_torch import pframe as tp

    n0 = _build.LAUNCHES["sptc_resolve_blocks"]
    got = []
    (check or (lambda fn: fn()))(lambda: got.append(tp.decode_p_resolve_streams(recs, lay, cfg)))
    launches = _build.LAUNCHES["sptc_resolve_blocks"] - n0
    (parts, err), = got
    want, want_err = tp.decode_p_resolve_streams_plain(recs, lay, cfg)
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
    lay_c = type(lay)(*(cpu(f) for f in lay))
    want_c, want_err_c = tp.decode_p_resolve_streams_plain({k: v.cpu() for k, v in recs.items()},
                                                           lay_c, cfg)
    for j, (g, a, b) in enumerate(zip(parts, want, want_c)):
        assert g.dtype == torch.int32 and torch.equal(g, a) and torch.equal(g.cpu(), b), j
    assert torch.equal(err, want_err) and torch.equal(err.cpu(), want_err_c)
    return parts, err, launches


@pytest.mark.parametrize("name", ["chunks", "clean", "damaged", "garbage", "rebuild_damaged",
                                  "rebuild_edges", "rebuild_empty", "rebuild_motion",
                                  "rebuild_partial", "rebuild_streams", "rebuild_types",
                                  "rebuild_wrap", "streams"])
def test_resolve_kernel_matches_plain(cuda, name):
    """K8 equals the plain resolve, all six outputs and the error word, on
    the resolve fixtures: the rebuild fixtures' slots as data blocks, every
    block type, several streams, damaged and garbage streams beside clean
    ones; one C call each."""
    from torch_support import resolve_fixtures, resolve_inputs  # tests/ is on the path

    _, err, launches = _k8_vs_plain(*resolve_inputs(*resolve_fixtures()[name], device=cuda))
    assert launches == 1
    if name in ("damaged", "garbage"):
        assert not bool(err[0]) and bool(err[1:].all())


def test_resolve_kernel_on_decodes(cuda):
    """K8 equals the plain resolve on the captured rebuild calls of a 1080p
    session decode (C = 1, its coded P frames) and of a three-stream
    serving decode (C = 3), on the card."""
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder
    from screenpressor_tpu_torch.synth import synth_screencast

    from torch_support import resolve_calls  # tests/ is on the path

    frames = synth_screencast(1080, 1920, 12)
    big = CodecConfig(width=1920, height=1080)
    single = [p for p, _ in TorchEncoder(big, cuda).encode_batch(frames)]
    steps = _serving_steps(4)
    cfg = CodecConfig(width=640, height=360, k_fixed=64, msr_x=256, msr_y=256)
    enc = BatchedEncoder(3, cfg, cuda)
    served = [[p for p, _ in enc.encode(torch.as_tensor(f[:3], device=cuda))] for f in steps]
    calls = []
    with resolve_calls(calls):
        TorchDecoder(big, cuda).decode_batch(single)
        dec = BatchedDecoder(3, cfg, cuda)
        for step in served:
            dec.decode(step)
    assert len(calls) >= 6 and any(lay.hdr.shape[0] == 3 for _, lay, _ in calls)
    for recs, lay, c_ in calls:
        _, err, launches = _k8_vs_plain(recs, lay, c_)
        assert launches == 1 and not bool(err.any())


@pytest.mark.parametrize("max_run", [1, 12])
def test_resolve_kernel_on_1080p_flip(cuda, max_run):
    """K8 equals the plain resolve on a fully changed 1920x1080 frame (a
    pages flip: every block coded, data and motion, runs over all 8,160
    blocks; run lengths of 1 give about 1.4 M records, so 340 tiles)."""
    from torch_support import random_blocks, resolve_inputs, stream_sections

    rng = np.random.default_rng(31 + max_run)
    blocks = random_blocks(rng, 1080, 1920, p_types=(0.0, 0.45, 0.2, 0.25, 0.1),
                           max_run=max_run)
    recs, row = stream_sections(blocks, 8160, full_range=True)
    _, err, launches = _k8_vs_plain(*resolve_inputs([recs], [row], 1080, 1920, device=cuda))
    assert launches == 1 and not bool(err.any())


def test_resolve_kernel_on_64_streams(cuda):
    """K8 equals the plain resolve on 64 streams of 640x360 (920 blocks
    each) in one call, streams of every mix of block types, one damaged."""
    from torch_support import (DAMAGE_KINDS, _damage, random_blocks,  # tests/ is on the path
                               resolve_inputs, stream_sections)

    rng = np.random.default_rng(64)
    streams, rows = [], []
    for s in range(64):
        p = rng.dirichlet(np.ones(5))
        recs, row = stream_sections(random_blocks(rng, 360, 640, p_types=p), 920)
        if s == 17:
            _damage(rng, DAMAGE_KINDS[4], recs, row)
        streams.append(recs)
        rows.append(row)
    _, err, launches = _k8_vs_plain(*resolve_inputs(streams, rows, 360, 640, device=cuda))
    assert launches == 1 and bool(err[17]) and int(err.count_nonzero()) == 1


def test_resolve_kernel_on_damaged_streams(cuda):
    """The damaged payloads of corrupt_payloads decoded on the card, and the
    damaged serving steps (stream 1 damaged beside three clean streams):
    every rebuild call's K8 outputs and error word equal the plain
    version's bit for bit, and the clean streams' error words are 0."""
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.parallel.serving import BatchedDecoder

    from torch_support import (corrupt_payloads, damaged_serving_steps,  # tests/ is on the path
                               resolve_calls)

    cfg, _, payloads, damaged = corrupt_payloads()
    s_cfg, steps, _, cases = damaged_serving_steps(cuda)
    calls, served = [], []
    with resolve_calls(calls):
        for i, data in damaged:
            dec = TorchDecoder(cfg, cuda)
            dec.decode_batch(payloads[:i])
            try:
                dec.decode_batch([data])
            except bs.CorruptStreamError:
                pass
        n_single = len(calls)
        for i, data in cases:
            dec = BatchedDecoder(len(steps[0]), s_cfg, cuda)
            for st in steps[:i]:
                dec.decode(st)
            try:
                dec.decode([data if j == 1 else p for j, p in enumerate(steps[i])])
            except bs.CorruptStreamError:
                pass
    n_damaged = 0
    for j, (recs, lay, c_) in enumerate(calls):
        _, err, launches = _k8_vs_plain(recs, lay, c_)
        assert launches == 1
        n_damaged += bool(err.any())
        if j >= n_single and err.shape[0] == 4:
            assert not bool(err[[0, 2, 3]].any())
    assert n_damaged >= 10 and len(calls) > n_single


def test_resolve_one_call_no_sync_three_launches(cuda, monkeypatch):
    """decode_p_resolve_streams on the card makes no host sync (torch's
    sync debug mode set to raise), never runs the plain chain, and its span
    holds three kernel launches (the profiler's launch calls: K8's three
    kernels and nothing of the wrapper's), on a serving step and a 1080p
    frame."""
    from torch.profiler import ProfilerActivity, profile

    from screenpressor_tpu_torch import pframe as tp

    from torch_support import random_blocks, resolve_inputs, stream_sections

    rng = np.random.default_rng(5)
    cases = []
    for h, w, c in ((360, 640, 64), (1080, 1920, 1)):
        made = [stream_sections(random_blocks(rng, h, w), -(-w // 16) * -(-h // 16))
                for _ in range(c)]
        cases.append(resolve_inputs([m[0] for m in made], [m[1] for m in made], h, w,
                                    device=cuda))

    def no_sync(fn):
        torch.cuda.synchronize()
        with monkeypatch.context() as mp:
            mp.setattr(tp, "decode_p_resolve_streams_plain", None)
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")

    for recs, lay, cfg in cases:
        _, _, launches = _k8_vs_plain(recs, lay, cfg, no_sync)
        assert launches == 1
        tp.decode_p_resolve_streams(recs, lay, cfg)  # the allocator's blocks exist
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tp.decode_p_resolve_streams(recs, lay, cfg)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        n = sum(name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
                for name in names)
        assert n == 3, sorted(set(names))


# ---- K7: the session API's RGB32 <-> RGB24 conversion (csrc/pixels.cu) ----

K7_WIDTHS = [1, 7, 1918, 1920]


def _k7_launches():
    return _build.LAUNCHES["sptc_rgb32_to_rgb24"], _build.LAUNCHES["sptc_rgb24_to_rgb32"]


@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("w", K7_WIDTHS)
def test_k7_matches_plain(cuda, w, n):
    """K7 both ways equals the plain batch functions on the CPU, one launch
    a batch: widths with a ragged last tile, frame bases off 16 bytes
    (1918 x 5 pixels), a tile of 512 or less, and whole tiles. Each RGB24
    frame it writes is in storage of its own."""
    from screenpressor_tpu_torch import colorspace as cs

    rng = np.random.default_rng(w * 1000 + n)
    f32 = rng.integers(0, 256, (n, 5, w, 4), dtype=np.uint8)
    f24 = rng.integers(0, 256, (n, 5, w, 3), dtype=np.uint8)
    before = _k7_launches()
    got24 = cs.rgb32_to_rgb24_batch(torch.as_tensor(f32, device=cuda))
    got32 = cs.rgb24_to_rgb32_batch([torch.as_tensor(f, device=cuda) for f in f24])
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k7_launches(), before)) == (1, 1)
    want24 = cs.rgb32_to_rgb24_batch(torch.as_tensor(f32))
    for g, want in zip(got24, want24, strict=True):
        assert g.device.type == "cuda" and g.is_contiguous()
        np.testing.assert_array_equal(g.cpu().numpy(), want.numpy())
    assert len({g.data_ptr() for g in got24}) == n
    want32 = cs.rgb24_to_rgb32_batch([torch.as_tensor(f) for f in f24])
    np.testing.assert_array_equal(got32.cpu().numpy(), want32.numpy())


@pytest.mark.parametrize("n", [1, 64])
def test_k7_repeated_and_unaligned_slots(cuda, n):
    """A batch whose slots repeat one tensor (idle P frames decode to their
    previous frame), with frames that lie at an odd offset of their
    storage (the pixel-by-pixel path), at 1080p: equal to the plain
    version; and back through K7 to the same RGB24 frames."""
    from screenpressor_tpu_torch import colorspace as cs

    rng = np.random.default_rng(n)
    h, w = 1080, 1920
    base = [torch.as_tensor(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), device=cuda)
            for _ in range(3)]
    odd = torch.empty(h * w * 3 + 5, dtype=torch.uint8, device=cuda)
    odd[5:] = base[2].reshape(-1)
    base[2] = odd[5:].view(h, w, 3)
    slots = [base[min(i // 3, 2) if n > 1 else 2] for i in range(n)]
    before = _k7_launches()
    got32 = cs.rgb24_to_rgb32_batch(slots)
    back = cs.rgb32_to_rgb24_batch(got32)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k7_launches(), before)) == (1, 1)
    host = [s.cpu() for s in slots]
    np.testing.assert_array_equal(got32.cpu().numpy(), cs.rgb24_to_rgb32_batch(host).numpy())
    for b, s in zip(back, host, strict=True):
        assert torch.equal(b.cpu(), s)


def test_rgb32_session_on_card_equals_pinned_digests(cuda):
    """A 1080p RGB32 session through the session API, fed from one buffer
    that the caller refills between two 32-frame batches: without the
    keyframe's format prefix the payloads are the native codec's pinned
    bytes; the decoder gives the frames back with alpha 255, each an array
    of its own. One K7 launch a batch and direction; every frame counted on
    the card's path. Frames the caller keeps hold no page-locked memory:
    the second call's page-locked bytes are the first's (the sessions reuse
    their buffers)."""
    import hashlib

    from screenpressor_tpu_torch import Decoder, Encoder, FormatParams, PixelFormat, telemetry
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.synth import synth_screencast

    with open(os.path.join(DATA, "torch_native_1080p_64.json")) as fh:
        pinned = json.load(fh)["frames"]
    frames = synth_screencast(1080, 1920, 64)
    rng = np.random.default_rng(5)
    cfg = CodecConfig(width=1920, height=1080)
    fmt = FormatParams(PixelFormat.RGB32)
    enc, dec = Encoder(cfg, fmt, device=cuda), Decoder(cfg, device=cuda)
    buf = np.empty((32, 1080, 1920, 4), np.uint8)
    buf[..., 3] = rng.integers(0, 256, buf.shape[:3], dtype=np.uint8)
    before, counted = _k7_launches(), telemetry.counts()
    pays, outs, pinned_bytes = [], [], []
    for b in range(2):
        buf[..., :3] = frames[32 * b: 32 * (b + 1)]
        got = enc.encode_batch(list(buf))
        buf[...] = 0  # the caller's buffer is refilled before the next batch
        pays += got
        outs.append(dec.decode_batch([p for p, _ in got]))  # kept
        pinned_bytes.append(torch.cuda.host_memory_stats()["allocated_bytes.current"])
    assert pinned_bytes[1] - pinned_bytes[0] < 1080 * 1920 * 4, pinned_bytes
    assert tuple(a - b for a, b in zip(_k7_launches(), before)) == (2, 2)
    after = telemetry.counts()
    assert after.get("api.convert.device_frames", 0) - counted.get(
        "api.convert.device_frames", 0) == 128
    assert after.get("api.convert.host_frames", 0) == counted.get("api.convert.host_frames", 0)
    prefix = bs.pack_format_prefix(32)
    for i, ((p, ft), want) in enumerate(zip(pays, pinned, strict=True)):
        if ft == 0:
            assert p.startswith(prefix)
            p = p[len(prefix):]
        assert {"size": len(p), "ftype": ft, "sha256": hashlib.sha256(p).hexdigest()} == want, i
    flat = [o for call in outs for o in call]
    for i, (o, f) in enumerate(zip(flat, frames, strict=True)):
        assert isinstance(o, np.ndarray) and o.shape == (1080, 1920, 4)
        np.testing.assert_array_equal(o[..., :3], f, err_msg=f"frame {i}")
        assert (o[..., 3] == 255).all()
    assert not any(np.shares_memory(a, b) for i, a in enumerate(flat) for b in flat[i + 1:])


# -- the four-card conferencing host ---------------------------------------------

@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return [torch.device("cuda", i) for i in range(4)]


def test_split_over_four_cards_equals_one_card(four_cards):
    """The benchmark's four-card host (`spbench/configs/conf-4x64x360p.json`:
    256 streams of 640x360, kf 500 staggered over the streams, the
    `staggered` traffic rendered on cuda:0) for 12 steps through
    serve_pipelined with device_out=True, split over the four cards (one
    group of 64 a card): the unsplit one-card 256-stream session's bytes,
    every decoded frame equal to its input in one tensor on cuda:0, and
    132,710,400 bytes a step (3/4 of the frames) through each counter."""
    from spbench.generators.screen import Screen

    from screenpressor_tpu_torch import telemetry
    from screenpressor_tpu_torch.parallel.serving import (
        BatchedDecoder,
        BatchedEncoder,
        serve_pipelined,
    )

    spb = os.path.join(os.path.dirname(DATA), os.pardir, "spbench")
    with open(os.path.join(spb, "configs", "conf-4x64x360p.json")) as fh:
        conf = json.load(fh)
    with open(os.path.join(spb, "traffic", "staggered.json")) as fh:
        traffic = json.load(fh)
    s, h, w, steps = conf["streams"], conf["height"], conf["width"], 12
    cfg = CodecConfig(width=w, height=h, **conf["codec"])
    offsets = (np.arange(s) * cfg.kf_interval) // s
    screen = Screen(traffic, h, w, 2**31 + 5)
    screen.to_device(s, four_cards[0])
    frames = [screen.streams(t) for t in range(steps)]

    def run(**where):
        enc = BatchedEncoder(s, cfg, kf_offsets=offsets, **where)
        dec = BatchedDecoder(s, cfg, **where)
        before = telemetry.counts()
        pays, wrong = [], []
        for t, (outs, back) in enumerate(serve_pipelined(enc, frames, dec, device_out=True)):
            assert back.device == four_cards[0] and back.shape == (s, h, w, 3), t
            pays.append([p for p, _ in outs])
            wrong.append(int((back != frames[t]).flatten(1).any(dim=1).sum()))
        dec.validate()
        after = telemetry.counts()
        moved = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("serving.dp.scatter_bytes", "serving.dp.gather_bytes")}
        return pays, wrong, moved

    split, wrong, moved = run(devices=four_cards)
    one, wrong_one, _ = run(device=four_cards[0])
    for t in range(steps):
        assert split[t] == one[t], f"step {t}"
    assert wrong == [0] * steps and wrong_one == [0] * steps
    assert moved == {"serving.dp.scatter_bytes": steps * 132_710_400,
                     "serving.dp.gather_bytes": steps * 132_710_400}
    kinds = [p[0] & 0x0F for p in split[steps - 1] + split[2]]
    assert 2 in kinds and 3 in kinds  # keyframes among P streams
