"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions, on
the card. Skips where there is no CUDA device.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from screenpressor_tpu.config import CodecConfig, lane_count, seg_tile
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder, _build
from screenpressor_tpu_torch import classify as tcl
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import kernels as tk
from screenpressor_tpu_torch import recon as tr
from screenpressor_tpu_torch.tables import renew_tables

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
    bufs, starts, tab_k = tk.encode_sections_kernel([dealt], [lens], tabs, kts)
    lens_np = lens.cpu().numpy()
    blobs_p = tc.blobs_from_buf(buf_p.cpu().numpy(), start_p.cpu().numpy(), lens_np)
    blobs_k = tc.blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(), lens_np)
    assert blobs_k == blobs_p
    _assert_tables_equal(tab_k, tab_p)

    pay = torch.as_tensor(tc.pad_payload(blobs_k, k), device=cuda)
    rec_p, dtab_p = tc.decode_section_scan(pay, lens, tabs, name, t)
    recs, dtab_k = tk.decode_sections_kernel([pay], [lens], tabs, kts)
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
    b1, s1, t1 = tk.encode_sections_kernel(dealt, lens_l, renew_tables(cuda), tuple(kts))
    tabs = renew_tables(cuda)
    for i in range(5):
        b, s, tabs = tk.encode_sections_kernel([dealt[i]], [lens_l[i]], tabs, (kts[i],))
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
    got = tr.recon_rows(*rows, w)
    assert torch.equal(got, tr.recon_rows_plain(*rows, w))
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
    assert all(v > 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
