#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (screenpressor_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. the card (torch and nvidia-smi);
  2. the kernel build (nvcc, sm_90a) from screenpressor_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the main path's 1080p
     shapes (the synth_screencast keyframe and a scroll P frame), exact
     equality of bytes, records and table state, both times from CUDA
     events;
  4. the main path: TorchEncoder.encode_batch on the 64-frame 1080p
     synth_screencast batch, then TorchDecoder.decode_batch, run twice (new
     sessions each time); the second run's kernel launches are counted and
     every kernel must appear. Its bytes are held against the native C++
     SPTC codec (screenpressor_tpu.native) and its decode must be lossless.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure raises (non-zero exit, no
result line). Needs a CUDA device; imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, N_FRAMES = 1080, 1920, 64
NATIVE_BUDGET_S = 240.0  # native encode time spent comparing bytes (>= 8 frames)
TIMED_REPS = 5


def phase(name, t0):
    print(f"[{time.perf_counter() - t0:8.2f} s] {name}", flush=True)


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds per call of fn from CUDA events, and its result."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_abs_err(pairs):
    err = 0
    for a, b in pairs:
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} != {b.shape}")
        if a.size:
            err = max(err, int(np.abs(a - b).max()))
    return err


def tables_pairs(a, b):
    return [(a[kd][key].cpu().numpy(), b[kd][key].cpu().numpy())
            for kd in b for key in b[kd]]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bench import synth_screencast
    from screenpressor_tpu.config import CodecConfig, seg_tile
    from screenpressor_tpu.native import NativeEncoder
    from screenpressor_tpu_torch import TorchDecoder, TorchEncoder, _build
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import kernels as tk
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch import recon as tr
    from screenpressor_tpu_torch.tables import renew_tables

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase("card", t0)

    # ---- 2. the kernel build ----
    tb0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - tb0:.2f} s")
    phase("build", t0)

    # ---- 3. kernels vs plain at the main path's shapes ----
    frames = synth_screencast(H, W, N_FRAMES)
    cfg = CodecConfig(width=W, height=H)
    kf = torch.as_tensor(frames[0], device=dev)
    rows = {}  # kernel -> {"ms": , "plain_ms": , "err": }

    def record(kernel, ms, plain_ms, err):
        r = rows.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0, "err": 0})
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["err"] = max(r["err"], err)
        if err:
            raise AssertionError(f"{kernel}: kernel differs from plain (max |err| {err})")

    # K3 on the keyframe's fits
    fits = tcl.fits_planes_i(kf)
    st = tcl.start_types_i(fits)
    bits = tcl.fits_bits(fits)
    tile = seg_tile(H * W, W)
    ms, got = cuda_ms(lambda: tcl.run_walk(bits, st, tile), TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: tcl.run_walk_plain(bits, st, tile), 1, False)
    err = max_abs_err([(got.cpu().numpy(), ref.cpu().numpy())])
    record("sptc_run_walk", ms, plain_ms, err)
    print(f"K3 run walk n={H * W} tile={tile}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal")

    # K4 on the keyframe's records
    records, n_rec, lits, n_lit = tcl.classify_i(kf)
    n_rec, n_lit = int(n_rec), int(n_lit)
    pt_pix, lit_pix = tr.expand_records(records[:n_rec], lits[:max(n_lit, 1)], H * W)
    pt_rows, lit_rows = tr.pad_rows(pt_pix, lit_pix, H, W)
    ms, got = cuda_ms(lambda: tr.recon_rows(pt_rows, lit_rows, W), TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: tr.recon_rows_plain(pt_rows, lit_rows, W), 1, False)
    err = max_abs_err([(got.cpu().numpy(), ref.cpu().numpy()),
                       (got.cpu().numpy(), frames[0])])
    record("sptc_recon_rows", ms, plain_ms, err)
    print(f"K4 recon {H}x{W} (Wp={pt_rows.shape[1]}): kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, equal, equals the keyframe")

    # K1 / K2 on the keyframe's rec and col, the five sections of a scroll
    # frame (frame 1) and the data-block sections of a typing frame (frame 2)
    sections = []
    for nm, src, n in (("rec", records, n_rec), ("col", lits, n_lit)):
        sections.append(("I " + nm, nm, src, n))
    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev)
    for label, i, names in (("P scroll", 1, ("bt", "sxy", "mv", "rec", "col")),
                            ("P typing", 2, ("rec", "col"))):
        cur = torch.as_tensor(frames[i], device=dev)
        prv = torch.as_tensor(frames[i - 1], device=dev)
        arrs, counts, _flat = tb.analyze_compact(cur, prv, cands, cfg)
        counts = counts.cpu().numpy()
        pix, plit, pcounts = tp.classify_assemble(cur, prv, arrs["data_rects"],
                                                  int(counts[6]))
        n_pix, n_plit = (int(v) for v in pcounts.cpu().numpy())
        srcs = {"bt": (arrs["bt"], int(counts[3])), "sxy": (arrs["sxy"], int(counts[4])),
                "mv": (arrs["mv"], int(counts[5])), "rec": (pix, n_pix),
                "col": (plit, n_plit)}
        for nm in names:
            sections.append((f"{label} {nm}", nm, *srcs[nm]))
    tabs = renew_tables(dev)
    for label, nm, src, n in sections:
        k = cfg.lanes(n)
        t = tc.steps_for(n, k)
        dealt = tc.deal(src, n, k, t)
        lens = tc.lane_lens(n, k, dev)
        kts = ((nm, k, t),)
        ms, (bufs, starts, tab_k) = cuda_ms(
            lambda: tk.encode_sections_kernel([dealt], [lens], tabs, kts), TIMED_REPS)

        def plain_encode():
            cum, freq, act, tab = tc.model_scan(dealt, lens, tabs, nm)
            return tc.rans_pack(cum, freq, act, tc.pack_cap(nm, t)), tab

        plain_ms, ((buf_p, start_p), tab_p) = cuda_ms(plain_encode, 1, False)
        lens_np = lens.cpu().numpy()
        blobs = tc.blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(), lens_np)
        blobs_p = tc.blobs_from_buf(buf_p.cpu().numpy(), start_p.cpu().numpy(), lens_np)
        err = max_abs_err([(np.frombuffer(b"".join(blobs), np.uint8),
                            np.frombuffer(b"".join(blobs_p), np.uint8)),
                           (starts[0].cpu().numpy(), start_p.cpu().numpy())]
                          + tables_pairs(tab_k, tab_p))
        if [len(b) for b in blobs] != [len(b) for b in blobs_p]:
            raise AssertionError(f"K1 {label}: lane sizes differ")
        record("sptc_sections_encode", ms, plain_ms, err)

        pay = torch.as_tensor(tc.pad_payload(blobs, k), device=dev)
        dms, (recs, dtab_k) = cuda_ms(
            lambda: tk.decode_sections_kernel([pay], [lens], tabs, kts), TIMED_REPS)
        dplain_ms, (rec_p, dtab_p) = cuda_ms(
            lambda: tc.decode_section_scan(pay, lens, tabs, nm, t), 1, False)
        derr = max_abs_err([(recs[0].cpu().numpy(), rec_p.cpu().numpy()),
                            (tc.undeal(recs[0], n, k, max(n, 1))[:n].cpu().numpy(),
                             src[:n].cpu().numpy())]
                           + tables_pairs(dtab_k, dtab_p) + tables_pairs(dtab_k, tab_k))
        record("sptc_sections_decode", dms, dplain_ms, derr)
        print(f"K1/K2 {label}: n={n} k={k} t={t} bytes={sum(map(len, blobs))}: "
              f"encode {ms:.3f} ms (plain {plain_ms:.1f} ms), decode {dms:.3f} ms "
              f"(plain {dplain_ms:.1f} ms), bytes, records and tables equal")
    phase("kernels vs plain", t0)

    # ---- 4. the main path: a first session, then the counted one ----
    def session():
        torch.cuda.synchronize()
        te = time.perf_counter()
        payloads = TorchEncoder(cfg, dev).encode_batch(frames)
        torch.cuda.synchronize()
        td = time.perf_counter()
        decoded = TorchDecoder(cfg, dev).decode_batch([p for p, _ in payloads],
                                                      device_out=True)
        torch.cuda.synchronize()
        return payloads, decoded, td - te, time.perf_counter() - td

    _, _, t_enc0, t_dec0 = session()
    _build.reset_counts()
    payloads, decoded, t_enc, t_dec = session()
    launches = dict(_build.LAUNCHES)
    print(f"main path launches: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    phase("main path", t0)

    for i, (f, o) in enumerate(zip(frames, decoded)):
        if not torch.equal(o, torch.as_tensor(f, device=dev)):
            raise AssertionError(f"frame {i}: decode is not lossless")
    sizes = [len(p) for p, _ in payloads]
    print(f"decoded all {len(frames)} frames losslessly; bytes per frame: {sizes}")

    native = NativeEncoder(cfg)
    tn = time.perf_counter()
    compared = 0
    for i, (f, (p, ft)) in enumerate(zip(frames, payloads)):
        nb, nft = native.encode(f)
        if nb != p or nft != ft:
            raise AssertionError(f"frame {i}: port bytes ({len(p)}) != native ({len(nb)})")
        compared += 1
        if compared >= 8 and time.perf_counter() - tn > NATIVE_BUDGET_S:
            break
    print(f"port bytes equal native SPTC bytes on {compared} of {len(frames)} frames "
          f"({time.perf_counter() - tn:.1f} s native)")
    phase("native comparison", t0)

    mpix = H * W * len(frames) / 1e6
    for tag, te_, td_ in (("first session", t_enc0, t_dec0),
                          ("second session", t_enc, t_dec)):
        print(f"{tag}: encode {mpix / te_:.3f} Mpix/s ({te_:.3f} s), decode "
              f"{mpix / td_:.3f} Mpix/s ({td_:.3f} s) for {len(frames)} frames "
              f"at {W}x{H} on {smi}")

    sources = {
        "sptc_sections_encode": ("screenpressor_tpu_torch/csrc/sections.cu",
                                 "screenpressor_tpu/jx/kernels.py:1016"),
        "sptc_sections_decode": ("screenpressor_tpu_torch/csrc/sections.cu",
                                 "screenpressor_tpu/jx/kernels.py:577"),
        "sptc_run_walk": ("screenpressor_tpu_torch/csrc/run_walk.cu",
                          "screenpressor_tpu/jx/classify.py:142"),
        "sptc_recon_rows": ("screenpressor_tpu_torch/csrc/recon.cu",
                            "screenpressor_tpu/jx/recon.py:143"),
    }
    kernels = [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[kname], "max_abs_err": rows[kname]["err"],
         "ms": round(rows[kname]["ms"], 4), "plain_ms": round(rows[kname]["plain_ms"], 4)}
        for kname, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
