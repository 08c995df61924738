#!/usr/bin/env python3
"""K1 (section encode), K3 (run walk), K4 (row reconstruction), the
serving session, the 1080p session, the P analysis and the P rebuild of
two checkouts of the PyTorch / CUDA port on one card, in one process tree:
before / after numbers that may stand side by side.

    python3 tools/torch_kernels_before_after.py --parent DIR [--kernels serving,rebuild]

DIR is a checkout of the commit to compare with (for example `git archive
<commit> | tar -x -C DIR`); the change is the checkout this script lies in.
Each checkout is measured in a process of its own, which builds that
checkout's kernels: parent, change, change, parent, then a copy of the
parent whose K1 returns before its rANS pack (its forward phase alone; a
checkout whose wrapper hands out the block's device timer reports its own
phases). Every run works on the same inputs, made from seeds:
  - K1 on the ten 1080p sections chip_smoke.py compares (the keyframe's rec
    and col, the five sections of the scroll P frame, the three of the
    typing P frame; of the one-step sections also the launch alone, on
    tables copied beforehand), and the colw path against full-table col on
    the keyframe's col;
  - K1 per substep on the keyframe's rec and col records dealt to 1, 8 and
    32 lanes over 600 steps;
  - K1 on the serving keyframe step (64 streams of 360x640, 64 lanes, rec
    and col in one launch), full-table col and the colw path;
  - K3 on the full 1080p keyframe, on the 64 serving keyframes padded to
    whole tiles, and on the data-block walks of the scroll and the typing P
    frame;
  - K4 on the 1080p keyframe and on the serving keyframe step (64 frames,
    and one of them alone): the kernel on its padded rows, its time a row,
    and the whole reconstruct_i (expand, pad, kernel);
  - serving: chip_smoke.py's serving session (serve_pipelined over 64
    streams of 360x640 for 5 steps, BatchedEncoder and BatchedDecoder, one
    keyframe step in each), three sessions after a warm-up one, each as
    stream-frames/s on the host clock with its peak device memory; then a
    session with the P decode's functions after K2 (undeal and rebuild)
    and the P encode's analysis and classification (per stream or
    stream-batched, whichever the checkout has) timed on the synchronised
    host clock; a session under torch.profiler (the device's busy time, its
    events, its idle share); and the decode and the encode of the
    session's steps alone, each timed and profiled.
  - session: chip_smoke.py's 1080p single-stream session (64 frames), three
    timed encodes and decodes after a warm-up, and a profiled encode.
  - analysis: the P analysis (blocks.analyze_compact_streams) of the 1080p
    batch's 63 P frames and of the serving scroll step, one call timed and
    one profiled with each stage's device ms (change map, each
    pack_pixels, K5, block types, compaction, the rest), the parent's
    flat test alone, and the 1080p session encode's peak device memory.
  - rebuild: the P rebuild (pframe.rebuild_p_streams) on the calls the
    decoders make: the 1080p session's scroll and typing frames (its first
    two coded P frames, C = 1) and the serving session's scroll and typing
    steps (64 streams), each call timed by CUDA events and by the
    synchronised host clock, with the device kernels and copies it
    launches (torch.profiler); all 32 calls of the 1080p decode in
    sequence beside the decode; the 1080p session decode's Mpix/s and the
    serving session's decode time (three runs each after a warm-up).
  - api: the session API (`Encoder` / `Decoder`) at 1080p on 64
    synth_screencast frames, host frames in and out: RGB32 (alpha seeded)
    and RGB24, each a warm-up session, then three timed sessions (a new
    Encoder and Decoder each, synchronised host clock); then a Decoder's
    three calls over the RGB32 stream whose frames the caller keeps, with
    the page-locked bytes PyTorch's host allocator holds after each.
--kernels picks the groups to run (k1, k3, k4, serving, session, analysis,
rebuild, api; default k1,k3,k4).
Kernel times are CUDA events, the mean of 5 launches after a warm-up. Prints one
JSON line per run, then a table, with the card's nvidia-smi name and power
limit. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK_MARK = "  // reverse rANS pack, one lane per thread (jx/coder.py:rans_pack)\n"
REPS = 5


def measure(root: str, kernels) -> dict:
    sys.path.insert(0, root)
    import inspect

    import numpy as np
    import torch

    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import kernels as tk
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch import recon as tr
    from screenpressor_tpu_torch.config import NUM_PTYPES, CodecConfig, seg_tile
    from screenpressor_tpu_torch.synth import synth_screencast
    from screenpressor_tpu_torch.tables import renew_tables, renew_tables_streams

    dev = torch.device("cuda")
    h, w = 1080, 1920

    def ms_of(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    def k4(label, recs, hh, ww):
        """K4 on keyframes' (records, literals): the kernel on the padded
        rows (whatever layout this checkout's pad_rows makes) and the whole
        reconstruct_i."""
        rows = [tr.pad_rows(*tr.expand_records(r, lt, hh * ww), hh, ww) for r, lt in recs]
        rows = [r if isinstance(r, tuple) else (r,) for r in rows]
        args = [torch.stack(a) for a in zip(*rows)] if len(rows) > 1 else list(rows[0])
        ms = ms_of(lambda: tr.recon_rows(*args, ww))
        out["k4"][f"{label}: kernel"] = ms
        out["k4"][f"{label}: kernel, us a row"] = 1e3 * ms / hh
        if len(recs) > 1:
            whole = ms_of(lambda: tr.reconstruct_i_streams(*zip(*recs), hh, ww))
        else:
            whole = ms_of(lambda: tr.reconstruct_i(*recs[0], hh, ww))
        out["k4"][f"{label}: reconstruct_i with expand and pad"] = whole

    out = {"k1": {}, "k1_probe": {}, "k3": {}, "k4": {}, "serving": {}, "session": {},
           "analysis": {}, "rebuild": {}, "api": {}}
    if "api" in kernels:
        api(out["api"], dev, synth_screencast)
    if "rebuild" in kernels:
        rebuild(out["rebuild"], dev, synth_screencast)
    if "analysis" in kernels:
        analysis(out["analysis"], dev, synth_screencast)
    if "serving" in kernels:
        serving(out["serving"], dev, synth_screencast)
    if "session" in kernels:
        session(out["session"], dev, synth_screencast)
    frames = synth_screencast(h, w, 3)
    cfg = CodecConfig(width=w, height=h)
    kf = torch.as_tensor(frames[0], device=dev)
    if "k4" in kernels:
        records, n_rec, lits, n_lit = tcl.classify_i(kf)
        k4("1080p keyframe", [(records[: int(n_rec)], lits[: max(int(n_lit), 1)])], h, w)
        s_h, s_w = 360, 640
        base = synth_screencast(s_h, s_w, 1, seed=3)[0]
        batch = torch.as_tensor(np.stack([np.roll(base, 3 * i, axis=1) for i in range(64)]),
                                device=dev)
        recs = [(r[: int(n)], lt[: max(int(nl), 1)])
                for r, n, lt, nl in tcl.classify_i_streams(batch)]
        k4("serving keyframe step (64 x 360x640)", recs, s_h, s_w)
        k4("one serving keyframe (360x640)", recs[:1], s_h, s_w)
    if "k1" not in kernels and "k3" not in kernels:
        return out

    # K3 on the keyframe
    fits = tcl.fits_planes_i(kf)
    st, bits = tcl.start_types_i(fits), tcl.fits_bits(fits)
    tile = seg_tile(h * w, w)
    out["k3"]["1080p keyframe"] = ms_of(lambda: tcl.run_walk(bits, st, tile))

    records, n_rec, lits, n_lit = tcl.classify_i(kf)
    sections = [("I rec", "rec", records, int(n_rec)), ("I col", "col", lits, int(n_lit))]
    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev)
    for label, i, names in (("P scroll", 1, ("bt", "sxy", "mv", "rec", "col")),
                            ("P typing", 2, ("rec", "col"))):
        cur = torch.as_tensor(frames[i], device=dev)
        prv = torch.as_tensor(frames[i - 1], device=dev)
        arrs, counts, _flat = tb.analyze_compact(cur, prv, cands, cfg)
        counts = counts.cpu().numpy()
        rects = arrs["data_rects"][: int(counts[6])]
        if hasattr(tp, "_apron"):  # a checkout before the stream-batched classification
            cw, pw = tp._windows(tp._apron(cur), rects), tp._windows(tp._apron(prv), rects)
        else:
            bsid = torch.zeros(rects.shape[0], dtype=torch.int64, device=dev)
            cw = tp._windows_streams(cur[None], rects, bsid)
            pw = tp._windows_streams(prv[None], rects, bsid)
        bfits, bst, _, _ = tp._block_fits(cw, pw, rects)
        wbits, wst = tcl.fits_bits(bfits.reshape(-1, NUM_PTYPES)), bst.reshape(-1)
        out["k3"][f"{label} data blocks ({rects.shape[0]})"] = ms_of(
            lambda: tcl.run_walk(wbits, wst, tp.AREA))
        pix, plit, pcounts = tp.classify_assemble(cur, prv, arrs["data_rects"], int(counts[6]))
        n_pix, n_plit = (int(v) for v in pcounts.cpu().numpy())
        srcs = {"bt": (arrs["bt"], int(counts[3])), "sxy": (arrs["sxy"], int(counts[4])),
                "mv": (arrs["mv"], int(counts[5])), "rec": (pix, n_pix), "col": (plit, n_plit)}
        sections += [(f"{label} {nm}", nm, *srcs[nm]) for nm in names]

    tabs = renew_tables(dev)
    with_clocks = "clocks" in inspect.signature(tk.encode_sections_streams_kernel).parameters
    for label, nm, src, n in sections:
        k = cfg.lanes(n)
        t = tc.steps_for(n, k)
        dealt, lens, kts = tc.deal(src, n, k, t), tc.lane_lens(n, k, dev), ((nm, k, t),)
        out["k1"][f"{label} (K {k}, T {t})"] = ms_of(
            lambda: tc.encode_sections([dealt], [lens], tabs, kts))
        if t == 1:  # a one-step section: the launch alone, without the tables' copy
            one = tc._one_stream(tabs, kts)
            out["k1"][f"{label} (K {k}, T {t}), the launch alone"] = ms_of(
                lambda: tk.encode_sections_streams_kernel([dealt[None]], [lens[None]], one,
                                                          kts, [0]))
        if label.startswith("I ") and with_clocks:
            clocks = []
            tk.encode_sections_streams_kernel([dealt[None]], [lens[None]],
                                              tc._one_stream(tabs, kts), kts, [0], clocks=clocks)
            t_in, t_fwd, t_end = (int(v) for v in clocks[0][0].cpu())
            out["k1"][f"{label} forward phase (device timer)"] = (t_fwd - t_in) / 1e6
            out["k1"][f"{label} pack phase (device timer)"] = (t_end - t_fwd) / 1e6
        if label == "I col":
            bm = tc.color_touched_bitmap(src, n)
            col_w = tc.col_compact_bucket(int(bm.sum()))
            out["k1"][f"I col colw{col_w} path"] = ms_of(
                lambda: tc.encode_sections([dealt], [lens], tabs, kts, col_w, bm))

    for nm, src, s_n in (("rec", records, 2), ("col", lits, 3)):
        for k in (1, 8, 32):
            t = 600
            dealt, lens, kts = tc.deal(src, k * t, k, t), tc.lane_lens(k * t, k, dev), ((nm, k, t),)
            ms = ms_of(lambda: tc.encode_sections([dealt], [lens], tabs, kts))
            out["k1_probe"][f"{nm} K {k} us/substep"] = 1e3 * ms / (t * s_n)

    # the serving keyframe step: 64 keyframes of 360x640, 64 lanes
    s_n, s_h, s_w, k = 64, 360, 640, 64
    base = synth_screencast(s_h, s_w, 1, seed=3)[0]
    batch = torch.as_tensor(np.stack([np.roll(base, 3 * i, axis=1) for i in range(s_n)]),
                            device=dev)
    wb, ws, wtile = tcl.walk_inputs_streams(batch)
    wb, ws = wb.reshape(-1), ws.reshape(-1)
    out["k3"]["64 serving keyframes"] = ms_of(lambda: tcl.run_walk(wb, ws, wtile))
    cls = tcl.classify_i_streams(batch)
    dealt_l, lens_l, kts = [], [], []
    for nm, pick in (("rec", lambda c: (c[0], int(c[1]))), ("col", lambda c: (c[2], int(c[3])))):
        pairs = [pick(c) for c in cls]
        t = max(tc.steps_for(n, k) for _, n in pairs)
        dealt_l.append(torch.stack([tc.deal(src, n, k, t) for src, n in pairs]))
        lens_l.append(torch.stack([tc.lane_lens(n, k, dev) for _, n in pairs]))
        kts.append((nm, k, t))
    kts = tuple(kts)
    bm = torch.stack([tc.color_touched_bitmap(c[2], int(c[3])) for c in cls])
    col_w = tc.col_compact_bucket(int(bm.sum(dim=1).max()))
    tabs_b = renew_tables_streams(s_n, dev)
    sidx = list(range(s_n))
    out["k1"][f"serving keyframe step (T {[t for _, _, t in kts]})"] = ms_of(
        lambda: tc.encode_sections_streams(dealt_l, lens_l, tabs_b, kts, sidx))
    out["k1"][f"serving keyframe step, colw{col_w} path"] = ms_of(
        lambda: tc.encode_sections_streams(dealt_l, lens_l, tabs_b, kts, sidx, col_w, bm))
    return out


# the P analysis's stages: functions of blocks.py, whichever the checkout has
ANALYSIS_STAGES = (("change map", "change_analysis_streams"), ("pack_pixels", "pack_pixels"),
                   ("K5", "motion_search_streams_kernel"),
                   ("K5", "analyze_blocks_streams_kernel"),
                   ("block types", "block_types_from"), ("compaction", "compact_block_records"))


def analysis(out: dict, dev, synth_screencast):
    """The P analysis (blocks.analyze_compact_streams) of the 1080p batch's
    63 P frames (two tensors, as encode_batch stacks them) and of the
    serving scroll step's P streams (chip_smoke.py's inputs): one call's
    time (CUDA events, the mean of REPS calls after a warm-up), then one
    call under torch.profiler with each stage (a function of blocks.py:
    ANALYSIS_STAGES) wrapped in a record_function range, each stage's
    device ms (torch_support.stage_ms); "other" is the call's device time
    outside them (the flat test, the candidate gather). Then the parent's
    flat expression alone on the same frames, and the 1080p session's
    encode (TorchEncoder.encode_batch) with its peak device memory."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import stage_ms  # would shadow ROOT/tests

    from screenpressor_tpu_torch import TorchEncoder
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch.config import CodecConfig

    h, w = 1080, 1920
    frames = synth_screencast(h, w, 64)
    dev_frames = torch.as_tensor(np.stack(frames), device=dev)
    n, s_h, s_w, kf = 64, 360, 640, 150
    base = synth_screencast(s_h, s_w, 2, seed=3)
    steps = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(n)]),
                             device=dev) for t in range(2)]
    own = torch.as_tensor(np.nonzero((1 + (np.arange(n) * kf) // n) % kf != 0)[0], device=dev)
    inputs = (
        ("1080p batch (63 P frames)", dev_frames[1:].clone(), dev_frames[:-1].clone(),
         CodecConfig(width=w, height=h)),
        (f"serving scroll step ({own.numel()} P streams)", steps[1][own], steps[0][own],
         CodecConfig(width=s_w, height=s_h, kf_interval=kf, k_fixed=64, msr_x=256, msr_y=256)),
    )
    for label, fr, pv, cfg in inputs:
        cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev).reshape(-1, 2)
        call = lambda: tb.analyze_compact_streams(fr, pv, cands, cfg)  # noqa: E731
        call()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            call()
        b.record()
        torch.cuda.synchronize()
        out[f"{label}: one call ms"] = a.elapsed_time(b) / REPS

        real, seen = {}, {}
        for stage, fn in ANALYSIS_STAGES:
            if hasattr(tb, fn):
                real[fn] = getattr(tb, fn)

                def wrapped(*args, _fn=fn, _stage=stage, **kw):
                    seen[_stage] = seen.get(_stage, 0) + 1
                    tag = f"{_stage} {seen[_stage]}" if _stage == "pack_pixels" else _stage
                    with record_function(f"ana {tag}"):
                        return real[_fn](*args, **kw)
                setattr(tb, fn, wrapped)

        def whole():
            with record_function("ana whole"):
                call()
        try:
            _, ms = stage_ms(whole, "ana ")
        finally:
            for fn, f in real.items():
                setattr(tb, fn, f)
        total = ms.pop("whole")
        for stage, v in ms.items():
            out[f"{label}: device ms, {stage}"] = v
        out[f"{label}: device ms, other"] = total - sum(ms.values())
        out[f"{label}: device ms, whole call"] = total

        c0 = fr[:, 0, 0]

        def flat():
            with record_function("ana flat"):
                (fr == c0[:, None, None]).reshape(fr.shape[0], -1).all(dim=1)
        out[f"{label}: device ms, the parent's flat test alone"] = (
            stage_ms(flat, "ana ")[1]["flat"])

    cfg = CodecConfig(width=w, height=h)
    TorchEncoder(cfg, dev).encode_batch(frames)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    TorchEncoder(cfg, dev).encode_batch(frames)
    torch.cuda.synchronize()
    out["1080p session encode: peak device memory MiB"] = (
        torch.cuda.max_memory_allocated() - held) / 2**20


def rebuild(out: dict, dev, synth_screencast):
    """The P rebuild (pframe.rebuild_p_streams) on the calls the 1080p
    session decode and the serving decode make: the first two coded P
    frames of the 1080p batch (scroll, typing) and the serving session's
    scroll and typing steps, each call's time (CUDA events, the mean of
    REPS calls after a warm-up; the synchronised host clock, the same) and
    the device kernels and copies it launches (torch.profiler); the 1080p
    decode's 32 calls in sequence; the 1080p session decode's Mpix/s and
    the serving decode's time, three runs each after a warm-up."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.parallel import serving as ts

    def captured(run):
        calls = []
        real = tp.rebuild_p_streams

        def spy(recs, lay, prev, cfg):
            calls.append((recs, lay, prev.clone(), cfg))
            return real(recs, lay, prev, cfg)

        tp.rebuild_p_streams = ts.rebuild_p_streams = spy
        try:
            run()
        finally:
            tp.rebuild_p_streams = ts.rebuild_p_streams = real
        torch.cuda.synchronize()
        return calls

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def one_call(label, args):
        call = lambda: tp.rebuild_p_streams(*args)  # noqa: E731
        call()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            call()
        b.record()
        torch.cuda.synchronize()
        out[f"{label}: rebuild_p_streams ms (CUDA events)"] = a.elapsed_time(b) / REPS
        out[f"{label}: rebuild_p_streams ms (host, synchronised)"] = (
            1e3 * host_s(lambda: [call() for _ in range(REPS)]) / REPS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        dev_events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = sum(nm.startswith(("Memcpy", "Memset")) for nm in dev_events)
        out[f"{label}: device kernels launched a call"] = len(dev_events) - copies
        out[f"{label}: device copies and sets a call"] = copies

    h, w = 1080, 1920
    cfg = CodecConfig(width=w, height=h)
    frames = synth_screencast(h, w, 64)
    payloads = [p for p, _ in TorchEncoder(cfg, dev).encode_batch(frames)]
    decode = lambda: TorchDecoder(cfg, dev).decode_batch(payloads, device_out=True)  # noqa: E731
    calls = captured(decode)
    one_call("1080p frame 1 (scroll)", calls[0])
    one_call("1080p frame 2 (typing)", calls[1])
    out[f"1080p decode's {len(calls)} rebuild_p_streams calls in sequence, ms (host, "
        "synchronised)"] = 1e3 * host_s(lambda: [tp.rebuild_p_streams(*c) for c in calls])
    del calls
    decode()
    for r in range(1, 4):
        dt = host_s(decode)
        out[f"1080p session decode {r}, s"] = dt
        out[f"1080p session decode {r}, Mpix/s"] = h * w * len(frames) / 1e6 / dt

    n, s_h, s_w, kf, steps = 64, 360, 640, 150, 5
    s_cfg = CodecConfig(width=s_w, height=s_h, kf_interval=kf, k_fixed=64, msr_x=256,
                        msr_y=256)
    offsets = (np.arange(n) * kf) // n
    base = synth_screencast(s_h, s_w, steps, seed=3)
    batches = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(n)]),
                               device=dev) for t in range(steps)]
    enc = ts.BatchedEncoder(n, s_cfg, dev, kf_offsets=offsets)
    s_payloads = [[p for p, _ in enc.encode(f)] for f in batches]
    del enc

    def serve_decode():
        dec = ts.BatchedDecoder(n, s_cfg, dev)
        for step in s_payloads:
            dec.decode(step, device_out=True)
        dec.validate()

    calls = captured(serve_decode)
    one_call("serving scroll step", calls[0])
    one_call("serving typing step", calls[1])
    del calls
    serve_decode()
    for r in range(1, 4):
        out[f"serving session decode {r} (5 steps), ms"] = 1e3 * host_s(serve_decode)


def serving(out: dict, dev, synth_screencast):
    """chip_smoke.py's serving session: a warm-up and three timed sessions,
    one with the P decode's and the P encode's functions timed, one
    profiled, and the decode and the encode alone."""
    import time

    import numpy as np
    import torch

    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.parallel import serving as ts

    n, s_h, s_w, kf, steps = 64, 360, 640, 150, 5
    cfg = CodecConfig(width=s_w, height=s_h, kf_interval=kf, k_fixed=64, msr_x=256, msr_y=256)
    offsets = (np.arange(n) * kf) // n
    base = synth_screencast(s_h, s_w, steps, seed=3)
    batches = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(n)]),
                               device=dev) for t in range(steps)]

    def session():
        enc = ts.BatchedEncoder(n, cfg, dev, kf_offsets=offsets)
        dec = ts.BatchedDecoder(n, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(ts.serve_pipelined(enc, batches, dec))
        dec.validate()
        torch.cuda.synchronize()
        if not all(torch.equal(back, f) for (_, back), f in zip(got, batches)):
            raise AssertionError("serving session not lossless")
        return time.perf_counter() - t0, [[p for p, _ in outs] for outs, _ in got]

    walls = []
    for r in range(4):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dt, payloads = session()
        if r:
            walls.append(dt)
            out[f"session {r}, stream-frames/s"] = n * steps / dt
            out[f"session {r}, peak device memory MiB"] = (
                torch.cuda.max_memory_allocated() - held) / 2**20

    # the P decode's functions after K2 and the P encode's analysis and
    # classification on the synchronised host clock: the stream-batched
    # ones where this checkout has them, else the per-stream
    dec_names = [nm for nm in ("undeal_sections", "rebuild_p", "undeal_sections_streams",
                               "rebuild_p_streams") if hasattr(ts, nm)]
    enc_names = [nm for nm in ("analyze_compact", "classify_assemble",
                               "analyze_compact_streams", "classify_assemble_streams")
                 if hasattr(ts, nm)]
    names = dec_names + enc_names
    spent = {nm: [0.0, 0] for nm in names}

    def timed(nm, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[nm][0] += time.perf_counter() - t0
            spent[nm][1] += 1
            return res
        return run

    real = {nm: getattr(ts, nm) for nm in names}
    for nm in names:
        setattr(ts, nm, timed(nm, real[nm]))
    try:
        dt, _ = session()
    finally:
        for nm in names:
            setattr(ts, nm, real[nm])
    out["timed session, s"] = dt
    for nm, (sec, calls) in spent.items():
        out[f"timed session: {nm}, ms ({calls} calls)"] = 1e3 * sec
    for tag, group in (("P decode after K2", dec_names),
                       ("P encode analysis and classification", enc_names)):
        out[f"timed session: {tag}, share of the session"] = (
            sum(spent[nm][0] for nm in group) / dt)

    # the device's busy time and launches under torch.profiler: a session,
    # then the decode of its steps alone
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def busy(prof):
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        total, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e3, len(spans)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, _ = session()
    ms, n_dev = busy(prof)
    out["profiled session: device busy ms"] = ms
    out["profiled session: device events"] = n_dev
    out["profiled session: idle share of its wall"] = 1 - ms / (1e3 * dt)
    out["profiled session: idle share of the timed sessions' median wall"] = (
        1 - ms / (1e3 * float(np.median(walls))))

    def decode_all():
        dec = ts.BatchedDecoder(n, cfg, dev)
        for step in payloads:
            dec.decode(step, device_out=True)
        dec.validate()

    def encode_all():
        enc = ts.BatchedEncoder(n, cfg, dev, kf_offsets=offsets)
        for frames in batches:
            enc.encode(frames)

    for tag, fn in (("decode", decode_all), ("encode", encode_all)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[f"{tag} of the session's 5 steps alone, ms"] = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms, n_dev = busy(prof)
        out[f"{tag} alone, profiled: device busy ms"] = ms
        out[f"{tag} alone, profiled: device events"] = n_dev


def session(out: dict, dev, synth_screencast):
    """chip_smoke.py's 1080p single-stream session (64 synth_screencast
    frames, host frames in): a warm-up, three timed encodes and decodes
    (new sessions each, synchronised host clock), then an encode under
    torch.profiler (the device's busy time and idle share)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
    from screenpressor_tpu_torch.config import CodecConfig

    h, w, n = 1080, 1920, 64
    frames = synth_screencast(h, w, n)
    cfg = CodecConfig(width=w, height=h)
    mpix = h * w * n / 1e6

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    def encode():
        return TorchEncoder(cfg, dev).encode_batch(frames)

    _, payloads = timed(encode)
    payloads = [p for p, _ in payloads]
    timed(lambda: TorchDecoder(cfg, dev).decode_batch(payloads))
    for r in range(1, 4):
        out[f"session {r}, encode Mpix/s"] = mpix / timed(encode)[0]
        out[f"session {r}, decode Mpix/s"] = mpix / timed(
            lambda: TorchDecoder(cfg, dev).decode_batch(payloads))[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, _ = timed(encode)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    out["profiled encode: device busy ms"] = busy / 1e3
    out["profiled encode: device events"] = len(spans)
    out["profiled encode: idle share of its wall"] = 1 - busy / 1e6 / dt


def api(out: dict, dev, synth_screencast):
    """The session API's host frames: see the module docstring's `api`."""
    import time

    import numpy as np
    import torch

    from screenpressor_tpu_torch import Decoder, Encoder, FormatParams, PixelFormat
    from screenpressor_tpu_torch.config import CodecConfig

    h, w, n = 1080, 1920, 64
    frames = synth_screencast(h, w, n)
    rng = np.random.default_rng(8)
    f32 = [np.dstack([f, rng.integers(0, 256, (h, w), dtype=np.uint8)]) for f in frames]
    cfg = CodecConfig(width=w, height=h)
    mpix = h * w * n / 1e6

    def timed(fn, arg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(arg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    for tag, fmt, src in (("RGB32", FormatParams(PixelFormat.RGB32), f32),
                          ("RGB24", FormatParams(), frames)):
        for r in range(4):  # 0: the warm-up
            te, pays = timed(Encoder(cfg, fmt, device=dev).encode_batch, src)
            td, _ = timed(Decoder(cfg, device=dev).decode_batch, [p for p, _ in pays])
            if r:
                out[f"{tag} session {r}, encode Mpix/s"] = mpix / te
                out[f"{tag} session {r}, decode Mpix/s"] = mpix / td
        if tag == "RGB32":
            stream = [p for p, _ in pays]
    dec, kept = Decoder(cfg, device=dev), []
    for c, part in enumerate((stream[:21], stream[21:42], stream[42:]), 1):
        kept.append(dec.decode_batch(part))
        held = torch.cuda.host_memory_stats().get("allocated_bytes.current", -1)
        out[f"RGB32 decode, frames kept: page-locked MB after call {c}"] = held / 1e6


def forward_only_copy(parent: str) -> str:
    """A copy of the parent whose K1 returns before its pack."""
    dst = parent.rstrip("/") + "_k1_forward_only"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(parent, dst, ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(dst, "screenpressor_tpu_torch", "csrc", "sections.cu")
    with open(path) as fh:
        src = fh.read()
    if PACK_MARK not in src:
        return ""
    with open(path, "w") as fh:
        fh.write(src.replace(PACK_MARK, "  return;\n" + PACK_MARK))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare with")
    ap.add_argument("--kernels", default="k1,k3,k4", help="groups to run, comma-separated")
    ap.add_argument("--measure", help="(internal) measure this checkout, print one JSON line")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if args.measure:
        print(json.dumps(measure(args.measure, kernels)))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parent = os.path.abspath(args.parent)
    runs = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    fwd = forward_only_copy(parent) if "k1" in kernels else ""
    if fwd:
        runs.append(("parent, K1 forward phase only", fwd))
    results = []
    for tag, root in runs:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                               "--kernels", args.kernels], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append((tag, res))
        print(json.dumps({"run": tag, "card": smi, **res}), flush=True)
    print(f"\nms (us or stream-frames/s where the name says so) on {smi}; columns: "
          + " | ".join(tag for tag, _ in results))
    for group in ("k1", "k1_probe", "k3", "k4", "serving", "session", "analysis", "rebuild",
                  "api"):
        names = []
        for _, res in results:
            names += [nm for nm in res[group] if nm not in names]
        for nm in names:
            cells = [f"{res[group][nm]:.3f}" if nm in res[group] else "-" for _, res in results]
            print(f"{group} {nm}: " + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
