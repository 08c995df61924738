#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (screenpressor_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. the card (torch and nvidia-smi);
  2. the kernel build (nvcc, sm_90a) from screenpressor_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the main path's 1080p
     shapes (the synth_screencast keyframe, a scroll and a typing P frame),
     exact equality of bytes, records and table state, both times from
     CUDA events; K1-colw, on each of those col sections whose touched rows
     fit a compact bucket (as the session takes it), also against full-table
     K1 col; K1's forward (modeling) and pack phases apart on the keyframe's
     rec and col (the device's nanosecond timer read inside the block); K3
     on the data-block walks of the scroll and the typing P frame (one
     256-position tile a block); then K1's and K2's time per substep on the
     keyframe's rec and col records dealt to 1, 8 and 32 lanes over 600
     steps (the chain's latency at one lane, and what 32 lanes' warps add);
  4. the single-stream main path: TorchEncoder.encode_batch on the
     64-frame 1080p synth_screencast batch, then TorchDecoder.decode_batch,
     run twice (new sessions each time); the second run's kernel launches
     are counted and every kernel it runs must appear. All 64 frames'
     sizes, types and SHA-256 digests must equal the native C++ SPTC
     codec's, pinned in tests/data/torch_native_1080p_64.json, and its
     decode must be lossless;
  5. the stream-batched kernels against their plain versions at the
     serving shapes (64 streams of 360x640, k_fixed 64): K1 and K2 over the
     sections of the keyframe step and of the scroll and the typing P steps,
     K1-colw against full-table K1 col on the typing step's and the
     keyframe step's color sections and on sections that touch color row
     12287, K3 and K4 over the keyframe step's 64 frames (K4 also on one of
     them alone: its latency a row at a batch of one);
  6. the serving main path: serve_pipelined(BatchedEncoder,
     BatchedDecoder) over 5 steps of 64 staggered-keyframe streams (the
     fourth step keyframes stream 63), run twice in new sessions, the
     second counted: every serving kernel must appear, decode must be
     lossless, each stream's bytes must equal its own TorchEncoder session,
     and the pinned procedural_serving_kfixed golden must reproduce;
  6b. the serving P rebuild: on the inputs BatchedDecoder hands
     pframe.rebuild_p_streams on the scroll and the typing step (one call
     over every coded P stream), that call against pframe.rebuild_p stream
     by stream, both timed by CUDA events and by the synchronised host
     clock; frames and error words must be equal; K6 (the data-block
     rebuild, one launch a call) against its plain version on each step's
     call, K6 timed as its device time from a CUDA graph of its launches;
     K8 (the block resolution, one C call of three kernels a call) against
     its plain version on both steps' calls, timed the same way, with the
     wrapper's and the plain version's synchronised host time; then the
     1080p session's decode with each of its 32 rebuild_p_streams calls
     captured: K6 and K8 against plain on every one, the scroll and the
     typing frame's call timed, and all of them in sequence beside the
     session's decode time;
  6c. the serving P encode front half: on each P step of the serving
     session, one blocks.analyze_compact_streams call over the step's P
     streams, the pull of their counts and one
     pframe.classify_assemble_streams call over their data blocks (as
     BatchedEncoder runs them), against analyze_compact and
     classify_assemble stream by stream; both timed by CUDA events and by
     the synchronised host clock, with their host syncs counted (torch's
     sync debug mode; the analysis alone makes none); counts, records and
     classification must be equal; K5 (the analysis's block front end:
     change map, sub-rects, flat flags, motion search) against its plain
     version on each step's inputs; then the 1080p batch's 63 P frames in
     one analyze_compact_streams call (as encode_batch makes it; its ms
     printed) against analyze_compact frame by frame, K5 against plain on
     them, and K5 on a noise frame against a noise prev (every candidate
     of every block tested) at 1080p (plain on its first block row, a row
     range) and at 360x640 (plain on all of it);
  7. damaged streams: one-byte corruptions and truncations of a 48x64
     stream decode on the card to the CPU port's verdicts, and a clean
     stream decodes after them in the same process; then the serving
     fixture of tests/test_torch_serving_decode.py: one damaged stream of 4
     in a BatchedDecoder step, whose verdict (the error's message) must be
     the CPU port's and whose clean streams' frames must equal their clean
     decode;
  8. the session API (Encoder / Decoder) at 1080p, counted from a reset:
     the 64 frames as RGB32 with a seeded alpha, encoded from host frames
     and from device frames (equal bytes; every keyframe starts with the
     RGB32 format prefix, and without it all 64 frames equal the pinned
     native digests), decoded by a default (RGB24) Decoder that configures
     itself to RGB32 (lossless, alpha 255); then as RGB16 565 frames (each
     channel cut to its mask), device and host frames again, whose bytes
     must equal TorchEncoder's over the port's numpy rgb16_to_rgb24 (with
     the prefix on keyframes), decoded back to the uint16 frames. Every
     single-stream kernel must appear in the phase's launch counts, K7
     once a RGB32 batch and direction; its Mpix/s print beside phase 4's
     RGB24 session, then (not counted) the host numpy and the card's torch
     conversions over the 64 frames, K7 both ways over them against its
     bound, and an RGB24 API session with host frames in and out;
  9. the sp mesh (screenpressor_tpu_torch.parallel.mesh) with its shards
     on the one card (devices=[cuda] * sp, printed as such): the 8-frame
     4K synth_screencast session through encode_i_sp / encode_p_sp at sp
     1, 2 and 4 and back through decode_i_sp / decode_p_sp, counted from a
     reset (K1-K6 must all appear), each equal to the unsharded
     TorchEncoder session on the card and to the native digests pinned in
     tests/data/torch_native_4k_8.json, every decode lossless, the Mpix/s
     beside the unsharded session's; then, not counted, the device time
     of each stage (the mesh's "sp ..." ranges under torch.profiler); K3
     on a 4K shard's walk, K1 / K2 on the 4K keyframe's rec and col
     sections (as the sp path deals them), K4 on the 4K keyframe, K5 on
     the counted run's first shard analysis (a row range of the full
     frames) and K6 on every block rebuild of that run against their
     plain versions;
     the 64-frame 1080p session at sp 2 (uneven I seams) against the
     pinned 1080p digests; dryrun_step
     on 64 streams of 360x640 at dp 2 x sp 2, each stream's lanes,
     n_records and tables equal to device_encode_step alone;
 10. window serving (screenpressor_tpu_torch.parallel.serve_scan): the
     serving profile over 1 + 16 steps (synth_screencast(360, 640, 17,
     seed=3), stream i rolled 3i columns: a per-step keyframe step, then
     two windows of F 8) through serve_windowed at the WindowConfig
     defaults and through serve_pipelined, 3 runs each in turns (times,
     peak memory); every stream-step of the window RAW by a cause of the
     capacity rule (counted by cause) or equal to serve_pipelined's bytes,
     decode lossless; the window path counted from a reset (K1-K6 must all
     appear), its first K1 and K2 launch over the streams, its walks, its
     K4 launch, its first K5 launch and every K6 launch against their
     plain versions;
     the window at capacities that hold every stream-step equal to
     serve_pipelined everywhere; a window's begin and finish with their
     host syncs counted; then
     the single-stream window (bench.py:167-222, k_fixed 32) on 17 1080p
     frames against the sequential session (bytes, decode_window, Mpix/s);
 11. the dp split: the serving session (phase 6's 5 steps) through
     serve_pipelined with its streams split over 2 and 4 groups on the one
     card (devices=[cuda] * n, printed as such) and unsplit, 3 runs each in
     turns; bytes equal the unsplit session's, decode lossless; the 2-group
     path counted from a reset and its launches held against plain as in
     phase 10.
K4 in phase 3 and 5 also reports its time a row and the whole
reconstruct_i (expand, pad, kernel). Phases 4, 6, 8-11 require K5 (the
P analysis's block front end) and K6 (the P decode's data-block rebuild)
among their launches too, phases 4, 6 and 8 K8 (the P decode's block
resolution); phase 4 prints the 1080p session encode's peak device memory.
The kernels' JSON summary gives each kernel's launches on its main path,
its time, its plain version's, its largest error and its roofline bound
(the larger of the bytes it must move over 3.35 TB/s and its scalar
operations over 67 TOP/s, the H100 SXM figures): summed over the compared
launches, like the times, and "library_ms": null (no single PyTorch call
computes K1-K8: K5 ends in a first-match search, K6 is a recurrence, K8
a chain of scans and searches).
Then the card's nvidia-smi name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure raises (non-zero exit, no
result line). Needs a CUDA device; imports nothing of JAX, of the JAX
package or of its benchmark.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, N_FRAMES = 1080, 1920, 64
NATIVE_DIGESTS = os.path.join(ROOT, "tests", "data", "torch_native_1080p_64.json")
# the sp mesh's session: one 4K stream, its native digests
SP_H, SP_W, SP_N = 2160, 3840, 8
NATIVE_DIGESTS_4K = os.path.join(ROOT, "tests", "data", "torch_native_4k_8.json")
TIMED_REPS = 5
# the serving profile of bench.serving_diag: 64 concurrent 360p streams,
# staggered keyframes, +-256 motion, 64 lanes per section
S_STREAMS, S_H, S_W, S_KF, S_STEPS = 64, 360, 640, 150, 5


def golden_session_frames(h, w):
    """Copy of tools/make_goldens.py:session_frames (that module imports
    JAX); only its first frame seeds the serving golden."""
    base = np.full((h + 60, w, 3), (30, 40, 50), np.uint8)
    base[h // 6: h - h // 6, 8: w - 8] = (250, 250, 250)
    for y in range(h // 5, h - h // 5, 6):
        base[y: y + 2, 10: w - 16: 2] = (10, 20, 30)
    return [base[:h].copy()]


def golden_serving_frames(h=32, w=48, s=4):
    """Copy of tools/make_goldens.py:serving_session_frames, the frames of
    the procedural_serving_kfixed golden."""
    base = np.stack([np.roll(golden_session_frames(h, w)[0], 7 * i, axis=1)
                     for i in range(s)])
    seq = [base]
    f = base.copy()
    f[:, h // 5: h // 3, w // 3: 2 * w // 3] = (250, 250, 250)
    seq.append(f)
    seq.append(np.roll(f, 5, axis=1))
    seq.append(seq[-1].copy())
    return seq


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# per lane, substep and alphabet entry: effective-row entry, prefix sum,
# compare and select (K1 and K2)
SECTION_OPS_PER_SYMBOL = 4
# K5: the bound compares of a candidate tested; per pixel of the range its
# packing, change compare and flat compare
SEARCH_OPS_TEST = 4
ANALYSIS_OPS_PIXEL = 3
# K6: per position of a sub-rect, the row step's selects and its four
# shuffle-and-add scan steps
REBUILD_OPS_POSITION = 8


def bound(nbytes, nops):
    """(ms, what bounds it): the least time the card needs to move nbytes
    and compute nops scalar operations."""
    b, o = nbytes / HBM_BYTES_PER_S, nops / SCALAR_OPS_PER_S
    return 1e3 * max(b, o), "bytes" if b >= o else "operations"


def sections_work(kts, recs_list, lens_list, coded_bytes):
    """(bytes, operations) a K1 or K2 launch over these sections needs:
    each valid record and each coded byte once, lens, the tables of the
    sections' kinds read and written once (of color only the rows the
    records touch, as this run's data needs), and SECTION_OPS_PER_SYMBOL
    per lane, substep and alphabet entry of each valid record."""
    import torch

    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch.config import TABLE_KINDS, kind_mixed
    from screenpressor_tpu_torch.substeps import SUBSTEP_CODECS

    nbytes, nops, kinds = coded_bytes, 0, {}
    for (name, _k, _t), recs, lens in zip(kts, recs_list, lens_list):
        if recs.dim() == 3:
            recs, lens = recs[None], lens[None]
        codec = SUBSTEP_CODECS[name]
        n_valid = int(lens.long().sum())
        nbytes += n_valid * codec.rec_width * 4 + lens.numel() * 4
        nops += n_valid * SECTION_OPS_PER_SYMBOL * sum(TABLE_KINDS[kd][1] for kd in codec.kinds)
        for kd in codec.kinds:
            rows, alpha = TABLE_KINDS[kd]
            if kd == "color":
                rows = [int(torch.unique(r).numel())
                        for r in tc._col_rows_exact(recs[..., :3].int(), lens)]
            else:
                rows = [rows] * recs.shape[0]
            g = alpha + 1 if kind_mixed(kd) else 0
            kinds[kd] = sum(2 * 4 * (r * (alpha + 1) + g) for r in rows)
    return nbytes + sum(kinds.values()), nops


def walk_work(bits, starts):
    """K3: the fits bits and start types in (int32 each), the start mask
    out, and one compare-and-select chain of 4 operations per position."""
    return bits.numel() * 8 + starts.numel() * starts.element_size(), 4 * bits.numel()


def recon_work(rows, out, unpacked=False):
    """K4: its packed rows in (one int32 a padded position) and 3 B out per
    pixel; per padded position and channel a log2(Wp)-step scan of affine
    compositions (3 operations a step) and the predictor (4). unpacked
    counts the rows as an int32 ptype and three int32 literals (16 B a
    padded position), the inputs before recon.pack_rows."""
    wp = rows.shape[-1]
    n = rows.numel() * 3
    per_pos = 16 if unpacked else rows.element_size()
    return rows.numel() * per_pos + out.numel(), n * (3 * max(wp.bit_length() - 1, 1) + 4)


def recon_timings(tr, records, lits, h, w, reps):
    """K4 on one frame's records: (kernel ms, whole reconstruct_i ms with
    its expand and pad, rows, kernel output)."""
    rows = tr.pad_rows(*tr.expand_records(records, lits, h * w), h, w)
    ms, got = cuda_ms(lambda: tr.recon_rows(rows, w), reps)
    whole_ms, whole = cuda_ms(lambda: tr.reconstruct_i(records, lits, h, w), reps)
    if not (whole == got).all():
        raise AssertionError("reconstruct_i differs from K4 on its padded rows")
    return ms, whole_ms, rows, got


def rebuild_work(args):
    """K6's (bytes, operations) on one call's inputs (out, prev, rects,
    bsid, ptypes, rlens, lits), counted from what this call's records need:
    each slot's rect (16 B) and, for a slot with a sub-rect, its stream id
    (8 B); the run lengths of the records that start inside the sub-rect
    (4 B each), the ptype of each record a position takes (4 B) and the
    three literals of each such literal record (12 B); the distinct pixels
    of prev that the positions read (the row above, the left edge and the
    above-left pixel where a predictor reads them, a PT_PREVFRAME
    position's own pixel; 3 B each, none outside the frame); 3 B for each
    distinct pixel written. Operations: REBUILD_OPS_POSITION a position."""
    import torch

    from screenpressor_tpu_torch.config import (PT_ABOVE, PT_ABOVELEFT, PT_GRADIENT, PT_LEFT,
                                                PT_LITERAL, PT_PREVFRAME)

    _, prev, rects, bsid, ptypes, rlens, _ = args
    c, h, w = prev.shape[:3]
    dev, nblk = prev.device, rects.shape[0]
    rects, bsid, rl, pt_rec = rects.long(), bsid.long(), rlens.long(), ptypes.long()
    bw = (rects[:, 2] - rects[:, 0]).clamp(0, 16)
    bh = (rects[:, 3] - rects[:, 1]).clamp(0, 16)
    n_pos = torch.where((bsid >= 0) & (bsid < c), bw * bh, 0)
    # each position's record, as the plain version expands them
    starts = rl.cumsum(1) - rl
    marks = (rl > 0) & (starts >= 0) & (starts < 256)
    at = torch.zeros((nblk, 257), dtype=torch.long, device=dev)
    at.scatter_add_(1, torch.where(marks, starts, 256), marks.long())
    rid = (at[:, :256].cumsum(1) - 1).clamp(0, 255)
    p = torch.arange(256, device=dev)[None]
    inside = p < n_pos[:, None]
    used = torch.zeros((nblk, 256), dtype=torch.long, device=dev)
    used = used.scatter_add_(1, rid, inside.long()) > 0
    n_rlens = int(((starts < n_pos[:, None]) & (n_pos[:, None] > 0)).sum())
    n_lits = int((used & (pt_rec == PT_LITERAL)).sum())
    # the pixels of prev the positions read, and those written
    pt = pt_rec.gather(1, rid)
    ry, rx = p // bw.clamp_min(1)[:, None], p % bw.clamp_min(1)[:, None]
    y, x = rects[:, 1:2] + ry, rects[:, 0:1] + rx
    edge, grad = (ry == 0) | (rx == 0), pt == PT_GRADIENT
    sid = bsid.clamp(0, c - 1)[:, None]

    def pixels(yy, xx, need):
        keep = need & inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return ((sid * h + yy) * w + xx)[keep]

    reads = torch.cat([
        pixels(y - 1, x, (ry == 0) & ((pt == PT_ABOVE) | grad)),
        pixels(y, x, pt == PT_PREVFRAME),
        pixels(y - 1, x - 1, edge & ((pt == PT_ABOVELEFT) | grad)),
        pixels(y, x - 1, (rx == 0) & ((pt == PT_LEFT) | grad)),
    ])
    n_read = int(torch.unique(reads).numel())
    n_written = int(torch.unique(pixels(y, x, inside)).numel())
    nbytes = (16 * nblk + 8 * int((n_pos > 0).sum()) + 4 * n_rlens + 4 * int(used.sum())
              + 12 * n_lits + 3 * n_read + 3 * n_written)
    return nbytes, REBUILD_OPS_POSITION * int(n_pos.sum())


def graph_ms(fn, reps, replays=20):
    """Device milliseconds a call of fn: reps calls captured in one CUDA
    graph, replayed `replays` times between CUDA events after one warm
    replay, over reps * replays. The host's dispatch of fn is not in it;
    the graph's gaps between its kernels are."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def hold_rebuild(record, entry, calls, label, smi):
    """K6 (kernels.rebuild_blocks_streams_kernel) against its plain version
    (pframe.reconstruct_blocks_streams_plain) on captured calls (out before
    the rebuild, prev, rects, bsid, ptypes, rlens, lits), summed over the
    calls; the frames must be equal (the sink row aside). K6's time is its
    device time from a CUDA graph of its launches (graph_ms); the
    wrapper's time by CUDA events over TIMED_REPS calls queued back to
    back (its host dispatch sets that) is printed beside it; plain: CUDA
    events, one run. record: the row to add them to. Returns (kernel ms,
    plain ms, bound ms)."""
    from screenpressor_tpu_torch import kernels as tk
    from screenpressor_tpu_torch import pframe as tp

    ms = wrapper_ms = plain_ms = 0.0
    err, nbytes, nops, n_slots, n_live = 0, 0, 0, 0, 0
    for args in calls:
        out, rest = args[0], args[1:]
        got, want = out.clone(), out.clone()
        run = lambda: tk.rebuild_blocks_streams_kernel(got, *rest)  # noqa: E731
        wrapper_ms += cuda_ms(run, TIMED_REPS)[0]
        plain_ms += cuda_ms(lambda: tp.reconstruct_blocks_streams_plain(want, *rest), 1, False)[0]
        err = max(err, max_abs_err([(got[:-1].cpu().numpy(), want[:-1].cpu().numpy())]))
        b, o = rebuild_work(args)
        nbytes, nops = nbytes + b, nops + o
        n_slots += args[2].shape[0]
        n_live += int((args[2][:, 2] > args[2][:, 0]).sum())
        if args[2].shape[0]:
            ms += graph_ms(run, TIMED_REPS)
    record(entry, ms, plain_ms, err, (nbytes, nops))
    bms, by = bound(nbytes, nops)
    print(f"K6 {label}: {len(calls)} calls, {n_slots} data-block slots ({n_live} not empty): "
          f"kernel {ms:.4f} ms (device, a CUDA graph of its launches; the wrapper "
          f"{wrapper_ms:.4f} ms by CUDA events), bound {bms:.4g} ms ({by}; {nbytes} B, "
          f"{nops} operations), plain {plain_ms:.1f} ms, equal, on {smi}")
    return ms, plain_ms, bms


def resolve_work(recs, lay):
    """K8's bytes on one call: every record of its five sections read once
    (int32), the layout (hdr, the slot ranges, each data-block slot's
    stream, int64) read once, its outputs written once (motion rects and
    vectors, data-block rects, each data-block slot's 256 ptypes, run
    lengths and literal triples, int32, and the error words)."""
    n_in = sum(r.numel() for r in recs.values()) * 4
    n_in += 8 * (lay.hdr.numel() + 4 * lay.hdr.shape[0] + lay.bsid.shape[0])
    m, b, c = lay.msid.shape[0], lay.bsid.shape[0], lay.hdr.shape[0]
    return n_in + 4 * (6 * m + 4 * b + 5 * 256 * b + c)


def hold_resolve(record, entry, calls, label, smi):
    """K8 (kernels.resolve_blocks_streams_kernel, one C call of three
    kernels) against its plain version (pframe.decode_p_resolve_streams_plain)
    on captured calls (recs, lay, cfg), summed over the calls; all six
    outputs and the error word must be equal. K8's time is its device time
    from a CUDA graph of its calls (graph_ms), the wrapper's CUDA-event time
    and the synchronised host time a call printed beside it; plain: CUDA
    events and the synchronised host clock, one run. record: the row to add
    them to. Returns (kernel ms, plain ms, bound ms)."""
    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch import pframe as tp

    ms = wrapper_ms = host = plain_ms = plain_host = 0.0
    err, nbytes, n_rec, launches = 0, 0, 0, 0
    for recs, lay, cfg in calls:
        run = lambda: tp.decode_p_resolve_streams(recs, lay, cfg)  # noqa: E731
        plain = lambda: tp.decode_p_resolve_streams_plain(recs, lay, cfg)  # noqa: E731
        n0 = _build.LAUNCHES["sptc_resolve_blocks"]
        wrapper_ms += cuda_ms(run, TIMED_REPS)[0]
        launches += _build.LAUNCHES["sptc_resolve_blocks"] - n0
        host += host_ms(run, TIMED_REPS)[0]
        t_plain, (want, want_err) = cuda_ms(plain, 1, False)
        plain_ms += t_plain
        plain_host += host_ms(plain, 1)[0]
        got, got_err = run()
        err = max(err, max_abs_err([(g.cpu().numpy(), w.cpu().numpy()) for g, w in
                                    zip((*got, got_err), (*want, want_err))]))
        nbytes += resolve_work(recs, lay)
        n_rec += int(lay.hdr[:, 3].sum())
        ms += graph_ms(run, TIMED_REPS)
    record(entry, ms, plain_ms, err, (nbytes, 0))
    bms, by = bound(nbytes, 0)
    print(f"K8 {label}: {len(calls)} calls ({launches} C calls in {(TIMED_REPS + 1) * len(calls)} "
          f"wrapper calls, three kernels each), {n_rec} records: kernel {ms:.4f} ms (device, a CUDA graph of its calls; "
          f"the wrapper {wrapper_ms:.4f} ms by CUDA events, {host:.4f} ms on the synchronised "
          f"host), bound {bms:.4g} ms ({by}; {nbytes} B), plain {plain_ms:.3f} ms by CUDA "
          f"events ({plain_host:.3f} ms on the host), equal, on {smi}")
    return ms, plain_ms, bms


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


def clone_tables(tables_b):
    return {kd: {key: v.clone() for key, v in tab.items()} for kd, tab in tables_b.items()}


def serving_batches(dev, synth_screencast):
    """The serving profile's config, keyframe offsets and S_STEPS batches
    (host numpy and device)."""
    import torch

    from screenpressor_tpu_torch.config import CodecConfig

    cfg = CodecConfig(width=S_W, height=S_H, kf_interval=S_KF, k_fixed=64,
                      msr_x=256, msr_y=256)
    offsets = (np.arange(S_STREAMS) * S_KF) // S_STREAMS
    base = synth_screencast(S_H, S_W, S_STEPS, seed=3)
    host = [np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(S_STREAMS)])
            for t in range(S_STEPS)]
    return cfg, offsets, host, [torch.as_tensor(b, device=dev) for b in host]


def serving_kernels_vs_plain(t0, dev, smi, record, cfg, offsets, host, batches):
    """Phase 5 (its tensors are freed on return, before phase 6 measures
    the session's peak memory)."""
    import torch

    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import kernels as tk
    from screenpressor_tpu_torch import recon as tr
    from screenpressor_tpu_torch.config import color_ctx
    from screenpressor_tpu_torch.parallel import serving as ts
    from screenpressor_tpu_torch.tables import renew_tables_streams

    k = cfg.k_fixed

    # ---- 5. stream-batched kernels vs plain at the serving shapes ----
    # the sections of steps 0-2 (keyframes; scroll P; typing P) as the
    # encoder hands them to K1
    captured = {}
    real = tc.encode_sections_streams

    def capture(dealt_list, lens_list, tables_b, kts, sidx, col_w=None, col_bm=None):
        captured.setdefault(len(captured_steps), []).append(
            (list(dealt_list), list(lens_list), clone_tables(tables_b), kts, list(sidx),
             col_w, col_bm))
        return real(dealt_list, lens_list, tables_b, kts, sidx, col_w, col_bm)

    enc = ts.BatchedEncoder(S_STREAMS, cfg, dev, kf_offsets=offsets)
    captured_steps = []
    tc.encode_sections_streams = capture
    try:
        for step in range(3):
            enc.encode(batches[step])
            captured_steps.append(step)
    finally:
        tc.encode_sections_streams = real
    del enc
    for step in range(3):
        calls = captured.get(step, [])
        if len(calls) != 1 or len(calls[0][4]) < 2:
            raise AssertionError(f"step {step}: expected one K1 call over the streams")

    def blobs_of(bufs, starts, lens, i, n):
        return [tc.blobs_from_buf(bufs[i][j].cpu().numpy(), starts[i][j].cpu().numpy(),
                                  lens[i][j].cpu().numpy()) for j in range(n)]

    def tables_err(a, b):
        """Max |a - b| over every table tensor, taken on the device."""
        return max(int((a[kd][key].long() - b[kd][key].long()).abs().max())
                   for kd in b for key in b[kd])

    # K1 and K2 over the streams on the keyframe step and the two P steps,
    # full-table col (the colw comparison follows)
    for step, label in ((0, "keyframe"), (1, "scroll"), (2, "typing")):
        dealt, lens, tabs0, kts, sidx, _, _ = captured[step][0]
        scratch = clone_tables(tabs0)
        ms, _ = cuda_ms(lambda: tc.encode_sections_streams(dealt, lens, scratch, kts, sidx),
                        TIMED_REPS)
        tab_k = clone_tables(tabs0)
        bufs, starts = tc.encode_sections_streams(dealt, lens, tab_k, kts, sidx)
        tab_p = clone_tables(tabs0)
        plain_ms, (bufs_p, starts_p) = cuda_ms(
            lambda: tc.encode_sections_streams_plain(dealt, lens, tab_p, kts, sidx), 1, False)
        err = tables_err(tab_k, tab_p)
        n_bytes = 0
        for i in range(len(kts)):
            blobs = blobs_of(bufs, starts, lens, i, len(sidx))
            if blobs != blobs_of(bufs_p, starts_p, lens, i, len(sidx)):
                raise AssertionError(f"K1 streams {label} {kts[i][0]}: bytes differ from plain")
            n_bytes += sum(len(b) for bl in blobs for b in bl)
            err = max(err, max_abs_err([(starts[i].cpu().numpy(), starts_p[i].cpu().numpy())]))
        record("sptc_sections_encode_streams", ms, plain_ms, err,
               sections_work(kts, dealt, lens, n_bytes))
        print(f"K1 streams, step {step} ({label}): {len(sidx)} streams x {len(kts)} sections "
              f"(T {[t for _, _, t in kts]}), {n_bytes} bytes: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bytes, starts and tables equal")

        pays = []
        for i in range(len(kts)):
            arrs = [tc.pad_payload(bl, k) for bl in blobs_of(bufs, starts, lens, i, len(sidx))]
            width = max(a.shape[1] for a in arrs)
            pays.append(torch.as_tensor(
                np.stack([np.pad(a, ((0, 0), (0, width - a.shape[1]))) for a in arrs]),
                device=dev))
        scratch = clone_tables(tabs0)
        dms, _ = cuda_ms(lambda: tc.decode_sections_streams(pays, lens, scratch, kts, sidx),
                         TIMED_REPS)
        dtab_k = clone_tables(tabs0)
        recs = tc.decode_sections_streams(pays, lens, dtab_k, kts, sidx)
        dtab_p = clone_tables(tabs0)
        dplain_ms, recs_p = cuda_ms(
            lambda: tc.decode_sections_streams_plain(pays, lens, dtab_p, kts, sidx), 1, False)
        pairs = []
        for i in range(len(kts)):
            valid = (torch.arange(recs[i].shape[1], device=dev)[None, :, None]
                     < lens[i][:, None, :])[..., None]
            pairs += [(recs[i].cpu().numpy(), recs_p[i].cpu().numpy()),
                      (torch.where(valid, recs[i], 0).cpu().numpy(),
                       torch.where(valid, dealt[i], 0).cpu().numpy())]
        derr = max(max_abs_err(pairs), tables_err(dtab_k, dtab_p), tables_err(dtab_k, tab_k))
        record("sptc_sections_decode_streams", dms, dplain_ms, derr,
               sections_work(kts, recs, lens, sum(p.numel() for p in pays)))
        print(f"K2 streams, step {step} ({label}): kernel {dms:.3f} ms, plain "
              f"{dplain_ms:.1f} ms, records equal the encoded ones, tables equal plain and "
              "encoder")
        del tabs0, tab_k, tab_p, dtab_k, dtab_p, scratch

    # K1-colw against full-table K1 col: the typing P step's and the
    # keyframe step's color sections, then sections whose literals touch
    # color row 12287
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (6, 3))
    pal[0] = (255, 250, 17)
    assert 2 * 4096 + int(color_ctx(255, 250)) == 12287
    fx_ns = [int(v) for v in rng.integers(1, 3000, S_STREAMS)]
    fx_lits = [torch.as_tensor(pal[rng.integers(0, 6, n)], dtype=torch.int32, device=dev)
               for n in fx_ns]
    fx_t = max(tc.steps_for(n, k) for n in fx_ns)
    fixtures = []
    for step, label in ((2, "typing P step col"), (0, "keyframe step col")):
        dealt, lens, tabs0, kts, sidx, col_w, col_bm = captured[step][0]
        ci = [name for name, _, _ in kts].index("col")
        if col_w is None:
            raise AssertionError(f"{label}: {int(col_bm.sum(dim=1).max())} touched rows, "
                                 "no colw bucket")
        fixtures.append((label, [dealt[ci]], [lens[ci]], (kts[ci],), sidx, tabs0, col_w,
                         col_bm))
    del captured
    fixtures.append(
        ("row-12287 fixture", [torch.stack([tc.deal(lt, n, k, fx_t)
                                            for lt, n in zip(fx_lits, fx_ns)])],
         [torch.stack([tc.lane_lens(n, k, dev) for n in fx_ns])], (("col", k, fx_t),),
         list(range(S_STREAMS)), renew_tables_streams(S_STREAMS, dev), 256,
         torch.stack([tc.color_touched_bitmap(lt, n) for lt, n in zip(fx_lits, fx_ns)])))
    for label, d_l, l_l, c_kts, c_sidx, c_tabs, c_w, c_bm in fixtures:
        n_touch = int(c_bm.sum(dim=1).max())
        if n_touch > c_w or (label.startswith("row") and not bool(c_bm[:, 12287].any())):
            raise AssertionError(f"{label}: fixture does not fit colw{c_w} / touch row 12287")
        kts_w = ((f"colw{c_w}",) + c_kts[0][1:],)
        scratch = clone_tables(c_tabs)
        recs_c, ctab_c, _ = tc.color_compact_streams(d_l[0], l_l[0], c_bm, scratch["color"],
                                                     c_sidx, c_w)
        ms, _ = cuda_ms(lambda: tk.encode_sections_streams_kernel(
            [recs_c], l_l, {**scratch, "color": ctab_c}, kts_w, c_sidx, ("color",)),
            TIMED_REPS)
        full_ms, _ = cuda_ms(lambda: tk.encode_sections_streams_kernel(
            d_l, l_l, scratch, c_kts, c_sidx), TIMED_REPS)
        path_ms, _ = cuda_ms(lambda: tc.encode_sections_streams(
            d_l, l_l, scratch, c_kts, c_sidx, c_w, c_bm), TIMED_REPS)
        tab_w, tab_f, tab_pw = (clone_tables(c_tabs) for _ in range(3))
        b_w, s_w = tc.encode_sections_streams(d_l, l_l, tab_w, c_kts, c_sidx, c_w, c_bm)
        b_f, s_f = tc.encode_sections_streams(d_l, l_l, tab_f, c_kts, c_sidx)

        def plain_colw():
            recs_p, ctab_p, maps = tc.color_compact_streams(
                d_l[0], l_l[0], c_bm, tab_pw["color"], c_sidx, c_w)
            out = tc.encode_sections_streams_plain(
                [recs_p], l_l, {**tab_pw, "color": ctab_p}, kts_w, c_sidx, ("color",))
            tc.color_restore_streams(tab_pw["color"], c_sidx, ctab_p, maps)
            return out

        plain_ms, (b_p, s_p) = cuda_ms(plain_colw, 1, False)
        for j in range(len(c_sidx)):
            ln = l_l[0][j].cpu().numpy()
            got = tc.blobs_from_buf(b_w[0][j].cpu().numpy(), s_w[0][j].cpu().numpy(), ln)
            if (got != tc.blobs_from_buf(b_f[0][j].cpu().numpy(), s_f[0][j].cpu().numpy(), ln)
                    or got != tc.blobs_from_buf(b_p[0][j].cpu().numpy(),
                                                s_p[0][j].cpu().numpy(), ln)):
                raise AssertionError(f"K1-colw {label}: stream {c_sidx[j]} bytes differ")
        err = max(tables_err(tab_w, tab_f), tables_err(tab_w, tab_pw),
                  max_abs_err([(s_w[0].cpu().numpy(), s_f[0].cpu().numpy())]))
        record("sptc_sections_encode_colw_streams", ms, plain_ms, err,
               sections_work(kts_w, [recs_c], l_l, sum(
                   len(b) for j in range(len(c_sidx)) for b in tc.blobs_from_buf(
                       b_w[0][j].cpu().numpy(), s_w[0][j].cpu().numpy(),
                       l_l[0][j].cpu().numpy()))))
        print(f"K1-colw {label}: {len(c_sidx)} streams, T {c_kts[0][2]}, colw{c_w}, touched "
              f"rows <= {n_touch}: colw kernel {ms:.3f} ms, full-table col kernel "
              f"{full_ms:.3f} ms, colw path with its torch gather and restore {path_ms:.3f} ms, "
              f"plain colw {plain_ms:.1f} ms; bytes, starts and restored tables equal full "
              "col and plain")
        del scratch, recs_c, ctab_c, tab_w, tab_f, tab_pw
    del fixtures

    # K3 over the keyframe step's 64 frames, each padded to whole seg tiles
    bits, sts, tile = tcl.walk_inputs_streams(batches[0])
    bits, sts = bits.reshape(-1), sts.reshape(-1)
    ms, got = cuda_ms(lambda: tcl.run_walk(bits, sts, tile), TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: tcl.run_walk_plain(bits, sts, tile), 1, False)
    record("sptc_run_walk_streams", ms, plain_ms,
           max_abs_err([(got.cpu().numpy(), ref.cpu().numpy())]), walk_work(bits, got))
    print(f"K3 streams: {S_STREAMS} keyframes {S_H}x{S_W}, n={bits.numel()} tile={tile}: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal")
    del bits, sts, got, ref

    # K4 over the keyframe step's 64 frames, then one of them alone (the
    # chain floor: rows x the latency of a row at a batch of one)
    cls = tcl.classify_i_streams(batches[0])
    recs = [(r[: int(n)], lt[: max(int(nl), 1)]) for r, n, lt, nl in cls]
    k4_rows = torch.stack([tr.pad_rows(*tr.expand_records(r, lt, S_H * S_W), S_H, S_W)
                           for r, lt in recs])
    ms, got = cuda_ms(lambda: tr.recon_rows(k4_rows, S_W), TIMED_REPS)
    whole_ms, whole = cuda_ms(lambda: tr.reconstruct_i_streams(*zip(*recs), S_H, S_W),
                              TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: torch.stack([tr.recon_rows_plain(r, S_W) for r in k4_rows]),
                            1, False)
    err = max_abs_err([(got.cpu().numpy(), ref.cpu().numpy()), (got.cpu().numpy(), host[0]),
                       (whole.cpu().numpy(), host[0])])
    record("sptc_recon_rows_streams", ms, plain_ms, err, recon_work(k4_rows, got))
    one_ms, one_whole_ms, _, one = recon_timings(tr, *recs[0], S_H, S_W, TIMED_REPS)
    if not torch.equal(one, got[0]):
        raise AssertionError("K4 on one serving frame differs from the batch")
    print(f"K4 streams: {S_STREAMS} keyframes {S_H}x{S_W} (Wp={k4_rows.shape[-1]}): kernel "
          f"{ms:.3f} ms ({1e3 * ms / S_H:.3f} us a row), bound "
          f"{bound(*recon_work(k4_rows, got))[0]:.4f} ms (unpacked inputs "
          f"{bound(*recon_work(k4_rows, got, True))[0]:.4f} ms), reconstruct_i_streams with expand "
          f"and pad {whole_ms:.3f} ms, plain {plain_ms:.1f} ms, equal, equal the frames; one "
          f"frame alone: kernel {one_ms:.3f} ms ({1e3 * one_ms / S_H:.3f} us a row: chain "
          f"floor {S_H} x that), reconstruct_i {one_whole_ms:.3f} ms, on {smi}")
    del cls, recs, k4_rows, got, whole, ref
    phase("serving kernels vs plain", t0)


def serving_main_path(t0, dev, smi, cfg, offsets, host, batches):
    """Phase 6. Returns the counted session's launch counts."""
    import torch

    from screenpressor_tpu_torch import TorchEncoder, _build
    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.parallel import serving as ts

    # ---- 6. the serving main path, run twice, the second counted ----
    def serve():
        enc = ts.BatchedEncoder(S_STREAMS, cfg, dev, kf_offsets=offsets)
        dec = ts.BatchedDecoder(S_STREAMS, cfg, dev)
        torch.cuda.synchronize()
        ts0 = time.perf_counter()
        got = list(ts.serve_pipelined(enc, batches, dec))
        dec.validate()
        torch.cuda.synchronize()
        return got, time.perf_counter() - ts0

    dt0 = serve()[1]
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    got, dt = serve()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held  # the session's own
    print(f"serving main path launches: {launches}")
    need = ("sptc_sections_encode", "sptc_sections_encode_colw", "sptc_sections_decode",
            "sptc_run_walk", "sptc_recon_rows", "sptc_analyze_blocks", "sptc_rebuild_blocks",
            "sptc_resolve_blocks")
    missing = [kn for kn in need if launches[kn] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the serving path: {missing}")
    kinds = set()
    for t, ((outs, back), frames) in enumerate(zip(got, batches)):
        if not torch.equal(back, frames):
            bad = [i for i in range(S_STREAMS) if not torch.equal(back[i], frames[i])]
            raise AssertionError(f"serving step {t}: streams {bad[:8]} not lossless")
        kinds.add(tuple(sorted({ft for _, ft in outs})))
    if (0, 1) not in kinds:
        raise AssertionError(f"no mixed I/P step in the serving run: {kinds}")
    phase("serving main path", t0)

    single = CodecConfig(width=S_W, height=S_H, kf_interval=0, k_fixed=64, msr_x=256,
                         msr_y=256)
    for i in range(S_STREAMS):
        e = TorchEncoder(single, dev)
        for t in range(S_STEPS):
            force = t > 0 and (t + offsets[i]) % S_KF == 0
            if e.encode(host[t][i], force_key=force) != got[t][0][i]:
                raise AssertionError(f"serving stream {i} step {t}: bytes differ from its "
                                     "TorchEncoder session")
    print(f"serving bytes equal {S_STREAMS} per-stream TorchEncoder sessions over "
          f"{S_STEPS} steps")

    gcfg = CodecConfig(width=48, height=32, kf_interval=3, k_fixed=8, msr_x=8, msr_y=8)
    genc = ts.BatchedEncoder(4, gcfg, dev, kf_offsets=[0, 1, 2, 0])
    gpay = [p for fr in golden_serving_frames() for p, _ in genc.encode(fr)]
    with open(os.path.join(ROOT, "tests", "data", "golden_manifest.json")) as fh:
        gmeta = json.load(fh)["procedural_serving_kfixed"]
    if [len(p) for p in gpay] != gmeta["sizes"] or zlib.crc32(b"".join(gpay)) != gmeta["crc32"]:
        raise AssertionError("procedural_serving_kfixed golden does not reproduce")
    print("procedural_serving_kfixed golden: sizes and crc32 equal")
    phase("serving byte checks", t0)

    sizes = [sum(len(p) for p, _ in outs) for outs, _ in got]
    n_sf = S_STREAMS * S_STEPS
    for tag, d in (("first session", dt0), ("second session", dt)):
        print(f"serving {tag}: {S_STREAMS} streams x {S_STEPS} steps at {S_W}x{S_H}, "
              f"encode+decode {d:.3f} s: {n_sf / d:.2f} stream-frames/s, "
              f"{n_sf * S_H * S_W / d / 1e6:.3f} Mpix/s on {smi}")
    print(f"serving bytes per step: {sizes}; peak device memory of the counted session "
          f"{peak / 2**20:.1f} MiB on {smi}")
    return launches


def host_ms(fn, reps):
    """Mean milliseconds per call of fn on the host clock, synchronised
    with the card before and after, and its result."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - start) / reps, out


def serving_rebuild(t0, dev, smi, record, cfg, offsets, batches):
    """Phase 6b: the stream-batched P rebuild (pframe.rebuild_p_streams,
    one call a step) against pframe.rebuild_p stream by stream, on the
    inputs BatchedDecoder hands it on the serving session's scroll and
    typing steps; both must be equal. K6 (the data-block rebuild inside
    it) against its plain version on each step's call."""
    import torch

    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.parallel import serving as ts
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import rebuild_calls, rebuild_p_loop  # would shadow ROOT/tests

    enc = ts.BatchedEncoder(S_STREAMS, cfg, dev, kf_offsets=offsets)
    steps = [[p for p, _ in enc.encode(batches[t])] for t in range(3)]
    del enc
    captured = []
    real = ts.rebuild_p_streams

    def capture(recs, lay, prev, cfg_):
        captured.append(({name: r.clone() for name, r in recs.items()},
                         lay.hdr.cpu().numpy(), prev.clone()))
        return real(recs, lay, prev, cfg_)

    dec = ts.BatchedDecoder(S_STREAMS, cfg, dev)
    k6_calls = []
    ts.rebuild_p_streams = capture
    try:
        with rebuild_calls(k6_calls):
            for step in steps:
                dec.decode(step)
    finally:
        ts.rebuild_p_streams = real
    del dec
    if len(captured) != 2:
        raise AssertionError(f"expected one stream-batched rebuild on each P step, got "
                             f"{len(captured)}")
    for (recs, rows, prev), k6, label in zip(captured, k6_calls, ("scroll", "typing")):
        def batched():
            return tp.rebuild_p_streams(recs, tp.step_layout(rows, dev), prev, cfg)

        ms, (frames, err) = cuda_ms(batched, TIMED_REPS)
        hms, _ = host_ms(batched, TIMED_REPS)
        _build.reset_counts()
        batched()
        k6_launches = _build.LAUNCHES["sptc_rebuild_blocks"]
        k6_ms, k6_plain, k6_bound = hold_rebuild(record, "sptc_rebuild_blocks_streams", [k6],
                                                 f"serving {label} step", smi)
        loop_ms, (frames_l, err_l) = cuda_ms(lambda: rebuild_p_loop(recs, rows, prev, cfg), 2)
        loop_hms, _ = host_ms(lambda: rebuild_p_loop(recs, rows, prev, cfg), 2)
        if not (torch.equal(frames, frames_l) and torch.equal(err, err_l)):
            raise AssertionError(f"P rebuild, {label} step: stream-batched and per-stream "
                                 "results differ")
        if bool(err.any()):
            raise AssertionError(f"P rebuild, {label} step: error word set on a clean step")
        n_mv = int(np.maximum(rows[:, 2], 1).sum())
        n_blk = int(np.maximum(rows[:, 7], 1).sum())
        print(f"P rebuild, {label} step: {len(rows)} coded P streams, {n_mv} motion and "
              f"{n_blk} data-block slots: stream-batched {ms:.3f} ms (CUDA events), "
              f"{hms:.3f} ms (host, synchronised), {k6_launches} K6 launch (kernel "
              f"{k6_ms:.4f} ms, bound {k6_bound:.4g} ms, plain {k6_plain:.1f} ms); per-stream "
              f"loop {loop_ms:.3f} ms, {loop_hms:.3f} ms; frames and error words equal, on {smi}")
    hold_resolve(record, "sptc_resolve_blocks_streams",
                 [(recs, tp.step_layout(rows, dev), cfg) for recs, rows, _ in captured],
                 "serving scroll and typing steps", smi)
    del captured, k6_calls
    phase("serving P rebuild", t0)


def session_rebuild(t0, dev, smi, record, payloads, cfg, t_dec):
    """Phase 6b on the single stream: the 1080p session's decode with each
    pframe.rebuild_p_streams call (one a coded P frame, C = 1) captured; K6
    against its plain version on every call; the first two coded P frames'
    calls (the scroll and the typing frame) timed by CUDA events and the synchronised host
    clock with their K6 launches; all the calls again in sequence on the
    synchronised host clock, beside the session's decode time t_dec."""
    import torch

    from screenpressor_tpu_torch import TorchDecoder, _build
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.config import ALG_P
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import rebuild_calls  # would shadow ROOT/tests

    captured, k6_calls = [], []
    real = tp.rebuild_p_streams

    def capture(recs, lay, prev, cfg_):
        captured.append((recs, lay, prev.clone()))
        return real(recs, lay, prev, cfg_)

    tp.rebuild_p_streams = capture
    try:
        with rebuild_calls(k6_calls):
            TorchDecoder(cfg, dev).decode_batch([p for p, _ in payloads], device_out=True)
    finally:
        tp.rebuild_p_streams = real
    torch.cuda.synchronize()
    hold_rebuild(record, "sptc_rebuild_blocks", k6_calls,
                 f"1080p session, its {len(k6_calls)} coded P frames", smi)
    coded = [i for i, (p, _) in enumerate(payloads)
             if bs.parse_header_byte(p[0]) == ALG_P and tp.parse_p_header(p, 1, cfg)]
    if len(coded) != len(captured):
        raise AssertionError(f"1080p decode: {len(captured)} rebuilds for {len(coded)} coded "
                             "P frames")
    for j in (0, 1):  # the 1080p batch's frame 1 scrolls, frame 2 types
        recs, lay, prev = captured[j]
        ms, _ = cuda_ms(lambda: real(recs, lay, prev, cfg), TIMED_REPS)
        hms, _ = host_ms(lambda: real(recs, lay, prev, cfg), TIMED_REPS)
        _build.reset_counts()
        real(recs, lay, prev, cfg)
        n_blk = int((k6_calls[j][2][:, 2] > k6_calls[j][2][:, 0]).sum())
        print(f"P rebuild, 1080p frame {coded[j]}: {int(lay.msid.shape[0])} motion slots, "
              f"{n_blk} data blocks, rebuild_p_streams "
              f"{ms:.3f} ms (CUDA events), {hms:.3f} ms (host, synchronised), "
              f"{_build.LAUNCHES['sptc_rebuild_blocks']} K6 launch, on {smi}")
    hold_resolve(record, "sptc_resolve_blocks", [(r, lay, cfg) for r, lay, _ in captured],
                 f"1080p session, its {len(captured)} coded P frames", smi)
    all_ms, _ = host_ms(lambda: [real(*c, cfg) for c in captured], 3)
    print(f"P rebuild, 1080p session: its {len(captured)} rebuild_p_streams calls in sequence "
          f"{all_ms:.3f} ms (host, synchronised), {all_ms / 1e3 / t_dec:.4f} of the session's "
          f"decode ({t_dec:.3f} s), on {smi}")
    del captured, k6_calls
    phase("1080p session P rebuild", t0)


def count_syncs(fn):
    """fn() with the card's synchronizing calls counted (torch's sync debug
    mode, each warning one host sync) -> (result, syncs)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def analysis_work(frames, cands, row0, nby, out):
    """K5's (bytes, operations) as this run's data needs them: both frames'
    rows of block rows [row0, row0 + nby) once (3 B a pixel each), the
    candidates once, the four outputs once (22 B a block); then the
    search's reads of the previous frame outside those rows (none when the
    call covers the whole frame): one pixel for each in-frame candidate a
    changed block rejects before its answer and the sub-rect at its match,
    at most the rest of the previous frame of each stream with a change,
    read once. Operations: ANALYSIS_OPS_PIXEL a pixel of the range,
    SEARCH_OPS_TEST bound compares for each candidate tested before the
    answer (all of them where none matches), one pixel compare more for
    each in-frame one rejected, one a position at a match."""
    import torch

    changed, rects, choice, _flat = out
    c, h, w, _ = frames.shape
    rows = max(0, min((row0 + nby) * 16, h) - row0 * 16)
    n_cand = cands.shape[0]
    ch = changed.reshape(-1)
    r = rects.reshape(-1, 4)[ch].long()
    ci = choice.reshape(-1)[ch].long()
    area = (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
    found = ci < n_cand
    mx, my = cands[:, 0].long(), cands[:, 1].long()
    order = torch.arange(n_cand, device=cands.device)
    rejected_in = 0
    for lo in range(0, r.shape[0], 4096):
        rr, cc = r[lo:lo + 4096], ci[lo:lo + 4096]
        inb = ((rr[:, 0:1] + mx >= 0) & (rr[:, 2:3] + mx <= w)
               & (rr[:, 1:2] + my >= 0) & (rr[:, 3:4] + my <= h))
        rejected_in += int((inb & (order < cc[:, None])).sum())
    tested = int(torch.where(found, ci + 1, n_cand).sum())
    matched_px = int(area[found].sum())
    prev_bytes = min(3 * (rejected_in + matched_px),
                     3 * (h - rows) * w * int(changed.reshape(c, -1).any(dim=1).sum()))
    nbytes = 2 * 3 * c * rows * w + 4 * cands.numel() + 22 * changed.numel() + prev_bytes
    return nbytes, (ANALYSIS_OPS_PIXEL * c * rows * w + SEARCH_OPS_TEST * tested
                    + rejected_in + matched_px)


def hold_analysis(record, entry, args, label, smi):
    """K5 (kernels.analyze_blocks_streams_kernel) against its plain version
    (blocks.analyze_blocks_streams_plain) on these inputs (frames, prevs,
    cands, row0, nby) on the card, both timed by CUDA events; changed,
    rects, choice and flat must be equal. record: the row to add it to
    (None: a check only). Returns (kernel ms, plain ms)."""
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import kernels as tk

    frames, prevs, cands, row0, nby = args
    ms, got = cuda_ms(lambda: tk.analyze_blocks_streams_kernel(*args), TIMED_REPS)
    plain_ms, want = cuda_ms(lambda: tb.analyze_blocks_streams_plain(*args), 1, False)
    err = max_abs_err([(g.cpu().numpy().astype(np.int64), wt.cpu().numpy().astype(np.int64))
                       for g, wt in zip(got, want)])
    work = analysis_work(frames, cands, row0, nby, got)
    if record is not None:
        record(entry, ms, plain_ms, err, work)
    elif err:
        raise AssertionError(f"K5 {label}: kernel differs from plain (max |err| {err})")
    bms, by = bound(*work)
    c, h, w, _ = frames.shape
    print(f"K5 {label}: {c} x {w}x{h}, block rows {row0}-{row0 + nby}, "
          f"{int(got[0].sum())} changed blocks, {int((got[2] < cands.shape[0]).sum())} matched, "
          f"{int(got[3].sum())} flat, {cands.shape[0]} candidates: kernel {ms:.3f} ms, bound "
          f"{bms:.4f} ms ({by}, reach {bms / ms:.3f}), plain {plain_ms:.1f} ms, equal, on {smi}")
    return ms, plain_ms


def noise_search(dev, smi, cfg, rng):
    """K5 on a noise frame against a noise prev (every block changed, none
    matching: every candidate of every block tested) at 1080p, its choices
    all "none" and equal to the plain version's on the first block row;
    the plain version against K5 on the whole 360x640 noise pair."""
    import torch

    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import kernels as tk
    from screenpressor_tpu_torch.config import CodecConfig

    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev).reshape(-1, 2)
    pair = torch.as_tensor(rng.integers(0, 256, (2, 1, cfg.height, cfg.width, 3),
                                        dtype=np.uint8), device=dev)
    args = (pair[1], pair[0], cands, 0, cfg.nby)
    ms, got = cuda_ms(lambda: tk.analyze_blocks_streams_kernel(*args), TIMED_REPS)
    if not (bool(got[0].all()) and bool((got[2] == cands.shape[0]).all())):
        raise AssertionError("K5 noise 1080p: a block unchanged or matched")
    hold_analysis(None, None, (pair[1], pair[0], cands, 0, 1), "noise 1080p, first block row",
                  smi)
    bms, by = bound(*analysis_work(pair[1], cands, 0, cfg.nby, got))
    print(f"K5 noise 1080p: {got[0].numel()} changed blocks, none matched, "
          f"{cands.shape[0]} candidates each: kernel {ms:.3f} ms, bound {bms:.4f} ms ({by}); "
          f"the first block row equal to plain, on {smi}")
    small = CodecConfig(width=S_W, height=S_H, msr_x=256, msr_y=256)
    pair = torch.as_tensor(rng.integers(0, 256, (2, 1, S_H, S_W, 3), dtype=np.uint8),
                           device=dev)
    hold_analysis(None, None, (pair[1], pair[0], cands, 0, small.nby), "noise 360x640", smi)


def batch_encode_front(t0, dev, smi, record, frames, cfg):
    """Phase 6c on the single stream: the analysis of the 1080p batch's 63 P
    frames in one analyze_compact_streams call, as TorchEncoder.encode_batch
    makes it, against its P frames one by one (analyze_compact); counts and
    records must be equal."""
    import torch

    from screenpressor_tpu_torch import blocks as tb

    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev).reshape(-1, 2)
    dev_frames = torch.as_tensor(np.stack(frames), device=dev)
    # two tensors, as encode_batch's torch.stack makes them (views of one
    # tensor would share their bytes in L2)
    fr, pv = dev_frames[1:].clone(), dev_frames[:-1].clone()
    ms, (arrs, counts, _flat) = cuda_ms(lambda: tb.analyze_compact_streams(fr, pv, cands, cfg),
                                        TIMED_REPS)
    _, syncs = count_syncs(lambda: tb.analyze_compact_streams(fr, pv, cands, cfg))
    search_ms, search_plain_ms = hold_analysis(record, "sptc_analyze_blocks",
                                               (fr, pv, cands, 0, cfg.nby), "1080p batch", smi)
    noise_search(dev, smi, cfg, np.random.default_rng(13))
    loop_ms, ana = cuda_ms(lambda: [tb.analyze_compact(fr[j], pv[j], cands, cfg)
                                    for j in range(fr.shape[0])], 1)
    _, loop_syncs = count_syncs(lambda: [tb.analyze_compact(fr[j], pv[j], cands, cfg)
                                         for j in range(fr.shape[0])])
    ch = counts.cpu().numpy()
    for j, (one, c1, _) in enumerate(ana):
        n = {"bt": ch[j, 3], "sxy": ch[j, 4], "mv": ch[j, 5], "data_rects": ch[j, 6]}
        if not torch.equal(counts[j], c1) or (
                ch[j, 0] and any(not torch.equal(arrs[nm][j, :n[nm]], one[nm][:n[nm]])
                                 for nm in n)):
            raise AssertionError(f"1080p batch analysis, P frame {j + 1}: differs from "
                                 "its analysis alone")
    print(f"1080p batch analysis: {fr.shape[0]} P frames, {int(ch[:, 6].sum())} data and "
          f"{int(ch[:, 5].sum())} motion blocks: one call {ms:.3f} ms (CUDA events), "
          f"{syncs} host syncs, of which K5 (change map, sub-rects, flat flags, motion search) "
          f"{search_ms:.3f} ms (plain "
          f"{search_plain_ms:.1f} ms); frame by frame {loop_ms:.3f} ms, {loop_syncs} host "
          f"syncs; counts and records equal, on {smi}")
    phase("1080p batch analysis", t0)


def serving_encode_front(t0, dev, smi, record, cfg, offsets, batches):
    """Phase 6c: the stream-batched P encode front half on the serving
    session's steps, as BatchedEncoder runs it (one analyze_compact_streams
    call over the step's P streams, the pull of their counts, one
    classify_assemble_streams call over their data blocks), against the
    per-stream loop (analyze_compact, then classify_assemble and the
    touched-row bitmap, stream by stream); both timed by CUDA events and by
    the synchronised host clock, their host syncs counted; the results must
    be equal. K3 on the data-block walk of each step's classification (one
    launch over every P stream's data blocks) against its plain version."""
    import torch

    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch.config import NUM_PTYPES

    cands = torch.tensor(tb.mv_candidates(cfg), dtype=torch.int32, device=dev).reshape(-1, 2)
    for t in range(1, len(batches)):
        own = np.nonzero((t + offsets) % S_KF != 0)[0]
        own_t = torch.as_tensor(own, device=dev)
        fr, pv = batches[t][own_t], batches[t - 1][own_t]

        def batched():
            arrs, counts, flat = tb.analyze_compact_streams(fr, pv, cands, cfg)
            ch = torch.cat([counts, flat], dim=1).cpu().numpy()
            n_data = np.where((ch[:, 0] != 0) & (ch[:, 7] == 0), ch[:, 6], 0)
            cls = (tp.classify_assemble_streams(fr, pv, arrs["data_rects"], n_data)
                   if n_data.any() else None)
            return arrs, ch, n_data, cls

        def loop():
            ana = [tb.analyze_compact(fr[j], pv[j], cands, cfg) for j in range(len(own))]
            ch = torch.stack([torch.cat([c, f]) for _, c, f in ana]).cpu().numpy()
            n_data = np.where((ch[:, 0] != 0) & (ch[:, 7] == 0), ch[:, 6], 0)
            cls = {}
            for j in np.nonzero(n_data)[0]:
                pix, lit, pl = tp.classify_assemble(fr[j], pv[j], ana[j][0]["data_rects"],
                                                    int(n_data[j]))
                cls[j] = (pix, lit, pl, tc.color_touched_bitmap(lit, pl[1]))
            return ana, ch, cls

        ms, (arrs, ch, n_data, cls) = cuda_ms(batched, TIMED_REPS)
        hms, _ = host_ms(batched, TIMED_REPS)
        _, syncs = count_syncs(batched)
        _, a_syncs = count_syncs(lambda: tb.analyze_compact_streams(fr, pv, cands, cfg))
        search_ms, search_plain_ms = hold_analysis(
            record, "sptc_analyze_blocks_streams", (fr, pv, cands, 0, cfg.nby),
            f"serving step {t}", smi)
        _build.reset_counts()
        batched()
        walks = _build.LAUNCHES["sptc_run_walk"]
        loop_ms, (ana, ch_l, cls_l) = cuda_ms(loop, 1)
        loop_hms, _ = host_ms(loop, 1)
        _, loop_syncs = count_syncs(loop)
        if not np.array_equal(ch, ch_l):
            raise AssertionError(f"P encode front, step {t}: counts differ from the loop")
        for j in range(len(own)):
            n = {"bt": ch[j, 3], "sxy": ch[j, 4], "mv": ch[j, 5], "data_rects": ch[j, 6]}
            if ch[j, 0] and any(not torch.equal(arrs[nm][j, :n[nm]], ana[j][0][nm][:n[nm]])
                                for nm in n):
                raise AssertionError(f"P encode front, step {t} stream {own[j]}: records "
                                     "differ from the loop")
        if cls is not None:
            pix, lit, counts, bm, off = cls
            for j, (p1, l1, c1, bm1) in cls_l.items():
                n_pix, n_lit = (int(v) for v in c1.cpu())
                if not (torch.equal(counts[j, :2], c1) and torch.equal(bm[j], bm1)
                        and torch.equal(pix[off[j]:off[j] + n_pix], p1[:n_pix])
                        and torch.equal(lit[off[j]:off[j] + n_lit], l1[:n_lit])):
                    raise AssertionError(f"P encode front, step {t} stream {own[j]}: "
                                         "classification differs from the loop")
        elif cls_l:
            raise AssertionError(f"P encode front, step {t}: the loop classified blocks")
        walk = ""
        if n_data.any():  # K3 on the step's data-block walk, the inputs K3 gets
            nbp = arrs["data_rects"].shape[1]
            boff = np.cumsum(n_data) - n_data
            blk = torch.as_tensor(np.repeat(np.arange(len(own)) * nbp - boff, n_data)
                                  + np.arange(int(n_data.sum())), device=dev)
            rects, bsid = arrs["data_rects"].reshape(-1, 4)[blk], blk // nbp
            bfits, bst, _, _ = tp._block_fits(tp._windows_streams(fr, rects, bsid),
                                              tp._windows_streams(pv, rects, bsid), rects)
            wbits, wst = tcl.fits_bits(bfits.reshape(-1, NUM_PTYPES)), bst.reshape(-1)
            kms, got = cuda_ms(lambda: tcl.run_walk(wbits, wst, tp.AREA), TIMED_REPS)
            plain_ms, ref = cuda_ms(lambda: tcl.run_walk_plain(wbits, wst, tp.AREA), 1, False)
            record("sptc_run_walk_streams", kms, plain_ms,
                   max_abs_err([(got.cpu().numpy(), ref.cpu().numpy())]), walk_work(wbits, got))
            walk = (f"; K3 over its {rects.shape[0]} data blocks x tile {tp.AREA}: kernel "
                    f"{kms:.3f} ms, plain {plain_ms:.1f} ms, equal")
        print(f"P encode front, step {t}: {len(own)} P streams, "
              f"{int((ch[:, 0] != 0).sum())} changed, {int(ch[:, 5].sum())} motion and "
              f"{int(n_data.sum())} data blocks: stream-batched {ms:.3f} ms (CUDA events), "
              f"{hms:.3f} ms (host, synchronised), {syncs} host syncs, {walks} K3 "
              f"launches, of which the analysis {a_syncs} host syncs and K5 "
              f"{search_ms:.3f} ms (plain {search_plain_ms:.1f} ms); per-stream loop "
              f"{loop_ms:.3f} ms, {loop_hms:.3f} ms, {loop_syncs} host syncs; counts, "
              f"records and classification equal{walk}, "
              f"on {smi}")
    phase("serving P encode front half", t0)


def damaged_streams(t0, dev, smi):
    """Phase 7: the damaged payloads of tests/test_torch_corrupt.py decoded
    on the card and on the CPU; the verdicts must agree, nothing but
    CorruptStreamError may be raised, and a clean stream must decode after
    them in this process (a device-side assert would end it)."""
    import torch

    from screenpressor_tpu_torch import TorchDecoder
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.parallel import serving as ts
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import corrupt_payloads, damaged_serving_steps  # would shadow ROOT/tests

    cfg, frames, payloads, damaged = corrupt_payloads()

    def verdict(device, i, data):
        dec = TorchDecoder(cfg, device)
        dec.decode_batch(payloads[:i])
        try:
            return "ok", np.asarray(dec.decode_batch([data])[0])
        except bs.CorruptStreamError:
            return "corrupt", None

    n_bad = 0
    for c, (i, data) in enumerate(damaged):
        (got, frame), (want, ref) = verdict(dev, i, data), verdict("cpu", i, data)
        if got != want or (got == "ok" and not np.array_equal(frame, ref)):
            raise AssertionError(f"damaged payload {c}: card {got}, CPU {want}")
        n_bad += got == "corrupt"
    torch.cuda.synchronize()
    for f, o in zip(frames, TorchDecoder(cfg, dev).decode_batch(payloads)):
        if not np.array_equal(o, f):
            raise AssertionError("a clean stream after the damaged ones is not lossless")
    print(f"damaged streams: {len(damaged)} payloads, {n_bad} raised CorruptStreamError on the "
          f"card as on the CPU, the rest decoded equal; a clean stream then decoded losslessly "
          f"on {smi}")

    # one damaged stream among clean ones in a BatchedDecoder step
    cfg, steps, _, cases = damaged_serving_steps(dev)
    bad = 1

    def step_verdict(device, i, data):
        """(verdict or message, the step's frames) of step i with stream
        bad's payload replaced by data, after the clean steps before it."""
        dec = ts.BatchedDecoder(len(steps[0]), cfg, device)
        for step in steps[:i]:
            dec.decode(step)
        payloads = list(steps[i])
        payloads[bad] = data
        try:
            out = dec.decode(payloads, device_out=True)
        except bs.CorruptStreamError as e:
            return str(e), None
        try:
            dec.validate()
        except bs.CorruptStreamError as e:
            return str(e), out.cpu().numpy()
        return "ok", out.cpu().numpy()

    clean = {}
    n_err_word = 0
    for c, (i, data) in enumerate(cases):
        if i not in clean:
            clean[i] = step_verdict(dev, i, steps[i][bad])[1]
        (got, frames), (want, ref) = step_verdict(dev, i, data), step_verdict("cpu", i, data)
        if got != want:
            raise AssertionError(f"serving damaged case {c}: card {got!r}, CPU {want!r}")
        if frames is not None:
            others = [j for j in range(len(steps[0])) if j != bad]
            if not np.array_equal(frames[others], clean[i][others]):
                raise AssertionError(f"serving damaged case {c}: a clean stream's frame "
                                     "changed beside the damaged stream")
            if got == "ok" and not np.array_equal(frames, ref):
                raise AssertionError(f"serving damaged case {c}: card frames differ from CPU")
            n_err_word += got != "ok"
    torch.cuda.synchronize()
    if not n_err_word:
        raise AssertionError("no serving damaged case reached the device error word")
    print(f"damaged stream among clean streams: {len(cases)} payloads in stream {bad} of "
          f"{len(steps[0])}, each step's verdict equal to the CPU port's ({n_err_word} through "
          f"the device error word), the clean streams' frames equal their clean decode, on {smi}")
    phase("damaged streams", t0)


def session_api(t0, dev, smi, frames, cfg, pinned, rgb24_rates):
    """Phase 8: the session API on the main path's 64 1080p frames as RGB32
    and as RGB16 565, host and device frames. rgb24_rates: phase 4's
    (encode, decode) Mpix/s per session."""
    import torch

    from screenpressor_tpu_torch import (
        Decoder, Encoder, FormatParams, PixelFormat, TorchEncoder, _build)
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch import colorspace as cs

    masks = (0xF800, 0x07E0, 0x001F)
    rng = np.random.default_rng(8)
    f32 = [np.dstack([f, rng.integers(0, 256, f.shape[:2], dtype=np.uint8)]) for f in frames]
    f16 = [cs.rgb24_to_rgb16(f >> np.array([3, 2, 3], np.uint8), *masks) for f in frames]
    fmt32 = FormatParams(pixel_format=PixelFormat.RGB32)
    fmt16 = FormatParams(PixelFormat.RGB16, *masks)
    d32 = [torch.as_tensor(f, device=dev) for f in f32]
    d16 = [torch.as_tensor(f, device=dev) for f in f16]

    def timed(fn, arg):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn(arg)
        torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    # ---- 8. the session API, counted from a reset ----
    encs = [Encoder(cfg, fmt, dev) for fmt in (fmt32, fmt32, fmt16, fmt16)]
    dec32, dec16 = Decoder(cfg, device=dev), Decoder(cfg, device=dev)
    _build.reset_counts()
    p32h, te32h = timed(encs[0].encode_batch, f32)
    p32d, te32d = timed(encs[1].encode_batch, d32)
    out32, td32 = timed(dec32.decode_batch, [p for p, _ in p32h])
    p16d, te16d = timed(encs[2].encode_batch, d16)
    p16h, te16h = timed(encs[3].encode_batch, f16)
    out16, td16 = timed(dec16.decode_batch, [p for p, _ in p16d])
    launches = dict(_build.LAUNCHES)
    print(f"session API launches: {launches}")
    single = ("sptc_sections_encode", "sptc_sections_encode_colw", "sptc_sections_decode",
              "sptc_run_walk", "sptc_recon_rows", "sptc_analyze_blocks",
              "sptc_rebuild_blocks", "sptc_resolve_blocks", "sptc_rgb32_to_rgb24",
              "sptc_rgb24_to_rgb32")
    missing = [k for k in single if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the session API: {missing}")
    # K7: one launch a batch and direction (host and device RGB32 frames
    # in, the RGB32 decode out)
    if (launches["sptc_rgb32_to_rgb24"], launches["sptc_rgb24_to_rgb32"]) != (2, 1):
        raise AssertionError(f"K7 launches {launches}: 2 encode batches and 1 decode expected")
    phase("session API", t0)

    if p32d != p32h:
        raise AssertionError("RGB32: device-frame bytes differ from host-frame bytes")
    pre32 = bs.pack_format_prefix(32)
    for i, ((p, ft), want) in enumerate(zip(p32h, pinned["frames"], strict=True)):
        if ft == 0:
            if not p.startswith(pre32):
                raise AssertionError(f"RGB32 keyframe {i} lacks the format prefix")
            p = p[len(pre32):]
        got = {"size": len(p), "ftype": ft, "sha256": hashlib.sha256(p).hexdigest()}
        if got != want:
            raise AssertionError(f"RGB32 frame {i}: bytes without the prefix {got} != "
                                 f"native {want}")
    if dec32.fmt != fmt32:
        raise AssertionError(f"the default Decoder did not configure itself: {dec32.fmt}")
    for i, (o, f) in enumerate(zip(out32, frames, strict=True)):
        if o.shape != (H, W, 4) or not np.array_equal(o[..., :3], f) or (o[..., 3] != 255).any():
            raise AssertionError(f"RGB32 frame {i}: decode not lossless with alpha 255")
    print(f"RGB32: host and device frames equal; keyframes carry the prefix; without it "
          f"{len(p32h)} of {len(frames)} frames equal the pinned native digests; a default "
          f"Decoder configured itself to RGB32 and decoded losslessly, alpha 255")

    if p16d != p16h:
        raise AssertionError("RGB16: device-frame bytes differ from host-frame bytes")
    i16 = [cs.rgb16_to_rgb24(f, *masks) for f in f16]
    plain = TorchEncoder(cfg, dev).encode_batch(i16)
    pre16 = bs.pack_format_prefix(16, *masks)
    if p16h != [(pre16 + p if ft == 0 else p, ft) for p, ft in plain]:
        raise AssertionError("RGB16: bytes differ from TorchEncoder over rgb16_to_rgb24")
    if dec16.fmt != fmt16:
        raise AssertionError(f"the default Decoder did not configure itself: {dec16.fmt}")
    for i, (o, f) in enumerate(zip(out16, f16, strict=True)):
        if o.dtype != np.uint16 or not np.array_equal(o, f):
            raise AssertionError(f"RGB16 frame {i}: decode is not the uint16 frame")
    print("RGB16 565: device frames, host frames and TorchEncoder over rgb16_to_rgb24 "
          "equal; decoded back to the uint16 frames")
    phase("session API byte checks", t0)

    mpix = H * W * len(frames) / 1e6
    for tag, te_h, te_d, td_ in (("RGB32", te32h, te32d, td32), ("RGB16 565", te16h, te16d, td16)):
        print(f"session API {tag}: encode host frames {mpix / te_h:.3f} Mpix/s ({te_h:.3f} s), "
              f"device frames {mpix / te_d:.3f} Mpix/s ({te_d:.3f} s), decode "
              f"{mpix / td_:.3f} Mpix/s ({td_:.3f} s) for {len(frames)} frames at {W}x{H} "
              f"on {smi}")
    print("beside phase 4's RGB24 session: " + "; ".join(
        f"encode {e:.3f}, decode {d:.3f} Mpix/s" for e, d in rgb24_rates) + f" on {smi}")

    # where the API's time goes beside phase 4 (after the counted run)
    conv = []
    for tag, fn, src in (("rgb32_to_rgb24", cs.rgb32_to_rgb24, f32),
                         ("rgb24_to_rgb32", cs.rgb24_to_rgb32, frames),
                         ("rgb16_to_rgb24", lambda f: cs.rgb16_to_rgb24(f, *masks), f16),
                         ("rgb24_to_rgb16", lambda f: cs.rgb24_to_rgb16(f, *masks), i16)):
        ts = time.perf_counter()
        for f in src:
            fn(f)
        conv.append(f"{tag} {time.perf_counter() - ts:.3f} s")
    print(f"host numpy conversions over {len(frames)} frames: {', '.join(conv)}")
    d24 = [torch.as_tensor(f, device=dev) for f in frames]
    di16 = [torch.as_tensor(f, device=dev) for f in i16]
    conv = []
    for tag, fn, src in (
            ("rgb32_to_rgb24 (with the session's contiguous copy)",
             lambda f: cs.rgb32_to_rgb24_device(f).contiguous(), d32),
            ("rgb24_to_rgb32", cs.rgb24_to_rgb32_device, d24),
            ("rgb16_to_rgb24", lambda f: cs.rgb16_to_rgb24_device(f, *masks), d16),
            ("rgb24_to_rgb16", lambda f: cs.rgb24_to_rgb16_device(f, *masks), di16)):
        ms, _ = cuda_ms(lambda fn=fn, src=src: [fn(f) for f in src], 3)
        conv.append(f"{tag} {ms:.3f} ms")
    print(f"torch conversions on the card over {len(frames)} frames (CUDA events, mean of 3): "
          f"{', '.join(conv)} on {smi}")
    # K7 at the main path's shapes: the 64 frames one way and back, 7 B a
    # pixel moved. The kernel: its C launches alone on outputs made and
    # frame pointers uploaded beforehand, device time from a CUDA graph
    # (graph_ms); the wrapper (outputs made and pointers uploaded a call):
    # CUDA events over 20 queued calls after a warm-up.
    batch32 = torch.stack(d32)
    outs24 = [torch.empty_like(f) for f in d24]
    out32 = torch.empty_like(batch32)
    ptrs24 = torch.tensor([f.data_ptr() for f in outs24], dtype=torch.int64, device=dev)
    ptrs_in = torch.tensor([f.data_ptr() for f in d24], dtype=torch.int64, device=dev)
    n = len(frames)
    k7 = []
    for tag, launch, wrapper in (
            ("rgb32_to_rgb24",
             lambda: _build.launch("sptc_rgb32_to_rgb24", batch32.data_ptr(), ptrs24.data_ptr(),
                                   H * W, n, device=dev),
             lambda: cs.rgb32_to_rgb24_batch(batch32)),
            ("rgb24_to_rgb32",
             lambda: _build.launch("sptc_rgb24_to_rgb32", ptrs_in.data_ptr(), out32.data_ptr(),
                                   H * W, n, device=dev),
             lambda: cs.rgb24_to_rgb32_batch(d24))):
        ms = graph_ms(launch, 5)
        wms, _ = cuda_ms(wrapper, 20)
        bms, by = bound(7 * H * W * n, 0)
        k7.append(f"{tag} {ms:.4f} ms (bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f} % of "
                  f"it; wrapper {wms:.4f} ms)")
    if not all(torch.equal(a, b) for a, b in zip(outs24, cs.rgb32_to_rgb24_batch(batch32))):
        raise AssertionError("K7 rgb32_to_rgb24: the timed launches' frames differ")
    if not torch.equal(out32, cs.rgb24_to_rgb32_batch(d24)):
        raise AssertionError("K7 rgb24_to_rgb32: the timed launches' batch differs")
    print(f"K7 over {n} frames at {W}x{H}: {'; '.join(k7)} on {smi}")
    del batch32, outs24, out32
    enc24, dec24 = Encoder(cfg, device=dev), Decoder(cfg, device=dev)
    p24, te24 = timed(enc24.encode_batch, frames)
    _, td24 = timed(dec24.decode_batch, [p for p, _ in p24])
    _, td24d = timed(lambda d: Decoder(cfg, device=dev).decode_batch(d, device_out=True),
                     [p for p, _ in p24])
    print(f"session API RGB24: encode host frames {mpix / te24:.3f} Mpix/s ({te24:.3f} s), "
          f"decode to host frames {mpix / td24:.3f} Mpix/s ({td24:.3f} s), to device frames "
          f"{mpix / td24d:.3f} Mpix/s ({td24d:.3f} s) on {smi}")


def check_digests(payloads, pinned, label):
    for i, ((p, ft), want) in enumerate(zip(payloads, pinned["frames"], strict=True)):
        got = {"size": len(p), "ftype": ft, "sha256": hashlib.sha256(p).hexdigest()}
        if got != want:
            raise AssertionError(f"{label} frame {i}: port bytes {got} != native {want}")


def sp_mesh(t0, dev, smi, record, frames_1080, cfg_1080, pinned_1080):
    """Phase 9: one large stream row-sharded over a mesh whose shards share
    the one card. Returns the launch counts of its counted run."""
    import torch

    from screenpressor_tpu_torch import TorchDecoder, TorchEncoder, _build
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import recon as tr
    from screenpressor_tpu_torch.config import NUM_PTYPES, CodecConfig, seg_tile
    from screenpressor_tpu_torch.parallel import mesh as tm
    from screenpressor_tpu_torch.synth import synth_screencast

    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import (rebuild_calls, sp_decode, sp_encode,  # would shadow ROOT/tests
                               sp_stage_ms)

    # ---- 9. the sp mesh ----
    with open(NATIVE_DIGESTS_4K) as fh:
        pinned = json.load(fh)
    if (pinned["height"], pinned["width"], pinned["n_frames"]) != (SP_H, SP_W, SP_N):
        raise AssertionError("pinned 4K digests are for another workload")
    frames = synth_screencast(SP_H, SP_W, SP_N)
    cfg = CodecConfig(width=SP_W, height=SP_H)
    card = torch.device("cuda", torch.cuda.current_device())
    meshes = {sp: tm.make_mesh(sp, sp=sp, devices=[card] * sp) for sp in (1, 2, 4)}
    for sp, mesh in meshes.items():
        print(f"sp mesh {sp}: devices=[{card}] * {sp} (the shards share the one card)")
    mpix = SP_H * SP_W * SP_N / 1e6

    def session(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # the unsharded session on the card: the bytes every sp session must give
    session(TorchEncoder(cfg, dev).encode_batch, frames)
    ref, t_ref = session(TorchEncoder(cfg, dev).encode_batch, frames)
    check_digests(ref, pinned, "4K unsharded")
    session(TorchDecoder(cfg, dev).decode_batch, [p for p, _ in ref], True)
    dref, t_dref = session(TorchDecoder(cfg, dev).decode_batch, [p for p, _ in ref], True)
    print(f"4K unsharded session: bytes {[len(p) for p, _ in ref]} equal the pinned native "
          f"digests; encode {mpix / t_ref:.3f} Mpix/s ({t_ref:.3f} s), decode "
          f"{mpix / t_dref:.3f} Mpix/s ({t_dref:.3f} s) on {smi}")

    # a first sp session (not counted), its keyframe's sections captured
    captured = []
    real = tc.encode_sections

    def capture_sections(dealt_list, lens_list, tables, kts, col_w=None, col_bm=None):
        captured.append((list(dealt_list), list(lens_list), tables, kts))
        return real(dealt_list, lens_list, tables, kts, col_w, col_bm)

    tc.encode_sections = capture_sections
    try:
        sp_encode(frames[:1], meshes[4], cfg)
    finally:
        tc.encode_sections = real
    sp_encode(frames, meshes[4], cfg)

    # the counted run: the 8 frames at sp 1, 2 and 4, encode and decode;
    # its first motion search and every block rebuild captured
    searches, rebuilds = {}, []
    _build.reset_counts()
    timed = {}
    with capture(tm, "analyze_blocks_streams", searches, "K5 sp"), rebuild_calls(rebuilds):
        for sp, mesh in meshes.items():
            got, t_enc = session(sp_encode, frames, mesh, cfg)
            dec, t_dec = session(sp_decode, got, mesh, cfg)
            timed[sp] = (got, t_enc, dec, t_dec)
    launches = dict(_build.LAUNCHES)
    print(f"sp path launches (8 4K frames at sp 1, 2 and 4, encode and decode): {launches}")
    missing = [k for k in ("sptc_sections_encode", "sptc_sections_decode", "sptc_run_walk",
                           "sptc_recon_rows", "sptc_analyze_blocks",
                           "sptc_rebuild_blocks") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sp path: {missing}")
    for sp, (got, t_enc, dec, t_dec) in timed.items():
        if got != ref:
            raise AssertionError(f"sp {sp}: bytes differ from the unsharded session")
        check_digests(got, pinned, f"4K sp {sp}")
        for i, (f, o) in enumerate(zip(frames, dec)):
            if not torch.equal(o, torch.as_tensor(f, device=dev)):
                raise AssertionError(f"sp {sp} frame {i}: decode is not lossless")
        print(f"4K sp {sp}: 8 frames equal the unsharded session and the pinned native "
              f"digests, decode lossless; encode {mpix / t_enc:.3f} Mpix/s ({t_enc:.3f} s; "
              f"unsharded {mpix / t_ref:.3f}), decode {mpix / t_dec:.3f} Mpix/s "
              f"({t_dec:.3f} s; unsharded {mpix / t_dref:.3f}) on {smi}")
    # the time per stage: a session and its decode under torch.profiler
    # (not counted), each labelled range's device time
    for sp, mesh in meshes.items():
        _, st = sp_stage_ms(lambda: sp_decode(sp_encode(frames, mesh, cfg), mesh, cfg))
        stages = ", ".join(f"{k} {v:.3f} ms ({mpix / v * 1e3:.1f} Mpix/s)" if v > 0
                           else f"{k} not measured" for k, v in st.items())
        print(f"4K sp {sp} stages (device time under torch.profiler, 8 frames; Mpix/s: the "
              f"session's pixels over the stage's time): {stages}")
    phase("sp mesh 4K sessions", t0)

    # the sp path's kernels against their plain versions at its 4K shapes:
    # K3 on a middle shard's walk (sp 4), K1 / K2 on the keyframe's rec and
    # col sections as the sp path deals them, K4 on the keyframe
    kf = torch.as_tensor(frames[0], device=dev)
    r0, r1 = tm.i_seams(SP_H, SP_W, 4)[1]
    fits = tm._halo_fits(kf[r0:r1].int(), kf[r0 - 1].int()).reshape(-1, NUM_PTYPES)
    st, bits = tcl.start_types_i(fits), tcl.fits_bits(fits)
    tile = seg_tile(SP_H * SP_W, SP_W)
    ms, got = cuda_ms(lambda: tcl.run_walk(bits, st, tile), TIMED_REPS)
    plain_ms, want = cuda_ms(lambda: tcl.run_walk_plain(bits, st, tile), 1, False)
    record("sptc_run_walk_sp", ms, plain_ms, max_abs_err([(got.cpu(), want.cpu())]),
           walk_work(bits, got))
    print(f"K3 sp shard 1 of 4 (rows {r0}-{r1}, n={bits.numel()}, tile {tile}): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, equal, on {smi}")
    dealt_l, lens_l, tabs, kts = captured[0]
    for dealt, lens, kt in zip(dealt_l, lens_l, kts):
        nm, k, t = kt
        ms, (bufs, starts, tab_k) = cuda_ms(
            lambda: tc.encode_sections([dealt], [lens], tabs, (kt,)), TIMED_REPS)

        def plain_encode():
            cum, freq, act, tab = tc.model_scan(dealt, lens, tabs, nm)
            return tc.rans_pack(cum, freq, act, tc.pack_cap(nm, t)), tab

        plain_ms, ((buf_p, start_p), tab_p) = cuda_ms(plain_encode, 1, False)
        lens_np = lens.cpu().numpy()
        blobs = tc.blobs_from_buf(bufs[0].cpu().numpy(), starts[0].cpu().numpy(), lens_np)
        blobs_p = tc.blobs_from_buf(buf_p.cpu().numpy(), start_p.cpu().numpy(), lens_np)
        if blobs != blobs_p:
            raise AssertionError(f"K1 4K keyframe {nm} (K {k}): bytes differ from plain")
        err = max_abs_err([(starts[0].cpu().numpy(), start_p.cpu().numpy())]
                          + tables_pairs(tab_k, tab_p))
        record("sptc_sections_encode_sp", ms, plain_ms, err,
               sections_work((kt,), [dealt], [lens], sum(map(len, blobs))))
        pay = torch.as_tensor(tc.pad_payload(blobs, k), device=dev)
        dms, (recs, dtab_k) = cuda_ms(lambda: tc.decode_sections([pay], [lens], tabs, (kt,)),
                                      TIMED_REPS)
        dplain_ms, (rec_p, dtab_p) = cuda_ms(
            lambda: tc.decode_section_scan(pay, lens, tabs, nm, t), 1, False)
        valid = (torch.arange(t, device=dev)[:, None] < lens[None, :])[..., None]
        derr = max_abs_err([(recs[0].cpu().numpy(), rec_p.cpu().numpy()),
                            (torch.where(valid, recs[0], 0).cpu().numpy(),
                             torch.where(valid, dealt, 0).cpu().numpy())]
                           + tables_pairs(dtab_k, dtab_p) + tables_pairs(dtab_k, tab_k))
        record("sptc_sections_decode_sp", dms, dplain_ms, derr,
               sections_work((kt,), [recs[0]], [lens], pay.numel()))
        print(f"K1/K2 4K keyframe {nm}: K {k}, T {t}, {sum(map(len, blobs))} bytes: encode "
              f"{ms:.3f} ms (plain {plain_ms:.1f} ms), decode {dms:.3f} ms (plain "
              f"{dplain_ms:.1f} ms), bytes, records and tables equal, on {smi}")
    records, n_rec, lits, n_lit = tcl.classify_i(kf)
    ms, whole_ms, k4_rows, got = recon_timings(tr, records[:int(n_rec)],
                                               lits[:max(int(n_lit), 1)], SP_H, SP_W,
                                               TIMED_REPS)
    plain_ms, want = cuda_ms(lambda: tr.recon_rows_plain(k4_rows, SP_W), 1, False)
    record("sptc_recon_rows_sp", ms, plain_ms,
           max_abs_err([(got.cpu().numpy(), want.cpu().numpy()),
                        (got.cpu().numpy(), frames[0])]), recon_work(k4_rows, got))
    print(f"K4 4K keyframe: kernel {ms:.3f} ms, reconstruct_i {whole_ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, equal, equals the keyframe, on {smi}")
    hold_analysis(record, "sptc_analyze_blocks_sp", searches.pop("K5 sp")[0],
                "sp path, 4K P frame 1 (sp 1)", smi)
    hold_rebuild(record, "sptc_rebuild_blocks_sp", rebuilds,
                 "sp path, the 4K P frames at sp 1, 2 and 4", smi)
    del rebuilds
    phase("sp mesh kernels vs plain", t0)

    # the 1080p session at sp 2 (uneven I seams: rows 0-544 and 544-1080)
    got, t_1080 = session(sp_encode, frames_1080, meshes[2], cfg_1080)
    check_digests(got, pinned_1080, "1080p sp 2")
    print(f"1080p sp 2 (I seams {tm.i_seams(cfg_1080.height, cfg_1080.width, 2)}): all "
          f"{len(got)} frames equal the pinned native digests; encode "
          f"{cfg_1080.width * cfg_1080.height * len(got) / 1e6 / t_1080:.3f} Mpix/s "
          f"({t_1080:.3f} s) on {smi}")
    phase("sp mesh 1080p", t0)

    # the dryrun step: 64 streams of 360x640 at dp 2 x sp 2, each stream's
    # lanes against device_encode_step alone
    from screenpressor_tpu_torch.tables import renew_tables_cached, renew_tables_streams

    base = synth_screencast(S_H, S_W, 2, seed=3)
    host = [np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(S_STREAMS)])
            for t in range(2)]
    mesh = tm.make_mesh(4, sp=2, devices=[card] * 4)
    print(f"dryrun mesh dp 2 x sp 2: devices=[{card}] * 4 (the shards share the one card)")
    tabs_b = renew_tables_streams(S_STREAMS, dev)
    (res, t_dry) = session(tm.dryrun_step, host[1], host[0], tabs_b, mesh)
    (fits, changed, flat), (buf, start, n_rec), tabs_out = res
    if fits.shape != (S_STREAMS, S_H, S_W, NUM_PTYPES) or not bool(changed.all()):
        raise AssertionError("dryrun analysis: unexpected fits shape or unchanged streams")
    for i in range(S_STREAMS):
        b1, s1, n1, t1 = tm.device_encode_step(host[1][i], renew_tables_cached(dev), S_H, S_W,
                                               8)
        if (int(n1) != int(n_rec[i])
                or tc.blobs_from_buf(b1.cpu().numpy(), s1.cpu().numpy(), np.ones(8))
                != tc.blobs_from_buf(buf[i].cpu().numpy(), start[i].cpu().numpy(),
                                     np.ones(8))):
            raise AssertionError(f"dryrun stream {i}: lanes differ from device_encode_step")
        for kd in ("ptype", "nrun"):
            for key in t1[kd]:
                if not torch.equal(t1[kd][key], tabs_out[kd][key][i]):
                    raise AssertionError(f"dryrun stream {i}: table {kd}.{key} differs")
    print(f"dryrun step, {S_STREAMS} streams of {S_H}x{S_W} at dp 2 x sp 2: {t_dry:.3f} s; "
          f"every stream's lanes, n_records and tables equal device_encode_step alone, on "
          f"{smi}")
    phase("sp mesh dryrun step", t0)
    return launches


# ---- phases 10 and 11: window serving and the dp split ----

WIN_STEPS = 17  # one per-step keyframe step, then two windows of F 8 (bench.py:339-361)


@contextlib.contextmanager
def capture(module, name, store, key, pick=lambda *a: True, tables_at=None):
    """Wrap module.name while the block runs: store[key] = (args, a copy of
    the tables argument tables_at as the call found them) of the first call
    that pick(*args) accepts."""
    real = getattr(module, name)

    def wrapped(*args, **kw):
        if key not in store and pick(*args):
            store[key] = (args, None if tables_at is None else clone_tables(args[tables_at]))
        return real(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def window_captures(store, tag):
    """The captures of K1-K6 launches on a window or split path: the first
    K1 and K2 launch over at least two streams, the first keyframe walk,
    data-block walk, K4 launch and motion search, and every block
    rebuild."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import rebuild_calls  # would shadow ROOT/tests

    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch import recon as tr

    stack = contextlib.ExitStack()
    two = lambda *a: len(a[4]) >= 2  # noqa: E731 (sidx)
    stack.enter_context(capture(tc, "encode_sections_streams", store, f"K1 {tag}", two, 2))
    stack.enter_context(capture(tc, "decode_sections_streams", store, f"K2 {tag}", two, 2))
    stack.enter_context(capture(tcl, "run_walk", store, f"K3 keyframes {tag}"))
    stack.enter_context(capture(tp, "run_walk", store, f"K3 data blocks {tag}"))
    stack.enter_context(capture(tr, "recon_rows", store, f"K4 {tag}"))
    stack.enter_context(capture(tb, "analyze_blocks_streams", store, f"K5 {tag}"))
    stack.enter_context(rebuild_calls(store.setdefault(f"K6 {tag}", [])))
    return stack


def hold_captured(record, store, tag, entries, smi, subset=2):
    """The captured K1-K6 launches of `tag` against their plain versions on
    the card: K1 / K2 over all their streams (full-table col), timed, and
    the plain version on their first `subset` streams (a stream's bytes,
    starts, records and tables do not depend on the others); K3 whole; K4
    timed whole, plain on its first `subset` frames; K5 whole; K6 on every
    captured call.
    entries: the row names for K1, K2, K3, K4, K5, K6."""
    import torch

    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import recon as tr

    def rows_err(a, b, ids):
        ids = torch.as_tensor([int(i) for i in ids], device=next(iter(b["color"].values())).device)
        return max(int((a[kd][key][ids].long() - b[kd][key][ids].long()).abs().max())
                   for kd in b for key in b[kd])

    k1, k2, k3, k4, k5, k6 = entries
    (dealt, lens, _, kts, sidx, *_), tabs0 = store[f"K1 {tag}"]
    m = min(subset, len(sidx))
    sidx = [int(i) for i in sidx]
    scratch = clone_tables(tabs0)
    ms, _ = cuda_ms(lambda: tc.encode_sections_streams(dealt, lens, scratch, kts, sidx),
                    TIMED_REPS)
    tab_k, tab_p = clone_tables(tabs0), clone_tables(tabs0)
    bufs, starts = tc.encode_sections_streams(dealt, lens, tab_k, kts, sidx)
    plain_ms, (bufs_p, starts_p) = cuda_ms(lambda: tc.encode_sections_streams_plain(
        [d[:m] for d in dealt], [ln[:m] for ln in lens], tab_p, kts, sidx[:m]), 1, False)
    err, n_bytes = rows_err(tab_k, tab_p, sidx[:m]), 0
    for i in range(len(kts)):
        for j in range(len(sidx)):
            ln = lens[i][j].cpu().numpy()
            got = tc.blobs_from_buf(bufs[i][j].cpu().numpy(), starts[i][j].cpu().numpy(), ln)
            n_bytes += sum(map(len, got))
            if j < m and got != tc.blobs_from_buf(bufs_p[i][j].cpu().numpy(),
                                                  starts_p[i][j].cpu().numpy(), ln):
                raise AssertionError(f"{k1} {kts[i][0]} stream {sidx[j]}: bytes differ")
        err = max(err, max_abs_err([(starts[i][:m].cpu().numpy(), starts_p[i].cpu().numpy())]))
    record(k1, ms, plain_ms, err, sections_work(kts, dealt, lens, n_bytes))
    print(f"{k1}: {len(sidx)} streams x {[(n, t) for n, _, t in kts]} (name, T): kernel "
          f"{ms:.3f} ms; plain on {m} of the streams {plain_ms:.1f} ms; bytes, starts, tables "
          "equal")
    del scratch, tab_k, tab_p, tabs0

    (pays, lens, _, kts, sidx), tabs0 = store[f"K2 {tag}"]
    sidx = [int(i) for i in sidx]
    m = min(subset, len(sidx))
    scratch = clone_tables(tabs0)
    ms, _ = cuda_ms(lambda: tc.decode_sections_streams(pays, lens, scratch, kts, sidx),
                    TIMED_REPS)
    tab_k, tab_p = clone_tables(tabs0), clone_tables(tabs0)
    recs = tc.decode_sections_streams(pays, lens, tab_k, kts, sidx)
    plain_ms, recs_p = cuda_ms(lambda: tc.decode_sections_streams_plain(
        [p[:m] for p in pays], [ln[:m] for ln in lens], tab_p, kts, sidx[:m]), 1, False)
    err = max(rows_err(tab_k, tab_p, sidx[:m]),
              max_abs_err([(r[:m].cpu().numpy(), rp.cpu().numpy())
                           for r, rp in zip(recs, recs_p)]))
    record(k2, ms, plain_ms, err, sections_work(kts, recs, lens, sum(p.numel() for p in pays)))
    print(f"{k2}: {len(sidx)} streams x {[(n, t) for n, _, t in kts]}: kernel {ms:.3f} ms; "
          f"plain on {m} of the streams {plain_ms:.1f} ms; records and tables equal")
    del scratch, tab_k, tab_p, tabs0

    for key in (f"K3 keyframes {tag}", f"K3 data blocks {tag}"):
        if key not in store:
            continue
        (bits, st, tile), _ = store[key]
        ms, got = cuda_ms(lambda: tcl.run_walk(bits, st, tile), TIMED_REPS)
        plain_ms, ref = cuda_ms(lambda: tcl.run_walk_plain(bits, st, tile), 1, False)
        record(k3, ms, plain_ms, max_abs_err([(got.cpu().numpy(), ref.cpu().numpy())]),
               walk_work(bits, got))
        print(f"{k3} ({key}): n={bits.numel()} tile={tile}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, equal")

    (rows, w), _ = store[f"K4 {tag}"]
    m = min(subset, rows.shape[0])
    ms, got = cuda_ms(lambda: tr.recon_rows(rows, w), TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: torch.stack([tr.recon_rows_plain(r, w) for r in rows[:m]]),
                            1, False)
    record(k4, ms, plain_ms, max_abs_err([(got[:m].cpu().numpy(), ref.cpu().numpy())]),
           recon_work(rows, got))
    print(f"{k4}: {rows.shape[0]} frames: kernel {ms:.3f} ms, plain on {m} of them "
          f"{plain_ms:.1f} ms, equal, on {smi}")

    hold_analysis(record, k5, store[f"K5 {tag}"][0], k5, smi)
    hold_rebuild(record, k6, store[f"K6 {tag}"], k6, smi)


def payload_counts(p):
    """(alg, {count: value}) of a frame's container header: an I frame's
    n_rec and n_lit, a coded P frame's n_pix, n_lit and n_data."""
    from screenpressor_tpu_torch import bitstream as bs
    from screenpressor_tpu_torch.config import ALG_I, ALG_P

    alg = p[0] & 0x0F
    if alg == ALG_I:
        (n_rec, n_lit), _ = bs.read_varint(p, 1, 2)
        return alg, {"n_rec": n_rec, "n_lit": n_lit}
    if alg == ALG_P and p[1] & 1:
        vals, _ = bs.read_varint(p, 2, 8)
        return alg, {"n_pix": vals[5], "n_lit": vals[6], "n_data": vals[7]}
    return alg, {}


def escape_causes(p, wcfg, thr):
    """The window's RAW rule (serve_scan.py's module note) applied to the
    counts and size of the sequential path's payload p of a stream-step."""
    from screenpressor_tpu_torch.config import ALG_I, ALG_P, ALG_RAW

    alg, n = payload_counts(p)
    if alg == ALG_RAW:
        return ["size (also sequential)"]
    causes = []
    if alg == ALG_I:
        causes += [c for c, hit in (("irec_cap", n["n_rec"] > wcfg.irec_cap),
                                    ("icol_cap", n["n_lit"] > wcfg.icol_cap)) if hit]
    elif alg == ALG_P and n:
        causes += [c for c, hit in (("bcap", n["n_data"] > wcfg.bcap),
                                    ("rec_cap", n["n_pix"] > wcfg.rec_cap),
                                    ("col_cap", n["n_lit"] > wcfg.col_cap)) if hit]
    else:
        return []
    if len(p) >= thr:
        causes.append("size")
    if len(p) > wcfg.pack_cap:
        causes.append("pack_cap")
    return causes


def no_escape_caps(ss, cfg, n_streams, steps, f, c):
    """A WindowConfig whose capacities hold every stream-step of `steps`
    (the sequential path's payloads): no stream-step escapes."""
    from screenpressor_tpu_torch.config import ALG_I

    need = {"n_pix": 1, "n_lit_p": 1, "n_data": 1, "n_rec": 1, "n_lit_i": 1}
    longest = 1
    for outs in steps:
        for p, _ in outs:
            alg, n = payload_counts(p)
            longest = max(longest, len(p))
            for key, v in n.items():
                key = key + ("_i" if alg == ALG_I else "_p") if key == "n_lit" else key
                need[key] = max(need[key], v)
    return ss.WindowConfig(cfg, n_streams, f=f, c=c, rec_cap=next_pow2_(need["n_pix"]),
                           col_cap=next_pow2_(need["n_lit_p"]), bcap=next_pow2_(need["n_data"]),
                           irec_cap=next_pow2_(need["n_rec"]), icol_cap=next_pow2_(need["n_lit_i"]),
                           pack_cap=next_pow2_(longest + 1))


def next_pow2_(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def timed_runs(runs, reps):
    """Each of runs {label: fn} reps times in turns after a warm-up; fn()
    returns what it served. -> ({label: [seconds]}, {label: peak device MiB
    of its last run}, {label: first timed run's result})."""
    import torch

    walls, peaks, first = {k: [] for k in runs}, {}, {}
    for fn in runs.values():
        fn()
    for _ in range(reps):
        for label, fn in runs.items():
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t)
            peaks[label] = (torch.cuda.max_memory_allocated() - held) / 2**20
            first.setdefault(label, got)
    return walls, peaks, first


def spread(xs):
    return f"{min(xs):.6f}-{max(xs):.6f}"


def window_serving(t0, dev, smi, record, frames_1080, synth_screencast):
    """Phase 10: window serving (parallel/serve_scan.py) on the serving
    workload over 1 + 16 steps, against serve_pipelined; the single-stream
    window at 1080p against the sequential session. Returns the counted
    window run's launch counts."""
    import torch

    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch.config import ALG_RAW, CodecConfig
    from screenpressor_tpu_torch.parallel import serve_scan as ss
    from screenpressor_tpu_torch.parallel import serving as ts

    cfg = CodecConfig(width=S_W, height=S_H, kf_interval=S_KF, k_fixed=64, msr_x=256,
                      msr_y=256)
    offsets = (np.arange(S_STREAMS) * S_KF) // S_STREAMS
    base = synth_screencast(S_H, S_W, WIN_STEPS, seed=3)
    batches = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1)
                                         for i in range(S_STREAMS)]), device=dev)
               for t in range(WIN_STEPS)]
    defaults = ss.WindowConfig(cfg, S_STREAMS)
    thr = 1 + S_H * S_W * 3

    def serve(window, wcfg=None):
        enc = ts.BatchedEncoder(S_STREAMS, cfg, dev, kf_offsets=offsets)
        dec = ts.BatchedDecoder(S_STREAMS, cfg, dev)
        got = list(ss.serve_windowed(enc, batches, dec, wcfg) if window
                   else ts.serve_pipelined(enc, batches, dec))
        dec.validate()
        return got

    walls, peaks, first = timed_runs(
        {"serve_pipelined": lambda: serve(False),
         "serve_windowed (defaults)": lambda: serve(True, defaults)}, 3)
    pipe, win = first["serve_pipelined"], first["serve_windowed (defaults)"]
    phase("window serving: timed runs", t0)

    # every stream-step of the default window: RAW by a cause of the rule,
    # else the pipelined bytes (up to the stream's first RAW: an escape
    # renews its tables), and every decode lossless
    causes, first_raw, after = {}, {}, 0
    for t in range(WIN_STEPS):
        for i in range(S_STREAMS):
            (pw, fw), (pp, fp) = win[t][0][i], pipe[t][0][i]
            why = escape_causes(pp, defaults, thr) if t else []
            if pw[0] & 0x0F == ALG_RAW and pp[0] & 0x0F != ALG_RAW:
                if not why and i not in first_raw:
                    raise AssertionError(f"window step {t} stream {i}: RAW without a cause")
                for c in why or ["size after an earlier escape"]:
                    causes[c] = causes.get(c, 0) + 1
                first_raw.setdefault(i, t)
            elif i in first_raw:
                after += 1
            elif (pw, fw) != (pp, fp):
                raise AssertionError(f"window step {t} stream {i}: bytes differ from "
                                     "serve_pipelined's within the capacities")
            elif any(c for c in why if "sequential" not in c):
                raise AssertionError(f"window step {t} stream {i}: over a capacity, not RAW")
    for (_, back), (_, ref), frames in zip(win, pipe, batches):
        if not (torch.equal(back, frames) and torch.equal(ref, frames)):
            raise AssertionError("window serving: decode not lossless")
    n_raw = sum(1 for t in range(WIN_STEPS) for p, _ in win[t][0] if p[0] & 0x0F == ALG_RAW)
    print(f"window serving, WindowConfig defaults: {n_raw} RAW stream-steps of "
          f"{S_STREAMS * WIN_STEPS}, by cause {causes} (first RAW step by stream "
          f"{first_raw}); {after} later stream-steps of escaped streams (tables renewed: "
          "decoded only); the rest equal serve_pipelined's bytes; decode lossless")

    # the window path counted, its K1-K4 launches captured: steps 1-16 at
    # the defaults after the per-step keyframe step; its bytes are those of
    # the timed runs
    enc = ts.BatchedEncoder(S_STREAMS, cfg, dev, kf_offsets=offsets)
    dec = ts.BatchedDecoder(S_STREAMS, cfg, dev)
    dec.decode([p for p, _ in enc.encode(batches[0])])
    store = {}
    torch.cuda.synchronize()
    _build.reset_counts()
    with window_captures(store, "window"):
        got = list(ss.serve_windowed(enc, batches[1:], dec, defaults))
        dec.validate()
    counts = dict(_build.LAUNCHES)
    print(f"window path launches (16 steps in two windows of 8, WindowConfig defaults): "
          f"{counts}")
    missing = [k for k in ("sptc_sections_encode", "sptc_sections_decode", "sptc_run_walk",
                           "sptc_recon_rows", "sptc_analyze_blocks",
                           "sptc_rebuild_blocks") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the window path: {missing}")
    if [outs for outs, _ in got] != [outs for outs, _ in win[1:]]:
        raise AssertionError("window serving: the counted run's bytes differ from the timed "
                             "runs'")

    # capacities that hold every stream-step: the window equals
    # serve_pipelined everywhere
    big = no_escape_caps(ss, cfg, S_STREAMS, [outs for outs, _ in pipe[1:]], 8, 2)
    for t, ((outs, back), (ref, _), frames) in enumerate(zip(serve(True, big), pipe, batches)):
        if outs != ref:
            bad = [i for i in range(S_STREAMS) if outs[i] != ref[i]]
            raise AssertionError(f"window step {t}: streams {bad[:8]} differ from "
                                 "serve_pipelined's bytes")
        if not torch.equal(back, frames):
            raise AssertionError(f"window step {t}: decode not lossless")
    print(f"window serving, no-escape capacities {vars(big)}: every stream-step's bytes "
          "equal serve_pipelined's, decode lossless")
    phase("window serving: bytes", t0)
    hold_captured(record, store, "window", ("sptc_sections_encode_window",
                                            "sptc_sections_decode_window",
                                            "sptc_run_walk_window", "sptc_recon_rows_window",
                                            "sptc_analyze_blocks_window",
                                            "sptc_rebuild_blocks_window"), smi)
    del store

    # a window's host syncs (torch's sync debug mode)
    enc = ts.BatchedEncoder(S_STREAMS, cfg, dev, kf_offsets=offsets)
    enc.encode(batches[0])
    handle, begin_syncs = count_syncs(lambda: ss.encode_window_begin(enc, batches[1:9],
                                                                     defaults))
    _, finish_syncs = count_syncs(lambda: ss.encode_window_finish(handle))
    print(f"window serving: host syncs of a window of 8 steps over {S_STREAMS} streams: "
          f"encode_window_begin {begin_syncs}, encode_window_finish {finish_syncs}, on {smi}")
    phase("window serving: kernels vs plain", t0)

    n_sf = S_STREAMS * WIN_STEPS
    for label, xs in walls.items():
        print(f"{label}: {S_STREAMS} streams x {WIN_STEPS} steps at {S_W}x{S_H}, encode + "
              f"decode {spread(xs)} s over 3 runs in turns: "
              f"{spread([n_sf / x for x in xs])} stream-frames/s; peak device memory "
              f"{peaks[label]:.1f} MiB, on {smi}")

    # the single-stream window (bench.py:167-222): 17 1080p frames, k_fixed 32
    h, w = frames_1080[0].shape[:2]
    cfg1 = CodecConfig(width=w, height=h, k_fixed=32)
    one = [torch.as_tensor(f[None], device=dev) for f in frames_1080[:WIN_STEPS]]

    def sequential():
        enc = ts.BatchedEncoder(1, cfg1, dev)
        return [enc.encode(b) for b in one]

    want = sequential()
    wcfg1 = no_escape_caps(ss, cfg1, 1, want[1:], WIN_STEPS - 1, 1)

    def windowed():
        enc = ts.BatchedEncoder(1, cfg1, dev)
        return [enc.encode(one[0])] + ss.encode_window(enc, one[1:], wcfg1)

    walls1, _, first1 = timed_runs({"sequential": sequential, "window": windowed}, 3)
    if first1["window"] != want or first1["sequential"] != want:
        raise AssertionError("1080p single-stream window: bytes differ from the sequential "
                             "session")
    dec = ts.BatchedDecoder(1, cfg1, dev)
    dec.decode([want[0][0][0]])
    back = ss.decode_window(dec, [[o[0][0]] for o in want[1:]])
    dec.validate()
    if not all(torch.equal(back[t, 0], one[t + 1][0]) for t in range(WIN_STEPS - 1)):
        raise AssertionError("1080p single-stream window: decode_window not lossless")
    mpix = h * w * WIN_STEPS / 1e6
    print(f"1080p single-stream window ({WIN_STEPS} frames, one F {WIN_STEPS - 1} window, "
          f"capacities {vars(wcfg1)}): bytes equal the sequential BatchedEncoder's, "
          f"decode_window lossless; encode Mpix/s over 3 runs: window "
          f"{spread([mpix / x for x in walls1['window']])}, sequential "
          f"{spread([mpix / x for x in walls1['sequential']])}, on {smi}")
    phase("window serving: 1080p single stream", t0)
    return counts


def dp_split(t0, dev, smi, record, synth_screencast):
    """Phase 11: the serving session split over 2 and 4 stream groups on
    the one card (devices=[cuda] * n) against the unsplit session. Returns
    the counted 2-group run's launch counts."""
    import torch

    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch.parallel import serving as ts

    cfg, offsets, _, batches = serving_batches(dev, synth_screencast)

    def serve(n):
        kw = {"device": dev} if n == 1 else {"devices": [dev] * n}
        enc = ts.BatchedEncoder(S_STREAMS, cfg, kf_offsets=offsets, **kw)
        dec = ts.BatchedDecoder(S_STREAMS, cfg, **kw)
        got = list(ts.serve_pipelined(enc, batches, dec))
        dec.validate()
        return got

    walls, peaks, first = timed_runs({n: (lambda n=n: serve(n)) for n in (1, 2, 4)}, 3)
    for n in (2, 4):
        for t, ((outs, back), (ref, _), frames) in enumerate(zip(first[n], first[1], batches)):
            if outs != ref:
                raise AssertionError(f"dp {n} groups, step {t}: bytes differ from unsplit")
            if not torch.equal(back, frames):
                raise AssertionError(f"dp {n} groups, step {t}: decode not lossless")
    n_sf = S_STREAMS * S_STEPS
    for n, xs in walls.items():
        label = "unsplit" if n == 1 else f"{n} groups (devices=[{dev}] * {n}, one card)"
        print(f"dp split, {label}: {S_STREAMS} streams x {S_STEPS} steps, serve_pipelined "
              f"{spread(xs)} s over 3 runs in turns: {spread([n_sf / x for x in xs])} "
              f"stream-frames/s; peak device memory {peaks[n]:.1f} MiB, on {smi}")
    print("dp split: the 2- and 4-group sessions' bytes equal the unsplit session's, "
          "decode lossless")
    phase("dp split: timed runs", t0)

    store = {}
    torch.cuda.synchronize()
    _build.reset_counts()
    with window_captures(store, "dp"):
        got = serve(2)
    counts = dict(_build.LAUNCHES)
    print(f"dp split path launches (2 groups, 5 steps): {counts}")
    missing = [k for k in ("sptc_sections_encode", "sptc_sections_decode", "sptc_run_walk",
                           "sptc_recon_rows", "sptc_analyze_blocks",
                           "sptc_rebuild_blocks") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the dp split path: {missing}")
    if [outs for outs, _ in got] != [outs for outs, _ in first[1]]:
        raise AssertionError("dp split counted run: bytes differ from unsplit")
    hold_captured(record, store, "dp", ("sptc_sections_encode_dp", "sptc_sections_decode_dp",
                                        "sptc_run_walk_dp", "sptc_recon_rows_dp",
                                        "sptc_analyze_blocks_dp", "sptc_rebuild_blocks_dp"),
                  smi)
    phase("dp split: kernels vs plain", t0)
    return counts


def recorder(rows):
    """record(kernel, ms, plain_ms, err, work): add one compared call to
    rows[kernel] (times, largest error, bound of its (bytes, operations));
    raises if the kernel differs from its plain version."""
    def record(kernel, ms, plain_ms, err, work):
        r = rows.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0, "err": 0, "bound_ms": 0.0,
                                     "bytes_ms": 0.0, "ops_ms": 0.0})
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["err"] = max(r["err"], err)
        r["bound_ms"] += bound(*work)[0]
        r["bytes_ms"] += bound(work[0], 0)[0]
        r["ops_ms"] += bound(0, work[1])[0]
        if err:
            raise AssertionError(f"{kernel}: kernel differs from plain (max |err| {err})")
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from screenpressor_tpu_torch import TorchDecoder, TorchEncoder, _build
    from screenpressor_tpu_torch import blocks as tb
    from screenpressor_tpu_torch import classify as tcl
    from screenpressor_tpu_torch import coder as tc
    from screenpressor_tpu_torch import kernels as tk
    from screenpressor_tpu_torch import pframe as tp
    from screenpressor_tpu_torch import recon as tr
    from screenpressor_tpu_torch.config import NUM_PTYPES, CodecConfig, seg_tile
    from screenpressor_tpu_torch.synth import synth_screencast
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
    record = recorder(rows)

    # K3 on the keyframe's fits
    fits = tcl.fits_planes_i(kf)
    st = tcl.start_types_i(fits)
    bits = tcl.fits_bits(fits)
    tile = seg_tile(H * W, W)
    ms, got = cuda_ms(lambda: tcl.run_walk(bits, st, tile), TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: tcl.run_walk_plain(bits, st, tile), 1, False)
    err = max_abs_err([(got.cpu().numpy(), ref.cpu().numpy())])
    record("sptc_run_walk", ms, plain_ms, err, walk_work(bits, got))
    print(f"K3 run walk n={H * W} tile={tile}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal")

    # K4 on the keyframe's records
    records, n_rec, lits, n_lit = tcl.classify_i(kf)
    n_rec, n_lit = int(n_rec), int(n_lit)
    ms, whole_ms, k4_rows, got = recon_timings(tr, records[:n_rec], lits[:max(n_lit, 1)], H,
                                               W, TIMED_REPS)
    plain_ms, ref = cuda_ms(lambda: tr.recon_rows_plain(k4_rows, W), 1, False)
    err = max_abs_err([(got.cpu().numpy(), ref.cpu().numpy()),
                       (got.cpu().numpy(), frames[0])])
    record("sptc_recon_rows", ms, plain_ms, err, recon_work(k4_rows, got))
    print(f"K4 recon {H}x{W} (Wp={k4_rows.shape[1]}): kernel {ms:.3f} ms ({1e3 * ms / H:.3f} us "
          f"a row), bound {bound(*recon_work(k4_rows, got))[0]:.4f} ms (unpacked inputs "
          f"{bound(*recon_work(k4_rows, got, True))[0]:.4f} ms), reconstruct_i with expand and "
          f"pad {whole_ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, equal, equals the keyframe, on {smi}")

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
        # K3 on this frame's data-block walk (pframe._segment_seq's inputs)
        rects = arrs["data_rects"][: int(counts[6])]
        bsid = torch.zeros(rects.shape[0], dtype=torch.int64, device=dev)
        bfits, bst, _, _ = tp._block_fits(tp._windows_streams(cur[None], rects, bsid),
                                          tp._windows_streams(prv[None], rects, bsid), rects)
        wbits, wst = tcl.fits_bits(bfits.reshape(-1, NUM_PTYPES)), bst.reshape(-1)
        ms, got = cuda_ms(lambda: tcl.run_walk(wbits, wst, tp.AREA), TIMED_REPS)
        plain_ms, ref = cuda_ms(lambda: tcl.run_walk_plain(wbits, wst, tp.AREA), 1, False)
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 {label} data-block walk differs from plain")
        print(f"K3 {label} data-block walk: {rects.shape[0]} blocks x tile {tp.AREA}: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.1f} ms, equal, on {smi}")
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
            lambda: tc.encode_sections([dealt], [lens], tabs, kts), TIMED_REPS)

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
        record("sptc_sections_encode", ms, plain_ms, err,
               sections_work(kts, [dealt], [lens], sum(map(len, blobs))))

        pay = torch.as_tensor(tc.pad_payload(blobs, k), device=dev)
        dms, (recs, dtab_k) = cuda_ms(
            lambda: tc.decode_sections([pay], [lens], tabs, kts), TIMED_REPS)
        dplain_ms, (rec_p, dtab_p) = cuda_ms(
            lambda: tc.decode_section_scan(pay, lens, tabs, nm, t), 1, False)
        derr = max_abs_err([(recs[0].cpu().numpy(), rec_p.cpu().numpy()),
                            (tc.undeal(recs[0], n, k, max(n, 1))[:n].cpu().numpy(),
                             src[:n].cpu().numpy())]
                           + tables_pairs(dtab_k, dtab_p) + tables_pairs(dtab_k, tab_k))
        record("sptc_sections_decode", dms, dplain_ms, derr,
               sections_work(kts, [recs[0]], [lens], pay.numel()))
        print(f"K1/K2 {label}: n={n} k={k} t={t} bytes={sum(map(len, blobs))}: "
              f"encode {ms:.3f} ms (plain {plain_ms:.1f} ms), decode {dms:.3f} ms "
              f"(plain {dplain_ms:.1f} ms), bytes, records and tables equal")
        if label.startswith("I "):
            # K1's two phases apart, from the device timer inside the block
            clocks = []
            tk.encode_sections_streams_kernel([dealt[None]], [lens[None]],
                                              tc._one_stream(tabs, kts), kts, [0],
                                              clocks=clocks)
            t_in, t_fwd, t_end = (int(v) for v in clocks[0][0].cpu())
            print(f"K1 {label} phases: forward {(t_fwd - t_in) / 1e6:.3f} ms, pack "
                  f"{(t_end - t_fwd) / 1e6:.3f} ms (device timer, one launch) on {smi}")
        if nm != "col":
            continue
        bm = tc.color_touched_bitmap(src, n)
        col_w = tc.col_compact_bucket(int(bm.sum()))
        if col_w is None:
            print(f"K1-colw {label}: {int(bm.sum())} touched rows, no bucket (full col)")
            continue
        kts_w = ((f"colw{col_w}", k, t),)
        wms, (b_w, s_w, tab_w) = cuda_ms(
            lambda: tc.encode_sections([dealt], [lens], tabs, kts, col_w, bm), TIMED_REPS)

        def plain_colw():
            one = {key: v[None].clone() for key, v in tabs["color"].items()}
            recs_c, ctab_c, maps = tc.color_compact_streams(dealt[None], lens[None], bm[None],
                                                            one, [0], col_w)
            (buf_c,), (start_c,) = tc.encode_sections_streams_plain(
                [recs_c], [lens[None]], {"color": ctab_c}, kts_w, [0], ("color",))
            tc.color_restore_streams(one, [0], ctab_c, maps)
            return buf_c[0], start_c[0], {"color": {key: v[0] for key, v in one.items()}}

        wplain_ms, (buf_p, start_p, tab_p) = cuda_ms(plain_colw, 1, False)
        blobs_w = tc.blobs_from_buf(b_w[0].cpu().numpy(), s_w[0].cpu().numpy(), lens_np)
        if blobs_w != blobs or blobs_w != tc.blobs_from_buf(
                buf_p.cpu().numpy(), start_p.cpu().numpy(), lens_np):
            raise AssertionError(f"K1-colw {label}: bytes differ from full col or plain colw")
        err = max_abs_err([(s_w[0].cpu().numpy(), starts[0].cpu().numpy()),
                           (s_w[0].cpu().numpy(), start_p.cpu().numpy())]
                          + tables_pairs(tab_w, {"color": tab_k["color"]})
                          + tables_pairs(tab_w, tab_p))
        record("sptc_sections_encode_colw", wms, wplain_ms, err,
               sections_work(kts_w, [dealt], [lens], sum(map(len, blobs_w))))
        print(f"K1-colw {label}: colw{col_w}, {int(bm.sum())} touched rows: colw path "
              f"{wms:.3f} ms (full col {ms:.3f} ms, plain colw {wplain_ms:.1f} ms), bytes, "
              "starts and restored tables equal full col and plain colw")
    if "sptc_sections_encode_colw" not in rows:
        raise AssertionError("no 1080p col section fits a colw bucket")

    # K1's and K2's time per substep against the lanes: the keyframe's rec
    # and col records dealt to K lanes over 600 steps (K 1: the chain's
    # latency floor; K 32: the 1080p keyframe's lanes). Decoded records must
    # equal the dealt ones.
    for nm, src, s_n in (("rec", records, 2), ("col", lits, 3)):
        per, per_e = [], []
        for k in (1, 8, 32):
            t = 600
            dealt = tc.deal(src, k * t, k, t)
            lens = tc.lane_lens(k * t, k, dev)
            kts = ((nm, k, t),)
            ems, (bufs, starts, _) = cuda_ms(
                lambda: tc.encode_sections([dealt], [lens], tabs, kts), TIMED_REPS)
            per_e.append(f"K {k} {1e3 * ems / (t * s_n):.3f} us")
            pay = torch.as_tensor(tc.pad_payload(tc.blobs_from_buf(
                bufs[0].cpu().numpy(), starts[0].cpu().numpy(), lens.cpu().numpy()), k),
                device=dev)
            ms, (recs, _) = cuda_ms(lambda: tc.decode_sections([pay], [lens], tabs, kts),
                                    TIMED_REPS)
            if not torch.equal(recs[0], dealt):
                raise AssertionError(f"K2 {nm} K {k}: records differ from the dealt ones")
            per.append(f"K {k} {1e3 * ms / (t * s_n):.3f} us")
        print(f"K1 time per substep, keyframe {nm} records, T 600: {', '.join(per_e)} on {smi}")
        print(f"K2 time per substep, keyframe {nm} records, T 600: {', '.join(per)} on {smi}")
    phase("kernels vs plain", t0)

    # ---- 4. the main path: a first session, then the counted one ----
    def session():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        te = time.perf_counter()
        payloads = TorchEncoder(cfg, dev).encode_batch(frames)
        torch.cuda.synchronize()
        td = time.perf_counter()
        enc_peak = torch.cuda.max_memory_allocated() - held
        decoded = TorchDecoder(cfg, dev).decode_batch([p for p, _ in payloads],
                                                      device_out=True)
        torch.cuda.synchronize()
        return payloads, decoded, td - te, time.perf_counter() - td, enc_peak

    _, _, t_enc0, t_dec0, _ = session()
    _build.reset_counts()
    payloads, decoded, t_enc, t_dec, enc_peak = session()
    launches = dict(_build.LAUNCHES)
    print(f"single-stream main path launches: {launches}")
    single = ("sptc_sections_encode", "sptc_sections_encode_colw", "sptc_sections_decode",
              "sptc_run_walk", "sptc_recon_rows", "sptc_analyze_blocks",
              "sptc_rebuild_blocks", "sptc_resolve_blocks")
    missing = [k for k in single if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    phase("main path", t0)

    for i, (f, o) in enumerate(zip(frames, decoded)):
        if not torch.equal(o, torch.as_tensor(f, device=dev)):
            raise AssertionError(f"frame {i}: decode is not lossless")
    sizes = [len(p) for p, _ in payloads]
    print(f"decoded all {len(frames)} frames losslessly; bytes per frame: {sizes}")
    print(f"1080p session: the encode's peak device memory {enc_peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated above what was held), on {smi}")

    with open(NATIVE_DIGESTS) as fh:
        pinned = json.load(fh)
    if (pinned["height"], pinned["width"], pinned["n_frames"]) != (H, W, N_FRAMES):
        raise AssertionError("pinned native digests are for another workload")
    for i, ((p, ft), want) in enumerate(zip(payloads, pinned["frames"], strict=True)):
        got = {"size": len(p), "ftype": ft, "sha256": hashlib.sha256(p).hexdigest()}
        if got != want:
            raise AssertionError(f"frame {i}: port bytes {got} != native {want}")
    print(f"port bytes equal the pinned native SPTC digests on {len(pinned['frames'])} of "
          f"{len(frames)} frames")
    phase("native comparison", t0)

    mpix = H * W * len(frames) / 1e6
    rgb24_rates = [(mpix / te_, mpix / td_) for te_, td_ in ((t_enc0, t_dec0), (t_enc, t_dec))]
    for tag, te_, td_ in (("first session", t_enc0, t_dec0),
                          ("second session", t_enc, t_dec)):
        print(f"{tag}: encode {mpix / te_:.3f} Mpix/s ({te_:.3f} s), decode "
              f"{mpix / td_:.3f} Mpix/s ({td_:.3f} s) for {len(frames)} frames "
              f"at {W}x{H} on {smi}")

    s_cfg, s_offsets, s_host, s_batches = serving_batches(dev, synth_screencast)
    serving_kernels_vs_plain(t0, dev, smi, record, s_cfg, s_offsets, s_host, s_batches)
    serve = serving_main_path(t0, dev, smi, s_cfg, s_offsets, s_host, s_batches)
    serving_rebuild(t0, dev, smi, record, s_cfg, s_offsets, s_batches)
    session_rebuild(t0, dev, smi, record, payloads, cfg, t_dec)
    serving_encode_front(t0, dev, smi, record, s_cfg, s_offsets, s_batches)
    batch_encode_front(t0, dev, smi, record, frames, cfg)
    damaged_streams(t0, dev, smi)
    session_api(t0, dev, smi, frames, cfg, pinned, rgb24_rates)
    sp_counts = sp_mesh(t0, dev, smi, record, frames, cfg, pinned)
    win_counts = window_serving(t0, dev, smi, record, frames, synth_screencast)
    dp_counts = dp_split(t0, dev, smi, record, synth_screencast)

    sections = "screenpressor_tpu_torch/csrc/sections.cu"
    walk = "screenpressor_tpu_torch/csrc/run_walk.cu"
    recon = "screenpressor_tpu_torch/csrc/recon.cu"
    k1, k2 = "screenpressor_tpu/jx/kernels.py:1016", "screenpressor_tpu/jx/kernels.py:577"
    k2_grid, k3 = "screenpressor_tpu/jx/kernels.py:685", "screenpressor_tpu/jx/classify.py:142"
    k4 = "screenpressor_tpu/jx/recon.py:143"
    # K5 stands for the block front end of the jitted analyze_compact: its
    # change_analysis and the search motion_search_pruned (no Pallas site:
    # XLA fuses them, the search a lax.while_loop)
    search, k5 = ("screenpressor_tpu_torch/csrc/motion_search.cu",
                  "screenpressor_tpu/jx/blocks.py:389")
    # K6 stands for the jitted reconstruct_blocks (no Pallas site: XLA
    # compiles it with the motion apply into one program a frame)
    rebuild, k6 = ("screenpressor_tpu_torch/csrc/block_rebuild.cu",
                   "screenpressor_tpu/jx/pframe.py:253")
    # K8 stands for decode_p_resolve after its section scans (no Pallas
    # site: XLA fuses it into the P decode program)
    resolve, k8 = ("screenpressor_tpu_torch/csrc/resolve.cu",
                   "screenpressor_tpu/jx/pframe.py:510")
    entries = (  # (entry, its launch count, main path's counts, source, TPU kernel)
        ("sptc_sections_encode", "sptc_sections_encode", launches, sections, k1),
        ("sptc_sections_encode_colw", "sptc_sections_encode_colw", launches, sections, k1),
        ("sptc_sections_decode", "sptc_sections_decode", launches, sections, k2),
        ("sptc_run_walk", "sptc_run_walk", launches, walk, k3),
        ("sptc_recon_rows", "sptc_recon_rows", launches, recon, k4),
        ("sptc_sections_encode_streams", "sptc_sections_encode", serve, sections, k1),
        ("sptc_sections_encode_colw_streams", "sptc_sections_encode_colw", serve, sections, k1),
        ("sptc_sections_decode_streams", "sptc_sections_decode", serve, sections, k2_grid),
        ("sptc_run_walk_streams", "sptc_run_walk", serve, walk, k3),
        ("sptc_recon_rows_streams", "sptc_recon_rows", serve, recon, k4),
        ("sptc_sections_encode_sp", "sptc_sections_encode", sp_counts, sections, k1),
        ("sptc_sections_decode_sp", "sptc_sections_decode", sp_counts, sections, k2),
        ("sptc_run_walk_sp", "sptc_run_walk", sp_counts, walk, k3),
        ("sptc_recon_rows_sp", "sptc_recon_rows", sp_counts, recon, k4),
        ("sptc_sections_encode_window", "sptc_sections_encode", win_counts, sections, k1),
        ("sptc_sections_decode_window", "sptc_sections_decode", win_counts, sections, k2_grid),
        ("sptc_run_walk_window", "sptc_run_walk", win_counts, walk, k3),
        ("sptc_recon_rows_window", "sptc_recon_rows", win_counts, recon, k4),
        ("sptc_sections_encode_dp", "sptc_sections_encode", dp_counts, sections, k1),
        ("sptc_sections_decode_dp", "sptc_sections_decode", dp_counts, sections, k2_grid),
        ("sptc_run_walk_dp", "sptc_run_walk", dp_counts, walk, k3),
        ("sptc_recon_rows_dp", "sptc_recon_rows", dp_counts, recon, k4),
        ("sptc_analyze_blocks", "sptc_analyze_blocks", launches, search, k5),
        ("sptc_analyze_blocks_streams", "sptc_analyze_blocks", serve, search, k5),
        ("sptc_analyze_blocks_sp", "sptc_analyze_blocks", sp_counts, search, k5),
        ("sptc_analyze_blocks_window", "sptc_analyze_blocks", win_counts, search, k5),
        ("sptc_analyze_blocks_dp", "sptc_analyze_blocks", dp_counts, search, k5),
        ("sptc_rebuild_blocks", "sptc_rebuild_blocks", launches, rebuild, k6),
        ("sptc_rebuild_blocks_streams", "sptc_rebuild_blocks", serve, rebuild, k6),
        ("sptc_rebuild_blocks_sp", "sptc_rebuild_blocks", sp_counts, rebuild, k6),
        ("sptc_rebuild_blocks_window", "sptc_rebuild_blocks", win_counts, rebuild, k6),
        ("sptc_rebuild_blocks_dp", "sptc_rebuild_blocks", dp_counts, rebuild, k6),
        ("sptc_resolve_blocks", "sptc_resolve_blocks", launches, resolve, k8),
        ("sptc_resolve_blocks_streams", "sptc_resolve_blocks", serve, resolve, k8),
    )
    kernels = [
        {"name": entry, "route": "cuda", "source": src, "replaces": rep,
         "launches": path[count], "max_abs_err": rows[entry]["err"],
         "ms": rows[entry]["ms"], "plain_ms": rows[entry]["plain_ms"],
         "bound_ms": rows[entry]["bound_ms"],
         "bound_by": "bytes" if rows[entry]["bytes_ms"] >= rows[entry]["ops_ms"] else "operations",
         "library_ms": None}  # no single PyTorch call computes K1-K8
        for entry, count, path, src, rep in entries
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
