#!/usr/bin/env python3
"""Host syncs of the serving encoder's steps on one card, by source line.

    python3 tools/torch_sync_sites.py

Runs chip_smoke.py's serving session (64 streams of 360x640, 5 steps of
BatchedEncoder.encode, after a warm-up session) with torch's sync debug
mode on, and prints for each step the number of synchronizing calls and
the port's source lines they came from (the innermost three frames of
screenpressor_tpu_torch on the stack). Then the same for the window path
(parallel/serve_scan.py) on that profile over 1 + 8 steps: a per-step
keyframe step, then one window of F 8 (WindowConfig defaults): its
encode_window_begin, its encode_window_finish and its decode_window apart.
Needs a CUDA device; imports nothing of JAX.
"""

import collections
import os
import subprocess
import sys
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sync_sites: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from screenpressor_tpu_torch.parallel import serve_scan as ss
    from screenpressor_tpu_torch.parallel import serving as ts
    from screenpressor_tpu_torch.synth import synth_screencast

    dev = torch.device("cuda")
    cfg, offsets, _host, batches = chip_smoke.serving_batches(dev, synth_screencast)
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                 for f in traceback.extract_stack() if "screenpressor_tpu_torch" in f.filename]
        sites[" <- ".join(reversed(stack[-3:]))] += 1

    def count(label, fn):
        sites.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if label:
            print(f"{label}: {sum(sites.values())} host syncs")
            for site, n in sites.most_common():
                print(f"  {n:4d}  {site}")
        return out

    for warm in (True, False):
        enc = ts.BatchedEncoder(chip_smoke.S_STREAMS, cfg, dev, kf_offsets=offsets)
        for t, frames in enumerate(batches):
            count(None if warm else f"encoder step {t}", lambda: enc.encode(frames))

    base = synth_screencast(cfg.height, cfg.width, 9, seed=3)
    steps = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1)
                                       for i in range(chip_smoke.S_STREAMS)]), device=dev)
             for t in range(9)]
    wcfg = ss.WindowConfig(cfg, chip_smoke.S_STREAMS)
    for warm in (True, False):
        enc = ts.BatchedEncoder(chip_smoke.S_STREAMS, cfg, dev, kf_offsets=offsets)
        dec = ts.BatchedDecoder(chip_smoke.S_STREAMS, cfg, dev)
        dec.decode([p for p, _ in enc.encode(steps[0])])
        tag = None if warm else "window (F 8, 64 streams)"
        handle = count(tag and tag + ": encode_window_begin",
                       lambda: ss.encode_window_begin(enc, steps[1:], wcfg))
        outs = count(tag and tag + ": encode_window_finish",
                     lambda: ss.encode_window_finish(handle))
        count(tag and tag + ": decode_window",
              lambda: ss.decode_window(dec, [[p for p, _ in o] for o in outs]))
        dec.validate()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
