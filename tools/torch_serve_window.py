#!/usr/bin/env python3
"""Window serving against the per-step serving loop on one card: where the
device's time goes.

    python3 tools/torch_serve_window.py

Runs chip_smoke.py's window workload (64 streams of 360x640, k_fixed 64,
msr 256, staggered keyframes, 1 + 16 steps) through serve_pipelined and
through serve_windowed (WindowConfig defaults, F 8), each once under
torch.profiler after a warm-up, and prints for each: its wall, the
device's busy time and idle share of the wall, the device time of each
kernel (K1 encode_kernel, K2 decode_kernel, K3 run_walk_kernel, K4
recon_kernel, K5 analyze_blocks_kernel) and of everything else, K1's
device time a step, and the kernels' launch counts. Then the encode alone (the window's begin and
finish, or the encode steps) the same way. Prints the card's nvidia-smi
name and power limit. Walls: three unprofiled runs after the warm-up.
Needs a CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"K1": "encode_kernel", "K2": "decode_kernel", "K3": "run_walk_kernel",
           "K4": "recon_kernel", "K5": "analyze_blocks_kernel"}


def device_time(prof):
    """(busy ms of the union of device events, {kernel: ms}, other ms)."""
    from torch.autograd import DeviceType

    spans, per, other = [], dict.fromkeys(KERNELS, 0.0), 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        hit = next((k for k, nm in KERNELS.items() if nm in e.name), None)
        if hit:
            per[hit] += (b - a) / 1e3
        else:
            other += (b - a) / 1e3
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, per, other


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_window: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.parallel import serve_scan as ss
    from screenpressor_tpu_torch.parallel import serving as ts
    from screenpressor_tpu_torch.synth import synth_screencast

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    s, h, w, steps = chip_smoke.S_STREAMS, chip_smoke.S_H, chip_smoke.S_W, chip_smoke.WIN_STEPS
    cfg = CodecConfig(width=w, height=h, kf_interval=chip_smoke.S_KF, k_fixed=64, msr_x=256,
                      msr_y=256)
    offsets = (np.arange(s) * chip_smoke.S_KF) // s
    base = synth_screencast(h, w, steps, seed=3)
    batches = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(s)]),
                               device=dev) for t in range(steps)]
    wcfg = ss.WindowConfig(cfg, s)

    def sessions():
        return (ts.BatchedEncoder(s, cfg, dev, kf_offsets=offsets),
                ts.BatchedDecoder(s, cfg, dev))

    def serve_pipelined():
        enc, dec = sessions()
        list(ts.serve_pipelined(enc, batches, dec))
        dec.validate()

    def serve_windowed():
        enc, dec = sessions()
        list(ss.serve_windowed(enc, batches, dec, wcfg))
        dec.validate()

    def encode_steps():
        enc, _ = sessions()
        for b in batches:
            enc.encode(b)

    def encode_windows():
        enc, _ = sessions()
        enc.encode(batches[0])
        pend = None
        for lo in range(1, steps, wcfg.f):
            nxt = ss.encode_window_begin(enc, batches[lo:lo + wcfg.f], wcfg)
            if pend is not None:
                ss.encode_window_finish(pend)
            pend = nxt
        ss.encode_window_finish(pend)

    print(f"{s} streams x {steps} steps at {w}x{h} on {smi}")
    for label, fn in (("serve_pipelined", serve_pipelined), ("serve_windowed", serve_windowed),
                      ("encode, per step", encode_steps), ("encode, windows", encode_windows)):
        fn()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        med = float(np.median(walls))
        _build.reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        busy, per, other = device_time(prof)
        kern = ", ".join(f"{k} {v:.3f}" for k, v in per.items())
        print(f"{label}: walls {', '.join(f'{x:.6f}' for x in walls)} s, "
              f"{s * steps / med:.2f} stream-frames/s at the median; profiled wall "
              f"{wall:.6f} s, device busy {busy:.3f} ms, idle share of the median wall "
              f"{1 - busy / 1e3 / med:.4f} (of the profiled {1 - busy / 1e3 / wall:.4f}); device ms "
              f"by kernel: {kern}, other {other:.3f}; K1 a step {per['K1'] / steps:.3f} ms; "
              f"launches {launches}", flush=True)
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
