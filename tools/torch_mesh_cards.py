#!/usr/bin/env python3
"""The row-sharded mesh (screenpressor_tpu_torch/parallel/mesh.py) over
every visible card, against the same mesh with all its shards on card 0.

    python3 tools/torch_mesh_cards.py [--dp-only]

With N >= 2 cards: the 8-frame 4K synth_screencast session through
encode_i_sp / encode_p_sp and back through decode_i_sp / decode_p_sp on
make_mesh(N, sp=N) (one shard a card) and on the same mesh with
devices=[cuda:0] * N; both must equal the pinned native digests
(tests/data/torch_native_4k_8.json) and decode losslessly. Then, with 4
cards, sharded_analysis_step and dryrun_step over 64 streams of 360x640 at
dp 2 x sp 2 on the four cards against the one-card mesh (fits, flags,
lane bytes, n_records, tables). Prints each session's Mpix/s (synchronised
host clock, mean of 3 after a warm-up) and the device time of each stage
(the mesh's "sp ..." ranges under torch.profiler), with the cards'
nvidia-smi name and power limit. Then the serving session split along its
stream axis (BatchedEncoder / BatchedDecoder with devices=): chip_smoke.py's
window workload (64 streams of 360x640, 1 + 16 steps) through
serve_pipelined and serve_windowed with one stream group a card, against
the same split with every group on card 0 (bytes equal, decode lossless;
stream-frames/s, mean of 3 after a warm-up); --dp-only runs this part
alone. Imports nothing of JAX or of the JAX package; exits non-zero on
any difference.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N = 2160, 3840, 8
REPS = 3


def sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn, *args):
    fn(*args)
    sync_all()
    t = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    sync_all()
    return out, (time.perf_counter() - t) / REPS


def dp_split_cards(n: int, smi) -> None:
    """The serving session split along its stream axis, one stream group a
    card, against the same split with every group on card 0."""
    import torch

    import chip_smoke
    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.parallel import serve_scan as ss
    from screenpressor_tpu_torch.parallel import serving as ts
    from screenpressor_tpu_torch.synth import synth_screencast

    card0 = torch.device("cuda", 0)
    s, sh, sw, steps = 64, 360, 640, chip_smoke.WIN_STEPS
    scfg = CodecConfig(width=sw, height=sh, kf_interval=150, k_fixed=64, msr_x=256, msr_y=256)
    offsets = (np.arange(s) * 150) // s
    base = synth_screencast(sh, sw, steps, seed=3)
    batches = [torch.as_tensor(np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(s)]),
                               device=card0) for t in range(steps)]
    groups = {"cards": [torch.device("cuda", i) for i in range(n)], "card 0": [card0] * n}
    outs = {}
    for path in ("serve_pipelined", "serve_windowed"):
        for label, devs in groups.items():
            def serve(devs=devs, path=path):
                enc = ts.BatchedEncoder(s, scfg, kf_offsets=offsets, devices=devs)
                dec = ts.BatchedDecoder(s, scfg, devices=devs)
                got = list(ts.serve_pipelined(enc, batches, dec) if path == "serve_pipelined"
                           else ss.serve_windowed(enc, batches, dec))
                dec.validate()
                return got

            got, dt = timed(serve)
            for t, ((_, back), frames) in enumerate(zip(got, batches)):
                if not torch.equal(back.to(card0), frames):
                    raise AssertionError(f"dp {path} on {label}, step {t}: not lossless")
            outs[path, label] = [o for o, _ in got]
            print(f"dp split, {n} groups on {label}, {path}: {s} streams x {steps} steps "
                  f"{dt:.4f} s, {s * steps / dt:.2f} stream-frames/s, mean of {REPS}, on {smi}")
        if outs[path, "cards"] != outs[path, "card 0"]:
            raise AssertionError(f"dp {path}: the cards' bytes differ from card 0's")
    print("dp split: bytes of the cards equal card 0's, decode lossless")


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # a `tests` package elsewhere
    from torch_support import sp_decode, sp_encode, sp_stage_ms  # would shadow ROOT/tests
    from screenpressor_tpu_torch import _build
    from screenpressor_tpu_torch.config import CodecConfig
    from screenpressor_tpu_torch.parallel import mesh as tm
    from screenpressor_tpu_torch.synth import synth_screencast
    from screenpressor_tpu_torch.tables import renew_tables_streams

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_mesh_cards: needs at least 2 CUDA devices, {n} visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"{n} cards: {smi}")
    _build.build()
    if "--dp-only" in sys.argv:
        dp_split_cards(n, smi)
        print(json.dumps({"ok": True, "cards": n, "smi": smi}))
        return 0
    with open(os.path.join(ROOT, "tests", "data", "torch_native_4k_8.json")) as fh:
        pinned = json.load(fh)["frames"]
    frames = synth_screencast(H, W, N)
    cfg = CodecConfig(width=W, height=H)
    mpix = H * W * N / 1e6
    card0 = torch.device("cuda", 0)
    meshes = {"cards": tm.make_mesh(n, sp=n),
              "card 0": tm.make_mesh(n, sp=n, devices=[card0] * n)}
    for label, mesh in meshes.items():
        print(f"{label}: {mesh}")
        got, t_enc = timed(sp_encode, frames, mesh, cfg)
        for i, ((p, ft), want) in enumerate(zip(got, pinned, strict=True)):
            have = {"size": len(p), "ftype": ft, "sha256": hashlib.sha256(p).hexdigest()}
            if have != want:
                raise AssertionError(f"{label} frame {i}: {have} != pinned {want}")
        dec, t_dec = timed(sp_decode, got, mesh, cfg)
        for i, (f, o) in enumerate(zip(frames, dec)):
            if not np.array_equal(o.cpu().numpy(), f):
                raise AssertionError(f"{label} frame {i}: decode is not lossless")
        _, st = sp_stage_ms(lambda: sp_decode(sp_encode(frames, mesh, cfg), mesh, cfg))
        stages = ", ".join(f"{k} {v:.3f} ms" for k, v in st.items())
        print(f"4K sp {n} on {label}: 8 frames equal the pinned digests, decode lossless; "
              f"encode {mpix / t_enc:.3f} Mpix/s ({t_enc:.4f} s), decode {mpix / t_dec:.3f} "
              f"Mpix/s ({t_dec:.4f} s), mean of {REPS}; stages (device time under "
              f"torch.profiler): {stages}")

    if n >= 4:
        s, sh, sw = 64, 360, 640
        base = synth_screencast(sh, sw, 2, seed=3)
        host = [np.stack([np.roll(base[t], 3 * i, axis=1) for i in range(s)])
                for t in range(2)]
        outs = {}
        for label, devs in (("cards", None), ("card 0", [card0] * 4)):
            mesh = tm.make_mesh(4, sp=2, devices=devs)
            tabs = renew_tables_streams(s, card0)
            res, t_dry = timed(tm.dryrun_step, host[1], host[0], tabs, mesh)
            outs[label] = res
            print(f"dryrun step dp 2 x sp 2 on {label}: {t_dry:.4f} s, mean of {REPS}")
        (a_an, a_enc, a_tab), (b_an, b_enc, b_tab) = outs["cards"], outs["card 0"]
        for x, y in zip((*a_an, *a_enc), (*b_an, *b_enc)):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError("dryrun step: the four cards differ from card 0")
        for kd in ("ptype", "nrun"):
            for key in a_tab[kd]:
                if not torch.equal(a_tab[kd][key].cpu(), b_tab[kd][key].cpu()):
                    raise AssertionError(f"dryrun step: table {kd}.{key} differs")
        print("dryrun step: fits, flags, lane bytes, n_records and tables of the four "
              "cards equal card 0's")
    dp_split_cards(n, smi)
    print(json.dumps({"ok": True, "cards": n, "smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
