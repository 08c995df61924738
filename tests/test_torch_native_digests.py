"""The pinned byte oracles of the port's smoke run on the card: for each
frame of `synth_screencast(h, w, n)` under `CodecConfig(width=w,
height=h)`, the size, the frame type and the SHA-256 of the native C++
codec's bytes. tests/data/torch_native_1080p_64.json holds the 64 frames
of the single-stream session at 1920x1080, torch_native_4k_8.json the 8
frames of the row-sharded (sp) session at 3840x2160. The card's machine
has no JAX package to run, so `chip_smoke.py` compares the port's payloads
with these digests.

Regenerate both (numpy and the native codec, a few seconds on one CPU
core):
    python -m tests.test_torch_native_digests
"""

import hashlib
import json
import os

import numpy as np
import pytest

from __graft_entry__ import _synth_frame as graft_synth_frame
from bench import synth_screencast as bench_synth
from screenpressor_tpu.config import CodecConfig
from screenpressor_tpu.native import NativeEncoder
from screenpressor_tpu_torch.synth import synth_frame, synth_screencast

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PATH = os.path.join(DATA, "torch_native_1080p_64.json")
PATH_4K = os.path.join(DATA, "torch_native_4k_8.json")
H, W, N = 1080, 1920, 64
H4, W4, N4 = 2160, 3840, 8


def native_digests(h=H, w=W, n=N) -> dict:
    cfg = CodecConfig(width=w, height=h)
    enc = NativeEncoder(cfg)
    frames = []
    for f in synth_screencast(h, w, n):
        data, ftype = enc.encode(f)
        frames.append({"size": len(data), "ftype": ftype,
                       "sha256": hashlib.sha256(data).hexdigest()})
    return {"height": h, "width": w, "n_frames": n, "seed": 0,
            "config": f"CodecConfig(width={w}, height={h})", "frames": frames}


def test_pinned_digests_reproduce():
    with open(PATH) as fh:
        pinned = json.load(fh)
    assert native_digests() == pinned


def test_pinned_4k_digests_reproduce():
    with open(PATH_4K) as fh:
        pinned = json.load(fh)
    assert native_digests(H4, W4, N4) == pinned


@pytest.mark.parametrize("shape", [(16, 32, 0), (64, 64, 3), (2160, 3840, 7)])
def test_port_synth_frame_equals_graft_entry(shape):
    h, w, seed = shape
    np.testing.assert_array_equal(synth_frame(h, w, seed), graft_synth_frame(h, w, seed))


@pytest.mark.parametrize("shape", [(H, W, N, 0), (360, 640, 5, 3)])
def test_port_synth_equals_bench(shape):
    h, w, n, seed = shape
    ours, theirs = synth_screencast(h, w, n, seed=seed), bench_synth(h, w, n, seed=seed)
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    for path, shape in ((PATH, (H, W, N)), (PATH_4K, (H4, W4, N4))):
        with open(path, "w") as fh:
            json.dump(native_digests(*shape), fh, indent=1)
            fh.write("\n")
        print(f"wrote {path}")
