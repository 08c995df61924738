"""The pinned byte oracle of the port's smoke run on the card
(tests/data/torch_native_1080p_64.json): for each of the 64 frames of
`synth_screencast(1080, 1920, 64)` under `CodecConfig(width=1920,
height=1080)`, the size, the frame type and the SHA-256 of the native C++
codec's bytes. The card's machine has no JAX package to run, so
`chip_smoke.py` compares the port's payloads with these digests.

Regenerate (numpy and the native codec, about a second on one CPU core):
    python -m tests.test_torch_native_digests
"""

import hashlib
import json
import os

import numpy as np
import pytest

from bench import synth_screencast as bench_synth
from screenpressor_tpu.config import CodecConfig
from screenpressor_tpu.native import NativeEncoder
from screenpressor_tpu_torch.synth import synth_screencast

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_native_1080p_64.json")
H, W, N = 1080, 1920, 64


def native_digests() -> dict:
    cfg = CodecConfig(width=W, height=H)
    enc = NativeEncoder(cfg)
    frames = []
    for f in synth_screencast(H, W, N):
        data, ftype = enc.encode(f)
        frames.append({"size": len(data), "ftype": ftype,
                       "sha256": hashlib.sha256(data).hexdigest()})
    return {"height": H, "width": W, "n_frames": N, "seed": 0,
            "config": "CodecConfig(width=1920, height=1080)", "frames": frames}


def test_pinned_digests_reproduce():
    with open(PATH) as fh:
        pinned = json.load(fh)
    assert native_digests() == pinned


@pytest.mark.parametrize("shape", [(H, W, N, 0), (360, 640, 5, 3)])
def test_port_synth_equals_bench(shape):
    h, w, n, seed = shape
    ours, theirs = synth_screencast(h, w, n, seed=seed), bench_synth(h, w, n, seed=seed)
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    with open(PATH, "w") as fh:
        json.dump(native_digests(), fh, indent=1)
        fh.write("\n")
    print(f"wrote {PATH}")
