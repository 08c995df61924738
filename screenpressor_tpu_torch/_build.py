"""Build, load and count the hand-written Hopper kernels.

`csrc/*.cu` compile with `nvcc` for `sm_90a`, one process per source, all
started together, and link into one shared library with a plain C
interface under `build/torch_kernels/` (next to the package), named by a
hash of the sources so an edited source rebuilds on first use. The
library is loaded with ctypes; every kernel wrapper calls `launch`, which
adds one to that kernel's launch count (and K1's colw variant's, for a
launch that holds a colw section), makes the inputs' card current and
passes its current stream, and raises when the launch is refused.
Compiling the sources side by side bounds the build by its slowest
source, not by their sum.

Nothing here runs at import: the build happens on the first launch, so the
CPU tests (no nvcc, no card) import every module freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry point -> argument types (every launcher returns a cudaError_t)
SIGNATURES = {
    "sptc_sections_encode": (_P, _I, _I, _P),
    "sptc_sections_decode": (_P, _I, _I, _P),
    "sptc_run_walk": (_P, _P, _P, _L, _I, _P),
    "sptc_recon_rows": (_P, _P, _I, _I, _I, _I, _P),
    "sptc_analyze_blocks": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "sptc_rebuild_blocks": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    "sptc_rgb32_to_rgb24": (_P, _P, _L, _I, _P),
    "sptc_rgb24_to_rgb32": (_P, _P, _L, _I, _P),
    "sptc_resolve_blocks": (_P, _P),
}

# kernel -> launches since the last reset_counts(); a K1 launch that holds
# a colw section also adds one to `sptc_sections_encode_colw`.
LAUNCHES = {name: 0 for name in (*SIGNATURES, "sptc_sections_encode_colw")}

_LOCK = threading.Lock()
_LIB = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsptc_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _run(cmds, verbose: bool) -> None:
    """Run the commands side by side; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        if verbose and out:
            print(out, flush=True)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, cmds = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                     "-c", "-o", str(obj), str(src)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run(cmds, verbose)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]], verbose)
        os.replace(tmp, out)
    finally:
        for leftover in (*objs, tmp):
            leftover.unlink(missing_ok=True)
    return out


def library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def launch(name: str, *args, device, counts=None) -> None:
    """Launch C entry `name` on `device` (the inputs' card: made current for
    the launch, on its current stream) and add one to each of `counts`
    (default: `name`); raises if the launch is refused."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    for count in counts or (name,):
        LAUNCHES[count] += 1


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def require_cuda(*tensors: torch.Tensor) -> None:
    """A kernel wrapper's input check: every tensor on one CUDA device,
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
