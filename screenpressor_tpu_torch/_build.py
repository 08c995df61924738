"""Build, load and count the hand-written Hopper kernels.

`csrc/*.cu` compile with `nvcc` for `sm_90a` into one shared library with a
plain C interface under `build/torch_kernels/` (next to the package), named
by a hash of the sources so an edited source rebuilds on first use. The
library is loaded with ctypes; every kernel wrapper calls `launch`, which
adds one to that kernel's launch count, passes PyTorch's current stream and
raises when the launch is refused.

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
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry point -> argument types (every launcher returns a cudaError_t)
SIGNATURES = {
    "sptc_sections_encode": (_P, _I, _P),
    "sptc_sections_decode": (_P, _I, _P),
    "sptc_run_walk": (_P, _P, _P, _L, _I, _P),
    "sptc_recon_rows": (_P, _P, _P, _I, _I, _I, _P),
}

# kernel name -> launches since the last reset_counts()
LAUNCHES = {name: 0 for name in SIGNATURES}

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


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp)] + [str(s) for s in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
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


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream; raises if refused."""
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    LAUNCHES[name] += 1


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
