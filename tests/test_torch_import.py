"""The port never imports JAX: checked in a fresh interpreter."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("_build", "blocks", "classify", "codec", "coder", "convert",
           "iframe", "kernels", "parallel.serving", "pframe", "recon", "substeps",
           "tables")


def test_port_imports_no_jax():
    code = (
        "import sys, importlib\n"
        "import screenpressor_tpu_torch\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module('screenpressor_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('screenpressor_tpu.jx')\n"
        "             or m.startswith('screenpressor_tpu.parallel'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120, check=True)
    assert out.stdout.strip() == "", f"port imported {out.stdout.strip()}"


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrappers never build or launch a kernel."""
    import torch

    from screenpressor_tpu_torch import _build, classify, recon

    _build.reset_counts()
    bits = torch.zeros(300, dtype=torch.int32)
    classify.run_walk(bits, bits, 256)
    pt = torch.ones((2, 128), dtype=torch.int32)
    recon.recon_rows(pt, torch.zeros((2, 128, 3), dtype=torch.int32), 100)
    assert all(v == 0 for v in _build.LAUNCHES.values())
