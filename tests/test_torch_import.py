"""The port imports neither JAX nor the JAX package: checked on the sources
(every import statement) and in a fresh interpreter."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("_build", "api", "bitstream", "blocks", "classify", "codec", "coder",
           "colorspace", "config", "convert", "iframe", "kernels", "parallel.mesh",
           "parallel.serve_scan", "parallel.serving",
           "pframe", "recon", "substeps", "synth", "tables")

# files that run on the card, where neither JAX nor the reference is imported
PORT_FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "screenpressor_tpu_torch", "**", "*.py"),
                       recursive=True)
) + ["chip_smoke.py", "tests/test_torch_kernels_gpu.py"]
FORBIDDEN = ("screenpressor_tpu", "bench", "jax")


def _imported(src):
    """Top-level package of every module an absolute import names."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_the_reference(path):
    with open(os.path.join(ROOT, path)) as fh:
        bad = sorted({m for m in _imported(fh.read()) if m in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_import_check_sees_the_reference():
    """The AST check flags a dotted import and a plain one."""
    src = ("import screenpressor_tpu.jx.coder\nfrom bench import synth_screencast\n"
           "def f():\n    from screenpressor_tpu import native\n"
           "from screenpressor_tpu_torch import coder\n")
    assert set(_imported(src)) == {"screenpressor_tpu", "bench", "screenpressor_tpu_torch"}


def test_port_imports_no_jax():
    code = (
        "import sys, importlib\n"
        "import screenpressor_tpu_torch\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module('screenpressor_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'bench'\n"
        "             or m == 'screenpressor_tpu' or m.startswith('screenpressor_tpu.'))\n"
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
    recon.recon_rows(recon.pack_rows(pt, torch.zeros((2, 128, 3), dtype=torch.int32)), 100)
    assert all(v == 0 for v in _build.LAUNCHES.values())
