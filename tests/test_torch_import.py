"""The port imports neither JAX nor the JAX package: checked on the sources
(every import statement) and in a fresh interpreter. The sessions import
none of one another: they share what lies below them (the container
writer, the host <-> card copies), and the bitstream module stays free of
torch."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("_build", "api", "bitstream", "blocks", "classify", "codec", "coder",
           "colorspace", "config", "container", "convert", "iframe", "kernels",
           "parallel.mesh", "parallel.serve_scan", "parallel.serving",
           "pframe", "recon", "substeps", "synth", "tables", "transfer")
# the sessions: the desktop session, serving, the sp mesh, window serving
SESSIONS = ("codec", "parallel.serving", "parallel.mesh", "parallel.serve_scan")
PORT = "screenpressor_tpu_torch"

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


def _port_imports(src):
    """(module, names) of each import in src: a port module by its name
    under the package ("parallel.serving"), with the names imported from
    it; another module by its full name."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.removeprefix(PORT + "."), []
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [a.name for a in node.names]
            if node.module in (PORT, PORT + ".parallel"):  # modules by name
                base = node.module.removeprefix(PORT).lstrip(".")
                for n in names:
                    yield (base + "." + n).lstrip("."), []
            else:
                yield node.module.removeprefix(PORT + "."), names


def _layering_faults(module: str, src: str) -> list:
    """What a session module (one of SESSIONS) imports of another session or
    of a `_private` name of a port module; what bitstream imports of torch
    or of a port module but config."""
    faults = []
    for mod, names in _port_imports(src):
        if module == "bitstream":
            port = mod.startswith(PORT) or mod in MODULES
            if mod.split(".")[0] == "torch" or (port and mod != "config"):
                faults.append(mod)
        elif mod in SESSIONS and mod != module:
            faults.append(mod)
        elif mod in MODULES:
            faults += [f"{mod}.{n}" for n in names if n.startswith("_")]
    return faults


@pytest.mark.parametrize("module", SESSIONS + ("bitstream",))
def test_sessions_import_none_of_one_another(module):
    path = os.path.join(ROOT, PORT, *module.split(".")) + ".py"
    with open(path) as fh:
        assert not _layering_faults(module, fh.read())


def test_layering_check_sees_a_sibling_and_a_private_name():
    src = ("from screenpressor_tpu_torch.codec import FTYPE_I, _pull\n"
           "from screenpressor_tpu_torch.parallel import serving\n"
           "import screenpressor_tpu_torch.parallel.serve_scan as ss\n"
           "from screenpressor_tpu_torch import _build, container\n"
           "from screenpressor_tpu_torch.pframe import _own_rows\n")
    assert _layering_faults("parallel.mesh", src) == [
        "codec", "parallel.serving", "parallel.serve_scan", "pframe._own_rows"]
    assert _layering_faults("bitstream", "import torch\nimport numpy as np\n"
                            "from screenpressor_tpu_torch.config import ALG_I\n"
                            "from screenpressor_tpu_torch import coder\n") == ["torch", "coder"]


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
