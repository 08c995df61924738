"""What the harness loads: a CPU run of a cell's set-up and window loads no
module of JAX or of the JAX package (top-level names compared whole), and
the reference loads nothing of the port."""

import json
import subprocess
import sys

from spbench.run import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "screenpressor_tpu"]

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from spbench import run as R
res = R.run({cell!r}, 2**31 + 3, 0.5, False, devices=["cpu"],
            config_override={over})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_session_run_loads_no_jax():
    mods = _modules(RUN.format(root=str(ROOT), cell="desktop-1080p-rgb32.browse",
                               over={"width": 176, "height": 96, "batch_frames": 4}))
    assert "screenpressor_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_serving_run_loads_no_jax():
    mods = _modules(RUN.format(root=str(ROOT), cell="conf-64x360p.staggered",
                               over={"width": 192, "height": 96, "streams": 2}))
    assert not mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            "import spbench.reference.sptc, spbench.work.roofline; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    mods = _modules(code)
    assert not mods & set(FORBIDDEN + ["screenpressor_tpu_torch", "torch"])
