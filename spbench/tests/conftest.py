"""The harness's own tests: `python -m pytest spbench/tests -q` from the
checkout's root (on the CPU; the tests marked `gpu` run where a CUDA card
is visible: `python -m pytest spbench/tests -q -m gpu`)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
