"""Helpers of the harness's tests."""

import json

from spbench.run import HERE


def traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())
