"""BENCHMARK.json against the contract's character and length rules, and
the harness finding every file of a cell, metric and driver by name (a
new cell, mix or metric is new files and entries only)."""

import json
import re
import shutil

import pytest

from spbench.run import HERE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:  # every listed cell reports what the metric moves
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        own = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert len(own) >= 2 and any(m["name"] == "setup_s" for m in own)
        assert any(w in m.get("workloads", ()) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    _, w, config, traffic = load_cell(cell)
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("spbench/configs/")
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    assert (HERE / "drivers" / f"{config['driver']}.py").exists()
    assert "cycle" in traffic
    for m in BENCH["per_layer"]:
        assert (HERE / "layers" / f"{m['name']}.py").exists(), m["name"]


def test_new_cell_is_files_and_entries(tmp_path):
    """A copy of the checkout with one more traffic file and one more
    workload entry runs that cell's lookup without any edited file."""
    shutil.copytree(HERE, tmp_path / "spbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "conf-64x360p.still", "config": "conf-64x360p",
                               "traffic": "still", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    t = json.loads((HERE / "traffic" / "staggered.json").read_text())
    t["cycle"] = ["idle"]
    (tmp_path / "spbench" / "traffic" / "still.json").write_text(json.dumps(t))
    _, w, config, traffic = load_cell("conf-64x360p.still", tmp_path)
    assert traffic["cycle"] == ["idle"] and config["driver"] == "serving"
