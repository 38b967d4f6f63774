"""BENCHMARK.json against the benchmark's contract: names and units,
every cell on one chip, each per-layer metric's cells reporting its
``moves`` target, and every file the manifest implies under portbench/."""

import json
import re

import pytest

from portbench import run
from portbench.tests.cells import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    metrics = m["end_to_end"] + m["per_layer"]
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [x["name"] for x in metrics])
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in m["workloads"]]:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert {x["name"] for x in m["end_to_end"]} >= {"setup_s"}
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(m)) < 64 * 1024


def test_cells_one_chip_and_metric_targets():
    m = manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    configs = {c["name"] for c in m["configs"]}
    assert {w["config"] for w in cells.values()} == configs
    assert all(w["chips"] == 1 for w in cells.values())
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["workloads"] and set(x["workloads"]) <= set(cells)
        target = e2e[x["moves"]]
        for w in x["workloads"]:
            assert w in target.get("workloads", cells), (x["name"], w)
    for name in cells:
        cell = run.load_cell(name)
        assert {x["name"] for x in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_cell_files(name):
    """Each cell's configuration, traffic mix, template and per-layer
    readers exist under portbench/, and the configuration holds limits."""
    cell = run.load_cell(name)
    cfg = cell["config"]
    assert cfg["entry"] in ("rpf", "render")
    assert (ROOT / (cfg["reference"].replace(".", "/") + ".py")).exists() or \
        (ROOT / cfg["reference"].replace(".", "/") / "__init__.py").exists()
    assert (ROOT / "portbench" / "scenes" / cfg["scene"]["template"]).exists()
    assert cfg["limits"] and all(v > 0 for v in cfg["limits"].values())
    for x in cell["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{x['name']}.py").exists()
