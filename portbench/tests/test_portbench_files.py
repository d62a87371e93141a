"""Every file the benchmark finds by name is there, loads, and keeps to the
names and limits of BENCHMARK.json."""

import importlib
import math
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = spec.load_json("configs", cfg["name"])
    assert os.path.join(spec.ROOT, cfg["file"]) == os.path.join(spec.HERE, "configs", cfg["name"] + ".json")
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
    assert NAME.match(cfg["name"]) and 1 <= len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_file(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = spec.load_cell(name)
    raw = spec.load_json("workloads", name)
    assert raw["config"] == w["config"] and raw["traffic"] == w["traffic"] and w["chips"] == 1
    assert NAME.match(name) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    entry = spec.entry_module(cell)
    assert callable(entry.setup)
    assert set(cell.limits) == set(entry.NUMBERS)
    assert all(math.isfinite(v) and v >= 0 for v in cell.limits.values())


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    if metric in BENCH["per_layer"]:
        assert callable(spec.metric_reader(metric["name"]).read)
        assert any(m["name"] == metric["moves"] for m in BENCH["end_to_end"])
    else:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")


def test_every_module_imports():
    for root, _, files in os.walk(spec.HERE):
        if "tests" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py") and f not in ("conftest.py", "run.py"):
                rel = os.path.relpath(os.path.join(root, f), spec.ROOT)[:-3].replace(os.sep, ".")
                importlib.import_module(rel.removesuffix(".__init__"))
