"""Where the benchmark finds its files, and the card's published peaks.

A cell is ``workloads/<cell>.json``: ``config`` and ``traffic`` name
``configs/<config>.json`` and ``traffic/<traffic>.json``, ``entry`` names
``entries/<entry>.py``, ``check`` says which answers of the window the check
samples and ``limits`` holds the limit of each number it compares.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BF16 = 989e12   # bfloat16 tensor-core operations/s
PEAK_FP32 = 67e12    # float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM bytes/s


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    entry: str
    check: dict
    limits: dict
    why: str


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({os.path.relpath(path, ROOT)})")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    spec = load_json("workloads", name)
    return Cell(name=name, config=load_json("configs", spec["config"]), traffic=load_json("traffic", spec["traffic"]),
                entry=spec["entry"], check=spec.get("check", {}), limits=spec.get("limits", {}), why=spec["why"])


def entry_module(cell: Cell):
    if not _NAME.match(cell.entry):
        raise ValueError(f"not an entry name: {cell.entry!r}")
    return importlib.import_module(f"portbench.entries.{cell.entry}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (a dot in the metric's name is ``_`` in the file's)."""
    module = name.replace(".", "_")
    if not _NAME.match(module):
        raise ValueError(f"not a metric name: {name!r}")
    return importlib.import_module(f"portbench.metrics.{module}")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
