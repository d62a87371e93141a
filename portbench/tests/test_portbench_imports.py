"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: checked in fresh processes, on the
top-level name of every loaded module, compared whole."""

import json
import os
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "icp_slam_yolo_tpu"}


def _modules(package_dir: str) -> list:
    out = []
    for root, _, files in os.walk(package_dir):
        if "tests" in root.split(os.sep):
            continue
        for f in sorted(files):
            if f.endswith(".py") and f != "conftest.py":
                rel = os.path.relpath(os.path.join(root, f), spec.ROOT)[:-3].replace(os.sep, ".")
                out.append(rel.removesuffix(".__init__"))
    return out


def _loaded_after_importing(modules: list) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=spec.ROOT,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax():
    mods = _modules(spec.HERE)
    assert "portbench.run" in mods and "portbench.reference.slam" in mods
    assert not _loaded_after_importing(mods) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after_importing(_modules(os.path.join(spec.HERE, "reference")))
    assert not loaded & (FORBIDDEN | {"icp_slam_yolo_tpu_torch"})
