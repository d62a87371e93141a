"""Each cell once on the card, briefly, through the benchmark's command:
it prints a result line that is correct (skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_runs_on_the_card(name, card):
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload", name, "--seed",
                          "4294967311", "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
