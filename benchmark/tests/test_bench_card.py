"""On the card: each cell, run as its command line runs it, for a short window,
prints one correct result line.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
