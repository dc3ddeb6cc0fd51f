"""What the reference and a run load, by whole top-level module names."""

import subprocess
import sys

from benchmark.harness import spec

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.dsp, benchmark.reference.model, benchmark.reference.pipeline
import benchmark.reference.serve, benchmark.reference.train, benchmark.reference.weights
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'vcagan', 'vcagan_torch'}}))
"""

RUN = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + '/benchmark')
import torch
from benchmark.tests.helpers_bench import small_cell
from benchmark.kinds import serve, train
from run import loaded_forbidden
serve.run(small_cell('grid-serve-bf16', True), 3, 0.3, True, torch.device('cpu'), time.perf_counter())
train.run(small_cell('grid-train-bf16', True), 3, 0.3, True, torch.device('cpu'), time.perf_counter())
print(loaded_forbidden(), 'vcagan_torch' in sys.modules)
"""


def run_python(code):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code.format(root=spec.ROOT)], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_program_or_jax():
    assert run_python(REFERENCE) == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The port's name begins with the JAX package's; names compare whole."""
    assert run_python(RUN) == "[] True"
