"""The visual front's own bf16 gradient: the mirror of
``test_bf16_first_moment_with_fp32_front`` (``tests/test_torch_train_bf16.py``).

One step of the port and of the JAX package's ``make_train_step`` with the
visual front in bf16 and the six other modules in fp32, from the same
weights, batch and noise (the narrow config and helpers of
``tests/test_torch_train_step.py``); each module's first moment after the
step is read against the port's fp32 one as ``tests/test_torch_train_bf16.py``
reads it: the cross distance (port against JAX) and the port's spread as
multiples of the JAX package's spread, and alpha, the difference of the two
moments' projections on the fp32 one (a gradient scaled by s moves it by
about 1 - s).
- The visual front, the decoder, the postnet, dis3 and the sync critic:
  the tight bounds of the fp32-front test (cross within 1.5 x the spread,
  the port's spread 0.5-1.5 x, alphas within 0.03).  Measured: cross
  1.05-1.23 x, the port's spread 1.04-1.17 x, alphas within 9.8e-3 (the
  visual front 1.19 x, 1.10 x, 9.7e-3).
- dis1 and dis2: their conditional heads magnify the bf16 error of the
  visual front's ``sent`` as in the whole bf16 step (module docstring
  there), so they take that test's loose bounds (4 x, 0.25-4 x, 0.25);
  measured 2.18 / 3.57 x, 2.25 / 3.65 x, alphas -0.168 / -0.129.
A visual-front gradient scaled by 0.9 in bf16 fails the visual front's
case (alpha 0.085; a mutation check made in a copy of the port).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_discriminator import train_variables  # noqa: E402
from test_torch_train_bf16 import check_readings  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    CONVERTERS, NARROW, JaxModelConfig, JaxModules, jax_steps, make_batch, port_steps)

BF16_FRONT = ("v_front",)
LOOSE = ("dis1", "dis2")  # behind the conditional heads


@pytest.fixture(scope="module")
def front_run():
    params, stats = train_variables(JaxModules.create(JaxModelConfig(**NARROW)), seed=31)
    batch = make_batch()
    _, _, fp32 = port_steps(params, stats, batch, True, 1)
    _, _, jax_front = jax_steps(params, stats, batch, True, 1, bf16=BF16_FRONT)
    _, _, port_front = port_steps(params, stats, batch, True, 1, bf16=BF16_FRONT)
    return fp32[0], jax_front[0], port_front[0]


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_bf16_first_moment_with_bf16_front(front_run, name):
    """The visual front in bf16, the six other modules in fp32: each
    module's first moment against the JAX package's (module docstring)."""
    fp32, jax_, port = front_run
    check_readings(port[name], jax_[name], fp32[name], "bf16" if name in LOOSE else "fp32 front")
