"""The PyTorch port's bf16 train step against the JAX package's.

``ModelConfig(use_bfloat16=True)``: two steps of the port and of the JAX
package's own ``make_train_step`` from the same weights, batch and noise,
at the narrow config, B = 2 and the lr milestone of
``tests/test_torch_train_step.py`` (whose helpers this file uses); one step
of both with the visual front in fp32 and the six other modules in bf16;
and one step of the port in fp32, the anchor below.

First moments.  In bf16 this network's gradients lie far from fp32's in
both packages (each package's first moment after step 1 is 6-39% from the
fp32 one, relative L2), while the port's and the JAX package's fp32
moments agree to 3.4e-3 (the fp32 test), so the port's fp32 moment
anchors both.  Each module is read, as shares of the anchor's norm, by the
cross distance (port against JAX), the JAX package's spread (its distance
from the anchor, the yardstick), the port's spread, and alpha, a moment's
projection on the anchor, <m, f> / <f, f>: a gradient scaled by s moves
alpha by about 1 - s, however large the rounding noise.
- The whole bf16 step, loose: the discriminators' conditional heads
  magnify the bf16 error of the visual front's ``sent``.  Their gradient is
  a near-cancelling sum of a real and a fake term that share the tiled time
  mean of ``sent``, so the few per cent that bf16 moves ``sent`` in either
  package move dis1's and dis2's gradients by 14-53%, as each package's
  roundings happen to fall.  Bounds from the readings: cross within 4 x the
  JAX package's spread (measured 0.98-3.4, the most in dis2), the port's
  spread 0.25-4 x it (1.11-3.6), alphas within 0.25 (0.175, dis1): they
  catch a halved or lost gradient, not a 10% one.
- The visual front in fp32, tight: both packages' ``sent`` then agree to
  1e-5 and what is left is the six modules' own rounding.  Measured: cross
  0.53-1.15 x the spread, the port's spread 0.89-1.09 x, alphas within
  4.6e-3 (on the card against the CPU at full width, ``chip_smoke.py``
  phase 10 (b), 0.49-1.10 x, 0.89-1.11 x and 1.0e-2).  Bounds: 1.5 x,
  0.5-1.5 x and 3e-2, so a module's gradient scaled by 0.9 fails.
- R1's gradient alone, each discriminator on random real mels at its
  scale (R1 is 2e-4 of the D loss, so the step's moments cannot see it):
  cross 0.59-1.41 x, the port's spread 1.06-1.13 x, alphas within 6.8e-3
  (on the card against the CPU at full width 0.55-0.93 x, 0.81-1.06 x and
  2.4e-2); bounds 2 x, 0.5-2 x and 5e-2.  PyTorch's own CPU bf16 convolution, whose
  second derivative is wrong at 80 x 80 maps, read 6.7 x, 6.8 x and -0.10
  in dis3 (the port's CPU convolutions no longer use it in bf16).
Mutation checks, each in a copy: dis3's or the postnet's gradient x 0.9 in
bf16 fails the fp32-front test; the visual front's x 0.5 fails the whole
step's test and the metrics; the discriminators' dense heads computing in
bf16 (fp32 out) fail ``test_bf16_dtypes``, their rounding lying below the
modules' spreads; PyTorch's CPU bf16 convolution put back fails the R1
test in dis3.
Losses rtol 2e-2 (measured 1e-2 at most), gradient norms 1e-1 (3e-2);
BatchNorm statistics within 0.05 anywhere and 0.1 of their move (measured
0.021 and 0.039).  The updates are not compared: at the first step an
update is lr * sign(g), and 2-15% of the signs differ between bf16 and
fp32 in either package.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_discriminator import train_variables  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    CONVERTERS, GRAD_NORMS, NARROW, B, JaxModelConfig, JaxModules, as_jax_trees, flat, jax_steps,
    make_batch, port_steps)
from vcagan.nn.losses import r1_penalty as jax_r1_penalty  # noqa: E402
from vcagan_torch.configs import ModelConfig, TrainConfig  # noqa: E402
from vcagan_torch.io.weights import from_jax  # noqa: E402
from vcagan_torch.nn.losses import r1_penalty  # noqa: E402
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step  # noqa: E402
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE  # noqa: E402

BF16 = {**NARROW, "use_bfloat16": True}
ALL_MODULES = tuple(CONVERTERS)
FP32_FRONT = tuple(name for name in ALL_MODULES if name != "v_front")
BF16_LOSS_RTOL, BF16_NORM_RTOL = 2e-2, 1e-1
# first moments: cross / spread, (least, most) own spread / spread, |alpha - alpha|
BOUNDS = {"bf16": (4.0, (0.25, 4.0), 0.25), "fp32 front": (1.5, (0.5, 1.5), 0.03),
          "r1": (2.0, (0.5, 2.0), 0.05)}
BF16_STATS_MAX, BF16_STATS_REL = 0.05, 0.1


def moment_readings(got, want, anchor):
    """The port's first moment ``got`` and the JAX package's ``want`` of one
    module against the fp32 ``anchor``, as shares of the anchor's norm:
    (cross, the JAX package's spread, the port's spread, alpha - alpha),
    alpha a moment's projection on the anchor, <m, f> / <f, f>."""
    g, w, f = (flat(t).astype(np.float64) for t in (got, want, anchor))
    norm = np.linalg.norm(f)
    alpha = (g - w) @ f / norm ** 2
    return (np.linalg.norm(g - w) / norm, np.linalg.norm(w - f) / norm,
            np.linalg.norm(g - f) / norm, alpha)


@pytest.fixture(scope="module")
def bf16_run():
    params, stats = train_variables(JaxModules.create(JaxModelConfig(**NARROW)), seed=31)
    batch = make_batch()
    jax_state, jax_metrics, jax_moments = jax_steps(params, stats, batch, True, 2, model=BF16)
    port_state, port_metrics, port_moments = port_steps(params, stats, batch, True, 2,
                                                        model=BF16)
    _, _, fp32_moments = port_steps(params, stats, batch, True, 1)
    _, _, jax_front = jax_steps(params, stats, batch, True, 1, bf16=FP32_FRONT)
    _, _, port_front = port_steps(params, stats, batch, True, 1, bf16=FP32_FRONT)
    return dict(stats=stats, jax_state=jax_state, jax_metrics=jax_metrics,
                port_state=port_state, port_metrics=port_metrics, fp32_moments=fp32_moments[0],
                moments={"bf16": (port_moments[0], jax_moments[0]),
                         "fp32 front": (port_front[0], jax_front[0])})


@pytest.mark.parametrize("step", [0, 1])
def test_bf16_metrics(bf16_run, step):
    want, got = bf16_run["jax_metrics"][step], bf16_run["port_metrics"][step]
    assert sorted(got) == sorted(want) and len(want) == 9
    for k in want:
        rtol = BF16_NORM_RTOL if k in GRAD_NORMS else BF16_LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-5, err_msg=k)


def check_readings(got, want, anchor, bounds):
    cross, spread, own, alpha = moment_readings(got, want, anchor)
    k, (least, most), alpha_max = BOUNDS[bounds]
    readings = dict(cross=cross, spread=spread, own=own, alpha=alpha)
    assert cross <= k * spread, readings
    assert least * spread <= own <= most * spread, readings
    assert abs(alpha) <= alpha_max, readings


@pytest.mark.parametrize("name", ALL_MODULES)
def test_bf16_first_moment(bf16_run, name):
    """The gradient after step 1 (first moment) of the whole bf16 step,
    against the JAX package's: loose bounds (module docstring)."""
    port, jax_ = bf16_run["moments"]["bf16"]
    check_readings(port[name], jax_[name], bf16_run["fp32_moments"][name], "bf16")


@pytest.mark.parametrize("name", ALL_MODULES)
def test_bf16_first_moment_with_fp32_front(bf16_run, name):
    """The same with the visual front in fp32 and the six other modules in
    bf16: tight bounds (module docstring)."""
    port, jax_ = bf16_run["moments"]["fp32 front"]
    check_readings(port[name], jax_[name], bf16_run["fp32_moments"][name], "fp32 front")


@pytest.fixture(scope="module")
def r1_run():
    """Each discriminator's R1 gradient (of the batch mean of the squared
    input gradient of its unconditional logits) alone, on random real mels
    at its scale: the JAX package's in bf16, the port's in bf16 and fp32."""
    params, stats = train_variables(JaxModules.create(JaxModelConfig(**NARROW)), seed=31)
    states = from_jax(params, stats)
    rng = np.random.default_rng(1)
    sent = rng.standard_normal((B, 20, 512)).astype(np.float32)
    out = {}
    for name, size in (("dis1", 20), ("dis2", 40), ("dis3", 80)):
        real = np.clip(rng.standard_normal((B, size, size)), -1, 1).astype(np.float32)
        jax_module = getattr(JaxModules.create(JaxModelConfig(**BF16)), name)

        def penalty(p, jax_module=jax_module, real=real):
            return jax_r1_penalty(lambda m: jax_module.apply(
                {"params": p}, m[..., None], jnp.asarray(sent))[0], jnp.asarray(real))

        want = jax.jit(jax.grad(penalty))(params[name])
        got = []
        for model in (BF16, NARROW):
            module = getattr(VCAGANModules.create(ModelConfig(**model)), name)
            module.load_state_dict(states[name])
            x = torch.from_numpy(real).requires_grad_()
            u, _ = module(x, torch.from_numpy(sent))
            grads = torch.autograd.grad(r1_penalty(u, x), list(module.parameters()),
                                        allow_unused=True, materialize_grads=True)
            tree = dict(zip((k for k, _ in module.named_parameters()), grads))
            got.append(CONVERTERS[name]({**tree, **dict(module.named_buffers())})["params"])
        out[name] = (got[0], want, got[1])
    return out


@pytest.mark.parametrize("name", ["dis1", "dis2", "dis3"])
def test_bf16_r1_gradient(r1_run, name):
    """R1's second-order gradient in bf16 against the JAX package's, read
    as the first moments are (module docstring)."""
    check_readings(*r1_run[name], "r1")


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "s_dis"])
def test_bf16_batch_statistics(bf16_run, name):
    got = as_jax_trees(bf16_run["port_state"])[1][name]
    want = bf16_run["jax_state"].batch_stats[name]
    g, w, s = flat(got), flat(want), flat(bf16_run["stats"][name])
    assert np.abs(g - w).max() <= BF16_STATS_MAX
    assert np.linalg.norm(g - w) <= BF16_STATS_REL * np.linalg.norm(w - s)


def test_bf16_dtypes():
    """The JAX package's bf16 dtypes: bf16 activations (phon, the decoder's
    mels), fp32 parameters, sentence features, logits and losses; the
    discriminators' heads and the sync critic's projection compute in fp32
    on their bf16 input, as flax's ``Dense`` with no dtype does."""
    modules = VCAGANModules.create(ModelConfig(**BF16))
    batch = Batch(**{k: torch.from_numpy(v) for k, v in make_batch().items()})
    gen = torch.Generator().manual_seed(0)
    dense = []
    hooks = [m.register_forward_hook(lambda m, args, out: dense.append((m, args[0], out)))
             for _, module in modules.named(DISCRIMINATOR_SIDE) for m in module.modules()
             if isinstance(m, torch.nn.Linear)]
    with torch.no_grad():
        phon, sent = modules.v_front(batch.video, gen)
        g1, g2, g3 = modules.gen(sent, phon, batch.vid_len, generator=gen)
        logits = [d(g, sent) for d, g in zip((modules.dis1, modules.dis2, modules.dis3),
                                             (g1, g2, g3))]
        sync = modules.s_dis(phon, batch.mel)
    assert (phon.dtype, sent.dtype) == (torch.bfloat16, torch.float32)
    assert {g.dtype for g in (g1, g2, g3, modules.post(g3))} == {torch.bfloat16}
    assert {x.dtype for pair in logits for x in pair} | {sync.dtype} == {torch.float32}
    assert {p.dtype for p in modules.parameters(GENERATOR_SIDE + DISCRIMINATOR_SIDE)} == {
        torch.float32}
    for hook in hooks:
        hook.remove()
    assert len(dense) == 7 and {x.dtype for _, x, _ in dense} == {torch.bfloat16}
    for m, x, out in dense:
        assert torch.equal(out, torch.nn.functional.linear(x.float(), m.weight, m.bias))
    state, g_tx, d_tx = create_train_state(modules, TrainConfig(), device="cpu")
    _, metrics = make_train_step(modules, g_tx, d_tx)(state, batch, gen)
    assert {m.dtype for m in metrics.values()} == {torch.float32}
