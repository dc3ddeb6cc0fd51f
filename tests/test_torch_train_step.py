"""The PyTorch port's train step against the JAX package's ``make_train_step``.

Two steps on both sides from the same weights, batch and noise, at a narrow
``ModelConfig`` that both packages take (the sync critic's 512-d features
and 80 mels kept), B = 2, a 20-frame window (the discriminators' minimum)
of 32 x 32 frames, dropout rates 0, and a learning-rate milestone after the
first step (steps_per_epoch 1), so that the second update runs at lr * gamma.
Two steps, because the port's AMSGrad would part from ``torch.optim``'s at
the second.  The JAX step gets the port's noise through a ``Decoder``
subclass that injects it; the port's generator is re-seeded before each
step, so it draws the same noise each time.  Weights: seeded random trees
(``train_variables``) through ``from_jax``; results back through the
reference converter.

The sync leak: the reference deliberately lets the D phase's sync loss,
taken on a live ``phon``, add its gradient to the visual front's G update
(``vcagan/train/step.py:399-403``); ``sync_leak=False`` leaves it out.  The
JAX step above runs with the leak; the port's step without it must differ
from the port's with it by exactly that gradient (only the visual front's
update and the G gradient's norm move), and the gradient is held to the
JAX package's, computed on its own.

Tolerances, and why.  This computation's gradients are ill-conditioned in
fp32: the deep train-mode BatchNorm stack of the decoder and the visual
front leaves the port's and the JAX package's gradients each about 3e-3
(relative L2, per leaf) from a float64 evaluation of the port, while the
forward losses agree to 1e-6.
- metrics: rtol 1e-4 at the first step (losses of one fp32 forward;
  measured 2e-7), 2e-4 for its gradient norms (measured 6e-5).  At the
  second step the weights differ by what the first update left (below):
  losses 1e-3 (measured 7e-5), gradient norms 5e-3 (measured 1.6e-3).
- gradients: after the first step each optimizer's first moment is
  (1 - b1) (g + wd p), with p the same start on both sides, so it holds
  each module's gradient to the JAX package's: relative L2 within 1e-2,
  from the 3e-3 above (measured 3.4e-3 in the visual front and the
  decoder, below 1e-5 in the postnet and the discriminators).
- parameters: an update is lr * m / (sqrt(v) + eps), at the first step
  lr * sign(g), so no update is much larger than lr and a scaled gradient
  leaves it as it was (the first moment above catches that).  Where a
  gradient lies within that fp32 noise its sign can differ between the
  packages, and the update then differs by 2 lr.  So the updates are held
  by the share of elements more than lr / 2 apart: below 5e-3 (measured at
  most 1.1e-3, in the decoder; 0 in the discriminators).
- BatchNorm statistics after two steps: the difference within 2e-3 of how
  far the statistics moved (relative L2; measured at most 4e-4) and
  within 1e-3 anywhere (measured 2.5e-4): the second step's batches pass
  through weights that differ by the first update's sign flips.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from test_torch_discriminator import train_variables  # noqa: E402
from tools.convert_torch_ckpt import (  # noqa: E402
    convert_decoder,
    convert_discriminator,
    convert_postnet,
    convert_sync_discriminator,
    convert_visual_front,
)
from vcagan.configs import ModelConfig as JaxModelConfig  # noqa: E402
from vcagan.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from vcagan.nn import Decoder as JaxDecoder  # noqa: E402
from vcagan.train import Batch as JaxBatch  # noqa: E402
from vcagan.train import VCAGANModules as JaxModules  # noqa: E402
from vcagan.train import make_train_step as jax_make_train_step  # noqa: E402
from vcagan.train.state import GANTrainState as JaxState  # noqa: E402
from vcagan.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from vcagan_torch.configs import ModelConfig, TrainConfig  # noqa: E402
from vcagan_torch.io.weights import from_jax  # noqa: E402
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step  # noqa: E402
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE  # noqa: E402

NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32, gru_dropout=0.0, frontend_dropout=0.0)
TRAIN = dict(lr_milestones=(1,))  # GRID recipe otherwise: amsgrad, lr 1e-4, wd 1e-5, recon 50
B, W, HW = 2, 20, 32
NOISE_SEED = 5
NOISE = torch.randn((B, 20, W, NARROW["noise_dim"]),
                    generator=torch.Generator().manual_seed(NOISE_SEED)).numpy()
CONVERTERS = {
    "v_front": convert_visual_front, "gen": convert_decoder, "post": convert_postnet,
    "dis1": lambda sd: convert_discriminator(sd, "1"),
    "dis2": lambda sd: convert_discriminator(sd, "2"),
    "dis3": lambda sd: convert_discriminator(sd, "3"),
    "s_dis": convert_sync_discriminator,
}
GRAD_NORMS = ("g_grad_norm", "d_grad_norm")
METRIC_RTOL = ({"loss": 1e-4, "norm": 2e-4}, {"loss": 1e-3, "norm": 5e-3})  # by step


class FixedNoiseDecoder(JaxDecoder):
    """The JAX decoder with the port's noise injected, whatever rng the
    step passes."""

    def __call__(self, sent, phon, lengths, train=True, noise=None):
        return super().__call__(sent, phon, lengths, train=train, noise=jnp.asarray(NOISE))


def make_batch():
    rng = np.random.default_rng(0)
    return dict(
        video=rng.standard_normal((B, W, HW, HW, 1)).astype(np.float32),
        mel=np.clip(rng.standard_normal((B, 80, 4 * W)), -1, 1).astype(np.float32),
        spec=np.abs(rng.standard_normal((B, 321, 4 * W))).astype(np.float32),
        vid_len=np.asarray([W, W - 6], np.int32),
        mel_len=np.asarray([4 * W, 4 * (W - 6)], np.int32),
    )


def mixed(create, config, model, bf16):
    """``create(config(**model))``, with the modules named in ``bf16`` taken
    from the same bundle in bf16."""
    modules = create(config(**model))
    if not bf16:
        return modules
    half = create(config(**{**model, "use_bfloat16": True}))
    return dataclasses.replace(modules, **{name: getattr(half, name) for name in bf16})


def jax_steps(params, stats, batch, sync_leak, steps, model=NARROW, train=TRAIN, bf16=(),
              **knobs):
    modules = mixed(JaxModules.create, JaxModelConfig, model, bf16)
    modules = dataclasses.replace(modules, gen=FixedNoiseDecoder(**{
        f.name: getattr(modules.gen, f.name) for f in dataclasses.fields(JaxDecoder)
        if f.name not in ("parent", "name")}))
    cfg = JaxTrainConfig(**train)
    txs = [jax_make_optimizer(cfg.lr, cfg.weight_decay, cfg.amsgrad, cfg.lr_milestones,
                              cfg.lr_gamma, 1) for _ in range(2)]
    g_params = {k: params[k] for k in ("v_front", "gen", "post")}
    d_params = {k: params[k] for k in ("dis1", "dis2", "dis3", "s_dis")}
    state = JaxState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                     batch_stats=stats, g_opt_state=txs[0].init(g_params),
                     d_opt_state=txs[1].init(d_params))
    step = jax_make_train_step(modules, *txs, cfg, donate=False, sync_leak=sync_leak, **knobs)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    metrics, moments = [], []
    for i in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
        # the optax chain's state: (weight decay, moments, learning rate)
        moments.append({**state.g_opt_state[1].mu, **state.d_opt_state[1].mu})
    return state, metrics, moments


def port_steps(params, stats, batch, sync_leak, steps, model=NARROW, train=TRAIN, bf16=(),
               **knobs):
    modules = mixed(VCAGANModules.create, ModelConfig, model, bf16).load_state_dicts(
        from_jax(params, stats))
    cfg = TrainConfig(**train)
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=1, device="cpu")
    step = make_train_step(modules, g_tx, d_tx, cfg, sync_leak=sync_leak, **knobs)
    tbatch = Batch(**{k: torch.from_numpy(v) for k, v in batch.items()})
    metrics, moments = [], []
    for _ in range(steps):
        state, m = step(state, tbatch, torch.Generator().manual_seed(NOISE_SEED))
        metrics.append({k: v.item() for k, v in m.items()})
        moments.append(first_moments(state))
    return state, metrics, moments


def first_moments(state):
    """Both optimizers' first moments, a copy, as JAX trees by module."""
    trees = {}
    for names, opt_state in ((GENERATOR_SIDE, state.g_opt_state),
                             (DISCRIMINATOR_SIDE, state.d_opt_state)):
        mu = iter(opt_state.mu)
        for name in names:
            module = getattr(state.modules, name)
            sd = {k: next(mu).clone() for k, _ in module.named_parameters()}
            trees[name] = CONVERTERS[name]({**sd, **dict(module.named_buffers())})["params"]
    return trees


def as_jax_trees(state):
    """The port's modules as JAX (params, batch_stats) trees."""
    trees = {name: CONVERTERS[name](sd) for name, sd in state.modules.state_dicts().items()}
    return ({k: t["params"] for k, t in trees.items()},
            {k: t.get("batch_stats", {}) for k, t in trees.items()})


@pytest.fixture(scope="module")
def run():
    params, stats = train_variables(JaxModules.create(JaxModelConfig(**NARROW)), seed=31)
    batch = make_batch()
    jax_state, jax_metrics, jax_moments = jax_steps(params, stats, batch, sync_leak=True,
                                                    steps=2)
    port_state, port_metrics, port_moments = port_steps(params, stats, batch, sync_leak=True,
                                                        steps=2)
    return dict(params=params, stats=stats, batch=batch, jax_state=jax_state,
                jax_metrics=jax_metrics, jax_moments=jax_moments, port_state=port_state,
                port_metrics=port_metrics, port_moments=port_moments)


@pytest.mark.parametrize("step", [0, 1])
def test_metrics(run, step):
    want, got = run["jax_metrics"][step], run["port_metrics"][step]
    assert sorted(got) == sorted(want) and len(want) == 9
    for k in want:
        rtol = METRIC_RTOL[step]["norm" if k in GRAD_NORMS else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=k)


def flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


def flipped_share(before, after_port, after_jax, lr):
    """The share of elements whose update is more than lr / 2 from the JAX
    package's."""
    diff = np.abs((flat(after_port) - flat(before)) - (flat(after_jax) - flat(before))) / lr
    return (diff > 0.5).mean()


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_first_moment(run, name):
    """The gradient through the first moment after step 1, (1 - b1) (g + wd p)."""
    got, want = run["port_moments"][0][name], run["jax_moments"][0][name]
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    g, w = flat(got), flat(want)
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= 1e-2, rel


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_updated_parameters(run, name):
    jax_state = run["jax_state"]
    got = as_jax_trees(run["port_state"])[0][name]
    want = {**jax_state.g_params, **jax_state.d_params}[name]
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    flipped = flipped_share(run["params"][name], got, want, TrainConfig().lr)
    assert flipped < 5e-3, flipped


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "s_dis"])
def test_batch_statistics(run, name):
    """Both phases' statistics: the generator side's move once a step (one
    forward), the sync critic's twice (real mel, then g3)."""
    port_state = run["port_state"]
    got = as_jax_trees(port_state)[1][name]
    want = run["jax_state"].batch_stats[name]
    g, w, s = flat(got), flat(want), flat(run["stats"][name])
    assert np.abs(g - w).max() <= 1e-3
    assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w - s)
    assert np.abs(g - s).min() > 0  # every statistic moved
    counts = {k: int(v) for k, v in getattr(port_state.modules, name).state_dict().items()
              if k.endswith("num_batches_tracked")}
    assert set(counts.values()) == {4 if name == "s_dis" else 2}


@pytest.fixture(scope="module")
def no_leak(run):
    """One port step with and without the leak, from the same start."""
    params, stats, batch = run["params"], run["stats"], run["batch"]
    port_state, port_metrics, _ = port_steps(params, stats, batch, sync_leak=False, steps=1)
    leak_state, leak_metrics, _ = port_steps(params, stats, batch, sync_leak=True, steps=1)
    return dict(params=params, stats=stats, batch=batch, port_state=port_state,
                port_metrics=port_metrics[0], leak_state=leak_state, leak_metrics=leak_metrics[0])


def test_leak_counts_in_the_g_gradient_norm_only(no_leak):
    got, leak = no_leak["port_metrics"], no_leak["leak_metrics"]
    assert leak["g_grad_norm"] != got["g_grad_norm"]
    for k in set(got) - {"g_grad_norm"}:
        assert leak[k] == got[k], k


def test_leak_moves_the_visual_front_update_only(no_leak):
    without = as_jax_trees(no_leak["port_state"])[0]
    with_leak = as_jax_trees(no_leak["leak_state"])[0]
    for name in CONVERTERS:
        same = jax.tree.leaves(jax.tree.map(np.array_equal, with_leak[name], without[name]))
        assert all(same) != (name == "v_front"), name


def _jax_leaked_gradient(params, stats, batch):
    """The D phase's sync gradient into the visual front, on its own:
    d (sync_dis_weight * mean InfoNCE(v_front(video).phon, mel)) / d v_front."""
    modules = JaxModules.create(JaxModelConfig(**NARROW))

    def sync(vf_params):
        (phon, _), _ = modules.v_front.apply(
            {"params": vf_params, "batch_stats": stats["v_front"]}, jnp.asarray(batch["video"]),
            train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        loss, _ = modules.s_dis.apply(
            {"params": params["s_dis"], "batch_stats": stats["s_dis"]}, phon,
            jnp.asarray(batch["mel"])[..., None], gen=False, train=True, mutable=["batch_stats"])
        return JaxTrainConfig().sync_dis_weight * jnp.mean(loss)

    return jax.jit(jax.grad(sync))(params["v_front"])


def test_leaked_gradient(no_leak):
    """After one step the first moment is (1 - b1) (g + wd p), so the port's
    with the leak less the one without is (1 - b1) times the leaked
    gradient.  Held to the JAX package's within 1e-2 relative L2: both
    pass through the visual front's train-mode BatchNorm stack, whose fp32
    gradients lie about 3e-3 apart (measured 2.8e-3 here)."""
    want = _jax_leaked_gradient(no_leak["params"], no_leak["stats"], no_leak["batch"])
    without, with_leak = no_leak["port_state"], no_leak["leak_state"]
    v_front = without.modules.v_front
    n = len(list(v_front.parameters()))
    leaked = {name: (a - b) / 0.1 for (name, _), a, b in zip(
        v_front.named_parameters(), with_leak.g_opt_state.mu[:n], without.g_opt_state.mu[:n])}
    got = CONVERTERS["v_front"]({**leaked, **dict(v_front.named_buffers())})["params"]
    g, w = flat(got), flat(want)
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
