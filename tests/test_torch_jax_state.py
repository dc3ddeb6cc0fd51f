"""JAX train states into the PyTorch port: ``tools/export_jax_train_state.py``
and ``vcagan_torch.io.jax_state``.

A narrow JAX state (the model and recipe of ``tests/test_torch_train_step.py``)
after one JAX step, so that every moment is non-zero, is saved by the JAX
package's orbax ``CheckpointManager``, exported to ``.npz`` and loaded into a
port ``GANTrainState`` on the CPU:
- every parameter, BatchNorm statistic, moment (mu, nu and AMSGrad's
  nu_max), both counts and the step equal the JAX state's exactly (the
  port's mapped back through the reference converter);
- one port step from the loaded state against the JAX package's second
  step from the saved one, with the tolerances of
  ``tests/test_torch_train_step.py`` at its second step: metrics rtol 1e-3
  (losses) and 5e-3 (gradient norms); each module's gradient through
  mu2 - b1 mu1 = (1 - b1)(g + wd p) within 1e-2 relative L2; the updates'
  share more than lr / 2 apart below 5e-3; BatchNorm statistics within
  1e-3 anywhere and 2e-3 of their move;
- the test CLI's ``--checkpoint`` takes the ``.npz``; a stray leaf raises;
- an ASR model's orbax variables, exported with ``--asr``, load through
  ``load_asr`` into the same model as the variables themselves.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_discriminator import train_variables  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    CONVERTERS, GRAD_NORMS, METRIC_RTOL, NARROW, NOISE_SEED, TRAIN, FixedNoiseDecoder,
    as_jax_trees, flat, flipped_share, make_batch)
from test_torch_asr import jax_variables  # noqa: E402
from tools.export_jax_train_state import export_asr_variables, export_train_state  # noqa: E402
from vcagan.configs import grid_config as jax_grid_config  # noqa: E402
from vcagan.io.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from vcagan.nn import Decoder as JaxDecoder  # noqa: E402
from vcagan.train import Batch as JaxBatch  # noqa: E402
from vcagan.train import VCAGANModules as JaxModules  # noqa: E402
from vcagan.train import make_train_step as jax_make_train_step  # noqa: E402
from vcagan.train.state import GANTrainState as JaxState  # noqa: E402
from vcagan.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from vcagan_torch.cli import test as cli_test  # noqa: E402
from vcagan_torch.configs import ModelConfig, TrainConfig, grid_config  # noqa: E402
from vcagan_torch.eval.asr_models import load_asr  # noqa: E402
from vcagan_torch.io.jax_state import load_jax_train_state  # noqa: E402
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step  # noqa: E402
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE  # noqa: E402
from vcagan_torch.train.state import B1  # noqa: E402

MOMENTS = ("mu", "nu", "nu_max")  # the GRID recipe's AMSGrad


def jax_recipe():
    return jax_grid_config(**{f"model.{k}": v for k, v in NARROW.items()},
                           **{f"train.{k}": v for k, v in TRAIN.items()})


def opt_trees(opt_state):
    """{moment: {module: tree}} and the count of an optax chain's state
    (weight decay, AMSGrad moments, learning rate)."""
    moments = opt_state[1]
    assert int(moments.count) == int(opt_state[2].count)
    return {name: getattr(moments, name) for name in MOMENTS}, int(moments.count)


def port_opt_trees(state, name):
    """The port's moment ``name`` of both optimizers as JAX trees by module."""
    trees = {}
    for names, opt_state in ((GENERATOR_SIDE, state.g_opt_state),
                             (DISCRIMINATOR_SIDE, state.d_opt_state)):
        values = iter(getattr(opt_state, name))
        for mod in names:
            module = getattr(state.modules, mod)
            sd = {k: next(values).clone() for k, _ in module.named_parameters()}
            trees[mod] = CONVERTERS[mod]({**sd, **dict(module.named_buffers())})["params"]
    return trees


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_state")
    params, stats = train_variables(JaxModules.create(jax_recipe().model), seed=31)
    batch = make_batch()

    modules = JaxModules.create(jax_recipe().model)
    modules = dataclasses.replace(modules, gen=FixedNoiseDecoder(**{
        f.name: getattr(modules.gen, f.name) for f in dataclasses.fields(JaxDecoder)
        if f.name not in ("parent", "name")}))
    cfg = jax_recipe().train
    txs = [jax_make_optimizer(cfg.lr, cfg.weight_decay, cfg.amsgrad, cfg.lr_milestones,
                              cfg.lr_gamma, 1) for _ in range(2)]
    g_params = {k: params[k] for k in GENERATOR_SIDE}
    d_params = {k: params[k] for k in DISCRIMINATOR_SIDE}
    state0 = JaxState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                      batch_stats=stats, g_opt_state=txs[0].init(g_params),
                      d_opt_state=txs[1].init(d_params))
    step = jax_make_train_step(modules, *txs, cfg, donate=False, sync_leak=True)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    state1, _ = step(state0, jbatch, jax.random.PRNGKey(0))
    ckpt = JaxCheckpointManager(str(tmp / "ckpt")).save(state1, 0)
    state2, metrics2 = step(state1, jbatch, jax.random.PRNGKey(1))
    npz = str(tmp / "state.npz")
    export_train_state(ckpt, npz, jax_recipe())

    port_modules = VCAGANModules.create(ModelConfig(**NARROW), seed=9)
    tcfg = TrainConfig(**TRAIN)
    pstate, g_tx, d_tx = create_train_state(port_modules, tcfg, 1, device="cpu")
    load_jax_train_state(npz, pstate)
    # copies: the step below updates the port's tensors in place
    loaded = dict(trees=jax.tree.map(np.array, as_jax_trees(pstate)),
                  moments={name: port_opt_trees(pstate, name) for name in MOMENTS},
                  counts=(pstate.g_opt_state.count, pstate.d_opt_state.count),
                  step=pstate.step)
    port_step = make_train_step(port_modules, g_tx, d_tx, tcfg, sync_leak=True)
    tbatch = Batch(**{k: torch.from_numpy(v) for k, v in batch.items()})
    pstate, pmetrics = port_step(pstate, tbatch, torch.Generator().manual_seed(NOISE_SEED))
    return dict(state1=jax.device_get(state1), state2=jax.device_get(state2),
                metrics2={k: float(v) for k, v in metrics2.items()}, npz=npz, loaded=loaded,
                port_state=pstate, port_metrics={k: v.item() for k, v in pmetrics.items()})


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_loaded_tensors_equal_the_jax_state(run, name):
    state1, loaded = run["state1"], run["loaded"]
    params, stats = loaded["trees"]
    want_params = {**state1.g_params, **state1.d_params}[name]
    assert jax.tree.structure(params[name]) == jax.tree.structure(want_params)
    for got, want in zip(jax.tree.leaves(params[name]), jax.tree.leaves(want_params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    want_stats = jax.tree.leaves(state1.batch_stats[name])
    assert len(jax.tree.leaves(stats[name])) == len(want_stats)
    for got, want in zip(jax.tree.leaves(stats[name]), want_stats):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    opt = state1.g_opt_state if name in GENERATOR_SIDE else state1.d_opt_state
    trees, _ = opt_trees(opt)
    for moment in MOMENTS:
        got, want = loaded["moments"][moment][name], trees[moment][name]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        leaves = jax.tree.leaves(want)
        assert any(np.abs(np.asarray(x)).max() > 0 for x in leaves)  # after a step
        for g, w in zip(jax.tree.leaves(got), leaves):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_loaded_counts_and_step(run):
    state1, loaded = run["state1"], run["loaded"]
    want = (opt_trees(state1.g_opt_state)[1], opt_trees(state1.d_opt_state)[1])
    assert loaded["counts"] == want == (1, 1) and loaded["step"] == int(state1.step) == 1


def test_next_step_metrics(run):
    want, got = run["metrics2"], run["port_metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        rtol = METRIC_RTOL[1]["norm" if k in GRAD_NORMS else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_next_step_gradient_and_update(run, name):
    """mu2 - b1 mu1 is (1 - b1) (g2 + wd p1): the second step's gradient."""
    side = "g_opt_state" if name in GENERATOR_SIDE else "d_opt_state"
    mu1 = opt_trees(getattr(run["state1"], side))[0]["mu"][name]
    mu2 = opt_trees(getattr(run["state2"], side))[0]["mu"][name]
    port_mu2 = port_opt_trees(run["port_state"], "mu")[name]
    g = flat(port_mu2) - B1 * flat(mu1)
    w = flat(mu2) - B1 * flat(mu1)
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
    before = {**run["state1"].g_params, **run["state1"].d_params}[name]
    after = {**run["state2"].g_params, **run["state2"].d_params}[name]
    got = as_jax_trees(run["port_state"])[0][name]
    assert flipped_share(before, got, after, TrainConfig().lr) < 5e-3


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "s_dis"])
def test_next_step_batch_statistics(run, name):
    got = flat(as_jax_trees(run["port_state"])[1][name])
    want = flat(run["state2"].batch_stats[name])
    start = flat(run["state1"].batch_stats[name])
    assert np.abs(got - want).max() <= 1e-3
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want - start)


def test_the_test_cli_takes_the_npz_and_a_stray_leaf_raises(run, tmp_path):
    cfg = grid_config(**{f"model.{k}": v for k, v in NARROW.items()})
    modules = cli_test.load_modules(cfg, SimpleNamespace(seed=1, checkpoint=run["npz"]),
                                    torch.device("cpu"))
    state1 = run["state1"]
    for name in GENERATOR_SIDE:
        got = CONVERTERS[name](getattr(modules, name).state_dict())["params"]
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(state1.g_params[name])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with np.load(run["npz"]) as z:
        leaves = {k: z[k] for k in z.files}
    stray = str(tmp_path / "stray.npz")
    np.savez(stray, **leaves, **{"g_opt/mu/gen/extra/kernel": np.zeros(3, np.float32)})
    state, _, _ = create_train_state(VCAGANModules.create(ModelConfig(**NARROW)),
                                     TrainConfig(**TRAIN), 1, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        load_jax_train_state(stray, state)


def test_asr_variables_export_through_orbax(tmp_path):
    import orbax.checkpoint as ocp

    variables = jax_variables("grid", seed=4)
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(str(tmp_path / "asr"), variables)
    ckpt.wait_until_finished()
    npz, direct = str(tmp_path / "asr.npz"), str(tmp_path / "direct.npz")
    export_asr_variables(str(tmp_path / "asr"), npz)
    np.savez(direct, variables=np.asarray(variables, dtype=object))
    got, want = load_asr("grid", npz, device="cpu"), load_asr("grid", direct, device="cpu")
    for (k, a), (_, b) in zip(got.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k
