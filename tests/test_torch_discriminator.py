"""Discriminators and GAN losses of the PyTorch port against the JAX modules.

Weights: trees with the structure of the JAX package's ``init_all`` (from
``jax.eval_shape``, nothing compiles) filled with seeded random values
(``train_variables``, also used by ``test_torch_train_step.py``), handed to
the port through ``from_jax``.  Inputs are made with numpy from a seed.
Tolerance rtol=atol=2e-4 on outputs, as in ``test_torch_modules.py``: fp32
on both sides, convolutions summed in other orders.  Gradients of the R1
penalty (a second-order quantity) are held to 1e-3 of their largest value.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_weights import SERVING_NPZ, _assert_trees_equal, _fill  # noqa: E402
from tools.convert_torch_ckpt import (  # noqa: E402
    convert_discriminator,
    convert_sync_discriminator,
)
from vcagan.nn import Discriminator as JaxDiscriminator  # noqa: E402
from vcagan.nn import SyncDiscriminator as JaxSyncDiscriminator  # noqa: E402
from vcagan.nn.losses import gan_loss as jax_gan_loss  # noqa: E402
from vcagan.nn.losses import r1_penalty as jax_r1_penalty  # noqa: E402
from vcagan.train.models import VCAGANModules as JaxModules  # noqa: E402
from vcagan_torch.io.weights import from_jax, load_serving_npz  # noqa: E402
from vcagan_torch.nn import Discriminator, SyncDiscriminator, gan_loss, r1_penalty  # noqa: E402


TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 20  # batch, video frames (the discriminators' minimum window)


def train_variables(jax_modules: JaxModules, seed: int):
    """(params, batch_stats) numpy trees of all seven modules, keyed by name,
    with the structure of ``jax_modules.init_all`` and seeded values."""
    shapes = jax.eval_shape(jax_modules.init_all, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = {name: _fill(tree, rng, stats=False) for name, tree in shapes[0].items()}
    stats = {name: _fill(tree, rng, stats=True) for name, tree in shapes[1].items()}
    return params, stats


@pytest.fixture(scope="module")
def variables():
    params, stats = train_variables(JaxModules.create(), seed=21)
    return params, stats, from_jax(params, stats)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    mels = [rng.uniform(-1, 1, (B, f, k * S)).astype(np.float32)
            for f, k in ((20, 1), (40, 2), (80, 4))]
    sent = rng.standard_normal((B, S, 512)).astype(np.float32)
    phon = rng.standard_normal((B, S, 512)).astype(np.float32)
    return mels, sent, phon


def _discriminator(phase, states):
    module = Discriminator(phase)
    module.load_state_dict(states[f"dis{phase}"], strict=True)
    return module


@pytest.mark.parametrize("phase", ["1", "2", "3"])
def test_discriminator_heads(variables, phase):
    params, _, states = variables
    mels, sent, _ = _inputs()
    mel = mels[int(phase) - 1]
    u_j, c_j = JaxDiscriminator(phase=phase).apply(
        {"params": params[f"dis{phase}"]}, jnp.asarray(mel)[..., None], jnp.asarray(sent)
    )
    with torch.no_grad():
        u, c = _discriminator(phase, states)(torch.from_numpy(mel), torch.from_numpy(sent))
    assert u.shape == c.shape == (B, 1)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), **TOL)


@pytest.mark.parametrize("phase", ["1", "2", "3"])
def test_discriminator_window_too_short_raises(variables, phase):
    """Both packages refuse a time dimension below 5 * 2**blocks and take
    the one at it."""
    params, _, states = variables
    need = 5 * 2 ** {"1": 2, "2": 3, "3": 4}[phase]
    sent = np.zeros((1, 4, 512), np.float32)
    module = _discriminator(phase, states)
    for t, ok in ((need - 1, False), (need, True)):
        mel = np.zeros((1, 20 * 2 ** (int(phase) - 1), t), np.float32)
        call_jax = lambda: JaxDiscriminator(phase=phase).apply(  # noqa: E731
            {"params": params[f"dis{phase}"]}, jnp.asarray(mel)[..., None], jnp.asarray(sent))
        call_port = lambda: module(torch.from_numpy(mel), torch.from_numpy(sent))  # noqa: E731
        if ok:
            call_jax(), call_port()
        else:
            for call in (call_jax, call_port):
                with pytest.raises(ValueError, match="downsamples below"):
                    call()


@pytest.mark.parametrize("gen", [False, True], ids=["dis", "gen"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sync_discriminator(variables, gen, train):
    """Per-sample losses, and in train mode the BatchNorm statistics (flax's
    biased running variance)."""
    params, stats, states = variables
    mels, _, phon = _inputs(1)
    variables_j = {"params": params["s_dis"], "batch_stats": stats["s_dis"]}
    args = (jnp.asarray(phon), jnp.asarray(mels[2])[..., None])
    if train:
        want, upd = JaxSyncDiscriminator().apply(variables_j, *args, gen=gen, train=True,
                                                 mutable=["batch_stats"])
    else:
        want = JaxSyncDiscriminator().apply(variables_j, *args, gen=gen, train=False)
    module = SyncDiscriminator()
    module.load_state_dict(states["s_dis"], strict=True)
    module.train(train)
    with torch.no_grad():
        got = module(torch.from_numpy(phon), torch.from_numpy(mels[2]), gen=gen)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    new_stats = convert_sync_discriminator(module.state_dict())["batch_stats"]
    if train:
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
                     new_stats, upd["batch_stats"])
    else:
        _assert_trees_equal(new_stats, stats["s_dis"])


@pytest.mark.parametrize("real", [True, False])
def test_gan_loss(real):
    logits = np.random.default_rng(3).standard_normal((5, 1)).astype(np.float32) * 4
    np.testing.assert_allclose(gan_loss(torch.from_numpy(logits), real).item(),
                               float(jax_gan_loss(jnp.asarray(logits), real)), rtol=1e-6)


@pytest.mark.parametrize("phase", ["1", "3"])
def test_r1_penalty_and_its_parameter_gradient(variables, phase):
    """The penalty and its gradient with respect to the discriminator's
    parameters (second order: create_graph) against jax.grad of jax.grad."""
    params, _, states = variables
    mels, sent, _ = _inputs(2)
    mel = mels[int(phase) - 1]
    module = JaxDiscriminator(phase=phase)

    def penalty(p):
        fn = lambda m: module.apply({"params": p}, m[..., None], jnp.asarray(sent))[0]  # noqa: E731
        return jax_r1_penalty(fn, jnp.asarray(mel))

    want, want_grads = jax.jit(jax.value_and_grad(penalty))(params[f"dis{phase}"])
    port = _discriminator(phase, states)
    x = torch.from_numpy(mel).requires_grad_()
    got = r1_penalty(port(x, torch.from_numpy(sent))[0], x)
    names, tensors = zip(*port.named_parameters())
    grads = torch.autograd.grad(got, tensors, allow_unused=True)  # the cond head: none
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, grads)]
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-4)
    got_grads = convert_discriminator(dict(zip(names, grads)), phase)["params"]
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want_grads))
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3,
                                                         atol=1e-3 * scale),
                 got_grads, want_grads)


def test_from_jax_is_exact_inverse_of_converters(variables):
    params, stats, states = variables
    for phase in "123":
        back = convert_discriminator(states[f"dis{phase}"], phase)
        _assert_trees_equal(back["params"], params[f"dis{phase}"], f"dis{phase}")
    back = convert_sync_discriminator(states["s_dis"])
    _assert_trees_equal(back["params"], params["s_dis"], "s_dis")
    _assert_trees_equal(back["batch_stats"], stats["s_dis"], "s_dis")


def test_serving_npz_keeps_refusing_discriminator_trees(tmp_path):
    """``from_jax`` now converts discriminator trees, but a serving file
    holds the generator side only: a discriminator leaf in it stays an
    unmatched leaf, as the JAX reader has it."""
    with np.load(SERVING_NPZ) as z:
        arrays = {key: z[key] for key in z.files}
    leaf = "params/dis1/conv_in/kernel"
    arrays[leaf] = np.zeros((5, 5, 1, 32), np.float16)
    path = tmp_path / "serving.npz"
    np.savez(path, **arrays)
    with pytest.raises(KeyError, match="unmatched leaves") as err:
        load_serving_npz(str(path))
    assert leaf in str(err.value)
