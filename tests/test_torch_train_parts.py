"""Parts of the PyTorch port's train step against the JAX package.

The optimizer against the optax chain of ``vcagan.train.state.make_optimizer``
over several steps (AMSGrad and Adam, across a milestone), the schedule,
the mel pyramid against ``jax.image.resize``, train-mode BatchNorm against
flax's, dropout from a generator, the attention's ``autograd.Function``
against the JAX custom VJP's backward (``_attn_bwd``), and the eval step.
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_discriminator import train_variables
from vcagan.configs import ModelConfig as JaxModelConfig
from vcagan.kernels.masked_attention import _attn_bwd
from vcagan.nn.common import batch_norm as flax_batch_norm
from vcagan.train import VCAGANModules as JaxModules
from vcagan.train import make_eval_step as jax_make_eval_step
from vcagan.train.schedule import multistep_schedule as jax_schedule
from vcagan.train.state import make_optimizer as jax_make_optimizer
from vcagan.train.step import _mel_pyramid as jax_mel_pyramid
from vcagan_torch.configs import ModelConfig, TrainConfig
from vcagan_torch.io.weights import from_jax
from vcagan_torch.kernels import masked_attention as attn
from vcagan_torch.nn.common import batch_norm, dropout
from vcagan_torch.nn.gru import BiGRU
from vcagan_torch.train import (
    VCAGANModules,
    create_train_state,
    make_eval_step,
    make_train_step,
    multistep_schedule,
)
from vcagan_torch.train.state import make_optimizer
from vcagan_torch.train.step import mel_pyramid
from _torch_threads import _one_thread  # noqa: F401  (autouse)


SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}


@pytest.mark.parametrize("amsgrad", [True, False], ids=["amsgrad", "adam"])
def test_optimizer_matches_optax_chain(amsgrad):
    """Six updates with lr 1e-3 and a milestone after the second epoch of two
    steps (so the last two updates use lr * gamma).  Parameters are of order
    1 and move by about lr a step: they agree to 2 fp32 ulps of 1 (the final
    add rounds on both sides, and the moments are summed in another order);
    the moments to 1e-5 relative."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    args = (1e-3, 1e-2, amsgrad, (2,), 0.1, 2)  # lr, wd, amsgrad, milestones, gamma, spe
    tx = jax_make_optimizer(*args)
    opt_state = tx.init(jax.tree.map(jnp.asarray, params))
    port = make_optimizer(*args)
    tensors = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    state = port.init(tensors)
    jparams = jax.tree.map(jnp.asarray, params)
    for _ in range(6):
        grads = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-4, 0, s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.update([torch.from_numpy(grads[k]) for k in SHAPES], state, tensors)
        for k, t in zip(SHAPES, tensors):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=0, atol=2.4e-7,
                                       err_msg=k)
    moments = opt_state[1]
    assert state.count == int(moments.count) == 6
    pairs = [(state.mu, moments.mu), (state.nu, moments.nu)]
    if amsgrad:
        pairs.append((state.nu_max, moments.nu_max))
    for got, want in pairs:
        for k, t in zip(SHAPES, got):
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-5, atol=0)


def test_optimizer_is_not_torch_amsgrad():
    """optax's AMSGrad keeps the maximum of the bias-corrected second moment,
    torch.optim.Adam's the raw one: the port follows optax, so it parts from
    torch's from the second step on (here by far more than the fp32 noise)."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(64).astype(np.float32)
    ours, theirs = torch.from_numpy(p0.copy()), torch.from_numpy(p0.copy()).requires_grad_()
    port = make_optimizer(1e-4, 0.0, True, (), 0.1, 1)
    state = port.init([ours])
    torch_opt = torch.optim.Adam([theirs], lr=1e-4, amsgrad=True)
    diffs = []
    for scale in (1.0, 0.01):
        g = torch.from_numpy((rng.standard_normal(64) * scale).astype(np.float32))
        port.update([g], state, [ours])
        theirs.grad = g.clone()
        torch_opt.step()
        diffs.append((ours - theirs.detach()).abs().max().item())
    assert diffs[0] < 2.4e-7 and diffs[1] > 1e-5  # 2 ulps of 1; a tenth of lr


def test_multistep_schedule():
    for spe in (1, 3):
        want, got = jax_schedule(1e-4, (5, 2), 0.1, spe), multistep_schedule(1e-4, (5, 2), 0.1, spe)
        for count in (0, 1, 5, 6, 14, 15, 16, 100):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


@pytest.mark.parametrize("t", [80, 160])
def test_mel_pyramid_matches_jax_resize(t):
    mel = np.random.default_rng(2).standard_normal((2, 80, t)).astype(np.float32)
    want = jax_mel_pyramid(jnp.asarray(mel))
    got = mel_pyramid(torch.from_numpy(mel))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_train_batch_norm_matches_flax(dims):
    """Output, and running statistics after two steps (flax moves the
    running variance with the biased batch variance, PyTorch's own
    BatchNorm with the unbiased one: at N = 6 x 5 per channel in 1-D that
    is 3% apart)."""
    rng = np.random.default_rng(3)
    c = 4
    spatial = {1: (5,), 2: (5, 3), 3: (2, 3, 4)}[dims]
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    port = batch_norm(c, dims).train()
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0),
                          "num_batches_tracked": torch.tensor(0)})
    flax_bn = flax_batch_norm(train=True)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    for step in range(2):
        x = (rng.standard_normal((6, c, *spatial)) * 2 + 1).astype(np.float32)
        want, upd = flax_bn.apply(variables, jnp.asarray(np.moveaxis(x, 1, -1)),
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, ours).numpy(),
                                   np.asarray(variables["batch_stats"][theirs]), rtol=1e-6)
    assert int(port.num_batches_tracked) == 2


def test_dropout_from_a_generator():
    x = torch.ones(200, 300)
    draw = lambda seed: dropout(x, 0.3, True, torch.Generator().manual_seed(seed))  # noqa: E731
    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.7))  # inverted scaling
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert dropout(x, 0.3, False, None) is x and dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="explicit generator"):
        dropout(x, 0.3, True, None)


def test_bigru_train_mode_layers_and_dropout():
    """Train mode runs the layers one call each: with rate 0 that is the
    eval result; with a rate, the mask between the layers comes from the
    generator and the same seed gives the same output."""
    torch.manual_seed(0)
    gru = BiGRU(16, 8, 2, dropout=0.0)
    x = torch.randn(3, 5, 16)
    with torch.no_grad():
        want = gru.eval()(x)
        assert torch.allclose(gru.train()(x), want, atol=1e-6)
        gru.dropout = 0.5
        a, b = (gru(x, torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b) and not torch.allclose(a, want)
    assert sorted(gru.state_dict()) == sorted(BiGRU(16, 8, 2).state_dict())


@pytest.mark.parametrize("lengths", [[1, 5, 9], [9, 1, 3]])
def test_attention_function_gradients_match_jax_vjp(lengths):
    """The autograd.Function on CPU tensors (the plain version forward, the
    backward by autograd of it) against the JAX custom VJP's backward."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((3, 7, 16), (3, 9, 16),
                                                                   (3, 9, 16)))
    g = rng.standard_normal((3, 7, 16)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = _attn_bwd(tuple(jnp.asarray(a) for a in (q, k, v, lens)), jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attn.masked_cross_attention(tq, tk, tv, torch.from_numpy(lens))
    assert isinstance(out.grad_fn, attn.MaskedAttention._backward_cls)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)
    assert want[3] is None
    with torch.no_grad():  # no gradient needed: the plain version, no Function
        assert attn.masked_cross_attention(tq, tk, tv, torch.from_numpy(lens)).grad_fn is None


def test_serving_only_and_unported_modes_raise():
    # bf16 training is ported: the modules build, computing in bf16
    bf16 = VCAGANModules.create(ModelConfig(use_bfloat16=True))
    assert bf16.dis3.main[0].compute_dtype == bf16.s_dis.frontend[0].compute_dtype == torch.bfloat16
    small = VCAGANModules.create(ModelConfig(stem_channels=8, gru_hidden=8, noise_dim=8,
                                             attention_dim=8, attention_inner=40,
                                             postnet_channels=8, disc_base_channels=8,
                                             disc_max_channels=8))
    state, g_tx, d_tx = create_train_state(small, TrainConfig(), device="cpu")
    # ported since: the JAX step's knobs build a step (their equivalence:
    # tests/test_torch_step_knobs.py); a mesh that is no DataLayout, and XLA
    # compiler options, still raise
    for knobs in ({"d_phase": "batched"}, {"remat": "r1"}, {"compiler_options": "auto"},
                  {"donate": True}):
        assert callable(make_train_step(small, g_tx, d_tx, **knobs))
    with pytest.raises(ValueError, match="not ported"):
        make_train_step(small, g_tx, d_tx, mesh="data")
    with pytest.raises(ValueError, match="XLA compiler options"):
        make_train_step(small, g_tx, d_tx, compiler_options={"xla_tpu_scoped_vmem_limit_kib": "1"})
    with pytest.raises(TypeError, match="sync_leek"):
        make_train_step(small, g_tx, d_tx, sync_leek=False)


@pytest.mark.parametrize("flip_tta", [False, True], ids=["plain", "flip_tta"])
def test_eval_step_matches_jax(flip_tta):
    """``make_eval_step`` against the JAX package's at a narrow configuration,
    the same noise for both passes injected on both sides; eval mode, so
    rtol=atol=2e-4 as for the serving modules (``test_torch_modules.py``)."""
    narrow = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
                  attention_inner=160, postnet_channels=32, disc_base_channels=8,
                  disc_max_channels=32)
    jax_modules = JaxModules.create(JaxModelConfig(**narrow))
    params, stats = train_variables(jax_modules, seed=41)
    rng = np.random.default_rng(5)
    b, t = 2, 8
    video = rng.standard_normal((b, t, 32, 32, 1)).astype(np.float32)
    vid_len = np.asarray([t, t - 3], np.int32)
    noise = rng.standard_normal((2, b, 20, t, 16)).astype(np.float32)
    want = jax_make_eval_step(jax_modules, flip_tta)(
        params, stats, jnp.asarray(video), jnp.asarray(vid_len), jax.random.PRNGKey(0),
        jnp.asarray(noise))
    modules = VCAGANModules.create(ModelConfig(**narrow)).load_state_dicts(
        from_jax(params, stats)).train()
    got = make_eval_step(modules, flip_tta)(torch.from_numpy(video), torch.from_numpy(vid_len),
                                            torch.Generator(), torch.from_numpy(noise))
    for name, g, w in zip(("g3", "spec"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=name)
    assert modules.v_front.training and modules.post.training  # modes put back
