"""The port's folded-BN serving variant against the JAX package's.

Folding (``vcagan_torch/nn/fold.py``) is held to ``vcagan.nn.fold_generator_side``
on variable trees whose BatchNorm statistics are away from the identity
(``test_torch_weights.jax_variables``: means 0.1*N(0,1), variances in
[0.5, 1.5], as ``tests/test_fold_bn.py`` perturbs them), the folded modules
to the JAX folded modules, and the whole ``Synthesizer(fold_bn=True,
fused_blocks=True)`` to the JAX composition of
``VCAGANModules.create(fold_bn=True, fused_blocks=True)``.

Tolerances: folded weights rtol 1e-6 (the same fp32 formula on both sides);
modules rtol = atol = 2e-4, the bound of ``tests/test_fold_bn.py`` (folding
is exact algebra, fp32 sums reassociate); the whole path 1e-4 on trained
weights as ``tests/test_torch_serve.py`` states it: Griffin-Lim is only
stable on a speech-like spectrogram.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve import SERVING_NPZ, _jax_bench_composition
from test_torch_serve import TOL as PATH_TOL
from test_torch_weights import jax_templates, jax_variables
from vcagan.io.serving_npz import load_serving_npz as jax_load_serving_npz
from vcagan.nn import Postnet as JaxPostnet
from vcagan.nn import VisualFront as JaxVisualFront
from vcagan.nn import fold_generator_side as jax_fold_generator_side
from vcagan_torch.io.weights import from_jax
from vcagan_torch.nn import BasicBlock, Decoder, Postnet, ResNetTrunk, VisualFront
from vcagan_torch.nn.fold import fold_conv_bn, fold_generator_side
from vcagan_torch.serve import Synthesizer
from _torch_threads import _one_thread  # noqa: F401  (autouse)


TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def variables():
    params, stats = jax_variables(seed=21)
    folded_p, folded_s = jax_fold_generator_side(params, stats)
    return dict(params=params, stats=stats, folded_params=folded_p, folded_stats=folded_s,
                states=from_jax(params, stats))


def test_fold_matches_jax_fold(variables):
    got = fold_generator_side(variables["states"])
    want = from_jax(variables["folded_params"], variables["folded_stats"])
    for mod in ("v_front", "gen", "post"):
        assert sorted(got[mod]) == sorted(want[mod]), mod
        for key, w in want[mod].items():
            assert got[mod][key].dtype == w.dtype, (mod, key)
            np.testing.assert_allclose(
                got[mod][key].numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=f"{mod}/{key}"
            )


def test_fold_drops_paired_bns_only(variables):
    states = variables["states"]
    folded = fold_generator_side(states)
    v_front, post, gen = folded["v_front"], folded["post"], folded["gen"]
    assert not any("running_" in k or ".bn" in k for k in v_front)
    assert not any(k.startswith(("frontend.1.", "postnet.1.")) for k in {**v_front, **post})
    for key in ("frontend.0.bias", "resnet.layer1.0.conv1.bias", "resnet.layer1.0.conv2.bias",
                "resnet.layer2.0.downsample.0.bias"):
        assert key in v_front and key not in states["v_front"], key
    # postnet.0 had a bias of its own, which is folded in, not replaced
    assert "postnet.0.bias" in states["post"]
    assert not torch.equal(post["postnet.0.bias"], states["post"]["postnet.0.bias"])
    assert not any("running_" in k for k in post)
    # the decoder's pre-activation norms are no pairs: nothing changes there
    assert list(gen) == list(states["gen"])
    assert all(torch.equal(gen[k], states["gen"][k]) for k in gen)
    assert "decode.0.norm1.running_var" in gen and "to_mel1.0.running_mean" in gen
    # the input is not written to
    assert "frontend.1.running_var" in states["v_front"]


def test_fold_is_idempotent(variables):
    once = fold_generator_side(variables["states"])
    twice = fold_generator_side(once)
    for mod in once:
        assert list(once[mod]) == list(twice[mod])
        assert all(torch.equal(once[mod][k], twice[mod][k]) for k in once[mod])


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module


@pytest.mark.parametrize("fused", [False, True])
def test_folded_visual_front_matches_jax_and_unfolded(variables, fused):
    video = np.random.default_rng(1).standard_normal((2, 8, 48, 48, 1)).astype(np.float32)
    want = JaxVisualFront(fold_bn=True, fused=fused).apply(
        {"params": variables["folded_params"]["v_front"]}, jnp.asarray(video), train=False
    )
    folded = fold_conv_bn(variables["states"]["v_front"])
    with torch.no_grad():
        got = _load(VisualFront(fold_bn=True, fused=fused), folded)(torch.from_numpy(video))
        unfolded = _load(VisualFront(), variables["states"]["v_front"]).eval()(
            torch.from_numpy(video)
        )
    for name, g, w, u in zip(("phon", "sent"), got, want, unfolded):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), u.numpy(), err_msg=name, **TOL)


def test_folded_postnet_matches_jax_and_unfolded(variables):
    mel = np.random.default_rng(2).standard_normal((2, 80, 32)).astype(np.float32)
    want = JaxPostnet(fold_bn=True).apply(
        {"params": variables["folded_params"]["post"]}, jnp.asarray(mel), train=False
    )
    with torch.no_grad():
        got = _load(Postnet(fold_bn=True), fold_conv_bn(variables["states"]["post"]))(
            torch.from_numpy(mel)
        )
        unfolded = _load(Postnet(), variables["states"]["post"]).eval()(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), unfolded.numpy(), **TOL)


def test_decoder_is_untouched_by_folding(variables):
    b, t = 2, 8
    rng = np.random.default_rng(3)
    sent, phon = (torch.from_numpy(rng.standard_normal((b, t, 512)).astype(np.float32))
                  for _ in range(2))
    noise = torch.from_numpy(rng.standard_normal((b, 20, t, 128)).astype(np.float32))
    lengths = torch.tensor([t, t - 3], dtype=torch.int32)
    with torch.no_grad():
        want = _load(Decoder(), variables["states"]["gen"]).eval()(
            sent, phon, lengths, noise=noise
        )
        got = _load(Decoder(), fold_conv_bn(variables["states"]["gen"])).eval()(
            sent, phon, lengths, noise=noise
        )
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_folded_fused_synthesizer_matches_jax_composition():
    b, t = 2, 8
    params, stats = jax_load_serving_npz(SERVING_NPZ, *jax_templates())
    rng = np.random.default_rng(5)
    video = rng.standard_normal((b, t, 48, 48, 1)).astype(np.float32)
    lengths = np.asarray([t, t - 2], np.int32)
    noise = rng.standard_normal((b, 20, t, 128)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32)

    want = _jax_bench_composition(
        params, stats, *(jnp.asarray(a) for a in (video, lengths, noise, phase)), folded=True
    )
    synth = Synthesizer.from_serving_npz(  # unfolded weights, folded once at load
        SERVING_NPZ, device="cpu", fold_bn=True, fused_blocks=True
    )
    assert not any("running_" in k for k in synth.v_front.state_dict())
    got = synth(video, lengths, noise=noise, init_phase=phase)
    assert got["wav"].shape == (b, 160 * (4 * t - 1))
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **PATH_TOL)


def test_fused_blocks_need_fold_bn():
    with pytest.raises(ValueError, match="fused_blocks requires fold_bn"):
        Synthesizer(device="cpu", fused_blocks=True)
    for build in (lambda: VisualFront(fused=True), lambda: BasicBlock(64, 64, fused=True)):
        with pytest.raises(ValueError, match="fused requires fold_bn"):
            build()


@pytest.mark.parametrize(
    "build",
    [lambda: VisualFront(fold_bn=True), lambda: Postnet(fold_bn=True),
     lambda: ResNetTrunk(fold_bn=True, fused=True), lambda: BasicBlock(64, 64, fold_bn=True)],
    ids=["visual_front", "postnet", "trunk", "block"],
)
def test_folded_modules_refuse_training_mode(build):
    module = build()
    assert not any(m.training for m in module.modules())  # built in eval mode
    with pytest.raises(RuntimeError, match="eval-only"):
        module.train()
    assert module.eval() is module
    wrapper = torch.nn.Sequential(module)
    with pytest.raises(RuntimeError, match="eval-only"):
        wrapper.train()
