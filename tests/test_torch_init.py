"""The port's weight initialisation against the JAX package's.

Every module the port draws from a seed (``VCAGANModules.create``, a
``Synthesizer`` built without weights, unfolded and folded + fused, and
``load_asr`` without a checkpoint) is held leaf by leaf to the distribution
the JAX package's counterpart gives that leaf.  The draws are not the JAX
package's bit for bit (randomness is injected, never matched); their
distributions are.  A leaf's rule is read from its name and shape alone,
so a module that forgets its rule fails here:

- ``lecun``: every convolution and dense kernel outside a ResNet
  ``BasicBlock`` (flax's ``nn.Conv`` / ``nn.Dense`` default, and the stem,
  ``vcagan/nn/visual_front.py:40-43``): a normal truncated at +-2 of the
  unit normal with std 1 / sqrt(fan_in), so every element within
  2 / 0.8796 / sqrt(fan_in) (held at 2.28);
- ``he``: every ``BasicBlock`` convolution and projection (the trunk's, and
  the audio front's block in the sync critic and the ASR models;
  ``vcagan/nn/common.py:40-43``): a normal of std sqrt(2 / fan_out);
- ``gru``: U(+-1 / sqrt(hidden)) (``vcagan/nn/gru.py:41-56``);
- ``zero``: every convolution and dense bias, the folded ones too;
- ``constant``: BatchNorm's scale, bias and statistics and the PReLU
  slopes, equal to the JAX package's.

Fans are counted as the JAX kernel's layout counts them (receptive field x
in, receptive field x out).  A kernel's sample std must lie within
4 / sqrt(2n) + 0.01 of its rule's std, relatively (the sample std of n
normal draws has a relative spread of about 1 / sqrt(2n)), and its mean
within 4 std / sqrt(n) of 0.  The JAX package's own ``init_all`` leaves,
mapped through ``from_jax`` / ``asr_from_jax``, pass the same checks: they
are the yardstick.  The JAX side runs at the narrow widths of
``tests/test_torch_train_step.py`` (its full-width ``init_all`` takes
about 35 s on the CPU), the port's at those widths (same leaves, shapes
and constants as JAX's) and at the default widths.
"""

import functools
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from vcagan.configs import ModelConfig as JaxModelConfig  # noqa: E402
from vcagan.eval.asr_models import GridASR as JaxGridASR  # noqa: E402
from vcagan.eval.asr_models import LRWClassifier as JaxLRWClassifier  # noqa: E402
from vcagan.train import VCAGANModules as JaxModules  # noqa: E402
from vcagan_torch.configs import ModelConfig  # noqa: E402
from vcagan_torch.eval.asr_models import load_asr  # noqa: E402
from vcagan_torch.io.weights import asr_from_jax, from_jax  # noqa: E402
from vcagan_torch.nn.resnet import BasicBlock  # noqa: E402
from vcagan_torch.serve import Synthesizer  # noqa: E402
from vcagan_torch.train import VCAGANModules  # noqa: E402

NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32, gru_dropout=0.0, frontend_dropout=0.0)
LECUN_EDGE = 2.28  # x sqrt(fan_in): the truncation at 2 / 0.87962566
# the convolutions of a ResNet BasicBlock: the trunk's and the audio front's
HE_KEY = re.compile(r"(^resnet\.layer\d\.\d|^Res_block\.0)\.(conv1|conv2|downsample\.0)\.weight$")
GRU_KEY = re.compile(r"(weight|bias)_(ih|hh)_l\d")
ASR_FRAMES = {"grid": 300, "lrw": 116}


def rule(key, state):
    """The initialiser the JAX package gives the leaf ``key`` of a module's
    state dict ``state``."""
    prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    if GRU_KEY.match(leaf):
        return "gru"
    if leaf in ("running_mean", "running_var", "num_batches_tracked") or (
            f"{prefix}.running_mean" in state):
        return "constant"  # BatchNorm
    if leaf == "weight" and state[key].dim() == 1:
        return "constant"  # PReLU slopes
    if leaf == "bias":
        return "zero"
    assert leaf == "weight" and state[key].dim() >= 2, key
    return "he" if HE_KEY.search(key) else "lecun"


def fans(w):
    receptive = math.prod(w.shape[2:])
    return w.shape[1] * receptive, w.shape[0] * receptive


def gru_hidden(state, key):
    """The hidden size of the GRU that holds ``key``: a third of its
    weight_hh's rows."""
    layer = re.sub(r"(weight|bias)_(ih|hh)_", "weight_hh_", key)
    return state[layer].shape[0] // 3


def check_leaf(what, key, state):
    """Holds one leaf to its rule; returns the rule."""
    kind = rule(key, state)
    w = state[key].double()
    n = w.numel()
    if kind == "zero":
        assert torch.count_nonzero(w) == 0, f"{what} {key}: a non-zero bias"
        return kind
    if kind == "constant":
        return kind
    if kind == "gru":
        bound = 1.0 / math.sqrt(gru_hidden(state, key))
        want = bound / math.sqrt(3.0)
        assert w.abs().max() <= bound, f"{what} {key}: outside U(+-{bound:.4g})"
    else:
        fan_in, fan_out = fans(w)
        want = math.sqrt(1.0 / fan_in) if kind == "lecun" else math.sqrt(2.0 / fan_out)
        if kind == "lecun":
            edge = LECUN_EDGE / math.sqrt(fan_in)
            assert w.abs().max() <= edge, f"{what} {key}: {w.abs().max():.4g} > {edge:.4g}"
    got = w.std().item()
    tol = 4.0 / math.sqrt(2.0 * n) + 0.01
    assert abs(got / want - 1.0) <= tol, (
        f"{what} {key} ({kind}, n={n}): std {got:.5g}, rule {want:.5g}, tol {tol:.3g}")
    assert abs(w.mean().item()) <= 4.0 * want / math.sqrt(n), f"{what} {key}: mean {w.mean()}"
    return kind


def check_states(what, states):
    """Every leaf of ``states`` ({module: state dict}) against its rule;
    returns the count of leaves by rule."""
    counts = {}
    for module, state in states.items():
        for key in state:
            kind = check_leaf(f"{what} {module}", key, state)
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def tensors(states):
    return {m: {k: v.detach().clone() for k, v in sd.items()} for m, sd in states.items()}


@pytest.fixture(scope="module")
def jax_narrow():
    """The JAX package's seven modules at the narrow widths, initialised by
    its own ``init_all``, as the port's state dicts."""
    params, stats = JaxModules.create(JaxModelConfig(**NARROW)).init_all(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, (params, stats))
    return from_jax(*tree)


@functools.lru_cache(maxsize=None)
def jax_asr(kind):
    """The JAX package's ASR model, initialised by flax, as the port's front
    and back state dicts (read only)."""
    model = JaxGridASR() if kind == "grid" else JaxLRWClassifier()
    variables = jax.jit(lambda key, mel: model.init({"params": key}, mel, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, ASR_FRAMES[kind], 1)))
    front, back = asr_from_jax(jax.tree_util.tree_map(np.asarray, variables), kind)
    return {"front": front, "back": back}


def port_asr(kind):
    model = load_asr(kind, device="cpu")
    return {"front": model.front.state_dict(), "back": model.back.state_dict()}


def test_the_jax_package_follows_the_rules(jax_narrow):
    """The yardstick: the JAX package's own draws pass the checks the
    port's are held to."""
    counts = check_states("JAX init_all", jax_narrow)
    # the trunk's 16 block convolutions and 4 projections (a 16-channel stem
    # gives the first block one), the sync critic's block 2
    assert counts["lecun"] > 50 and counts["he"] == 22 and counts["gru"] == 16, counts
    for kind in ("grid", "lrw"):
        counts = check_states(f"JAX {kind} ASR", jax_asr(kind))
        assert counts["he"] == 2 and counts["gru"] == 16 and counts["lecun"] == 4, counts


def test_narrow_modules_have_the_jax_leaves_and_constants(jax_narrow):
    """At the narrow widths the port draws the JAX package's leaves, shapes
    and constants, and every random leaf follows its rule."""
    port = VCAGANModules.create(ModelConfig(**NARROW), seed=0).state_dicts()
    assert set(port) == set(jax_narrow)
    for module, state in port.items():
        want = jax_narrow[module]
        assert set(state) == set(want), module
        for key, value in state.items():
            assert value.shape == want[key].shape, (module, key)
            if rule(key, state) == "constant":
                assert torch.equal(value, want[key].to(value.dtype)), (module, key)
    assert check_states("port narrow", port) == check_states("JAX init_all", jax_narrow)


def test_default_modules_follow_the_rules():
    counts = check_states("port", VCAGANModules.create(seed=0).state_dicts())
    # the trunk's 16 block convolutions and 3 projections, the sync critic's 2
    assert counts["he"] == 21 and counts["gru"] == 16, counts


@pytest.mark.parametrize("kind", ["grid", "lrw"])
def test_asr_models_follow_the_rules(kind):
    port, jax_states = port_asr(kind), jax_asr(kind)
    for part, state in port.items():
        assert set(state) == set(jax_states[part]), part
        for key, value in state.items():
            assert value.shape == jax_states[part][key].shape, (part, key)
            if rule(key, state) == "constant":
                assert torch.equal(value, jax_states[part][key].to(value.dtype)), (part, key)
    assert check_states(f"port {kind} ASR", port) == check_states(f"JAX {kind} ASR", jax_states)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded+fused"])
def test_weightless_synthesizer_follows_the_rules(folded):
    """The serving modules without weights: unfolded as ``create``'s
    generator side; folded + fused with every folded bias exactly 0 and the
    fused blocks' packed copies made from the drawn weights."""
    synth = Synthesizer(device="cpu", fold_bn=folded, fused_blocks=folded)
    states = {name: m.state_dict() for name, m in zip(("v_front", "gen", "post"),
                                                      synth.modules())}
    counts = check_states("Synthesizer", states)
    assert counts["he"] == 19, counts
    if folded:
        assert counts["zero"] > 19
        assert torch.count_nonzero(states["v_front"]["frontend.0.bias"]) == 0
        blocks = [m for m in synth.v_front.modules() if isinstance(m, BasicBlock) and m.fused]
        assert len(blocks) == 5
        for block in blocks:
            assert torch.equal(block.w1_hwio, block.conv1.weight.permute(2, 3, 1, 0))
            assert torch.equal(block.w2_hwio, block.conv2.weight.permute(2, 3, 1, 0))
    else:
        create = VCAGANModules.create(seed=0)
        for name, state in states.items():
            for key, value in state.items():
                assert torch.equal(value, getattr(create, name).state_dict()[key]), (name, key)


def test_draws_come_from_the_seed_alone():
    """The same seed gives the same tensors, another seed others, and no
    constructor moves the global generator."""
    before = torch.random.get_rng_state()
    a = tensors(VCAGANModules.create(ModelConfig(**NARROW), seed=0).state_dicts())
    torch.manual_seed(12345)  # the global generator plays no part
    b = tensors(VCAGANModules.create(ModelConfig(**NARROW), seed=0).state_dicts())
    c = tensors(VCAGANModules.create(ModelConfig(**NARROW), seed=1).state_dicts())
    torch.random.set_rng_state(before)
    for module, state in a.items():
        for key, value in state.items():
            assert torch.equal(value, b[module][key]), (module, key)
            if rule(key, state) not in ("zero", "constant"):
                assert not torch.equal(value, c[module][key]), (module, key)
    for build in (lambda: VCAGANModules.create(ModelConfig(**NARROW), seed=3),
                  lambda: Synthesizer(ModelConfig(**NARROW), device="cpu"),
                  lambda: load_asr("grid", device="cpu")):
        build()
        assert torch.equal(torch.random.get_rng_state(), before)
