"""The PyTorch port's bf16 serving mode against the JAX package's.

``ModelConfig(use_bfloat16=True)`` is the JAX package's serving mode
(``bench.py:29``): fp32 parameters, per-module compute dtypes.  On the same
weights, video and injected decoder noise (B=2, T=8, 48x48):

- the dtype of every output, and of the attention's context, equals the JAX
  modules' (``jax.eval_shape``, nothing compiled); parameters stay fp32;
- port bf16 against JAX bf16, both serving variants, trained weights
  (``data/soak_serving_q8.npz``): mel3 correlation > 0.999 and spectrogram
  relative L2 < 3% (``BF16_PAIR``).  Two bf16 computations differ where a
  rounding flips (cuDNN, oneDNN and XLA sum in other orders, and XLA's CPU
  backend keeps excess precision across fused elementwise ops), and the
  flip spreads through the layers, so the bound is statistical, not
  elementwise; measured 0.99989 / 1.13% (unfolded) and 0.99988 / 1.14%
  (folded + fused); it is half the 6% of the JAX package's own bf16 test;
- port bf16 against JAX fp32 and against the port's fp32, within the JAX
  package's own bounds for bf16 against fp32
  (``tests/test_bf16_and_lrs_train.py``): mel3 correlation > 0.99 and
  spectrogram relative L2 < 5% on random weights (``:54-114``; measured
  0.99991 / 0.67%), > 0.999 and < 6% on the trained weights (``:142-204``;
  measured 0.99992 / 1.49%); the JAX package's own bf16 is held to the
  same bounds on these inputs, as the yardstick;
- the folded + fused bf16 path against the unfolded bf16 one (``BF16_PAIR``;
  measured 0.99989 / 1.01%);
- ``BasicBlock`` packs the fused kernel's weights for the compute dtype;
- ``vcagan_torch.bench`` runs its composition on the CPU at a small size.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_templates, jax_variables
from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.configs import ModelConfig as JaxModelConfig
from vcagan.dsp import MelPipeline as JaxMelPipeline
from vcagan.io.serving_npz import load_serving_npz as jax_load_serving_npz
from vcagan.nn import AVAttention as JaxAVAttention
from vcagan.nn import fold_generator_side as jax_fold_generator_side
from vcagan.train import VCAGANModules
from vcagan_torch import bench
from vcagan_torch.configs import ModelConfig
from vcagan_torch.io.weights import from_jax
from vcagan_torch.kernels.fused_block import pack_weights
from vcagan_torch.nn.resnet import BasicBlock
from vcagan_torch.serve import Synthesizer
from _torch_threads import _one_thread  # noqa: F401  (autouse)


SERVING_NPZ = os.path.join(os.path.dirname(__file__), "..", "data", "soak_serving_q8.npz")
B, T, HW = 2, 8, 48
VARIANTS = {"unfolded": {}, "folded+fused": dict(fold_bn=True, fused_blocks=True)}
# (mel3 correlation above, spectrogram relative L2 below)
BF16_PAIR = (0.999, 0.03)  # two bf16 computations on the same weights
JAX_BOUNDS = {"random": (0.99, 0.05), "trained": (0.999, 0.06)}  # bf16 against fp32


def _inputs():
    rng = np.random.default_rng(5)
    video = rng.standard_normal((B, T, HW, HW, 1)).astype(np.float32)
    lengths = np.asarray([T, T - 2], np.int32)
    noise = rng.standard_normal((B, 20, T, 128)).astype(np.float32)
    return video, lengths, noise


def _jax_path(params, stats, video, lengths, noise, bf16, folded):
    """bench.py's composition up to the spectrogram, in bf16 or fp32, with
    the noise injected."""
    if folded:
        params, stats = jax_fold_generator_side(params, stats)
    m = VCAGANModules.create(JaxModelConfig(use_bfloat16=bf16), fold_bn=folded,
                             fused_blocks=folded)
    var = lambda k: {"params": params[k], "batch_stats": stats[k]}  # noqa: E731
    phon, sent = m.v_front.apply(var("v_front"), video, train=False)
    mel1, mel2, mel3 = m.gen.apply(var("gen"), sent, phon, lengths, train=False, noise=noise)
    post = m.post.apply(var("post"), mel3, train=False)
    return dict(phon=phon, sent=sent, mel1=mel1, mel2=mel2, mel3=mel3, post=post,
                spec=jnp.swapaxes(post, 1, 2).astype(jnp.float32))


_WEIGHTS, _RUNS = {}, {}


def _weights(name):
    if name not in _WEIGHTS:
        trees = (jax_load_serving_npz(SERVING_NPZ, *jax_templates()) if name == "trained"
                 else jax_variables(seed=3))
        _WEIGHTS[name] = trees, from_jax(*trees)
    return _WEIGHTS[name]


def _run(side, weights, bf16, variant="unfolded"):
    """Outputs (mel3, spec) as float32 numpy, each run once per module."""
    key = (side, weights, bf16, variant)
    if key not in _RUNS:
        (params, stats), states = _weights(weights)
        video, lengths, noise = _inputs()
        if side == "jax":
            out = _jax_path(params, stats, *(jnp.asarray(a) for a in (video, lengths, noise)),
                            bf16=bf16, folded=variant != "unfolded")
            out = {k: np.asarray(out[k], np.float32) for k in ("mel3", "spec")}
        else:
            synth = Synthesizer(ModelConfig(use_bfloat16=bf16), device="cpu", **VARIANTS[variant])
            out = synth.load_state_dicts(states)(video, lengths, noise=noise)
            out = {k: out[k].float().numpy() for k in ("mel3", "spec")}
        _RUNS[key] = out
    return _RUNS[key]


def _assert_close(got, want, bounds, what):
    corr = np.corrcoef(got["mel3"].ravel(), want["mel3"].ravel())[0, 1]
    rel = np.linalg.norm(got["spec"] - want["spec"]) / np.linalg.norm(want["spec"])
    print(f"{what}: mel3 correlation {corr:.6f}, spectrogram relative L2 {rel:.4%}")
    assert corr > bounds[0] and rel < bounds[1], (what, corr, rel)


def _torch_dtype_name(dtype):
    return str(dtype).split(".")[-1]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dtype_map_equals_jax(variant):
    params, stats = jax_templates()
    video, lengths, noise = (jax.ShapeDtypeStruct(a.shape, a.dtype) for a in _inputs())
    want = jax.eval_shape(
        lambda p, s, v, l, n: _jax_path(p, s, v, l, n, bf16=True, folded=variant != "unfolded"),
        params, stats, video, lengths, noise,
    )
    want["wav"] = jax.eval_shape(
        lambda spec: JaxMelPipeline(JaxAudioConfig()).inverse_spec(spec, jax.random.PRNGKey(0)),
        want["spec"],
    )
    g1 = jax.ShapeDtypeStruct((B, 20, T, 128), jnp.bfloat16)  # the decoder's bf16 map
    want["ctx"] = jax.eval_shape(
        lambda p, s, g, l: JaxAVAttention().apply({"params": p}, s, g, l),
        params["gen"]["att1"], want["sent"], g1, lengths,
    )
    want = {k: str(v.dtype) for k, v in want.items()}
    assert want == dict(phon="bfloat16", sent="float32", mel1="bfloat16", mel2="bfloat16",
                        mel3="bfloat16", post="bfloat16", spec="float32", wav="float32",
                        ctx="float32")

    synth = Synthesizer(ModelConfig(use_bfloat16=True), device="cpu", **VARIANTS[variant])
    assert all(p.dtype == torch.float32 for m in synth.modules() for p in m.parameters())
    video, lengths, noise = _inputs()
    got = synth(video, lengths, noise=noise)
    with torch.inference_mode():
        got["post"] = synth.post(got["mel3"])
        g1 = torch.zeros(B, 128, 20, T, dtype=torch.bfloat16)  # (B, C, F, T)
        got["ctx"] = synth.gen.att1(got["sent"], g1, torch.from_numpy(lengths))
    assert {k: _torch_dtype_name(v.dtype) for k, v in got.items()} == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_path_matches_jax_bf16(variant):
    _assert_close(_run("port", "trained", True, variant), _run("jax", "trained", True, variant),
                  BF16_PAIR, f"port bf16 vs JAX bf16, {variant}")


@pytest.mark.parametrize("reference", ["jax", "port"])
@pytest.mark.parametrize("weights", ["random", "trained"])
def test_bf16_path_within_jax_bounds_of_fp32(weights, reference):
    _assert_close(_run("port", weights, True), _run(reference, weights, False),
                  JAX_BOUNDS[weights], f"port bf16 vs {reference} fp32, {weights} weights")
    if reference == "jax":  # the yardstick: the JAX package's own bf16 on these inputs
        _assert_close(_run("jax", weights, True), _run("jax", weights, False),
                      JAX_BOUNDS[weights], f"JAX bf16 vs JAX fp32, {weights} weights")


def test_folded_fused_bf16_matches_unfolded_bf16():
    _assert_close(_run("port", "trained", True, "folded+fused"), _run("port", "trained", True),
                  BF16_PAIR, "folded+fused bf16 vs unfolded bf16")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_basic_block_packs_for_the_compute_dtype(dtype):
    block = BasicBlock(64, 64, fold_bn=True, fused=True, dtype=dtype)
    state = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
             for i, (k, v) in enumerate(block.state_dict().items())}
    block.load_state_dict(state)  # repacks
    assert block.conv1.weight.dtype == torch.float32
    for conv, packed in ((block.conv1, block.w1_packed), (block.conv2, block.w2_packed)):
        hwio = conv.weight.detach().permute(2, 3, 1, 0)
        assert packed.dtype == dtype
        assert torch.equal(packed, pack_weights(hwio.contiguous(), dtype))
    synth = Synthesizer(ModelConfig(use_bfloat16=True), device="cpu", fold_bn=True,
                        fused_blocks=True)
    fused = [m for m in synth.v_front.modules() if isinstance(m, BasicBlock) and m.fused]
    assert len(fused) == 5
    assert all(m.w1_packed.dtype == m.w2_packed.dtype == torch.bfloat16 for m in fused)


@pytest.mark.parametrize("fold_bn_fused", [False, True])
def test_bench_composition_prints_one_line_of_four_keys(fold_bn_fused, capsys, monkeypatch):
    calls = []
    serve = Synthesizer.__call__
    monkeypatch.setattr(Synthesizer, "__call__",
                        lambda self, *a, **kw: calls.append(self.config) or serve(self, *a, **kw))
    line = bench.bench(device="cpu", fold_bn_fused=fold_bn_fused, batch=1, frames=4, image=48)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["unit"] == "mel-frames/s" and line["value"] > 0
    # the same batches on both variants, all in the bf16 mode by default
    assert len(calls) == bench.WARMUPS + bench.IN_FLIGHT == 10
    assert all(config.use_bfloat16 for config in calls)
