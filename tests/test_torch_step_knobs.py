"""The train step's knobs: ``d_phase="batched"`` and the remat sites
(``vfront``, ``stem``, ``r1``), the port against itself and against the JAX
package's ``make_train_step``.

Port against port: two steps from the seeded init of the narrow model of
``tests/test_torch_train_step.py`` with its dropout rates left non-zero
(0.3 in the visual front and between the biGRU's layers), B = 2 with
unequal lengths, 20-frame windows of 24 x 24, the step's own generator.
The init's convolution and dense biases, which the JAX package's
initialisation leaves at 0, are drawn U(+-0.1) from a seed of their own
(``nonzero_biases``): a bias whose exact gradient is 0 (ahead of a
train-mode BatchNorm; the attention's key bias, which shifts all the scores
of a row alike) would otherwise hold nothing but rounding noise in every
leaf of the state, its parameter and moments both, and no relative bound
could hold it (in float64 "batched" and "ref" part by 100% of such a
leaf, 4e-13 of its module's norm); from a non-zero start its weight decay
keeps it defined, as PyTorch's own initialisation did until the port took
the JAX package's.

- A remat site changes no arithmetic: the recompute runs the forward's
  operations on the forward's inputs, with the forward's dropout masks.
  So each combination is held to the step without remat bit for bit,
  after each step: the metrics, every parameter, BatchNorm statistic,
  ``num_batches_tracked`` and optimizer moment, and the generator's state
  (a recompute that moved the statistics again, redrew a mask or left
  the generator advanced would differ).  That is shown in fp32, the
  dtype the port trains in, under "ref" (``stem``, ``vfront``, ``r1``,
  ``stem,r1``, ``vfront,r1``), and in float64 for ``stem,r1`` under
  "batched".  ``RECOMPUTES`` counts each region's recomputes a step:
  ``stem`` and ``vfront`` once (the G backward; the D backward stops at
  ``phon``), ``r1`` twice a discriminator (R1's input gradient, then the
  D backward).
- ``d_phase="batched"`` sums in another order (one 2B convolution where
  "ref" runs two of B), so it is held to "ref" in float64: the metrics,
  every parameter and every BatchNorm statistic within 1e-9 relative (L2
  a leaf; measured at most 7e-16 for the metrics), the counts and the
  generator's state equal.  The optimizer moments within 1e-7: a
  convolution's bias ahead of a train-mode BatchNorm has a gradient of 0
  in exact arithmetic, so its computed gradient is rounding noise that
  the summation order moves (measured 1e-8 relative in those leaves'
  second moments, of order 1e-16 absolute, and 5e-9 in their first).
- The bf16 step under "batched": the 2B batch of real (fp32) and fake
  (bf16) mels reaches each discriminator in fp32, as ``jnp.concatenate``
  promotes it, then R1's B-row forward of the real mels.

Against the JAX package: one step of the port under ``d_phase="batched",
remat="stem,r1"`` against ``vcagan.train.make_train_step`` with the same
knobs, in the setting and at the first-step tolerances of
``tests/test_torch_train_step.py`` (its helpers take the knobs): metrics
1e-4 relative (gradient norms 2e-4), each module's first moment within
1e-2 relative L2.

The refusals use the JAX package's words: an unknown remat site, ``vfront``
with ``stem``, an unknown ``d_phase``; a dict of XLA compiler options has
no compiler to go to.  ``donate=False``, ``compiler_options=None`` and
``"auto"`` build a step.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from vcagan_torch.configs import ModelConfig, TrainConfig  # noqa: E402
from vcagan_torch.nn.common import RECOMPUTES  # noqa: E402
from vcagan_torch.parallel.dryrun import to_float64  # noqa: E402
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step  # noqa: E402

MODEL = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
             attention_inner=160, postnet_channels=32, disc_base_channels=8,
             disc_max_channels=32)  # dropout rates: the defaults, 0.3
B, W, HW = 2, 20, 24
STEPS = 2
STEP_SEED = 7
BIAS_SEED = 11
BATCHED_RTOL = 1e-9
BATCHED_MOMENT_RTOL = 1e-7
REMAT_RUNS = [("ref", "stem"), ("ref", "vfront"), ("ref", "r1"), ("ref", "stem,r1"),
              ("ref", "vfront,r1"), ("batched", "stem,r1")]
# a region's recomputes a step: r1 wraps each of the three discriminators
RECOMPUTES_A_STEP = {"stem": 1, "vfront": 1, "r1": 2 * 3}


def make_batch(dtype):
    rng = np.random.default_rng(0)
    real = np.float64 if dtype == torch.float64 else np.float32
    return Batch(
        video=torch.from_numpy(rng.standard_normal((B, W, HW, HW, 1)).astype(real)),
        mel=torch.from_numpy(np.clip(rng.standard_normal((B, 80, 4 * W)), -1, 1).astype(real)),
        spec=torch.from_numpy(np.abs(rng.standard_normal((B, 321, 4 * W))).astype(real)),
        vid_len=torch.tensor([W, W - 6], dtype=torch.int32),
        mel_len=torch.tensor([4 * W, 4 * (W - 6)], dtype=torch.int32),
    )


def state_leaves(state):
    """Every tensor of the train state, by name: the modules' parameters and
    buffers (BatchNorm statistics, ``num_batches_tracked``) and both
    optimizers' moments."""
    out = {f"{m}.{k}": v for m, sd in state.modules.state_dicts().items() for k, v in sd.items()}
    for side, opt in (("g", state.g_opt_state), ("d", state.d_opt_state)):
        for name in ("mu", "nu", "nu_max"):
            out.update({f"{side}.{name}.{i}": t for i, t in enumerate(getattr(opt, name))})
    return out


def nonzero_biases(modules):
    """Every convolution and dense bias of ``modules`` drawn U(+-0.1) from
    ``BIAS_SEED`` (see the module's docstring)."""
    generator = torch.Generator().manual_seed(BIAS_SEED)
    with torch.no_grad():
        for _, module in modules.named():
            for layer in module.modules():
                if isinstance(layer, (torch.nn.Linear, torch.nn.modules.conv._ConvNd)) and (
                        layer.bias is not None):
                    layer.bias.uniform_(-0.1, 0.1, generator=generator)
    return modules


def run_steps(d_phase, remat, dtype, model=MODEL):
    """Two steps under the knobs; each step's metrics, generator state and
    recomputes by site, and the state's leaves after the second."""
    modules = nonzero_biases(VCAGANModules.create(ModelConfig(**model), seed=0))
    if dtype == torch.float64:
        to_float64(modules)
    cfg = TrainConfig()
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=1, device="cpu")
    step = make_train_step(modules, g_tx, d_tx, cfg, d_phase=d_phase, remat=remat)
    batch = make_batch(dtype)
    generator = torch.Generator().manual_seed(STEP_SEED)
    out = dict(metrics=[], generator=[], recomputes=[])
    for _ in range(STEPS):
        RECOMPUTES.clear()
        state, metrics = step(state, batch, generator)
        out["metrics"].append({k: v.item() for k, v in metrics.items()})
        out["generator"].append(generator.get_state())
        out["recomputes"].append(dict(RECOMPUTES))
    out["leaves"] = {k: v.detach() for k, v in state_leaves(state).items()}
    return out


def leaf_rel(got, want):
    """Relative L2 of each leaf (0 where both leaves are 0)."""
    out = {}
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        out[k] = float(torch.linalg.vector_norm(g - w) / max(float(torch.linalg.vector_norm(w)),
                                                              1e-300))
    return out


@pytest.fixture(scope="module")
def runs():
    """Each run against its reference, compared as it ends so that at most
    two states are alive: the remat runs against the run without remat of
    their dtype and d_phase; "batched" against "ref" in float64."""
    deltas = {}

    def bitwise(got, want):
        return dict(
            metrics=got["metrics"] == want["metrics"],
            leaves=sorted(k for k, v in want["leaves"].items()
                          if not torch.equal(got["leaves"][k], v)),
            generator=[torch.equal(g, w) for g, w in zip(got["generator"], want["generator"])],
            recomputes=got["recomputes"])

    for d_phase, dtype in (("ref", torch.float32), ("batched", torch.float64)):
        base = run_steps(d_phase, "none", dtype)
        deltas[(d_phase, "none")] = dict(recomputes=base["recomputes"])
        for phase, remat in REMAT_RUNS:
            if phase == d_phase:
                deltas[(phase, remat)] = bitwise(run_steps(phase, remat, dtype), base)
        if d_phase == "batched":
            ref = run_steps("ref", "none", torch.float64)
            metric_rel = max(abs(g - w) / abs(w) for gm, wm in zip(base["metrics"], ref["metrics"])
                             for g, w in ((gm[k], wm[k]) for k in wm))
            counts = [k for k in ref["leaves"] if k.endswith("num_batches_tracked")]
            deltas["batched vs ref"] = dict(
                metric_rel=metric_rel,
                leaf_rel=leaf_rel(base["leaves"], ref["leaves"]),
                counts_equal=all(torch.equal(base["leaves"][k], ref["leaves"][k]) for k in counts),
                n_counts=len(counts),
                generator=[torch.equal(g, w) for g, w in zip(base["generator"],
                                                                ref["generator"])])
            del ref
        del base
    return deltas


@pytest.mark.parametrize("knobs", REMAT_RUNS, ids="/".join)
def test_remat_reproduces_the_step_bit_for_bit(runs, knobs):
    r = runs[knobs]
    assert r["metrics"], "the metrics differ from the step without remat"
    assert r["leaves"] == [], r["leaves"][:10]


@pytest.mark.parametrize("knobs", REMAT_RUNS, ids="/".join)
def test_remat_leaves_the_generator_where_the_step_leaves_it(runs, knobs):
    assert runs[knobs]["generator"] == [True] * STEPS


@pytest.mark.parametrize("knobs", REMAT_RUNS + [("ref", "none"), ("batched", "none")],
                         ids="/".join)
def test_each_region_recomputes_as_often_as_its_backward_passes_need(runs, knobs):
    sites = {s for s in knobs[1].split(",") if s != "none"}
    want = {s: RECOMPUTES_A_STEP[s] for s in sites}
    assert runs[knobs]["recomputes"] == [want] * STEPS


def test_batched_equals_ref_in_float64(runs):
    r = runs["batched vs ref"]
    worst = max(r["leaf_rel"], key=r["leaf_rel"].get)
    print(f"batched vs ref, float64: metrics {r['metric_rel']:.2e}, worst leaf {worst} "
          f"{r['leaf_rel'][worst]:.2e}")
    assert r["metric_rel"] <= BATCHED_RTOL
    for k, rel in r["leaf_rel"].items():
        moment = k.startswith(("g.", "d."))
        assert rel <= (BATCHED_MOMENT_RTOL if moment else BATCHED_RTOL), (k, rel)
    assert r["n_counts"] > 0 and r["counts_equal"]
    assert r["generator"] == [True] * STEPS


def test_batched_feeds_the_discriminators_fp32_in_bf16():
    """The bf16 modules under "batched": each discriminator's D-phase inputs
    are the 2B concatenation, promoted to fp32 (the real mel's dtype), then
    the real mel alone for R1, and its G-phase input the bf16 fake mel; the
    first convolution computes in bf16 each time."""
    model = {**MODEL, "use_bfloat16": True}
    modules = VCAGANModules.create(ModelConfig(**model), seed=0)
    seen = []
    for name in ("dis1", "dis2", "dis3"):
        d = getattr(modules, name)
        d.register_forward_pre_hook(lambda m, args, n=name: seen.append((n, *args[0].shape[:1],
                                                                         args[0].dtype)))
        d.main[0].register_forward_hook(lambda m, args, out, n=name: seen.append((n, out.dtype)))
    state, g_tx, d_tx = create_train_state(modules, TrainConfig(), device="cpu")
    step = make_train_step(modules, g_tx, d_tx, d_phase="batched")
    _, metrics = step(state, make_batch(torch.float32), torch.Generator().manual_seed(STEP_SEED))
    assert all(np.isfinite(v.item()) for v in metrics.values())
    names = ("dis1", "dis2", "dis3")
    d_phase = [(n, 2 * B, torch.float32) for n in names] + [(n, B, torch.float32) for n in names]
    g_phase = [(n, B, torch.bfloat16) for n in names]
    inputs = [s for s in seen if len(s) == 3]
    assert inputs == d_phase + g_phase
    assert [s for s in seen if len(s) == 2] == [(n, torch.bfloat16) for n, *_ in inputs]


@pytest.fixture(scope="module")
def jax_run():
    """One step of the JAX package's step and of the port's, both under
    ``d_phase="batched", remat="stem,r1"``, in the setting of
    ``tests/test_torch_train_step.py``."""
    import test_torch_train_step as ref

    params, stats = ref.train_variables(ref.JaxModules.create(ref.JaxModelConfig(**ref.NARROW)),
                                        seed=31)
    batch = ref.make_batch()
    knobs = dict(d_phase="batched", remat="stem,r1")
    _, jax_metrics, jax_moments = ref.jax_steps(params, stats, batch, sync_leak=True, steps=1,
                                                **knobs)
    RECOMPUTES.clear()
    _, port_metrics, port_moments = ref.port_steps(params, stats, batch, sync_leak=True, steps=1,
                                                   **knobs)
    return dict(ref=ref, jax_metrics=jax_metrics[0], port_metrics=port_metrics[0],
                jax_moments=jax_moments[0], port_moments=port_moments[0],
                recomputes=dict(RECOMPUTES))


def test_jax_step_metrics(jax_run):
    ref, want, got = jax_run["ref"], jax_run["jax_metrics"], jax_run["port_metrics"]
    assert jax_run["recomputes"] == {"stem": 1, "r1": 6}
    assert sorted(got) == sorted(want) and len(want) == 9
    for k in want:
        rtol = ref.METRIC_RTOL[0]["norm" if k in ref.GRAD_NORMS else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "dis1", "dis2", "dis3", "s_dis"])
def test_jax_step_first_moment(jax_run, name):
    ref = jax_run["ref"]
    g, w = ref.flat(jax_run["port_moments"][name]), ref.flat(jax_run["jax_moments"][name])
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= 1e-2, rel


@pytest.fixture(scope="module")
def tiny():
    modules = VCAGANModules.create(ModelConfig(**MODEL))
    state, g_tx, d_tx = create_train_state(modules, TrainConfig(), device="cpu")
    return modules, g_tx, d_tx


@pytest.mark.parametrize("knobs,words", [
    (dict(remat="stem,bogus"),
     r"unknown remat site\(s\) \['bogus'\]; valid: none, vfront, stem, r1"),
    (dict(remat="vfront, stem"), "remat sites 'vfront' and 'stem' are mutually exclusive"),
    (dict(d_phase="joint"), "unknown d_phase 'joint'; valid: ref, batched"),
    (dict(compiler_options={"xla_tpu_scoped_vmem_limit_kib": "65536"}), "XLA compiler options"),
], ids=["unknown site", "vfront with stem", "unknown d_phase", "compiler options dict"])
def test_refusals(tiny, knobs, words):
    with pytest.raises(ValueError, match=words):
        make_train_step(*tiny, **knobs)


@pytest.mark.parametrize("knobs", [
    dict(donate=False), dict(compiler_options=None), dict(compiler_options="auto"),
    dict(remat=" none , r1,"), dict(remat="stem,r1", d_phase="batched", donate=False),
], ids=["donate False", "compiler_options None", "compiler_options auto", "blanks and none",
        "all at once"])
def test_accepted(tiny, knobs):
    assert callable(make_train_step(*tiny, **knobs))


def test_the_jax_package_refuses_in_the_same_words():
    """The JAX step's own checks, for the words above."""
    import test_torch_train_step as ref

    modules = ref.JaxModules.create(ref.JaxModelConfig(**ref.NARROW))
    txs = [ref.jax_make_optimizer(1e-4, 0.0, False, (), 0.1, 1) for _ in range(2)]
    for knobs, words in ((dict(remat="stem,bogus"), r"unknown remat site\(s\) \['bogus'\]"),
                         (dict(remat="vfront, stem"), "mutually exclusive"),
                         (dict(d_phase="joint"), "unknown d_phase 'joint'; valid: ref, batched")):
        with pytest.raises(ValueError, match=words):
            ref.jax_make_train_step(modules, *txs, **knobs)

