"""The data-parallel train step: 2 gloo ranks against one process and
against the JAX package's step.

Two checks, run at once, each with a wall-clock limit that kills its
processes, so a rank left waiting in a collective fails the test:

1. ``python -m vcagan_torch.parallel.dryrun --float64``: one step of the
   gate's problem (the JAX gate's 20 frames of 24 x 24, the default
   ``TrainConfig``, 2 clips a rank; here at the narrow widths of
   ``tests/test_torch_train_step.py``) in one process on the whole batch,
   then on 2 ranks of half the batch each, all in float64, compared by
   ``vcagan_torch/parallel/dryrun.py`` ``compare``:
   - the metrics within ``METRIC_RTOL`` = 5e-4 relative and each updated
     generator-side leaf's mean|p| within 2.5 x lr, the tolerances of
     ``vcagan/parallel/dryrun.py`` unchanged;
   - the reduced gradients of the step, through the first moments, within
     ``GRAD_RTOL`` = 1e-5 relative a leaf and ``MODULE_GRAD_RTOL`` a
     module;
   - the parameters, BatchNorm statistics and optimizer states of both
     ranks equal bit for bit;
   - 2 attention calls a rank a step, at the rank's batch: (2, 20, 20, 32)
     and (2, 40, 20, 32).
2. The 2-rank fp32 step against ``vcagan.train.make_train_step`` on the
   concatenated batch, from the same weights and noise: the setting of
   ``tests/test_torch_train_step.py`` (its narrow widths with dropout 0,
   seeded weights through ``from_jax``, 32 x 32 frames, the JAX decoder fed
   the port's noise), at B = 4 with unequal lengths, 2 clips a rank, one
   step.  This file, run as a script, is a rank.  Held at that test's
   first-step tolerances: the metrics (rtol 1e-4 for losses, 2e-4 for the
   gradient norms), each module's first moment within 1e-2 relative L2,
   each module's update by the share of elements more than lr / 2 apart
   (below 5e-3), and the BatchNorm statistics of the global batch within
   1e-3 and 2e-3 of their move; the ranks' states equal bit for bit.
3. The same fp32 step on 2 x 2 ranks (``--model_parallel 2``: 2 data
   ranks of 2 clips, each a model group of 2 that splits the four
   attention projections by column), against the same JAX step at the same
   tolerances; each rank gathers the split leaves and their moments before
   it writes its state, and the ranks' whole states equal bit for bit.
   Launched with the 2 ranks above, so the JAX step compiles once for both.
4. The gate's float64 problem (``vcagan_torch/parallel/dryrun.py``
   ``build_problem`` and ``run_step``, through their Python entry) with
   the train step's knobs: 2 gloo ranks under ``remat="stem,r1",
   d_phase="batched"`` against one process without them, held by the
   gate's ``compare`` at its float64 bounds.  Dropout is on (the gate's
   default rates).  Under the layout the stem's BatchNorm all-reduce runs
   again inside the recompute, during the G backward: every rank must
   reach it at the same point, and the recomputed statistics must be the
   forward's, or the gradients are of another function.  This file, run
   as a script with ``knobs``, is one of those processes.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LIMIT_S = 240
WORLD = 2
LAYOUTS = {"2x1": (2, 1), "2x2": (4, 2)}  # name: (world, model_parallel)
B, W, HW = 4, 20, 32  # 2 clips a rank
LENGTHS = [W, W - 6, W - 3, W]
KNOBS = dict(remat="stem,r1", d_phase="batched")


def jax_reference():
    """``tests/test_torch_train_step.py``, which imports JAX: the test
    process's, never a rank's."""
    import test_torch_train_step

    return test_torch_train_step


def popen(cmd):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def finish(p):
    """Its exit code and output; kills the process group where it outlives
    the limit."""
    try:
        out = p.communicate(timeout=LIMIT_S)[0]
    finally:
        if p.poll() is None:  # the gate or the rank, and every process it started
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, out


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_batch():
    rng = np.random.default_rng(0)
    lengths = np.asarray(LENGTHS, np.int32)
    return dict(
        video=rng.standard_normal((B, W, HW, HW, 1)).astype(np.float32),
        mel=np.clip(rng.standard_normal((B, 80, 4 * W)), -1, 1).astype(np.float32),
        spec=np.abs(rng.standard_normal((B, 321, 4 * W))).astype(np.float32),
        vid_len=lengths, mel_len=4 * lengths,
    )


def rank_main(rank, port, out, world=WORLD, model_parallel=1):
    """One rank: one fp32 step of the problem in ``out`` on its rows; the
    split leaves and their moments gathered before the state is written."""
    from vcagan_torch.configs import ModelConfig, TrainConfig
    from vcagan_torch.parallel import initialize_distributed, make_layout
    from vcagan_torch.parallel.dryrun import state_digest
    from vcagan_torch.parallel.shard import ModelSplit
    from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step

    torch.set_num_threads(1)
    problem = torch.load(os.path.join(out, "problem.pt"), weights_only=False)
    assert initialize_distributed("gloo", f"tcp://localhost:{port}", world, rank)
    layout = make_layout(model_parallel, batch_size=B, device="cpu")
    modules = VCAGANModules.create(ModelConfig(**problem["model"])).load_state_dicts(
        problem["state_dicts"])
    split = ModelSplit(modules, layout)
    split.split_()
    cfg = TrainConfig(**problem["train"])
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=1, device="cpu")
    step = make_train_step(modules, g_tx, d_tx, cfg, mesh=layout)
    rows = layout.batch_slice(B)
    batch = Batch(**{k: torch.from_numpy(v[rows]) for k, v in problem["batch"].items()})
    state, metrics = step(state, batch, torch.Generator().manual_seed(problem["noise_seed"]))
    with split.full(state):
        result = dict(metrics={k: v.item() for k, v in metrics.items()},
                      digest=state_digest(state))
        if rank == 0:  # the others' whole states equal it (the digests)
            result.update(g_mu=state.g_opt_state.mu, d_mu=state.d_opt_state.mu,
                          state_dicts=modules.state_dicts())
        torch.save(result, os.path.join(out, f"mp{model_parallel}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def knob_main(rank, port, out):
    """The knob gate's process: rank -1 the single process on the whole
    batch without knobs, else a rank of two on its rows under ``KNOBS``."""
    from vcagan_torch.nn.common import RECOMPUTES
    from vcagan_torch.parallel import initialize_distributed, make_layout
    from vcagan_torch.parallel.dryrun import NARROW, build_problem, run_step

    torch.set_num_threads(1)
    args = dict(world=WORLD, model=NARROW, float64=True)
    if rank < 0:
        result = run_step(build_problem(**args))
    else:
        assert initialize_distributed("gloo", f"tcp://localhost:{port}", WORLD, rank)
        layout = make_layout(1, batch_size=2 * WORLD, device="cpu")
        result = run_step(build_problem(**args, layout=layout), layout.batch_slice(2 * WORLD),
                          layout, knobs=KNOBS)
        if rank:  # rank 0's moments stand for both (compare holds the states equal)
            result["moments"] = {}
        torch.distributed.destroy_process_group()
    result["recomputes"] = dict(RECOMPUTES)
    torch.save(result, os.path.join(out, f"knobs{rank}.pt"))


def jax_step(ref, params, stats, batch, noise):
    """One step of the JAX package's ``make_train_step`` on the whole
    batch, its decoder fed ``noise``: ``ref.FixedNoiseDecoder`` injects
    ``ref.NOISE``, set to the global batch's noise for the call."""
    kept = ref.NOISE
    ref.NOISE = noise
    try:
        state, metrics, moments = ref.jax_steps(params, stats, batch, sync_leak=True, steps=1)
    finally:
        ref.NOISE = kept
    return state, metrics[0], moments[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vcagan_torch.io.weights import from_jax

    gate = popen([sys.executable, "-m", "vcagan_torch.parallel.dryrun", "--world", str(WORLD),
                  "--device", "cpu", "--backend", "gloo", "--narrow", "--float64",
                  "--threads", "1", "--timeout", str(LIMIT_S - 20)])
    try:
        ref = jax_reference()
        out = tmp_path_factory.mktemp("ddp_jax")
        params, stats = ref.train_variables(
            ref.JaxModules.create(ref.JaxModelConfig(**ref.NARROW)), seed=31)
        batch = make_batch()
        torch.save(dict(model=ref.NARROW, train=ref.TRAIN, state_dicts=from_jax(params, stats),
                        batch=batch, noise_seed=ref.NOISE_SEED), out / "problem.pt")
        ranks = []
        for world, model_parallel in LAYOUTS.values():
            port = str(free_port())
            ranks += [popen([sys.executable, __file__, str(r), port, str(out), str(world),
                             str(model_parallel)]) for r in range(world)]
        try:
            # the port's noise at the global batch's shape, as each rank draws it
            noise = torch.randn((B, 20, W, ref.NARROW["noise_dim"]),
                                generator=torch.Generator().manual_seed(ref.NOISE_SEED)).numpy()
            jax_state, jax_metrics, jax_moments = jax_step(ref, params, stats, batch, noise)
        finally:
            logs = [finish(p) for p in ranks]
    finally:
        gate_result = finish(gate)
    for rc, log in logs:
        assert rc == 0, log[-3000:]
    results = {name: [torch.load(out / f"mp{mp}_rank{r}.pt", weights_only=False)
                      for r in range(world)] for name, (world, mp) in LAYOUTS.items()}
    return dict(gate=gate_result, ranks=results["2x1"], ranks_2x2=results["2x2"], params=params,
                stats=stats, jax_state=jax_state, jax_metrics=jax_metrics,
                jax_moments=jax_moments)


def test_two_ranks_reproduce_the_single_process_step(runs):
    from vcagan_torch.parallel.dryrun import GRAD_RTOL, METRIC_RTOL, MODULE_GRAD_RTOL

    rc, out = runs["gate"]
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert rc == 0 and lines, out[-3000:]
    r = json.loads(lines[-1])
    assert r["ok"], r
    print(f"float64: metrics {r['metric_rel']:.2e} relative, leaf mean|p| "
          f"{r['leaf_stat']:.2e} (bound {r['leaf_stat_bound']:.1e}), gradients "
          f"{r['grad_rel']:.2e} ({r['grad_rel_leaf']}), modules "
          f"{max(r['module_grad_rel'].values()):.2e}")
    assert r["world"] == WORLD
    assert r["metric_rel"] < METRIC_RTOL
    assert r["leaf_stat"] <= r["leaf_stat_bound"] == pytest.approx(2.5e-4)
    assert r["grad_rel"] <= GRAD_RTOL
    assert max(r["module_grad_rel"].values()) <= MODULE_GRAD_RTOL
    for calls in r["attention"]:  # each rank: two calls at its own 2 clips
        assert calls == [[2, 20, 20, 32], [2, 40, 20, 32]]
    assert r["reference_attention"] == [[4, 20, 20, 32], [4, 40, 20, 32]]
    assert r["attention_calls"] == [0, 0]  # the plain version on CPU tensors: no kernel


@pytest.fixture(scope="module")
def knob_gate(tmp_path_factory):
    """The single process and the 2 ranks at once, after the checks above
    (the tests' order), so that their processes and these do not share the
    CPU."""
    out = tmp_path_factory.mktemp("ddp_knobs")
    port = str(free_port())
    procs = [popen([sys.executable, __file__, "knobs", str(r), port, str(out)])
             for r in (-1, *range(WORLD))]
    logs = [finish(p) for p in procs]
    for rc, log in logs:
        assert rc == 0, log[-3000:]
    return [torch.load(out / f"knobs{r}.pt", weights_only=False) for r in (-1, *range(WORLD))]


def test_two_ranks_under_the_knobs_reproduce_the_single_process_step(knob_gate):
    from vcagan_torch.parallel.dryrun import GRAD_RTOL, METRIC_RTOL, MODULE_GRAD_RTOL, compare

    reference, *ranks = knob_gate
    r = compare(reference, ranks, GRAD_RTOL)
    print(f"float64 under {KNOBS}: metrics {r['metric_rel']:.2e} relative, leaf mean|p| "
          f"{r['leaf_stat']:.2e}, gradients {r['grad_rel']:.2e} ({r['grad_rel_leaf']}), modules "
          f"{max(r['module_grad_rel'].values()):.2e}")
    assert r["metric_rel"] < METRIC_RTOL and r["grad_rel"] <= GRAD_RTOL
    assert max(r["module_grad_rel"].values()) <= MODULE_GRAD_RTOL
    assert r["attention"] == [[[2, 20, 20, 32], [2, 40, 20, 32]]] * WORLD
    # the stem once in the G backward, each discriminator's 2B forward twice
    assert reference["recomputes"] == {}
    assert [rank["recomputes"] for rank in ranks] == [{"stem": 1, "r1": 6}] * WORLD


def port_state(ref, rank_result):
    """The rank's modules and first moments, shaped as the port's train
    state for ``ref.first_moments`` and ``ref.as_jax_trees``."""
    from vcagan_torch.configs import ModelConfig
    from vcagan_torch.train import VCAGANModules

    modules = VCAGANModules.create(ModelConfig(**ref.NARROW)).load_state_dicts(
        rank_result["state_dicts"])
    return types.SimpleNamespace(modules=modules,
                                 g_opt_state=types.SimpleNamespace(mu=rank_result["g_mu"]),
                                 d_opt_state=types.SimpleNamespace(mu=rank_result["d_mu"]))


def check_jax_step_metrics(runs, key):
    ref = jax_reference()
    ranks, want = runs[key], runs["jax_metrics"]
    assert all(r["digest"] == ranks[0]["digest"] for r in ranks)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    got = ranks[0]["metrics"]
    assert sorted(got) == sorted(want) and len(want) == 9
    for k in want:
        rtol = ref.METRIC_RTOL[0]["norm" if k in ref.GRAD_NORMS else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=k)


def test_two_ranks_match_the_jax_step_metrics(runs):
    check_jax_step_metrics(runs, "ranks")


def test_two_by_two_ranks_match_the_jax_step_metrics(runs):
    check_jax_step_metrics(runs, "ranks_2x2")


MODULES = ["v_front", "gen", "post", "dis1", "dis2", "dis3", "s_dis"]


def check_jax_first_moment(runs, key, name):
    """The reduced gradient, through the first moment (1 - b1) (g + wd p)."""
    ref = jax_reference()
    got = ref.first_moments(port_state(ref, runs[key][0]))[name]
    g, w = ref.flat(got), ref.flat(runs["jax_moments"][name])
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    print(f"{key} {name}: first moment {rel:.2e} relative L2 from the JAX step's")
    assert rel <= 1e-2, rel


@pytest.mark.parametrize("name", MODULES)
def test_two_ranks_match_the_jax_first_moment(runs, name):
    check_jax_first_moment(runs, "ranks", name)


@pytest.mark.parametrize("name", MODULES)
def test_two_by_two_ranks_match_the_jax_first_moment(runs, name):
    check_jax_first_moment(runs, "ranks_2x2", name)


def check_jax_update(runs, key, name):
    from vcagan_torch.configs import TrainConfig

    ref = jax_reference()
    got = ref.as_jax_trees(port_state(ref, runs[key][0]))[0][name]
    jax_state = runs["jax_state"]
    want = {**jax_state.g_params, **jax_state.d_params}[name]
    flipped = ref.flipped_share(runs["params"][name], got, want, TrainConfig().lr)
    assert flipped < 5e-3, flipped


@pytest.mark.parametrize("name", MODULES)
def test_two_ranks_match_the_jax_update(runs, name):
    check_jax_update(runs, "ranks", name)


@pytest.mark.parametrize("name", MODULES)
def test_two_by_two_ranks_match_the_jax_update(runs, name):
    check_jax_update(runs, "ranks_2x2", name)


def check_jax_batch_statistics(runs, key, name):
    """The running statistics move with the global batch's statistics, as
    flax's BatchNorm over the JAX step's whole batch."""
    ref = jax_reference()
    got = ref.as_jax_trees(port_state(ref, runs[key][0]))[1][name]
    g, w = ref.flat(got), ref.flat(runs["jax_state"].batch_stats[name])
    s = ref.flat(runs["stats"][name])
    assert np.abs(g - w).max() <= 1e-3
    assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w - s)
    assert np.abs(g - s).min() > 0  # every statistic moved


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "s_dis"])
def test_two_ranks_match_the_jax_batch_statistics(runs, name):
    check_jax_batch_statistics(runs, "ranks", name)


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "s_dis"])
def test_two_by_two_ranks_match_the_jax_batch_statistics(runs, name):
    check_jax_batch_statistics(runs, "ranks_2x2", name)


if __name__ == "__main__":
    if sys.argv[1] == "knobs":
        knob_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
                  int(sys.argv[5]))
