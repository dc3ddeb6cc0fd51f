"""The model axis of the port (``model_parallel`` > 1) against the JAX
package.

- The split plan (``vcagan_torch/parallel/shard.py``) against
  ``vcagan.parallel.mesh._param_spec`` at the full ``ModelConfig``, M = 1,
  2, 3, 4: every port parameter mapped to its flax leaf (the port's state
  dicts through the converter, ``tools/convert_torch_ckpt.py``, and back
  through ``from_jax`` with each leaf tagged), the same leaves split, on
  the matching axis (JAX's 1, the port's 0), nothing at M = 3.
- ``make_layout``: the groups as ``make_mesh`` lays out devices (row-major
  (data, model)); its refusals (M does not divide the world, the data size
  does not divide the batch, M = 2 in one process).
- One launch of 4 gloo processes (``torchrun``, this file as the script,
  one torch thread each), 2 data x 2 model ranks:
  1. ``AVAttention`` at full width with ``q`` and ``mel`` split over each
     model group, lengths 0, < S and = S.  In float64, against the JAX
     ``AVAttention`` on the same weights (``attention_state``, the
     converter's inverse) and inputs: the output and the gradients of
     ``g``, ``sent`` and every weight (the slices concatenated in
     model-rank order) within 1e-5 (``tests/test_torch_attention.py``'s
     tolerance; in fp32 the unsplit port's own weight gradients, of up to
     50, lie up to 2.5e-5 from the JAX module's).  In fp32, against the
     port's unsplit module: the output and the gradients within 1e-5
     relative and 1e-5 of max(1, each tensor's largest magnitude).  Not bit for
     bit: the unsplit ``Linear`` adds its bias inside the product, and the
     input gradients' sum over the model ranks reassociates the
     contraction over the split columns;
  2. ``python -m vcagan_torch.cli.train --model_parallel 2`` at the narrow
     widths of ``tests/test_torch_loop.py`` (global batch 2, 2 steps, the
     validation and checkpoint of step 2 on rank 0): every rank's whole
     state (gathered) equal; the checkpoint restored into the split state
     of each rank gives its state back bit for bit, and restored into one
     process gives the ranks' whole state, with the keys, shapes and
     dtypes of a one-process checkpoint.
- Before it (the two at once, beside the tier-1 command's other workers,
  ran out of time), ``python -m vcagan_torch.parallel.dryrun --world 4
  --model_parallel 2 --float64`` at the narrow widths: the 2 x 2 gate held
  to one process at its bounds (metrics 5e-4, leaf mean|p| 2.5 x lr,
  gradients 1e-5 a leaf and 2e-2 a module), the split leaves concatenated.

Every launch has a wall-clock limit that kills its processes.
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jax.sharding import PartitionSpec as P  # noqa: E402
from tools.convert_torch_ckpt import (  # noqa: E402
    convert_decoder, convert_discriminator, convert_postnet, convert_sync_discriminator,
    convert_visual_front)
from vcagan.nn import AVAttention as JaxAVAttention  # noqa: E402
from vcagan.parallel.mesh import _param_spec, make_mesh  # noqa: E402
from vcagan_torch.configs import ModelConfig, grid_config  # noqa: E402
from vcagan_torch.io.weights import attention_state, from_jax  # noqa: E402
from vcagan_torch.nn.attention import AVAttention  # noqa: E402
from vcagan_torch.parallel import make_layout, mesh  # noqa: E402
from vcagan_torch.parallel.shard import jax_path, split_axis, split_leaves  # noqa: E402
from vcagan_torch.train import VCAGANModules  # noqa: E402

LIMIT_S = 240
WORLD, MODEL = 4, 2
TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT = {("gen", "att1.q.weight"), ("gen", "att2.q.weight"), ("gen", "att1.mel.weight"),
         ("gen", "att2.mel.weight")}
# the attention problem: att1's shapes at full width, lengths 0, < S and = S
B, S, T, F, C = 3, 7, 9, 20, 128
LENGTHS = [0, 4, S]
# the CLI run: the narrow widths of tests/test_torch_loop.py
NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32)
CONFIG = {**{f"model.{k}": v for k, v in NARROW.items()}, "data.crop_size": 32,
          "data.synthetic_clips": 4}
STEPS = 2


# ------------------------------------------------------------- split plan


@pytest.fixture(scope="module")
def leaf_paths():
    """Each port parameter at the full ModelConfig: its full shape and the
    flax leaves (path, shape) whose values it holds, found by tagging every
    leaf of the converted trees with its own number and mapping the trees
    back with ``from_jax``."""
    modules = VCAGANModules.create(ModelConfig())
    sd = {name: {k: t.numpy() for k, t in m.state_dict().items()} for name, m in modules.named()}
    converted = {"v_front": convert_visual_front(sd["v_front"]),
                 "gen": convert_decoder(sd["gen"]), "post": convert_postnet(sd["post"]),
                 **{f"dis{p}": convert_discriminator(sd[f"dis{p}"], p) for p in "123"},
                 "s_dis": convert_sync_discriminator(sd["s_dis"])}
    leaves = []

    def tag(tree, path):
        if isinstance(tree, dict):
            return {k: tag(v, f"{path}/{k}") for k, v in tree.items()}
        leaves.append((path, np.shape(tree)))
        return np.full(np.shape(tree), len(leaves) - 1, np.float32)

    params = {name: tag(c["params"], name) for name, c in converted.items()}
    stats = {name: c.get("batch_stats", {}) for name, c in converted.items()}
    tagged = from_jax(params, stats)
    out = {}
    for name, module in modules.named():
        for key, p in module.named_parameters():
            ids = np.unique(tagged[name][key])
            out[(name, key)] = (tuple(p.shape), [leaves[int(i)] for i in ids])
    return out


@pytest.mark.parametrize("model_parallel", [1, 2, 3, 4])
def test_split_plan_is_the_jax_rule(leaf_paths, model_parallel):
    split = set()
    for (name, key), (shape, leaves) in leaf_paths.items():
        specs = [_param_spec(path, types.SimpleNamespace(ndim=len(s), shape=s), model_parallel)
                 for path, s in leaves]
        assert all(spec in (P(), P(None, "model")) for spec in specs)
        want = None
        if P(None, "model") in specs:  # JAX splits the leaf's axis 1, the port its axis 0
            assert len(leaves) == 1 and jax_path(name, key) == leaves[0][0]
            assert leaves[0][1] == shape[::-1]
            want = 0
        assert split_axis(jax_path(name, key), shape, model_parallel) == want, (name, key)
        if want is not None:
            split.add((name, key))
    assert split == {(leaf.module, leaf.key)
                     for leaf in split_leaves(VCAGANModules.create(ModelConfig()), model_parallel)}
    # 256 and 1280 columns: all four at 2 and 4, none at 3
    assert split == (SPLIT if model_parallel in (2, 4) else set())


# ----------------------------------------------------------------- layout


def fake_world(monkeypatch, world, rank):
    """``torch.distributed`` as rank ``rank`` of ``world`` sees it;
    ``new_group`` returns the tuple of its ranks."""
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(mesh.dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(mesh.dist, "new_group", lambda ranks: tuple(ranks))


def test_make_layout_lays_ranks_out_as_make_mesh_lays_devices(monkeypatch):
    grid = np.arange(8).reshape(4, 2)  # make_mesh's row-major (data, model) reshape
    for rank in range(8):
        fake_world(monkeypatch, 8, rank)
        layout = make_layout(2, batch_size=8, device="cpu")
        d, m = np.argwhere(grid == rank)[0]
        assert (layout.data, layout.model, layout.data_rank, layout.model_rank) == (4, 2, d, m)
        assert layout.model_group == tuple(grid[d]) and layout.data_group == tuple(grid[:, m])
        assert layout.batch_slice(8) == slice(2 * d, 2 * d + 2)
    fake_world(monkeypatch, 8, 5)
    one = make_layout(1, batch_size=8, device="cpu")
    assert (one.data, one.data_rank, one.model_group) == (8, 5, None)
    assert one.data_group is one.group


def test_make_layout_refusals(monkeypatch):
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        make_mesh(model_parallel=2, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="^1 processes not divisible by model_parallel=2$"):
        make_layout(2, device="cpu")  # one process
    fake_world(monkeypatch, 3, 1)
    with pytest.raises(ValueError, match="^3 processes not divisible by model_parallel=2$"):
        make_layout(2, device="cpu")
    fake_world(monkeypatch, 4, 1)
    with pytest.raises(ValueError, match=r"batch_size 3 .* data size 2: .* gcd = 1 x 2"):
        make_layout(2, batch_size=3, device="cpu")


# ------------------------------------------------------------- processes


def attention_inputs():
    rng = np.random.default_rng(11)
    return dict(sent=rng.standard_normal((B, S, 512)).astype(np.float32),
                g=rng.standard_normal((B, F, T, C)).astype(np.float32),  # JAX (B, F, T, C)
                lengths=np.asarray(LENGTHS, np.int32),
                cot=rng.standard_normal((B, F, T, 1280 // F)).astype(np.float32))


DTYPES = {"fp32": (torch.float32, np.float32), "float64": (torch.float64, np.float64)}


def port_attention(state, dtype=torch.float32):
    module = AVAttention(F * C)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return module.to(dtype)


def attention_pass(module, inputs, dtype=np.float32):
    """The port module's output and gradients on ``inputs`` (JAX layouts in,
    port layouts out): out, d sent, d g, and each parameter's gradient."""
    sent = torch.from_numpy(inputs["sent"].astype(dtype)).requires_grad_()
    g = torch.from_numpy(inputs["g"].astype(dtype)).permute(0, 3, 1, 2).requires_grad_()
    out = module(sent, g, torch.from_numpy(inputs["lengths"]))
    out.backward(torch.from_numpy(inputs["cot"].astype(dtype)).permute(0, 3, 1, 2))
    return dict(out=out.detach(), sent=sent.grad, g=g.grad,
                **{k: p.grad for k, p in module.named_parameters()})


def attention_rank(out_dir, layout):
    """The rank's passes in fp32 and float64 with its columns of ``q`` and
    ``mel``."""
    problem = torch.load(os.path.join(out_dir, "attention.pt"), weights_only=False)
    result = {}
    for name, (dtype, real) in DTYPES.items():
        module = port_attention(problem["state"], dtype)
        for linear in (module.q, module.mel):
            linear.weight.data = linear.weight.data.chunk(layout.model)[layout.model_rank].clone()
        with layout.active():
            result[name] = attention_pass(module, problem["inputs"], real)
    torch.save(result, os.path.join(out_dir, f"attention_rank{layout.rank}.pt"))


def worker(out_dir, argv):
    """A rank: the attention pass, then the training CLI; prints one RESULT
    line."""
    from vcagan_torch.cli import train as cli
    from vcagan_torch.io.checkpoint import CheckpointManager
    from vcagan_torch.parallel import initialize_distributed
    from vcagan_torch.parallel.dryrun import digest, split_tensors, state_digest
    from vcagan_torch.train.loop import Trainer

    torch.set_num_threads(1)
    assert initialize_distributed(backend="gloo")
    attention_rank(out_dir, make_layout(MODEL, device="cpu"))

    cli.grid_config = lambda **kw: grid_config(**{**kw, **CONFIG})
    fit = Trainer.fit

    def fit_and_report(self, *args, **kwargs):
        step = fit(self, *args, **kwargs)
        state = self.state
        sliced = digest(split_tensors(state, self.split))
        with self.split.full(state):
            whole = state_digest(state)
        (path,) = glob.glob(os.path.join(self.config.train.checkpoint_dir, "Epoch_*"))
        with self.split.full(state):  # the checkpoint of the last step, restored and cut
            CheckpointManager(self.config.train.checkpoint_dir).restore(state, path)
            restored_whole = state_digest(state)
        print("RESULT " + json.dumps(dict(
            rank=self.layout.rank, model_rank=self.layout.model_rank, step=step, whole=whole,
            sliced=sliced, restored_whole=restored_whole,
            restored_sliced=digest(split_tensors(state, self.split)),
            split=sorted(f"{leaf.module}.{leaf.key}" for leaf in self.split.leaves),
            shapes={f"{leaf.module}.{leaf.key}": list(leaf.linear.weight.shape)
                    for leaf in self.split.leaves}, checkpoint=path)), flush=True)
        return step

    Trainer.fit = fit_and_report
    cli.main(argv)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def popen(cmd):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def finish(p):
    """Its exit code and output; kills the process group where it outlives
    the limit."""
    try:
        out = p.communicate(timeout=LIMIT_S)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, out


def cli_argv(tmp):
    return ["--grid", "/nonexistent", "--batch_size", "2", "--window_size", "20",
            "--max_timesteps", "20", "--epochs", "1", "--max_steps", str(STEPS),
            "--eval_step", str(STEPS), "--media_every", "0", "--workers", "1",
            "--checkpoint_dir", str(tmp / "ckpt"), "--log_dir", str(tmp / "log"),
            "--platform", "cpu", "--model_parallel", str(MODEL)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    inputs = attention_inputs()
    jax_module = JaxAVAttention()
    params = jax_module.init(jax.random.PRNGKey(3), *(jnp.asarray(inputs[k])
                                                       for k in ("sent", "g", "lengths")))
    params = jax.tree.map(np.asarray, params["params"])
    torch.save(dict(state=attention_state(params, F), inputs=inputs), tmp / "attention.pt")
    # The gate's five processes first, then the four ranks: at once, beside
    # the tier-1 command's other workers, the gate ran out of its time.
    gate = popen([sys.executable, "-m", "vcagan_torch.parallel.dryrun", "--world", str(WORLD),
                  "--model_parallel", str(MODEL), "--device", "cpu", "--backend", "gloo",
                  "--narrow", "--float64", "--threads", "1", "--timeout", str(LIMIT_S - 20)])
    gate_result = ranks = None
    try:
        with jax.enable_x64(True):  # the JAX module in float64, this block only
            p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)

            def apply(p, sent, g):
                return jax_module.apply({"params": p}, sent, g, jnp.asarray(inputs["lengths"]))

            want, vjp = jax.vjp(apply, p64, *(jnp.asarray(inputs[k], jnp.float64)
                                              for k in ("sent", "g")))
            d_params, d_sent, d_g = vjp(jnp.asarray(inputs["cot"], jnp.float64))
            want64 = dict(out=np.asarray(want), sent=np.asarray(d_sent), g=np.asarray(d_g),
                          params=attention_state(jax.tree.map(np.asarray, d_params), F))
        gate_result = finish(gate)
        ranks = popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                       str(WORLD), "--master_addr", "localhost", "--master_port",
                       str(free_port()), __file__, str(tmp), *cli_argv(tmp)])
        plain = attention_pass(port_attention(attention_state(params, F)), inputs)
    finally:
        if gate_result is None:
            gate_result = finish(gate)
        if ranks is not None:
            ranks_result = finish(ranks)
    rc, log = ranks_result
    assert rc == 0, log[-4000:]
    results = sorted((json.loads(line.split("RESULT ", 1)[1]) for line in log.splitlines()
                      if "RESULT " in line), key=lambda r: r["rank"])
    attention = [torch.load(tmp / f"attention_rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]
    return dict(gate=gate_result, cli=results, attention=attention, plain=plain, tmp=tmp,
                jax=want64)


def whole_attention(ranks, dtype):
    """Data index 0's results in ``dtype``, the split weights' gradients
    concatenated in model-rank order."""
    got = dict(ranks[0][dtype])
    for k in ("q.weight", "mel.weight"):
        got[k] = torch.cat([ranks[m][dtype][k] for m in range(MODEL)])
    return got


def test_split_attention_matches_the_jax_module(runs):
    got, want = whole_attention(runs["attention"], "float64"), runs["jax"]
    assert tuple(runs["attention"][0]["float64"]["q.weight"].shape) == (256 // MODEL, F * C)
    assert tuple(runs["attention"][0]["float64"]["mel.weight"].shape) == (1280 // MODEL, 256)
    assert got["out"].dtype == torch.float64 and want["out"].dtype == np.float64
    np.testing.assert_allclose(got["out"].permute(0, 2, 3, 1).numpy(), want["out"], **TOL)
    np.testing.assert_allclose(got["sent"].numpy(), want["sent"], **TOL)
    np.testing.assert_allclose(got["g"].permute(0, 2, 3, 1).numpy(), want["g"], **TOL)
    assert set(want["params"]) == {"q.weight", "q.bias", "k.weight", "k.bias", "v.weight",
                                   "v.bias", "mel.weight", "mel.bias"}
    for k, w in want["params"].items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **TOL)
    assert np.isfinite(got["out"].numpy()).all() and (got["q.weight"] != 0).any()


def test_split_attention_against_the_unsplit_module(runs):
    ranks, plain = runs["attention"], runs["plain"]
    for r in range(WORLD):  # each data index's model group computes the same
        for dtype in DTYPES:
            for k, t in ranks[r][dtype].items():
                assert torch.equal(t, ranks[r % MODEL][dtype][k]), (r, dtype, k)
    got = whole_attention(ranks, "fp32")
    assert set(got) == set(plain)
    for k, want in plain.items():  # k.bias's gradient is 0 but for rounding: scale 1
        scale = max(float(want.abs().max()), 1.0)
        print(f"{k}: {float((got[k] - want).abs().max()) / scale:.2e} of max(1, its largest "
              "magnitude)")
        torch.testing.assert_close(got[k], want, rtol=1e-5, atol=1e-5 * scale, msg=k)


def test_two_by_two_gate_reproduces_the_single_process_step(runs):
    from vcagan_torch.parallel.dryrun import GRAD_RTOL, METRIC_RTOL, MODULE_GRAD_RTOL

    rc, out = runs["gate"]
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert rc == 0 and lines, out[-3000:]
    r = json.loads(lines[-1])
    assert r["ok"], r
    print(f"2 x 2 float64: metrics {r['metric_rel']:.2e} relative, leaf mean|p| "
          f"{r['leaf_stat']:.2e}, gradients {r['grad_rel']:.2e} ({r['grad_rel_leaf']}), "
          f"modules {max(r['module_grad_rel'].values()):.2e}")
    assert (r["world"], r["data"], r["model"]) == (WORLD, WORLD // MODEL, MODEL)
    assert r["split_leaves"] == sorted(f"{m}.{k}" for m, k in SPLIT)
    assert r["metric_rel"] < METRIC_RTOL
    assert r["leaf_stat"] <= r["leaf_stat_bound"] == pytest.approx(2.5e-4)
    assert r["grad_rel"] <= GRAD_RTOL
    assert max(r["module_grad_rel"].values()) <= MODULE_GRAD_RTOL
    for calls in r["attention"]:  # each rank: two calls at its data index's 2 clips
        assert calls == [[2, 20, 20, 32], [2, 40, 20, 32]]
    assert r["reference_attention"] == [[4, 20, 20, 32], [4, 40, 20, 32]]


def test_cli_trains_on_two_by_two_ranks_and_its_checkpoint_restores(runs):
    from vcagan_torch.io.checkpoint import STATE_FILE, CheckpointManager
    from vcagan_torch.parallel.dryrun import state_digest
    from vcagan_torch.train import create_train_state

    results = runs["cli"]
    assert [r["rank"] for r in results] == list(range(WORLD))
    assert all(r["step"] == STEPS for r in results)
    assert len({r["whole"] for r in results}) == 1  # every rank's whole state
    for r in results:
        assert r["split"] == sorted(f"{m}.{k}" for m, k in SPLIT)
        assert r["shapes"] == {"gen.att1.q.weight": [16, 2560], "gen.att2.q.weight": [16, 2560],
                               "gen.att1.mel.weight": [80, 32], "gen.att2.mel.weight": [80, 32]}
        assert r["sliced"] == results[r["model_rank"]]["sliced"]
        assert (r["restored_whole"], r["restored_sliced"]) == (r["whole"], r["sliced"])
    assert results[0]["sliced"] != results[1]["sliced"]
    path = results[0]["checkpoint"]

    config = grid_config(**CONFIG)
    modules = VCAGANModules.create(config.model)
    state, _, _ = create_train_state(modules, config.train, device="cpu")
    fresh = CheckpointManager(str(runs["tmp"] / "one")).save(state, 0,
                                                              generator=torch.Generator())
    CheckpointManager(os.path.dirname(path)).restore(state, path)
    assert state_digest(state) == results[0]["whole"]

    def layout_of(tree):
        if isinstance(tree, dict):
            return {k: layout_of(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [layout_of(v) for v in tree]
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        return type(tree)

    saved, one = (torch.load(os.path.join(p, STATE_FILE), weights_only=True)
                  for p in (path, fresh))
    assert layout_of(saved) == layout_of(one)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2:])
