"""``Trainer.fit`` on 2 gloo ranks through the training CLI under ``torchrun``,
against one process.

``torchrun --nproc_per_node 2`` runs this file as a script: it narrows the
GRID recipe (the widths of ``tests/test_torch_loop.py``; 4 synthetic clips
of 32 x 32 crops), then calls ``vcagan_torch.cli.train.main`` with
``--platform cpu`` (gloo), a global batch of 2, 2 steps, a validation and
checkpoint at step 2 and the media every step; the same script without
``torchrun`` is the one process on the whole batch.  Each run has a
wall-clock limit that kills its processes.

Held: each generator-side leaf's mean|p| after the 2 steps within 2 x 2.5
x lr (the bound of ``vcagan/parallel/dryrun.py`` for one step, once a
step); the metric stream's losses at step 1 within its ``METRIC_RTOL``
(5e-4 relative).  The rest is held to 3 to 6 times the spread of one
process against itself on 1 and on 3 CPU threads (measured at this
configuration): the gradient norms at step 1 within 5e-3 (spread 7.9e-4),
and at step 2, where the first update has flipped the sign of every
update element whose gradient lies within fp32 noise, the losses within
5e-3 (spread 2.5e-4) and the gradient norms within 5e-2 (spread 1.7e-2).
The ranks' train states and
generators equal bit for bit; only rank 0 writes: one record a step and
one of each validation (the CLI's before training, and at step 2) in the
stream, one checkpoint (as the one process's), and no
writer or checkpoint manager on rank 1.  The media and the validation draw
from the generator on rank 0 alone, so the second step also holds the
broadcast that hands rank 0's generator to rank 1.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 2
LIMIT_S = 300
NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32)
CONFIG = {**{f"model.{k}": v for k, v in NARROW.items()}, "data.crop_size": 32,
          "data.synthetic_clips": 4}


def worker(argv):
    """The CLI's main at the narrow widths; prints one RESULT line a rank."""
    from vcagan_torch.cli import train as cli
    from vcagan_torch.configs import grid_config
    from vcagan_torch.parallel.dryrun import g_param_leaf_stats, state_digest
    from vcagan_torch.train.loop import Trainer

    torch.set_num_threads(1)
    cli.grid_config = lambda **kw: grid_config(**{**kw, **CONFIG})
    fit = Trainer.fit

    def fit_and_report(self, *args, **kwargs):
        step = fit(self, *args, **kwargs)
        print("RESULT " + json.dumps(dict(
            rank=self.layout.rank, world=self.layout.world, step=step,
            digest=state_digest(self.state), generator=self.generator.get_state().tolist(),
            g_stats=g_param_leaf_stats(self.modules),
            writes=[self.writer is not None, self.ckpt is not None])), flush=True)
        return step

    Trainer.fit = fit_and_report
    cli.main(argv)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp, ranks):
    argv = ["--grid", "/nonexistent", "--batch_size", "2", "--window_size", "20",
            "--max_timesteps", "20", "--epochs", "1", "--max_steps", str(STEPS),
            "--eval_step", str(STEPS), "--media_every", "1", "--workers", "1",
            "--checkpoint_dir", str(tmp / "ckpt"), "--log_dir", str(tmp / "log"),
            "--platform", "cpu"]
    cmd = [sys.executable, __file__, *argv]
    if ranks > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
               "--master_addr", "localhost", "--master_port", str(free_port()), __file__, *argv]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def finish(p):
    try:
        out = p.communicate(timeout=LIMIT_S)[0]
    finally:
        if p.poll() is None:  # torchrun, its ranks, the collate threads
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode == 0, out[-4000:]
    results = [json.loads(line.split("RESULT ", 1)[1]) for line in out.splitlines()
               if "RESULT " in line]
    return sorted(results, key=lambda r: r["rank"]), out


def stream(tmp):
    with open(tmp / "log" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one, two = tmp_path_factory.mktemp("one"), tmp_path_factory.mktemp("two")
    procs = launch(one, 1), launch(two, 2)  # at once: each holds one core a process
    (single, _), (ranks, out) = finish(procs[0]), finish(procs[1])
    return dict(single=single, ranks=ranks, one=one, two=two, out=out)


def test_two_ranks_fit_as_one_process(runs):
    from vcagan_torch.parallel.dryrun import LEAF_LR_BOUND, METRIC_RTOL

    (single,), ranks = runs["single"], runs["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["world"] == 2
    assert single["world"] == 1 and single["step"] == ranks[0]["step"] == STEPS
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["generator"] == ranks[1]["generator"]
    train = {run: {r["step"]: r for r in stream(runs[run]) if "train/gen_loss" in r}
             for run in ("one", "two")}
    assert sorted(train["one"]) == sorted(train["two"]) == list(range(1, STEPS + 1))
    rtol = {1: {"loss": METRIC_RTOL, "norm": 5e-3}, 2: {"loss": 5e-3, "norm": 5e-2}}
    for step, want in train["one"].items():
        deltas = {}
        for key, v in want.items():
            if key.startswith("train/") and key != "train/step_seconds":
                d = deltas[key] = abs(train["two"][step][key] - v) / max(abs(v), 1e-6)
                bound = rtol[step]["norm" if key.endswith("grad_norm") else "loss"]
                assert d < bound, f"step {step} {key}: {train['two'][step][key]} vs {v}"
        print(f"step {step}: " + ", ".join(f"{k[6:]} {d:.1e}" for k, d in deltas.items()))
    lr = 1e-4
    stat = max(abs(ranks[0]["g_stats"][k] - v) for k, v in single["g_stats"].items())
    assert stat <= STEPS * LEAF_LR_BOUND * lr
    print(f"leaf mean|p| within {stat:.2e}")


def test_only_rank_0_writes(runs):
    ranks = runs["ranks"]
    assert ranks[0]["writes"] == [True, True] and ranks[1]["writes"] == [False, False]
    records = stream(runs["two"])
    steps = [r["step"] for r in records if "train/gen_loss" in r]
    assert steps == list(range(1, STEPS + 1))  # one record a step: rank 0's
    # the CLI's validation before training and the one at step 2, once each
    assert [r["step"] for r in records if "val/stoi" in r] == [0, STEPS]
    names = sorted(os.listdir(runs["two"] / "ckpt"))
    assert [n for n in names if n.startswith("Epoch_")] == [names[-1]]
    # Best_* too where the one process has it (where STOI rose)
    kinds = [[n.split("_")[0] for n in sorted(os.listdir(runs[run] / "ckpt"))]
             for run in ("one", "two")]
    assert kinds[0] == kinds[1]


if __name__ == "__main__":
    worker(sys.argv[1:])
