"""The PyTorch port's GRID loop: ``Trainer``, checkpoints and the training CLI.

A narrow model (the widths of ``tests/test_torch_train_step.py``), B = 2,
20-frame windows of 32 x 32 frames, a 4-clip synthetic source, on the CPU.

- ``fit`` equals ``make_train_step`` called directly on the same processed
  batches with the same generator, bit for bit (the same operations in the
  same order on one device), and logs each step's metrics; it validates
  and checkpoints every ``eval_step`` steps, or once an epoch.
- ``validate`` returns a finite (l1, stoi, estoi, pesq) and writes the JAX
  package's ``val/*`` keys (``vcagan/train/loop.py:476-486``).
- Checkpoint names are the JAX package's; ``Best_*`` moves only when STOI
  improves and links its checkpoint's files; save, restore into a Trainer
  of another seed (its weights, optimizer states and generator) and one
  more step equals three steps straight, bit for bit.
- The CLI's argv equals the JAX CLI's, ``--remat`` and ``--d_phase``
  included; ``main`` runs on the CPU with ``--platform cpu``.  ``--bf16``
  parses, and the Trainer builds on LRS2, LRS3 and in bf16 (LRS2 training
  itself: ``tests/test_torch_train_lrs.py``), and takes a step with
  ``train.remat="stem"`` and with ``train.d_phase="batched"`` (the knobs'
  equivalence: ``tests/test_torch_step_knobs.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from vcagan.cli import train as jax_cli
from vcagan.io.checkpoint import CheckpointManager as JaxCheckpointManager
from vcagan_torch.cli import train as cli
from vcagan_torch.configs import grid_config, lrs_config
from vcagan_torch.data.lrs import LRSDataset, SyntheticLRSSource
from vcagan_torch.io.checkpoint import CheckpointManager
from vcagan_torch.nn.common import RECOMPUTES
from vcagan_torch.train.loop import Trainer
from _torch_threads import _one_thread  # noqa: F401  (autouse)


NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32)
SMALL = {
    **{f"model.{k}": v for k, v in NARROW.items()},
    "data.window_size": 20, "data.max_v_timesteps": 20, "data.crop_size": 32,
    "data.data_root": "/nonexistent", "data.synthetic_clips": 4,
    "train.batch_size": 2, "train.eval_step": 0, "train.workers": 2,
}
VAL_KEYS = {"val/stoi", "val/estoi", "val/pesq", "val/stoi_mel", "val/estoi_mel",
            "val/pesq_mel"}


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint of this model is about 340 MB (its decoder keeps the
    full widths): keep none after the test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


LRS_SMALL = {
    **{f"model.{k}": v for k, v in NARROW.items()},
    "data.window_size": 20, "data.max_v_timesteps": 40,
    "data.data_root": "/nonexistent", "data.synthetic_clips": 4,
    "train.batch_size": 2, "train.workers": 2,
}


def small_trainer(tmp_path, name, **overrides):
    cfg = grid_config(**{**SMALL, "train.checkpoint_dir": str(tmp_path / name / "ckpt"),
                         **overrides})
    return Trainer(cfg, log_dir=str(tmp_path / name / "log"), device="cpu")


def small_lrs_trainer(tmp_path, name, dataset="LRS2", **overrides):
    cfg = lrs_config(dataset, **{**LRS_SMALL,
                                 "train.checkpoint_dir": str(tmp_path / name / "ckpt"),
                                 **overrides})
    return Trainer(cfg, log_dir=str(tmp_path / name / "log"), device="cpu")


def records(trainer):
    with open(trainer.writer.path) as f:
        return [json.loads(line) for line in f]


def tensors(trainer):
    """Every tensor of the train state, by name, and the step."""
    state = trainer.state
    out = {f"{m}.{k}": v for m, sd in state.modules.state_dicts().items() for k, v in sd.items()}
    for side, opt in (("g", state.g_opt_state), ("d", state.d_opt_state)):
        for name in ("mu", "nu", "nu_max"):
            # nu_max is None without AMSGrad (the LRS recipe)
            out.update({f"{side}.{name}.{i}": t for i, t in enumerate(getattr(opt, name) or [])})
        out[f"{side}.count"] = torch.tensor(opt.count)
    out["step"] = torch.tensor(state.step)
    return out


def assert_same_state(a, b):
    ta, tb = tensors(a), tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_fit_equals_the_train_step_called_directly(tmp_path):
    fitted = small_trainer(tmp_path, "fit")
    assert fitted.fit(epochs=1, max_steps=2) == 2
    assert len(fitted.queue_wait_s) == 2 and len(fitted.collate_s) == 2

    direct = small_trainer(tmp_path, "direct")
    metrics = []
    for raw in direct.train_ds.epoch(2):  # the same seeded shuffle and window draws
        batch = direct.process_train(raw, direct.generator)
        direct.state, m = direct.train_step(direct.state, batch, direct.generator)
        metrics.append(m)
    assert len(metrics) == 2
    assert_same_state(fitted, direct)
    lines = records(fitted)
    assert [r["step"] for r in lines] == [1, 2]
    for line, m in zip(lines, metrics):
        assert {f"train/{k}" for k in m} | {"train/step_seconds"} == set(line) - {"step", "time"}
        for k, v in m.items():
            assert line[f"train/{k}"] == v.item(), k


@pytest.mark.parametrize("eval_step", [2, 0])
def test_fit_validates_and_checkpoints(tmp_path, eval_step):
    """``eval_step`` 2: after every second step; 0: at each epoch's end (an
    epoch is two batches of the four clips here)."""
    trainer = small_trainer(tmp_path, "evals", **{"train.eval_step": eval_step})
    max_steps = 2 if eval_step else None
    assert trainer.fit(epochs=1, max_steps=max_steps) == 2
    lines = records(trainer)
    val = [r for r in lines if "val/stoi" in r]
    assert len(val) == 1 and val[0]["step"] == 2
    assert [r["step"] for r in lines if "train/gen_loss" in r] == [1, 2]
    assert any("train/epoch_seconds" in r for r in lines) == (eval_step == 0)
    saved = [p for p in os.listdir(trainer.ckpt.directory) if p.startswith("Epoch_0000_stoi_")]
    assert len(saved) == 1 and trainer.ckpt.latest().endswith(saved[0])


def test_validate_returns_metrics_and_writes_the_val_keys(tmp_path):
    trainer = small_trainer(tmp_path, "val")
    l1, stoi, estoi, pesq = trainer.validate(fast=False, max_batches=1)
    assert np.isfinite([l1, stoi, estoi, pesq]).all() and l1 > 0
    assert -1 <= stoi <= 1 and -1 <= estoi <= 1 and 1 <= pesq <= 4.64
    (line,) = records(trainer)
    assert set(line) - {"step", "time"} == VAL_KEYS and line["val/stoi"] == stoi
    # both splits fell back to the synthetic clips: one source renders them
    assert trainer._val_ds.source is trainer.train_ds.source
    # the cached dataset restarts its shuffle: a second pass scores the same clips
    again = trainer.validate(fast=True)
    assert len(records(trainer)) == 2 and np.isfinite(again).all()


def test_checkpoint_names_and_best(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    for args in ((0, 0.5, 0.25, 1.5), (12, 0.1234, 0.98765, 3.14159)):
        assert ckpt._name(*args) == JaxCheckpointManager._name(*args)
    trainer = small_trainer(tmp_path, "best")
    ckpt = trainer.ckpt
    first = ckpt.save(trainer.state, 0, stoi=0.5, estoi=0.4, pesq=2.0)
    assert os.path.basename(ckpt.best()) == "Best_" + os.path.basename(first)
    ckpt.save(trainer.state, 1, stoi=0.4, estoi=0.9, pesq=4.0)  # no better: Best_ stays
    assert os.path.basename(ckpt.best()) == "Best_" + os.path.basename(first)
    third = ckpt.save(trainer.state, 2, stoi=0.6, estoi=0.1, pesq=1.0)
    assert os.path.basename(ckpt.best()) == "Best_" + os.path.basename(third)
    assert len([p for p in os.listdir(ckpt.directory) if p.startswith("Best_")]) == 1
    assert ckpt.latest() == third
    assert CheckpointManager(ckpt.directory).best_metric == pytest.approx(0.6)
    # Best_* holds the same files, linked, not copied
    (fname,) = os.listdir(ckpt.best())
    assert os.path.samefile(os.path.join(ckpt.best(), fname), os.path.join(third, fname))
    with pytest.raises(ValueError, match="no generator state"):  # saved without one
        ckpt.restore(trainer.state, third, generator=trainer.generator)


def test_restore_then_one_step_equals_three_steps(tmp_path):
    """Each Trainer steps with its own generator; the checkpoint carries the
    first's into the resumed one, whose seed gave other weights and draws.
    The raw batches are handed in: the data's position is not saved."""
    def steps(trainer, batches):
        for raw in batches:
            batch = trainer.process_train(raw, trainer.generator)
            trainer.state, _ = trainer.train_step(trainer.state, batch, trainer.generator)

    straight = small_trainer(tmp_path, "straight")
    batches = [raw for _ in range(2) for raw in straight.train_ds.epoch(2)][:3]
    steps(straight, batches)

    first = small_trainer(tmp_path, "first")
    steps(first, batches[:2])
    path = first.ckpt.save(first.state, 0, stoi=0.3, generator=first.generator)
    resumed = small_trainer(tmp_path, "resumed", **{"train.seed": 7})
    assert not torch.equal(resumed.generator.get_state(), first.generator.get_state())
    resumed.ckpt.restore(resumed.state, path, generator=resumed.generator)
    assert_same_state(resumed, first)
    assert torch.equal(resumed.generator.get_state(), first.generator.get_state())
    steps(resumed, batches[2:])
    assert_same_state(resumed, straight)


@pytest.mark.parametrize("argv", [
    [],
    ["--grid", "/data/GRID", "--batch_size", "16", "--epochs", "3", "--subject", "s1",
     "--eval_step", "0", "--lr", "3e-4", "--seed", "5"],
    ["--window_size", "50", "--max_timesteps", "120", "--temp", "0.5", "--dataparallel",
     "--gpu", "0", "--workers", "2", "--start_epoch", "4", "--log_dir", "runs/x"],
    ["--checkpoint", "ck", "--checkpoint_dir", "cd", "--max_steps", "9", "--media_every", "0",
     "--synthetic", "--platform", "cpu", "--weight_decay", "0.0", "--augmentations", ""],
    ["--remat", "stem,r1", "--d_phase", "batched", "--bf16", "--collate_process"],
])
def test_parse_args_and_config_equal_the_jax_clis(argv):
    got, want = cli.parse_args(argv), jax_cli.parse_args(argv)
    assert vars(got) == vars(want)
    cfg, jcfg = cli.build_config(got), jax_cli.build_config(want)
    for part in ("data", "train", "model", "mesh"):
        mine, theirs = getattr(cfg, part), getattr(jcfg, part)
        for field in mine.__dataclass_fields__:
            assert getattr(mine, field) == getattr(theirs, field), f"{part}.{field}"


@pytest.mark.parametrize("argv,item", [
    # ported since: the flag parses into the config (the case keeps its id)
    pytest.param(["--bf16"], None, id="argv0-bf16 training"),
    pytest.param(["--remat", "r1"], None, id="argv1-TPU-compiler knobs"),
    pytest.param(["--d_phase", "batched"], None, id="argv2-TPU-compiler knobs"),
    pytest.param(["--model_parallel", "2"], None, id="argv3-multi-GPU"),
    pytest.param(["--collate_process"], None, id="argv4-ProcessEpoch"),
])
def test_unported_flags_stop_the_parse(argv, item, capsys):
    if item is None:
        cfg = cli.build_config(cli.parse_args(argv))
        if argv == ["--model_parallel", "2"]:  # the model axis: M ranks a model group
            assert cfg.mesh.model_parallel == 2
            return
        if argv[0] in ("--remat", "--d_phase"):  # the train step's knobs
            assert (cfg.train.remat, cfg.train.d_phase) == (
                ("r1", "ref") if argv[0] == "--remat" else ("none", "batched"))
            return
        assert cfg.model.use_bfloat16 if argv == ["--bf16"] else cfg.data.collate_process
        return
    with pytest.raises(SystemExit):
        cli.parse_args(argv)
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("override,item", [
    # ported since: the Trainer builds (the cases keep their ids)
    pytest.param({"data.dataset": "LRS2"}, None, id="override0-LRS data"),
    pytest.param({"data.dataset": "LRS3"}, None, id="override1-LRS data"),
    pytest.param({"model.use_bfloat16": True}, None, id="override2-bf16 training"),
    # ported since: the Trainer builds and takes a step (the cases keep their ids)
    pytest.param({"train.remat": "stem"}, None, id="override3-TPU-compiler knobs"),
    pytest.param({"train.d_phase": "batched"}, None, id="override4-TPU-compiler knobs"),
    # ported since: one process cannot hold a model group of 2, as make_mesh
    # cannot lay 1 device out as (data, 2) (the case keeps its id)
    pytest.param({"mesh.model_parallel": 2}, "^1 processes not divisible by model_parallel=2$",
                 id="override5-multi-GPU"),
    pytest.param({"data.collate_process": True}, None, id="override6-ProcessEpoch"),
])
def test_trainer_refuses_what_is_not_ported(tmp_path, override, item):
    if item is not None:
        with pytest.raises(ValueError, match=item):
            small_trainer(tmp_path, "refused", **override)
        return
    if "train.remat" in override or "train.d_phase" in override:
        trainer = small_trainer(tmp_path, "built", **override)
        rows = []
        trainer.modules.dis1.register_forward_pre_hook(lambda m, args: rows.append(len(args[0])))
        raw = next(iter(trainer.train_ds.epoch(trainer.config.train.batch_size)))
        RECOMPUTES.clear()
        trainer.state, metrics = trainer.train_step(
            trainer.state, trainer.process_train(raw, trainer.generator), trainer.generator)
        assert trainer.state.step == 1 and all(np.isfinite(v.item()) for v in metrics.values())
        if "train.remat" in override:  # the stem recomputed once, in the G backward
            assert dict(RECOMPUTES) == {"stem": 1} and rows == [2, 2, 2]
            step = trainer.train_step
            trainer.rebuild_train_step(d_phase="batched")  # the config's knobs kept
            assert trainer._step_kwargs == {"remat": "stem", "d_phase": "batched"}
            assert trainer.train_step is not step
        else:  # the D phase's 2B forward and R1's B forward, the G phase's B forward
            assert not RECOMPUTES and rows == [4, 2, 2]
        return
    if "data.dataset" in override:  # the LRS recipe on its synthetic clips
        with pytest.warns(UserWarning, match="not found under /nonexistent"):
            trainer = small_lrs_trainer(tmp_path, "built", override["data.dataset"])
        assert trainer.is_lrs and isinstance(trainer.train_ds, LRSDataset)
        assert isinstance(trainer.train_ds.source, SyntheticLRSSource)
    elif "data.collate_process" in override:  # fit feeds from the collate worker process
        trainer = small_trainer(tmp_path, "built", **override)
        assert trainer.config.data.collate_process
    else:
        trainer = small_trainer(tmp_path, "built", **override)
        assert trainer.modules.dis1.main[0].compute_dtype == torch.bfloat16
    assert trainer.device.type == "cpu" and trainer.steps_per_epoch == 2


def test_cli_main_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``main`` at the small size: build_config's recipe gets the narrow
    overrides that argv has no flags for."""
    narrow = {k: v for k, v in SMALL.items() if k.startswith("model.") or k in (
        "data.crop_size", "data.synthetic_clips")}
    monkeypatch.setattr(cli, "grid_config", lambda **kw: grid_config(**{**kw, **narrow}))
    log_dir = tmp_path / "log"
    cli.main(["--grid", "/nonexistent", "--batch_size", "2", "--window_size", "20",
              "--max_timesteps", "20", "--epochs", "1", "--max_steps", "1", "--eval_step", "0",
              "--workers", "1", "--checkpoint_dir", str(tmp_path / "ckpt"),
              "--log_dir", str(log_dir), "--platform", "cpu"])
    out = capsys.readouterr().out
    assert "pre-train validate: l1=" in out and "Finishing training" in out
    with open(log_dir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert sum("train/gen_loss" in r for r in lines) == 1
    assert sum("val/stoi" in r for r in lines) == 1

