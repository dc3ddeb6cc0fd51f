"""LRS2/LRS3 training in the PyTorch port against the JAX package.

- The LRS recipe's step (plain Adam, ``sync_dis_weight`` 0.5, L1 on
  normalised mels) once on both sides, from the weights, noise and narrow
  config of ``tests/test_torch_train_step.py`` (whose helpers this file
  uses), on its batch padded as the LRS pipeline pads (mel and spec -1.0
  past each clip's ``mel_len``; one clip of 14 of the 20 frames, so the
  attention masks its keys).  The bounds of that file's first step
  (measured: losses 1e-7, gradient norms 4e-5, first moments 4.7e-3,
  updates 1.5e-3 apart, statistics 6e-4).
- ``Trainer`` on LRS2 at the narrow widths of ``tests/test_torch_loop.py``
  (whose helpers this file uses), B = 2, 20-frame windows of the synthetic
  LRS clips (30-90 frames, cropped around their lip centres to 112 x 112),
  validation buckets up to 40 frames: ``fit`` equals the step called
  directly on the LRS pipeline's batch, one validation batch, a
  checkpoint round trip bit for bit.
- ``python -m vcagan_torch.cli.train_lrs``: its argv and config equal the
  JAX CLI's, ``--model_parallel 2`` among them, and ``main``
  runs one bf16 step on the CPU and raises without ``--platform cpu``
  where CUDA is absent.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_discriminator import train_variables  # noqa: E402
from test_torch_loop import (  # noqa: E402
    LRS_SMALL, VAL_KEYS, _drop_checkpoints, assert_same_state, records, small_lrs_trainer)
from test_torch_train_step import (  # noqa: E402
    CONVERTERS, GRAD_NORMS, METRIC_RTOL, NARROW, W, JaxModelConfig, JaxModules, as_jax_trees,
    flat, flipped_share, jax_steps, make_batch, port_steps)
from vcagan.cli import train_lrs as jax_cli_lrs  # noqa: E402
from vcagan_torch.cli import train_lrs as cli_lrs  # noqa: E402
from vcagan_torch.configs import TrainConfig, lrs_config  # noqa: E402

LRS_TRAIN = dict(lr_milestones=(1,), amsgrad=False, sync_dis_weight=0.5,
                 recon_on_denormalized=False)


def rel_l2(a, b):
    a, b = flat(a), flat(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def lrs_batch():
    """``make_batch`` padded as the LRS pipeline pads (-1.0 past each clip's
    mel_len), the spec normalised into [-1, 1]."""
    batch = make_batch()
    pad = np.arange(4 * W)[None, None, :] >= batch["mel_len"][:, None, None]
    batch["mel"] = np.where(pad, -1.0, batch["mel"]).astype(np.float32)
    batch["spec"] = np.where(pad, -1.0, np.clip(batch["spec"] - 1.0, -1, 1)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def lrs_run():
    params, stats = train_variables(JaxModules.create(JaxModelConfig(**NARROW)), seed=31)
    batch = lrs_batch()
    assert (batch["vid_len"] < W).any()
    jax_state, jax_metrics, jax_moments = jax_steps(params, stats, batch, True, 1,
                                                    train=LRS_TRAIN)
    port_state, port_metrics, port_moments = port_steps(params, stats, batch, True, 1,
                                                        train=LRS_TRAIN)
    return dict(params=params, stats=stats, jax_state=jax_state, jax_metrics=jax_metrics[0],
                jax_moments=jax_moments[0], port_state=port_state,
                port_metrics=port_metrics[0], port_moments=port_moments[0])


def test_lrs_step_metrics(lrs_run):
    want, got = lrs_run["jax_metrics"], lrs_run["port_metrics"]
    assert sorted(got) == sorted(want) and len(want) == 9
    for k in want:
        rtol = METRIC_RTOL[0]["norm" if k in GRAD_NORMS else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_lrs_step_first_moment_and_update(lrs_run, name):
    assert rel_l2(lrs_run["port_moments"][name], lrs_run["jax_moments"][name]) <= 1e-2
    got = as_jax_trees(lrs_run["port_state"])[0][name]
    want = {**lrs_run["jax_state"].g_params, **lrs_run["jax_state"].d_params}[name]
    assert flipped_share(lrs_run["params"][name], got, want, TrainConfig().lr) < 5e-3


@pytest.mark.parametrize("name", ["v_front", "gen", "post", "s_dis"])
def test_lrs_step_batch_statistics(lrs_run, name):
    got = as_jax_trees(lrs_run["port_state"])[1][name]
    want = lrs_run["jax_state"].batch_stats[name]
    g, w, s = flat(got), flat(want), flat(lrs_run["stats"][name])
    assert np.abs(g - w).max() <= 1e-3
    assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w - s)


def test_lrs_fit_validate_and_checkpoint(tmp_path):
    """LRS2 on the synthetic clips: one fit step equals the step called
    directly on the LRS pipeline's batch; one validation batch; a
    checkpoint round trip bit for bit."""
    fitted = small_lrs_trainer(tmp_path, "fit")
    assert fitted.fit(epochs=1, max_steps=1) == 1
    direct = small_lrs_trainer(tmp_path, "direct")
    raw = next(direct.train_ds.epoch(2))
    assert raw["video_raw"].shape[1] == 20 and {"centers", "centers_m", "vid_hw"} <= set(raw)
    batch = direct.process_train(raw, direct.generator)
    assert batch.video.shape == (2, 20, 112, 112, 1) and batch.mel.shape == (2, 80, 80)
    direct.state, metrics = direct.train_step(direct.state, batch, direct.generator)
    assert_same_state(fitted, direct)
    (line,) = records(fitted)
    assert all(line[f"train/{k}"] == v.item() for k, v in metrics.items())

    l1, stoi, estoi, pesq = fitted.validate(fast=False, max_batches=1)
    assert np.isfinite([l1, stoi, estoi, pesq]).all() and l1 > 0
    assert set(records(fitted)[-1]) - {"step", "time"} == VAL_KEYS
    assert fitted._val_ds.source is fitted.train_ds.source
    val_raw = next(fitted._val_ds.epoch(2, shuffle=False, drop_last=False))
    assert val_raw["video_raw"].shape[1] == 40  # the 40-frame bucket, short clips padded

    # a round trip: ``direct`` steps on, then takes ``fitted``'s checkpoint back
    path = fitted.ckpt.save(fitted.state, 0, stoi=stoi, estoi=estoi, pesq=pesq,
                            generator=fitted.generator)
    direct.state, _ = direct.train_step(direct.state, batch, direct.generator)
    direct.ckpt.restore(direct.state, path, generator=direct.generator)
    assert_same_state(direct, fitted)
    assert torch.equal(direct.generator.get_state(), fitted.generator.get_state())


@pytest.mark.parametrize("argv", [
    [],
    ["--data", "/data/LRS3", "--data_name", "LRS3", "--batch_size", "8", "--epochs", "3",
     "--eval_step", "100", "--lr", "3e-4", "--seed", "5", "--f_min", "40", "--f_max", "8000"],
    ["--window_size", "40", "--max_timesteps", "120", "--temp", "0.5", "--dataparallel",
     "--gpu", "0", "--workers", "2", "--start_epoch", "4", "--log_dir", "runs/x", "--bf16"],
    ["--checkpoint", "ck", "--checkpoint_dir", "cd", "--max_steps", "9", "--media_every", "0",
     "--synthetic", "--platform", "cpu", "--weight_decay", "0.0", "--augmentations", ""],
])
def test_train_lrs_parse_args_and_config_equal_the_jax_clis(argv):
    got, want = cli_lrs.parse_args(argv), jax_cli_lrs.parse_args(argv)
    assert vars(got) == vars(want)
    cfg, jcfg = cli_lrs.build_config(got), jax_cli_lrs.build_config(want)
    for part in ("audio", "data", "train", "model", "mesh"):
        mine, theirs = getattr(cfg, part), getattr(jcfg, part)
        for field in mine.__dataclass_fields__:
            assert getattr(mine, field) == getattr(theirs, field), f"{part}.{field}"


def test_train_lrs_refuses_model_parallel(capsys):
    """Ported since (the test keeps its name): ``--model_parallel 2`` parses
    into ``mesh.model_parallel`` as the JAX CLI's, for a world of 2 x N
    ranks under ``torchrun``."""
    args = cli_lrs.parse_args(["--model_parallel", "2"])
    assert vars(args) == vars(jax_cli_lrs.parse_args(["--model_parallel", "2"]))
    assert cli_lrs.build_config(args).mesh.model_parallel == 2
    assert capsys.readouterr().err == ""


def test_train_lrs_main_trains_bf16_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``main`` at the small size in bf16; without ``--platform cpu`` it
    needs CUDA and raises where there is none."""
    narrow = {k: v for k, v in LRS_SMALL.items()
              if k.startswith("model.") or k == "data.synthetic_clips"}
    monkeypatch.setattr(cli_lrs, "lrs_config",
                        lambda dataset, **kw: lrs_config(dataset, **{**kw, **narrow}))
    log_dir = tmp_path / "log"
    argv = ["--data", "/nonexistent", "--batch_size", "2", "--window_size", "20",
            "--max_timesteps", "40", "--epochs", "1", "--max_steps", "1", "--workers", "1",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(log_dir), "--bf16"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_lrs.main(argv)
    cli_lrs.main(argv + ["--platform", "cpu"])
    out = capsys.readouterr().out
    assert "pre-train validate: l1=" in out and "Finishing training" in out
    with open(log_dir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert sum("train/gen_loss" in r for r in lines) == 1
    assert sum("val/stoi" in r for r in lines) == 1
