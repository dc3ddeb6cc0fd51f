"""LRS2/LRS3 adversarial training CLI, argv-compatible with the reference
train_LRS.py (reference: train_LRS.py:27-53) and with ``python -m
vcagan.cli.train_lrs``.

    python -m vcagan_torch.cli.train_lrs --data <LRS_root> --data_name LRS2 ...
    torchrun --nproc_per_node 4 -m vcagan_torch.cli.train_lrs ...   # one rank a card

The recipe is ``lrs_config``'s: batch 16, 200 epochs, 50-frame windows, up
to 160 frames, plain Adam, milestones (100, 150), sync D-loss weight 0.5,
L1 on normalised mels, f_max 7600, validation once an epoch.  Runs on
CUDA; ``--platform cpu`` runs on the CPU (plain versions of the kernels).
Without the corpus's split and crop tables under ``./data/<data_name>`` it
trains on ``data.synthetic_clips`` synthetic clips and warns, naming the
root.  ``--bf16`` computes the modules in bf16 (parameters and losses stay
fp32).  ``--model_parallel M`` splits the four attention projections by
column over M ranks of the ``torchrun`` world (``cli.train``).
``--dataparallel``, ``--gpu`` and ``--synthetic``
are accepted and do nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse

from vcagan_torch.cli.train import run
from vcagan_torch.configs import lrs_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="Data_dir")
    p.add_argument("--data_name", type=str, default="LRS2", help="LRS2 | LRS3")
    p.add_argument("--checkpoint_dir", type=str, default="./data/checkpoints/LRS")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--weight_decay", type=float, default=0.00001)
    p.add_argument("--workers", type=int, default=3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--eval_step", type=int, default=0, help="0 = per-epoch")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--augmentations", default=True)
    p.add_argument("--window_size", type=int, default=50)
    p.add_argument("--max_timesteps", type=int, default=160)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--f_min", type=float, default=55.0)
    p.add_argument("--f_max", type=float, default=7600.0)
    p.add_argument("--dataparallel", default=False, action="store_true")
    p.add_argument("--gpu", type=str, default="0,1,2,3")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--log_dir", type=str, default="./runs/lrs")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--media_every", type=int, default=100)
    p.add_argument("--synthetic", action="store_true",
                   help="accepted for the JAX CLI's argv; the synthetic clips are "
                        "used whenever the corpus is absent")
    p.add_argument("--platform", type=str, default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs on the CPU; otherwise CUDA, which must be present")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the convolution-heavy modules "
                        "(parameters and losses stay fp32)")
    return p


def parse_args(argv=None):
    """The JAX CLI's argv (each of its settings runs)."""
    return build_parser().parse_args(argv)


def build_config(args):
    return lrs_config(
        args.data_name,
        **{
            "audio.f_min": args.f_min,
            "audio.f_max": args.f_max,
            "data.data_root": args.data,
            "data.dataset": args.data_name,
            "data.window_size": args.window_size,
            "data.max_v_timesteps": args.max_timesteps,
            "data.augmentations": bool(args.augmentations),
            "train.batch_size": args.batch_size,
            "train.epochs": args.epochs,
            "train.lr": args.lr,
            "train.weight_decay": args.weight_decay,
            "train.seed": args.seed,
            "train.eval_step": args.eval_step,
            "train.start_epoch": args.start_epoch,
            "train.workers": args.workers,
            "train.checkpoint_dir": args.checkpoint_dir,
            "model.sync_temp": args.temp,
            "model.use_bfloat16": args.bf16,
            "mesh.model_parallel": args.model_parallel,
        },
    )


def main(argv=None):
    args = parse_args(argv)
    run(args, build_config(args))


if __name__ == "__main__":
    main()
