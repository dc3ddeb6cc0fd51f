"""GRID adversarial training CLI, argv-compatible with the reference
train.py (reference: train.py:25-50) and with ``python -m vcagan.cli.train``.

    python -m vcagan_torch.cli.train --grid <GRID_root> --subject overlap ...
    torchrun --nproc_per_node 4 -m vcagan_torch.cli.train ...   # one rank a card
    torchrun --nproc_per_node 4 -m vcagan_torch.cli.train --model_parallel 2 ...

Under ``torchrun`` each rank trains on its data index's slice of the
global ``--batch_size`` on ``cuda:LOCAL_RANK`` (NCCL; gloo on the CPU with
``--platform cpu``, or where ``VCAGAN_DIST_BACKEND=gloo`` lets ranks share
a card); ``--model_parallel M`` makes M ranks a model group, which splits
the four attention projections by column (the world over M is the data
axis; M must divide the world).  Rank 0 validates, logs and checkpoints,
on the whole state.

Runs on CUDA; ``--platform cpu`` runs on the CPU (plain versions of the
kernels).  Without the corpus under ``--grid`` it trains on the synthetic
clips (``data.synthetic_clips``) and warns, naming the root.
``--checkpoint`` restores the train state and the run's generator from
one of the port's checkpoints, or the train state from a JAX package's
checkpoint exported to ``.npz`` by ``tools/export_jax_train_state.py``.
``--bf16`` computes the modules in bf16 (parameters and losses stay fp32).
``--collate_process`` collates in a worker process (``ProcessEpoch``).
``--remat`` (remat sites: none, r1, stem, vfront, comma-separated) and
``--d_phase`` (ref or batched) go to the train step; an unknown site
raises where the Trainer builds it, as in the JAX CLI.  ``--dataparallel``,
``--gpu`` and ``--synthetic`` are accepted and do nothing, as in the JAX
CLI (the ranks come from ``torchrun``).
"""

from __future__ import annotations

import argparse

from vcagan_torch.configs import grid_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="Data_dir")
    p.add_argument("--checkpoint_dir", type=str, default="./data/checkpoints/GRID")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=88)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--weight_decay", type=float, default=0.00001)
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--subject", type=str, default="overlap",
                   help="overlap | unseen | s1 | s2 | s4 | s29 | four")
    p.add_argument("--eval_step", type=int, default=720)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--augmentations", default=True)
    p.add_argument("--window_size", type=int, default=40)
    p.add_argument("--max_timesteps", type=int, default=75)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--dataparallel", default=False, action="store_true")
    p.add_argument("--gpu", type=str, default="0,1,2,3")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--log_dir", type=str, default="./runs/grid")
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
    p.add_argument("--remat", type=str, default="none",
                   help="selective remat sites (none|r1|stem|vfront, comma-separable)")
    p.add_argument("--d_phase", type=str, default="ref", choices=("ref", "batched"),
                   help="D-phase program structure (ref|batched), math-identical; "
                        "batched = one 2B real+fake forward per scale + joint R1")
    p.add_argument("--collate_process", action="store_true",
                   help="decode and collate in a forked worker process (shared-memory "
                        "batches) instead of a producer thread")
    return p


def parse_args(argv=None):
    """The JAX CLI's argv."""
    return build_parser().parse_args(argv)


def build_config(args):
    return grid_config(
        **{
            "data.data_root": args.grid,
            "data.subject": args.subject,
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
            "train.remat": args.remat,
            "train.d_phase": args.d_phase,
            "data.collate_process": args.collate_process,
            "mesh.model_parallel": args.model_parallel,
        }
    )


def run(args, cfg) -> None:
    """The training run of both training CLIs: join the process group when
    started by ``torchrun`` (``initialize_distributed``: NCCL, or gloo with
    ``--platform cpu``), build the Trainer (each rank on its card), restore
    ``--checkpoint``, validate once on rank 0 and fit."""
    import torch.distributed as dist

    from vcagan_torch.parallel import initialize_distributed
    from vcagan_torch.train.loop import Trainer

    cpu = args.platform == "cpu"
    initialize_distributed(backend="gloo" if cpu else None)
    try:
        trainer = Trainer(cfg, log_dir=args.log_dir, device="cpu" if cpu else None)
        if args.checkpoint is not None:  # a port checkpoint, or an exported JAX train state
            from vcagan_torch.io.jax_state import restore_train_state

            with trainer.split.full(trainer.state):  # whole tensors in, this rank's columns kept
                restore_train_state(trainer.state, args.checkpoint, generator=trainer.generator)

        def smoke_validate():  # before training (reference train.py:121)
            logs = trainer.validate(fast=True, max_batches=1)
            print(f"pre-train validate: l1={logs[0]:.4f} stoi={logs[1]:.4f}")

        trainer.on_rank0(smoke_validate)
        trainer.fit(
            epochs=args.epochs,
            start_epoch=args.start_epoch,
            max_steps=args.max_steps,
            media_every=args.media_every,
        )
        print("Finishing training")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    run(args, build_config(args))


if __name__ == "__main__":
    main()
