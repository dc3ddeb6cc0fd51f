"""GRID ASR content-accuracy CLI, argv-compatible with ``python -m
vcagan.cli.asr_grid`` (counterpart of ASR_model/GRID/test.py).

    python -m vcagan_torch.cli.asr_grid --data ./test/spec_mel --gtpath <GRID_root> \\
        --checkpoint <variables.npz>

``--checkpoint``: an ``.npz`` holding ``variables``, a ``GridASR`` flax tree
(the JAX CLI's format; a reference torch checkpoint converted with
``tools/convert_torch_ckpt.py``, or an orbax directory exported with
``tools/export_jax_train_state.py --asr``); an orbax directory itself is
refused with that command; none: random init, the smoke mode.  Runs on
CUDA; ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="./test/spec_mel")
    p.add_argument("--wav", default=False, action="store_true")
    p.add_argument("--gtpath", default="GT_path")
    p.add_argument("--model", default="GRID_CTC")
    p.add_argument("--checkpoint_dir", type=str, default="./data")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=160)
    p.add_argument("--subject", default="overlap")
    p.add_argument("--max_timesteps", type=int, default=75)
    p.add_argument("--max_text_len", type=int, default=75)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dataparallel", default=False, action="store_true")
    p.add_argument("--gpu", type=str, default="0")
    p.add_argument("--platform", type=str, default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs on the CPU; otherwise CUDA, which must be present")
    return p.parse_args(argv)


def main(argv=None):
    from vcagan_torch.eval.asr_grid import evaluate
    from vcagan_torch.eval.asr_models import load_asr

    args = parse_args(argv)
    model = load_asr("grid", args.checkpoint, device=args.platform)
    wer, cer = evaluate(args.data, args.gtpath, model, wav=args.wav,
                        batch_size=args.batch_size, max_timesteps=args.max_timesteps)
    print("test_cer:", cer)
    print("test_wer:", wer)


if __name__ == "__main__":
    main()
