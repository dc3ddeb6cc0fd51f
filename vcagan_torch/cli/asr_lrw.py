"""LRW word-accuracy CLI, argv-compatible with ``python -m
vcagan.cli.asr_lrw`` (counterpart of ASR_model/LRW/test.py).

    python -m vcagan_torch.cli.asr_lrw --data <root of class/split/*.npz> \\
        --class_list ./data/class.txt --checkpoint <ckpt>

``--checkpoint``: the reference torch checkpoint (``a_front_state_dict`` +
``a_back_state_dict``, loaded as they are), or an ``.npz`` holding
``variables``, an ``LRWClassifier`` flax tree (an orbax directory exported
with ``tools/export_jax_train_state.py --asr``); an orbax directory itself
is refused with that command; none: random init, the smoke mode.  Runs on CUDA; ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="./test/spec_mel")
    p.add_argument("--wav", default=False, action="store_true")
    p.add_argument("--class_list", default="./data/class.txt")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=120)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dataparallel", default=False, action="store_true")
    p.add_argument("--gpu", type=str, default="0")
    p.add_argument("--platform", type=str, default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs on the CPU; otherwise CUDA, which must be present")
    return p.parse_args(argv)


def main(argv=None):
    from vcagan_torch.eval.asr_lrw import evaluate, load_class_list
    from vcagan_torch.eval.asr_models import load_asr

    args = parse_args(argv)
    classes = load_class_list(args.class_list)
    model = load_asr("lrw", args.checkpoint, num_classes=len(classes), device=args.platform)
    acc, wer = evaluate(args.data, classes, model, wav=args.wav, batch_size=args.batch_size)
    print("test_ACC:", acc, "WER:", wer)


if __name__ == "__main__":
    main()
