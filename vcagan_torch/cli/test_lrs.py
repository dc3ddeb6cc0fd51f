"""LRS2/LRS3 inference, metrics and artifact dump CLI, argv-compatible with
the reference test_LRS.py and with ``python -m vcagan.cli.test_lrs``.

    python -m vcagan_torch.cli.test_lrs --data <LRS_root> --data_name LRS2 --checkpoint <dir>

Flip-TTA inference on length-sorted buckets, the LRS spec chain inverted,
Griffin-Lim on the bucket with each clip's frames past its ``mel_len``
silenced, STOI/ESTOI on the device and PESQ on the host at each clip's own
length, and the dump of ``<out_dir>/<data_name>/{mel,wav}/<name>`` (the
clip's name with ``/`` as ``_``; each wav trimmed to its length) and
``metric.txt`` (reference: test_LRS.py:60-188).  Runs on CUDA;
``--platform cpu`` runs on the CPU.  Without the split and crop tables
under ``./data/<data_name>`` it runs on ``--synthetic_clips`` synthetic
clips and warns.  ``--time_breakdown`` prints one JSON line of wall
seconds: the vocoding (from the queued forward to the waveforms on the
host), STOI/ESTOI, PESQ, the dump and the rest.  ``--model_parallel`` is
parsed and has no effect, as in the JAX CLI (``vcagan/cli/test_lrs.py:56``):
the evaluation runs on one device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from vcagan_torch.cli.test import (
    load_modules, score, write_clip, write_metrics)
from vcagan_torch.cli.train_lrs import build_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="Data_dir")
    p.add_argument("--data_name", type=str, default="LRS2")
    p.add_argument("--checkpoint_dir", type=str, default="./data/checkpoints/LRS")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--weight_decay", type=float, default=0.00001)
    p.add_argument("--workers", type=int, default=3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--augmentations", default=False)
    p.add_argument("--window_size", type=int, default=50)
    p.add_argument("--max_timesteps", type=int, default=160)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--f_min", type=float, default=55.0)
    p.add_argument("--f_max", type=float, default=7600.0)
    p.add_argument("--dataparallel", default=False, action="store_true")
    p.add_argument("--gpu", type=str, default="0")
    p.add_argument("--eval_step", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--out_dir", type=str, default="./test")
    p.add_argument("--synthetic", action="store_true",
                   help="accepted for the JAX CLI's argv; the synthetic clips are "
                        "used whenever the corpus is absent")
    p.add_argument("--platform", type=str, default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs on the CPU; otherwise CUDA, which must be present")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--synthetic_clips", type=int, default=4,
                   help="clips of the synthetic source, when the corpus is absent")
    p.add_argument("--no_sort_by_length", action="store_true",
                   help="batch in the split's order, not by length (sorted, each "
                        "batch runs at the smallest bucket that fits it)")
    p.add_argument("--time_breakdown", action="store_true",
                   help="print a JSON line of wall seconds by part at the end")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the generator side (parameters and the "
                        "Griffin-Lim vocoder stay fp32)")
    return p


def parse_args(argv=None):
    """The JAX CLI's argv (each of its settings runs)."""
    return build_parser().parse_args(argv)


def vocode_lrs(pipe, gs: torch.Tensor, wav, mel_len: torch.Tensor, hop: int,
               generator: Optional[torch.Generator] = None,
               init_phase: Optional[torch.Tensor] = None):
    """A bucket's normalised postnet spectrogram (B, 321, T) denormalised,
    the frames at or past each clip's ``mel_len`` set to 0 so that they add
    no energy to the batched Griffin-Lim, and vocoded; both waveforms, the
    prediction and the ground truth ``wav`` trimmed to its length, zeroed
    past each clip's n_wav = min(mel_len * hop, L) samples (reference
    test_LRS.py:160-165 vocodes ``gs[b, :, :, :mel_len[b]]`` one clip at a
    time).  ``init_phase`` replaces the phase drawn from ``generator``.
    Returns (wav_pred, wav_gt, n_wav) on gs's device."""
    from vcagan_torch.data.lrs import lrs_denormalize_spec

    spec = lrs_denormalize_spec(gs.float().transpose(1, 2))
    mel_len = mel_len.to(spec.device).long()
    frame_ok = torch.arange(spec.shape[1], device=spec.device)[None, :] < mel_len[:, None]
    spec = torch.where(frame_ok[:, :, None], spec, 0.0)
    wav_pred = pipe.inverse_spec(spec, init_phase=init_phase, generator=generator)
    length = wav_pred.shape[1]
    wav_gt = torch.as_tensor(wav, device=spec.device)[:, :length]
    n_wav = torch.clamp(mel_len * hop, max=length)
    ok = torch.arange(length, device=spec.device)[None, :] < n_wav[:, None]
    return torch.where(ok, wav_pred, 0.0), torch.where(ok, wav_gt, 0.0), n_wav


def main(argv=None):
    from vcagan_torch.data.lrs import make_lrs_dataset, make_lrs_device_pipeline
    from vcagan_torch.data.prefetch import prefetch_iterator
    from vcagan_torch.dsp.pipeline import MelPipeline
    from vcagan_torch.runtime import resolve_device
    from vcagan_torch.train.step import make_eval_step

    args = parse_args(argv)
    cfg = build_config(args)
    device = resolve_device(args.platform)
    modules = load_modules(cfg, args, device)
    eval_step = make_eval_step(modules, flip_tta=True)
    process = make_lrs_device_pipeline(cfg.audio, augment=False, device=device)
    pipe = MelPipeline(cfg.audio)
    data = dataclasses.replace(cfg.data, synthetic_clips=args.synthetic_clips)
    ds = make_lrs_dataset(data, cfg.audio, "test", seed=0)
    generator = torch.Generator(device).manual_seed(args.seed)

    stois, estois, pesqs = [], [], []
    times = {"vocode_sync_s": 0.0, "stoi_estoi_s": 0.0, "pesq_s": 0.0, "dump_s": 0.0}
    t_wall0 = time.perf_counter()
    out_base = os.path.join(args.out_dir, args.data_name)
    os.makedirs(out_base, exist_ok=True)
    hop = cfg.audio.hop_length
    bs = args.batch_size
    # decode and collate overlap the device's work and the host's scoring
    epoch = prefetch_iterator(ds.epoch(bs, shuffle=False, drop_last=False,
                                       sort_by_length=not args.no_sort_by_length), depth=2)
    with contextlib.closing(epoch):
        for i, raw in enumerate(epoch):
            if args.max_batches is not None and i >= args.max_batches:
                break
            nv = int(raw.get("n_valid", bs))
            batch = process(raw)
            g3, gs = eval_step(batch.video, batch.vid_len, generator)
            t0 = time.perf_counter()
            wav_pred, wav_gt, n_wav = vocode_lrs(pipe, gs, raw["wav"], batch.mel_len, hop,
                                                 generator)
            wavs = wav_pred.cpu().numpy()  # the sync: forward, Griffin-Lim, copy
            times["vocode_sync_s"] += time.perf_counter() - t0
            for out, part in zip((stois, estois, pesqs),
                                 score(wav_gt, wav_pred, nv, lengths=n_wav, times=times)):
                out.append(part)

            t0 = time.perf_counter()
            # saved in fp32 also under --bf16: numpy keeps a bfloat16 array only as
            # raw 2-byte records, which the ASR loaders cannot read
            mel, spec = g3.float().cpu().numpy(), gs.float().cpu().numpy()
            n_wav = n_wav.cpu().numpy()
            for b in range(nv):
                rel = ds.source.name(int(raw["idx"][b])).replace("/", "_")
                write_clip(os.path.join(out_base, "mel"), os.path.join(out_base, "wav"), rel,
                           mel[b], spec[b], int(raw["mel_len"][b]), wavs[b, : int(n_wav[b])])
            times["dump_s"] += time.perf_counter() - t0

    if args.time_breakdown:
        wall = time.perf_counter() - t_wall0
        clips = int(sum(len(s) for s in stois))
        print(json.dumps({"clips": clips, "wall_s": wall, "clips_per_s": clips / max(wall, 1e-9),
                          **times, "other_s": wall - sum(times.values())}))
    write_metrics(os.path.join(out_base, "metric.txt"), stois, estois, pesqs)


if __name__ == "__main__":
    main()
