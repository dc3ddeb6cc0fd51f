"""GRID inference, metrics and artifact dump CLI, argv-compatible with the
reference test.py (reference: test.py:25-53) and with ``python -m
vcagan.cli.test``.

    python -m vcagan_torch.cli.test --grid <GRID_root> --checkpoint <ckpt_dir> ...

Flip-TTA inference, Griffin-Lim, STOI/ESTOI on the device and PESQ on the
host, and the dump of ``<out_dir>/spec_mel/<sub>/<file>.npz`` (``mel`` (1,
80, n) and ``spec`` (1, 321, n)), ``<out_dir>/wav/<sub>/<file>.wav`` and
``metric.txt`` (reference: test.py:131-170).  Runs on CUDA; ``--platform
cpu`` runs on the CPU (plain versions of the kernels).  ``--checkpoint`` is
one of the port's checkpoint directories or a JAX package's train state
exported to ``.npz`` by ``tools/export_jax_train_state.py`` (its generator
side is used; an orbax directory is refused with the exporter's command);
without one the weights are the random init of ``--seed``.
Without the corpus under ``--grid`` it runs on ``data.synthetic_clips``
synthetic clips and warns.  The noise and the Griffin-Lim phase come from
one generator on the device seeded by ``--seed``.  ``--dataparallel``,
``--gpu``, ``--synthetic`` and the training flags are accepted and do
nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from vcagan_torch.configs import grid_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="Data_dir")
    p.add_argument("--checkpoint_dir", type=str, default="./data/checkpoints/GRID")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--weight_decay", type=float, default=0.00001)
    p.add_argument("--workers", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--subject", type=str, default="overlap")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--augmentations", default=True)
    p.add_argument("--window_size", type=int, default=40)
    p.add_argument("--max_timesteps", type=int, default=75)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--dataparallel", default=False, action="store_true")
    p.add_argument("--gpu", type=str, default="0,1")
    p.add_argument("--save_mel", default=False, action="store_true")
    p.add_argument("--save_wav", default=False, action="store_true")
    p.add_argument("--out_dir", type=str, default="./test")
    p.add_argument("--synthetic", action="store_true",
                   help="accepted for the JAX CLI's argv; the synthetic clips are "
                        "used whenever the corpus is absent")
    p.add_argument("--platform", type=str, default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs on the CPU; otherwise CUDA, which must be present")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the generator side (parameters and the "
                        "Griffin-Lim vocoder stay fp32)")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def build_config(args):
    return grid_config(
        **{
            "data.data_root": args.grid,
            "data.subject": args.subject,
            "data.window_size": args.window_size,
            "data.max_v_timesteps": args.max_timesteps,
            "data.augmentations": False,
            "model.sync_temp": args.temp,
            "model.use_bfloat16": args.bf16,
        }
    )


def load_modules(cfg, args, device):
    """The seven modules, initialised from ``--seed``, on ``device``, with
    ``--checkpoint``'s weights where one is given (a port checkpoint or an
    exported JAX train state; an orbax directory raises before anything is
    built)."""
    from vcagan_torch.io.jax_state import is_orbax, orbax_refusal, restore_train_state
    from vcagan_torch.train.models import VCAGANModules
    from vcagan_torch.train.state import create_train_state

    if args.checkpoint is not None and is_orbax(args.checkpoint):
        raise orbax_refusal(args.checkpoint)
    modules = VCAGANModules.create(cfg.model, seed=args.seed)
    state, _, _ = create_train_state(modules, cfg.train, 1, device=device)
    if args.checkpoint is not None:
        restore_train_state(state, args.checkpoint)
    return modules


def vocode_grid(pipe, gs: torch.Tensor, wav, mel_len0: int,
                generator: Optional[torch.Generator] = None,
                init_phase: Optional[torch.Tensor] = None):
    """The whole batch's postnet spectrogram (B, 321, T) sliced to the FIRST
    clip's ``mel_len0`` frames and vocoded, as the reference does
    (test.py:143 vocodes ``gs[:, :, :, :mel_len[0]]``, unclamped); the
    ground-truth waveforms ``wav`` (B, L) trimmed to the prediction's
    length.  ``init_phase`` replaces the phase drawn from ``generator``.
    Returns (wav_pred, wav_gt), both (B, hop * (mel_len0 - 1)) on gs's
    device."""
    spec = gs.float().transpose(1, 2)[:, :mel_len0]
    wav_pred = pipe.inverse_spec(spec, init_phase=init_phase, generator=generator)
    wav_gt = torch.as_tensor(wav, device=wav_pred.device)[:, : wav_pred.shape[1]]
    return wav_pred, wav_gt


def score(wav_gt: torch.Tensor, wav_pred: torch.Tensor, n_valid: int,
          lengths: Optional[torch.Tensor] = None, times: Optional[dict] = None):
    """STOI and ESTOI on the waveforms' device, PESQ on the host, of the
    first ``n_valid`` clips; ``lengths``: each clip's samples.  ``times``
    gets the seconds of each (``stoi_estoi_s``, ``pesq_s``) added.  Returns
    three numpy arrays."""
    from vcagan_torch.eval.pesq_nb import pesq_batch
    from vcagan_torch.eval.stoi import stoi_estoi_batch

    t0 = time.perf_counter()
    s, e = stoi_estoi_batch(wav_gt, wav_pred, lengths=lengths)
    stoi, estoi = s.cpu().numpy()[:n_valid], e.cpu().numpy()[:n_valid]
    t1 = time.perf_counter()
    pesq = np.asarray(pesq_batch(wav_gt.cpu().numpy(), wav_pred.cpu().numpy(), fs=16_000))
    t2 = time.perf_counter()
    if times is not None:
        times["stoi_estoi_s"] = times.get("stoi_estoi_s", 0.0) + t1 - t0
        times["pesq_s"] = times.get("pesq_s", 0.0) + t2 - t1
    return stoi, estoi, pesq[:n_valid]


def write_clip(mel_dir: str, wav_dir: str, fname: str, mel: np.ndarray, spec: np.ndarray,
               n_mel: int, wav: np.ndarray) -> None:
    """``<mel_dir>/<fname>.npz`` with ``mel`` (1, 80, n_mel) and ``spec``
    (1, 321, n_mel) of one clip's (80, T) and (321, T) outputs, and
    ``<wav_dir>/<fname>.wav``."""
    from vcagan_torch.io.wav import write_wav

    os.makedirs(mel_dir, exist_ok=True)
    os.makedirs(wav_dir, exist_ok=True)
    np.savez(os.path.join(mel_dir, f"{fname}.npz"), mel=mel[None, :, :n_mel],
             spec=spec[None, :, :n_mel])
    write_wav(os.path.join(wav_dir, f"{fname}.wav"), wav)


def write_metrics(path: str, stois, estois, pesqs) -> None:
    """Print the means and write ``metric.txt`` as the reference does (the
    three writes on one line)."""
    means = [float(np.nanmean(np.concatenate(x))) if x else 0.0 for x in (stois, estois, pesqs)]
    for name, m in zip(("STOI", "ESTOI", "PESQ"), means):
        print(f"{name}: ", m)
    with open(path, "w") as f:
        for name, m in zip(("STOI", "ESTOI", "PESQ"), means):
            f.write(f"{name} : {m}")


def clip_name(source, idx: int) -> tuple[str, str]:
    """(subject directory, file name) of clip ``idx``; ``synthetic`` and
    ``clip_<idx>`` for the synthetic clips."""
    name = source.name(idx) if hasattr(source, "name") else f"clip_{idx:05d}"
    parts = name.split("/")
    return (parts[0] if len(parts) > 1 else "synthetic"), parts[-1]


def main(argv=None):
    from vcagan_torch.data.device_pipeline import make_device_pipeline
    from vcagan_torch.data.grid import make_grid_dataset
    from vcagan_torch.data.prefetch import prefetch_iterator
    from vcagan_torch.dsp.pipeline import MelPipeline
    from vcagan_torch.runtime import resolve_device
    from vcagan_torch.train.step import make_eval_step

    args = parse_args(argv)
    cfg = build_config(args)
    device = resolve_device(args.platform)
    modules = load_modules(cfg, args, device)
    eval_step = make_eval_step(modules, flip_tta=True)
    process = make_device_pipeline(cfg.audio, cfg.data, augment=False, device=device)
    pipe = MelPipeline(cfg.audio)
    ds = make_grid_dataset(cfg.data, cfg.audio, "test", seed=0)
    generator = torch.Generator(device).manual_seed(args.seed)

    stois, estois, pesqs = [], [], []
    os.makedirs(args.out_dir, exist_ok=True)
    bs = args.batch_size
    # decode and collate overlap the device's work and the host's scoring
    epoch = prefetch_iterator(ds.epoch(bs, shuffle=False, drop_last=False), depth=2)
    with contextlib.closing(epoch):
        for i, raw in enumerate(epoch):
            if args.max_batches is not None and i >= args.max_batches:
                break
            nv = int(raw.get("n_valid", bs))
            batch = process(raw)
            g3, gs = eval_step(batch.video, batch.vid_len, generator)
            wav_pred, wav_gt = vocode_grid(pipe, gs, raw["wav"], int(raw["mel_len"][0]),
                                           generator)
            for out, part in zip((stois, estois, pesqs), score(wav_gt, wav_pred, nv)):
                out.append(part)

            # saved in fp32 also under --bf16: numpy keeps a bfloat16 array only as
            # raw 2-byte records, which the ASR loaders cannot read
            mel, spec = g3.float().cpu().numpy(), gs.float().cpu().numpy()
            wavs = wav_pred.cpu().numpy()
            for b in range(nv):
                sub, fname = clip_name(ds.source, i * bs + b)
                write_clip(os.path.join(args.out_dir, "spec_mel", sub),
                           os.path.join(args.out_dir, "wav", sub), fname, mel[b], spec[b],
                           int(raw["mel_len"][b]), wavs[b])
    write_metrics(os.path.join(args.out_dir, "metric.txt"), stois, estois, pesqs)


if __name__ == "__main__":
    main()
