"""GRID and LRS training and validation: the loop of ``python -m
vcagan_torch.cli.train`` and ``python -m vcagan_torch.cli.train_lrs``.

Port of ``vcagan/train/loop.py:31-490`` (reference: train.py:124-468,
train_LRS.py:140-320): a
producer thread feeds collated host batches, the input pipeline turns them
into a ``Batch`` on the device, the GAN step updates the state in place;
every ``eval_step`` steps (or once an epoch) a validation vocodes with
Griffin-Lim, scores STOI/ESTOI on the device and PESQ on the host, and a
checkpoint is saved under the metric-named, best-by-STOI convention.

One ``torch.Generator`` on the device, seeded from ``train.seed``, draws
for the input pipeline and then for the step, batch after batch.

LRS2/LRS3 (``data.dataset``): variable-length clips with dynamic lip crops
(``vcagan_torch/data/lrs.py``), the LRS spec chain, and a validation that
vocodes each bucket at its static length with the frames past each clip's
``mel_len`` silenced, then scores every clip at its own length.  Without
the corpus the loop runs on ``data.synthetic_clips`` synthetic clips.

``data.collate_process`` feeds from a forked collate worker process
(``ProcessEpoch``) instead of the producer thread (``ParallelEpoch``).

Data and model parallel (``layout``, ``vcagan_torch.parallel``; the JAX
Trainer's mesh and multi-host feed, ``vcagan/train/loop.py:66-79,
169-235``): one process a device, each feeding its data index's slice of
the global batch (``train.batch_size``, which also sets ``steps_per_epoch``
and so the learning-rate schedule) to a step that reduces over the data
group.  With ``mesh.model_parallel`` > 1 each rank keeps only its columns
of the four split attention projections (``ModelSplit``, cut after the
seeded init); the rest of the state is replicated.  Validation,
checkpoints, the metric stream and the media run on rank 0 alone, on the
whole state: every rank first gathers the split leaves (``on_rank0``),
then the others wait at the broadcast of rank 0's generator state that
follows, which keeps every rank's generator where one process's would be.

``train.remat`` and ``train.d_phase`` go to ``make_train_step`` under
every layout; ``rebuild_train_step`` builds the step again with other
knobs.  The JAX Trainer's retry of a step compiled without its TPU
options (``_call_train_step``, which catches the TPU compile helper's
failure) has nothing to port: no step here is compiled.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from vcagan_torch import tracing
from vcagan_torch.configs import VCAGANConfig
from vcagan_torch.data.device_pipeline import make_device_pipeline
from vcagan_torch.data.grid import make_grid_dataset
from vcagan_torch.data.lrs import (
    SyntheticLRSSource, lrs_denormalize_spec, make_lrs_dataset, make_lrs_device_pipeline)
from vcagan_torch.data.synthetic import SyntheticLipSpeech
from vcagan_torch.data.prefetch import ParallelEpoch, ProcessEpoch
from vcagan_torch.dsp.griffin_lim import random_phase
from vcagan_torch.dsp.pipeline import MelPipeline
from vcagan_torch.eval.pesq_nb import pesq_batch
from vcagan_torch.eval.stoi import stoi_estoi_batch
from vcagan_torch.io.checkpoint import CheckpointManager
from vcagan_torch.io.metrics import MetricWriter
from vcagan_torch.parallel.mesh import DataLayout, make_layout
from vcagan_torch.parallel.shard import ModelSplit
from vcagan_torch.train.models import VCAGANModules
from vcagan_torch.train.state import create_train_state
from vcagan_torch.train.step import make_eval_step, make_train_step


class Trainer:
    """``layout``: the process layout (``make_layout``'s by default, with
    ``mesh.model_parallel`` ranks a model group: the process group's ranks
    where one is initialised, else one process on ``device``).
    ``split``: this rank's share of the split leaves.  ``writer`` and
    ``ckpt`` are None on the ranks past 0."""

    def __init__(self, config: VCAGANConfig, log_dir: str = "./runs", device=None,
                 layout: Optional[DataLayout] = None):
        self.config = config
        tc = config.train
        self.layout = layout or make_layout(config.mesh.model_parallel, tc.batch_size, device)
        self.device = self.layout.device
        self.is_main = self.layout.rank == 0
        self.modules = VCAGANModules.create(config.model, seed=tc.seed)
        self.split = ModelSplit(self.modules, self.layout)
        self.split.split_()
        self.pipeline = MelPipeline(config.audio)
        self.writer = MetricWriter(log_dir) if self.is_main else None
        self.ckpt = CheckpointManager(tc.checkpoint_dir) if self.is_main else None
        self.is_lrs = config.data.dataset in ("LRS2", "LRS3")

        self.train_ds = self._make_dataset("train", seed=tc.seed)
        self.steps_per_epoch = max(len(self.train_ds) // tc.batch_size, 1)
        self.state, self.g_tx, self.d_tx = create_train_state(
            self.modules, tc, self.steps_per_epoch, device=self.device)
        if self.is_lrs:
            self.process_train = make_lrs_device_pipeline(
                config.audio, augment=config.data.augmentations, device=self.device)
            self.process_eval = make_lrs_device_pipeline(config.audio, augment=False,
                                                         device=self.device)
        else:
            self.process_train = make_device_pipeline(
                config.audio, config.data, augment=config.data.augmentations,
                device=self.device)
            self.process_eval = make_device_pipeline(
                config.audio, config.data, augment=False, device=self.device)
        self.mesh = self.layout if self.layout.group is not None else None
        self._step_kwargs = dict(remat=tc.remat, d_phase=tc.d_phase)
        self.train_step = make_train_step(self.modules, self.g_tx, self.d_tx, tc,
                                          mesh=self.mesh, **self._step_kwargs)
        self.eval_step = make_eval_step(self.modules)
        self.generator = torch.Generator(self.device).manual_seed(tc.seed)
        # built once and reused by every validation (a dataset per call
        # would leave a decode pool behind each time)
        self._val_ds = None
        # per step of the last fit: seconds the loop waited on the feed
        # queue, and the producer's seconds to collate each batch
        self.queue_wait_s: list[float] = []
        self.collate_s: list[float] = []
        self.last_profile = None

    # --------------------------------------------------------------- datasets

    def on_rank0(self, work) -> None:
        """``work()`` on rank 0 alone, on the whole state (every rank
        gathers the split leaves first, ``ModelSplit.full``: a collective
        inside work that rank 0 runs alone would hang); then every rank
        takes rank 0's generator state (a broadcast, which holds the other
        ranks until rank 0 is done), so the ranks draw on as one process
        would."""
        with self.split.full(self.state):
            if self.is_main:
                work()
        if self.layout.group is not None:
            state = self.generator.get_state().to(self.device)
            torch.distributed.broadcast(state, src=0, group=self.layout.group)
            self.generator.set_state(state.cpu())

    def rebuild_train_step(self, **overrides) -> None:
        """Build the step again with changed ``make_train_step`` keywords
        (e.g. a remat recipe the config did not carry); they stay for later
        rebuilds (``vcagan/train/loop.py:262-269``)."""
        self._step_kwargs.update(overrides)
        self.train_step = make_train_step(self.modules, self.g_tx, self.d_tx, self.config.train,
                                          mesh=self.mesh, **self._step_kwargs)

    def _make_dataset(self, mode: str, seed: int = 0):
        cfg = self.config
        # decode pool: the full count for training, 2 for validation
        # (reference train.py:139-146 / 337-353); the synthetic clips where
        # the corpus is absent
        workers = cfg.train.workers if mode == "train" else min(cfg.train.workers, 2)
        make = make_lrs_dataset if self.is_lrs else make_grid_dataset
        ds = make(cfg.data, cfg.audio, mode, seed=seed, workers=workers)
        synthetic = (SyntheticLRSSource, SyntheticLipSpeech)
        if (mode == "val" and isinstance(ds.source, synthetic)
                and type(ds.source) is type(self.train_ds.source)):
            # both splits fell back to the same synthetic clips: render each
            # once for both
            ds.source = self.train_ds.source
        return ds

    # ------------------------------------------------------------------ train

    def fit(
        self,
        epochs: Optional[int] = None,
        start_epoch: int = 0,
        max_steps: Optional[int] = None,
        media_every: int = 0,
        profile_steps: Optional[tuple] = None,
        profile_dir: str = "./runs/profile",
    ) -> int:
        """Train; returns the step count.  ``eval_step > 0`` validates and
        checkpoints every N steps (GRID recipe, reference train.py:280);
        ``eval_step == 0`` once an epoch (LRS recipe, train_LRS.py:275-311).

        ``profile_steps=(start, stop)`` traces the steps after ``start`` up
        to ``stop`` with ``torch.profiler`` (host and device), writes the
        trace to ``profile_dir`` and keeps the profile in
        ``last_profile``.  Tracing (``vcagan_torch.tracing``) is on for that
        stretch, its ranges only (no device events), so the trace holds the
        loop's spans ``vcagan.feed.wait``, ``vcagan.input_pipeline``,
        ``vcagan.train_step`` and ``vcagan.readback`` and, inside them, the
        input pipeline's and the step's (``train.input``, ``train.step`` and
        its parts).

        Under a layout of several ranks each feeds its slice of every
        global batch, and only rank 0 logs, validates and checkpoints."""
        tc = self.config.train
        epochs = epochs if epochs is not None else tc.epochs
        step = self.state.step
        step_t0 = time.time()
        self.queue_wait_s, self.collate_s = [], []
        prof = None
        stretch = contextlib.ExitStack()  # tracing's ranges over the profiled steps

        # Step N's metrics leave the device in one stacked copy queued right
        # behind step N and are read after step N + 1 is queued: the wait is
        # for step N only, while step N + 1 keeps the device busy.  (A copy
        # queued at the read would sit behind step N + 1 on the stream.)
        pending = None

        def queue_readback(pstep, metrics):
            keys = list(metrics)
            stacked = torch.stack([metrics[k] for k in keys])
            if self.device.type != "cuda":
                return pstep, keys, stacked, None
            host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return pstep, keys, host, done

        def flush():
            nonlocal pending, step_t0
            if pending is None:
                return
            pstep, keys, host_vals, done = pending
            pending = None
            with tracing.span("readback"):
                if done is not None:
                    done.synchronize()
                host = dict(zip(keys, host_vals.tolist()))
            # wall time since the previous logged step: the loop's pace
            host["step_seconds"] = time.time() - step_t0
            step_t0 = time.time()
            self.writer.scalars({f"train/{k}": v for k, v in host.items()}, pstep)

        def validate_and_save(epoch):
            logs = self.validate(fast=True)
            self.ckpt.save(self.state, epoch, *logs[1:], generator=self.generator)

        process_slice = self.layout.batch_slice(tc.batch_size)
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                # the collate worker process where configured (as the JAX
                # Trainer, vcagan/train/loop.py:204-215), else the thread
                producer = ProcessEpoch if self.config.data.collate_process else ParallelEpoch
                feed = producer(self.train_ds, tc.batch_size, depth=2, device=self.device,
                                process_slice=process_slice)
                self.collate_s = feed.collate_s
                batches = iter(feed)
                while True:
                    if profile_steps and step == profile_steps[0]:
                        stretch.enter_context(tracing.enabled(device_events=False))
                        prof = torch.profiler.profile(activities=self._activities())
                        prof.start()
                    wait_t0 = time.perf_counter()
                    with tracing.span("feed.wait"):
                        raw = next(batches, None)
                    if raw is None:
                        break
                    self.queue_wait_s.append(time.perf_counter() - wait_t0)
                    with tracing.span("input_pipeline"), self.layout.active():
                        batch = self.process_train(raw, self.generator)
                    with tracing.span("train_step"):
                        self.state, metrics = self.train_step(self.state, batch, self.generator)
                    step += 1
                    flush()  # read back step - 1's metrics while this step runs
                    pending = queue_readback(step, metrics) if self.is_main else None
                    if prof is not None and step == profile_steps[1]:
                        flush()
                        self._stop_profile(prof, profile_dir)
                        stretch.close()
                        prof = None
                    if media_every and step % media_every == 0:
                        self.on_rank0(lambda: self._log_train_media(batch, step))
                    if tc.eval_step and step % tc.eval_step == 0:
                        flush()
                        self.on_rank0(lambda: validate_and_save(epoch))
                    if max_steps is not None and step >= max_steps:
                        flush()
                        batches.close()  # the producer has ended when fit returns
                        return step
                flush()
                if not tc.eval_step:  # per-epoch validation (LRS recipe)
                    self.on_rank0(lambda: validate_and_save(epoch))
                if self.is_main:
                    self.writer.scalars({"train/epoch_seconds": time.time() - t0}, step)
            return step
        finally:
            stretch.close()  # where the stretch did not reach its stop

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _stop_profile(self, prof, profile_dir: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        rank = f"_rank{self.layout.rank}" if self.layout.world > 1 else ""
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              f"trace_step{self.state.step}{rank}.json"))
        self.last_profile = prof

    def _log_train_media(self, batch, step: int) -> None:
        """Spectrogram images and Griffin-Lim audio of the batch's first
        clip (reference logs these every 100 steps, train.py:239-278).  The
        noise is drawn under the layout, at the global batch's shape."""
        with self.layout.active():
            g3, gs = (x.float() for x in self.eval_step(batch.video, batch.vid_len,
                                                        self.generator))
        self.writer.spectrogram("train_mel/g3", g3[0].cpu().numpy(), step)
        self.writer.spectrogram("train_mel/gt", batch.mel[0].cpu().numpy(), step)
        self.writer.spectrogram("train_spec/gen", gs[0].cpu().numpy(), step)
        spec = gs[:1].transpose(1, 2)
        if self.is_lrs:
            spec = lrs_denormalize_spec(spec)
        wav = self.pipeline.inverse_spec(spec, generator=self.generator)
        self.writer.audio("train_aud/pred_spec", wav[0].cpu().numpy(), step)

    # --------------------------------------------------------------- validate

    @torch.no_grad()
    def validate(self, fast: bool = False, max_batches: Optional[int] = None):
        """Returns (recon_l1, stoi, estoi, pesq) of the POSTNET path.

        As the reference's validate (train.py:331-468; for LRS the JAX
        Trainer's bucketed form, ``vcagan/train/loop.py:383-432``): the eval forward,
        Griffin-Lim on both paths, inverse_spec(gs) and inverse_mel(g3),
        from one initial phase, STOI/ESTOI and PESQ of each (the mel path's
        go to the metric stream as val/*_mel), figures and audio of the
        first batch; ``fast`` scores 5 batches, else ``max_batches`` or
        all; only the ``n_valid`` real clips of a padded batch count.  Rank
        0's work (``on_rank0``) under a layout of several ranks."""
        if not self.is_main:
            raise RuntimeError("validate runs on rank 0 (Trainer.on_rank0)")
        cfg = self.config
        if self._val_ds is None:
            self._val_ds = self._make_dataset("val", seed=0)
        val_ds = self._val_ds
        limit = 5 if fast else (max_batches or len(val_ds))
        bs = max(cfg.train.batch_size, 1)

        losses, stois, estois, pesqs = [], [], [], []
        stois_mel, estois_mel, pesqs_mel = [], [], []
        # the cached dataset's shuffle restarts each call, so every fast
        # validation scores the same clips and Best_* compares like with like
        val_ds.rng = np.random.default_rng(0)
        for i, raw in enumerate(val_ds.epoch(bs, shuffle=fast, drop_last=False)):
            if i >= limit:
                break
            nv = int(raw.get("n_valid", bs))
            batch = self.process_eval(raw)
            g3, gs = self.eval_step(batch.video, batch.vid_len, self.generator)
            g3, gs = g3.float(), gs.float()  # bf16 in bf16 training: vocoded in fp32
            losses.append((g3 - batch.mel).abs()[:nv].mean().item())
            if self.is_lrs:
                # the bucket's static length, frames past each clip's mel_len
                # silenced (spec 0, normalised mel -1), as the JAX Trainer
                # vocodes LRS (vcagan/train/loop.py:393-402)
                spec = lrs_denormalize_spec(gs.transpose(1, 2))
                frame_ok = (torch.arange(spec.shape[1], device=self.device)[None, :]
                            < batch.mel_len[:, None])[:, :, None]
                spec = torch.where(frame_ok, spec, 0.0)
                mel_in = torch.where(frame_ok, g3.transpose(1, 2), -1.0)
            else:
                # the valid frames, cut at the first clip's length as the
                # reference's g3[:, :, :, :mel_len[0]] (train.py:389-391); the
                # raw postnet output, unclamped (train.py:390)
                ml0 = int(np.asarray(raw["mel_len"])[0])
                spec = gs.transpose(1, 2)[:, :ml0]
                mel_in = g3.transpose(1, 2)[:, :ml0]
            phase = random_phase(spec.shape, self.generator, spec.device)
            wav_pred = self.pipeline.inverse_spec(spec, init_phase=phase)
            wav_mel = self.pipeline.inverse_mel(mel_in, init_phase=phase)
            wav_gt = torch.as_tensor(raw["wav"], device=self.device)[:, : wav_pred.shape[1]]
            wav_mel = wav_mel[:, : wav_gt.shape[1]]
            lens = None
            if self.is_lrs:
                # each clip scored at its own length, zeros past it
                # (vcagan/train/loop.py:418-432)
                lens = torch.clamp(batch.mel_len.long() * self.config.audio.hop_length,
                                   max=wav_pred.shape[1])
                ok = torch.arange(wav_pred.shape[1], device=self.device)[None, :] < lens[:, None]
                wav_pred, wav_mel, wav_gt = (torch.where(ok, x, 0.0)
                                             for x in (wav_pred, wav_mel, wav_gt))
            gt_host = wav_gt.cpu().numpy()
            for wav, s_out, e_out, p_out in ((wav_pred, stois, estois, pesqs),
                                             (wav_mel, stois_mel, estois_mel, pesqs_mel)):
                s_b, e_b = stoi_estoi_batch(wav_gt, wav, lengths=lens)
                s_out.append(s_b.cpu().numpy()[:nv])
                e_out.append(e_b.cpu().numpy()[:nv])
                p_out.append(np.asarray(pesq_batch(gt_host, wav.cpu().numpy(), fs=16_000))[:nv])

            if i == 0:  # media of the first batch (reference train.py:406-448)
                step = self.state.step
                w = self.writer
                w.spectrogram("val_mel/g3", g3[0].cpu().numpy(), step)
                w.spectrogram("val_mel/gt", batch.mel[0].cpu().numpy(), step)
                w.spectrogram("val_spec/gen", gs[0].cpu().numpy(), step)
                w.audio("val_aud/pred", wav_pred[0].cpu().numpy(), step)
                w.audio("val_aud/pred_mel", wav_mel[0].cpu().numpy(), step)
                w.audio("val_aud/gt", gt_host[0], step)
                w.waveform("val_wav/gt", gt_host[0], step)
                w.waveform("val_wav/pred_mel", wav_mel[0].cpu().numpy(), step)
                w.waveform("val_wav/pred_spec", wav_pred[0].cpu().numpy(), step)

        if not losses:
            return 0.0, 0.0, 0.0, 0.0

        def pesq_mean(parts):
            scores = np.concatenate(parts)
            return float(np.nanmean(scores)) if np.isfinite(scores).any() else 0.0

        logs = (
            float(np.mean(losses)),
            float(np.nanmean(np.concatenate(stois))),
            float(np.nanmean(np.concatenate(estois))),
            pesq_mean(pesqs),
        )
        # both paths go to the stream (reference train.py:453-460); the
        # postnet path's numbers are returned and name the checkpoint
        self.writer.scalars(
            {
                "val/stoi": logs[1],
                "val/estoi": logs[2],
                "val/pesq": logs[3],
                "val/stoi_mel": float(np.nanmean(np.concatenate(stois_mel))),
                "val/estoi_mel": float(np.nanmean(np.concatenate(estois_mel))),
                "val/pesq_mel": pesq_mean(pesqs_mel),
            },
            self.state.step,
        )
        return logs
