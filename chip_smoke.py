#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vcagan_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. print the card's name and power limit (nvidia-smi); require CUDA;
  2. build the kernels from ``vcagan_torch/csrc`` (one nvcc each, started
     together: the attention, the fused block, the stem and Griffin-Lim),
     print the build time and ptxas report, and count the tensor-core
     instructions in the libraries of the first three;
  3. hold each kernel (masked attention, fused ResNet block) to its plain
     PyTorch version and to a float64 evaluation on the card at the serving
     paths' shapes and at edge cases (both kernels' fp32 forms, which are
     3xTF32, also against that arithmetic in plain PyTorch; the fused block
     in its bf16 form too; D = 100 and D = 264 past 512 keys, once
     refused, among the cases; the fused block's C = 16 and 48, which no
     configuration gives it, must raise); the attention's in-block instance
     (up to 512 keys) at every such case, forced where the planner routes
     a case elsewhere; time the fused block's kernel, plain version and
     bf16 library convolutions; the stem kernel (``fused_stem``) against its
     plain version at (B, T) = (48, 75), an LRS bucket (8, 160) and T = 3,
     all 112x112, and at ragged H, W, T = 1 and C = 128 (C = 48 must
     raise), timed at the first three beside its bound, the plain version
     and the module chain's cuDNN calls;
  4. run the four serving paths (trained weights from
     data/soak_serving_q8.npz, B=2, T=75, 112x112) on the card and on the
     CPU with the same noise and Griffin-Lim phase, and compare: the
     unfolded path and the folded-BN path with fused blocks, each in fp32
     and in the bf16 serving mode; the folded + fused path is also held to
     the unfolded one, and each bf16 path to its fp32 path on the card
     (the JAX package's bounds for bf16 on trained weights); the bf16
     outputs must have the JAX package's dtypes;
  5. serve B=48 x 75 frames at full width on each of the four paths: 2
     warm-ups, then 8 counted batches with one sync; count the kernel
     calls of each run (``vcagan_torch.tracing``'s counters; one stem call
     a forward on the folded + fused bf16 path, none on the others); then
     time the stages of one more forward, the visual front's parts (the
     stem by its span), the five identity-shortcut ResNet blocks and the
     two attentions inside it, with CUDA events; on the bf16 paths, profile
     one forward and the stem alone with torch.profiler (device busy share,
     the kernels that take the most time; the forward's kernel launches,
     the stem's among them, counted against those it saw);
  6. time the attention kernel (and each of its instances up to 512 keys:
     the in-block one and the strip), its plain version and sdpa, the
     PyTorch call that computes the same function, at the serving shapes
     (and at the LRS shape and the GRID training shapes, printed only);
     then one call of each instance under torch.profiler, its launches
     checked, and counted as the profiler saw them, and phase 17 (f) (both
     before the profiler sessions of phases 8-11);
  7. run ``python3 -m vcagan_torch.bench --fold-bn-fused`` (bf16) and
     print its JSON line;
  8. training (``vcagan_torch.train``, fp32, TF32 off): (a) the attention's
     ``autograd.Function`` at the GRID training shapes with ragged lengths,
     its forward and dq, dk, dv against the plain version and float64 (the
     in-block instance's forward too, where the planner routes elsewhere);
     (b) one full-width step (B=2, 40 frames, 112x112, dropout 0) on the
     card against the same step on the CPU: losses, metrics, every
     module's gradient, the updates and the BatchNorm statistics;
     (c) the GRID training shape, B=88 x 40 frames: 2 warm-up and 5
     counted steps, their time, clips/s, peak memory, attention calls a
     step and the time of each part of a step (CUDA events), then one
     step under torch.profiler, its kernels by call site (``call_sites``;
     every fixed-batch step of phase 10 too);
  9. training through its entry points (``vcagan_torch.train.loop.Trainer``
     on the synthetic GRID clips, fp32): (c) ``Trainer.fit`` at the GRID
     recipe, B=88 x 40 frames over 880 clips (10 batches, one epoch, each
     clip rendered on first use): after 2 warm-ups, 5 counted steps from
     the first step before which the device waited on the feed (or the
     last 5, if it never did), the loop's pace beside phase 8 (c)'s
     fixed-batch step and the producer's collate time of the same batches,
     the consumer's waits on the feed queue, peak memory, attention
     calls (2 a step); then 3
     more steps under torch.profiler, with the device's busy share and its
     longest idle gaps labelled by the loop's host range; (d) one
     validation batch at B=88 x 75 (2 attention calls), and its parts
     timed apart; (a) the input pipeline on the card against the CPU on
     one B=88 raw batch, without and with augmentation (the same draws),
     and its time; (b) STOI/ESTOI on the card against the numpy STOI for 8
     waveforms; (e) a checkpoint saved and restored on the card, bit for
     bit; (f) ``python3 -m vcagan_torch.cli.train`` as a subprocess on the
     card (2 steps at B=8), its metric stream read back, run at the end
     beside phase 10 (d)'s CLI;
 10. LRS2 training and bf16 training (the LRS2 recipe: B=16, 50-frame
     windows, plain Adam, sync weight 0.5; its synthetic clips of 30-90
     frames): (a) the attention kernel at the LRS shapes with the real
     lengths of the first training batch and of the first validation
     bucket, against its plain version, float64 and its own 3xTF32
     arithmetic, timed beside each instance up to 512 keys, plain, sdpa
     and its bound, and its autograd.Function's gradient at (16, 50, 50)
     against float64 with the masked key rows' gradients exactly 0; (b) the
     bf16 GRID step at B=2 on the card against the CPU (the CPU test's bf16
     bounds), all modules in bf16 and then the visual front in fp32, and
     R1's gradient into each discriminator alone, then the bf16
     fixed-batch step at B=88 x 40 beside phase 8 (c)'s fp32 one; (c) the LRS2 fixed-batch step at B=16 x 50 (a batch of
     the LRS input pipeline with clips shorter than the window) in fp32
     and bf16; (d) ``Trainer.fit`` on LRS2 over 10 batches counted as in
     phase 9 (c), one validation batch (2 attention calls), a checkpoint
     round trip, and ``python3 -m vcagan_torch.cli.train_lrs --bf16`` (2
     steps) as a subprocess at the same time as phase 9 (f)'s, so that
     their start-ups overlap;
 11. evaluation (the test CLIs' functions, ``vcagan_torch/cli/test.py`` and
     ``test_lrs.py``, and the ASR scorers): (a) the attention kernel at the
     GRID test shapes, B=100 x 75 frames, and at the LRS test bucket of
     160 frames, B=8 with the real lengths of such a batch, against its
     plain version, float64 and its 3xTF32 arithmetic, timed beside each
     instance up to 512 keys, plain, sdpa and its bound, and that
     LRS batch through the flip-TTA eval forward, 4 attention calls
     asserted; (b) the
     GRID and LRS per-batch functions card against CPU on the trained
     weights with the same noise and Griffin-Lim phase, bf16 against fp32
     on the card, and both ASR models card against CPU at full width;
     (c) one GRID test batch at the recipe, B=100 x 75 real clips with flip TTA, in
     fp32 and bf16, each part timed (the two forwards, Griffin-Lim, STOI
     on the card, PESQ on the host, the dump), 4 attention calls
     asserted; (d) ``python3 -m vcagan_torch.cli.test`` and ``test_lrs
     --time_breakdown`` as subprocesses at once on a port checkpoint of
     the trained weights, their artifacts read back, then ``cli.asr_grid``
     and ``cli.asr_lrw`` on them, and the ASR models' ms a batch;
 12. past 512 keys, the collate worker process, JAX train states and
     serving npz: (a) the key-blocked attention kernel (S > 512, keys in
     blocks of 256 with an online softmax) at (B, T, S) = (4, 750, 750)
     and (4, 1500, 750) with lengths 0 and S among them, against its plain
     version, float64 and its arithmetic in plain PyTorch, a length-0 row
     against the mean of its values, the launch counted, timed beside its
     bound, plain and sdpa; its gradient at S = 640; (b) ``Synthesizer``
     on B=2 clips of 750 frames (30 s), fp32 against the CPU, bf16 against
     fp32 on the card, 2 attention calls a forward; (c) ``Trainer.fit``
     in bf16 on GRID and LRS2 with the thread producer (first epoch and
     cached) and with ``ProcessEpoch`` (cached): ms a step, idle share,
     collate ms; (d) a train state in the exporter's format loaded on the
     card, every tensor equal, and scored by ``cli.test`` for one batch;
     (e) phase 9's Trainer written as serving npz (q8) and served by
     ``Synthesizer.from_serving_npz`` on the card;
 13. data parallel (``vcagan_torch.parallel``): (a) under a one-rank NCCL
     group, ``Trainer.fit`` in bf16 at the GRID recipe (B=88 x 40) on phase
     12 (c)'s cached clips: ms a step beside phase 12 (c)'s without a
     group, the gradient all-reduce's ms a step (CUDA events at the step's
     marks) and bytes, 2 attention calls a step; one fp32 step with the
     layout against one without it on the same batch (phase 8 (b)'s
     bounds); (b) ``python3 -m vcagan_torch.parallel.dryrun`` with two gloo
     ranks on the one card at full width, B=88 x 40 frames, 44 clips a
     rank, against one process on all 88 at the gate's tolerances, each
     rank's attention calls and shape, then the attention kernel alone
     at the rank's shapes (44, 40 | 80, 40, 256), beside its bound, plain
     and sdpa;
 14. the model axis (``vcagan_torch.parallel.shard``: ``q`` and ``mel`` of
     both attentions split by column over a model group): (a) ``python3 -m
     vcagan_torch.parallel.dryrun --world 4 --model_parallel 2`` with four
     gloo ranks on the one card at full width, B=16 x 40 frames, 8 clips a
     data rank, against one process on all 16 at the gate's tolerances,
     each rank's attention calls, shapes, peak memory and the model
     axis's ms a step (one more step profiled), then the attention kernel
     alone at the rank's shapes (8, 40 | 80, 40, 256) beside its bound,
     plain and sdpa; (b) ``python3 -m torch.distributed.run
     --nproc_per_node 2 -m vcagan_torch.cli.train --model_parallel 2`` with
     gloo ranks on the card, 2 steps at B=8, its checkpoint held to one
     process's keys, shapes and dtypes and loaded into one process;
 15. the train step's knobs (``make_train_step``'s ``d_phase`` and
     ``remat``): (a) from one state, batch and generator seed, one fp32
     step at the GRID shape (B=88 x 40, dropout on) under "ref"/"none",
     "batched"/"none", "ref"/"stem", "ref"/"vfront", "ref"/"r1" and
     "batched"/"stem,r1", each held to "ref"/"none" (run twice: the card's
     own spread beside): metrics, gradient norms, each module's first
     moment, the BatchNorm statistics and their counts, the generator's
     state, the regions' recomputes and 2 attention calls a step;
     (b) ms a step (3 counted after the first), the parts' CUDA events,
     peak memory and kernel launches in one profiled step under each knob,
     GRID fp32 and bf16, and LRS2 (B=16 x 50) bf16 under "batched" against
     "ref"; (c) phase 9 (f)'s ``cli.train`` runs with ``--remat stem,r1
     --d_phase batched``;
 16. every width the JAX package runs, with ``masked_attention_reference``
     and ``fused_block_reference`` raising on a CUDA tensor (the phase
     keeps them as its oracle): (a) the attention through
     ``masked_cross_attention`` at D = 4, 12, 100 (padded to a multiple of
     8) and S = 21, 75, 600, at D = 264, 512, 1024 (column slices of 256)
     and S = 600, 750 with lengths 0 and S among them, at (64, 512, 4096)
     (no strip fits) and at B = 70,000 (chunks of 65535 samples): one launch
     counted each, against its plain version and float64 (and the in-block
     instance up to 512 keys, forced where the planner routes elsewhere),
     timed beside each instance up to 512 keys, its plain version, sdpa and
     the true shape's bound; (b) the fused block in
     one bf16 call past 2^31 elements (two chunks of images), its first,
     border and last images against its plain version; (c) narrow models card
     against CPU with attention_dim 12 and 264, stem_channels 16 folded +
     fused, and S = 600 at B = 1, their launches counted; (d) the
     full-width ``Synthesizer`` with attention_dim 512 on B=2 clips of 750
     frames in fp32 and bf16, its two attention calls against the plain
     version, one forward timed;
 17. Griffin-Lim's forms, its kernel (``vcagan_torch/kernels/griffin_lim.py``,
     the card's fp32 form) and ``MelPipeline(gl_dtype=...)``: (a) the fp32
     matmul form (``griffin_lim_mxu``) on the card against the FFT form on
     the card and on the CPU at 20 rounds, each beside a float64 run, and
     the bf16 synthesis against its bf16 operands in float64 (fp32 results,
     not bf16 ones); (b) bf16 against fp32 by the JAX package's convergence
     bounds on its multi-tone signal and on the trained postnet's
     spectrogram at B=48; (c) the FFT form's and the kernel's device ms at
     (48, 300, 321), (100, 300, 321), (8, 640, 321) and (1, 4, 321), the
     matmul forms' at the first two, beside their bounds, and one bf16
     call profiled; (d) the bf16 folded + fused serving path at B=48 x 75
     with ``gl_dtype=bf16`` beside the default, in turns, its launches
     asserted and its Griffin-Lim form counted, and the stages of one such
     forward; (e) the kernel at those four shapes against the FFT form on
     the card, its plain twin and a float64 FFT form, with no round and at
     60 rounds, and from a generator; (f) one kernel call at the serving
     shape under torch.profiler: its launches, as counted and as the plan
     gives them, and no other device activity (run after phase 6);
 18. the discriminators' convolutions differentiated twice (``DiscConv2d``
     on ``conv2d_twice``, ``vcagan_torch/nn/discriminator.py``): R1's
     parameter gradients at GRID's training shapes (B=88, the three mel
     scales of a 40-frame window, bf16 modules) against the same
     discriminator on ``F.conv2d`` (PyTorch's double backward), both held
     to that plain path's fp32 gradient (TF32 off) over each
     discriminator's flat gradient: the new path within
     ``R1_TWICE_BOUNDS[0]`` times the plain bf16 path's relative L2 to it,
     the two bf16 paths within ``R1_TWICE_BOUNDS[1]`` times that of each
     other.  (The profiled step of phases 8 (c) and 10 (b), (c) is read by
     call site, ``call_sites``: no double backward, 33 graph backwards a
     step, in bf16 no SIMT convolution in ``train.d_backward`` but over
     one-channel maps);
then print Griffin-Lim's JSON line, the per-kernel JSON line and, last,
the device JSON line.
Needs one card; JAX is not used.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from vcagan_torch.configs import AudioConfig, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from vcagan_torch.configs import grid_config, lrs_config  # noqa: E402
from vcagan_torch.data.device_pipeline import make_device_pipeline  # noqa: E402
from vcagan_torch.data.grid import GridDataset  # noqa: E402
from vcagan_torch.data.lrs import LRSDataset, SyntheticLRSSource  # noqa: E402
from vcagan_torch.data.lrs import make_lrs_device_pipeline  # noqa: E402
from vcagan_torch.data.synthetic import SyntheticLipSpeech  # noqa: E402
from vcagan_torch.data.transforms import augment_draws  # noqa: E402
from vcagan_torch.dsp import STFTParams, griffin_lim, griffin_lim_mxu, stft  # noqa: E402
from vcagan_torch.dsp import pipeline as dsp_pipeline  # noqa: E402
from vcagan_torch.dsp.griffin_lim import dft_bases, random_phase  # noqa: E402
from vcagan_torch.dsp.stft import _wss_correction, overlap_add  # noqa: E402
from vcagan_torch.eval import stoi_np  # noqa: E402
from vcagan_torch.eval.stoi import stoi_estoi_batch  # noqa: E402
from vcagan_torch import tracing  # noqa: E402
from vcagan_torch.io.weights import load_serving_npz  # noqa: E402
from vcagan_torch.kernels import _build  # noqa: E402
from vcagan_torch.kernels import fused_block as fb  # noqa: E402
from vcagan_torch.kernels import fused_stem as fs  # noqa: E402
from vcagan_torch.kernels import griffin_lim as gl_kernel  # noqa: E402
from vcagan_torch.kernels import masked_attention as attn  # noqa: E402
from vcagan_torch.nn.discriminator import DiscConv2d, Discriminator  # noqa: E402
from vcagan_torch.nn.losses import r1_penalty  # noqa: E402
from vcagan_torch.nn.resnet import BasicBlock  # noqa: E402
from vcagan_torch.runtime import use_full_fp32  # noqa: E402
from vcagan_torch.nn.generator import Decoder  # noqa: E402
from vcagan_torch.serve import Synthesizer  # noqa: E402
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step  # noqa: E402
from vcagan_torch.train.loop import Trainer  # noqa: E402
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE  # noqa: E402

SERVING_NPZ = os.path.join(ROOT, "data", "soak_serving_q8.npz")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# tensor cores' dense rates.  A bound divides by the rate of the unit that
# the kernel's form runs on.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# Both kernels' fp32 forms do three TF32 products a multiply (3xTF32).
FB_FLOP_PER_S = {"fp32": TF32_TC_FLOP_PER_S / 3, "bf16": BF16_TC_FLOP_PER_S}
ATTN_FLOP_PER_S = TF32_TC_FLOP_PER_S / 3
ATTN_TOL = 1e-5  # atol and rtol: fp32 on both sides, D=256-term sums
# Fused block, atol and rtol.  fp32: two convolutions of up to 9*512 = 4608
# terms each, summed in another order than cuDNN's, on outputs of order 1;
# the kernel's 3xTF32 products keep about 2^-21 relative each, so the fp32
# bound is unchanged.  bf16: one rounding of h and one of the output (2^-8
# relative each), the bound of the JAX package's own bf16 test.
FB_TOL = 1e-4
FB_BF16_TOL = 0.05
# The libraries whose kernels run on the tensor cores, and Griffin-Lim's
# (cuFFT's transforms and three fp32 elementwise kernels: none there).
TENSOR_CORE_KERNELS = ("masked_attention", "fused_block", "fused_stem")
KERNELS = (*TENSOR_CORE_KERNELS, "griffin_lim")
# Names of the launches of a Griffin-Lim kernel call, as torch.profiler lists
# them: its three kernels and cuFFT's two transforms.
GL_LAUNCH_NAMES = ("gl_project", "gl_reframe", "gl_overlap_add", "regular_fft_c2r",
                   "regular_fft_r2c")
# The stem kernel against its plain version on the card: both round to bf16
# at the same points, but sum the 245 products in fp32 in other orders, so a
# sum that lies at a rounding boundary may round the other way: one bf16 ulp
# of the sum, two of the largest output at most, in a small share of outputs
# (measured 2.0e-5-4.7e-5 of them; 1e-3 allowed).
STEM_ULPS, STEM_FLIP_SHARE = 2 * 2.0**-7, 1e-3
# The stem kernel's shapes: GRID serving, an LRS bucket (B=8 x 160) and a
# short clip, then ragged edges, T = 1 and two channel chunks.
STEM_CASES = (("GRID serving", 48, 75, 112, 112, 64), ("LRS bucket", 8, 160, 112, 112, 64),
              ("T=3", 48, 3, 112, 112, 64), ("ragged T=1", 3, 1, 37, 29, 64),
              ("C=128", 2, 6, 40, 52, 128), ("odd 23x111", 1, 11, 23, 111, 64))
# The identity-shortcut blocks of one forward: (name, H, W, C).
TRUNK_BLOCKS = (("layer1_0", 28, 28, 64), ("layer1_1", 28, 28, 64), ("layer2_1", 14, 14, 128),
                ("layer3_1", 7, 7, 256), ("layer4_1", 4, 4, 512))
PATH_TOL = 1e-3  # atol and rtol for phon/sent/mel3/spec, card vs CPU
WAV_REL_L2 = 1e-2  # waveform after 60 Griffin-Lim rounds, card vs CPU
# bf16 serving: the bounds of the JAX package's own test of bf16 against
# fp32 on trained weights (tests/test_bf16_and_lrs_train.py:198-204): mel3
# correlation and the spectrogram's relative L2.  They hold every bf16
# comparison here: bf16 against fp32 on the card, and card against CPU and
# folded + fused against unfolded in bf16, where both sides round to bf16
# but cuDNN and the CPU sum in other orders, so a rounding that flips
# spreads through the layers and elementwise bounds do not apply.
BF16_MEL_CORR = 0.999
BF16_SPEC_REL = 0.06
BF16_DTYPES = dict(phon=torch.bfloat16, sent=torch.float32, mel1=torch.bfloat16,
                   mel2=torch.bfloat16, mel3=torch.bfloat16, spec=torch.float32,
                   wav=torch.float32)
SERVE_BATCHES = 8  # counted batches on each serving path
# Training.  (a) The Function's backward is the plain version's autograd on
# the saved inputs, so its gradients equal the plain version's on the card
# (same cuBLAS calls) and are held to float64: fp32 sums of at most T = 80
# or D = 256 products of order 1, a bound of 1e-4 (atol and rtol).
ATTN_GRAD_TOL = 1e-4
# (b) Card against CPU, one full-width step from the same weights, batch and
# noise.  Losses and metrics: one fp32 forward (cuDNN against oneDNN sums),
# rtol 1e-3; R1 and the gradient norms come from backward passes, 1e-2.
# Gradients: the train-mode BatchNorm stack leaves fp32 gradients of this
# network about 3e-3 from float64 (relative L2 a leaf, measured on the CPU
# at narrow width against the JAX package and a float64 run,
# tests/test_torch_train_step.py), so each module's is held to 2e-2.  The
# first update is lr * sign(g), never much larger than lr, so it is held by
# the share of elements more than lr / 2 apart (the gradient check above
# catches a scaled gradient, which leaves the update as it was): where g
# lies within that noise its sign may differ and the update with it, by
# 2 lr, in at most 1% of the elements.  BatchNorm statistics:
# one step's move of 0.1 x the batch statistics, to 1e-3 of its size.
STEP_LOSS_RTOL, STEP_NORM_RTOL = 1e-3, 1e-2
STEP_GRAD_REL = 2e-2
STEP_FLIP_SHARE = 1e-2
STEP_STATS_REL = 1e-3
# Phase 10 (b), bf16: the bounds of the CPU test of the port's bf16 step
# against the JAX package's (tests/test_torch_train_bf16.py), the CPU in
# the JAX package's place.  Each module's first moment is read against
# the fp32 one of phase 8 (b), each device against its own, as shares of
# the CPU's fp32 norm: cross (card against CPU), the CPU's spread and the
# card's (each from its fp32 moment), and alpha, a moment's projection on
# its fp32 moment (a gradient scaled by s moves it by 1 - s).  Two runs:
# all seven modules in bf16, where the discriminators' conditional heads
# magnify the bf16 error of the visual front's sentence features (loose:
# cross within 4 x the CPU's spread, the card's 0.25-4 x, alphas 0.25
# apart), and the visual front in fp32 with the six others in bf16 (tight:
# 1.5 x, 0.5-1.5 x, 0.03).  R1's gradient alone, each discriminator on
# random real mels (the step's moments cannot see it): 2 x, 0.5-2 x, 0.05.
# Losses rtol 2e-2, gradient norms 1e-1; statistics 0.05 anywhere and 0.1
# of their move.
BF16_STEP_LOSS_RTOL, BF16_STEP_NORM_RTOL = 2e-2, 1e-1
BF16_RUNS = {"bf16": GENERATOR_SIDE + DISCRIMINATOR_SIDE,
             "bf16, fp32 visual front": GENERATOR_SIDE[1:] + DISCRIMINATOR_SIDE}
BF16_BOUNDS = {"bf16": (4.0, (0.25, 4.0), 0.25),
               "bf16, fp32 visual front": (1.5, (0.5, 1.5), 0.03),
               "r1": (2.0, (0.5, 2.0), 0.05)}
BF16_STATS_MAX, BF16_STATS_REL = 0.05, 0.1
TRAIN_BATCH = TrainConfig().batch_size  # the GRID recipe: 88 clips
TRAIN_WINDOW = DataConfig().window_size  # of 40 frames
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TRAIN_PHASES = ("gen_forward", "d_loss", "d_backward", "d_update", "g_loss", "g_backward",
                "g_update")
# Phase 9, the Trainer.  (c) One epoch of 10 batches of the GRID recipe:
# after 2 warm-ups, 5 counted steps from the first step before which the
# device waited on the feed (from there nothing is buffered, so the pace
# is the feed's or the step's, whichever binds, and not a backlog's);
# a wait is a gap of over LOOP_IDLE_MS between a step's end and the next
# one's start.  (d) validation at B=88 x 75.
LOOP_BATCHES, LOOP_WARMUP, LOOP_STEPS, LOOP_PROFILED = 10, 2, 5, 3
LOOP_IDLE_MS = 10.0
LOOP_RANGES = tuple(tracing.PREFIX + name
                    for name in ("feed.wait", "input_pipeline", "train_step", "readback"))
# (a) The input pipeline, card against CPU on the same raw batch: the video
# goes through two fp32 resize products (TF32 off) and (x - 0.4136) / 0.17,
# values up to 3.5, atol 1e-4; the spectrogram is cuFFT against pocketFFT
# in fp32 on magnitudes up to a few hundred, rtol 1e-4 and atol 1e-3; the
# normalised mel, a log of mel energies scaled by 2 / 11.5, atol 1e-4.
PIPE_VIDEO_TOL, PIPE_SPEC_TOL, PIPE_MEL_TOL = 1e-4, (1e-4, 1e-3), 1e-4
# (b) STOI/ESTOI on the card (fp32) against the float64 numpy STOI: the JAX
# package's bound for its own batched STOI (tests/test_stoi.py).
STOI_TOL = 1e-3
# Phase 10, the LRS2 recipe: B=16 clips, 50-frame training windows,
# validation buckets of up to 160 frames; its synthetic clips (30-90
# frames), LOOP_BATCHES batches of them.
LRS_CONFIG = lrs_config("LRS2")
LRS_BATCH, LRS_WINDOW = LRS_CONFIG.train.batch_size, LRS_CONFIG.data.window_size
LRS_CLIPS = LOOP_BATCHES * LRS_BATCH
PATHS = (("unfolded", False, False), ("folded+fused", True, False),
         ("unfolded bf16", False, True), ("folded+fused bf16", True, True))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, samples: int = 20, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call: median over ``samples`` of the CUDA-event
    time of ``calls`` back-to-back calls, divided by ``calls`` (so the host's
    per-call work overlaps the queued launches instead of being timed)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, side, samples: int = 20, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call: ``calls`` calls captured once in a CUDA
    graph on the stream ``side``, the graph replayed ``samples`` times
    between CUDA events; the median, divided by ``calls``.  No host work is
    timed, which matters for calls of tens of microseconds, where
    ``time_ms`` times the host (the attention's wrapper, its plain version
    and sdpa take 20-140 us of host time a call)."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def attention_inputs(b, t, s, d, lengths, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device="cuda")


def attention_work(b, t, s, d):
    """(bytes, flops) the function needs: q,k,v,lengths read once, out
    written once; two products of 2*B*T*S*D flops each (the B*T*S softmax
    exponentials are not counted)."""
    return 4 * (2 * b * t * d + 2 * b * s * d + b), 4 * b * t * s * d


def key_mask(k, lengths):
    return torch.arange(k.shape[1], device=k.device)[None, :] < lengths[:, None].long()


def sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], attn_mask=mask[:, None, None, :]
    )[:, 0]


def attention_3xtf32(plan, q, k, v, lens):
    """The kernel's arithmetic in plain PyTorch for ``plan`` (its key blocks
    and splits past 512 keys)."""
    if not plan.key_block:
        return attn.masked_attention_reference_3xtf32(q, k, v, lens)
    return attn.masked_attention_reference_3xtf32(q, k, v, lens, key_pad=attn.N_TILE,
                                                  key_block=plan.key_block,
                                                  key_splits=plan.splits)


def check_in_block(name, q, k, v, lens, oracle=None):
    """The in-block instance (the attention up to 512 keys, D up to 256) at
    this row, its plan forced where the planner routes the row elsewhere:
    against the plain version (``oracle``, where the plain version is
    refused on CUDA tensors), float64 and its own 3xTF32 arithmetic, each
    to ATTN_TOL.  Returns the worst of the three errors, or None where the
    instance takes no such shape."""
    b, t, d = q.shape
    s_ = k.shape[1]
    plan = attn.in_block_plan(t, s_, d, b)
    if plan is None:
        return None
    plain = oracle or attn.masked_attention_reference
    got = attn.masked_attention_cuda(q, k, v, lens, plan=plan)
    want = plain(q, k, v, lens)
    want64 = plain(q.double(), k.double(), v.double(), lens)
    want3x = attention_3xtf32(plan, q, k, v, lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err64 = (got.double() - want64).abs().max().item()
    err3x = (got - want3x).abs().max().item()
    check(torch.isfinite(got).all().item() and torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
          and err64 < ATTN_TOL and err3x < ATTN_TOL,
          f"{name} {b, t, s_, d}, in-block instance ({plan.describe()}): vs plain {err:.3e}, "
          f"vs float64 {err64:.3e}, vs its 3xTF32 arithmetic {err3x:.3e}")
    return max(err, err64, err3x)


def instance_ms(q, k, v, lens, side, samples=20):
    """ms (CUDA-graph replay) of each instance that takes this row up to
    512 keys: the in-block instance's plan and the strip's, whichever the
    planner routes the row to."""
    b, t, d = q.shape
    s_ = k.shape[1]
    times = {}
    for name, plan in (("in_block", attn.in_block_plan(t, s_, d, b)),
                       ("strip", attn.strip_plan(t, s_, d))):
        if plan is not None:
            times[name] = graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens, plan=plan),
                                   side, samples=samples, calls=samples)
    return times


def check_refused(what, fn, words):
    """``fn`` must raise ValueError with ``words`` in its message."""
    try:
        fn()
    except ValueError as e:
        check(words in str(e), f"{what}: raised, but with {e}")
        print(f"{what}: refused ({e}) ok")
    else:
        check(False, f"{what}: the wrapper did not raise")


def phase_kernel_vs_plain(card):
    """Returns the worst error against the plain version."""
    rng = np.random.default_rng(0)
    cases = [
        ("att1 path", 48, 75, 75, 256, rng.integers(1, 76, 48)),
        ("att2 path", 48, 150, 75, 256, rng.integers(1, 76, 48)),
        ("LRS max", 4, 640, 160, 256, [160, 100, 1, 37]),
        ("ragged", 3, 77, 21, 256, [1, 2, 3]),
        ("edges", 4, 33, 21, 256, [0, 7, 21, 40]),  # 0, < S, = S, > S
        ("S=8", 3, 40, 8, 256, [0, 8, 5]),
        ("S=9", 3, 40, 9, 256, [0, 9, 4]),
        ("S=16", 3, 40, 16, 256, [0, 16, 11]),
        ("S=160", 3, 40, 160, 256, [0, 160, 97]),
        ("S=S_MAX", 2, 20, attn.S_MAX, 256, [0, 300]),
        ("S=S_MAX+1", 2, 20, attn.S_MAX + 1, 256, [0, attn.S_MAX + 1]),  # past 512 keys
        # past 512 keys, lengths at the key-block (64) and split boundaries
        ("S=600 edges", 6, 70, 600, 256, [256, 257, 512, 513, 0, 600]),
        ("S=1030 edges", 6, 130, 1030, 256, [256, 257, 512, 513, 1029, 1033]),
        ("S=600 D=64", 3, 70, 600, 64, [0, 256, 257]),
        ("S=1030 D=72", 4, 100, 1030, 72, [513, 1030, 0, 1]),
        ("T=1", 5, 1, 75, 256, [75, 0, 1, 40, 80]),
        ("T=17", 3, 17, 75, 256, [75, 0, 33]),
        ("B=1", 1, 75, 75, 256, [60]),
        ("D=64", 3, 33, 21, 64, [0, 21, 9]),
        ("D=128", 3, 33, 21, 128, [0, 21, 9]),
        ("D=72", 2, 20, 21, 72, [0, 13]),
        # once refused: D padded to 104; D past 256 past 512 keys (slices)
        ("D=100", 2, 9, 21, 100, [21, 0]),
        ("D=264 past 512 keys", 2, 9, 600, 264, [600, 0]),
    ]

    worst = worst_3x = 0.0
    for i, (name, b, t, s, d, lengths) in enumerate(cases):
        q, k, v, lens = attention_inputs(b, t, s, d, lengths, seed=i)
        got = attn.masked_attention_cuda(q, k, v, lens)
        torch.cuda.synchronize()
        want = attn.masked_attention_reference(q, k, v, lens)
        err = (got - want).abs().max().item()
        # The plain version has its own rounding, so the kernel is also held
        # to a float64 evaluation of the same function, and to its own
        # arithmetic (three TF32 products a multiply) in plain PyTorch.
        want64 = attn.masked_attention_reference(q.double(), k.double(), v.double(), lens)
        err64 = (got.double() - want64).abs().max().item()
        plan = attn.attention_plan(t, s, d, b)
        err3x = (got - attention_3xtf32(plan, q, k, v, lens)).abs().max().item()
        worst, worst_3x = max(worst, err), max(worst_3x, err3x)
        check(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
        check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
              f"{name} {b, t, s, d}: kernel vs plain max abs err {err:.3e}")
        check(err64 < ATTN_TOL, f"{name} {b, t, s, d}: kernel vs float64 max abs err {err64:.3e}")
        check(err3x < ATTN_TOL, f"{name} {b, t, s, d}: kernel vs plain 3xTF32 {err3x:.3e}")
        zero_err = max([(got[j].double() - v[j].double().mean(0)).abs().max().item()
                        for j, n in enumerate(lengths) if n <= 0], default=0.0)
        check(zero_err < ATTN_TOL, f"{name}: a length-0 row is {zero_err:.3e} from the mean")
        in_err = None if attn.instance(plan) == "in_block" else check_in_block(name, q, k, v, lens)
        print(f"attention {name:10s} B={b} T={t} S={s} D={d} ({plan.describe()}): "
              f"max_abs_err {err:.3e} (vs float64 {err64:.3e}, vs plain 3xTF32 {err3x:.3e}, "
              f"length-0 rows vs the mean {zero_err:.3e})"
              + ("" if in_err is None else f"; the in-block instance {in_err:.3e}") + " ok")
        worst = max(worst, in_err or 0.0)
    print(f"attention (3xTF32) vs plain 3xTF32, worst of the cases: {worst_3x:.3e}")
    # The in-block instance's producers and consumer share rings of slots:
    # the same call must give the same bits every time.
    for i, (b, t, s) in enumerate(((48, 75, 75), (48, 150, 75), (100, 150, 75), (8, 160, 160))):
        q, k, v, lens = attention_inputs(b, t, s, 256, [s - 3 * j % s for j in range(b)], seed=90 + i)
        first = attn.masked_attention_cuda(q, k, v, lens)
        differ = sum(not torch.equal(attn.masked_attention_cuda(q, k, v, lens), first)
                     for _ in range(8))
        check(differ == 0, f"attention {b, t, s}: {differ} of 8 repeated calls differ")
    print("attention: 8 repeated calls the same bits at four shapes ok")
    return worst


# A call's kernel launches by instance (torch.profiler): the in-block one
# launch (two with key splits: the combine), the strip one, the split pass
# two (three with key splits).
INSTANCE_KERNELS = {"in_block": ("in_block_attention_kernel",),
                    "strip": ("masked_attention_kernel",),
                    "split_pass": ("split_pieces_kernel", "long_attention_kernel")}
ATTENTION_KERNELS = {k for ks in INSTANCE_KERNELS.values() for k in ks} | {"combine_splits_kernel"}


def kernel_names(device):
    """The device activities' kernel names without namespace, template and
    arguments."""
    names = []
    for n, _, _ in device:
        short = re.search(r"(\w+)(?:<[^()]*>)?\(", n)
        names.append(short.group(1) if short else n)
    return names


def gl_launches_seen(names):
    """The launches of the Griffin-Lim kernel among ``kernel_names``."""
    return sum(any(k in n for k in GL_LAUNCH_NAMES) for n in names)


def phase_gl_launches(card):
    """Phase 17 (f), run here, before the profiler sessions of phases 8-11:
    one Griffin-Lim kernel call at the serving shape, (48, 300, 321), 60
    rounds, under torch.profiler; every device activity of the call must be
    one of its launches, as many as ``griffin_lim.launches`` counted and
    ``kernel_launches`` gives, and no torch elementwise kernel among them.
    Returns the launches by name."""
    mag = torch.rand((48, 300, 321), generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda") * 10.0
    phase = random_phase(mag.shape, torch.Generator("cuda").manual_seed(4), mag.device)
    plan = gl_kernel.plan_griffin_lim(48, 300, GL_PARAMS, GL_ROUNDS)
    call = lambda: gl_kernel.griffin_lim_cuda(mag, GL_PARAMS, GL_ROUNDS, init_phase=phase)  # noqa: E731
    counted = []

    def measured():
        before = count_of("griffin_lim.launches")
        call()
        counted.append(count_of("griffin_lim.launches") - before)

    call()
    torch.cuda.synchronize()
    device, _ = profiled(measured, warmup=call)
    names = kernel_names(device)
    by_name = {k: sum(k in n for n in names) for k in GL_LAUNCH_NAMES}
    check(len(names) == gl_launches_seen(names) == counted[0] == gl_kernel.kernel_launches(plan),
          f"griffin-lim (48, 300, 321) x {GL_ROUNDS}: the profiler saw {len(names)} device "
          f"activities ({gl_launches_seen(names)} of the kernel's: {by_name}), "
          f"{counted[0]} launches counted, the plan gives {gl_kernel.kernel_launches(plan)}")
    print(f"griffin-lim kernel (48, 300, 321) x {GL_ROUNDS} rounds: one call is {len(names)} "
          f"launches under torch.profiler ({', '.join(f'{k} {v}' for k, v in by_name.items())}), "
          f"as counted, no other device activity ok [{card}]")
    return by_name


def phase_instance_launches(card):
    """Each instance's launches a call under torch.profiler, checked: here,
    before the profiler sessions of phases 8-11 (after them the profiler
    has seen none of this library's kernels)."""
    cases = (("in_block", 48, 75, 75, 1), ("in_block", 48, 75, 75, 2), ("strip", 48, 75, 75, 1),
             ("split_pass", 4, 750, 750, 2))
    for i, (name, b, t, s_, splits) in enumerate(cases):
        if name == "strip":
            plan = attn.strip_plan(t, s_, 256)
        else:
            plan = attn.LongAttentionPlan(t, s_, 256, b, splits, in_block=name == "in_block",
                                          key_block=attn.in_block_plan(t, s_, 256, b).key_block
                                          if name == "in_block" else attn.KEY_BLOCK)
        q, k, v, lens = attention_inputs(b, t, s_, 256, [s_] * b, seed=70 + i)
        attn.masked_attention_cuda(q, k, v, lens, plan=plan)
        torch.cuda.synchronize()
        before = count_of("attention.launches"), count_of(f"attention.launches.{name}")
        device, _ = profiled(lambda: attn.masked_attention_cuda(q, k, v, lens, plan=plan))
        names = kernel_names(device)
        want = list(INSTANCE_KERNELS[name]) + (["combine_splits_kernel"] if splits > 1 else [])
        check(names == want, f"{name} ({plan.describe()}): torch.profiler saw {names}, not {want}")
        counted = (count_of("attention.launches") - before[0],
                   count_of(f"attention.launches.{name}") - before[1])
        check(counted == (len(names),) * 2 == (attn.kernel_launches(plan, b),) * 2,
              f"{name}: launches counted {counted}, the profiler saw {len(names)}, the plan "
              f"gives {attn.kernel_launches(plan, b)}")
        print(f"attention {name} B={b} T={t} S={s_}, {splits} split(s): one call is "
              f"{len(names)} launch(es) under torch.profiler ({', '.join(names)}), as counted "
              f"ok [{card}]")


def phase_attention_times(card):
    """Times at the serving path's inputs: full lengths (bench-style clips
    of 75 frames), so no key is masked and the work is the whole product.
    Device times from CUDA-graph replays; the kernel's time_ms (events around
    back-to-back calls, host work included, as the attention was timed
    before) stands beside as ``events_ms``.  Each instance that takes the
    row up to 512 keys is timed too (``instance_ms``): the in-block one,
    which the planner routes these rows to, and the strip.  The LRS shape
    and the GRID training shapes (B=88, 40 frames) are printed only.
    Run after the serving phases: capturing the plain version leaves cuBLAS
    a workspace for the capture stream, which would count in their peak
    memory.  Returns the per-forward totals (with each instance's)."""
    totals = dict(ms=0.0, events_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0,
                  instances={})
    side = torch.cuda.Stream()
    for name, b, t, s, d in (("att1", 48, 75, 75, 256), ("att2", 48, 150, 75, 256),
                             ("LRS", 4, 640, 160, 256), ("train att1", 88, 40, 40, 256),
                             ("train att2", 88, 80, 40, 256)):
        q, k, v, lens = attention_inputs(b, t, s, d, [s] * b, seed=7)
        plan = attn.attention_plan(t, s, d, b)
        ms = graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens), side)
        events_ms = time_ms(lambda: attn.masked_attention_cuda(q, k, v, lens))
        plain = graph_ms(lambda: attn.masked_attention_reference(q, k, v, lens), side)
        mask = key_mask(k, lens)
        lib = graph_ms(lambda: sdpa(q, k, v, mask), side)
        by_instance = instance_ms(q, k, v, lens, side)
        nbytes, flops = attention_work(b, t, s, d)
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ATTN_FLOP_PER_S * 1e3
        bound, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
        print(f"attention {name} time B={b} T={t} S={s} D={d} (3xTF32 on the tensor cores): "
              f"kernel {ms:.4f} ms ({attn.instance(plan)}: {plan.describe()}; events around "
              f"back-to-back calls {events_ms:.4f} ms), by instance "
              + ", ".join(f"{n} {m:.4f} ms" for n, m in by_instance.items())
              + f"; plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at 495 TFLOP/s / 3) [{card}]")
        if name not in ("att1", "att2"):  # printed only
            continue
        for key, val in (("ms", ms), ("events_ms", events_ms), ("plain_ms", plain),
                         ("library_ms", lib), ("bytes", nbytes), ("flops", flops)):
            totals[key] += val
        for n, m in by_instance.items():
            totals["instances"][n] = totals["instances"].get(n, 0.0) + m
    return totals


def fused_block_inputs(n, h, w, c, seed, dtype=torch.float32, zero_ring=False):
    """x (N,H,W,C); weights of variance 1/(9C), so h and the output stay of
    order 1; biases 0.1; PReLU slopes of either sign.  ``zero_ring``: x = 0
    and b1 = 3, so h is PReLU(b1) inside the image and must be 0 outside."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    x = rand(n, h, w, c)
    w1, w2 = (rand(3, 3, c, c) / (9 * c) ** 0.5 for _ in range(2))
    b1, b2 = 0.1 * rand(c), 0.1 * rand(c)
    a1, a2 = 0.25 * rand(c), 0.25 * rand(c)
    if zero_ring:
        x, b1 = torch.zeros_like(x), b1 + 3.0
    return x.to(dtype), w1, b1, a1, w2, b2, a2


def fused_block_work(n, h, w, c, itemsize=4):
    """(bytes, flops) the function needs: x read and out written once, both
    weights (of x's type), fp32 biases and slopes read once; two
    convolutions of 2*9*C*C*H*W*N flops each."""
    nbytes = 2 * n * h * w * c * itemsize + 2 * 9 * c * c * itemsize + 4 * 4 * c
    return nbytes, 2 * 2 * 9 * c * c * h * w * n


def ragged_batch(h, w, c, dtype):
    """An N for which the plan puts several images in a block and the last
    block is not full."""
    for n in range(151, 400):
        plan = fb.plan_fused_block(n, h, w, c, dtype)
        if plan.g > 1 and n % plan.g:
            return n
    raise RuntimeError(f"chip_smoke: no ragged batch for {h}x{w}x{c} {dtype}")


def convs_bf16(x, w1, b1, a1, w2, b2, a2):
    """The block as bf16 library convolutions on channels-last memory (a
    yardstick for the bf16 form; not what the plain version computes)."""
    def prelu(v, a):
        return torch.where(v >= 0, v, a.to(v.dtype)[None, :, None, None] * v)

    xc = x.permute(0, 3, 1, 2)
    k1, k2 = (k.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
              for k in (w1, w2))
    hmid = prelu(F.conv2d(xc, k1, b1.to(x.dtype), padding=1), a1)
    return prelu(F.conv2d(hmid, k2, b2.to(x.dtype), padding=1) + xc, a2).permute(0, 2, 3, 1)


def phase_fused_block_vs_plain(card):
    """Returns one forward's totals (the five trunk blocks at N = 3600), fp32
    and bf16, and the worst fp32 error against the plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [shape for _, *shape in TRUNK_BLOCKS[1:]]
    cases = [  # name, N, H, W, C, dtype, zero_ring
        *((f"{name} N=150", 150, h, w, c, f32, False) for name, h, w, c in TRUNK_BLOCKS[1:]),
        *((f"{name} N=7", 7, h, w, c, f32, False) for name, h, w, c in TRUNK_BLOCKS[3:]),
        # the last block of several images is not full
        *((f"ragged {h}x{w}x{c}", ragged_batch(h, w, c, dt), h, w, c, dt, False)
          for h, w, c in shapes[2:] for dt in (f32, bf16)),
        *((f"one image {h}x{w}x{c}", 1, h, w, c, dt, False) for h, w, c in shapes
          for dt in (f32, bf16)),
        ("9x9x64", 5, 9, 9, 64, f32, False),
        ("ragged 11x5x192", 13, 11, 5, 192, f32, False),
        ("ragged 11x5x192", 13, 11, 5, 192, bf16, False),
        *((f"zero ring {h}x{w}x{c}", 3, h, w, c, dt, True) for h, w, c in shapes
          for dt in (f32, bf16)),
        *((f"bf16 {name}", 50, h, w, c, bf16, False) for name, h, w, c in TRUNK_BLOCKS[1:]),
    ]
    # C not a multiple of the 64 channels of a tensor-core tile: no
    # configuration gives the block one (the trunk's widths are 64 ... 512
    # whatever stem_channels is), and the kernel says so instead of
    # computing something else.
    for c in (16, 48):
        args = fused_block_inputs(3, 5, 5, c, seed=99)
        check_refused(f"fused_block C={c}", lambda: fb.fused_basic_block(*args), "multiple of 64")
    # bf16 x with weights packed for fp32 (the packing of the weights' own type
    # where the compute dtype is bf16): refused, not read as bf16.
    x, w1, b1, a1, w2, b2, a2 = fused_block_inputs(3, 5, 5, 64, seed=97, dtype=bf16)
    check_refused("fused_block bf16 x with fp32-packed weights",
                  lambda: fb.fused_block_cuda(x, fb.pack_weights(w1, f32), b1, a1,
                                              fb.pack_weights(w2, f32), b2, a2),
                  "w1_packed must be torch.bfloat16")

    worst = worst_3x = 0.0
    for i, (name, n, h, w, c, dtype, zero_ring) in enumerate(cases):
        args = fused_block_inputs(n, h, w, c, seed=100 + i, dtype=dtype, zero_ring=zero_ring)
        got = fb.fused_basic_block(*args)  # packs the weights, launches the kernel
        torch.cuda.synchronize()
        want = fb.fused_block_reference(*args)
        check(got.shape == want.shape and got.dtype == dtype, f"{name}: shape or dtype")
        check(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        if dtype == f32:
            tol = FB_TOL
            worst = max(worst, err)
            # cuDNN's own rounding is in `want`, so also hold the kernel to
            # a float64 evaluation of the same function, and to its own
            # arithmetic (three TF32 products a multiply) in plain PyTorch.
            want64 = fb.fused_block_reference(*(a.double() for a in args))
            err64 = (got.double() - want64).abs().max().item()
            check(torch.allclose(got.double(), want64, rtol=tol, atol=tol),
                  f"{name}: kernel vs float64 max abs err {err64:.3e}")
            err3x = (got - fb.fused_block_reference_3xtf32(*args)).abs().max().item()
            check(err3x < tol, f"{name}: kernel vs 3xTF32 in plain PyTorch {err3x:.3e}")
            worst_3x = max(worst_3x, err3x)
            extra = f" (vs float64 {err64:.3e}, vs plain 3xTF32 {err3x:.3e})"
        else:
            tol, extra = FB_BF16_TOL, ""
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{name} {n, h, w, c}: kernel vs plain max abs err {err:.3e}")
        if zero_ring:  # the border pixels are where a wrong ring shows
            border = torch.ones(h, w, dtype=torch.bool, device="cuda")
            border[1:-1, 1:-1] = False
            berr = (got.float() - want.float())[:, border].abs().max().item()
            check(berr <= tol * (1 + want.float().abs().max().item()),
                  f"{name}: border max abs err {berr:.3e}")
            extra += f" border {berr:.3e}"
        plan = fb.plan_fused_block(n, h, w, c, dtype)
        print(f"fused_block {name:22s} N={n} {h}x{w}x{c} {str(dtype)[6:]} (rows {plan.r}, images "
              f"{plan.g} a block): max_abs_err {err:.3e}{extra} ok")
    print(f"fused_block fp32 form (3xTF32) vs plain 3xTF32, worst of the cases: {worst_3x:.3e}")

    # The serving path's own shapes, N = B*T = 3600, one per shape class and
    # form: first kernel against plain version (no float64 pass at this
    # size), then the times, with the weights packed beforehand as the
    # modules pack them at load.
    totals = {form: dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0) for form in FB_FLOP_PER_S}
    totals["bf16"]["convs_ms"] = 0.0
    timed = {}
    n = 3600
    kw = dict(samples=5, calls=4, warmup=1)  # milliseconds a call: few suffice
    for name, h, w, c in TRUNK_BLOCKS:
        for form, dtype, tol in (("fp32", f32, FB_TOL), ("bf16", bf16, FB_BF16_TOL)):
            if (h, w, c, form) not in timed:
                args = fused_block_inputs(n, h, w, c, seed=7, dtype=dtype)
                x, w1, b1, a1, w2, b2, a2 = args
                packed = (x, fb.pack_weights(w1, dtype), b1, a1, fb.pack_weights(w2, dtype), b2, a2)
                got, want = fb.fused_block_cuda(*packed), fb.fused_block_reference(*args)
                err = (got.float() - want.float()).abs().max().item()
                check(torch.isfinite(got).all().item(), f"N={n} {h}x{w}x{c}: non-finite output")
                check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"N={n} {h}x{w}x{c} {form}: kernel vs plain max abs err {err:.3e}")
                if form == "fp32":
                    worst = max(worst, err)
                print(f"fused_block serving shape N={n} {h}x{w}x{c} {form}: max_abs_err "
                      f"{err:.3e} ok")
                del got, want
                plain = time_ms(lambda: fb.fused_block_reference(*args), **kw)
                ms = time_ms(lambda: fb.fused_block_cuda(*packed), **kw)
                nbytes, flops = fused_block_work(n, h, w, c, x.element_size())
                bound = max(nbytes / HBM_BYTES_PER_S, flops / FB_FLOP_PER_S[form]) * 1e3
                timed[(h, w, c, form)] = dict(ms=ms, plain_ms=plain, bytes=nbytes, flops=flops)
                if form == "fp32":
                    what = ("3xTF32 on the tensor cores", "plain (cuDNN fp32 convs, TF32 off)",
                            "flops / (495 TFLOP/s / 3)")
                    extra = ""
                else:
                    convs = time_ms(lambda: convs_bf16(*args), **kw)
                    timed[(h, w, c, form)]["convs_ms"] = convs
                    what = ("bf16 on the tensor cores", "plain (bf16 values, cuDNN fp32 convs)",
                            "flops / 989 TFLOP/s")
                    extra = f", bf16 cuDNN convs {convs:.3f} ms"
                print(f"fused_block time N={n} {h}x{w}x{c} {form} ({what[0]}): kernel {ms:.3f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), {what[1]} {plain:.3f} ms{extra}, bound "
                      f"{bound:.3f} ms ({what[2]}; {nbytes / 1e6:.1f} MB, {flops / 1e12:.3f} "
                      f"TFLOP) [{card}]")
                del args, packed
            for key, val in timed[(h, w, c, form)].items():
                totals[form][key] += val
    return totals, worst


def stem_inputs(b, t, h, w, c, seed):
    """video (B,T,H,W,1) of order 1; weights of variance 1/245, so outputs
    stay of order 1; biases 0.3 and PReLU slopes 0.5 of either sign."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    return rand(b, t, h, w, 1), rand(c, 1, 5, 7, 7) / 245 ** 0.5, 0.3 * rand(c), 0.5 * rand(c)


def stem_work(b, t, h, w, c):
    """(bytes, flops) the stem needs: the fp32 video read and the bf16 pooled
    map written once, the bf16 weights, fp32 bias and slopes; 245
    multiply-adds an output of the convolution."""
    ho, wo, hp, wp = fs.conv_size(h), fs.conv_size(w), fs.pooled_size(h), fs.pooled_size(w)
    nbytes = b * t * h * w * 4 + b * t * hp * wp * c * 2 + 245 * c * 2 + 2 * c * 4
    return nbytes, 2 * 245 * b * t * ho * wo * c


def stem_chain(video, weight, bias, slope):
    """The stem as the module chain runs it elsewhere: bf16 cuDNN
    convolution with its bias, PReLU, max-pool, then the copy into the
    trunk's channels-last layout (a yardstick; not what the plain version
    computes, which rounds the sum before the bias)."""
    bf16 = torch.bfloat16
    x = F.conv3d(video.permute(0, 4, 1, 2, 3).to(bf16), weight.to(bf16), bias.to(bf16),
                 stride=(1, 2, 2), padding=(2, 3, 3))
    x = F.max_pool3d(F.prelu(x, slope.to(bf16)), (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
    return x.permute(0, 2, 3, 4, 1).reshape(-1, *x.shape[3:], x.shape[1]).contiguous()


def phase_stem_vs_plain(card):
    """Phase 3, the stem kernel: C not a multiple of 64 refused; at
    ``STEM_CASES`` the kernel against its plain version (``STEM_ULPS``,
    ``STEM_FLIP_SHARE``); at the three main shapes its time beside the plain
    version, the module chain's cuDNN calls and its bound.  Returns the GRID
    serving shape's figures and the worst error as a share of the largest
    output."""
    args = stem_inputs(1, 2, 16, 16, 48, seed=1)
    check_refused("fused_stem C=48", lambda: fs.fused_stem(*args), "multiple of 64")
    worst, out = 0.0, {}
    kw = dict(samples=5, calls=4, warmup=1)
    for i, (name, b, t, h, w, c) in enumerate(STEM_CASES):
        args = stem_inputs(b, t, h, w, c, seed=200 + i)
        got = fs.fused_stem(*args)  # packs the weights, launches the kernel
        torch.cuda.synchronize()
        want = fs.fused_stem_reference(*args)
        check(got.shape == want.shape and got.dtype == torch.bfloat16, f"stem {name}: shape")
        check(torch.isfinite(got).all().item(), f"stem {name}: non-finite kernel output")
        diff = (got.float() - want.float()).abs()
        scale = want.float().abs().max().item()
        err, share = diff.max().item() / scale, (diff > 0).float().mean().item()
        worst = max(worst, err)
        check(err <= STEM_ULPS and share <= STEM_FLIP_SHARE,
              f"stem {name} {(b, t, h, w, c)}: kernel vs plain {err:.3e} of the largest output, "
              f"{share:.3e} of outputs differ")
        plan = fs.plan_fused_stem(b, t, h, w, c)
        line = (f"stem {name:12s} {(b, t, h, w, c)} (band {plan.p} pooled rows, {plan.tc} "
                f"frames a block, {plan.blocks} blocks): max err {err:.3e} of the largest output, "
                f"{share:.3e} of outputs differ ok")
        del got, want, diff
        if i < 3:
            packed = fs.pack_stem_weights(args[1])
            ms = time_ms(lambda: fs.fused_stem_cuda(args[0], packed, args[2], args[3]), **kw)
            plain = time_ms(lambda: fs.fused_stem_reference(*args), samples=2, calls=2, warmup=1)
            library = time_ms(lambda: stem_chain(*args), samples=3, calls=2, warmup=1)
            nbytes, flops = stem_work(b, t, h, w, c)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOP_PER_S) * 1e3
            line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.3f} "
                     f"ms, cuDNN chain {library:.3f} ms, bound {bound:.3f} ms (flops / 989 "
                     f"TFLOP/s; {nbytes / 1e6:.1f} MB, {flops / 1e12:.3f} TFLOP) [{card}]")
            if i == 0:
                out = dict(ms=ms, plain_ms=plain, library_ms=library, bytes=nbytes, flops=flops,
                           bound_ms=bound)
            del packed
        print(line)
        del args
    return out, worst


def count_of(name):
    """A counter of ``vcagan_torch.tracing`` (0 where nothing was counted):
    ``attention.calls`` / ``fused_block.calls``, the calls of a kernel, and
    ``*.launches``, its kernel launches."""
    return tracing.counters().get(name, 0)


def reset_launches():
    tracing.read()  # clears the counters (tracing is off: no span is held)


def check_calls(attention, fused, what):
    """Since ``reset_launches``: ``attention`` calls of the attention kernel
    and ``fused`` of the fused-block kernel."""
    got = count_of("attention.calls"), count_of("fused_block.calls")
    check(got == (attention, fused), f"{what}: {got[0]} attention and {got[1]} fused-block "
          f"kernel calls, not {attention} and {fused}")


def check_launches(forwards, fused, what, stem=None, gl=1):
    """Every forward calls the attention kernel twice and, with fused blocks,
    the fused-block kernel 5 times (else never); with ``stem`` given, the
    stem kernel once where it is true (the folded + fused bf16 front), else
    never; the Griffin-Lim kernel ``gl`` times (once with the default fp32
    Griffin-Lim, never with ``gl_dtype`` bf16)."""
    check(count_of("griffin_lim.calls") == gl * forwards,
          f"{what}: {count_of('griffin_lim.calls')} Griffin-Lim kernel calls in {forwards} "
          f"forwards, not {gl} each")
    if stem is not None:
        want = forwards if stem else 0
        check(count_of("stem.calls") == want,
              f"{what}: {count_of('stem.calls')} stem calls in {forwards} forwards, not {want}")
    calls = count_of("attention.calls")
    check(calls == 2 * forwards,
          f"{what}: {calls} attention calls in {forwards} forwards, not 2 each")
    want = 5 * forwards if fused else 0
    check(count_of("fused_block.calls") == want,
          f"{what}: {count_of('fused_block.calls')} fused-block calls in {forwards} forwards, "
          f"not {want}")


def compare_outputs(what, got, want, tol, wav_tol):
    for name in ("phon", "sent", "mel3", "spec"):
        g, w = got[name].cpu(), want[name].cpu()
        check(torch.isfinite(g).all().item(), f"{what} {name}: non-finite")
        err = (g - w).abs().max().item()
        print(f"path {what} {name}: max abs err {err:.3e} (max |ref| {w.abs().max().item():.3e})")
        check(torch.allclose(g, w, rtol=tol, atol=tol), f"{what} {name} differs: {err:.3e}")
    g, w = got["wav"].cpu(), want["wav"].cpu()
    rel = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
    print(f"path {what} wav: relative L2 {rel:.3e}")
    check(rel < wav_tol, f"{what} wav relative L2 {rel:.3e}")


def corr_rel(got, want):
    """Correlation and relative L2 of two tensors, in float64 on the CPU."""
    g, w = got.cpu().double().flatten(), want.cpu().double().flatten()
    corr = torch.corrcoef(torch.stack([g, w]))[0, 1].item()
    return corr, (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()


def compare_bf16(what, got, want):
    """A bf16 run against another run: mel3 correlation and the spectrogram's
    relative L2 held to the JAX package's bounds; phon, sent and wav printed."""
    for name in ("phon", "sent", "mel3", "spec", "wav"):
        check(torch.isfinite(got[name]).all().item(), f"{what} {name}: non-finite")
        corr, rel = corr_rel(got[name], want[name])
        print(f"path {what} {name}: correlation {corr:.6f}, relative L2 {rel:.3e}")
        if name == "mel3":
            check(corr > BF16_MEL_CORR, f"{what} mel3 correlation {corr:.6f}")
        if name == "spec":
            check(rel < BF16_SPEC_REL, f"{what} spec relative L2 {rel:.3e}")


def phase_paths_card_vs_cpu(states):
    """The four paths on the card against the CPU (plain versions of the
    kernels); on the card, the folded + fused paths against the unfolded
    ones and the bf16 paths against the fp32 ones."""
    b, t = 2, 75
    rng = np.random.default_rng(1)
    video = rng.standard_normal((b, t, 112, 112, 1)).astype(np.float32)
    lengths = np.asarray([t, 60], np.int32)
    noise = rng.standard_normal((b, 20, t, 128)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32)

    outs = {}
    for path, fused, bf16 in PATHS:
        kw = dict(fold_bn=fused, fused_blocks=fused)
        config = ModelConfig(use_bfloat16=bf16)
        on_card = Synthesizer(config, device="cuda", **kw).load_state_dicts(states)
        reset_launches()
        got = on_card(video, lengths, noise=noise, init_phase=phase)
        torch.cuda.synchronize()
        check_launches(1, fused, path, stem=fused and bf16)
        check(got["wav"].shape == (b, 160 * (4 * t - 1)), f"wav shape {tuple(got['wav'].shape)}")
        want = Synthesizer(config, device="cpu", **kw).load_state_dicts(states)(
            video, lengths, noise=noise, init_phase=phase
        )
        if bf16:
            for name, dtype in BF16_DTYPES.items():  # the JAX package's dtypes, on both devices
                for side, out in (("card", got), ("CPU", want)):
                    check(out[name].dtype == dtype,
                          f"{path} {name} on the {side}: {out[name].dtype}, not {dtype}")
            compare_bf16(f"{path}, card vs CPU", got, want)
        else:
            compare_outputs(f"{path}, card vs CPU", got, want, PATH_TOL, WAV_REL_L2)
        outs[path] = got
    # Folding is exact algebra and the kernel computes the same block, so in
    # fp32 the two paths differ by fp32 rounding only: the same bounds hold.
    compare_outputs("folded+fused vs unfolded, card", outs["folded+fused"], outs["unfolded"],
                    PATH_TOL, WAV_REL_L2)
    compare_bf16("folded+fused bf16 vs unfolded bf16, card", outs["folded+fused bf16"],
                 outs["unfolded bf16"])
    for path in ("unfolded", "folded+fused"):
        compare_bf16(f"{path} bf16 vs {path} fp32, card", outs[f"{path} bf16"], outs[path])


def phase_serve(states, card, what, fused, bf16):
    """Serve at full width on one path, its synthesizer the only one on the
    card; returns the launches of the counted batches, by kernel, and the
    identity-shortcut blocks' time inside one forward."""
    synth = Synthesizer(ModelConfig(use_bfloat16=bf16), device="cuda", fold_bn=fused,
                        fused_blocks=fused).load_state_dicts(states)
    b, t, batches = 48, 75, SERVE_BATCHES
    video = torch.from_numpy(
        np.random.default_rng(2).standard_normal((b, t, 112, 112, 1)).astype(np.float32)
    ).cuda()
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")
    for _ in range(2):
        synth(video, lengths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    outs = [synth(video, lengths) for _ in range(batches)]
    sums = torch.stack([o["wav"].abs().sum() for o in outs]).cpu()  # the one sync
    elapsed = time.perf_counter() - t0
    launches = (count_of("attention.calls"), count_of("fused_block.calls"),
                count_of("stem.calls"), count_of("griffin_lim.calls"))
    by_instance = {n: count_of(f"attention.launches.{n}") for n in INSTANCE_KERNELS}
    check_launches(batches, fused, what, stem=fused and bf16)

    wav = outs[-1]["wav"]
    check(wav.shape == (b, 160 * (4 * t - 1)), f"wav shape {tuple(wav.shape)}")
    check(bool(torch.isfinite(sums).all()) and bool(torch.isfinite(wav).all()), "non-finite wav")
    mel_fps = batches * b * 4 * t / elapsed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve {what} B={b} T={t}: {mel_fps:.1f} mel-frames/s ({elapsed:.3f} s for "
          f"{batches} batches), peak {peak_gb:.2f} GB, {launches[0] / batches:g} attention calls "
          f"(kernel launches {', '.join(f'{n} {c}' for n, c in by_instance.items())} in all) "
          f"and {launches[1] / batches:g} fused-block, {launches[2] / batches:g} stem and "
          f"{launches[3] / batches:g} Griffin-Lim kernel calls per forward [{card}]")
    del outs
    parts = stage_breakdown(synth, video, lengths, card, what)
    if bf16:
        device_profile(synth, video, lengths, card, what)
    counts = dict(zip(("masked_cross_attention", "fused_basic_block", "fused_stem",
                       "griffin_lim"), launches))
    counts["attention_by_instance"] = by_instance
    return counts, parts


def time_modules(groups):
    """Forward hooks that record a CUDA event just before and just after every
    call of each module in ``groups`` ({label: [modules]}).  Returns the
    hooks (to remove) and, by label, the [start, end] event pairs."""
    pairs = {label: [] for label in groups}
    hooks = []

    def record():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    for label, modules in groups.items():
        def before(module, args, label=label):
            pairs[label].append([record()])

        def after(module, args, out, label=label):
            pairs[label][-1].append(record())

        for m in modules:
            hooks += [m.register_forward_pre_hook(before), m.register_forward_hook(after)]
    return hooks, pairs


@torch.inference_mode()
def stage_breakdown(synth, video, lengths, card, what):
    """Device time of each stage of one forward (the composition of
    ``Synthesizer.__call__``), from CUDA events between the stages; and,
    from events around modules, of the visual front's parts, of the trunk's
    five identity-shortcut blocks (fused-block calls on the folded +
    fused paths) and of the decoder's two attentions; the stem (one
    stem-kernel call on the folded + fused bf16 path, else the layers) by
    its span, ``v_front.stem``.  Returns each part's sum in ms."""
    v = synth.v_front
    blocks = [m for m in v.modules() if isinstance(m, BasicBlock) and m.downsample is None]
    check(len(blocks) == 5, f"{len(blocks)} identity-shortcut blocks, not 5")
    groups = {"trunk": [v.resnet],
              "biGRU+fc": [v.sentence_encoder, v.fc], "identity blocks": blocks,
              "attention (denses + kernel)": [synth.gen.att1, synth.gen.att2]}
    hooks, pairs = time_modules(groups)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    try:
        events[0].record()
        tracing.read()  # nothing held: the spans of the front alone
        with tracing.enabled():
            phon, sent = v(video)
        stem = [s.device_ms for s in tracing.read()["spans"] if s.name == "v_front.stem"]
        events[1].record()
        mels = synth.gen(sent, phon, lengths, generator=synth.generator)
        events[2].record()
        spec = synth.post(mels[2]).transpose(1, 2).float()
        events[3].record()
        synth.pipe.inverse_spec(spec, generator=synth.generator)
        events[4].record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    names = ("visual_front", "decoder", "postnet", "griffin_lim+deemphasis")
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(4)]
    total = sum(ms)
    print(f"stages of one {what} B={video.shape[0]} forward [{card}]: " + ", ".join(
        f"{n} {m:.2f} ms ({100 * m / total:.1f}%)" for n, m in zip(names, ms)
    ) + f"; total {total:.2f} ms")
    parts = {"stem": stem, **{label: [a.elapsed_time(b) for a, b in pairs[label]]
                               for label in groups}}
    check(len(parts["identity blocks"]) == 5 and len(parts["stem"]) == 1, f"hooks: {parts}")
    print(f"inside that {what} forward [{card}]: " + ", ".join(
        f"{label} {sum(times):.2f} ms" for label, times in parts.items()))
    print(f"identity-shortcut blocks inside that {what} forward "
          f"({'fused-block calls' if blocks[0].fused else 'library convolutions'}): "
          + ", ".join(f"{m:.3f}" for m in parts["identity blocks"])
          + f" ms, sum {sum(parts['identity blocks']):.3f} ms [{card}]")
    return {label: sum(times) for label, times in parts.items()}


def profiled(fn, record_shapes=False, warmup=None):
    """One call of ``fn`` under ``torch.profiler``: its device activities
    (kernels, copies) as (name, start us, end us), and the profile.
    ``warmup``, where given, is called first in a cycle of the session whose
    events are dropped: a session can miss the kernels of its first few
    milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kw = {} if warmup is None else dict(schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes, **kw) as prof:
        if warmup is not None:
            warmup()
            torch.cuda.synchronize()
            prof.step()
        fn()
        torch.cuda.synchronize()
        if warmup is not None:
            prof.step()
    # (a schedule's step is a range that the device timeline mirrors: no work)
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")], prof


# what one GRID or LRS2 step's R1 differentiates with a graph: the
# convolutions on the path from each unconditional logit to its mel, 8 + 11 + 14
R1_GRAPH_BACKWARDS = 33


def call_sites(prof, counts, what, bf16, card):
    """A profiled train step's kernels by call site (``tools/conv_sites.py``)
    and the step's counters: no ``aten::_convolution_double_backward`` (the
    discriminators' convolutions differentiate twice through
    ``conv_transpose2d``) and ``R1_GRAPH_BACKWARDS`` backwards under a
    graph; in bf16, every cuDNN convolution without tensor cores
    (``implicit_convolve_sgemm``, ``precomputed_convolve_sgemm``) left in
    ``train.d_backward`` one over a one-channel map, for which cuDNN has
    no tensor-core algorithm (the discriminators' input convolution, which
    the forward runs on the same kernel), and each named with its shapes."""
    from tools.conv_sites import SIMT, sites

    def one_channel(g):  # the op's weight (C_out, 1, k, k)
        shapes = ast.literal_eval(g["shapes"])
        return shapes[2 if g["chain"].endswith("convolution_backward") else 1][1] == 1

    found = sites(prof, 1, top=10 ** 6)
    left = [g for g in found["groups"] if any(k in g["kernel"] for k in SIMT)]
    graphs = counts.get("disc_conv.graph_backwards")
    print(f"kernels of that step by call site [{card}]: "
          f"{found['double_backward_ops_per_step']:g} double-backward ops, disc_conv "
          f"{counts.get('disc_conv.calls')} calls and {graphs} graph backwards; SIMT convolutions: "
          + ("; ".join(f"{g['range']} {g['node']} {g['chain'].split(' > ')[0]} {g['shapes'][:80]} "
                       f"{g['ms_per_step']:.2f} ms" for g in left) or "none")
          + "; largest: " + "; ".join(f"{g['kernel'][:48]} {g['range']} {g['node']} "
                                      f"{g['ms_per_step']:.2f} ms" for g in found["groups"][:6]))
    check(found["double_backward_ops_per_step"] == 0,
          f"train {what}: a convolution differentiates twice in PyTorch's generic way")
    check(graphs == R1_GRAPH_BACKWARDS,
          f"train {what}: disc_conv.graph_backwards {graphs} a step, not {R1_GRAPH_BACKWARDS}")
    check(not bf16 or all(one_channel(g) for g in left if g["range"] == "train.d_backward"),
          f"train {what}: SIMT convolutions over several channels left in train.d_backward")


def most_time(activities, top=8):
    by_name = {}
    for name, start, end in activities:
        by_name[name] = by_name.get(name, 0.0) + end - start
    return "; ".join(f"{name[:70]} {us / 1e3:.2f} ms"
                     for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def busy_share(device, what):
    """The device's busy time (the union of its activities' intervals)
    against the span from the first one's start to the last one's end."""
    check(len(device) > 0, f"{what}: the profiler saw no device activity")
    spans = sorted((start, end) for _, start, end in device)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - spans[0][0]
    return (f"{len(device)} device activities, busy {busy / 1e3:.2f} ms of a {span / 1e3:.2f} "
            f"ms span (idle {100 * (1 - busy / span):.1f}%)")


@torch.inference_mode()
def device_profile(synth, video, lengths, card, what):
    """One forward under ``torch.profiler``: the device's busy time (the
    union of its activities' intervals) against the span from the first
    one's start to the last one's end, and the kernels that take the most
    time; then the stem alone.  The profiler slows the host, so the idle
    share is an upper bound.  The kernel launches counted in it
    (``attention.launches``, ``fused_block.launches``, ``stem.launches``)
    must be those the profiler saw; a forward runs before it, in a cycle
    of the session whose events are dropped."""
    names_counted = ("attention.launches", "fused_block.launches", "stem.launches",
                     "griffin_lim.launches")
    counted = []

    def forward():
        before = [count_of(n) for n in names_counted]
        synth(video, lengths)
        counted.extend(count_of(n) - b for n, b in zip(names_counted, before))

    device, _ = profiled(forward, warmup=lambda: synth(video, lengths))
    names = kernel_names(device)
    seen = (sum(n in ATTENTION_KERNELS for n in names), names.count("fused_block_kernel"),
            names.count("fused_stem_kernel"), gl_launches_seen(names))
    counted = tuple(counted)
    check(seen == counted and seen[0] >= 2, f"{what}: one forward's launches counted "
          f"{counted} (attention, fused block, stem, Griffin-Lim), the profiler saw {seen}")
    print(f"profile of one {what} B={video.shape[0]} forward [{card}]: "
          f"{busy_share(device, what)}; most time: {most_time(device)}")
    stem, _ = profiled(lambda: synth.v_front.stem(video))
    print(f"profile of the stem alone ({what}) [{card}]: {most_time(stem, top=5)}")


def phase_bench(card):
    """``python3 -m vcagan_torch.bench --fold-bn-fused`` (bf16, the path of
    every kernel; phase 5 times the unfolded one) must print one JSON line
    with the four keys."""
    run = subprocess.run([sys.executable, "-m", "vcagan_torch.bench", "--fold-bn-fused"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"vcagan_torch.bench --fold-bn-fused failed:\n{run.stderr[-4000:]}")
    last = run.stdout.strip().splitlines()[-1]
    line = json.loads(last)
    check(set(line) == {"metric", "value", "unit", "vs_baseline"}, f"bench line {last}")
    print(f"vcagan_torch.bench --fold-bn-fused [{card}]: {last}")


def phase_train_attention(card):
    """(a) The attention as the train step runs it: through its
    ``autograd.Function`` (forward by the kernel, backward by the plain
    version's autograd) at the GRID training shapes, ragged lengths
    (1 and S among them).  Returns the worst gradient error against
    float64."""
    rng = np.random.default_rng(8)
    worst = 0.0
    for i, (name, b, t, s_, d) in enumerate((("att1", 88, 40, 40, 256), ("att2", 88, 80, 40, 256))):
        lengths = rng.integers(1, s_ + 1, b)
        lengths[:2] = (1, s_)
        q, k, v, lens = attention_inputs(b, t, s_, d, lengths, seed=200 + i)
        grad = torch.randn(b, t, d, generator=torch.Generator(device="cuda").manual_seed(9),
                           device="cuda")
        leaves = [x.requires_grad_() for x in (q, k, v)]
        out = attn.masked_cross_attention(*leaves, lens)
        check(isinstance(out.grad_fn, attn.MaskedAttention._backward_cls),
              f"{name}: the attention did not go through its autograd.Function")
        got = torch.autograd.grad(out, leaves, grad)
        plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        want = attn.masked_attention_reference(*plain, lens)
        want_grads = torch.autograd.grad(want, plain, grad)
        wide = [x.detach().double().requires_grad_() for x in (q, k, v)]
        want64 = attn.masked_attention_reference(*wide, lens)
        want64_grads = torch.autograd.grad(want64, wide, grad.double())
        torch.cuda.synchronize()
        err = (out.detach() - want.detach()).abs().max().item()
        err64 = (out.detach().double() - want64.detach()).abs().max().item()
        check(err < ATTN_TOL and err64 < ATTN_TOL,
              f"train {name}: forward vs plain {err:.3e}, vs float64 {err64:.3e}")
        errs = []
        for gname, g, w, w64 in zip(("dq", "dk", "dv"), got, want_grads, want64_grads):
            check(torch.isfinite(g).all().item(), f"train {name} {gname}: non-finite")
            e, e64 = (g - w).abs().max().item(), (g.double() - w64).abs().max().item()
            check(torch.allclose(g.double(), w64, rtol=ATTN_GRAD_TOL, atol=ATTN_GRAD_TOL),
                  f"train {name} {gname}: vs float64 max abs err {e64:.3e}")
            check(torch.allclose(g, w, rtol=ATTN_GRAD_TOL, atol=ATTN_GRAD_TOL),
                  f"train {name} {gname}: vs plain max abs err {e:.3e}")
            errs.append(f"{gname} {e:.3e} (vs float64 {e64:.3e})")
            worst = max(worst, e64)
        in_err = None if attn.instance(attn.attention_plan(t, s_, d, b)) == "in_block" else (
            check_in_block(f"train {name}", q.detach(), k.detach(), v.detach(), lens))
        print(f"train attention {name} B={b} T={t} S={s_} D={d} ragged: forward vs plain "
              f"{err:.3e} (vs float64 {err64:.3e})"
              + ("" if in_err is None else f", the in-block instance forced {in_err:.3e}")
              + f"; gradients vs plain: {', '.join(errs)} ok")
    return worst


def train_batch(b, w, seed, device):
    """A GRID-shaped batch made with numpy: video (B, W, 112, 112, 1), mel
    (B, 80, 4W) in [-1, 1], spec (B, 321, 4W) >= 0, ragged lengths."""
    rng = np.random.default_rng(seed)
    hw = DataConfig().crop_size
    vid_len = np.full(b, w, np.int32)
    vid_len[1::2] = w - 7
    return Batch(
        video=torch.from_numpy(rng.standard_normal((b, w, hw, hw, 1), np.float32)),
        mel=torch.from_numpy(np.clip(rng.standard_normal((b, 80, 4 * w), np.float32), -1, 1)),
        spec=torch.from_numpy(np.abs(rng.standard_normal((b, 321, 4 * w), np.float32))),
        vid_len=torch.from_numpy(vid_len), mel_len=torch.from_numpy(4 * vid_len),
    ).to(device)


class FixedNoiseDecoder(Decoder):
    """The decoder with a given noise tensor, whatever the step draws: the
    card's and the CPU's generators give other numbers."""

    def __init__(self, config, noise):
        super().__init__(config)
        self.register_buffer("fixed_noise", noise, persistent=False)

    def forward(self, sent, phon, lengths, noise=None, generator=None):
        return super().forward(sent, phon, lengths, noise=self.fixed_noise)


def one_step(device, config, noise, batch, bf16=()):
    """One train step from the weights of seed 0 with the given noise, the
    modules named in ``bf16`` computing in bf16; returns the state and the
    metrics as floats."""
    half = dataclasses.replace(config, use_bfloat16=True)
    modules = VCAGANModules.create(config, seed=0)
    if bf16:
        in_bf16 = VCAGANModules.create(half, seed=0)
        modules = dataclasses.replace(modules, **{n: getattr(in_bf16, n) for n in bf16})
    gen = FixedNoiseDecoder(half if "gen" in bf16 else config, noise)
    gen.load_state_dict(modules.gen.state_dict())
    modules = dataclasses.replace(modules, gen=gen)
    state, g_tx, d_tx = create_train_state(modules, TrainConfig(), device=device)
    step = make_train_step(modules, g_tx, d_tx, TrainConfig())
    state, metrics = step(state, batch.to(device), torch.Generator(device).manual_seed(0))
    return state, {k: v.item() for k, v in metrics.items()}


def first_moments(state):
    """Each module's first moment after a step, flat on the CPU, by name."""
    out = {}
    for side, opt in ((GENERATOR_SIDE, state.g_opt_state), (DISCRIMINATOR_SIDE, state.d_opt_state)):
        first = 0
        for name in side:
            n = len(list(getattr(state.modules, name).parameters()))
            out[name] = torch.cat([m.flatten().cpu() for m in opt.mu[first:first + n]])
            first += n
    return out


def rel_l2(a, b):
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def moment_readings(card_m, cpu_m, card_f, cpu_f):
    """A module's bf16 first moments on the card and the CPU against each
    device's fp32 one, as shares of the CPU's fp32 norm: (cross, the CPU's
    spread, the card's, alpha on the card - alpha on the CPU)."""
    card_m, cpu_m, card_f, cpu_f = (t.double() for t in (card_m, cpu_m, card_f, cpu_f))
    norm = torch.linalg.vector_norm(cpu_f)
    alpha = card_m @ card_f / (card_f @ card_f) - cpu_m @ cpu_f / (cpu_f @ cpu_f)
    return tuple(float(x) for x in (torch.linalg.vector_norm(card_m - cpu_m) / norm,
                                    torch.linalg.vector_norm(cpu_m - cpu_f) / norm,
                                    torch.linalg.vector_norm(card_m - card_f) / norm, alpha))


def phase_train_card_vs_cpu(card, run=None, fp32_moments=None):
    """(b) One full-width step on the card and on the CPU (plain versions of
    the kernels), the same initial weights, batch and noise, dropout rates
    0: losses and metrics, each module's gradient (relative L2; from the
    first moment, (1 - b1) (g + wd p) after one step), the update (against
    lr) and the BatchNorm statistics.  With ``run``, a key of ``BF16_RUNS``
    (phase 10 (b)), its modules compute in bf16 and the bounds are the CPU
    test's for bf16 against the JAX package (``BF16_BOUNDS``), the fp32
    moments ``fp32_moments`` (this phase's fp32 run) the anchors; the
    updates are not compared.  Returns the first moments of both devices."""
    b, w = 2, TRAIN_WINDOW
    config = ModelConfig(gru_dropout=0.0, frontend_dropout=0.0)
    bf16 = BF16_RUNS[run] if run else ()
    batch = train_batch(b, w, seed=3, device="cpu")
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((b, 20, w, 128),
                                                                      np.float32))
    start = VCAGANModules.create(config, seed=0)  # the initial weights, for the updates
    reset_launches()
    card_state, card_m = one_step("cuda", config, noise.cuda(), batch, bf16)
    check_calls(2, 0, "card step")
    t0 = time.perf_counter()
    cpu_state, cpu_m = one_step("cpu", config, noise, batch, bf16)
    mode = run or "fp32"
    print(f"train step {mode} card vs CPU, B={b} x {w} frames, 112x112, full width (the CPU "
          f"step {time.perf_counter() - t0:.1f} s):")
    for k, want in cpu_m.items():
        got = card_m[k]
        norm = k in ("r1", "g_grad_norm", "d_grad_norm")
        if run:
            rtol = BF16_STEP_NORM_RTOL if k in ("g_grad_norm", "d_grad_norm") else BF16_STEP_LOSS_RTOL
        else:
            rtol = STEP_NORM_RTOL if norm else STEP_LOSS_RTOL
        rel = abs(got - want) / max(abs(want), 1e-12)
        print(f"  {k}: card {got:.7g}, CPU {want:.7g}, relative {rel:.2e} (bound {rtol:g})")
        check(np.isfinite(got) and rel <= rtol, f"train step {mode} {k}: card {got} vs CPU {want}")
    lr = TrainConfig().lr
    moments = {"card": first_moments(card_state), "cpu": first_moments(cpu_state)}
    for name in GENERATOR_SIDE + DISCRIMINATOR_SIDE:
        card_mod, cpu_mod = getattr(card_state.modules, name), getattr(cpu_state.modules, name)
        grad_rel = rel_l2(moments["card"][name], moments["cpu"][name])
        stats = [(k, v) for k, v in cpu_mod.state_dict().items() if "running" in k]
        stats_rel = stats_max = 0.0
        if stats:
            start_sd, card_sd = start.state_dicts()[name], card_mod.state_dict()
            moved = torch.cat([(v - start_sd[k]).flatten() for k, v in stats])
            off = torch.cat([(card_sd[k].cpu() - v).flatten() for k, v in stats])
            stats_rel = (torch.linalg.vector_norm(off) / torch.linalg.vector_norm(moved)).item()
            stats_max = off.abs().max().item()
        if run:
            cross, spread, own, alpha = moment_readings(
                moments["card"][name], moments["cpu"][name], fp32_moments["card"][name],
                fp32_moments["cpu"][name])
            k, (least, most), alpha_max = BF16_BOUNDS[run]
            print(f"  {name}{' (bf16)' if name in bf16 else ''}: gradient cross {cross:.3e}, "
                  f"the CPU's spread {spread:.3e}, the card's {own:.3e} (cross {cross / spread:.3f}"
                  f" x the spread, bound {k:g}; the card's {own / spread:.3f} x, bounds {least:g}-"
                  f"{most:g}), alpha card - CPU {alpha:+.2e} (bound {alpha_max:g}); BatchNorm "
                  f"statistics {stats_rel:.2e} of their move, at most {stats_max:.2e} apart")
            check(cross <= k * spread, f"train step {mode} {name}: gradient {cross:.3e}")
            check(least * spread <= own <= most * spread,
                  f"train step {mode} {name}: the card's gradient {own:.3e} from fp32")
            check(abs(alpha) <= alpha_max, f"train step {mode} {name}: alpha {alpha:+.3e}")
            check(stats_rel <= BF16_STATS_REL and stats_max <= BF16_STATS_MAX,
                  f"train step {mode} {name}: statistics {stats_rel:.3e}, {stats_max:.3e}")
            continue
        before = start.parameters([name])
        up_card = torch.cat([(p.detach().cpu() - p0).flatten()
                             for p, p0 in zip(card_mod.parameters(), before)])
        up_cpu = torch.cat([(p.detach() - p0).flatten()
                            for p, p0 in zip(cpu_mod.parameters(), before)])
        diff = (up_card - up_cpu).abs() / lr
        worst, flipped = diff.max().item(), (diff > 0.5).float().mean().item()
        print(f"  {name}: gradient relative L2 {grad_rel:.2e} (bound {STEP_GRAD_REL:g}); "
              f"update worst {worst:.3f} lr, share over lr/2 {flipped:.2e} (bound "
              f"{STEP_FLIP_SHARE:g}); BatchNorm statistics {stats_rel:.2e} of their move")
        check(grad_rel <= STEP_GRAD_REL, f"train step {name}: gradient {grad_rel:.3e}")
        check(flipped <= STEP_FLIP_SHARE,
              f"train step {name}: update worst {worst:.3f} lr, share {flipped:.3e}")
        check(stats_rel <= STEP_STATS_REL, f"train step {name}: statistics {stats_rel:.3e}")
    print(f"train step {mode} card vs CPU ok [{card}]")
    return moments


def r1_gradient(device, phase, config, real, sent):
    """A discriminator's R1 gradient, flat on the CPU, from the weights of
    seed 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = Discriminator(phase, config).to(device)
    x = real.to(device).requires_grad_()
    logits, _ = module(x, sent.to(device))
    grads = torch.autograd.grad(r1_penalty(logits, x), list(module.parameters()),
                                allow_unused=True, materialize_grads=True)
    return torch.cat([g.flatten().cpu() for g in grads])


def phase_r1_card_vs_cpu(card):
    """(b) R1's gradient into each discriminator alone, full width, B=2 at
    the GRID window's mel scales, in bf16 on the card against the CPU, each
    device's fp32 gradient its anchor (``BF16_BOUNDS["r1"]``)."""
    rng = np.random.default_rng(5)
    b, w = 2, TRAIN_WINDOW
    sent = torch.from_numpy(rng.standard_normal((b, w, 512), np.float32))
    config = ModelConfig()
    half = dataclasses.replace(config, use_bfloat16=True)
    k, (least, most), alpha_max = BF16_BOUNDS["r1"]
    for phase, (f, t) in zip("123", ((20, w), (40, 2 * w), (80, 4 * w))):
        real = torch.from_numpy(np.clip(rng.standard_normal((b, f, t), np.float32), -1, 1))
        got = {(dev, cfg.use_bfloat16): r1_gradient(dev, phase, cfg, real, sent)
               for dev in ("cuda", "cpu") for cfg in (config, half)}
        cross, spread, own, alpha = moment_readings(
            got["cuda", True], got["cpu", True], got["cuda", False], got["cpu", False])
        print(f"  R1 gradient dis{phase} ({f} x {t} mels) bf16: cross {cross:.3e}, the CPU's "
              f"spread {spread:.3e}, the card's {own:.3e} (cross {cross / spread:.3f} x, bound "
              f"{k:g}; the card's {own / spread:.3f} x, bounds {least:g}-{most:g}), alpha card - "
              f"CPU {alpha:+.2e} (bound {alpha_max:g})")
        check(cross <= k * spread and least * spread <= own <= most * spread
              and abs(alpha) <= alpha_max, f"R1 gradient dis{phase} bf16 card vs CPU")
    print(f"R1 gradients bf16 card vs CPU ok [{card}]")


def phase_train_fixed(card, what, model_config, train_config, batch):
    """A fixed batch on the card at full width, random init from seed 0,
    dropout on, the step's own generator: 2 warm-up steps, then 5 counted
    steps on the same batch with one sync; then one step under
    torch.profiler (busy share, the kernels that take the most time, the
    kernels by call site: ``call_sites``).  Phase 8 (c): the GRID shape, B=88 clips x 40
    frames, fp32; phase 10: the same in bf16, and LRS2 batches.  Returns
    the attention calls of the counted steps and the ms a step."""
    b, w = batch.video.shape[:2]
    modules = VCAGANModules.create(model_config, seed=0)
    marks = []

    def on_phase(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks[-1].append(event)

    state, g_tx, d_tx = create_train_state(modules, train_config, device="cuda")
    step = make_train_step(modules, g_tx, d_tx, train_config, on_phase=on_phase)
    generator = torch.Generator("cuda").manual_seed(0)

    def run(steps):
        out = []
        for _ in range(steps):
            marks.append([])
            on_phase("start")
            out.append(step(state, batch, generator)[1])
        return out

    run(TRAIN_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks.clear()
    reset_launches()
    t0 = time.perf_counter()
    metrics = run(TRAIN_STEPS)
    table = {k: torch.stack([m[k] for m in metrics]).cpu() for k in metrics[0]}  # the one sync
    elapsed = time.perf_counter() - t0
    launches = count_of("attention.calls")
    check_calls(2 * TRAIN_STEPS, 0, f"train {what}, {TRAIN_STEPS} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = elapsed / TRAIN_STEPS * 1e3
    lengths = batch.vid_len.tolist()
    print(f"train {what} B={b} x {w} frames (vid_len {min(lengths)}-{max(lengths)}), 112x112: "
          f"{ms:.1f} ms a step, {b * TRAIN_STEPS / elapsed:.2f} clips/s, "
          f"{b * 4 * w * TRAIN_STEPS / elapsed:.1f} mel-frames/s trained, peak {peak_gb:.2f} GB, "
          f"{launches / TRAIN_STEPS:g} attention calls a step ({TRAIN_STEPS} counted steps "
          f"after {TRAIN_WARMUP} warm-ups, one sync) [{card}]")
    parts = {name: statistics.median(m[i].elapsed_time(m[i + 1]) for m in marks)
             for i, name in enumerate(TRAIN_PHASES)}
    print(f"train {what} step parts (median of {TRAIN_STEPS} steps, CUDA events) [{card}]: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
          + f"; D phase {parts['d_loss'] + parts['d_backward']:.2f} ms, G phase "
          f"{parts['g_loss'] + parts['g_backward']:.2f} ms, sum {sum(parts.values()):.2f} ms")
    for k, v in table.items():
        check(bool(torch.isfinite(v).all()), f"train {what} metric {k} not finite: {v.tolist()}")
        print(f"train {what} metric {k}: " + ", ".join(f"{x:.6g}" for x in v.tolist()))
    recon = table["recon_loss"]
    check(recon[-1] < recon[0],
          f"train {what}: recon_loss did not fall over the counted steps: {recon.tolist()}")
    # one more step under the profiler (it slows the host: the idle share is an upper bound)
    tracing.read()
    with tracing.enabled(device_events=False):
        device, prof = profiled(lambda: run(1), record_shapes=True)
    print(f"profile of one train step {what} B={b} [{card}]: {busy_share(device, 'train step')}; "
          f"most time: {most_time(device, top=12)}")
    call_sites(prof, tracing.read()["counters"], what, model_config.use_bfloat16, card)
    return launches, ms


def phase_train_grid(card, bf16=False):
    """(c) The GRID training shape on the card: B=88 clips x 40 frames,
    112x112, fp32 (phase 10 (b): bf16)."""
    return phase_train_fixed(card, f"GRID {'bf16' if bf16 else 'fp32'}",
                             ModelConfig(use_bfloat16=bf16), TrainConfig(),
                             train_batch(TRAIN_BATCH, TRAIN_WINDOW, seed=5, device="cuda"))


def host_ranges(prof):
    """The program's host ranges (``vcagan.*``: the spans of
    ``vcagan_torch.tracing``, on in ``Trainer.fit``'s profiled stretch: the
    loop's ``LOOP_RANGES``, the input pipeline's and the step's) as (name,
    start us, end us), in order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(tracing.PREFIX)
                   and e.device_type != _cuda_device_type()), key=lambda r: r[1])


def _cuda_device_type():
    from torch.autograd import DeviceType
    return DeviceType.CUDA


def device_activities(prof):
    """Kernels and copies as (name, start us, end us); the host ranges'
    mirrors on the device timeline are left out."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == _cuda_device_type() and not e.name.startswith(tracing.PREFIX)]


def idle_gaps(device, ranges, top=5):
    """The ``top`` longest stretches with no device activity, each with the
    innermost host range (or "between ranges") open when it began."""
    spans = sorted((a, b) for _, a, b in device)
    gaps, end = [], spans[0][1]
    for a, b in spans[1:]:
        if a > end:
            gaps.append((a - end, end))
        end = max(end, b)
    gaps.sort(reverse=True)
    out = []
    for length, start in gaps[:top]:
        inside = [(b - a, n) for n, a, b in ranges if a <= start < b]
        label = min(inside)[1] if inside else "between ranges"
        out.append(f"{length / 1e3:.2f} ms in {label}")
    return ", ".join(out)


def loop_config(tmp, batches, **overrides):
    """The GRID recipe over the synthetic clips (no corpus at the missing
    root): ``batches`` batches of 88 clips an epoch, validation once an
    epoch (no fit below reaches an epoch's end)."""
    return grid_config(**{
        "data.data_root": os.path.join(tmp, "no_corpus"),
        "data.synthetic_clips": batches * TRAIN_BATCH,
        "train.batch_size": TRAIN_BATCH,
        "train.eval_step": 0,
        "train.checkpoint_dir": os.path.join(tmp, "ckpt"),
        **overrides,
    })


def train_lines(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [r for r in lines if "train/gen_loss" in r]


def phase_trainer_fit(card, fixed_step_ms, tmp, config=None, what="GRID fp32"):
    """(c) ``Trainer.fit`` at the GRID recipe on the card (phase 10 (d):
    ``config`` the LRS2 recipe).  Returns the trainer and the attention
    calls of the fit."""
    config = config or loop_config(tmp, LOOP_BATCHES)
    b, w = config.train.batch_size, config.data.window_size
    log_dir = os.path.join(tmp, "log")
    t0 = time.perf_counter()
    trainer = Trainer(config, log_dir=log_dir)
    check(trainer.device.type == "cuda", f"the Trainer runs on {trainer.device}")
    check(trainer.steps_per_epoch == LOOP_BATCHES, f"{trainer.steps_per_epoch} steps an epoch")
    print(f"trainer: built in {time.perf_counter() - t0:.1f} s (modules, state on the card, "
          f"{len(trainer.train_ds)} synthetic clips, rendered on first use) [{card}]")
    # A CUDA event before each step's input pipeline and one after each
    # step that fit queues: the device time between two step ends is the
    # loop's pace, idle time included, and a start more than LOOP_IDLE_MS
    # after the step before it ended is a wait on the feed (the batch's
    # copy and the readback take about 2 ms).  (The metric stream's
    # step_seconds time the readbacks, which fit places a step late.)
    starts, ends = [], []
    step_fn, pipe_fn = trainer.train_step, trainer.process_train

    def stamp(events):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def stamped_pipeline(*args):
        stamp(starts)
        return pipe_fn(*args)

    def stamped_step(*args):
        out = step_fn(*args)
        stamp(ends)
        return out

    trainer.train_step, trainer.process_train = stamped_step, stamped_pipeline
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = LOOP_BATCHES
    t0 = time.perf_counter()
    check(trainer.fit(epochs=1, max_steps=steps) == steps, "fit stopped early")
    elapsed = time.perf_counter() - t0
    trainer.train_step, trainer.process_train = step_fn, pipe_fn
    launches = count_of("attention.calls")
    check_calls(2 * steps, 0, f"fit, {steps} steps")
    lines = train_lines(log_dir)
    check([r["step"] for r in lines] == list(range(1, steps + 1)), "fit's metric lines")
    for r in lines:
        check(all(np.isfinite(v) for k, v in r.items() if k.startswith("train/")),
              f"fit metrics not finite: {r}")
    check(len(starts) == len(ends) == steps, f"{len(starts)} starts, {len(ends)} ends stamped")
    # idle[k]: device ms between step k's end and step k + 1's start (0-based)
    idle = [a.elapsed_time(b_) for a, b_ in zip(ends, starts[1:])]
    step_ms = [a.elapsed_time(b_) for a, b_ in zip(ends, ends[1:])]  # steps 2, 3, ...
    fed = [k for k in range(LOOP_WARMUP, steps) if idle[k - 1] > LOOP_IDLE_MS]
    if fed and fed[0] + LOOP_STEPS <= steps:  # feed-bound from the first wait on
        first_counted = fed[0]
        regime = ("feed-bound: from the first step after the warm-ups before which the "
                  "device waited on the feed")
    else:  # the step binds (the queue stays full), or the feed began to bind late
        first_counted = steps - LOOP_STEPS
        regime = ("the last steps: the device never waited on the feed after the warm-ups"
                  if not fed else f"the last steps: the device first waited on the feed "
                  f"before step {fed[0] + 1}")
    counted = list(range(first_counted, first_counted + LOOP_STEPS))
    counted_ms = step_ms[counted[0] - 1:counted[-1]]
    pace_ms = sum(counted_ms) / len(counted)
    waits = [1e3 * x for x in trainer.queue_wait_s]
    collate = [1e3 * x for x in trainer.collate_s]
    collate_ms = statistics.mean(collate[k] for k in counted)
    idle_ms = sum(idle[k - 1] for k in counted)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"trainer fit {what} B={b} x {w} frames: {pace_ms:.1f} ms a step (loop pace over "
          f"{len(counted)} counted steps, steps {counted[0] + 1}-{counted[-1] + 1} of {steps}, "
          f"{regime}; CUDA events at each step's start and end), "
          f"{b * len(counted) / sum(counted_ms) * 1e3:.2f} clips/s; the producer's collate of the "
          f"same batches {collate_ms:.1f} ms a batch; the fixed-batch step "
          f"{fixed_step_ms:.1f} ms, so the loop is {pace_ms / fixed_step_ms:.3f}x it; device idle "
          f"before the counted steps {idle_ms:.1f} ms of {sum(counted_ms):.1f} "
          f"({100 * idle_ms / sum(counted_ms):.1f}%); whole fit {elapsed:.1f} s for {steps} "
          f"steps; peak {peak_gb:.2f} GB; {launches / steps:g} attention calls a step [{card}]")
    print(f"trainer feed, first epoch (each clip rendered on first use): collate ms a batch "
          f"(producer thread, {trainer.config.train.workers} decode workers) "
          + ", ".join(f"{x:.1f}" for x in collate)
          + "; queue wait ms a step (consumer) " + ", ".join(f"{x:.1f}" for x in waits)
          + f"; counted steps wait {sum(waits[k] for k in counted):.1f} ms [{card}]")
    print("trainer device ms from each step's end to the next (steps 2 on): "
          + ", ".join(f"{x:.1f}" for x in step_ms) + "; device idle ms before each step "
          "(steps 2 on): " + ", ".join(f"{x:.1f}" for x in idle)
          + "; metric stream step_seconds (ms): "
          + ", ".join(f"{1e3 * r['train/step_seconds']:.1f}" for r in lines))

    # Three more steps under the profiler: a new epoch (the clips cached);
    # the profile starts after its first step, so the epoch's first wait
    # stays out of it.
    first = steps + 1
    t0 = time.perf_counter()
    trainer.fit(epochs=1, max_steps=first + LOOP_PROFILED,
                profile_steps=(first, first + LOOP_PROFILED),
                profile_dir=os.path.join(tmp, "profile"))
    prof = trainer.last_profile
    check(prof is not None, "fit kept no profile")
    device, ranges = device_activities(prof), host_ranges(prof)
    loop = sum(n in LOOP_RANGES for n, _, _ in ranges)
    check(loop >= 3 * LOOP_PROFILED, f"{loop} of the loop's host ranges in the profile")
    parts = sum(n == tracing.PREFIX + "train.d_backward" for n, _, _ in ranges)
    check(parts == LOOP_PROFILED, f"{parts} train.d_backward ranges in {LOOP_PROFILED} steps")
    by_range = {name: sum(b_ - a for n, a, b_ in ranges if n == name) / 1e3
                for name in LOOP_RANGES}
    print(f"profile of {LOOP_PROFILED} fit steps (second epoch, clips cached; "
          f"{time.perf_counter() - t0:.1f} s with the profiler) [{card}]: "
          f"{busy_share(device, 'fit')}; host ms in each range: "
          + ", ".join(f"{k} {v:.1f}" for k, v in by_range.items())
          + f"; longest idle gaps: {idle_gaps(device, ranges)}; queue waits (ms) "
          + ", ".join(f"{1e3 * x:.1f}" for x in trainer.queue_wait_s))
    return trainer, launches


def phase_trainer_validate(card, trainer):
    """(d) One validation batch at B=88 x 75 through ``validate``, then its
    parts on the same batch, each timed apart.  Returns its attention
    calls."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logs = trainer.validate(fast=False, max_batches=1)
    elapsed = time.perf_counter() - t0
    launches = count_of("attention.calls")
    check_calls(2, 0, "validate")
    check(all(np.isfinite(x) for x in logs) and logs[0] > 0, f"validate returned {logs}")
    print(f"trainer validate, one batch B={TRAIN_BATCH} x {DataConfig().max_v_timesteps} frames: "
          f"{elapsed:.2f} s (first call; its clips rendered in fit: the val set shares the synthetic source), l1 {logs[0]:.4f}, stoi "
          f"{logs[1]:.4f}, estoi {logs[2]:.4f}, pesq {logs[3]:.4f}; {launches} attention "
          f"calls [{card}]")

    from vcagan_torch.dsp.griffin_lim import random_phase
    from vcagan_torch.eval.pesq_nb import pesq_batch
    raw = next(trainer._val_ds.epoch(TRAIN_BATCH, shuffle=False, drop_last=False))
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t
        return out

    with torch.no_grad():
        batch = timed("copy + input pipeline", lambda: trainer.process_eval(raw))
        g3, gs = timed("eval forward", lambda: trainer.eval_step(batch.video, batch.vid_len,
                                                                 trainer.generator))
        spec, mel_in = gs.transpose(1, 2), g3.transpose(1, 2)
        phase = random_phase(spec.shape, trainer.generator, spec.device)
        wav = timed("Griffin-Lim (postnet)", lambda: trainer.pipeline.inverse_spec(
            spec, init_phase=phase))
        wav_mel = timed("Griffin-Lim (mel)", lambda: trainer.pipeline.inverse_mel(
            mel_in, init_phase=phase))
        gt = torch.as_tensor(raw["wav"], device="cuda")[:, : wav.shape[1]]
        timed("STOI/ESTOI on the card, both paths", lambda: [
            stoi_estoi_batch(gt, x) for x in (wav, wav_mel[:, : gt.shape[1]])])
        gt_host = gt.cpu().numpy()
        hosts = [x.cpu().numpy() for x in (wav, wav_mel[:, : gt.shape[1]])]
        timed("PESQ on the host, both paths", lambda: [pesq_batch(gt_host, h, fs=16_000)
                                                       for h in hosts])
    print(f"trainer validation batch parts, timed apart (s) [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return launches


def phase_trainer_pipeline(card, trainer):
    """(a) The input pipeline on the card against the CPU on one B=88 raw
    batch of the trainer's clips, without and with augmentation (the same
    draws); its time on the card, and the raw batch's copy."""
    dataset = GridDataset(trainer.train_ds.source, AudioConfig(), DataConfig(), "train", seed=9)
    raw = next(dataset.epoch(TRAIN_BATCH))
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in raw.items() if v.ndim}
    on_card = {k: v.to("cuda", non_blocking=True) for k, v in pinned.items()}
    nbytes = sum(v.numel() * v.element_size() for v in pinned.values())
    worst = {}
    for augment in (False, True):
        card_proc = make_device_pipeline(augment=augment)
        cpu_proc = make_device_pipeline(augment=augment, device="cpu")
        draws = augment_draws(TRAIN_BATCH, torch.Generator("cuda").manual_seed(4), "cuda")
        got = card_proc(on_card, draws=draws)
        want = cpu_proc(raw, draws=type(draws)(*(d.cpu() for d in draws)))
        for name, tol in (("video", (0.0, PIPE_VIDEO_TOL)), ("spec", PIPE_SPEC_TOL),
                          ("mel", (0.0, PIPE_MEL_TOL))):
            g, w_ = getattr(got, name).cpu(), getattr(want, name)
            check(torch.isfinite(g).all().item(), f"pipeline {name}: non-finite")
            err = (g - w_).abs().max().item()
            worst[(augment, name)] = err
            check(torch.allclose(g, w_, rtol=tol[0], atol=tol[1]),
                  f"pipeline augment={augment} {name}: card vs CPU max abs err {err:.3e}")
        for name in ("vid_len", "mel_len"):
            check(torch.equal(getattr(got, name).cpu(), getattr(want, name)), f"pipeline {name}")
    gen = torch.Generator("cuda").manual_seed(5)
    proc = trainer.process_train
    ms = time_ms(lambda: proc(on_card, gen), samples=5, calls=4, warmup=1)
    copy_ms = time_ms(lambda: {k: v.to("cuda", non_blocking=True) for k, v in pinned.items()},
                      samples=5, calls=4, warmup=1)
    print(f"input pipeline B={TRAIN_BATCH} x {TRAIN_WINDOW} frames, card vs CPU: "
          + ", ".join(f"{'augmented' if a else 'plain'} {n} {e:.3e}" for (a, n), e in worst.items())
          + f" ok; on the card {ms:.3f} ms a batch (augmented, CUDA events), the pinned raw "
          f"batch's copy ({nbytes / 1e6:.1f} MB) {copy_ms:.3f} ms [{card}]")


def phase_trainer_stoi(card, trainer):
    """(b) STOI/ESTOI on the card against the numpy STOI (float64) on 8
    waveforms: the trainer's ground-truth windows against noisy copies."""
    dataset = GridDataset(trainer.train_ds.source, AudioConfig(), DataConfig(), "val", seed=0)
    clean = next(dataset.epoch(8, shuffle=False, drop_last=False))["wav"]
    rng = np.random.default_rng(6)
    noisy = (clean + rng.standard_normal(clean.shape).astype(np.float32)
             * np.linspace(0.01, 0.3, 8, dtype=np.float32)[:, None] * clean.std()).astype(np.float32)
    s, e = (x.cpu().numpy() for x in stoi_estoi_batch(torch.from_numpy(clean).cuda(),
                                                      torch.from_numpy(noisy).cuda()))
    want_s = np.asarray([stoi_np.stoi_np(c, n, fs=16_000) for c, n in zip(clean, noisy)])
    want_e = np.asarray([stoi_np.estoi_np(c, n, fs=16_000) for c, n in zip(clean, noisy)])
    err_s, err_e = np.abs(s - want_s).max(), np.abs(e - want_e).max()
    check(err_s < STOI_TOL and err_e < STOI_TOL,
          f"STOI card vs numpy: stoi {err_s:.3e}, estoi {err_e:.3e}")
    print(f"STOI/ESTOI on the card vs numpy, 8 waveforms of {clean.shape[1]} samples: stoi "
          + ", ".join(f"{x:.4f}" for x in s) + f" (max err {err_s:.2e}); estoi "
          + ", ".join(f"{x:.4f}" for x in e) + f" (max err {err_e:.2e}) ok [{card}]")


def phase_trainer_checkpoint(card, trainer):
    """(e) Save the trainer's state and generator on the card, overwrite
    every tensor and draw from the generator, restore: every tensor and
    the generator's state as saved, bit for bit."""
    def tensors(state):
        out = [t for sd in state.modules.state_dicts().values() for t in sd.values()]
        for opt in (state.g_opt_state, state.d_opt_state):
            out += opt.mu + opt.nu + (opt.nu_max or [])
        return out

    state = trainer.state
    t0 = time.perf_counter()
    path = trainer.ckpt.save(state, 0, stoi=0.5, estoi=0.5, pesq=2.0,
                             generator=trainer.generator)
    save_s = time.perf_counter() - t0
    saved = [t.clone() for t in tensors(state)]
    saved_gen = trainer.generator.get_state()
    torch.rand(8, device=trainer.device, generator=trainer.generator)
    counts = (state.step, state.g_opt_state.count, state.d_opt_state.count)
    with torch.no_grad():
        for t in tensors(state):
            t.add_(1) if t.is_floating_point() else t.add_(3)
    state.step, state.g_opt_state.count, state.d_opt_state.count = 0, 0, 0
    t0 = time.perf_counter()
    trainer.ckpt.restore(state, path, generator=trainer.generator)
    restore_s = time.perf_counter() - t0
    back = tensors(state)
    check(all(t.device.type == "cuda" for t in back), "restored off the card")
    check(len(back) == len(saved) and all(torch.equal(a, b) for a, b in zip(back, saved)),
          "checkpoint: a restored tensor differs")
    check((state.step, state.g_opt_state.count, state.d_opt_state.count) == counts,
          "checkpoint: step or optimizer counts differ")
    check(torch.equal(trainer.generator.get_state(), saved_gen),
          "checkpoint: the generator's state differs")
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    print(f"checkpoint on the card: {len(saved)} tensors, {size / 1e9:.2f} GB, saved in "
          f"{save_s:.1f} s, restored in {restore_s:.1f} s, bit for bit ok (and the generator's state); Best_* "
          f"{os.path.basename(trainer.ckpt.best() or '')} [{card}]")


# Phase 9 (f) and 10 (d): the two training CLIs, "{tmp}" their own
# directory, 2 steps each after the pre-train validation.
CLI_RUNS = (("vcagan_torch.cli.train", ["--grid", "{tmp}/no_corpus", "--batch_size", "8",
                                        "--eval_step", "0", "--remat", "stem,r1",
                                        "--d_phase", "batched"]),
            ("vcagan_torch.cli.train_lrs", ["--data", "{tmp}/no_corpus", "--bf16"]))


def run_clis(runs, what, card):
    """Run (module, argv, directory) CLIs as subprocesses at once, on the
    card; check each ends with 0 and return their output lines, in order."""
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for module, args, own in runs:
            os.makedirs(own, exist_ok=True)
            with open(os.path.join(own, "out"), "w") as out, \
                    open(os.path.join(own, "err"), "w") as err:
                procs.append(subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                                              stdout=out, stderr=err, text=True))
        for (module, args, own), proc in zip(runs, procs):
            code = proc.wait(timeout=600)
            with open(os.path.join(own, "err")) as f:
                check(code == 0, f"{module} failed:\n{f.read()[-4000:]}")
            with open(os.path.join(own, "out")) as f:
                outs.append(f.read().strip().splitlines())
            print(f"python3 -m {module} {' '.join(args)}: done {time.perf_counter() - t0:.1f} s "
                  f"after the {what} started [{card}]")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def phase_clis(card):
    """Phase 9 (f) and 10 (d): ``python3 -m vcagan_torch.cli.train`` (B=8,
    with phase 15 (c)'s ``--remat stem,r1 --d_phase batched``) and
    ``python3 -m vcagan_torch.cli.train_lrs --bf16`` (its recipe's B=16) on
    the card (their default device) as a user runs them, both at
    once, so that their start-ups overlap (they share the card and the
    host's cores: neither's time is a pace); each metric stream must hold
    2 train lines."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        runs = []
        for module, args in CLI_RUNS:
            own = os.path.join(tmp, module.rsplit(".", 1)[1])
            runs.append((module, [a.replace("{tmp}", own) for a in args] + [
                "--max_steps", "2", "--epochs", "1", "--checkpoint_dir", os.path.join(own, "ckpt"),
                "--log_dir", os.path.join(own, "log")], own))
        outs = run_clis(runs, "two training CLIs", card)
        for (module, _, own), out in zip(runs, outs):
            lines = train_lines(os.path.join(own, "log"))
            check(len(lines) == 2, f"{module}'s metric stream holds {len(lines)} train lines, not 2")
            check("Finishing training" in out, f"{module} printed {out[-3:]}")
            print(f"{module}: {out[0]}, 2 train lines (gen_loss "
                  + ", ".join(f"{r['train/gen_loss']:.3f}" for r in lines) + f") ok [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_trainer(card, fixed_step_ms):
    """Phase 9: the Trainer, its validation, input pipeline, STOI and
    checkpoint on the card (its CLI runs in ``phase_clis``).  Returns the attention calls of
    fit's steps and of one validation batch, and the Trainer's generator
    side (CPU copies; phase 12 (e) serves them)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        trainer, fit_launches = phase_trainer_fit(card, fixed_step_ms, tmp)
        val_launches = phase_trainer_validate(card, trainer)
        phase_trainer_pipeline(card, trainer)
        phase_trainer_stoi(card, trainer)
        phase_trainer_checkpoint(card, trainer)
        trained = {name: {k: v.detach().cpu().clone() for k, v in sd.items()}
                   for name, sd in trainer.state.modules.state_dicts().items()
                   if name in GENERATOR_SIDE}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"fit_steps": LOOP_BATCHES, "fit": fit_launches,
            "validation_batch": val_launches}, trained


def attention_work_lengths(b, t, s, d, lengths):
    """(bytes, flops) this run's data needs: q and lengths read and out
    written in full, k and v only in their min(length, S) unmasked rows;
    4 T D flops a valid key (two products)."""
    valid = sum(min(max(int(n), 0), s) for n in lengths)
    return 4 * (2 * b * t * d + 2 * valid * d + b), 4 * t * valid * d


def lrs_raw_batches():
    """The first training batch (50-frame windows, seed 1 as the recipe's
    Trainer draws them) and the first validation batch (the bucket of its
    longest clip) of the LRS2 recipe over LRS_CLIPS synthetic clips: the
    batches that ``Trainer.fit`` and ``validate`` of phase 10 (d) start
    with."""
    source = SyntheticLRSSource(num_clips=LRS_CLIPS)
    cfg = LRS_CONFIG
    train = next(LRSDataset(source, cfg.audio, cfg.data, "train", cfg.train.seed)
                 .epoch(LRS_BATCH))
    val = next(LRSDataset(source, cfg.audio, cfg.data, "val", 0)
               .epoch(LRS_BATCH, shuffle=False, drop_last=False))
    return train, val


def attention_row(card, name, t, s_, d, lengths, seed, side):
    """The attention kernel at (len(lengths), t, s_, d) with these lengths,
    against its plain version and float64, then timed by CUDA-graph replay
    beside its plain version and sdpa, its bound counting the unmasked
    keys only.  Returns the row for the kernels line."""
    b = len(lengths)
    q, k, v, lens = attention_inputs(b, t, s_, d, lengths, seed=seed)
    got = attn.masked_attention_cuda(q, k, v, lens)
    want = attn.masked_attention_reference(q, k, v, lens)
    want64 = attn.masked_attention_reference(q.double(), k.double(), v.double(), lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err64 = (got.double() - want64).abs().max().item()
    check(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
    check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL) and err64 < ATTN_TOL,
          f"{name}: kernel vs plain {err:.3e}, vs float64 {err64:.3e}")
    plan = attn.attention_plan(t, s_, d, b)
    err3x = (got - attention_3xtf32(plan, q, k, v, lens)).abs().max().item()
    check(err3x < ATTN_TOL, f"{name}: kernel vs its 3xTF32 arithmetic {err3x:.3e}")
    in_err = None if attn.instance(plan) == "in_block" else check_in_block(name, q, k, v, lens)
    by_instance = instance_ms(q, k, v, lens, side)
    ms = graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens), side)
    events_ms = time_ms(lambda: attn.masked_attention_cuda(q, k, v, lens))
    plain = graph_ms(lambda: attn.masked_attention_reference(q, k, v, lens), side)
    mask = key_mask(k, lens)
    lib = graph_ms(lambda: sdpa(q, k, v, mask), side)
    nbytes, flops = attention_work_lengths(b, t, s_, d, lengths)
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ATTN_FLOP_PER_S * 1e3
    bound, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
    masked = sum(s_ - min(int(n), s_) for n in lengths)
    print(f"attention {name} B={b} T={t} S={s_} D={d}, lengths {min(lengths)}-"
          f"{max(lengths)} ({masked} of {b * s_} keys masked): max_abs_err {err:.3e} (vs "
          f"float64 {err64:.3e}, vs its 3xTF32 arithmetic {err3x:.3e}"
          + ("" if in_err is None else f", the in-block instance forced {in_err:.3e}")
          + f") ok; kernel {ms:.4f} ms ({attn.instance(plan)}: {plan.describe()}; events "
          f"{events_ms:.4f}), by instance "
          + ", ".join(f"{n} {m:.4f} ms" for n, m in by_instance.items())
          + f"; plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP of the unmasked keys) [{card}]")
    return {"shape": [b, t, s_, d], "masked_keys": masked, "instance": attn.instance(plan),
            "ms": ms, "ms_by_instance": by_instance, "events_ms": events_ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": max(err, err3x, in_err or 0.0)}


def phase_lrs_attention(card, train_len, val_len, val_t):
    """(a) The attention kernel at the LRS shapes with the real lengths of
    the first training and validation batch, against its plain version and
    float64, timed by CUDA-graph replay beside its plain version and sdpa;
    then its ``autograd.Function`` at (16, 50, 50) against float64, the
    masked key and value rows' gradients exactly 0.  Returns the rows for
    the kernels line, the worst forward error and the gradient's."""
    side = torch.cuda.Stream()
    d = 256
    cases = (("train att1", LRS_WINDOW, LRS_WINDOW, train_len),
             ("train att2", 2 * LRS_WINDOW, LRS_WINDOW, train_len),
             ("val att1", val_t, val_t, val_len), ("val att2", 2 * val_t, val_t, val_len))
    rows = [attention_row(card, f"LRS {name}", t, s_, d, lengths, 300 + i, side)
            for i, (name, t, s_, lengths) in enumerate(cases)]
    worst = max(row["max_abs_err"] for row in rows)

    # The gradient as a train step takes it: the Function's backward is the
    # plain version's autograd, where a masked key's softmax weight is exactly 0.
    b, t = len(train_len), LRS_WINDOW
    q, k, v, lens = attention_inputs(b, t, t, d, train_len, seed=310)
    grad = torch.randn(b, t, d, generator=torch.Generator(device="cuda").manual_seed(11),
                       device="cuda")
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = attn.masked_cross_attention(*leaves, lens)
    check(isinstance(out.grad_fn, attn.MaskedAttention._backward_cls),
          "LRS: the attention did not go through its autograd.Function")
    got = torch.autograd.grad(out, leaves, grad)
    wide = [x.detach().double().requires_grad_() for x in (q, k, v)]
    want64 = torch.autograd.grad(attn.masked_attention_reference(*wide, lens), wide,
                                 grad.double())
    masked = torch.arange(t, device="cuda")[None, :] >= lens[:, None].long()  # (B, S)
    check(bool(masked.any()), "LRS: no key of the training batch is masked")
    errs = []
    for gname, g, w64 in zip(("dq", "dk", "dv"), got, want64):
        e64 = (g.double() - w64).abs().max().item()
        check(torch.allclose(g.double(), w64, rtol=ATTN_GRAD_TOL, atol=ATTN_GRAD_TOL),
              f"LRS attention {gname}: vs float64 max abs err {e64:.3e}")
        errs.append(e64)
    for gname, g in (("dk", got[1]), ("dv", got[2])):
        check(bool((g[masked] == 0).all()), f"LRS attention {gname}: a masked row's gradient is not 0")
    print(f"attention LRS train B={b} T=S={t} D={d} through MaskedAttention: dq, dk, dv vs "
          f"float64 {', '.join(f'{e:.3e}' for e in errs)}; the {int(masked.sum())} masked key "
          f"rows' dk and dv exactly 0 ok [{card}]")
    return rows, worst, max(errs)


def phase_lrs_train(card, train_raw):
    """(c) The LRS2 fixed-batch step at full width, B=16 x 50 frames, in fp32
    and bf16, on the first training batch through the LRS input pipeline on
    the card (augmented).  Returns the fp32 step's ms and the launches."""
    process = make_lrs_device_pipeline(LRS_CONFIG.audio, augment=True, device="cuda")
    raw = {k: torch.as_tensor(v).cuda() if np.ndim(v) else v for k, v in train_raw.items()}
    batch = process(raw, torch.Generator("cuda").manual_seed(0))
    check(int(batch.vid_len.min()) < LRS_WINDOW, "the LRS batch holds no clip shorter "
          f"than {LRS_WINDOW} frames: {batch.vid_len.tolist()}")
    out = {}
    for bf16 in (False, True):
        mode = "bf16" if bf16 else "fp32"
        out[mode] = phase_train_fixed(card, f"LRS2 {mode}", ModelConfig(use_bfloat16=bf16),
                                      LRS_CONFIG.train, batch)
        torch.cuda.empty_cache()
    print(f"train LRS2 B={LRS_BATCH} x {LRS_WINDOW}: bf16 {out['bf16'][1]:.1f} ms a step against "
          f"fp32 {out['fp32'][1]:.1f} ms ({out['fp32'][1] / out['bf16'][1]:.3f}x) [{card}]")
    return out


def phase_lrs_trainer(card, fixed_step_ms):
    """(d) ``Trainer.fit`` on LRS2 (the recipe, fp32, its synthetic clips:
    LOOP_BATCHES batches an epoch) counted as phase 9 (c) counts it, one
    validation batch and a checkpoint round trip (``python3 -m
    vcagan_torch.cli.train_lrs --bf16`` runs in ``phase_clis``).  Returns the attention calls
    of fit's steps and of the validation batch."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lrs_")
    try:
        config = lrs_config("LRS2", **{
            "data.data_root": os.path.join(tmp, "no_corpus"), "data.synthetic_clips": LRS_CLIPS,
            "train.checkpoint_dir": os.path.join(tmp, "ckpt")})
        trainer, fit_launches = phase_trainer_fit(card, fixed_step_ms, tmp, config, "LRS2 fp32")
        check(trainer.is_lrs and isinstance(trainer.train_ds.source, SyntheticLRSSource),
              "the LRS2 Trainer does not run on the synthetic LRS clips")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logs = trainer.validate(fast=False, max_batches=1)
        elapsed = time.perf_counter() - t0
        val_launches = count_of("attention.calls")
        check_calls(2, 0, "LRS validate")
        check(all(np.isfinite(x) for x in logs) and logs[0] > 0, f"LRS validate returned {logs}")
        raw = next(trainer._val_ds.epoch(LRS_BATCH, shuffle=False, drop_last=False))
        print(f"trainer validate LRS2, one batch B={LRS_BATCH} x {raw['video_raw'].shape[1]} "
              f"frames (the bucket; vid_len {raw['vid_len'].min()}-{raw['vid_len'].max()}): "
              f"{elapsed:.2f} s, l1 {logs[0]:.4f}, stoi {logs[1]:.4f}, estoi {logs[2]:.4f}, pesq "
              f"{logs[3]:.4f}; {val_launches} attention calls [{card}]")
        phase_trainer_checkpoint(card, trainer)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"fit_steps": LOOP_BATCHES, "fit": fit_launches, "validation_batch": val_launches}


# Phase 11: evaluation.  The GRID test recipe: B=100 clips of up to 75
# frames, flip TTA (2 forwards, so 4 attention calls a batch); test_lrs:
# B=8 length-sorted clips in buckets of up to 160 frames.  ASR_TOL: the ASR
# models' logits card vs CPU (cuDNN convolutions and GRU against oneDNN, in
# fp32 with TF32 off: sums of up to 25 x 64 terms in another order, then
# two GRU layers), atol and rtol.
EVAL_BATCH, EVAL_FRAMES = 100, DataConfig().max_v_timesteps
LRS_TEST_BATCH = 8
ASR_TOL = 1e-3


def lrs_test_batch(lengths):
    """The raw batch ``test_lrs`` makes of clips of these frame counts: the
    LRS2 recipe's test split (length-sorted, the bucket of the longest)."""
    cfg = LRS_CONFIG
    ds = LRSDataset(SyntheticLRSSource(lengths=lengths), cfg.audio, cfg.data, "test", 0)
    return next(ds.epoch(len(lengths), shuffle=False, drop_last=False, sort_by_length=True))


def eval_modules(states, device, bf16=False):
    """The generator side of ``states`` (trained weights) in a seven-module
    bundle on ``device``, as the test CLIs hold it."""
    return VCAGANModules.create(ModelConfig(use_bfloat16=bf16)).load_state_dicts(states).to(device)


def phase_eval_attention(card):
    """(a) The attention kernel at the test shapes: GRID's B=100 x 75 clips
    (all 75 frames, as the synthetic clips are), and LRS test's B=8 at the
    160-frame bucket with the real lengths of such a batch (clips of
    121-160 frames).  Returns the rows, the worst error and that LRS raw
    batch."""
    lengths = np.random.default_rng(11).integers(121, 161, LRS_TEST_BATCH).tolist()
    raw = lrs_test_batch(lengths)
    t = raw["video_raw"].shape[1]
    check(t == 160, f"the LRS test batch's bucket is {t}, not 160")
    lrs_len = raw["vid_len"].tolist()
    side = torch.cuda.Stream()
    grid_len = [EVAL_FRAMES] * EVAL_BATCH
    cases = (("GRID test att1", EVAL_FRAMES, EVAL_FRAMES, grid_len),
             ("GRID test att2", 2 * EVAL_FRAMES, EVAL_FRAMES, grid_len),
             ("LRS test att1", t, t, lrs_len), ("LRS test att2", 2 * t, t, lrs_len))
    rows = [attention_row(card, name, tq, s_, 256, lens, 400 + i, side)
            for i, (name, tq, s_, lens) in enumerate(cases)]
    return rows, max(row["max_abs_err"] for row in rows), raw


def phase_eval_lrs_batch(card, states, raw):
    """One ``test_lrs`` batch at its recipe (B=8, the 160-frame bucket,
    real lengths) through the LRS input pipeline and the flip-TTA eval
    forward on the card, after one warm-up: 4 attention calls asserted
    and the forwards timed by CUDA events.  Returns the launches."""
    from vcagan_torch.train.step import make_eval_step

    step = make_eval_step(eval_modules(states, "cuda"), flip_tta=True)
    batch = make_lrs_device_pipeline(LRS_CONFIG.audio, augment=False, device="cuda")(raw)
    gen = torch.Generator("cuda").manual_seed(1)
    step(batch.video, batch.vid_len, gen)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    g3, gs = step(batch.video, batch.vid_len, gen)
    ev[1].record()
    ev[1].synchronize()
    launches = count_of("attention.calls")
    check_calls(4, 0, "LRS test batch")
    check(torch.isfinite(g3).all().item() and torch.isfinite(gs).all().item(),
          "LRS test batch: non-finite output")
    print(f"LRS test batch B={LRS_TEST_BATCH} x {batch.video.shape[1]} (lengths "
          f"{batch.vid_len.tolist()}): the two eval forwards {ev[0].elapsed_time(ev[1]):.1f} ms "
          f"(CUDA events), {launches} attention calls [{card}]")
    return launches


def phase_eval_card_vs_cpu(card, states):
    """(b) The test CLIs' per-batch functions card against CPU on the
    trained weights, the same noise and Griffin-Lim phase on both: GRID's
    flip-TTA forward at B=2 x 75 and ``vocode_grid``; an LRS test batch
    (B=2, the 40-frame bucket) through the LRS input pipeline and the
    forward, and ``vocode_lrs`` on its normalised target spectrogram (the
    trained weights are GRID's, whose postnet gives linear magnitudes, not
    the LRS normalised log-spectrogram); on the card the bf16 forward
    against the fp32 one; then both ASR models at full width on the same
    mels."""
    from vcagan_torch.cli.test import vocode_grid
    from vcagan_torch.cli.test_lrs import vocode_lrs
    from vcagan_torch.dsp.pipeline import MelPipeline
    from vcagan_torch.eval.asr_models import load_asr
    from vcagan_torch.train.step import make_eval_step

    rng = np.random.default_rng(12)
    b, t = 2, EVAL_FRAMES
    video = torch.from_numpy(rng.standard_normal((b, t, 112, 112, 1)).astype(np.float32))
    lengths = torch.tensor([t, 60], dtype=torch.int32)
    noise = torch.from_numpy(rng.standard_normal((2, b, 20, t, 128)).astype(np.float32))
    phase = torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32))
    wav = rng.uniform(-0.5, 0.5, (b, 4 * t * 160)).astype(np.float32)
    lrs_raw = lrs_test_batch([40, 31])
    lrs_pipe = make_lrs_device_pipeline(LRS_CONFIG.audio, augment=False, device="cuda")
    lrs_batch = lrs_pipe(lrs_raw)
    tl = lrs_batch.video.shape[1]
    lrs_noise = torch.from_numpy(rng.standard_normal((2, b, 20, tl, 128)).astype(np.float32))
    lrs_phase = torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, 4 * tl, 321)).astype(np.float32))
    hop = LRS_CONFIG.audio.hop_length

    outs = {}
    for name, device, bf16 in (("card", "cuda", False), ("CPU", "cpu", False),
                               ("card bf16", "cuda", True)):
        step = make_eval_step(eval_modules(states, device, bf16), flip_tta=True)
        g3, gs = step(video.to(device), lengths.to(device), None, noise.to(device))
        wav_pred, wav_gt = vocode_grid(MelPipeline(), gs, wav, 4 * t, init_phase=phase.to(device))
        lg3, lgs = step(lrs_batch.video.to(device), lrs_batch.vid_len.to(device), None,
                        lrs_noise.to(device))
        lwav, lgt, n_wav = vocode_lrs(MelPipeline(LRS_CONFIG.audio), lrs_batch.spec.to(device),
                                      lrs_raw["wav"], lrs_batch.mel_len.to(device), hop,
                                      init_phase=lrs_phase.to(device))
        outs[name] = {k: v.float().cpu() for k, v in dict(
            g3=g3, spec=gs, wav=wav_pred, wav_gt=wav_gt, lrs_g3=lg3, lrs_spec=lgs,
            lrs_wav=lwav, lrs_wav_gt=lgt, n_wav=n_wav).items()}
    got, want = outs["card"], outs["CPU"]
    for key in ("g3", "spec", "lrs_g3", "lrs_spec"):
        g, w = got[key], want[key]
        err = (g - w).abs().max().item()
        check(torch.isfinite(g).all().item(), f"eval {key}: non-finite")
        check(torch.allclose(g, w, rtol=PATH_TOL, atol=PATH_TOL),
              f"eval {key}: card vs CPU {err:.3e}")
        print(f"eval {key} card vs CPU: max abs err {err:.3e} (max |CPU| "
              f"{w.abs().max().item():.3e})")
    for key in ("wav", "lrs_wav"):
        rel = rel_l2(got[key], want[key])
        check(rel < WAV_REL_L2, f"eval {key}: card vs CPU relative L2 {rel:.3e}")
        print(f"eval {key} card vs CPU: relative L2 {rel:.3e}")
    for key in ("wav_gt", "lrs_wav_gt", "n_wav"):
        check(torch.equal(got[key], want[key]), f"eval {key}: card and CPU differ")
    check(got["wav"].shape == (b, 160 * (4 * t - 1)), f"GRID wav {tuple(got['wav'].shape)}")
    n = got["n_wav"].long()
    check(bool((got["lrs_wav"][torch.arange(got["lrs_wav"].shape[1])[None, :] >= n[:, None]]
                == 0).all()), "eval LRS: a waveform is not 0 past its length")
    for key, other in (("g3", "mel3"), ("spec", "spec"), ("lrs_g3", "LRS mel3"),
                       ("lrs_spec", "LRS spec")):
        corr, rel = corr_rel(outs["card bf16"][key], got[key])
        print(f"eval {other} bf16 vs fp32 on the card: correlation {corr:.6f}, relative L2 "
              f"{rel:.3e}")
        if key.endswith("g3"):
            check(corr > BF16_MEL_CORR, f"eval bf16 {key} correlation {corr:.6f}")
        else:
            check(rel < BF16_SPEC_REL, f"eval bf16 {key} relative L2 {rel:.3e}")

    for kind, frames in (("grid", 4 * EVAL_FRAMES), ("lrw", 116)):
        mel = torch.from_numpy(rng.uniform(-11.5, 0.0, (2, 80, frames)).astype(np.float32))
        g = load_asr(kind, device="cuda")(mel.cuda()).cpu()
        w = load_asr(kind, device="cpu")(mel)
        err = (g - w).abs().max().item()
        check(torch.allclose(g, w, rtol=ASR_TOL, atol=ASR_TOL),
              f"ASR {kind}: card vs CPU {err:.3e}")
        print(f"ASR {kind} {tuple(g.shape)} logits card vs CPU: max abs err {err:.3e} (max |CPU| "
              f"{w.abs().max().item():.3e}) [{card}]")


def grid_test_raw(card):
    """A GRID test raw batch at the recipe, B=100 synthetic clips, every
    one real (``n_valid`` 100), as the test CLI collates them."""
    cfg = DataConfig()
    t0 = time.perf_counter()
    ds = GridDataset(SyntheticLipSpeech(num_clips=EVAL_BATCH), AudioConfig(), cfg,
                     "test", 0, workers=6)
    raw = next(ds.epoch(EVAL_BATCH, shuffle=False, drop_last=False))
    ds.close()
    check(int(raw["n_valid"]) == EVAL_BATCH, f"GRID test batch: {int(raw['n_valid'])} real clips")
    print(f"GRID test batch: {int(raw['n_valid'])} clips rendered and collated into B="
          f"{EVAL_BATCH} x {raw['video_raw'].shape[1]} in {time.perf_counter() - t0:.2f} s "
          f"(6 threads) [{card}]")
    return raw


def phase_eval_grid_batch(card, states, raw, bf16):
    """(c) One GRID test batch at the recipe through the CLI's functions,
    after one warm-up on it: the input pipeline, the two eval forwards and
    Griffin-Lim timed by CUDA events, STOI/ESTOI (to its sync) and PESQ on
    the host and the artifact dump by the host's clock; 4 attention
    calls asserted.  Returns the parts."""
    import shutil
    import tempfile

    from vcagan_torch.cli.test import score, vocode_grid, write_clip
    from vcagan_torch.dsp.pipeline import MelPipeline
    from vcagan_torch.train.step import make_eval_step

    mode = "bf16" if bf16 else "fp32"
    step = make_eval_step(eval_modules(states, "cuda", bf16), flip_tta=True)
    process = make_device_pipeline(AudioConfig(), DataConfig(), augment=False, device="cuda")
    pipe = MelPipeline()
    gen = torch.Generator("cuda").manual_seed(1)
    nv, ml0 = int(raw["n_valid"]), int(raw["mel_len"][0])
    batch = process(raw)
    score(*vocode_grid(pipe, step(batch.video, batch.vid_len, gen)[1], raw["wav"], ml0, gen),
          nv)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        batch = process(raw)
        ev[1].record()
        g3, gs = step(batch.video, batch.vid_len, gen)
        ev[2].record()
        wav_pred, wav_gt = vocode_grid(pipe, gs, raw["wav"], ml0, gen)
        ev[3].record()
        ev[3].synchronize()
        launches = count_of("attention.calls")
        times = {}
        stoi, estoi, pesq = score(wav_gt, wav_pred, nv, times=times)
        t1 = time.perf_counter()
        mel, spec, wavs = (x.float().cpu().numpy() for x in (g3, gs, wav_pred))
        for i in range(nv):
            write_clip(os.path.join(tmp, "spec_mel"), os.path.join(tmp, "wav"), f"clip_{i:05d}",
                       mel[i], spec[i], int(raw["mel_len"][i]), wavs[i])
        wall = time.perf_counter() - t0
        dump = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(launches == 4 and count_of("fused_block.calls") == 0,
          f"GRID test batch {mode}: {launches} attention and {count_of('fused_block.calls')} "
          "fused-block kernel calls, not 4 and 0")
    check(np.isfinite(stoi).all() and np.isfinite(estoi).all(),
          f"GRID test {mode}: STOI not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    parts = {"input_pipeline_ms": ev[0].elapsed_time(ev[1]),
             "forwards_ms": ev[1].elapsed_time(ev[2]), "griffin_lim_ms": ev[2].elapsed_time(ev[3]),
             "stoi_estoi_ms": 1e3 * times["stoi_estoi_s"], "pesq_host_ms": 1e3 * times["pesq_s"],
             "dump_ms": 1e3 * dump, "wall_ms": 1e3 * wall}
    print(f"GRID test batch {mode} B={EVAL_BATCH} x {EVAL_FRAMES} ({nv} scored): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; {nv / wall:.2f} clips/s, peak {peak:.2f} GB, {launches} attention "
          f"calls; STOI {np.nanmean(stoi):.4f} ESTOI {np.nanmean(estoi):.4f} PESQ "
          f"{np.nanmean(pesq):.4f} [{card}]")
    return {**parts, "launches": launches, "peak_gb": peak, "clips_per_s": nv / wall}


def phase_eval_clis(card, states):
    """(d) ``python3 -m vcagan_torch.cli.test`` (B=100, 2 batches asked; the
    64 synthetic clips make one) and ``cli.test_lrs --time_breakdown`` (B=8,
    2 batches of 16 synthetic clips) at once, on a port checkpoint of the
    trained generator; their artifact trees and ``metric.txt`` read back;
    then ``cli.asr_grid`` on ``test``'s ``spec_mel`` (B=160) and
    ``cli.asr_lrw`` on a tree of 120 116-frame mels (B=120), both random
    init (no trained ASR weights are in the repository), at once; then
    each ASR model's forward and ``evaluate`` timed in this process."""
    import glob
    import re
    import shutil
    import tempfile

    from vcagan_torch.eval import asr_grid, asr_lrw
    from vcagan_torch.eval.asr_models import load_asr
    from vcagan_torch.io.checkpoint import CheckpointManager

    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_cli_")
    try:
        # a checkpoint of each recipe: its train state holds the recipe's
        # optimizer (AMSGrad for GRID, Adam for LRS), which the CLI restores
        ckpts = {}
        for recipe, train_config in (("grid", TrainConfig()), ("lrs", LRS_CONFIG.train)):
            state, _, _ = create_train_state(VCAGANModules.create().load_state_dicts(states),
                                             train_config, 1, device="cuda")
            ckpts[recipe] = CheckpointManager(os.path.join(tmp, f"ckpt_{recipe}")).save(state, 0)
            del state
        torch.cuda.empty_cache()
        grid_out, lrs_out = os.path.join(tmp, "grid"), os.path.join(tmp, "lrs")
        no_corpus = os.path.join(tmp, "no_corpus")
        outs = run_clis([
            ("vcagan_torch.cli.test", ["--grid", no_corpus, "--checkpoint", ckpts["grid"],
                                       "--max_batches", "2", "--out_dir", grid_out], grid_out),
            ("vcagan_torch.cli.test_lrs", ["--data", no_corpus, "--checkpoint", ckpts["lrs"],
                                           "--time_breakdown", "--max_batches", "2",
                                           "--synthetic_clips", "16", "--out_dir", lrs_out],
             lrs_out)], "two test CLIs", card)
        metric = re.compile(r"STOI : \S+ESTOI : \S+PESQ : \S+")
        lrs_base = os.path.join(lrs_out, "LRS2")
        for what, base, tree, n in (("test", grid_out, ("spec_mel/synthetic", "wav/synthetic"), 64),
                                    ("test_lrs", lrs_base, ("mel", "wav"), 16)):
            npz = sorted(glob.glob(os.path.join(base, tree[0], "*.npz")))
            wavs = sorted(glob.glob(os.path.join(base, tree[1], "*.wav")))
            check(len(npz) == len(wavs) == n,
                  f"{what}: {len(npz)} npz and {len(wavs)} wav, not {n}")
            with np.load(npz[0]) as z:
                shapes = {k: z[k].shape for k in z.files}
            check(set(shapes) == {"mel", "spec"} and shapes["mel"][:2] == (1, 80)
                  and shapes["spec"][:2] == (1, 321), f"{what}: npz {shapes}")
            with open(os.path.join(base, "metric.txt")) as f:
                text = f.read()
            check(metric.fullmatch(text) is not None, f"{what}: metric.txt {text!r}")
            print(f"{what} artifacts: {n} npz ({shapes}) and wav; metric.txt {text} [{card}]")
        breakdown = json.loads(next(line for line in outs[1] if line.startswith("{")))
        print(f"test_lrs --time_breakdown: {json.dumps(breakdown)} [{card}]")

        lrw = os.path.join(tmp, "lrw")
        classes = [f"W{i:03d}" for i in range(500)]
        rng = np.random.default_rng(13)
        for i in range(120):
            word = classes[i % 10]
            os.makedirs(os.path.join(lrw, word, "test"), exist_ok=True)
            np.savez(os.path.join(lrw, word, "test", f"{word}_{i:05d}.npz"),
                     mel=rng.uniform(-1, 1, (1, 80, 116)).astype(np.float32))
        with open(os.path.join(tmp, "classes.txt"), "w") as f:
            f.write("\n".join(classes))
        spec_mel = os.path.join(grid_out, "spec_mel")
        outs = run_clis([
            ("vcagan_torch.cli.asr_grid", ["--data", spec_mel, "--gtpath", no_corpus,
                                           "--batch_size", "160"], os.path.join(tmp, "asr_grid")),
            ("vcagan_torch.cli.asr_lrw", ["--data", lrw, "--class_list",
                                          os.path.join(tmp, "classes.txt"), "--batch_size", "120"],
             os.path.join(tmp, "asr_lrw"))], "two ASR CLIs", card)
        check(outs[0][-2].startswith("test_cer:") and outs[0][-1].startswith("test_wer:"),
              f"asr_grid printed {outs[0][-2:]}")
        check(outs[1][-1].startswith("test_ACC:"), f"asr_lrw printed {outs[1][-1:]}")
        print(f"asr_grid: {outs[0][-2]}, {outs[0][-1]}; asr_lrw: {outs[1][-1]} (random init) "
              f"[{card}]")

        rows = {}
        for kind, b, frames, run in (
                ("grid", 160, 4 * EVAL_FRAMES, lambda m: asr_grid.evaluate(
                    spec_mel, no_corpus, m, batch_size=160)),
                ("lrw", 120, 116, lambda m: asr_lrw.evaluate(lrw, classes, m, batch_size=120))):
            model = load_asr(kind, device="cuda")
            mel = torch.from_numpy(rng.uniform(-11.5, 0, (b, 80, frames)).astype(np.float32)).cuda()
            forward_ms = time_ms(lambda: model(mel), samples=5, calls=5, warmup=2)
            run(model)
            t0 = time.perf_counter()
            run(model)
            rows[kind] = {"forward_ms": forward_ms, "evaluate_ms": 1e3 * (time.perf_counter() - t0)}
            print(f"ASR {kind} B={b} x {frames} mel frames: forward {forward_ms:.2f} ms a batch "
                  f"(CUDA events), evaluate {rows[kind]['evaluate_ms']:.1f} ms for its one batch "
                  f"(files loaded on the host) [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return breakdown, rows


def phase_eval(card, states):
    """Phase 11: evaluation on the card.  Returns the attention rows, their
    worst error and the attention calls of one LRS and one GRID test
    batch (fp32 and bf16)."""
    rows, worst, lrs_raw = phase_eval_attention(card)
    launches = {"lrs_test_batch": phase_eval_lrs_batch(card, states, lrs_raw)}
    phase_eval_card_vs_cpu(card, states)
    torch.cuda.empty_cache()
    raw = grid_test_raw(card)
    for bf16 in (False, True):
        parts = phase_eval_grid_batch(card, states, raw, bf16)
        launches["grid_test_batch" + ("_bf16" if bf16 else "")] = parts["launches"]
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_eval_clis(card, states)
    print(f"phase 11 (d), the four CLIs and the ASR timings: {time.perf_counter() - t0:.1f} s")
    return rows, worst, launches


# Phase 12: past 512 keys, the collate worker process, JAX train states and
# serving npz.  (a) The attention past 512 keys at the shapes of 30 s clips
# (750 frames: att1 (4, 750, 750) with lengths 0, 750 and two between,
# att2 (4, 1500, 750)), an LRS att2 bucket of 513 frames, 640 keys and
# 4096 keys; (B, T, S, graph samples).  The last three are timed on fewer
# samples.
LONG_CASES = (("30 s att1", 4, 750, 750, 10), ("30 s att2", 4, 1500, 750, 10),
              ("LRS 513", 8, 1026, 513, 5), ("640 keys", 2, 1280, 640, 5),
              ("4096 keys", 1, 4096, 4096, 5))
LONG_FRAMES = 750  # a 30 s clip at 25 fps


def long_lengths(b, s_, rng):
    """Mixed lengths with 0 and S among them (S alone for one sample)."""
    if b == 1:
        return [s_]
    lengths = rng.integers(1, s_ + 1, b)
    lengths[:2] = (0, s_)
    return lengths.tolist()


def phase_long_attention(card):
    """(a) The attention kernel past 512 keys (S > S_MAX) at LONG_CASES
    against its plain version, float64 and its own arithmetic in plain
    PyTorch (3xTF32 over the plan's key blocks and splits), a length-0 row's
    output against the mean of its S values, one launch counted on each
    shape (the combine of the splits included); timed by CUDA-graph replay
    beside its bound, plain and sdpa, with its plan (splits, blocks,
    workspace).  Then its autograd.Function's gradient at S = 640 against
    float64.  Returns the rows, the worst forward and gradient errors."""
    side = torch.cuda.Stream()
    rng = np.random.default_rng(12)
    d = 256
    rows, worst = [], 0.0
    for i, (name, b, t, s_, samples) in enumerate(LONG_CASES):
        lengths = long_lengths(b, s_, rng)
        q, k, v, lens = attention_inputs(b, t, s_, d, lengths, seed=500 + i)
        plan = attn.attention_plan(t, s_, d, b)
        check(plan.key_block == attn.KEY_BLOCK, f"{name}: plan {plan}")
        before = count_of("attention.calls"), count_of("attention.launches")
        got = attn.masked_attention_cuda(q, k, v, lens)
        torch.cuda.synchronize()
        check(count_of("attention.calls") == before[0] + 1, f"{name}: the kernel was not called")
        check(count_of("attention.launches") == before[1] + attn.kernel_launches(plan, b),
              f"{name}: {count_of('attention.launches') - before[1]} launches counted, not "
              f"{attn.kernel_launches(plan, b)}")
        want = attn.masked_attention_reference(q, k, v, lens)
        want64 = attn.masked_attention_reference(q.double(), k.double(), v.double(), lens)
        want3x = attention_3xtf32(plan, q, k, v, lens)
        err = (got - want).abs().max().item()
        err64 = (got.double() - want64).abs().max().item()
        err3x = (got - want3x).abs().max().item()
        check(torch.isfinite(got).all().item(), f"long {name}: non-finite kernel output")
        check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL) and err64 < ATTN_TOL
              and err3x < ATTN_TOL, f"long {name} {b, t, s_, d}: kernel vs plain {err:.3e}, "
              f"vs float64 {err64:.3e}, vs its 3xTF32 arithmetic {err3x:.3e}")
        zero_err = 0.0
        for j, n in enumerate(lengths):
            if n <= 0:
                mean = v[j].double().mean(0).expand(t, d)
                zero_err = max(zero_err, (got[j].double() - mean).abs().max().item())
        check(zero_err < ATTN_TOL, f"long {name}: a length-0 row is {zero_err:.3e} from the "
              "mean of its S values")
        del want64, want3x
        ms = graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens), side, samples=samples,
                      calls=samples)
        plain = graph_ms(lambda: attn.masked_attention_reference(q, k, v, lens), side,
                         samples=samples, calls=samples)
        mask = key_mask(k, lens)
        lib = graph_ms(lambda: sdpa(q, k, v, mask), side, samples=samples, calls=samples)
        nbytes, flops = attention_work_lengths(b, t, s_, d, lengths)
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ATTN_FLOP_PER_S * 1e3
        bound, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
        worst = max(worst, err, err64)
        print(f"attention long {name} B={b} T={t} S={s_} D={d} ({plan.describe()}), "
              f"lengths {lengths[:4]}"
              f"{' ...' if b > 4 else ''}: max_abs_err {err:.3e} (vs float64 {err64:.3e}, vs "
              f"its 3xTF32 arithmetic {err3x:.3e}, length-0 rows vs the mean {zero_err:.3e}) ok; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP of "
              f"the unmasked keys) [{card}]")
        if i == 0:  # the launches of five calls by the profiler, printed: after the
            # profiler sessions of phases 8-11 it has seen none of them (the check is
            # phase 6's phase_instance_launches, before those sessions)
            device, _ = profiled(lambda: [attn.masked_attention_cuda(q, k, v, lens)
                                          for _ in range(5)])
            kernels = {}
            for n, s0, e in device:  # the name without its namespace, template and arguments
                short = re.search(r"(\w+)(?:<[^()]*>)?\(", n)
                kernels.setdefault(short.group(1) if short else n, []).append((e - s0) / 1e3)
            print(f"attention long {name} under torch.profiler, five calls: " + (
                "; ".join(f"{n} x{len(ms)} median {statistics.median(ms):.4f} ms"
                          for n, ms in kernels.items()) or "no device activity seen")
                  + f" [{card}]")
        rows.append({"shape": [b, t, s_, d], "key_block": plan.key_block,
                     "splits": plan.splits, "blocks": plan.blocks,
                     "workspace_mb": plan.workspace_floats * 4 / 1e6, "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "bound_by": bound_by, "max_abs_err": max(err, err64)})
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()

    # The gradient at S = 640 as a train step takes it (MaskedAttention).
    b, t, s_ = 2, 1280, 640
    q, k, v, lens = attention_inputs(b, t, s_, d, [0, 500], seed=520)
    grad = torch.randn(b, t, d, generator=torch.Generator(device="cuda").manual_seed(12),
                       device="cuda")
    leaves = [x.requires_grad_() for x in (q, k, v)]
    before = count_of("attention.calls")
    out = attn.masked_cross_attention(*leaves, lens)
    check(isinstance(out.grad_fn, attn.MaskedAttention._backward_cls) and
          count_of("attention.calls") == before + 1, "long: the kernel was not called under autograd")
    got = torch.autograd.grad(out, leaves, grad)
    wide = [x.detach().double().requires_grad_() for x in (q, k, v)]
    want64 = torch.autograd.grad(attn.masked_attention_reference(*wide, lens), wide,
                                 grad.double())
    errs = []
    for gname, g, w64 in zip(("dq", "dk", "dv"), got, want64):
        e64 = (g.double() - w64).abs().max().item()
        check(torch.allclose(g.double(), w64, rtol=ATTN_GRAD_TOL, atol=ATTN_GRAD_TOL),
              f"long attention {gname}: vs float64 max abs err {e64:.3e}")
        errs.append(e64)
    print(f"attention long B={b} T={t} S={s_} D={d} through MaskedAttention: dq, dk, dv vs "
          f"float64 {', '.join(f'{e:.3e}' for e in errs)} ok [{card}]")
    return rows, worst, max(errs)


def phase_synth_long(card, states):
    """(b) ``Synthesizer`` on B=2 clips of 750 frames (30 s; lengths 750
    and 513), fp32 and bf16, on the trained weights: 2 attention calls
    (both key-blocked) a forward; the fp32 forward held to the CPU's with
    the same noise and Griffin-Lim phase (``PATH_TOL`` and ``WAV_REL_L2``),
    the bf16 one to the fp32 one on the card (the JAX package's bf16
    bounds, as phase 4 holds bf16 to fp32); one forward timed on the card.
    Returns the launches of the two card forwards."""
    b, t = 2, LONG_FRAMES
    rng = np.random.default_rng(13)
    video = rng.standard_normal((b, t, 112, 112, 1)).astype(np.float32)
    lengths = np.asarray([t, 513], np.int32)
    noise = rng.standard_normal((b, 20, t, 128)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32)
    launches, fp32 = {}, None
    for bf16 in (False, True):
        mode = "bf16" if bf16 else "fp32"
        config = ModelConfig(use_bfloat16=bf16)
        on_card = Synthesizer(config, device="cuda").load_state_dicts(states)
        on_card(video, lengths, noise=noise, init_phase=phase)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = on_card(video, lengths, noise=noise, init_phase=phase)
        ev[1].record()
        torch.cuda.synchronize()
        launches[mode] = count_of("attention.calls")
        check_calls(2, 0, f"30 s clips {mode}, one forward")
        check(got["wav"].shape == (b, 160 * (4 * t - 1)), f"wav shape {tuple(got['wav'].shape)}")
        del on_card
        if bf16:
            compare_bf16(f"30 s clips {mode}, against fp32 on the card", got, fp32)
            against = "bf16 against fp32 on the card ok"
        else:
            t0 = time.perf_counter()
            want = Synthesizer(config, device="cpu").load_state_dicts(states)(
                video, lengths, noise=noise, init_phase=phase)
            against = f"card vs CPU ok (the CPU's forward {time.perf_counter() - t0:.1f} s)"
            compare_outputs(f"30 s clips {mode}, card vs CPU", got, want, PATH_TOL, WAV_REL_L2)
            fp32 = got
        print(f"serve 30 s clips {mode} B={b} x {t} frames (lengths {lengths.tolist()}; the "
              f"attention at ({b}, {t}, {t}) and ({b}, {2 * t}, {t}), key-blocked): one forward "
              f"{ev[0].elapsed_time(ev[1]):.1f} ms on the card, {launches[mode]} attention "
              f"calls; {against} [{card}]")
        del got
        torch.cuda.empty_cache()
    return launches


FIT_BATCHES = 4  # batches an epoch in (c): the first step a warm-up, 3 paced
RENDERED_SOURCES = {}  # (c)'s synthetic sources, their clips rendered, by recipe


def fit_epoch(trainer, what, card):
    """One epoch of ``trainer.fit`` (FIT_BATCHES steps, stopped at the last
    one), each step's start and end stamped with CUDA events.  Returns its
    readings: ms a step (device ms from the first step's end to the last's,
    over the steps after it), the device's idle share over them, the
    producer's collate ms a batch and the attention calls."""
    starts, ends = [], []
    step_fn, pipe_fn = trainer.train_step, trainer.process_train

    def stamped_pipeline(*args):
        starts.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record()
        return pipe_fn(*args)

    def stamped_step(*args):
        out = step_fn(*args)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    trainer.train_step, trainer.process_train = stamped_step, stamped_pipeline
    torch.cuda.synchronize()
    reset_launches()
    first = trainer.state.step
    t0 = time.perf_counter()
    try:
        done = trainer.fit(epochs=1, max_steps=first + FIT_BATCHES)
    finally:
        trainer.train_step, trainer.process_train = step_fn, pipe_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(done == first + FIT_BATCHES, f"{what}: fit stopped at step {done}")
    check_calls(2 * FIT_BATCHES, 0, f"{what}, {FIT_BATCHES} steps")
    step_ms = [a.elapsed_time(b_) for a, b_ in zip(ends, ends[1:])]
    idle = [a.elapsed_time(b_) for a, b_ in zip(ends, starts[1:])]
    collate = [1e3 * x for x in trainer.collate_s]
    out = {"ms_a_step": sum(step_ms) / len(step_ms), "idle_share": sum(idle) / sum(step_ms),
           "collate_ms": statistics.mean(collate), "wall_s": wall,
           "launches": count_of("attention.calls")}
    print(f"fit {what}: {out['ms_a_step']:.1f} ms a step (steps 2-{FIT_BATCHES}, CUDA events), "
          f"device idle {100 * out['idle_share']:.1f}%, collate {out['collate_ms']:.1f} ms a "
          f"batch (" + ", ".join(f"{x:.0f}" for x in collate) + f"), {wall:.1f} s for the "
          f"epoch, {count_of('attention.calls')} attention calls [{card}]")
    return out


def phase_fit_producers(card):
    """(c) ``Trainer.fit`` in bf16 on GRID (B=88 x 40) and on LRS2 (B=16 x
    50) over FIT_BATCHES batches of synthetic clips an epoch: the thread
    producer (``ParallelEpoch``) on its first epoch (each clip rendered on
    first use) and on the next (cached), then the collate worker process
    (``ProcessEpoch``) on the cached clips (the worker inherits them).  Its
    first epoch on a fresh source (the worker rendering every clip) left
    the script to make room for phase 15 (its last times: PERF.md).
    Returns the readings by run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    runs = {}
    try:
        recipes = (
            ("GRID", loop_config(tmp, FIT_BATCHES, **{"model.use_bfloat16": True})),
            ("LRS2", lrs_config("LRS2", **{
                "data.data_root": os.path.join(tmp, "no_corpus"),
                "data.synthetic_clips": FIT_BATCHES * LRS_BATCH,
                "train.checkpoint_dir": os.path.join(tmp, "ckpt"),
                "model.use_bfloat16": True})),
        )
        for name, config in recipes:
            trainer = Trainer(config, log_dir=os.path.join(tmp, f"log_{name}"))
            check(trainer.steps_per_epoch == FIT_BATCHES, f"{trainer.steps_per_epoch} steps")
            b = config.train.batch_size
            # one step on a batch made with numpy first: a new bundle's first
            # step (kernel loads, cuDNN's choices) would let the feed buffer
            # the first epoch and hide its pace
            trainer.state, _ = trainer.train_step(
                trainer.state, train_batch(b, config.data.window_size, 0, "cuda"),
                trainer.generator)
            torch.cuda.synchronize()
            runs[f"{name} thread, first epoch"] = fit_epoch(
                trainer, f"{name} bf16 B={b}, thread producer, first epoch", card)
            runs[f"{name} thread, cached"] = fit_epoch(
                trainer, f"{name} bf16 B={b}, thread producer, clips cached", card)
            trainer.config = dataclasses.replace(
                config, data=dataclasses.replace(config.data, collate_process=True))
            runs[f"{name} process, cached"] = fit_epoch(
                trainer, f"{name} bf16 B={b}, ProcessEpoch, clips cached", card)
            RENDERED_SOURCES[name] = trainer.train_ds.source  # phase 13 (a) reuses it
            del trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def exported_state_leaves(state):
    """A port train state as the leaves of ``tools/export_jax_train_state.py``'s
    ``.npz`` (what it writes of a JAX train state), through the reference
    converter (numpy only)."""
    from tools.convert_torch_ckpt import (convert_decoder, convert_discriminator,
                                          convert_postnet, convert_sync_discriminator,
                                          convert_visual_front)

    converters = {"v_front": convert_visual_front, "gen": convert_decoder,
                  "post": convert_postnet, "s_dis": convert_sync_discriminator,
                  **{f"dis{p}": (lambda sd, p=p: convert_discriminator(sd, p)) for p in "123"}}
    leaves = {"step": np.asarray(state.step, np.int32)}

    def put(prefix, tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                put(f"{prefix}/{key}", value)
            else:
                leaves[f"{prefix}/{key}"] = np.array(value)

    for side, names, opt in (("g", GENERATOR_SIDE, state.g_opt_state),
                             ("d", DISCRIMINATOR_SIDE, state.d_opt_state)):
        leaves[f"{side}_opt/count"] = np.asarray(opt.count, np.int32)
        moments = {"mu": opt.mu, "nu": opt.nu, "nu_max": opt.nu_max}
        values = {k: iter(v) for k, v in moments.items()}
        for name in names:
            module = getattr(state.modules, name)
            sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
            tree = converters[name](sd)
            put(f"{side}_params/{name}", tree["params"])
            if tree.get("batch_stats"):
                put(f"batch_stats/{name}", tree["batch_stats"])
            buffers = {k: v.cpu() for k, v in module.named_buffers()}
            for moment, it in values.items():
                msd = {k: next(it).detach().cpu() for k, _ in module.named_parameters()}
                put(f"{side}_opt/{moment}/{name}", converters[name]({**msd, **buffers})["params"])
    return leaves


def phase_jax_state(card, states):
    """(d) A train state in the exporter's format (the trained generator
    side, the seeded discriminators, seeded non-zero moments, count and
    step 7), written by the reference converter, loaded on the card by
    ``load_jax_train_state``: every tensor equal to its source; then
    ``python -m vcagan_torch.cli.test`` (in this process) scores one batch
    of 16 synthetic clips with it as ``--checkpoint``.  Returns the test
    batch's attention calls."""
    import shutil
    import tempfile

    from vcagan_torch.cli import test as cli_test
    from vcagan_torch.io.jax_state import load_jax_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_jax_state_")
    try:
        source, _, _ = create_train_state(VCAGANModules.create(seed=3).load_state_dicts(states),
                                          TrainConfig(), 1, device="cpu")
        gen = torch.Generator().manual_seed(12)
        for opt in (source.g_opt_state, source.d_opt_state):
            for t in opt.mu:
                t.copy_(torch.randn(t.shape, generator=gen) * 1e-3)
            for t in opt.nu + opt.nu_max:
                t.copy_(torch.rand(t.shape, generator=gen) * 1e-6)
            opt.count = 7
        source.step = 7
        path = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        leaves = exported_state_leaves(source)
        np.savez(path, **leaves)
        write_s = time.perf_counter() - t0
        state, _, _ = create_train_state(VCAGANModules.create(seed=5), TrainConfig(), 1)
        t0 = time.perf_counter()
        load_jax_train_state(path, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

        def tensors(st):
            out = [t for sd in st.modules.state_dicts().values() for k, t in sd.items()
                   if not k.endswith("num_batches_tracked")]
            for opt in (st.g_opt_state, st.d_opt_state):
                out += opt.mu + opt.nu + opt.nu_max
            return out

        got, want = tensors(state), tensors(source)
        check(len(got) == len(want) and all(a.device.type == "cuda" for a in got) and
              all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              "the loaded JAX-format state differs from its source")
        check((state.step, state.g_opt_state.count, state.d_opt_state.count) == (7, 7, 7),
              "the loaded step or counts differ")
        size = os.path.getsize(path)
        print(f"JAX train state in the exporter's format: {len(leaves)} leaves, "
              f"{size / 1e9:.2f} GB, written in {write_s:.1f} s, loaded onto the card in "
              f"{load_s:.1f} s, {len(got)} tensors equal to the source bit for bit [{card}]")
        del state, source
        torch.cuda.empty_cache()
        reset_launches()
        t0 = time.perf_counter()
        cli_test.main(["--grid", os.path.join(tmp, "no_corpus"), "--checkpoint", path,
                       "--batch_size", "16", "--max_batches", "1",
                       "--out_dir", os.path.join(tmp, "test")])
        torch.cuda.synchronize()
        launches = count_of("attention.calls")
        check(launches == 4, f"cli.test: {launches} attention calls in one batch, not 4")
        with open(os.path.join(tmp, "test", "metric.txt")) as f:
            metric = f.read().strip()
        check(metric.startswith("STOI : "), f"cli.test wrote {metric!r}")
        print(f"cli.test with the exported state as --checkpoint, one batch of 16 clips: "
              f"{time.perf_counter() - t0:.1f} s, {launches} attention calls; {metric} "
              f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_serving_npz(card, trained_states):
    """(e) The generator side of phase 9's Trainer (trained on the card)
    written by ``save_serving_npz`` in q8, read back by ``Synthesizer.
    from_serving_npz`` on the card: each tensor within half a quantisation
    step of the Trainer's (fp16 where not quantised), one forward at B=2
    x 75 finite, 2 attention calls.  Returns the launches."""
    import shutil
    import tempfile

    from vcagan_torch.io.serving_npz import save_serving_npz

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_npz_")
    try:
        path = os.path.join(tmp, "serving_q8.npz")
        t0 = time.perf_counter()
        save_serving_npz(trained_states, path, quantize="q8")
        save_s = time.perf_counter() - t0
        synth = Synthesizer.from_serving_npz(path, device="cuda")
        worst = 0.0
        loaded = load_serving_npz(path)
        for name in GENERATOR_SIDE:
            for key, want in trained_states[name].items():
                if key.endswith("num_batches_tracked"):
                    continue
                got, want = loaded[name][key], want.float().cpu()
                err = (got - want).abs()
                if want.numel() > 4096 and "running" not in key:  # q8: half a step
                    ok = bool(err.max() <= 0.5 * want.abs().max() / 127 * (1 + 1e-4))
                else:  # fp16: its rounding, 2^-11 relative (subnormals below 6e-5)
                    ok = bool((err <= want.abs() * 2.0 ** -11 + 1e-7).all())
                check(ok, f"serving npz {name}.{key}: {float(err.max()):.3e} from the Trainer's")
                worst = max(worst, float(err.max()))
        rng = np.random.default_rng(14)
        video = rng.standard_normal((2, 75, 112, 112, 1)).astype(np.float32)
        reset_launches()
        out = synth(video, np.asarray([75, 60], np.int32))
        torch.cuda.synchronize()
        launches = count_of("attention.calls")
        check(launches == 2, f"serving npz forward: {launches} attention calls")
        check(all(bool(torch.isfinite(v.float()).all()) for v in out.values()),
              "serving npz forward: non-finite outputs")
        print(f"serving npz (q8) of phase 9's Trainer: {os.path.getsize(path) / 1e6:.1f} MB "
              f"written in {save_s:.1f} s, read by Synthesizer.from_serving_npz on the card "
              f"(largest tensor difference {worst:.3e}, within the quantisation), one forward "
              f"B=2 x 75 finite, {launches} attention calls [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_twelve(card, states, trained_states):
    """Phase 12.  Returns the attention's rows and errors and the launches
    of each path, each read just after it ran with the counts set to 0."""
    t0 = time.perf_counter()
    rows, long_worst, long_grad = phase_long_attention(card)
    t1 = time.perf_counter()
    synth_launches = phase_synth_long(card, states)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    fit_runs = phase_fit_producers(card)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    test_launches = phase_jax_state(card, states)
    torch.cuda.empty_cache()
    npz_launches = phase_serving_npz(card, trained_states)
    print(f"phase 12 parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, (d) "
          f"and (e) {time.perf_counter() - t3:.1f} s")
    return {"long_shapes": rows, "long_max_abs_err": long_worst,
            "long_grad_max_abs_err": long_grad,
            "launches_long": {"synth_750_forward": synth_launches,
                              "fit_bf16": {k: v["launches"] for k, v in fit_runs.items()},
                              "cli_test_jax_state_batch": test_launches,
                              "serving_npz_forward": npz_launches},
            "fit_bf16": fit_runs}


# Phase 13, data parallel.  (a) One rank over NCCL: the bf16 GRID recipe's
# fit, and one fp32 step with the layout against the step without it on the
# same batch (phase 8 (b)'s card-vs-CPU bounds).  (b) Two gloo ranks on the
# one card (NCCL refuses two ranks on one device; gloo all-reduces CUDA
# tensors): the dryrun gate at full width, B=88 x 40 frames of 112 x 112,
# 44 clips a rank, against one process on all 88, each in a process of its
# own (the single process first, so the ranks' memory fits).  Each module's
# gradient is held there (dryrun.py MODULE_GRAD_RTOL, this file's
# STEP_GRAD_REL): at full width the gradients fill several of the
# all-reduce's buckets, which only this phase crosses on the card.
DP_WORLD = 2
DP_STEP_BATCH = 8  # (a)'s fp32 step with and without the layout
DP_TIMEOUT_S = 420


def phase_dp_fit_world1(card, cached_ms):
    """(a) ``Trainer.fit`` under a one-rank NCCL group (the step's gradient
    all-reduce and metric mean run, on a group of one): FIT_BATCHES steps
    in bf16 at B=88 x 40 on cached synthetic clips, the all-reduce's ms a
    step (CUDA events at the step's marks) and bytes; then one fp32 step
    with the layout against one without it.  Returns the readings."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from vcagan_torch.parallel import make_layout

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        layout = make_layout(batch_size=TRAIN_BATCH)
        check(layout.world == 1 and layout.group is not None and layout.device.type == "cuda",
              f"layout {layout}")
        config = loop_config(tmp, FIT_BATCHES, **{"model.use_bfloat16": True})
        trainer = Trainer(config, log_dir=os.path.join(tmp, "log"), layout=layout)
        if "GRID" in RENDERED_SOURCES:
            trainer.train_ds.source = RENDERED_SOURCES["GRID"]
        marks = []

        def mark(name):
            if name in ("d_backward", "d_reduce", "g_backward", "g_reduce"):
                marks.append((name, torch.cuda.Event(enable_timing=True)))
                marks[-1][1].record()

        trainer.rebuild_train_step(on_phase=mark)
        check(trainer.mesh is layout, "the Trainer's step runs without the one-rank layout")
        trainer.state, _ = trainer.train_step(
            trainer.state, train_batch(TRAIN_BATCH, TRAIN_WINDOW, 0, "cuda"), trainer.generator)
        torch.cuda.synchronize()
        marks.clear()
        first = fit_epoch(trainer, f"GRID bf16 B={TRAIN_BATCH}, one NCCL rank", card)
        if "GRID" not in RENDERED_SOURCES:  # the clips rendered in that epoch: again, cached
            marks.clear()
            first = fit_epoch(trainer, f"GRID bf16 B={TRAIN_BATCH}, one NCCL rank, cached", card)
        torch.cuda.synchronize()
        steps = [marks[i:i + 4] for i in range(0, len(marks), 4)]
        check(len(steps) == FIT_BATCHES and all([n for n, _ in m] == [
            "d_backward", "d_reduce", "g_backward", "g_reduce"] for m in steps),
            f"step marks {[n for n, _ in marks]}")
        reduce_ms = [m[0][1].elapsed_time(m[1][1]) + m[2][1].elapsed_time(m[3][1])
                     for m in steps]
        nbytes = 4 * sum(p.numel() for p in trainer.modules.parameters(
            GENERATOR_SIDE + DISCRIMINATOR_SIDE))
        out = dict(first, reduce_ms=statistics.mean(reduce_ms[1:]), reduce_bytes=nbytes,
                   cached_ms_no_group=cached_ms)
        print(f"data parallel (a) fit GRID bf16 B={TRAIN_BATCH} x {TRAIN_WINDOW}, one NCCL rank: "
              f"{out['ms_a_step']:.1f} ms a step against {cached_ms:.1f} ms without a group "
              f"(phase 12 (c), cached); gradient all-reduce "
              f"{out['reduce_ms']:.2f} ms a step (" + ", ".join(f"{x:.2f}" for x in reduce_ms)
              + f") over {nbytes / 1e6:.1f} MB of fp32 gradients; "
              f"{out['launches']} attention calls in {FIT_BATCHES} steps [{card}]")
        del trainer
        torch.cuda.empty_cache()
        out["fp32_step"] = dp_step_vs_plain(card, layout)
        return out
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def dp_step_vs_plain(card, layout):
    """(a) One fp32 step at full width (B=DP_STEP_BATCH x 40, dropout on)
    with the one-rank layout and one without it, from the same weights,
    batch and generator: metrics, each module's gradient and update, by
    phase 8 (b)'s card-vs-CPU bounds."""
    batch = train_batch(DP_STEP_BATCH, TRAIN_WINDOW, seed=5, device="cuda")
    runs = {}
    for what, mesh in (("plain", None), ("layout", layout)):
        modules = VCAGANModules.create(ModelConfig(), seed=0)
        state, g_tx, d_tx = create_train_state(modules, TrainConfig(), device="cuda")
        step = make_train_step(modules, g_tx, d_tx, TrainConfig(), mesh=mesh)
        state, metrics = step(state, batch, torch.Generator("cuda").manual_seed(0))
        runs[what] = (state, {k: v.item() for k, v in metrics.items()})
    (plain, want), (dp, got) = runs["plain"], runs["layout"]
    metric_rel = max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items())
    for k, v in want.items():
        rtol = STEP_NORM_RTOL if k in ("r1", "g_grad_norm", "d_grad_norm") else STEP_LOSS_RTOL
        check(abs(got[k] - v) <= rtol * max(abs(v), 1e-12), f"dp step {k}: {got[k]} vs {v}")
    moments = first_moments(dp), first_moments(plain)
    worst_grad = worst_share = 0.0
    lr, equal = TrainConfig().lr, True
    for name in GENERATOR_SIDE + DISCRIMINATOR_SIDE:
        grad = rel_l2(moments[0][name], moments[1][name])
        a, b_ = getattr(dp.modules, name).parameters(), getattr(plain.modules, name).parameters()
        diff = torch.cat([(p - q).detach().flatten() for p, q in zip(a, b_)]).abs() / lr
        share = (diff > 0.5).float().mean().item()
        equal = equal and diff.max().item() == 0.0
        check(grad <= STEP_GRAD_REL and share <= STEP_FLIP_SHARE,
              f"dp step {name}: gradient {grad:.3e}, share {share:.3e}")
        worst_grad, worst_share = max(worst_grad, grad), max(worst_share, share)
    print(f"data parallel (a) fp32 step B={DP_STEP_BATCH} x {TRAIN_WINDOW} with the one-rank "
          f"layout vs without: metrics within {metric_rel:.2e}, gradients {worst_grad:.2e} "
          f"(bound {STEP_GRAD_REL:g}), updates over lr/2 {worst_share:.2e} (bound "
          f"{STEP_FLIP_SHARE:g}), parameters {'bit for bit equal' if equal else 'not equal'} "
          f"[{card}]")
    del runs, plain, dp
    torch.cuda.empty_cache()
    return dict(metric_rel=metric_rel, grad_rel=worst_grad, flip_share=worst_share,
                bitwise_equal=equal)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_dp_two_ranks(card):
    """(b) ``python -m vcagan_torch.parallel.dryrun`` with two gloo ranks on
    the card at full width, fp32: its deltas at its tolerances, each rank's
    attention calls and shapes; then the attention alone at the rank's
    shapes.  Returns the readings and the two attention rows."""
    torch.cuda.empty_cache()
    print(f"data parallel (b): this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"of the card while the gate runs")
    cmd = [sys.executable, "-m", "vcagan_torch.parallel.dryrun", "--world", str(DP_WORLD),
           "--device", "cuda", "--backend", "gloo", "--batch", str(TRAIN_BATCH), "--frames",
           str(TRAIN_WINDOW), "--image", str(DataConfig().crop_size), "--timeout",
           str(DP_TIMEOUT_S)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=DP_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    check(proc.returncode == 0 and lines and json.loads(lines[-1])["ok"],
          f"dryrun failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    r = json.loads(lines[-1])
    per_rank = TRAIN_BATCH // DP_WORLD
    shapes = [[per_rank, TRAIN_WINDOW, TRAIN_WINDOW, 256], [per_rank, 2 * TRAIN_WINDOW,
                                                           TRAIN_WINDOW, 256]]
    check(r["attention_calls"] == [2] * DP_WORLD and all(a == shapes for a in r["attention"]),
          f"per-rank attention: calls {r['attention_calls']}, shapes {r['attention']}")
    print(f"data parallel (b) dryrun, {DP_WORLD} gloo ranks on one card, fp32, B={TRAIN_BATCH} x "
          f"{TRAIN_WINDOW} frames (112 x 112), {per_rank} clips a rank, against one process on "
          f"all {TRAIN_BATCH}: metrics within {r['metric_rel']:.3e} relative (bound 5e-4), "
          f"generator-side leaf mean|p| within {r['leaf_stat']:.3e} (bound "
          f"{r['leaf_stat_bound']:.1e}), each module's gradient through the first moments "
          f"within {r['module_grad_bound']:g} relative L2 (" + ", ".join(
              f"{m} {v:.2e}" for m, v in r["module_grad_rel"].items()) + "), a leaf's "
          f"{r['grad_rel']:.3e} at worst ({r['grad_rel_leaf']}; reported, not bounded in fp32), "
          f"the ranks' states equal bit for bit; attention calls a rank {r['attention_calls']} at "
          f"{shapes}, the single process {r['reference_attention_calls']}; the single process "
          f"{r['single_process_s']:.1f} s, the ranks {r['ranks_s']:.1f} s, {wall:.1f} s in all "
          f"[{card}]")
    side = torch.cuda.Stream()
    rows = [attention_row(card, f"per rank att{i + 1}", t, s_, d, [s_] * b, 400 + i, side)
            for i, (b, t, s_, d) in enumerate(shapes)]
    keep = ("world", "metric_rel", "leaf_stat", "leaf_stat_bound", "grad_rel", "grad_rel_leaf",
            "module_grad_rel", "module_grad_bound", "attention_calls", "attention",
            "reference_attention_calls", "single_process_s", "ranks_s")
    return {k: r[k] for k in keep}, rows


def phase_thirteen(card, cached_ms):
    """Phase 13.  Returns the readings for the kernels line."""
    fit = phase_dp_fit_world1(card, cached_ms)
    torch.cuda.empty_cache()
    dryrun, rows = phase_dp_two_ranks(card)
    return {"launches_fit_nccl_world1": fit["launches"], "fit_nccl_world1": fit,
            "data_parallel_dryrun": dryrun, "per_rank_shapes": rows}


# Phase 14: the model axis (model_parallel > 1; vcagan_torch/parallel/shard.py).
# (a) the dryrun gate with 4 gloo ranks on the one card at full width, 2 data
# x 2 model ranks, B=16 x 40 frames of 112 x 112 (8 clips a data rank),
# against one process on all 16 (first, so its memory is given back), and one
# more step of each rank under torch.profiler for the collectives' ms; (b) the
# training CLI under torch.distributed.run with 2 gloo ranks on the card, one
# model group of 2 (VCAGAN_DIST_BACKEND=gloo: NCCL refuses two ranks on one
# device), B=8, 2 steps, the checkpoint of step 2 against one process's.
MA_WORLD, MA_MODEL = 4, 2
MA_BATCH = 16
MA_CLI_BATCH = 8
MA_TIMEOUT_S = 420
SPLIT_LEAVES = sorted(f"gen.att{i}.{d}.weight" for i in (1, 2) for d in ("q", "mel"))


def model_axis_ms(profile):
    """A rank's ms a step in the model axis's collectives (host time of the
    ``model_axis.*`` ranges: the call, its transfer and the wait for the
    group) and in the data axis's, from ``dryrun.profile_step``."""
    def total(prefix):
        return sum(v["host_ms"] for k, v in profile.items()
                   if k.startswith(prefix) and v is not None)

    return total("model_axis."), total("data_axis.")


def phase_model_axis_gate(card):
    """(a) ``python -m vcagan_torch.parallel.dryrun --world 4
    --model_parallel 2`` with gloo ranks sharing the card, fp32, at its
    tolerances: the deltas, the states' equality, each rank's attention
    calls and shapes, peak memory and the model axis's ms a step; then
    the attention alone at the rank's shapes.  Returns the readings and the
    two attention rows."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "vcagan_torch.parallel.dryrun", "--world", str(MA_WORLD),
           "--model_parallel", str(MA_MODEL), "--device", "cuda", "--backend", "gloo",
           "--batch", str(MA_BATCH), "--frames", str(TRAIN_WINDOW), "--image",
           str(DataConfig().crop_size), "--timeout", str(MA_TIMEOUT_S), "--profile"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=MA_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    check(proc.returncode == 0 and lines and json.loads(lines[-1])["ok"],
          f"model axis dryrun failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    r = json.loads(lines[-1])
    per_rank = MA_BATCH // (MA_WORLD // MA_MODEL)
    shapes = [[per_rank, TRAIN_WINDOW, TRAIN_WINDOW, 256],
              [per_rank, 2 * TRAIN_WINDOW, TRAIN_WINDOW, 256]]
    check((r["data"], r["model"]) == (MA_WORLD // MA_MODEL, MA_MODEL)
          and r["split_leaves"] == SPLIT_LEAVES, f"layout {r['data']} x {r['model']}, split "
          f"{r['split_leaves']}")
    check(r["attention_calls"] == [2] * MA_WORLD and all(a == shapes for a in r["attention"]),
          f"per-rank attention: calls {r['attention_calls']}, shapes {r['attention']}")
    axis_ms = [model_axis_ms(p) for p in r["profile"]]
    print(f"model axis (a) dryrun, {MA_WORLD} gloo ranks on one card ({MA_WORLD // MA_MODEL} "
          f"data x {MA_MODEL} model; (b) beside it), fp32, B={MA_BATCH} x {TRAIN_WINDOW} frames (112 x 112), "
          f"{per_rank} clips a data rank, the four attention projections split by column, "
          f"against one process on all {MA_BATCH}: metrics within {r['metric_rel']:.3e} "
          f"relative (bound 5e-4), generator-side leaf mean|p| (the split leaves "
          f"concatenated) within {r['leaf_stat']:.3e} (bound {r['leaf_stat_bound']:.1e}), "
          f"each module's gradient within {r['module_grad_bound']:g} relative L2 ("
          + ", ".join(f"{m} {v:.2e}" for m, v in r["module_grad_rel"].items()) + "), a leaf's "
          f"{r['grad_rel']:.3e} at worst ({r['grad_rel_leaf']}; reported, not bounded in fp32), "
          f"the replicated states equal bit for bit and the split leaves equal within each "
          f"model index; attention calls a rank {r['attention_calls']} at {shapes}, the single "
          f"process {r['reference_attention_calls']}; peak memory a rank "
          + ", ".join(f"{b / 1e9:.2f}" for b in r["peak_bytes"])
          + f" GB, the single process {r['reference_peak_bytes'] / 1e9:.2f} GB; the single "
          f"process {r['single_process_s']:.1f} s, the ranks {r['ranks_s']:.1f} s, {wall:.1f} s "
          f"in all [{card}]")
    for rank, (p, (model_ms, data_ms)) in enumerate(zip(r["profile"], axis_ms)):
        print(f"model axis (a) rank {rank}, one profiled step: {p['step_ms']:.1f} ms, the model "
              f"axis's collectives {model_ms:.2f} ms (" + ", ".join(
                  f"{k.split('.', 1)[1]} {v['host_ms']:.2f} ms (device {v['device_ms']:.2f}) x "
                  f"{v['calls']}"
                  for k, v in p.items() if k.startswith("model_axis.") and v)
              + f"), the data axis's {data_ms:.2f} ms (host time of the ranges, the wait for "
              f"the other ranks in it; 4 ranks share the card and gloo moves each collective "
              f"through the host) [{card}]")
    side = torch.cuda.Stream()
    rows = [attention_row(card, f"model axis per rank att{i + 1}", t, s_, d, [s_] * b, 410 + i,
                          side)
            for i, (b, t, s_, d) in enumerate(shapes)]
    keep = ("world", "data", "model", "split_leaves", "metric_rel", "leaf_stat",
            "leaf_stat_bound", "grad_rel", "grad_rel_leaf", "module_grad_rel",
            "module_grad_bound", "attention_calls", "attention", "reference_attention_calls",
            "peak_bytes",
            "reference_peak_bytes", "single_process_s", "ranks_s")
    out = {k: r[k] for k in keep}
    out.update(model_axis_ms=[a for a, _ in axis_ms], data_axis_ms=[b for _, b in axis_ms],
               profiled_step_ms=[p["step_ms"] for p in r["profile"]])
    return out, rows


def state_layout(tree):
    """The keys, shapes and dtypes of a saved train state."""
    if isinstance(tree, dict):
        return {k: state_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [state_layout(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype))
    return type(tree).__name__


def start_model_axis_cli(tmp):
    """(b) ``python -m torch.distributed.run --nproc_per_node 2 -m
    vcagan_torch.cli.train --model_parallel 2`` with gloo ranks on the card
    (synthetic GRID clips, B=8, 2 steps, the validation and checkpoint of
    step 2 on rank 0), started in the background.  Returns the process and
    its start time."""
    env = dict(os.environ, VCAGAN_DIST_BACKEND="gloo")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(MA_MODEL),
           "--master_addr", "localhost", "--master_port", str(_free_port()), "-m",
           "vcagan_torch.cli.train", "--model_parallel", str(MA_MODEL), "--grid",
           os.path.join(tmp, "no_corpus"), "--batch_size", str(MA_CLI_BATCH), "--max_steps",
           "2", "--eval_step", "2", "--epochs", "1", "--media_every", "0", "--checkpoint_dir",
           os.path.join(tmp, "ckpt"), "--log_dir", os.path.join(tmp, "log")]
    with open(os.path.join(tmp, "out"), "w") as out, open(os.path.join(tmp, "err"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err, text=True)
    return proc, time.perf_counter()


def finish_model_axis_cli(card, tmp, proc, t0):
    """(b) its end: exit 0, 2 train lines, and a checkpoint with one
    process's keys, shapes and dtypes that loads into one process.
    Returns the readings."""
    from vcagan_torch.io.checkpoint import STATE_FILE, CheckpointManager

    code = proc.wait(timeout=max(MA_TIMEOUT_S - (time.perf_counter() - t0), 1))
    wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "out")) as f:
        out = f.read()
    with open(os.path.join(tmp, "err")) as f:
        check(code == 0 and "Finishing training" in out,
              f"torchrun cli.train --model_parallel {MA_MODEL} failed ({code}):\n{out[-3000:]}"
              f"\n{f.read()[-3000:]}")
    lines = train_lines(os.path.join(tmp, "log"))
    check(len(lines) == 2, f"the metric stream holds {len(lines)} train lines, not 2")
    ckpt = os.path.join(tmp, "ckpt")
    paths = sorted(p for p in os.listdir(ckpt) if p.startswith("Epoch_"))
    check(len(paths) == 1, f"checkpoints {os.listdir(ckpt)}")
    path = os.path.join(ckpt, paths[0])
    modules = VCAGANModules.create(ModelConfig(), seed=0)
    state, _, _ = create_train_state(modules, TrainConfig(), device="cuda")
    one = CheckpointManager(os.path.join(tmp, "one")).save(
        state, 0, generator=torch.Generator("cuda"))
    saved, want = (torch.load(os.path.join(p, STATE_FILE), map_location="cpu", weights_only=True)
                   for p in (path, one))
    check(state_layout(saved) == state_layout(want),
          "the model axis's checkpoint differs from one process's in keys, shapes or dtypes")
    CheckpointManager(ckpt).restore(state, path)
    check(state.step == 2, f"restored step {state.step}")
    print(f"model axis (b) torch.distributed.run --nproc_per_node {MA_MODEL} -m "
          f"vcagan_torch.cli.train --model_parallel {MA_MODEL} (gloo ranks on one card, "
          f"B={MA_CLI_BATCH}, beside (a)): exit 0 in {wall:.1f} s, 2 train lines (gen_loss "
          + ", ".join(f"{x['train/gen_loss']:.3f}" for x in lines) + f"), its checkpoint "
          f"{paths[0]} with one process's keys, shapes and dtypes, restored into one process "
          f"at step {state.step} [{card}]")
    del modules, state, saved, want
    torch.cuda.empty_cache()
    return dict(cli_s=wall, checkpoint_layout_equal=True)


def phase_fourteen(card):
    """Phase 14: (b) started first, then (a) beside it.  Returns the
    readings for the kernels line."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_model_axis_")
    proc, t0 = start_model_axis_cli(tmp)
    try:
        gate, rows = phase_model_axis_gate(card)
        torch.cuda.empty_cache()
        cli = finish_model_axis_cli(card, tmp, proc, t0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches_model_axis_dryrun": gate["attention_calls"], "model_axis_dryrun": gate,
            "model_axis_cli": cli, "per_rank_shapes_model_axis": rows}


# Phase 15: the train step's knobs (``d_phase`` and the remat sites).  (a)
# From one state, batch and generator seed, one fp32 step under each knob,
# held to "ref"/"none": metrics and gradient norms (relative), each
# module's first moment (STEP_GRAD_REL, relative L2), the BatchNorm
# statistics within KNOB_STATS_REL of their move and num_batches_tracked
# equal, the generator's state equal.  "ref"/"none" runs twice: the second
# is the card's own spread (its backward convolutions sum in no fixed
# order).  (b) ms a step, peak memory and kernel launches a step under
# each knob, GRID fp32 and bf16, and LRS2 bf16 under "batched" and "ref".
KNOB_RUNS = (("ref", "none"), ("batched", "none"), ("ref", "stem"), ("ref", "vfront"),
             ("ref", "r1"), ("batched", "stem,r1"))
KNOB_STEPS = 3  # counted, after the first step (the warm-up, and in (a) the compared one)
KNOB_METRIC_RTOL, KNOB_NORM_RTOL = 1e-4, 2e-4
KNOB_STATS_REL = 1e-5


def knob_name(knobs):
    return "/".join(knobs)


def live_tensors(state):
    """Every tensor a step writes: parameters, buffers, optimizer moments."""
    tensors = [t for _, m in state.modules.named() for t in [*m.parameters(), *m.buffers()]]
    for opt in (state.g_opt_state, state.d_opt_state):
        tensors += [*opt.mu, *opt.nu, *(opt.nu_max or [])]
    return tensors


def module_moments(state):
    """Each module's first moments (device tensors, by module name)."""
    out = {}
    for side, opt in ((GENERATOR_SIDE, state.g_opt_state), (DISCRIMINATOR_SIDE, state.d_opt_state)):
        first = 0
        for name in side:
            n = len(list(getattr(state.modules, name).parameters()))
            out[name] = opt.mu[first:first + n]
            first += n
    return out


def foreach_rel(got, want):
    num = torch.stack(torch._foreach_norm(torch._foreach_sub(got, want))).square().sum()
    return (num.sqrt() / torch.stack(torch._foreach_norm(want)).square().sum().sqrt()).item()


def kernel_launches(device):
    """Kernels among the profiler's device activities (copies and fills
    left out)."""
    return sum(not name.startswith(("Memcpy", "Memset")) for name, _, _ in device)


def knob_steps(card, what, model_config, train_config, batch, runs, compare=False,
               timed=None, profile=()):
    """One bundle from seed 0 on the card, its state reset to the same
    start before each of ``runs``: the first step (with ``compare``, held
    to the first run's; a run named twice is only compared, the card's own
    spread), then, for the runs named in ``timed`` (all where None),
    KNOB_STEPS counted steps (one sync) with the parts' CUDA events and
    peak memory over them, and for those named in ``profile`` one step
    under torch.profiler for the kernel launches a step.  Returns the
    readings by run."""
    from vcagan_torch.nn.common import RECOMPUTES

    modules = VCAGANModules.create(model_config, seed=0)
    state, g_tx, d_tx = create_train_state(modules, train_config, device="cuda")
    tensors = live_tensors(state)
    start = [t.detach().clone() for t in tensors]
    buffers = {(n, k): t for n, m in modules.named() for k, t in m.named_buffers()}
    initial = {key: t.detach().clone() for key, t in buffers.items()}
    b, w = batch.video.shape[:2]
    marks = []

    def on_phase(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks[-1].append(event)

    first = None
    out = {}
    for knobs in runs:
        name = knob_name(knobs)
        again = name in out
        name += " again" if again else ""
        with torch.no_grad():
            for t, t0 in zip(tensors, start):
                t.copy_(t0)
        state.step = state.g_opt_state.count = state.d_opt_state.count = 0
        step = make_train_step(modules, g_tx, d_tx, train_config, d_phase=knobs[0],
                               remat=knobs[1], on_phase=on_phase)
        generator = torch.Generator("cuda").manual_seed(0)
        RECOMPUTES.clear()
        reset_launches()
        marks.append([])
        on_phase("start")
        metrics = {k: v.item() for k, v in step(state, batch, generator)[1].items()}
        recomputes = dict(RECOMPUTES)
        sites = [site for site in knobs[1].split(",") if site != "none"]
        want = {site: 2 * 3 if site == "r1" else 1 for site in sites}
        check(recomputes == want, f"knobs {what} {name}: recomputes {recomputes} in a step, not "
              f"{want} (r1: each discriminator twice)")
        check_calls(2, 0, f"knobs {what} {name}, a step")
        for k, v in metrics.items():
            check(np.isfinite(v), f"knobs {what} {name}: {k} = {v}")
        reading = {"recomputes_first_step": recomputes}
        if compare:
            mine = dict(metrics=metrics, generator=generator.get_state(),
                        moments={k: [t.clone() for t in v]
                                 for k, v in module_moments(state).items()},
                        buffers={key: t.detach().clone() for key, t in buffers.items()})
            if first is None:
                first = mine
            else:
                reading.update(knob_against(card, what, name, mine, first, initial))
            del mine
        if again or (timed is not None and name not in timed):
            out[name] = reading
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the phase's own copies (the start, ref/none's moments and statistics)
        held = sum(t.numel() * t.element_size() for t in start)
        if first is not None:
            held += sum(t.numel() * t.element_size()
                        for ts in first["moments"].values() for t in ts)
            held += sum(t.numel() * t.element_size() for t in first["buffers"].values())
        marks.clear()
        reset_launches()
        t0 = time.perf_counter()
        counted = []
        for _ in range(KNOB_STEPS):
            marks.append([])
            on_phase("start")
            counted.append(step(state, batch, generator)[1])
        table = {k: torch.stack([m[k] for m in counted]).cpu() for k in counted[0]}
        elapsed = time.perf_counter() - t0
        check_calls(2 * KNOB_STEPS, 0, f"knobs {what} {name}, {KNOB_STEPS} steps")
        for k, v in table.items():
            check(bool(torch.isfinite(v).all()), f"knobs {what} {name}: {k} {v.tolist()}")
        parts = {p: statistics.median(m[i].elapsed_time(m[i + 1]) for m in marks)
                 for i, p in enumerate(TRAIN_PHASES)}
        peak = torch.cuda.max_memory_allocated()
        reading.update(ms_a_step=elapsed / KNOB_STEPS * 1e3, peak_gb=(peak - held) / 1e9,
                       peak_with_copies_gb=peak / 1e9,
                       attention_launches_a_step=count_of("attention.calls") / KNOB_STEPS,
                       parts_ms=parts)
        if name in profile:
            marks.append([])
            on_phase("start")
            device, _ = profiled(lambda: step(state, batch, generator))
            reading["kernel_launches_a_step"] = kernel_launches(device)
            reading["device_activities_a_step"] = len(device)
        print(f"knobs {what} B={b} x {w} {name}: {reading['ms_a_step']:.1f} ms a step "
              f"({KNOB_STEPS} counted after the first, one sync), peak "
              f"{reading['peak_gb']:.2f} GB ({reading['peak_with_copies_gb']:.2f} with this "
              f"phase's copies), {reading['attention_launches_a_step']:g} attention "
              f"calls a step, "
              + (f"{reading['kernel_launches_a_step']} kernel launches in one profiled step, "
                 if name in profile else "")
              + f"recomputes in a step {recomputes}; parts " + ", ".join(
                  f"{k} {v:.2f}" for k, v in parts.items()) + f" ms [{card}]")
        out[name] = reading
    del start, tensors, buffers, state, modules, first
    torch.cuda.empty_cache()
    return out


def knob_against(card, what, name, mine, first, initial):
    """(a) One step under a knob against the first run's ("ref"/"none");
    ``initial``: the BatchNorm buffers before the step."""
    worst = 0.0
    for k, want in first["metrics"].items():
        got = mine["metrics"][k]
        rtol = KNOB_NORM_RTOL if k in ("g_grad_norm", "d_grad_norm") else KNOB_METRIC_RTOL
        rel = abs(got - want) / max(abs(want), 1e-12)
        check(rel <= rtol, f"knobs {what} {name}: {k} {got} against {want} (relative {rel:.2e}, "
              f"bound {rtol:g})")
        worst = max(worst, rel)
    grads = {m: foreach_rel(mine["moments"][m], first["moments"][m]) for m in first["moments"]}
    for m, rel in grads.items():
        check(rel <= STEP_GRAD_REL, f"knobs {what} {name}: {m}'s gradient {rel:.3e} from ref/none")
    stats = {}
    for m in ("v_front", "gen", "post", "s_dis"):
        keys = [key for key in initial if key[0] == m and "running" in key[1]]
        moved = torch.cat([(first["buffers"][key] - initial[key]).flatten() for key in keys])
        off = torch.cat([(mine["buffers"][key] - first["buffers"][key]).flatten() for key in keys])
        stats[m] = (torch.linalg.vector_norm(off) / torch.linalg.vector_norm(moved)).item()
        check(stats[m] <= KNOB_STATS_REL, f"knobs {what} {name}: {m}'s BatchNorm statistics "
              f"{stats[m]:.3e} of their move from ref/none's")
        counts = [key for key in initial if key[0] == m and key[1].endswith("num_batches_tracked")]
        check(all(torch.equal(mine["buffers"][key], first["buffers"][key]) for key in counts),
              f"knobs {what} {name}: {m}'s num_batches_tracked differ from ref/none's")
    check(torch.equal(mine["generator"], first["generator"]),
          f"knobs {what} {name}: the generator's state differs from ref/none's")
    print(f"knobs {what} {name} against ref/none, one step: metrics within {worst:.2e} "
          f"relative (bounds {KNOB_METRIC_RTOL:g}, gradient norms {KNOB_NORM_RTOL:g}), first "
          "moments " + ", ".join(f"{m} {r:.2e}" for m, r in grads.items())
          + f" (bound {STEP_GRAD_REL:g}), BatchNorm statistics " + ", ".join(
              f"{m} {r:.2e}" for m, r in stats.items())
          + f" of their move (bound {KNOB_STATS_REL:g}); counts and the generator's state "
          f"equal [{card}]")
    return {"metric_rel": worst, "moment_rel": grads, "stats_rel": stats}


def phase_fifteen(card):
    """Phase 15: the train step's knobs on the card.  (a) and (b) at the
    GRID shape, B=88 x 40 frames, fp32 with dropout on (the compared
    steps; "batched"/"stem,r1" is compared and not timed) and bf16 (the
    five single knobs); (b) at the LRS2 shape, B=16 x 50, bf16, "batched"
    against "ref".  The kernel launches a step are counted in bf16, under
    "ref" and "batched" (a profiled step takes seconds).  Returns the
    readings for the kernels line."""
    grid = train_batch(TRAIN_BATCH, TRAIN_WINDOW, seed=5, device="cuda")
    single = KNOB_RUNS[:5]
    phases = ("ref/none", "batched/none")
    runs = {
        "GRID fp32": knob_steps(card, "GRID fp32", ModelConfig(), TrainConfig(), grid,
                                KNOB_RUNS[:1] + KNOB_RUNS, compare=True,
                                timed={knob_name(k) for k in single}),
        "GRID bf16": knob_steps(card, "GRID bf16", ModelConfig(use_bfloat16=True),
                                TrainConfig(), grid, single, profile=phases),
    }
    del grid
    lrs = train_batch(LRS_BATCH, LRS_WINDOW, seed=6, device="cuda")
    runs["LRS2 bf16"] = knob_steps(
        card, "LRS2 bf16", dataclasses.replace(LRS_CONFIG.model, use_bfloat16=True),
        LRS_CONFIG.train, lrs, KNOB_RUNS[:2], profile=phases)
    for what, readings in runs.items():
        print(f"knobs {what}: " + "; ".join(
            f"{name} {r['ms_a_step']:.1f} ms, {r['peak_gb']:.2f} GB"
            + (f", {r['kernel_launches_a_step']} kernels" if "kernel_launches_a_step" in r else "")
            for name, r in readings.items() if "ms_a_step" in r) + f" [{card}]")
    launches = {what: {name: r["attention_launches_a_step"] for name, r in readings.items()
                       if "ms_a_step" in r} for what, readings in runs.items()}
    return {"launches_train_knobs": launches, "train_knobs": runs}


# Phase 16: every width the JAX package runs.  (a) The attention at D not a
# multiple of 8 (padded to one), D past 256 past 512 keys (column slices),
# a strip too large for shared memory (the key-blocked instance) and a batch
# past the grid's 65535 (chunks of samples); (b) the fused block past 2^31
# elements (chunks of images).
WIDTH_ATTENTION = (
    *((f"D={d} S={s_}", 3, 75, s_, d, [0, s_, s_ // 2 + 1]) for d in (4, 12, 100)
      for s_ in (21, 75, 600)),
    *((f"D={d} S={s_}", 4, s_, s_, d, [0, s_, s_ - 37, s_ // 3 + 1]) for d in (264, 512, 1024)
      for s_ in (600, 750)),
    ("(64, 512, 4096)", 2, 64, 512, 4096, [512, 0]),
    ("B=70000", 70_000, 2, 3, 8, None),
)
# (c) Narrow models: the test widths (tests/test_torch_loop.py) on 48 x 48
# frames, one width under test each.
NARROW_MODEL = dict(gru_hidden=32, noise_dim=16, attention_inner=160, postnet_channels=32)
WIDTH_MODELS = (  # name, ModelConfig overrides, folded + fused, B, T
    ("attention_dim 12", dict(attention_dim=12), False, 2, 75),
    ("attention_dim 264", dict(attention_dim=264), False, 2, 75),
    ("stem_channels 16, folded + fused", dict(stem_channels=16), True, 2, 75),
    ("S=600, attention_dim 264", dict(attention_dim=264), False, 1, 600),
)


class plain_versions_refused:
    """Inside: ``masked_attention_reference`` and ``fused_block_reference``
    raise on a CUDA tensor, so a dispatcher that sent one to a plain version
    fails; ``plain`` keeps the two for this phase's oracle."""

    def __enter__(self):
        self.plain = (attn.masked_attention_reference, fb.fused_block_reference)

        def refuse(fn):
            def guarded(*args, **kw):
                check(not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args),
                      f"{fn.__name__} was reached with a CUDA tensor")
                return fn(*args, **kw)
            return guarded

        attn.masked_attention_reference, fb.fused_block_reference = map(refuse, self.plain)
        return self

    def __exit__(self, *exc):
        attn.masked_attention_reference, fb.fused_block_reference = self.plain


def width_attention(card, oracle):
    """(a) Each case through ``masked_cross_attention``, one launch counted,
    against the plain version and float64 (``ATTN_TOL``), length-0 rows
    against the mean of their values; then the kernel, the plain version and
    sdpa timed by CUDA-graph replay beside the bound of the true shape's
    work.  Returns the rows."""
    side = torch.cuda.Stream()
    rng = np.random.default_rng(16)
    rows = []
    for i, (name, b, t, s_, d, lengths) in enumerate(WIDTH_ATTENTION):
        if lengths is None:
            lengths = rng.integers(-1, s_ + 2, b).tolist()
        q, k, v, lens = attention_inputs(b, t, s_, d, lengths, seed=1600 + i)
        plan = attn.attention_plan(t, s_, d, b)
        before = count_of("attention.calls"), count_of("attention.launches")
        got = attn.masked_cross_attention(q, k, v, lens)
        torch.cuda.synchronize()
        calls = count_of("attention.calls") - before[0]
        launches = count_of("attention.launches") - before[1]
        check(calls == 1 and launches == attn.kernel_launches(plan, b),
              f"width {name}: {calls} calls, {launches} launches counted, not 1 and "
              f"{attn.kernel_launches(plan, b)}")
        want = oracle(q, k, v, lens)
        want64 = oracle(q.double(), k.double(), v.double(), lens)
        err = (got - want).abs().max().item()
        err64 = (got.double() - want64).abs().max().item()
        zero = [j for j, n in enumerate(lengths) if n <= 0][:64]
        zero_err = max([(got[j].double() - v[j].double().mean(0)).abs().max().item()
                        for j in zero], default=0.0)
        check(got.shape == (b, t, d) and torch.isfinite(got).all().item(),
              f"width {name}: shape {tuple(got.shape)} or non-finite output")
        check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL) and err64 < ATTN_TOL
              and zero_err < ATTN_TOL, f"width {name} {b, t, s_, d}: kernel vs plain {err:.3e}, "
              f"vs float64 {err64:.3e}, length-0 rows vs the mean {zero_err:.3e}")
        del want64
        in_err = None if attn.instance(plan) == "in_block" else check_in_block(
            f"width {name}", q, k, v, lens, oracle)
        kw = dict(samples=5, calls=5)
        by_instance = instance_ms(q, k, v, lens, side, samples=5)
        ms = graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens), side, **kw)
        plain = graph_ms(lambda: oracle(q, k, v, lens), side, **kw)
        mask = key_mask(k, lens)
        lib = graph_ms(lambda: sdpa(q, k, v, mask), side, **kw)
        nbytes, flops = attention_work_lengths(b, t, s_, d, lengths)
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ATTN_FLOP_PER_S * 1e3
        bound, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
        print(f"width attention {name} B={b} T={t} S={s_} D={d} (kernel D {plan.d_kernel}; "
              f"{attn.instance(plan)}: {plan.describe()}): max_abs_err {err:.3e} (vs float64 "
              f"{err64:.3e}, length-0 rows vs the mean {zero_err:.3e}"
              + ("" if in_err is None else f", the in-block instance forced {in_err:.3e}")
              + f") ok; kernel {ms:.4f} ms, by instance "
              + ", ".join(f"{n} {m:.4f} ms" for n, m in by_instance.items())
              + f"; plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms ({bound_by}) "
              f"[{card}]")
        rows.append({"name": name, "shape": [b, t, s_, d], "d_kernel": plan.d_kernel,
                     "instance": attn.instance(plan), "plan": plan.describe(), "ms": ms,
                     "ms_by_instance": by_instance, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound, "bound_by": bound_by,
                     "max_abs_err": max(err, err64, in_err or 0.0)})
        del q, k, v, lens, got, want, mask
        torch.cuda.empty_cache()
    return rows


def width_blocks(card, oracle):
    """(b) One bf16 call through ``fused_basic_block`` past 2^31 elements
    (two chunks of images), one launch counted, timed once; its first
    images, those around the chunks' border and its last against the plain
    version (``FB_BF16_TOL``).  Returns its row."""
    bf16 = torch.bfloat16
    h = w = 28
    c = 64
    per_launch = (2**31 - 1) // (h * w * c)
    n = per_launch + 100
    g = torch.Generator(device="cuda").manual_seed(1799)
    x = torch.randn((n, h, w, c), generator=g, device="cuda", dtype=bf16)
    _, w1, b1, a1, w2, b2, a2 = fused_block_inputs(1, h, w, c, seed=1798)
    before = count_of("fused_block.calls"), count_of("fused_block.launches")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = fb.fused_basic_block(x, w1, b1, a1, w2, b2, a2)
    ev[1].record()
    torch.cuda.synchronize()
    calls = count_of("fused_block.calls") - before[0]
    launches = count_of("fused_block.launches") - before[1]
    check(calls == 1 and launches == 2, f"past 2^31: {calls} calls and {launches} launches "
          "counted, not 1 and 2 (two chunks of images)")
    errs = []
    for lo in (0, per_launch - 64, n - 128):
        want = oracle(x[lo:lo + 128], w1, b1, a1, w2, b2, a2)
        errs.append((got[lo:lo + 128].float() - want.float()).abs().max().item())
        check(torch.allclose(got[lo:lo + 128].float(), want.float(), rtol=FB_BF16_TOL,
                             atol=FB_BF16_TOL), f"past 2^31, images {lo}...: {errs[-1]:.3e}")
    print(f"width fused_block past 2^31 elements: N={n} {h}x{w}x{c} bf16 "
          f"({n * h * w * c} elements, chunks of {per_launch} images): one call "
          f"{ev[0].elapsed_time(ev[1]):.2f} ms, images 0-127, {per_launch - 64}-"
          f"{per_launch + 63} and the last 128 vs plain max abs err "
          f"{', '.join(f'{e:.3e}' for e in errs)} ok [{card}]")
    row = {"name": "past 2^31", "form": "bf16", "shape": [n, h, w, c],
           "ms_one_call": ev[0].elapsed_time(ev[1]), "max_abs_err": max(errs)}
    del x, got
    torch.cuda.empty_cache()
    return [row]


def width_models(card):
    """(c) Narrow models card against CPU (fp32, random init from seed 0,
    the same noise and Griffin-Lim phase) at ``PATH_TOL`` and
    ``WAV_REL_L2``: 2 attention calls a forward, and on the folded +
    fused path one fused-block launch for each identity-shortcut block (4
    with stem_channels 16: the first block of the trunk then takes a
    projection, in the JAX package too)."""
    rng = np.random.default_rng(18)
    for name, overrides, fused, b, t in WIDTH_MODELS:
        config = ModelConfig(**NARROW_MODEL, **overrides)
        video = rng.standard_normal((b, t, 48, 48, 1)).astype(np.float32)
        lengths = np.asarray([t, t - 20][:b], np.int32)
        noise = rng.standard_normal((b, 20, t, config.noise_dim)).astype(np.float32)
        phase = rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32)
        kw = dict(fold_bn=fused, fused_blocks=fused)
        on_card = Synthesizer(config, device="cuda", **kw)
        fused_blocks = sum(isinstance(m, BasicBlock) and m.fused
                           for m in on_card.v_front.modules())
        check(fused_blocks == (4 if fused else 0), f"{name}: {fused_blocks} fused blocks")
        reset_launches()
        got = on_card(video, lengths, noise=noise, init_phase=phase)
        torch.cuda.synchronize()
        check_calls(2, fused_blocks, f"{name}, one forward")
        want = Synthesizer(config, device="cpu", **kw)(video, lengths, noise=noise,
                                                       init_phase=phase)
        compare_outputs(f"width model {name}, card vs CPU", got, want, PATH_TOL, WAV_REL_L2)
        print(f"width model {name} B={b} T={t} (48 x 48 frames): card vs CPU ok, "
              f"{count_of('attention.calls')} attention and {count_of('fused_block.calls')} "
              f"fused-block calls [{card}]")
        del on_card, got, want


def width_synth_512(card, oracle):
    """(d) The full-width ``Synthesizer`` with attention_dim 512 on B=2 clips
    of 750 frames (30 s; lengths 750 and 513), fp32 and bf16, on the card:
    its two attention calls (past 512 keys, D in two column slices) held to
    the plain version on their own inputs, one forward timed."""
    import vcagan_torch.nn.attention as attention_module

    b, t = 2, LONG_FRAMES
    rng = np.random.default_rng(19)
    video = rng.standard_normal((b, t, 112, 112, 1)).astype(np.float32)
    lengths = np.asarray([t, 513], np.int32)
    kernel = attention_module.masked_cross_attention
    calls = []

    def recorded(q, k, v, lens):
        out = kernel(q, k, v, lens)
        calls.append((q, k, v, lens, out))
        return out

    attention_module.masked_cross_attention = recorded
    try:
        for bf16 in (False, True):
            mode = "bf16" if bf16 else "fp32"
            synth = Synthesizer(ModelConfig(attention_dim=512, use_bfloat16=bf16), device="cuda")
            synth(video, lengths)  # warm-up
            torch.cuda.synchronize()
            calls.clear()
            reset_launches()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            got = synth(video, lengths)
            ev[1].record()
            torch.cuda.synchronize()
            check(count_of("attention.calls") == 2 and len(calls) == 2,
                  f"attention_dim 512 {mode}: {count_of('attention.calls')} attention calls a "
                  "forward")
            check(all(torch.isfinite(o).all().item() for o in got.values()),
                  f"attention_dim 512 {mode}: non-finite output")
            errs = []
            for q, k, v, lens, out in calls:
                want = oracle(q, k, v, lens)
                errs.append((out - want).abs().max().item())
                check(torch.allclose(out, want, rtol=ATTN_TOL, atol=ATTN_TOL),
                      f"attention_dim 512 {mode} {tuple(q.shape)}: kernel vs plain {errs[-1]:.3e}")
            shapes = [tuple(q.shape) + (k.shape[1],) for q, k, *_ in calls]
            print(f"width Synthesizer attention_dim 512 {mode} B={b} x {t} frames (lengths "
                  f"{lengths.tolist()}; attention (B, T, D, S) {shapes}): one forward "
                  f"{ev[0].elapsed_time(ev[1]):.1f} ms on the card, 2 attention calls, "
                  f"each vs plain max abs err {', '.join(f'{e:.3e}' for e in errs)} ok [{card}]")
            del synth, got
            calls.clear()
            torch.cuda.empty_cache()
    finally:
        attention_module.masked_cross_attention = kernel


def phase_sixteen(card):
    """Phase 16: (a)-(d) with the plain versions refused on CUDA tensors.
    Returns the rows for the kernels line."""
    with plain_versions_refused() as guard:
        oracle_attn, oracle_block = guard.plain
        rows_attn = width_attention(card, oracle_attn)
        rows_block = width_blocks(card, oracle_block)
        width_models(card)
        width_synth_512(card, oracle_attn)
    return rows_attn, rows_block


# Phase 17, Griffin-Lim's forms.  The card's published float32 rate
# outside the tensor cores (the fp32 matmul form runs with TF32 off).
FP32_FLOP_PER_S = 67e12
GL_FORMS = (("fft fp32", None), ("kernel fp32", "kernel"), ("matmul fp32", torch.float32),
            ("matmul bf16", torch.bfloat16))
# (B, mel frames): the serving and GRID test batches, an LRS bucket of 160
# video frames and the shortest clip the kernel takes; the matmul forms are
# timed at the first two only.
GL_SHAPES = ((48, 300), (100, 300), (8, 640), (1, 4))
GL_MATMUL_SHAPES = GL_SHAPES[:2]
GL_PARAMS = STFTParams()  # AudioConfig's 640 / 160 / 640
GL_ROUNDS = AudioConfig().griffin_lim_iters
GL_CHECK_ROUNDS = 20
# The fp32 matmul form on the card against the FFT form on the card and
# against the FFT form on the CPU (the port's route off the card) at 20
# rounds: the JAX package's bound for its matmul form against its FFT form
# (tests/test_dsp.py:200-217).  bf16 with no round against the same bf16
# operands multiplied and summed in float64: fp32 sums of 642 products,
# about sqrt(642) x 2^-24 of their scale, held at 1e-5 of the waveform's
# peak (a result rounded to bf16 would be 2e-3 off).
GL_FP32_TOL = 5e-5
GL_BF16_SYNTH_REL = 1e-5
# The Griffin-Lim kernel rounds where the FFT form rounds, on the same cuFFT
# transforms: against the FFT form on the card, and against its plain twin,
# it is held to the 20-round bound above at every round count; against a
# float64 FFT form to that form's own fp32 distance plus that bound (after
# 60 rounds the phases of near-silent bins part by more than fp32 rounding
# in either fp32 form), and with no round (one synthesis) to 1e-6 of the
# waveform's peak.
GL_SYNTH_REL = 1e-6


def gl_form(dtype, mag, rounds, phase=None, generator=None):
    """One Griffin-Lim form on ``mag``: the FFT form for ``dtype`` None, the
    kernel for "kernel", else ``griffin_lim_mxu`` in ``dtype``."""
    if dtype is None:
        return griffin_lim(mag, GL_PARAMS, rounds, init_phase=phase, generator=generator)
    if dtype == "kernel":
        return gl_kernel.griffin_lim_cuda(mag, GL_PARAMS, rounds, init_phase=phase,
                                          generator=generator)
    return griffin_lim_mxu(mag, GL_PARAMS, rounds, compute_dtype=dtype, init_phase=phase,
                           generator=generator)


def gl_work(b, t, dtype):
    """(bytes, flops, flop rate, state bytes) of one 60-round call at (B, T):
    the magnitudes and the phase read once and the waveform written once;
    the matmul form's products, 8 B T n_bins n_fft flops a round and half
    that for the last synthesis (the FFT form's transforms, 2.5 n log2 n
    flops a real 640-point FFT, two a round and one at the end), at the
    rate of the compute dtype; and the state every round must at least
    write and read again (the spectrum as [re | im] fp32 and the signal),
    which unfused elementwise passes multiply."""
    k, n, hop = GL_PARAMS.n_bins, GL_PARAMS.n_fft, GL_PARAMS.hop_length
    nbytes = 2 * b * t * k * 4 + b * hop * (t - 1) * 4
    if dtype is None:
        flops = (2 * GL_ROUNDS + 1) * b * t * 2.5 * n * np.log2(n)
    else:
        flops = (8 * GL_ROUNDS + 4) * b * t * k * n
    rate = BF16_TC_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    state = GL_ROUNDS * 2 * (b * t * 2 * k * 4 + b * hop * (t + 3) * 4)
    return nbytes, flops, rate, state


def speechish(n, seed):
    """Three amplitude-modulated partials (the JAX package's inverse-DSP
    parity signal, tests/test_inverse_dsp_parity.py:127-134)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = np.zeros_like(t)
    for f0 in (150.0, 450.0, 1200.0):
        am = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        x += am * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def gl_convergence(what, mag, recs, card):
    """The JAX package's bf16 quality bounds (tests/test_dsp.py:231-272) on
    two reconstructions {"fp32", "bf16"} of ``mag``: spectral convergence
    sc32 < 0.35 and sc16 < 0.40, sc16 < 1.2 sc32 + 0.02, log-magnitude
    correlation > 0.99."""
    mags = {d: stft(r, GL_PARAMS).abs() for d, r in recs.items()}
    sc = {d: (torch.linalg.vector_norm(m - mag) / torch.linalg.vector_norm(mag)).item()
          for d, m in mags.items()}
    corr, _ = corr_rel(torch.log(1e-5 + mags["bf16"]), torch.log(1e-5 + mags["fp32"]))
    print(f"griffin-lim bf16 vs fp32 on {what}: sc32 {sc['fp32']:.4f}, sc16 {sc['bf16']:.4f}, "
          f"log-magnitude correlation {corr:.5f} [{card}]")
    check(sc["fp32"] < 0.35 and sc["bf16"] < 0.40, f"{what}: spectral convergence {sc}")
    check(sc["bf16"] < 1.2 * sc["fp32"] + 0.02, f"{what}: bf16 converges worse {sc}")
    check(corr > 0.99, f"{what}: log-magnitude correlation {corr:.5f}")
    return {"sc32": sc["fp32"], "sc16": sc["bf16"], "log_mag_corr": corr}


def gl_checks(card, states):
    """(a) The fp32 matmul form on the card against the FFT form on the card
    and on the CPU (the port's route there), each against a float64 run of
    the matmul form on the CPU (printed), and the bf16 synthesis against
    its bf16 operands in float64;
    (b) bf16 against fp32 by the JAX package's bounds on its multi-tone
    signal and on the postnet spectrogram of the trained weights at B=48."""
    clips = np.stack([speechish(160 * 299, 31 + i) for i in range(4)])
    mag = stft(torch.from_numpy(clips).cuda(), GL_PARAMS).abs()  # (4, 300, 321)
    phase = torch.from_numpy(np.random.default_rng(17).uniform(
        -np.pi, np.pi, mag.shape).astype(np.float32)).cuda()
    fft = gl_form(None, mag, GL_CHECK_ROUNDS, phase)
    mm = gl_form(torch.float32, mag, GL_CHECK_ROUNDS, phase)
    cpu = gl_form(None, mag.cpu(), GL_CHECK_ROUNDS, phase.cpu())
    errs = {"matmul fp32 vs fft fp32, card": (mm - fft).abs().max().item(),
            "matmul fp32 card vs fft fp32 CPU": (mm.cpu() - cpu).abs().max().item()}
    exact = gl_form(torch.float64, mag.cpu().double(), GL_CHECK_ROUNDS, phase.cpu().double())
    runs = {"matmul fp32, card": mm, "fft fp32, card": fft, "fft fp32, CPU": cpu,
            "matmul fp32, CPU": gl_form(torch.float32, mag.cpu(), GL_CHECK_ROUNDS, phase.cpu())}
    print(f"griffin-lim {GL_CHECK_ROUNDS} rounds, (4, 300, 321), max abs err against a float64 "
          f"matmul form on the CPU: " + ", ".join(
              f"{what} {(run.cpu().double() - exact).abs().max().item():.3e}"
              for what, run in runs.items()) + f" [{card}]")
    synth16 = gl_form(torch.bfloat16, mag, 0, phase).cpu().double()
    # the one synthesis of no round, in float64 on the bf16 operands: the
    # spectrum rounded to bf16 as the matmul form rounds it, the fp32-rounded
    # bases rounded to bf16 as its bases, then every step in float64
    spectrum = (mag.repeat(1, 1, 2) * torch.cat([phase.cos(), phase.sin()], -1)).bfloat16()
    basis = torch.as_tensor(np.concatenate(dft_bases(GL_PARAMS)[2:], 0).astype(np.float32))
    frames = spectrum.cpu().double() @ basis.bfloat16().double()
    corr = _wss_correction(300, GL_PARAMS, torch.device("cpu"), torch.float64)
    exact16 = (overlap_add(frames, GL_PARAMS) * corr)[:, 320:-320]
    bf16_rel = ((synth16 - exact16).abs().max() / exact16.abs().max()).item()
    check(mm.shape == fft.shape == (4, 160 * 299), f"griffin-lim shapes {mm.shape} {fft.shape}")
    for what, err in errs.items():
        print(f"griffin-lim {what}, {GL_CHECK_ROUNDS} rounds, (4, 300, 321): max abs err "
              f"{err:.3e} (peak {fft.abs().max().item():.3f}) [{card}]")
        check(err < GL_FP32_TOL, f"griffin-lim {what}: {err:.3e}")
    print(f"griffin-lim matmul bf16 synthesis (no round) on the card against its bf16 operands "
          f"in float64: {bf16_rel:.3e} of the peak [{card}]")
    check(bf16_rel < GL_BF16_SYNTH_REL, f"bf16 synthesis against float64 {bf16_rel:.3e}")

    t = np.arange(16000) / 16000
    tone = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1310 * t)
            + 0.05 * np.random.default_rng(7).standard_normal(t.shape)).astype(np.float32)
    tone_mag = stft(torch.from_numpy(tone[None]).cuda(), GL_PARAMS).abs()
    # the CPU test's draw of the phase (tests/test_torch_griffin_lim_mxu.py):
    # the JAX package's correlation bound is one draw's, and spreads over
    # draws (0.9878-0.9915 over the JAX package's own keys 0-7)
    tone_phase = random_phase(tone_mag.shape, torch.Generator().manual_seed(3),
                              torch.device("cpu")).cuda()
    quality = {"multi-tone": gl_convergence("the multi-tone signal", tone_mag, {
        d: gl_form(dtype, tone_mag, GL_ROUNDS, tone_phase)
        for d, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}, card)}
    synth = Synthesizer(device="cuda").load_state_dicts(states)
    video = np.random.default_rng(2).standard_normal((48, 75, 112, 112, 1)).astype(np.float32)
    spec = synth(video, np.full(48, 75, np.int32))["spec"]  # (48, 300, 321), fp32
    del synth
    quality["postnet B=48"] = gl_convergence("the trained postnet's spectrogram, B=48", spec, {
        d: gl_form(dtype, spec, GL_ROUNDS, generator=torch.Generator("cuda").manual_seed(3))
        for d, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}, card)
    return {"max_abs_err": errs, "bf16_synthesis_rel": bf16_rel, "quality": quality}


def gl_times(card):
    """(c) Device ms (CUDA events around one call, median of 10 after 2
    warm-ups) of the FFT form and the kernel at ``GL_SHAPES`` and of the
    matmul forms at ``GL_MATMUL_SHAPES``, each beside its bound, and one
    bf16 matmul call at the serving shape under ``torch.profiler`` (busy
    share, the kernels that take the most time)."""
    rows = []
    for b, t in GL_SHAPES:
        mag = torch.rand((b, t, 321), generator=torch.Generator("cuda").manual_seed(b),
                         device="cuda") * 10.0
        for name, dtype in GL_FORMS:
            if (b, t) not in GL_MATMUL_SHAPES and name.startswith("matmul"):
                continue
            gen = torch.Generator("cuda").manual_seed(0)
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: gl_form(dtype, mag, GL_ROUNDS, generator=gen), samples=10,
                         calls=1, warmup=2)
            nbytes, flops, rate, state = gl_work(b, t, None if dtype == "kernel" else dtype)
            t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
            row = {"form": name, "shape": [b, t, 321], "rounds": GL_ROUNDS, "ms": ms,
                   "bound_ms": max(t_bytes, t_flops),
                   "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                   "tflop": flops / 1e12, "state_floor_ms": state / HBM_BYTES_PER_S * 1e3,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            rows.append(row)
            print(f"griffin-lim {name} ({b}, {t}, 321) x {GL_ROUNDS} rounds: {ms:.3f} ms, bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_by']}; {row['tflop']:.4f} TFLOP at "
                  f"{rate / 1e12:g} TFLOP/s), per-round state floor {row['state_floor_ms']:.2f} "
                  f"ms, peak {row['peak_gb']:.2f} GB [{card}]")
        del mag
    b, t = GL_SHAPES[0]
    mag = torch.rand((b, t, 321), generator=torch.Generator("cuda").manual_seed(b),
                     device="cuda") * 10.0
    device, _ = profiled(lambda: gl_form(torch.bfloat16, mag, GL_ROUNDS,
                                         generator=torch.Generator("cuda").manual_seed(0)))
    print(f"profile of one griffin-lim matmul bf16 call ({b}, {t}, 321) [{card}]: "
          f"{busy_share(device, 'griffin-lim matmul bf16')}; most time: {most_time(device, 6)}")
    del mag
    for b, t in GL_SHAPES:
        ms = {r["form"]: r["ms"] for r in rows if r["shape"][:2] == [b, t]}
        print(f"griffin-lim fp32 at ({b}, {t}, 321): the kernel {ms['kernel fp32']:.3f} ms "
              f"against the FFT form's {ms['fft fp32']:.3f} ms "
              f"({ms['fft fp32'] / ms['kernel fp32']:.2f}x) [{card}]")
    return rows


def gl_kernel_checks(card):
    """(e) The kernel at ``GL_SHAPES`` on speech-like magnitudes, from one
    injected phase, against the FFT form on the card, its plain twin on the
    card and a float64 FFT form, with no round and at 60 rounds; and from a
    generator against the FFT form from the same generator state.  Returns
    the errors by shape."""
    out = {}
    for b, t in GL_SHAPES:
        clips = np.stack([speechish(160 * (t - 1), 41 + i) for i in range(b)])
        mag = stft(torch.from_numpy(clips).cuda(), GL_PARAMS).abs()
        phase = random_phase(mag.shape, torch.Generator("cuda").manual_seed(b + t), mag.device)
        errs = {}
        for rounds in (0, GL_ROUNDS):
            got = gl_kernel.griffin_lim_cuda(mag, GL_PARAMS, rounds, init_phase=phase)
            fft = griffin_lim(mag, GL_PARAMS, rounds, init_phase=phase)
            twin = gl_kernel.griffin_lim_reference(mag, GL_PARAMS, rounds, init_phase=phase)
            exact = griffin_lim(mag.double(), GL_PARAMS, rounds, init_phase=phase.double())
            peak = exact.abs().max().item()
            e = {"fft": (got - fft).abs().max().item(), "twin": (got - twin).abs().max().item(),
                 "float64": (got.double() - exact).abs().max().item(),
                 "fft_float64": (fft.double() - exact).abs().max().item(), "peak": peak}
            check(got.shape == (b, 160 * (t - 1)) and bool(torch.isfinite(got).all()),
                  f"griffin-lim kernel ({b}, {t}): {tuple(got.shape)} or non-finite")
            check(e["fft"] < GL_FP32_TOL and e["twin"] < GL_FP32_TOL,
                  f"griffin-lim kernel ({b}, {t}) x {rounds}: against the FFT form {e['fft']:.3e}, "
                  f"its twin {e['twin']:.3e}")
            check(e["float64"] < e["fft_float64"] + GL_FP32_TOL,
                  f"griffin-lim kernel ({b}, {t}) x {rounds}: against float64 {e['float64']:.3e}, "
                  f"the FFT form {e['fft_float64']:.3e}")
            if rounds == 0:
                check(e["float64"] < GL_SYNTH_REL * peak,
                      f"griffin-lim kernel ({b}, {t}) synthesis against float64 {e['float64']:.3e}")
            errs[rounds] = e
            print(f"griffin-lim kernel ({b}, {t}, 321) x {rounds} rounds: max abs err against the "
                  f"FFT form {e['fft']:.3e}, its twin {e['twin']:.3e}, float64 {e['float64']:.3e} "
                  f"(the FFT form {e['fft_float64']:.3e}; peak {peak:.3f}), bit-equal to the FFT "
                  f"form {torch.equal(got, fft)} ok [{card}]")
        gens = [torch.Generator("cuda").manual_seed(b) for _ in range(2)]
        drawn = (gl_kernel.griffin_lim_cuda(mag, GL_PARAMS, GL_CHECK_ROUNDS, generator=gens[0])
                 - griffin_lim(mag, GL_PARAMS, GL_CHECK_ROUNDS, generator=gens[1])).abs().max().item()
        check(drawn < GL_FP32_TOL, f"griffin-lim kernel ({b}, {t}) from a generator: {drawn:.3e}")
        errs["generator"] = drawn
        out[f"{b}x{t}"] = errs
        del mag, clips
    return out


def gl_serve(card, states):
    """(d) The bf16 folded + fused serving path at B=48 x 75, 8 batches in
    flight, with the default Griffin-Lim (the kernel) and with
    ``gl_dtype=bf16``, in turns (default, bf16, bf16, default):
    mel-frames/s and peak memory, printed and not held; 2 attention and 5
    fused-block calls a forward asserted, and the form each run vocoded
    with counted; then the stages of one ``gl_dtype=bf16`` forward."""
    b, t, batches = 48, 75, SERVE_BATCHES
    video = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, t, 112, 112, 1)).astype(np.float32)).cuda()
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")
    forms = {"griffin_lim": 0, "griffin_lim_mxu": 0}
    originals = {name: getattr(dsp_pipeline, name) for name in forms}

    def counting(name):
        def call(*args, **kwargs):
            forms[name] += 1
            return originals[name](*args, **kwargs)
        return call

    synths = {gl: Synthesizer(ModelConfig(use_bfloat16=True), device="cuda", fold_bn=True,
                              fused_blocks=True, gl_dtype=dtype).load_state_dicts(states)
              for gl, dtype in (("default", None), ("bf16", torch.bfloat16))}
    runs = {"default": [], "bf16": []}
    for name in forms:
        setattr(dsp_pipeline, name, counting(name))
    try:
        for gl in ("default", "bf16", "bf16", "default"):
            synth = synths[gl]
            for _ in range(2):
                synth(video, lengths)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            forms.update(dict.fromkeys(forms, 0))
            t0 = time.perf_counter()
            outs = [synth(video, lengths) for _ in range(batches)]
            sums = torch.stack([o["wav"].abs().sum() for o in outs]).cpu()
            elapsed = time.perf_counter() - t0
            check_launches(batches, True, f"gl_dtype {gl} serving", stem=True,
                           gl=0 if gl == "bf16" else 1)
            check(bool(torch.isfinite(sums).all()), f"gl_dtype {gl}: non-finite wav")
            vocoded = dict(forms, kernel=count_of("griffin_lim.calls"))
            want = "griffin_lim_mxu" if gl == "bf16" else "kernel"
            check(vocoded[want] == batches and sum(vocoded.values()) == batches,
                  f"gl_dtype {gl}: vocoded by {vocoded}, not {batches} x {want}")
            runs[gl].append({"mel_frames_per_s": batches * b * 4 * t / elapsed,
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            print(f"serve folded+fused bf16 B={b} T={t}, gl_dtype {gl} ({want}): "
                  f"{runs[gl][-1]['mel_frames_per_s']:.1f} mel-frames/s, peak "
                  f"{runs[gl][-1]['peak_gb']:.2f} GB, {count_of('attention.calls') / batches:g} "
                  f"attention and {count_of('fused_block.calls') / batches:g} fused-block calls "
                  f"per forward [{card}]")
            del outs
    finally:
        for name, fn in originals.items():
            setattr(dsp_pipeline, name, fn)
    stage_breakdown(synths["bf16"], video, lengths, card, "folded+fused bf16, gl_dtype bf16")
    return runs


def phase_seventeen(card, states, launches=None):
    """Phase 17: Griffin-Lim's forms and ``MelPipeline(gl_dtype=...)`` on the
    card, (a)-(f); ``launches``, (f)'s result where ``main`` ran it early
    (it runs here otherwise)."""
    launches = launches or phase_gl_launches(card)
    kernel = gl_kernel_checks(card)
    torch.cuda.empty_cache()
    checks = gl_checks(card, states)
    torch.cuda.empty_cache()
    rows = gl_times(card)
    torch.cuda.empty_cache()
    serving = gl_serve(card, states)
    return {"form_rows": rows, "serving_gl_dtype": serving, "kernel_max_abs_err": kernel,
            "kernel_launches_by_name": launches, **checks}


# phase 18's bounds: the new path's relative L2 to the fp32 gradient over
# the plain bf16 path's, and the two bf16 paths' distance over the plain one's
R1_TWICE_BOUNDS = (1.25, 2.0)


@contextlib.contextmanager
def plain_disc_convs():
    """``DiscConv2d`` on ``nn.Conv2d``'s own ``F.conv2d`` (differentiated
    twice by PyTorch's ``_convolution_double_backward``) inside the block."""
    own = DiscConv2d._conv_forward
    DiscConv2d._conv_forward = torch.nn.Conv2d._conv_forward
    try:
        yield
    finally:
        DiscConv2d._conv_forward = own


def r1_parameter_gradient(module, real, sent):
    """R1's gradient into ``module``'s parameters, flat in fp32, and by leaf."""
    x = real.clone().requires_grad_()
    logits, _ = module(x, sent)
    grads = torch.autograd.grad(r1_penalty(logits, x), list(module.parameters()),
                                allow_unused=True, materialize_grads=True)
    return torch.cat([g.float().flatten() for g in grads]), [g.float() for g in grads]


def phase_eighteen(card):
    """Phase 18: R1's parameter gradients through ``conv2d_twice`` against
    PyTorch's double backward at the GRID shapes."""
    rng = np.random.default_rng(18)
    b, w = TRAIN_BATCH, TRAIN_WINDOW
    sent = torch.from_numpy(rng.standard_normal((b, w, 512), np.float32)).cuda()
    fp32, half = ModelConfig(), ModelConfig(use_bfloat16=True)
    new_k, paths_k = R1_TWICE_BOUNDS
    for phase, (f, t) in zip("123", ((20, w), (40, 2 * w), (80, 4 * w))):
        real = torch.from_numpy(np.clip(rng.standard_normal((b, f, t), np.float32), -1, 1)).cuda()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            d_half = Discriminator(phase, half).cuda()
        d_fp32 = Discriminator(phase, fp32).cuda()
        d_fp32.load_state_dict(d_half.state_dict())
        t0 = time.perf_counter()
        new, new_leaves = r1_parameter_gradient(d_half, real, sent)
        torch.cuda.synchronize()
        new_s = time.perf_counter() - t0
        with plain_disc_convs():
            t0 = time.perf_counter()
            plain, plain_leaves = r1_parameter_gradient(d_half, real, sent)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            anchor, _ = r1_parameter_gradient(d_fp32, real, sent)
        own, was = rel_l2(new, anchor), rel_l2(plain, anchor)
        between = rel_l2(new, plain)
        names = [n for n, _ in d_half.named_parameters()]
        worst = max(((rel_l2(a, p), n) for n, a, p in zip(names, new_leaves, plain_leaves)
                     if p.any()), key=lambda x: x[0])
        print(f"  R1 parameter gradient dis{phase} B={b} ({f} x {t} mels) bf16: conv2d_twice "
              f"{own:.3e} from fp32, F.conv2d's double backward {was:.3e} ({own / was:.3f} x, "
              f"bound {new_k:g}); the two bf16 paths {between:.3e} apart ({between / was:.3f} x, "
              f"bound {paths_k:g}), worst leaf {worst[1]} {worst[0]:.3e}; first call "
              f"{new_s * 1e3:.1f} against {plain_s * 1e3:.1f} ms")
        check(own <= new_k * was and between <= paths_k * was,
              f"R1 parameter gradient dis{phase}: conv2d_twice against the double backward")
        del d_half, d_fp32
    print(f"R1 parameter gradients through conv2d_twice ok [{card}]")


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    check(torch.cuda.is_available(), "CUDA is not available")
    use_full_fp32()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build(KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(KERNELS)} (in parallel)")
    for name in KERNELS:
        with open(_build.log_path(name)) as f:
            for line in f:
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"  {name}: {line.strip()}")

    for name in TENSOR_CORE_KERNELS:
        sass = subprocess.run(["cuobjdump", "-sass", _build.library_path(name)],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        lines = sass.splitlines()
        hgmma, hmma = (sum(op in line for line in lines) for op in ("HGMMA", "HMMA"))
        print(f"  {name}: {hgmma} HGMMA and {hmma} HMMA tensor-core instructions in the library")
        check(hgmma + hmma > 0, f"the {name} library holds no tensor-core instruction")

    attn_worst = phase_kernel_vs_plain(card)
    fb_totals, fb_worst = phase_fused_block_vs_plain(card)
    stem_totals, stem_worst = phase_stem_vs_plain(card)
    states = load_serving_npz(SERVING_NPZ)
    phase_paths_card_vs_cpu(states)
    launches, parts_ms = {}, {}
    for path, fused, bf16 in PATHS:
        launches[path], parts_ms[path] = phase_serve(states, card, path, fused, bf16)
        torch.cuda.empty_cache()
    attn_totals = phase_attention_times(card)
    phase_instance_launches(card)
    gl_launches = phase_gl_launches(card)
    torch.cuda.empty_cache()
    phase_bench(card)
    attn_grad_worst = phase_train_attention(card)
    fp32_moments = phase_train_card_vs_cpu(card)
    torch.cuda.empty_cache()
    train_launches, fixed_step_ms = phase_train_grid(card)
    torch.cuda.empty_cache()
    loop_launches, trained_states = phase_trainer(card, fixed_step_ms)
    torch.cuda.empty_cache()

    # Phase 10: LRS2 training and bf16 training.
    t10 = time.perf_counter()
    train_raw, val_raw = lrs_raw_batches()
    lrs_rows, lrs_worst, lrs_grad_worst = phase_lrs_attention(
        card, train_raw["vid_len"].tolist(), val_raw["vid_len"].tolist(),
        val_raw["video_raw"].shape[1])
    for run in BF16_RUNS:
        phase_train_card_vs_cpu(card, run, fp32_moments)
    phase_r1_card_vs_cpu(card)
    torch.cuda.empty_cache()
    bf16_launches, bf16_ms = phase_train_grid(card, bf16=True)
    print(f"train GRID B={TRAIN_BATCH} x {TRAIN_WINDOW}: bf16 {bf16_ms:.1f} ms a step against "
          f"phase 8 (c)'s fp32 {fixed_step_ms:.1f} ms ({fixed_step_ms / bf16_ms:.3f}x) [{card}]")
    torch.cuda.empty_cache()
    lrs_steps = phase_lrs_train(card, train_raw)
    lrs_loop_launches = phase_lrs_trainer(card, lrs_steps["fp32"][1])
    torch.cuda.empty_cache()
    phase_clis(card)
    print(f"phase 10 (LRS2 and bf16 training, and both training CLIs): "
          f"{time.perf_counter() - t10:.1f} s")
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    eval_rows, eval_worst, eval_launches = phase_eval(card, states)
    print(f"phase 11 (evaluation: the test CLIs and the ASR scorers): "
          f"{time.perf_counter() - t11:.1f} s")
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    twelve = phase_twelve(card, states, trained_states)
    print(f"phase 12 (past 512 keys, the collate worker process, JAX train states, serving "
          f"npz): {time.perf_counter() - t12:.1f} s")
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    thirteen = phase_thirteen(card, twelve["fit_bf16"]["GRID thread, cached"]["ms_a_step"])
    print(f"phase 13 (data parallel): {time.perf_counter() - t13:.1f} s")
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    fourteen = phase_fourteen(card)
    print(f"phase 14 (the model axis): {time.perf_counter() - t14:.1f} s")
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    fifteen = phase_fifteen(card)
    print(f"phase 15 (the train step's knobs): {time.perf_counter() - t15:.1f} s")
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    width_rows_attn, width_rows_block = phase_sixteen(card)
    print(f"phase 16 (every width the JAX package runs): {time.perf_counter() - t16:.1f} s")
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    seventeen = phase_seventeen(card, states, gl_launches)
    print(f"phase 17 (Griffin-Lim's forms, its kernel and gl_dtype): "
          f"{time.perf_counter() - t17:.1f} s")
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    phase_eighteen(card)
    print(f"phase 18 (the discriminators' convolutions differentiated twice): "
          f"{time.perf_counter() - t18:.1f} s")

    def bound(totals, flop_per_s):
        t_bytes, t_flops = totals["bytes"] / HBM_BYTES_PER_S, totals["flops"] / flop_per_s
        return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"

    def kernel_entry(name, source, replaces, worst, totals, flop_per_s, timer):
        bound_ms, bound_by = bound(totals, flop_per_s)
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches["folded+fused"][name],
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
            "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": totals.get("library_ms"), "timer": timer,
        }

    # ms, plain_ms, bound_ms: one forward's launches of the kernel (2
    # attentions; 5 fused blocks, in the fp32 form: 3xTF32, so its bound
    # divides by a third of the TF32 rate; the bf16 form's numbers stand
    # beside it), timed alone.  in_path_ms(_bf16): the five fused blocks'
    # device time inside one B=48 folded + fused serving forward (CUDA
    # events around each).  launches: the counted batches of the fp32
    # folded + fused serving run, which goes through both kernels; each
    # serving run's own count stands in launches_by_path.  timer: how ms,
    # plain_ms and library_ms were taken, "graph" (CUDA-graph replay, no host
    # work) or "events" (CUDA events around back-to-back calls, time_ms); the
    # attention's events_ms is its time by the second timer, comparable with
    # times taken that way before.
    fused = kernel_entry("fused_basic_block", "vcagan_torch/csrc/fused_block.cu",
                         "vcagan/kernels/fused_block.py:95", fb_worst, fb_totals["fp32"],
                         FB_FLOP_PER_S["fp32"], "events")
    fused.update(form="3xTF32", widths=width_rows_block, ms_bf16=fb_totals["bf16"]["ms"],
                 plain_ms_bf16=fb_totals["bf16"]["plain_ms"],
                 bound_ms_bf16=bound(fb_totals["bf16"], FB_FLOP_PER_S["bf16"])[0],
                 convs_ms_bf16=fb_totals["bf16"]["convs_ms"],
                 in_path_ms=parts_ms["folded+fused"]["identity blocks"],
                 in_path_ms_bf16=parts_ms["folded+fused bf16"]["identity blocks"])
    print(f"fused_block one forward (5 launches) [{card}]: fp32 form (3xTF32) "
          f"{fused['ms']:.2f} ms alone, {fused['in_path_ms']:.2f} ms in the path, plain "
          f"{fused['plain_ms']:.2f} ms, bound {fused['bound_ms']:.2f} ms; bf16 form "
          f"{fused['ms_bf16']:.2f} ms alone, {fused['in_path_ms_bf16']:.2f} ms in the path, "
          f"plain {fused['plain_ms_bf16']:.2f} ms, bf16 cuDNN convs "
          f"{fused['convs_ms_bf16']:.2f} ms, bound {fused['bound_ms_bf16']:.2f} ms")
    attention = kernel_entry("masked_cross_attention", "vcagan_torch/csrc/masked_attention.cu",
                             "vcagan/kernels/masked_attention.py:85", attn_worst, attn_totals,
                             ATTN_FLOP_PER_S, "graph")
    attention.update(form="3xTF32", events_ms=attn_totals["events_ms"],
                     launches_train=train_launches, grad_max_abs_err=attn_grad_worst,
                     launches_trainer=loop_launches, launches_train_bf16=bf16_launches,
                     launches_train_lrs={k: v[0] for k, v in lrs_steps.items()},
                     launches_trainer_lrs=lrs_loop_launches, lrs_shapes=lrs_rows,
                     lrs_max_abs_err=lrs_worst, lrs_grad_max_abs_err=lrs_grad_worst,
                     launches_eval=eval_launches, eval_shapes=eval_rows,
                     eval_max_abs_err=eval_worst, **twelve, **thirteen, **fourteen,
                     **fifteen, widths=width_rows_attn)
    # The attention's instances: their kernels, the kernel launches each took
    # on each serving path (2 calls a forward in all), one forward's two calls
    # timed on each instance that takes them (phase 6).
    attention["instances"] = [
        {"instance": n, "kernels": list(INSTANCE_KERNELS[n]),
         "launches_by_path": {path: counts["attention_by_instance"][n]
                              for path, counts in launches.items()},
         "ms_one_forward": attn_totals["instances"].get(n)}
        for n in INSTANCE_KERNELS]
    print(f"attention one forward (2 launches) [{card}]: 3xTF32 {attention['ms']:.4f} ms "
          f"(events {attention['events_ms']:.4f} ms), plain "
          f"{attention['plain_ms']:.4f} ms, sdpa {attention['library_ms']:.4f} ms, bound "
          f"{attention['bound_ms']:.4f} ms ({attention['bound_by']})")
    # The stem: one launch a folded + fused bf16 forward, timed alone at the
    # GRID serving shape and in that path (the v_front.stem span); library_ms
    # the module chain's cuDNN calls.
    stem = {"name": "fused_stem", "route": "cuda", "source": "vcagan_torch/csrc/fused_stem.cu",
            "replaces": None, "form": "bf16",
            "launches": launches["folded+fused bf16"]["fused_stem"],
            "launches_by_path": {path: counts["fused_stem"] for path, counts in launches.items()},
            "max_err_share_of_largest": stem_worst, "bound_by": "operations", "timer": "events",
            "in_path_ms": parts_ms["folded+fused bf16"]["stem"], **stem_totals}
    print(f"fused_stem one forward (1 launch) [{card}]: {stem['ms']:.3f} ms alone, "
          f"{stem['in_path_ms']:.3f} ms in the path, plain {stem['plain_ms']:.3f} ms, cuDNN chain "
          f"{stem['library_ms']:.3f} ms, bound {stem['bound_ms']:.3f} ms")
    # Griffin-Lim's kernel: one call a forward on the card's fp32 Griffin-Lim
    # (every serving path's default), timed alone at the serving shape; the
    # forms' figures stand on a line of their own.
    gl_rows = {r["form"]: r for r in seventeen["form_rows"] if r["shape"][:2] == [48, 300]}
    griffin = {"name": "griffin_lim", "route": "cuda", "source": "vcagan_torch/csrc/griffin_lim.cu",
               "replaces": None, "form": "fp32", "launches": launches["folded+fused bf16"]["griffin_lim"],
               "launches_by_path": {path: counts["griffin_lim"] for path, counts in launches.items()},
               "kernel_launches_a_call": sum(gl_launches.values()),
               "max_abs_err": seventeen["kernel_max_abs_err"], "ms": gl_rows["kernel fp32"]["ms"],
               "bound_ms": gl_rows["kernel fp32"]["bound_ms"],
               "bound_by": gl_rows["kernel fp32"]["bound_by"],
               "library_ms": gl_rows["fft fp32"]["ms"], "timer": "events"}
    print(f"griffin_lim one call (48, 300, 321) x {GL_ROUNDS} rounds ({griffin['kernel_launches_a_call']} "
          f"launches) [{card}]: {griffin['ms']:.3f} ms alone, the FFT form {griffin['library_ms']:.3f} "
          f"ms, bound {griffin['bound_ms']:.3f} ms")
    print(json.dumps({"griffin_lim": seventeen}))
    print(json.dumps({"kernels": [attention, fused, stem, griffin]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
