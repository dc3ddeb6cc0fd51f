"""Benchmark of the port: flagship serving throughput on one CUDA card.

    python3 -m vcagan_torch.bench [--fold-bn-fused] [--fp32]

The path and the measurement of the JAX package's ``bench.py:22-120``: a
batch of 48 random 75-frame clips (112x112, ``numpy.random.default_rng(0)``)
-> visual front -> decoder (3-scale mel, the attention kernel) -> postnet
-> 60-round Griffin-Lim + de-emphasis -> waveform, in the bf16 serving mode
(``bench.py:29``; ``--fp32`` serves in fp32), with the synthesizer's random
init from seed 0 (``bench.py`` uses a random init too).  Two warm-ups with a
sync each, then 8 batches in flight and one sync.  ``--fold-bn-fused``
serves the folded-BN variant whose five identity-shortcut ResNet blocks run
as the fused block kernel; both variants count the same batches.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.  It runs
on CUDA and raises without it; ``bench(device="cpu", ...)`` runs the same
composition on the CPU (for tests, at a small size).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vcagan_torch.configs import ModelConfig
from vcagan_torch.serve import Synthesizer

# mel-frames/s of the reference PyTorch model serving the same path on a CPU
# (batch 4, 75 frames; the constant of bench.py, copied, measured there by
# tools/measure_torch_baseline.py).  A CPU figure, not a TPU one.
TORCH_CPU_BASELINE = 151.9
BATCH = 48
FRAMES = 75
IMAGE = 112
WARMUPS = 2
IN_FLIGHT = 8


def bench(device=None, bf16: bool = True, fold_bn_fused: bool = False, batch: int = BATCH,
          frames: int = FRAMES, image: int = IMAGE) -> dict:
    """Serve ``WARMUPS`` + ``IN_FLIGHT`` batches, print the JSON line and
    return it as a dict.  ``device``: CUDA unless named."""
    synth = Synthesizer(ModelConfig(use_bfloat16=bf16), device=device,
                        fold_bn=fold_bn_fused, fused_blocks=fold_bn_fused)
    dev = synth.device
    rng = np.random.default_rng(0)
    video = torch.from_numpy(
        rng.standard_normal((batch, frames, image, image, 1)).astype(np.float32)
    ).to(dev)
    lengths = torch.full((batch,), frames, dtype=torch.int32, device=dev)

    for i in range(WARMUPS):
        wav = synth(video, lengths, generator=torch.Generator(dev).manual_seed(100 + i))["wav"]
        float(wav.abs().sum())  # a sync a warm-up

    # Serving throughput: the batches are queued back to back and read once,
    # so the host's round trip amortises as in a real inference queue.
    t0 = time.perf_counter()
    sums = [
        synth(video, lengths, generator=torch.Generator(dev).manual_seed(i))["wav"].abs().sum()
        for i in range(IN_FLIGHT)
    ]
    torch.stack(sums).cpu()  # the one sync
    elapsed = time.perf_counter() - t0
    mel_fps = IN_FLIGHT * batch * 4 * frames / elapsed
    line = {
        "metric": "mel_frames_per_sec_per_chip",
        "value": round(mel_fps, 1),
        "unit": "mel-frames/s",
        "vs_baseline": round(mel_fps / TORCH_CPU_BASELINE, 2),
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fold-bn-fused", action="store_true",
                        help="the folded-BN variant with the fused block kernel")
    parser.add_argument("--fp32", action="store_true", help="serve in fp32, not bf16")
    args = parser.parse_args(argv)
    bench(bf16=not args.fp32, fold_bn_fused=args.fold_bn_fused)


if __name__ == "__main__":
    main()
