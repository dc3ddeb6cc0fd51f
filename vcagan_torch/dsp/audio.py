"""Waveform- and mel-domain scalar ops of the inverse path.

Port of the parts of ``vcagan/dsp/audio.py`` that the serving path uses.
"""

from __future__ import annotations

import math

import torch

LOG1E5 = math.log(1e-5)


def deemphasis(wav: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] + coef * y[n-1] over the last axis.

    A sequential loop would be one launch per sample on the card; this is a
    log-depth doubling scan (after the step of span s, y[n] sums
    coef^i x[n-i] for i < 2s), the counterpart of the JAX package's
    ``lax.associative_scan``: ceil(log2 L) steps, 16 for a 48k-sample clip.
    """
    y = wav
    span = 1
    while span < wav.shape[-1]:
        shifted = torch.nn.functional.pad(y[..., :-span], (span, 0))
        y = y + (coef ** span) * shifted
        span *= 2
    return y


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, min=clip_val))."""
    return torch.log(torch.clamp(x, min=clip_val))


def dynamic_range_decompression(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


def mel_denormalize(mel: torch.Tensor) -> torch.Tensor:
    """Map [-1, 1] back to log-mel in [log 1e-5, ~0]."""
    return (mel + 1.0) * (-LOG1E5 / 2.0) + LOG1E5
