"""Waveform- and mel-domain scalar ops: the conditioning of the forward
path, the log compression and mel normalisation, and the inverse path's
de-emphasis.

Port of ``vcagan/dsp/audio.py``.
"""

from __future__ import annotations

import math

import torch

from vcagan_torch.nn.common import rounded

LOG1E5 = math.log(1e-5)


def peak_normalize(wav: torch.Tensor, target: float = 0.9, dim: int = -1) -> torch.Tensor:
    """wav / max|wav| * target."""
    peak = wav.abs().amax(dim=dim, keepdim=True)
    return wav / torch.clamp(peak, min=1e-8) * target


def preemphasis(wav: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - coef * x[n-1], y[0] = x[0], over the last axis (equals
    ``scipy.signal.lfilter([1, -coef], [1], x)``)."""
    return torch.cat([wav[..., :1], wav[..., 1:] - coef * wav[..., :-1]], dim=-1)


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


def mel_normalize(mel: torch.Tensor) -> torch.Tensor:
    """Map log-mel from [log 1e-5, ~0] to [-1, 1]."""
    return (mel - LOG1E5) / (-LOG1E5 / 2.0) - 1.0


def mel_denormalize(mel: torch.Tensor) -> torch.Tensor:
    """Map [-1, 1] back to log-mel in [log 1e-5, ~0].  The constants are
    rounded to the mel's dtype first, as JAX applies them to a bf16 array
    (the generator's mels in bf16 training)."""
    return (mel + 1.0) * rounded(-LOG1E5 / 2.0, mel.dtype) + rounded(LOG1E5, mel.dtype)
