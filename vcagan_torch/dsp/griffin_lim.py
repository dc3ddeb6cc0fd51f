"""Batched Griffin-Lim phase reconstruction.

Port of ``vcagan/dsp/griffin_lim.py:36-79``: the phase is carried as a unit
phasor (re, im), so each round is one ISTFT, one STFT and a normalisation
with no transcendental.  (``griffin_lim_mxu`` is a TPU rewrite of the same
function as matmuls and is not ported.)
"""

from __future__ import annotations

import math

import torch

from vcagan_torch.dsp.stft import STFTParams, istft_complex, stft


def random_phase(
    shape, generator: torch.Generator | None, device: torch.device, dtype=torch.float32
) -> torch.Tensor:
    """Uniform angles in [-pi, pi), drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return (2.0 * u - 1.0) * math.pi


def griffin_lim(
    magnitudes: torch.Tensor,
    params: STFTParams,
    n_iters: int = 60,
    init_phase: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """(B, T, n_bins) magnitudes -> (B, hop * (T-1)) waveforms.

    ``init_phase`` (B, T, n_bins) replaces the random phase drawn from
    ``generator``."""
    if init_phase is None:
        angles = random_phase(magnitudes.shape, generator, magnitudes.device, magnitudes.dtype)
    else:
        angles = init_phase.to(magnitudes.dtype)
    re, im = torch.cos(angles), torch.sin(angles)
    for _ in range(n_iters):
        z = stft(istft_complex(magnitudes * re, magnitudes * im, params), params)
        zr, zi = z.real, z.imag
        inv_norm = torch.rsqrt(zr * zr + zi * zi + 1e-16)
        re, im = zr * inv_norm, zi * inv_norm
    return istft_complex(magnitudes * re, magnitudes * im, params)
