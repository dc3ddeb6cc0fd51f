"""Batched Griffin-Lim phase reconstruction, in two forms.

``griffin_lim`` ports ``vcagan/dsp/griffin_lim.py:36-79``: the phase is
carried as a unit phasor (re, im), so each round is one ISTFT, one STFT
(``torch.fft``) and a normalisation with no transcendental.  It is the form
off the card and the oracle of the card's fp32 form, the Griffin-Lim kernel
(``vcagan_torch/kernels/griffin_lim.py``), which rounds where it rounds.

``griffin_lim_mxu`` ports ``vcagan/dsp/griffin_lim.py:86-200``, the same
function with the DFT written as products with windowed bases, in a compute
dtype (bf16 by default, as the JAX function's) with fp32 results.  The JAX
package runs it on its accelerator, ``MelPipeline(gl_dtype=...)`` on the
card for a ``gl_dtype`` other than fp32 (``vcagan_torch/dsp/pipeline.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from vcagan_torch.dsp.stft import (
    STFTParams, _wss_correction, hann_window, istft_complex, overlap_add, stft)


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


@functools.lru_cache(maxsize=4)
def dft_bases(params: STFTParams):
    """The windowed DFT bases of ``vcagan/dsp/griffin_lim.py:86-103``,
    float64 numpy: analysis (n_fft, n_bins) real and imaginary, the Hann
    window in the rows; synthesis (n_bins, n_fft) real and imaginary, the
    irfft's weights with the window in the columns."""
    n, n_bins = params.n_fft, params.n_bins
    win = hann_window(params.win_length, n)
    grid = 2.0 * np.pi * np.outer(np.arange(n), np.arange(n_bins)) / n
    cos_f = np.cos(grid) * win[:, None]
    sin_f = -np.sin(grid) * win[:, None]
    w_k = np.full(n_bins, 2.0)
    w_k[0] = 1.0
    if n % 2 == 0:
        w_k[-1] = 1.0
    cos_i = (np.cos(grid) * w_k[None, :] / n).T * win[None, :]
    sin_i = (-np.sin(grid) * w_k[None, :] / n).T * win[None, :]
    return cos_f, sin_f, cos_i, sin_i


@functools.lru_cache(maxsize=8)
def _stacked_bases(params: STFTParams, device: torch.device, dtype: torch.dtype):
    """The bases side by side, in ``dtype`` on ``device``, made once: analysis
    (n_fft, 2 n_bins) = [cos_f | sin_f], synthesis (2 n_bins, n_fft) =
    [cos_i ; sin_i], so that each direction's two products are one product
    of spectra laid out (re, im) (a sum over 2 n_bins where the JAX function
    adds two sums over n_bins).  Rounded to fp32 first, as the JAX function's,
    unless ``dtype`` is wider."""
    cos_f, sin_f, cos_i, sin_i = dft_bases(params)

    def to(a):
        a = a if dtype.itemsize > 4 else a.astype(np.float32)
        return torch.as_tensor(a, device=device).to(dtype)
    return to(np.concatenate([cos_f, sin_f], 1)), to(np.concatenate([cos_i, sin_i], 0))


def _product(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) in the basis's dtype with a result of at least fp32
    (the JAX function's ``preferred_element_type=float32``).  A narrower
    type (bf16) on the card: ``torch.mm(..., out_dtype=float32)``, which
    sums in fp32 and rounds nothing after; on the CPU, where that overload
    has no kernel, the products of the rounded operands in fp32.  fp32 on
    the card needs TF32 off (``runtime.use_full_fp32``)."""
    flat = x.to(basis.dtype).reshape(-1, x.shape[-1])  # a copy where x is framed
    if basis.dtype.itemsize >= 4:
        out = flat @ basis
    elif flat.is_cuda:
        out = torch.mm(flat, basis, out_dtype=torch.float32)
    else:
        out = flat.float() @ basis.float()
    return out.reshape(*x.shape[:-1], basis.shape[1])


def griffin_lim_mxu(
    magnitudes: torch.Tensor,
    params: STFTParams,
    n_iters: int = 60,
    compute_dtype: torch.dtype = torch.bfloat16,
    init_phase: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``griffin_lim`` with the DFT as windowed-basis products in
    ``compute_dtype`` (fp32 results; float64 throughout in float64, an
    oracle for the tests); (B, T, n_bins) magnitudes -> (B, hop * (T-1))
    waveforms, the FFT form's length.

    A round: the spectrum (magnitudes times the phasor, cast to the compute
    dtype) times the synthesis basis gives the windowed frames, overlap-added
    and corrected by the window-sum-square envelope; the signal trimmed of
    the centring pad, re-padded by reflection and framed, times the analysis
    basis, gives the new spectrum, whose unit phasor is the next phase.  The
    phase is drawn as ``griffin_lim`` draws it, so in fp32 both forms give
    the same waveform to fp32 rounding."""
    b, t, k = magnitudes.shape
    n_fft, hop, pad = params.n_fft, params.hop_length, params.n_fft // 2
    analysis, synthesis = _stacked_bases(params, magnitudes.device, compute_dtype)
    state = torch.promote_types(torch.float32, compute_dtype)
    corr = _wss_correction(t, params, magnitudes.device, state)
    if init_phase is None:
        angles = random_phase(magnitudes.shape, generator, magnitudes.device, state)
    else:
        angles = init_phase.to(state)
    magnitudes = magnitudes.to(state)[:, :, None]  # (B, T, 1, n_bins)
    phasor = torch.stack([torch.cos(angles), torch.sin(angles)], dim=2)  # (B, T, 2, n_bins)

    def synth(phasor):
        frames = _product((magnitudes * phasor).flatten(2), synthesis)  # (B, T, n_fft)
        return (overlap_add(frames, params) * corr)[:, pad:-pad]

    for _ in range(n_iters):
        y = F.pad(synth(phasor)[:, None], (pad, pad), mode="reflect")[:, 0]
        z = _product(y.unfold(-1, n_fft, hop), analysis).unflatten(-1, (2, k))
        inv_norm = torch.rsqrt(z.square().sum(2, keepdim=True) + 1e-16)  # zr^2 + zi^2
        phasor = z * inv_norm
    return synth(phasor)
