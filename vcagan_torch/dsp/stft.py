"""Batched STFT / ISTFT, time-major (B, frames, bins).

Port of ``vcagan/dsp/stft.py``: periodic Hann window, framing (centred and
reflect-padded, or of the signal as it is), ``torch.fft.rfft``/``irfft``, overlap-add by shifted adds, and the
window-sum-square correction of the reference's librosa-0.6 semantics.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class STFTParams:
    n_fft: int = 640
    hop_length: int = 160
    win_length: int = 640

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, zero-padded (centred) to n_fft, float64."""
    n = np.arange(win_length)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[pad : pad + win_length] = win
    return out


@functools.lru_cache(maxsize=8)
def window(params: STFTParams, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The window as a tensor, made once per device and dtype (a copy to
    the card on every Griffin-Lim round would stall its stream)."""
    return torch.as_tensor(hann_window(params.win_length, params.n_fft), dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def window_sumsquare(n_frames: int, params: STFTParams) -> np.ndarray:
    """Sum-square window envelope over the overlap-added signal."""
    win_sq = hann_window(params.win_length, params.n_fft) ** 2
    n = params.n_fft + params.hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    for i in range(n_frames):
        s = i * params.hop_length
        x[s : min(n, s + params.n_fft)] += win_sq[: max(0, min(params.n_fft, n - s))]
    return x


@functools.lru_cache(maxsize=16)
def _wss_correction(
    n_frames: int, params: STFTParams, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    wss = window_sumsquare(n_frames, params)
    tiny = np.finfo(np.float32).tiny
    corr = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
    return torch.as_tensor(corr, dtype=dtype, device=device)


def stft(y: torch.Tensor, params: STFTParams, center: bool = True) -> torch.Tensor:
    """Complex STFT: (B, L) float -> (B, T, n_bins) complex.  ``center``
    reflect-pads n_fft // 2 on each side (T = 1 + L // hop); without it the
    signal is framed as it is (T = 1 + (L - n_fft) // hop), as the input
    pipeline frames a segment that the host already padded and positioned
    (``vcagan_torch/data/audio_host.py`` ``stft_segment``)."""
    if center:
        pad = params.n_fft // 2
        y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, params.n_fft, params.hop_length) * window(params, y.device, y.dtype)
    return torch.fft.rfft(frames, n=params.n_fft, dim=-1)


def stft_magnitude(y: torch.Tensor, params: STFTParams, center: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude and phase of :func:`stft`, each (B, T, n_bins)."""
    z = stft(y, params, center=center)
    return z.abs(), z.angle()


def overlap_add(frames: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """(B, T, n_fft) -> (B, n_fft + hop*(T-1)) by R = n_fft // hop shifted
    adds of hop-sized chunks (chunk r of frame t lands at block t + r)."""
    n_fft, hop = params.n_fft, params.hop_length
    if n_fft % hop:
        raise ValueError("overlap-add by shifted adds needs n_fft % hop == 0")
    r_factor = n_fft // hop
    b, t, _ = frames.shape
    chunks = frames.reshape(b, t, r_factor, hop)
    total = frames.new_zeros((b, t + r_factor - 1, hop))
    for r in range(r_factor):
        total[:, r : r + t] += chunks[:, :, r]
    return total.reshape(b, -1)


def istft_complex(real: torch.Tensor, imag: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """ISTFT from explicit real/imag spectra (B, T, n_bins) -> (B, hop*(T-1)),
    window-sum-square corrected and trimmed of the centring pad."""
    frames = torch.fft.irfft(torch.complex(real, imag), n=params.n_fft, dim=-1)
    y = overlap_add(frames * window(params, real.device, real.dtype), params)
    corr = _wss_correction(real.shape[1], params, y.device, y.dtype)
    pad = params.n_fft // 2
    return (y * corr)[:, pad:-pad]
