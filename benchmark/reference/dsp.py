"""Plain PyTorch reference of the audio side: STFT, Griffin-Lim (FFT form,
float32), de-emphasis, the Slaney mel filterbank and the mel
normalisation.  A frozen copy of the mathematics, importing nothing of the
program.  The STFT is librosa 0.6's: a periodic Hann window, reflect-padded
centred frames, overlap-add with the window-sum-square correction.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, N_FFT, HOP, N_BINS = 16_000, 640, 160, 321
PREEMPHASIS = 0.97
GL_ROUNDS = 60
LOG1E5 = math.log(1e-5)


def hann(device, dtype=torch.float32) -> torch.Tensor:
    n = torch.arange(N_FFT, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / N_FFT)).to(device, dtype)


def stft(y: torch.Tensor, center: bool = True) -> torch.Tensor:
    """(B, L) -> complex (B, frames, 321)."""
    if center:
        y = F.pad(y[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = y.unfold(-1, N_FFT, HOP) * hann(y.device, y.dtype)
    return torch.fft.rfft(frames, n=N_FFT, dim=-1)


def _window_sumsquare(n_frames: int) -> np.ndarray:
    win = hann("cpu", torch.float64).numpy() ** 2
    out = np.zeros(N_FFT + HOP * (n_frames - 1))
    for i in range(n_frames):
        out[i * HOP:i * HOP + N_FFT] += win
    return out


def istft(spec: torch.Tensor) -> torch.Tensor:
    """complex (B, T, 321) -> (B, 160 (T - 1)), centred, corrected by the
    window's sum of squares where it is above float32's tiny."""
    b, t, _ = spec.shape
    frames = torch.fft.irfft(spec, n=N_FFT, dim=-1) * hann(spec.device)
    y = F.fold(frames.transpose(1, 2), output_size=(1, N_FFT + HOP * (t - 1)),
               kernel_size=(1, N_FFT), stride=(1, HOP))[:, 0, 0]
    wss = _window_sumsquare(t)
    tiny = np.finfo(np.float32).tiny
    corr = torch.as_tensor(np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0),
                           dtype=y.dtype, device=y.device)
    return (y * corr)[:, N_FFT // 2:-(N_FFT // 2)]


def griffin_lim(mag: torch.Tensor, init_phase: torch.Tensor, rounds: int = GL_ROUNDS
                ) -> torch.Tensor:
    """(B, T, 321) magnitudes, initial angles -> (B, 160 (T - 1))."""
    phase = torch.polar(torch.ones_like(mag), init_phase)
    for _ in range(rounds):
        z = stft(istft(mag * phase))
        phase = z / torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-16)
    return istft(mag * phase)


def deemphasis(wav: torch.Tensor, coef: float = PREEMPHASIS) -> torch.Tensor:
    """y[n] = x[n] + coef y[n-1], in float64: after the pass of span s,
    y[n] holds the sum of coef^i x[n-i] for i < 2s."""
    y = wav.to(torch.float64)
    span = 1
    while span < y.shape[-1]:
        y = y + coef ** span * F.pad(y[..., :-span], (span, 0))
        span *= 2
    return y.to(wav.dtype)


def vocode(spec: torch.Tensor, init_phase: torch.Tensor) -> torch.Tensor:
    """The serving path's last stage: Griffin-Lim, de-emphasis, clip."""
    return torch.clamp(deemphasis(griffin_lim(spec, init_phase)), -1.0, 1.0)


# ------------------------------------------------------------------- mels


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0),
                    f / (200.0 / 3.0))


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (np.maximum(m, 15.0) - 15.0)),
                    m * (200.0 / 3.0))


def mel_basis(f_max: float, n_mels: int = 80, f_min: float = 55.0) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangles (librosa's defaults),
    (n_mels, 321) float32."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_BINS)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    diff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / diff[:-1, None], ramps[2:] / diff[1:, None]))
    return (w * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


def mel_normalize(log_mel: torch.Tensor) -> torch.Tensor:
    """[log 1e-5, 0] -> [-1, 1]."""
    return (log_mel - LOG1E5) / (-LOG1E5 / 2.0) - 1.0


def mel_denormalize(mel: torch.Tensor) -> torch.Tensor:
    return (mel + 1.0) * (-LOG1E5 / 2.0) + LOG1E5


def log_mel(mag: torch.Tensor, f_max: float) -> torch.Tensor:
    """(B, T, 321) magnitudes -> (B, T, 80) log-mel."""
    basis = torch.as_tensor(mel_basis(f_max), device=mag.device)
    return torch.log(torch.clamp(mag @ basis.T, min=1e-5))
