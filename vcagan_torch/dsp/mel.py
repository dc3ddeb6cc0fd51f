"""Slaney-style mel filterbank (librosa defaults: Slaney mel scale, Slaney
area normalisation), built on the host with numpy.

A copy of ``vcagan/dsp/mel.py``, kept here so that the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np

# Slaney mel scale: linear below 1 kHz (200/3 Hz per mel), logarithmic above
# with step log(6.4)/27.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    freq = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    return np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freq,
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int = 16_000,
    n_fft: int = 640,
    n_mels: int = 80,
    f_min: float = 55.0,
    f_max: float = 7500.0,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_fft//2 + 1), float32."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalisation: 2 / bandwidth of each triangle.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
