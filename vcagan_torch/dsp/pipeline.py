"""Mel pipeline: waveform -> (log-mel, linear magnitudes), and linear or
normalised-mel spectrogram -> waveform.

Port of ``vcagan/dsp/pipeline.py:23-131``, time-major (B, T, bins).
"""

from __future__ import annotations

import torch

from vcagan_torch.configs import AudioConfig
from vcagan_torch.dsp import audio as audio_ops
from vcagan_torch.dsp.griffin_lim import griffin_lim, griffin_lim_mxu
from vcagan_torch.dsp.mel import mel_filterbank
from vcagan_torch.dsp.stft import STFTParams, stft_magnitude
from vcagan_torch.kernels import griffin_lim as griffin_lim_kernel
from vcagan_torch.tracing import span


class MelPipeline:
    """Stateless apart from the constant mel basis (n_mels, n_linear).

    ``gl_dtype``: the compute dtype of Griffin-Lim on the card
    (``vcagan/dsp/pipeline.py:26-43``); None is fp32.  On the card fp32
    vocodes with the Griffin-Lim kernel (``vcagan_torch/kernels/
    griffin_lim.py``: a round in four launches, cuFFT's transforms and two
    hand-written kernels), bf16 (or any type but fp32) with
    ``griffin_lim_mxu`` in that type; off the card the FFT form
    (``griffin_lim``) runs and ``gl_dtype`` is ignored, as the JAX package
    ignores it off its accelerator (``pipeline.py:110-131``)."""

    def __init__(self, config: AudioConfig | None = None, gl_dtype: torch.dtype | None = None):
        self.config = config or AudioConfig()
        self.gl_dtype = torch.float32 if gl_dtype is None else gl_dtype
        c = self.config
        self.stft_params = STFTParams(c.n_fft, c.hop_length, c.win_length)
        self.mel_basis = torch.from_numpy(
            mel_filterbank(c.sample_rate, c.n_fft, c.n_mels, c.f_min, c.f_max)
        )

    def _basis(self, like: torch.Tensor) -> torch.Tensor:
        if self.mel_basis.device != like.device or self.mel_basis.dtype != like.dtype:
            self.mel_basis = self.mel_basis.to(like.device, like.dtype)
        return self.mel_basis

    def condition_waveform(self, wav: torch.Tensor) -> torch.Tensor:
        """Peak-normalise x0.9, pre-emphasise, clamp to [-1, 1]."""
        wav = audio_ops.peak_normalize(wav, 0.9)
        wav = audio_ops.preemphasis(wav, self.config.preemphasis)
        return torch.clamp(wav, -1.0, 1.0)

    def mel_spectrogram(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform in [-1, 1] -> (log-mel (B, T, n_mels), linear
        magnitudes (B, T, n_linear)), centred STFT."""
        mag, _ = stft_magnitude(wav, self.stft_params)
        return self.compress_mel(mag), mag

    def compress_mel(self, mag: torch.Tensor) -> torch.Tensor:
        """Linear magnitudes (B, T, n_linear) -> log-mel (B, T, n_mels)."""
        return audio_ops.dynamic_range_compression(mag @ self._basis(mag).T)

    def mel_to_linear(self, mel_norm: torch.Tensor) -> torch.Tensor:
        """Normalised log-mel (B, T, n_mels) -> approximate linear magnitudes:
        denormalise, exp, the transposed basis as pseudo-inverse, x1000."""
        mel = audio_ops.dynamic_range_decompression(audio_ops.mel_denormalize(mel_norm))
        return (mel @ self._basis(mel)) * self.config.mel_inversion_scale

    def inverse_mel(self, mel_norm, init_phase=None, generator=None) -> torch.Tensor:
        """Normalised log-mel (B, T, n_mels) -> waveform (B, L), clipped."""
        return self.inverse_spec(self.mel_to_linear(mel_norm), init_phase, generator)

    def inverse_spec(self, spec, init_phase=None, generator=None) -> torch.Tensor:
        """Linear magnitudes (B, T, n_linear) -> waveform (B, hop*(T-1)):
        Griffin-Lim, de-emphasis, clip to [-1, 1].  ``init_phase`` (B, T,
        n_linear) replaces the random phase drawn from ``generator``.  Traced
        as ``vocoder.griffin_lim`` (every form) and ``vocoder.deemphasis``
        (de-emphasis and the clip)."""
        iters = self.config.griffin_lim_iters
        with span("vocoder.griffin_lim"):
            if not spec.is_cuda:
                wav = griffin_lim(spec, self.stft_params, iters, init_phase, generator)
            elif self.gl_dtype == torch.float32:
                wav = griffin_lim_kernel.griffin_lim_cuda(spec, self.stft_params, iters,
                                                          init_phase, generator)
            else:
                wav = griffin_lim_mxu(spec, self.stft_params, iters, self.gl_dtype, init_phase,
                                      generator)
        with span("vocoder.deemphasis"):
            wav = audio_ops.deemphasis(wav, self.config.preemphasis)
            return torch.clamp(wav, -1.0, 1.0)
