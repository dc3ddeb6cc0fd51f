"""The forward DSP chain of the PyTorch port against ``vcagan.dsp``.

The input pipeline frames a host-positioned segment without padding
(``stft(center=False)``), takes magnitudes, projects them to log-mel and
normalises; the ASR path conditions whole waveforms first.  Same numpy
inputs on both sides, fp32 on both.

Tolerances: one STFT of fp32 FFTs on spectra of magnitude up to a few
hundred, rtol 1e-5 and atol 1e-4 (the port's inverse-DSP test holds one
STFT to the same); the phase only where the magnitude is above 1e-2 (the
angle of a near-zero bin is rounding); log-mel, rtol 1e-5 and atol 1e-4
(a log of mel energies whose floor is log 1e-5); the conditioning chain,
elementwise fp32 ops in the same order, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.dsp import MelPipeline as JaxMelPipeline
from vcagan.dsp import audio as jax_audio
from vcagan.dsp import stft as jax_stft
from vcagan.dsp.stft import STFTParams as JaxSTFTParams
from vcagan.dsp.stft import stft_magnitude as jax_stft_magnitude
from vcagan_torch.dsp import MelPipeline, STFTParams, mel_normalize, stft, stft_magnitude
from vcagan_torch.dsp import audio as port_audio

SPEC_TOL = dict(atol=1e-4, rtol=1e-5)
MEL_TOL = dict(atol=1e-4, rtol=1e-5)
COND_TOL = dict(atol=1e-6, rtol=0)


def _wave(n, seed):
    """Harmonics under a syllable envelope, with a quiet noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f0 = 100 + 50 * rng.random()
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.random() * 6.28) / h for h in range(1, 10))
    y *= 0.4 + 0.6 * np.sin(2 * np.pi * 2.0 * t) ** 2
    y += 0.01 * rng.standard_normal(n)
    return (0.7 * y / np.abs(y).max()).astype(np.float32)


@pytest.fixture(scope="module")
def waves():
    return np.stack([_wave(20 * 4 * 160 + 640, s) for s in range(3)])  # segments of 4W+1 frames


@pytest.mark.parametrize("center", [False, True])
def test_stft(waves, center):
    got = stft(torch.from_numpy(waves), STFTParams(), center=center).numpy()
    want = np.asarray(jax_stft(jnp.asarray(waves), JaxSTFTParams(), center=center))
    assert got.shape == want.shape
    assert got.shape[1] == (81 if not center else 1 + waves.shape[1] // 160)
    np.testing.assert_allclose(got, want, **SPEC_TOL)


@pytest.mark.parametrize("center", [False, True])
def test_stft_magnitude(waves, center):
    mag, phase = stft_magnitude(torch.from_numpy(waves), STFTParams(), center=center)
    jmag, jphase = jax_stft_magnitude(jnp.asarray(waves), JaxSTFTParams(), center=center)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), **SPEC_TOL)
    loud = np.asarray(jmag) > 1e-2
    dphase = np.angle(np.exp(1j * (phase.numpy() - np.asarray(jphase))))  # wrapped
    assert loud.mean() > 0.5
    assert np.abs(dphase[loud]).max() < 1e-3


def test_condition_waveform(waves):
    got = MelPipeline().condition_waveform(torch.from_numpy(waves)).numpy()
    want = np.asarray(JaxMelPipeline(JaxAudioConfig()).condition_waveform(jnp.asarray(waves)))
    np.testing.assert_allclose(got, want, **COND_TOL)
    assert np.abs(got).max() <= 1.0


def test_scalar_ops(waves):
    x = torch.from_numpy(waves)
    np.testing.assert_allclose(port_audio.peak_normalize(x).numpy(),
                               np.asarray(jax_audio.peak_normalize(jnp.asarray(waves))),
                               **COND_TOL)
    np.testing.assert_allclose(port_audio.preemphasis(x).numpy(),
                               np.asarray(jax_audio.preemphasis(jnp.asarray(waves))), **COND_TOL)
    logmel = np.log(np.random.default_rng(4).uniform(1e-5, 2.0, (2, 30, 80))).astype(np.float32)
    np.testing.assert_allclose(mel_normalize(torch.from_numpy(logmel)).numpy(),
                               np.asarray(jax_audio.mel_normalize(jnp.asarray(logmel))),
                               **COND_TOL)


def test_mel_spectrogram(waves):
    pipe, jpipe = MelPipeline(), JaxMelPipeline(JaxAudioConfig())
    x = pipe.condition_waveform(torch.from_numpy(waves))
    mel, mag = pipe.mel_spectrogram(x)
    jmel, jmag = jpipe.mel_spectrogram(jpipe.condition_waveform(jnp.asarray(waves)))
    assert mel.shape == jmel.shape and mag.shape == jmag.shape
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), **SPEC_TOL)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), **MEL_TOL)
