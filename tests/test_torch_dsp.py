"""DSP of the PyTorch port against ``vcagan.dsp`` on the same inputs.

Waveform tolerance atol 5e-4 / rtol 1e-3, that of the JAX package's own
inverse-DSP parity tests (``tests/test_inverse_dsp_parity.py:205-275``):
60 Griffin-Lim rounds of fp32 FFTs compound rounding differences.  One
STFT or ISTFT is held tighter (rtol 1e-5, atol 1e-4 against spectra of
magnitude up to a few hundred).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.dsp import MelPipeline as JaxMelPipeline
from vcagan.dsp import audio as jax_audio
from vcagan.dsp import griffin_lim as jax_griffin_lim
from vcagan.dsp import mel_filterbank as jax_mel_filterbank
from vcagan.dsp import stft as jax_stft
from vcagan.dsp.stft import STFTParams as JaxSTFTParams
from vcagan.dsp.stft import istft_complex as jax_istft_complex
from vcagan_torch.dsp import MelPipeline, STFTParams, deemphasis, griffin_lim, istft_complex, stft
from vcagan_torch.dsp.mel import mel_filterbank
from _torch_threads import _one_thread  # noqa: F401  (autouse)


WAV_TOL = dict(atol=5e-4, rtol=1e-3)
SPEC_TOL = dict(atol=1e-4, rtol=1e-5)


def _speechish(n, seed):
    """A voiced-speech-like clip: harmonics under a syllable envelope."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f0 = 110 + 40 * rng.random()
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.random() * 6.28) / h for h in range(1, 12))
    y *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    y += 0.01 * rng.standard_normal(n)
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def _clips(b=2, n=6400, seed=0):
    return np.stack([_speechish(n, seed + i) for i in range(b)])


def _consistent_mag(y):
    """|STFT| of a real signal, (B, T, 321), from the JAX package."""
    return np.abs(np.array(jax_stft(jnp.asarray(y), JaxSTFTParams())))


def test_mel_filterbank_is_identical():
    np.testing.assert_array_equal(mel_filterbank(), jax_mel_filterbank())
    np.testing.assert_array_equal(
        mel_filterbank(16000, 640, 80, 55.0, 7600.0), jax_mel_filterbank(16000, 640, 80, 55.0, 7600.0)
    )


def test_stft_and_istft():
    y = _clips()
    got = stft(torch.from_numpy(y), STFTParams()).numpy()
    want = np.asarray(jax_stft(jnp.asarray(y), JaxSTFTParams()))
    assert got.shape == want.shape == (2, 41, 321)
    np.testing.assert_allclose(got, want, **SPEC_TOL)

    rng = np.random.default_rng(1)
    re, im = (rng.standard_normal((2, 41, 321)).astype(np.float32) for _ in range(2))
    got = istft_complex(torch.from_numpy(re), torch.from_numpy(im), STFTParams()).numpy()
    want = np.asarray(jax_istft_complex(jnp.asarray(re), jnp.asarray(im), JaxSTFTParams()))
    assert got.shape == want.shape == (2, 6400)
    np.testing.assert_allclose(got, want, **SPEC_TOL)


@pytest.mark.parametrize("n", [1, 7, 48_000])
def test_deemphasis_doubling_scan(n):
    x = np.random.default_rng(n).uniform(-1, 1, (2, n)).astype(np.float32)
    got = deemphasis(torch.from_numpy(x), 0.97).numpy()
    want = np.asarray(jax_audio.deemphasis(jnp.asarray(x), 0.97))
    np.testing.assert_allclose(got, want, **WAV_TOL)
    if n == 7:  # and the sequential definition itself
        y = np.zeros_like(x, dtype=np.float64)
        for i in range(n):
            y[:, i] = x[:, i] + (0.97 * y[:, i - 1] if i else 0.0)
        np.testing.assert_allclose(got, y, rtol=1e-6, atol=1e-6)


def test_griffin_lim_60_rounds_with_injected_phase():
    mag = _consistent_mag(_clips(seed=7))
    phase = np.random.default_rng(0).uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    got = griffin_lim(torch.from_numpy(mag), STFTParams(), 60,
                      init_phase=torch.from_numpy(phase)).numpy()
    want = np.asarray(jax_griffin_lim(
        jnp.asarray(mag), jax.random.PRNGKey(0), JaxSTFTParams(), 60, init_phase=jnp.asarray(phase)
    ))
    assert got.shape == want.shape == (2, 6400)
    np.testing.assert_allclose(got, want, **WAV_TOL)


def test_pipeline_inverse_spec_and_inverse_mel():
    pipe, jpipe = MelPipeline(), JaxMelPipeline(JaxAudioConfig())
    mag = _consistent_mag(_clips(seed=11))
    phase = np.random.default_rng(2).uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    got = pipe.inverse_spec(torch.from_numpy(mag), init_phase=torch.from_numpy(phase)).numpy()
    want = np.asarray(jpipe.inverse_spec(jnp.asarray(mag), jax.random.PRNGKey(0),
                                         init_phase=jnp.asarray(phase)))
    np.testing.assert_allclose(got, want, **WAV_TOL)

    log_mel = np.array(jpipe.compress_mel(jnp.asarray(mag)))
    np.testing.assert_allclose(
        pipe.compress_mel(torch.from_numpy(mag)).numpy(), log_mel, rtol=1e-5, atol=1e-5
    )
    mel_norm = np.array(jax_audio.mel_normalize(jnp.asarray(log_mel)))
    np.testing.assert_allclose(
        pipe.mel_to_linear(torch.from_numpy(mel_norm)).numpy(),
        np.asarray(jpipe.mel_to_linear(jnp.asarray(mel_norm))), rtol=1e-5, atol=1e-3,
    )
    got = pipe.inverse_mel(torch.from_numpy(mel_norm), init_phase=torch.from_numpy(phase)).numpy()
    want = np.asarray(jpipe.inverse_mel(jnp.asarray(mel_norm), jax.random.PRNGKey(0),
                                        init_phase=jnp.asarray(phase)))
    np.testing.assert_allclose(got, want, **WAV_TOL)


def test_random_phase_comes_from_the_callers_generator():
    mag = torch.from_numpy(_consistent_mag(_clips(b=1, n=1600)))
    a = griffin_lim(mag, STFTParams(), 2, generator=torch.Generator().manual_seed(5))
    b = griffin_lim(mag, STFTParams(), 2, generator=torch.Generator().manual_seed(5))
    c = griffin_lim(mag, STFTParams(), 2, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
