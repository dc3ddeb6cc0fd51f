"""The windowed-DFT Griffin-Lim (``griffin_lim_mxu``) and
``MelPipeline(gl_dtype=...)`` of the PyTorch port against the JAX package.

- fp32: the port's matmul form against the JAX package's with the same
  injected phase, atol 5e-5 at 20 rounds (the JAX package's own bound for
  its matmul form against its FFT form, ``tests/test_dsp.py:200-217``) and
  atol 2e-4 / rtol 1e-3 at 60 rounds (its bound against the reference's
  torch chain, ``tests/test_inverse_dsp_parity.py:207-226``); the port's
  matmul form against the port's FFT form, and each against a float64
  run of the matmul form, 5e-5 at 20 rounds.
- bf16 products with fp32 results: with no round, the one synthesis of a
  spectrum rounded to bf16 against the JAX package's to fp32 summation
  order (a result rounded to bf16 would be 2^-9 of the waveform off).
  After rounds the two packages' bf16 phases part (each rounding flip
  spreads), so they are held by the JAX package's convergence bounds
  (``tests/test_dsp.py:231-272``) on its multi-tone signal, each package
  on its own: spectral convergence sc32 < 0.35 and sc16 < 0.40,
  sc16 < 1.2 sc32 + 0.02, and the two reconstructions' log magnitudes
  correlated above 0.99.  The correlation bound is the JAX package's for
  one draw of the phase (``PRNGKey(3)``); over draws it spreads about it
  (the JAX package's own over keys 0-7: 0.9878-0.9915), so each package
  is held to it on its draw of seed 3, and over six draws each the port's
  mean correlation to the JAX package's mean, within 0.002.
- ``MelPipeline(gl_dtype=...)`` off the card runs the FFT form (the JAX
  pipeline's route off its accelerator): equal to ``MelPipeline()``, and
  to the JAX pipeline with the same ``gl_dtype``.
- Every form gives the waveform length hop * (T - 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.dsp import MelPipeline as JaxMelPipeline
from vcagan.dsp import stft as jax_stft
from vcagan.dsp.griffin_lim import griffin_lim_mxu as jax_griffin_lim_mxu
from vcagan.dsp.stft import STFTParams as JaxSTFTParams
from vcagan_torch.configs import AudioConfig
from vcagan_torch.dsp import MelPipeline, STFTParams, griffin_lim, griffin_lim_mxu, stft
from _torch_threads import _one_thread  # noqa: F401  (autouse)

P = STFTParams()
JP = JaxSTFTParams()
TOL_20 = dict(atol=5e-5, rtol=0)
TOL_60 = dict(atol=2e-4, rtol=1e-3)


def _speechish(n, seed):
    """Three amplitude-modulated partials, as the JAX package's inverse-DSP
    parity tests use."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = np.zeros_like(t)
    for f0 in (150.0, 450.0, 1200.0):
        am = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        x += am * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def _sine():
    t = np.arange(16000) / 16000
    return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None]


def _multi_tone():
    """``tests/test_dsp.py:241-250``'s signal: two tones and a noise floor."""
    rng = np.random.default_rng(7)
    t = np.arange(16000) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1310 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)[None]


def _mag(y):
    """Consistent magnitudes (B, T, 321) of a real signal, from the port's STFT."""
    return stft(torch.from_numpy(y), P).abs()


def _phase(shape, seed):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, shape).astype(np.float32)


def _port(mag, n, dtype, phase):
    return griffin_lim_mxu(mag, P, n, compute_dtype=dtype, init_phase=torch.from_numpy(phase))


def _jax(mag, n, dtype, phase):
    return np.asarray(jax_griffin_lim_mxu(
        jnp.asarray(mag.numpy()), jax.random.PRNGKey(0), JP, n, compute_dtype=dtype,
        init_phase=jnp.asarray(phase)))


@pytest.mark.parametrize("n_iters, tol", [(20, TOL_20), (60, TOL_60)], ids=["20", "60"])
def test_fp32_matches_the_jax_package(n_iters, tol):
    y = _sine() if n_iters == 20 else np.stack([_speechish(6400, 7 + s) for s in range(2)])
    mag = _mag(y)
    phase = _phase(mag.shape, n_iters)
    got = _port(mag, n_iters, torch.float32, phase).numpy()
    want = _jax(mag, n_iters, jnp.float32, phase)
    assert got.shape == want.shape == (y.shape[0], 160 * (mag.shape[1] - 1))
    np.testing.assert_allclose(got, want, **tol)


def test_fp32_matmul_form_matches_the_fft_form():
    mag = _mag(_sine())
    phase = torch.from_numpy(_phase(mag.shape, 1))
    got = griffin_lim_mxu(mag, P, 20, compute_dtype=torch.float32, init_phase=phase)
    want = griffin_lim(mag, P, 20, init_phase=phase)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_20)
    # the same draw of the phase from the same generator state
    gen = [torch.Generator().manual_seed(5) for _ in range(2)]
    np.testing.assert_allclose(
        griffin_lim_mxu(mag, P, 20, compute_dtype=torch.float32, generator=gen[0]).numpy(),
        griffin_lim(mag, P, 20, generator=gen[1]).numpy(), **TOL_20)


@pytest.mark.parametrize("form", ["matmul", "fft"])
def test_fp32_forms_match_a_float64_run(form):
    """Each fp32 form against the matmul form in float64 (bases, products
    and state), at the 20-round bound."""
    mag = _mag(np.stack([_speechish(6400, 21 + s) for s in range(2)]))
    phase = torch.from_numpy(_phase(mag.shape, 6))
    exact = griffin_lim_mxu(mag.double(), P, 20, compute_dtype=torch.float64,
                            init_phase=phase.double())
    assert exact.dtype == torch.float64
    got = (griffin_lim_mxu(mag, P, 20, compute_dtype=torch.float32, init_phase=phase)
           if form == "matmul" else griffin_lim(mag, P, 20, init_phase=phase))
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), **TOL_20)


def test_bf16_products_have_fp32_results():
    mag = _mag(np.stack([_speechish(6400, 3 + s) for s in range(2)]))
    phase = _phase(mag.shape, 2)
    got = _port(mag, 0, torch.bfloat16, phase).numpy()
    want = _jax(mag, 0, jnp.bfloat16, phase)
    fp32 = _port(mag, 0, torch.float32, phase).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-6 * scale
    # the bf16 form is a bf16 form: its spectrum was rounded
    assert np.abs(got - fp32).max() > 1e-4 * scale


def _convergence(run, mag):
    """The JAX package's bf16 quality check for one package's ``run(dtype)``
    -> (B, T, 321) magnitudes of the reconstruction."""
    m32, m16 = run("fp32"), run("bf16")
    sc32, sc16 = (float(np.linalg.norm(m - mag) / np.linalg.norm(mag)) for m in (m32, m16))
    assert sc32 < 0.35, sc32
    assert sc16 < 0.40, sc16
    assert sc16 < sc32 * 1.2 + 0.02, (sc16, sc32)
    corr = np.corrcoef(np.log(1e-5 + m32).ravel(), np.log(1e-5 + m16).ravel())[0, 1]
    assert corr > 0.99, corr
    return sc32, sc16, corr


def test_bf16_converges_as_the_jax_package_requires():
    y = _multi_tone()
    mag = _mag(y)
    dtypes = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}

    def port(dtype):
        rec = griffin_lim_mxu(mag, P, 60, compute_dtype=dtypes[dtype][0],
                              generator=torch.Generator().manual_seed(3))
        return stft(rec, P).abs().numpy()

    def jax_side(dtype):
        rec = jax_griffin_lim_mxu(jnp.asarray(mag.numpy()), jax.random.PRNGKey(3), JP, 60,
                                  compute_dtype=dtypes[dtype][1])
        return np.abs(np.asarray(jax_stft(rec, JP)))

    for run in (port, jax_side):
        _convergence(run, mag.numpy())


def test_bf16_correlation_spreads_as_the_jax_package_s():
    mag = _mag(_multi_tone())
    m = mag.numpy()

    def corr(m32, m16):
        for rec in (m32, m16):
            assert np.linalg.norm(rec - m) / np.linalg.norm(m) < 0.40
        return np.corrcoef(np.log(1e-5 + m32).ravel(), np.log(1e-5 + m16).ravel())[0, 1]

    port, jax_side = [], []
    for seed in range(6):
        port.append(corr(*(stft(griffin_lim_mxu(
            mag, P, 60, compute_dtype=d, generator=torch.Generator().manual_seed(seed)), P)
            .abs().numpy() for d in (torch.float32, torch.bfloat16))))
        jax_side.append(corr(*(np.abs(np.asarray(jax_stft(jax_griffin_lim_mxu(
            jnp.asarray(m), jax.random.PRNGKey(seed), JP, 60, compute_dtype=d), JP)))
            for d in (jnp.float32, jnp.bfloat16))))
    assert np.mean(port) > np.mean(jax_side) - 0.002, (port, jax_side)


@pytest.mark.parametrize("gl_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_mel_pipeline_off_the_card_runs_the_fft_form(gl_dtype):
    config = AudioConfig(griffin_lim_iters=8)
    spec = _mag(np.stack([_speechish(6400, 11 + s) for s in range(2)]))
    phase = _phase(spec.shape, 4)
    pipe = MelPipeline(config, gl_dtype=gl_dtype)
    assert pipe.gl_dtype == gl_dtype and MelPipeline().gl_dtype == torch.float32
    got = pipe.inverse_spec(spec, init_phase=torch.from_numpy(phase))
    fft = MelPipeline(config).inverse_spec(spec, init_phase=torch.from_numpy(phase))
    assert torch.equal(got, fft)
    jax_dtype = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[gl_dtype]
    want = JaxMelPipeline(JaxAudioConfig(griffin_lim_iters=8), gl_dtype=jax_dtype).inverse_spec(
        jnp.asarray(spec.numpy()), jax.random.PRNGKey(0), init_phase=jnp.asarray(phase))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("frames", [4, 5, 75, 300])
def test_every_form_gives_the_same_length(frames):
    mag = torch.rand((2, frames, P.n_bins), generator=torch.Generator().manual_seed(frames))
    lengths = {griffin_lim(mag, P, 1).shape,
               griffin_lim_mxu(mag, P, 1, compute_dtype=torch.float32).shape,
               griffin_lim_mxu(mag, P, 1).shape}
    assert lengths == {(2, 160 * (frames - 1))}
