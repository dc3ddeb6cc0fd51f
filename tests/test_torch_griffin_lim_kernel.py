"""The Griffin-Lim kernel's plan, refusals and plain twin
(``vcagan_torch/kernels/griffin_lim.py``) on the CPU.

- The twin (``griffin_lim_reference``: ``gl_reframe``'s gather of the four
  overlapping frames at each re-padded sample, reflected at both ends of the
  clip, and ``gl_project``'s projection, around ``torch.fft``'s transforms)
  against ``griffin_lim``, the FFT form, in fp32 and float64, B 1 and 3, T 4
  and 5 (where the reflection reaches past the first and the last frame),
  37 and 300, from an injected phase and from a generator: it rounds where
  the FFT form rounds, so the two agree to the last bit here, and the
  bound below is fp32 rounding.  The fp32 twin against the float64 FFT
  form within the 20-round bound of the Griffin-Lim forms
  (``tests/test_torch_griffin_lim_mxu.py``).
- The refusals: n_fft != 4 hop, win != n_fft, a hop not a multiple of 4,
  T < 4, and the plan's own.
- CPU tensors take the FFT form and move no counter; the launches of a call
  come from its plan.
- ``MelPipeline`` off the card against the JAX package's pipeline; the
  build links cuFFT and its hash covers what it links.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.dsp import MelPipeline as JaxMelPipeline
from vcagan_torch import tracing
from vcagan_torch.configs import AudioConfig
from vcagan_torch.dsp import MelPipeline, STFTParams, deemphasis, griffin_lim, stft
from vcagan_torch.dsp.griffin_lim import random_phase
from vcagan_torch.dsp.stft import _wss_correction, overlap_add, window
from vcagan_torch.kernels import _build
from vcagan_torch.kernels import griffin_lim as gl_kernel
from vcagan_torch.kernels.griffin_lim import (
    GriffinLimPlan, griffin_lim_cuda, griffin_lim_reference, kernel_launches, plan_griffin_lim,
    reframe_reference)
from _torch_threads import _one_thread  # noqa: F401  (autouse)

P = STFTParams()
ROUNDS = 8
# fp32 rounding of a waveform whose peak is about 1 after ROUNDS rounds
ULPS = {torch.float32: 1e-6, torch.float64: 1e-13}


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


def _mag(b, t, seed=0):
    """Consistent magnitudes (B, T, 321) of speech-like clips of T frames."""
    clips = np.stack([_speechish(P.hop_length * (t - 1), seed + i) for i in range(b)])
    return stft(torch.from_numpy(clips), P).abs()


def _draws(mag, source):
    """The keyword arguments of one draw of the initial phase, twice over:
    an injected phase (the same tensor) or two generators in one state."""
    if source == "init_phase":
        phase = random_phase(mag.shape, torch.Generator().manual_seed(11), mag.device, mag.dtype)
        return {"init_phase": phase}, {"init_phase": phase}
    return ({"generator": torch.Generator().manual_seed(5)},
            {"generator": torch.Generator().manual_seed(5)})


@pytest.mark.parametrize("source", ["init_phase", "generator"])
@pytest.mark.parametrize("t", [4, 5, 37, 300])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "f64"])
def test_twin_matches_the_fft_form(dtype, b, t, source):
    mag = _mag(b, t, seed=b + t).to(dtype)
    mine, theirs = _draws(mag, source)
    got = griffin_lim_reference(mag, P, ROUNDS, **mine)
    want = griffin_lim(mag, P, ROUNDS, **theirs)
    assert got.shape == want.shape == (b, P.hop_length * (t - 1))
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, atol=ULPS[dtype], rtol=0)


@pytest.mark.parametrize("t", [4, 5, 300])
def test_fp32_twin_within_rounding_of_float64(t):
    mag = _mag(2, t, seed=21)
    phase = random_phase(mag.shape, torch.Generator().manual_seed(6), mag.device)
    exact = griffin_lim(mag.double(), P, 20, init_phase=phase.double())
    got = griffin_lim_reference(mag, P, 20, init_phase=phase)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), atol=5e-5, rtol=0)


@pytest.mark.parametrize("t", [4, 5, 37])
def test_reframe_is_the_stft_of_the_overlap_added_signal(t):
    """One ``gl_reframe`` against the FFT form's ISTFT then framing, on frames
    that are not the transform of any signal."""
    frames = torch.randn((2, t, P.n_fft), generator=torch.Generator().manual_seed(t),
                         dtype=torch.float64)
    win = window(P, frames.device, frames.dtype)
    y = overlap_add(frames * win, P) * _wss_correction(t, P, frames.device, frames.dtype)
    y = torch.nn.functional.pad(y[:, 320:-320][:, None], (320, 320), mode="reflect")[:, 0]
    want = y.unfold(-1, P.n_fft, P.hop_length) * win
    torch.testing.assert_close(reframe_reference(frames, P), want, atol=1e-13, rtol=0)


@pytest.mark.parametrize("params, t, match", [
    (STFTParams(640, 200, 640), 10, "n_fft = 4 hop"),
    (STFTParams(640, 128, 640), 10, "n_fft = 4 hop"),
    (STFTParams(640, 160, 400), 10, "win_length = n_fft"),
    (STFTParams(648, 162, 648), 10, "multiple of 4"),
    (STFTParams(), 3, "T >= 4"),
    (STFTParams(), 1, "T >= 4"),
], ids=["hop200", "hop128", "win400", "hop162", "T3", "T1"])
def test_refusals(params, t, match):
    mag = torch.rand((2, t, params.n_bins))
    with pytest.raises(ValueError, match=match):
        plan_griffin_lim(2, t, params, 60)
    with pytest.raises(ValueError, match=match):
        griffin_lim_reference(mag, params, 1)


@pytest.mark.parametrize("b, t, params, rounds, match", [
    (0, 10, P, 60, "B >= 1"),
    (2, 10, P, -1, "rounds >= 0"),
    (2, 10, STFTParams(16384, 4096, 16384), 60, "shared memory"),
])
def test_plan_refusals(b, t, params, rounds, match):
    with pytest.raises(ValueError, match=match):
        plan_griffin_lim(b, t, params, rounds)


def test_the_kernel_wrapper_refuses_what_it_does_not_launch():
    mag = torch.rand((2, 10, P.n_bins))
    with pytest.raises(ValueError, match="CUDA device"):
        griffin_lim_cuda(mag, P, 1)
    grad = mag.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        griffin_lim_cuda(grad, P, 1)


@pytest.mark.parametrize("gl_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_tensors_take_the_fft_form_and_move_no_counter(gl_dtype):
    config = AudioConfig(griffin_lim_iters=ROUNDS)
    spec = _mag(2, 37, seed=3)
    phase = random_phase(spec.shape, torch.Generator().manual_seed(4), spec.device)
    before = tracing.counters()
    got = MelPipeline(config, gl_dtype=gl_dtype).inverse_spec(spec, init_phase=phase)
    want = torch.clamp(deemphasis(griffin_lim(spec, P, ROUNDS, init_phase=phase),
                                  config.preemphasis), -1.0, 1.0)
    assert torch.equal(got, want)
    after = tracing.counters()
    for name in ("griffin_lim.calls", "griffin_lim.launches"):
        assert after.get(name, 0) == before.get(name, 0)


@pytest.mark.parametrize("rounds, launches", [(0, 3), (1, 7), (20, 83), (60, 243)])
def test_launches_from_the_plan(rounds, launches):
    plan = plan_griffin_lim(48, 300, P, rounds)
    assert kernel_launches(plan) == launches


@pytest.mark.parametrize("b, t, tile, smem", [
    (48, 300, 16, 4 * (19 * 160 + 640)),
    (1, 4, 4, 4 * (7 * 160 + 640)),
    (8, 640, 16, 4 * (19 * 160 + 640)),
])
def test_the_plan_s_tile_and_shared_memory(b, t, tile, smem):
    plan = plan_griffin_lim(b, t, P, 60)
    assert plan == GriffinLimPlan(b, t, 640, 160, 60, tile, smem)
    assert plan.ints() == [b, t, 640, 160, 60, tile, smem]


def test_the_plan_takes_every_audio_config():
    for config in (AudioConfig(), JaxAudioConfig()):
        params = STFTParams(config.n_fft, config.hop_length, config.win_length)
        plan_griffin_lim(1, 4, params, config.griffin_lim_iters)


def test_the_gather_reflects_at_both_ends():
    """At T = 4 the re-padded signal (7 hops) is the clip's signal (3 hops)
    with two hops reflected on each side: the gather's positions p there
    mirror those inside, the edge samples not repeated."""
    idx, valid, m, p = gl_kernel._gather_index(4, P)
    pad, length = 320, 480
    s = p - pad
    assert s.shape == (7 * 160,)
    assert torch.equal(s[:pad], torch.arange(pad, 0, -1))
    assert torch.equal(s[pad:pad + length], torch.arange(length))
    assert torch.equal(s[pad + length:], torch.arange(length - 2, length - 2 - pad, -1))
    assert int(valid.sum(1).min()) >= 2 and bool(((idx >= 0) & (idx < 4 * 640)).all())


@pytest.mark.parametrize("t", [4, 75])
@pytest.mark.parametrize("entry", ["inverse_spec", "inverse_mel"])
def test_mel_pipeline_off_the_card_matches_the_jax_pipeline(entry, t):
    config = AudioConfig(griffin_lim_iters=ROUNDS)
    jax_pipe = JaxMelPipeline(JaxAudioConfig(griffin_lim_iters=ROUNDS))
    spec = _mag(2, t, seed=9)
    phase = np.random.default_rng(t).uniform(-math.pi, math.pi, spec.shape).astype(np.float32)
    pipe = MelPipeline(config)
    if entry == "inverse_mel":
        x = torch.clamp(pipe.compress_mel(spec) / 5.0, -1.0, 1.0)  # a normalised log-mel
    else:
        x = spec
    got = getattr(pipe, entry)(x, init_phase=torch.from_numpy(phase))
    want = getattr(jax_pipe, entry)(jnp.asarray(x.numpy()), jax.random.PRNGKey(0),
                                   init_phase=jnp.asarray(phase))
    assert got.shape == want.shape == (2, P.hop_length * (t - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


def test_the_build_links_cufft_and_hashes_what_it_links(monkeypatch):
    assert _build.link_flags("griffin_lim", "/toolkit/bin/nvcc") == [
        "-lcufft", "-Xlinker", "-rpath=/toolkit/lib64"]
    assert _build.link_flags("fused_stem", "/toolkit/bin/nvcc") == []
    before = _build.library_path("griffin_lim")
    monkeypatch.setitem(_build.LIBRARIES, "griffin_lim", ("cufft", "culibos"))
    assert _build.library_path("griffin_lim") != before
