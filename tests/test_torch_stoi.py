"""STOI/ESTOI of the PyTorch port against the JAX package's and the numpy
oracle; the port's copies of the numpy STOI and of PESQ against the JAX
package's.

Inputs: speech-like clips with leading silence (so silent frames are
removed), a noisy copy as the degraded signal, and for ``lengths`` a batch
zero-padded past each clip's true length.  Tolerances: against the float64
oracle, atol 1e-3, the JAX package's own bound for its batched STOI;
against the JAX package's fp32 program, atol 5e-4: the same operations,
summed in other orders, through normalised correlations of 30-frame
segments.  ESTOI's second normalisation amplifies rounding: on these
noisy clips the two fp32 programs give STOI 6e-5 apart and ESTOI 3.5e-4
apart, and the port run in float64 (with the fp32 filter and window)
lies 1.3e-4 from the oracle's ESTOI.  The copies of the numpy modules must give the same
numbers exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan_torch.eval import pesq_nb, stoi_np
from vcagan_torch.eval.stoi import stoi_batch, stoi_estoi_batch

# the modules (``vcagan.eval`` re-exports functions under two of their names)
jax_pesq_nb, jax_stoi, jax_stoi_np = (importlib.import_module(f"vcagan.eval.{name}")
                                      for name in ("pesq_nb", "stoi", "stoi_np"))
JAX_TOL = dict(atol=5e-4, rtol=0)
ORACLE_TOL = dict(atol=1e-3, rtol=0)
LENGTHS = [24000, 17000, 9000]


def speechlike(n, seed, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 120 + 40 * rng.random()
    env = np.clip(np.sin(2 * np.pi * 2.5 * t) + 0.3, 0, None)
    env[: n // 8] = 0.0  # leading silence
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 6))
    return (env * sig * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    xs = np.stack([speechlike(24000, s) for s in range(3)])
    ys = xs + 0.3 * np.random.default_rng(9).standard_normal(xs.shape).astype(np.float32) * xs.std()
    return xs, ys


@pytest.fixture(scope="module")
def padded(pair):
    """The clips cut to LENGTHS and zero-padded back to 24000 samples."""
    xs, ys = (a.copy() for a in pair)
    for i, n in enumerate(LENGTHS):
        xs[i, n:] = 0.0
        ys[i, n:] = 0.0
    return xs, ys


def oracle(xs, ys, extended, lengths=None):
    fn = stoi_np.estoi_np if extended else stoi_np.stoi_np
    lengths = lengths or [xs.shape[1]] * len(xs)
    return np.asarray([fn(x[:n], y[:n], fs=16000) for x, y, n in zip(xs, ys, lengths)])


@pytest.mark.parametrize("with_lengths", [False, True])
def test_stoi_estoi_batch(pair, padded, with_lengths):
    xs, ys = padded if with_lengths else pair
    lengths = np.asarray(LENGTHS, np.int32) if with_lengths else None
    got = stoi_estoi_batch(torch.from_numpy(xs), torch.from_numpy(ys),
                           lengths=None if lengths is None else torch.from_numpy(lengths))
    want = jax_stoi.stoi_estoi_batch(jnp.asarray(xs), jnp.asarray(ys),
                                     lengths=None if lengths is None else jnp.asarray(lengths))
    for g, w, extended in zip(got, want, (False, True)):
        assert g.shape == (3,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL)
        if with_lengths:  # pystoi on each clip at its true length
            np.testing.assert_allclose(g.numpy(), oracle(xs, ys, extended, LENGTHS),
                                       **ORACLE_TOL)
        else:
            np.testing.assert_allclose(g.numpy(), oracle(xs, ys, extended), **ORACLE_TOL)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_stoi_batch(pair, padded, extended, with_lengths):
    xs, ys = padded if with_lengths else pair
    lengths = np.asarray(LENGTHS, np.int32) if with_lengths else None
    got = stoi_batch(torch.from_numpy(xs), torch.from_numpy(ys), extended=extended,
                     lengths=None if lengths is None else torch.from_numpy(lengths))
    want = jax_stoi.stoi_batch(jnp.asarray(xs), jnp.asarray(ys), extended=extended,
                               lengths=None if lengths is None else jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_identical_signals_and_10k_input(pair):
    xs, _ = pair
    s, e = stoi_estoi_batch(torch.from_numpy(xs), torch.from_numpy(xs))
    assert (s > 0.99).all() and (e > 0.99).all()
    x10 = np.stack([stoi_np.resample_oct(x.astype(np.float64), 5, 8) for x in xs]).astype(np.float32)
    got = stoi_batch(torch.from_numpy(x10), torch.from_numpy(x10[::-1].copy()), input_rate=10_000)
    want = jax_stoi.stoi_batch(jnp.asarray(x10), jnp.asarray(x10[::-1].copy()), input_rate=10_000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    with pytest.raises(ValueError, match="input_rate"):
        stoi_batch(torch.from_numpy(xs), torch.from_numpy(xs), input_rate=8000)


def test_too_short_scores_1e5():
    """Under 30 band frames after silence removal: pystoi's 1e-5."""
    x = speechlike(4000, 1)[None]
    got = stoi_estoi_batch(torch.from_numpy(x), torch.from_numpy(x))
    assert [float(v) for v in got] == pytest.approx([1e-5, 1e-5])


def test_numpy_copies_equal_the_jax_packages(pair):
    xs, ys = pair
    for name in ("stoi_np", "estoi_np"):
        assert getattr(stoi_np, name)(xs[0], ys[0], fs=16000) == \
            getattr(jax_stoi_np, name)(xs[0], ys[0], fs=16000)
    got = pesq_nb.pesq_batch(xs, ys, fs=16000, workers=1)
    want = jax_pesq_nb.pesq_batch(xs, ys, fs=16000, workers=1)
    assert got == want and np.isfinite(got).all()
