"""Modules of the PyTorch port against the JAX modules on the same weights.

Each JAX module is applied (eval mode) to variable trees with the structure
of its init and seeded random values (``test_torch_weights.jax_variables``),
and the port's module gets the same trees through ``from_jax``.  Inputs are
made with numpy and handed to both.  Tolerance rtol=atol=2e-4, that of the
reference parity tests (``tests/test_torch_parity.py:38``): fp32 on both
sides, with convolutions summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_variables
from vcagan.nn import AVAttention as JaxAVAttention
from vcagan.nn import Decoder as JaxDecoder
from vcagan.nn import Postnet as JaxPostnet
from vcagan.nn import VisualFront as JaxVisualFront
from vcagan_torch.io.weights import as_tensors, attention_state, from_jax
from vcagan_torch.nn import AVAttention, Decoder, Postnet, VisualFront

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def variables():
    params, stats = jax_variables(seed=11)
    return params, stats, from_jax(params, stats)


def _port(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def test_visual_front(variables):
    params, stats, states = variables
    video = np.random.default_rng(0).standard_normal((2, 6, 48, 48, 1)).astype(np.float32)
    phon_j, sent_j = JaxVisualFront().apply(
        {"params": params["v_front"], "batch_stats": stats["v_front"]},
        jnp.asarray(video), train=False,
    )
    with torch.no_grad():
        phon, sent = _port(VisualFront(), states["v_front"])(torch.from_numpy(video))
    np.testing.assert_allclose(phon.numpy(), np.asarray(phon_j), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(sent_j), **TOL)


@pytest.mark.parametrize("att,f,c,t", [("att1", 20, 128, 7), ("att2", 40, 64, 14)])
def test_av_attention(variables, att, f, c, t):
    params = variables[0]["gen"][att]
    rng = np.random.default_rng(1)
    sent = rng.standard_normal((2, 7, 512)).astype(np.float32)
    g = rng.standard_normal((2, f, t, c)).astype(np.float32)  # JAX (B, F, T, C)
    lengths = np.asarray([7, 4], np.int32)
    want = JaxAVAttention().apply(
        {"params": params}, jnp.asarray(sent), jnp.asarray(g), jnp.asarray(lengths)
    )
    module = _port(AVAttention(f * c), as_tensors(attention_state(params, f)))
    with torch.no_grad():
        got = module(torch.from_numpy(sent), torch.from_numpy(g).permute(0, 3, 1, 2),
                     torch.from_numpy(lengths))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_decoder_with_injected_noise(variables):
    params, stats, states = variables
    b, t = 2, 8
    rng = np.random.default_rng(2)
    sent, phon = (rng.standard_normal((b, t, 512)).astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((b, 20, t, 128)).astype(np.float32)
    lengths = np.asarray([t, t - 3], np.int32)
    want = JaxDecoder().apply(
        {"params": params["gen"], "batch_stats": stats["gen"]},
        jnp.asarray(sent), jnp.asarray(phon), jnp.asarray(lengths),
        train=False, noise=jnp.asarray(noise),
    )
    with torch.no_grad():
        got = _port(Decoder(), states["gen"])(
            torch.from_numpy(sent), torch.from_numpy(phon), torch.from_numpy(lengths),
            noise=torch.from_numpy(noise),
        )
    for name, g, w in zip(("mel1", "mel2", "mel3"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_postnet(variables):
    params, stats, states = variables
    mel = np.random.default_rng(3).standard_normal((2, 80, 32)).astype(np.float32)
    want = JaxPostnet().apply(
        {"params": params["post"], "batch_stats": stats["post"]}, jnp.asarray(mel), train=False
    )
    with torch.no_grad():
        got = _port(Postnet(), states["post"])(torch.from_numpy(mel))
    assert got.shape == (2, 321, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
