"""Masked cross-attention of the PyTorch port against the JAX package.

The port's plain version (what its wrapper runs for CPU tensors) is held to
both JAX paths: the einsum oracle ``_attention_xla`` and the Pallas kernel
in interpret mode, at the cases of ``tests/test_attention_kernel.py`` plus
the edge lengths (0, < S, = S, > S).  Tolerance 1e-5 as there: both sides
are fp32 with D <= 256 terms per dot product.  The CUDA kernel itself is
held to the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.masked_attention import _attention_pallas, _attention_xla
from vcagan_torch.kernels import masked_attention as port

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, s, d, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    return q, k, v, np.asarray(lengths, np.int32)


CASES = [
    (1, 8, 8, 64, [1]),
    (4, 32, 16, 256, [1, 2, 3, 4]),
    (3, 77, 21, 256, [1, 2, 3]),  # non-aligned shapes
    (4, 19, 21, 256, [0, 7, 21, 40]),  # lengths 0, < S, = S, > S
]


@pytest.mark.parametrize("b,t,s,d,lengths", CASES)
def test_plain_matches_jax_oracle_and_pallas_interpret(b, t, s, d, lengths):
    q, k, v, lens = _inputs(b, t, s, d, lengths, seed=b * 1000 + t)
    got = port.masked_cross_attention(*(torch.from_numpy(a) for a in (q, k, v, lens))).numpy()
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    np.testing.assert_allclose(got, np.asarray(_attention_xla(jq, jk, jv, jl)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_attention_pallas(jq, jk, jv, jl, interpret=True)), **TOL
    )


def test_edge_lengths():
    """length 0 averages all of v (the mask is -1e30, not -inf); length >= S
    masks nothing."""
    b, t, s, d = 3, 5, 6, 32
    q, k, v, lens = _inputs(b, t, s, d, [0, s, s + 3], seed=7)
    got = port.masked_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), (t, d)), **TOL)
    scores = np.einsum("td,sd->ts", q[1], k[1]) / np.sqrt(d)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    np.testing.assert_allclose(got[1], (e / e.sum(-1, keepdims=True)) @ v[1], rtol=1e-4, atol=1e-5)
    full = port.masked_attention_reference(
        *(torch.from_numpy(a) for a in (q[2:], k[2:], v[2:], np.asarray([s], np.int32)))
    )
    np.testing.assert_allclose(got[2], full.numpy()[0], **TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(2, 4, 3, 16, [2, 3], seed=3))
    before = port.LAUNCHES
    out = port.masked_cross_attention(q, k, v, lens)
    assert port.LAUNCHES == before
    torch.testing.assert_close(out, port.masked_attention_reference(q, k, v, lens), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty((1, 2, 4), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        port.masked_cross_attention(q, q, q, lens)
    # the CUDA wrapper refuses CPU tensors instead of running something else
    with pytest.raises(ValueError):
        port.masked_attention_cuda(torch.zeros(1, 2, 4), torch.zeros(1, 2, 4),
                                   torch.zeros(1, 2, 4), torch.ones(1, dtype=torch.int32))
