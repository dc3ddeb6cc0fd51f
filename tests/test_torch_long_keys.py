"""The attention past 512 keys: the port's plain version against the JAX
package, the key-blocked kernel's arithmetic and its plans.

The JAX kernel holds a whole sample per program and takes any S
(``vcagan/kernels/masked_attention.py:50-121``); the port's kernel takes
up to ``S_MAX`` keys in one score strip a tile and more in blocks of
``KEY_BLOCK`` keys with an online softmax.  Here, on the CPU:
- the plain version (what the wrapper runs for CPU tensors, and what
  ``MaskedAttention``'s backward recomputes) against ``_attention_xla`` and
  ``_attention_pallas(interpret=True)`` at S = 513 and 640, lengths 0, 1,
  512, 513 and S: 1e-5, as ``tests/test_torch_attention.py`` (fp32 on both
  sides);
- the key-blocked 3xTF32 arithmetic (``masked_attention_reference_3xtf32(...,
  key_block=)``) within 1e-5 of float64 and of the plain version, rows of
  length 0 averaging all S values of v;
- the plans the kernel gets for S in {513, 640, 750, 1024, 4096}: within
  the shared memory, their blocks covering every key once.
The kernel itself is held to the plain version and float64 on the card by
``chip_smoke.py`` phase 12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.masked_attention import _attention_pallas, _attention_xla
from vcagan_torch.kernels import masked_attention as port

TOL = dict(rtol=1e-5, atol=1e-5)
T, D = 9, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread a test: the tier-1 command runs six workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, t, s, d, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("s", [513, 640])
def test_plain_matches_jax_past_512_keys(s):
    lengths = [0, 1, 512, 513, s]
    q, k, v, lens = _inputs(len(lengths), T, s, D, lengths, seed=s)
    got = port.masked_cross_attention(*(torch.from_numpy(a) for a in (q, k, v, lens))).numpy()
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    np.testing.assert_allclose(got, np.asarray(_attention_xla(jq, jk, jv, jl)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_attention_pallas(jq, jk, jv, jl, interpret=True)), **TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), (T, D)), **TOL)


@pytest.mark.parametrize("s,lengths", [
    (513, [0, 1, 256, 257, 512, 513]),
    (640, [0, 300, 511, 512, 600, 640]),
    (750, [0, 1, 255, 700, 750, 900]),
])
def test_key_blocked_3xtf32_holds_float64(s, lengths):
    """The kernel's key-blocked arithmetic, with its blocks of KEY_BLOCK keys
    and the last one padded to the n-tile, within 1e-5 of float64 and of
    the plain version; a length-0 row averages all S values."""
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(len(lengths), T, s, 256, lengths,
                                                          seed=s + 1))
    plan = port.attention_plan(T, s, 256)
    got = port.masked_attention_reference_3xtf32(q, k, v, lens, key_pad=port.N_TILE,
                                                 key_block=plan.key_block)
    want64 = port.masked_attention_reference(q.double(), k.double(), v.double(), lens)
    assert torch.isfinite(got).all()
    assert (got.double() - want64).abs().max() < 1e-5
    torch.testing.assert_close(got, port.masked_attention_reference(q, k, v, lens), **TOL)
    torch.testing.assert_close(got[0], v[0].mean(0).expand(T, 256), **TOL)


def test_key_blocked_arithmetic_at_small_blocks():
    """Blocks of 32 keys over 70 (the last of 6, padded to 8): a row whose
    real keys end in the first block, one whose last real key opens the
    last block, and the all-masked and unmasked rows."""
    lengths = [0, 20, 64, 65, 70, 99]
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(len(lengths), 5, 70, 16, lengths,
                                                          seed=3))
    got = port.masked_attention_reference_3xtf32(q, k, v, lens, key_pad=port.N_TILE,
                                                 key_block=32)
    want64 = port.masked_attention_reference(q.double(), k.double(), v.double(), lens)
    assert (got.double() - want64).abs().max() < 1e-5


@pytest.mark.parametrize("s", [513, 640, 750, 1024, 4096])
def test_key_blocked_plans_fit_and_cover_every_key_once(s):
    for t in (1, 75, 750, 1500):
        plan = port.attention_plan(t, s, 256)
        assert plan.key_block == port.KEY_BLOCK and plan.key_block % port.KEY_TILE == 0
        assert plan.smem_bytes <= port.MAX_SMEM
        rows = 16 * plan.tiles
        assert plan.smem_bytes == 4 * (rows * (plan.q_stride + plan.p_stride + plan.o_stride + 2)
                                       + 2 * plan.key_tile * max(plan.k_stride, plan.v_stride))
        assert plan.p_stride == plan.key_block + 4 and plan.o_stride % 32 == 8
        covered = np.zeros(s, int)
        for k0, n in plan.key_blocks():
            assert 1 <= n <= plan.key_block and k0 % plan.key_block == 0
            covered[k0:k0 + n] += 1
        assert (covered == 1).all()
        # every block holds a real key: the padding to 8 sits in the last one
        last = plan.key_blocks()[-1]
        assert last[0] + last[1] == s and last[1] >= 1
        ints = plan.ints(4)
        assert len(ints) == port.PLAN_INTS and ints[7] == plan.key_block
    assert port.attention_plan(1500, s, 256).tiles == port.TILES  # 4 tiles a block still fit
