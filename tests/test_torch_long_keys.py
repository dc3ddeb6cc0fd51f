"""The attention past 512 keys: the port's plain version against the JAX
package, the arithmetic of the kernel past 512 keys and its plans.

The JAX kernel holds a whole sample per program and takes any S
(``vcagan/kernels/masked_attention.py:50-121``); the port's kernel takes
up to ``S_MAX`` keys in one score strip a tile and more in blocks of
``KEY_BLOCK`` keys with an online softmax, the blocks a sample needs shared
out over key splits that a second launch combines.  Here, on the CPU:
- the plain version (what the wrapper runs for CPU tensors, and what
  ``MaskedAttention``'s backward recomputes) against ``_attention_xla`` and
  ``_attention_pallas(interpret=True)`` at S = 513 and 640, lengths 0, 1,
  512, 513 and S: 1e-5, as ``tests/test_torch_attention.py`` (fp32 on both
  sides);
- the kernel's 3xTF32 arithmetic past 512 keys
  (``masked_attention_reference_3xtf32(..., key_block=, key_splits=)``)
  within 1e-5 of float64, of the plain version and of the Pallas kernel,
  rows of length 0 averaging all S values of v, at lengths on the key-block
  and split boundaries;
- the plans the kernel gets past 512 keys: within the shared memory, their
  key ranges covering every key a sample needs once, the split count of
  least modelled time, the ints in the C entry point's order.
The kernel itself is held to the plain version and float64 on the card by
``chip_smoke.py`` phases 2 and 12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.masked_attention import _attention_pallas, _attention_xla
from vcagan_torch.kernels import masked_attention as port
from _torch_threads import _one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
T, D = 9, 64


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
        for b in (1, 4):
            plan = port.attention_plan(t, s, 256, b)
            assert plan.key_block == port.KEY_BLOCK and plan.row_blocks == -(-t // 64)
            assert plan.smem_bytes <= port.MAX_SMEM
            # Q's TF32 parts (4 chunks of 64 columns), three slots of a K or V
            # piece's, an mbarrier each and Q's
            assert plan.smem_bytes == (2 * 4 + 2 * 3) * 16384 + 8 * 4
            # the split pieces (hi and lo) of Q, K and V, then the splits' partials
            pieces = 4 * b * (-(-t // 64) + 2 * -(-s // 64))
            assert plan.workspace_floats == 2 * 4096 * pieces + (
                0 if plan.splits == 1 else plan.splits * b * t * 258)
            covered = np.zeros(s, int)
            for k0, n in plan.key_blocks():
                assert 1 <= n <= plan.key_block and k0 % plan.key_block == 0
                covered[k0:k0 + n] += 1
            assert (covered == 1).all()
            for length in (-2, 0, 1, 63, 64, 65, s - 1, s, s + 3):
                covered = np.zeros(s, int)
                for k0, n in plan.key_ranges(length):
                    assert n >= 0 and (n == 0 or k0 % plan.key_block == 0)
                    covered[k0:k0 + n] += 1
                # the blocks that hold a key below the length, once; all for <= 0
                need = s if length <= 0 else min(s, -(-length // 64) * 64)
                assert (covered[:need] == 1).all() and (covered[need:] == 0).all()
                shares = [-(-n // 64) for _, n in plan.key_ranges(length)]
                assert max(shares) - min(shares) <= 1  # the splits' shares differ by <= 1


LONG_SHAPES = [(4, 750, 750), (4, 1500, 750), (8, 1026, 513), (2, 1280, 640), (1, 4096, 4096),
               (2, 20, 513), (1, 1, 600), (48, 150, 600)]


@pytest.mark.parametrize("b,t,s", LONG_SHAPES, ids=[f"{b}x{t}x{s}" for b, t, s in LONG_SHAPES])
def test_long_plans_take_the_least_modelled_time_and_send_their_ints(b, t, s):
    """Past 512 keys the planner takes the split count of least modelled
    time (ties to fewer splits); a plan of fewer blocks than SMs runs in one
    wave, and the ints go in the order the C entry point reads them."""
    plan = port.attention_plan(t, s, 256, b)
    assert plan.blocks == plan.row_blocks * plan.splits * b
    assert 1 <= plan.splits <= plan.key_blocks_all
    costs = [port.LongAttentionPlan(t, s, 256, b, n).cost_us()
             for n in range(1, plan.key_blocks_all + 1)]
    assert plan.cost_us() == min(costs) and costs.index(min(costs)) == plan.splits - 1
    # one block an SM: a share of key blocks a wave
    waves = -(-plan.blocks // port.SMS)
    share = -(-plan.key_blocks_all // plan.splits)
    assert plan.cost_us() >= waves * (share * port.KEY_BLOCK_US + port.BLOCK_US)
    assert plan.ints() == [b, t, s, 256, 256, plan.row_blocks, plan.splits, 1, 64,
                           plan.smem_bytes, b, 0, plan.workspace_floats, 0]
    assert len(plan.ints()) == port.LONG_PLAN_INTS


def test_long_plans_fill_the_card_where_a_wave_allows():
    """The measured plans: (4, 750, 750) in one wave of 96 blocks (2 splits),
    att2 of 30 s clips in 384 (4 splits), 4096 keys in 128 (2 splits); a
    shape with fewer blocks than SMs even unsplit takes more splits."""
    assert port.attention_plan(750, 750, 256, 4).splits == 2
    assert port.attention_plan(1500, 750, 256, 4).splits == 4
    assert port.attention_plan(4096, 4096, 256, 1).splits == 2
    assert port.attention_plan(20, 513, 256, 2).blocks > 2


@pytest.mark.parametrize("d", [264, 512])
def test_long_plans_refuse_d_past_256(d):
    """D past 256, once refused past 512 keys, takes column slices of 256
    (each block computing the scores again over all of D) with Q streamed
    through the ring beside K."""
    plan = port.attention_plan(9, 600, d)
    assert plan.key_block == port.KEY_BLOCK and plan.slices == 2 and plan.chunks == -(-d // 64)
    assert plan.smem_bytes == 3 * 4 * 16384 + 32 <= port.MAX_SMEM
    assert plan.ints()[3:8] == [d, d, plan.row_blocks, plan.splits, 2]


SPLIT_LENGTHS = [0, 1, 255, 256, 257, 512]


@pytest.mark.parametrize("s", [513, 640, 1030])
def test_key_split_3xtf32_holds_float64_and_pallas(s):
    """The kernel's arithmetic past 512 keys, key blocks skipped past each
    length and shared over the plan's splits (and over 3), within 1e-5 of
    float64 and of the Pallas kernel; a length-0 row averages all S
    values; lengths at the key-block and split boundaries."""
    lengths = SPLIT_LENGTHS + [s - 1, s, s + 3]
    t, d = 5, 256
    q, k, v, lens = _inputs(len(lengths), t, s, d, lengths, seed=s + 7)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    plan = port.attention_plan(t, s, d, len(lengths))
    want64 = port.masked_attention_reference(tq.double(), tk.double(), tv.double(), tl)
    pallas = np.asarray(_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                          interpret=True))
    for splits in sorted({plan.splits, 3}):
        got = port.masked_attention_reference_3xtf32(tq, tk, tv, tl, key_pad=port.N_TILE,
                                                     key_block=plan.key_block,
                                                     key_splits=splits)
        assert torch.isfinite(got).all()
        assert (got.double() - want64).abs().max() < 1e-5
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
        torch.testing.assert_close(got[0], tv[0].mean(0).expand(t, d), **TOL)
