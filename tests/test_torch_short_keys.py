"""The attention up to 512 keys on the in-block instance: plans and arithmetic.

Up to 512 keys and D up to 256 the port's attention launches one kernel a
call (one more to combine key splits): two warpgroups a block of 64 query
rows, a producer that copies each piece of K and V and splits it into its
TF32 parts in shared memory while the consumer runs the wgmma products on
the piece before (``LongAttentionPlan(in_block=True)``,
``vcagan_torch/csrc/masked_attention.cu``).  Here, on the CPU:

- its plans at D = 8, 64, 100, 256 and 264, S = 1, 8, 9, 75, 160 and 512,
  T = 1, 17, 40, 75 and 320: within the 232,448 bytes of shared memory, every
  query row in one block, every key below a length walked once by one
  split, none at or past a length >= 1, all S for a length <= 0; D = 264,
  past the instance's 256 output columns, takes the split-pass instance's
  column slices;
- its 3xTF32 arithmetic in plain PyTorch (``masked_attention_reference_3xtf32``
  with the plan's key blocks and splits) within 1e-5 of float64 and of the
  JAX Pallas kernel in interpret mode, at lengths 0, < S, = S and > S;
- the plain version (what the wrapper runs for CPU tensors) against the
  Pallas kernel at S <= 512;
- the ints the C entry point reads, and the planner's choice: the least
  modelled time of ``candidate_plans``.
The kernel itself is held to the plain version, float64 and this arithmetic
on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.masked_attention import _attention_pallas
from vcagan_torch.kernels import masked_attention as port
from _torch_threads import _one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
PLAN_D = [8, 64, 100, 256, 264]
PLAN_S = [1, 8, 9, 75, 160, 512]
PLAN_T = [1, 17, 40, 75, 320]


def _inputs(b, t, s, d, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    return q, k, v, np.asarray(lengths, np.int32)


def _lengths(s, kb):
    """Lengths on the key-block boundaries, below 1 and past S."""
    return sorted({-2, 0, 1, kb - 1, kb, kb + 1, s - 1, s, s + 3})


def _check_walk(plan, s):
    """Every key below a length walked once by one split, none past it; all
    S for a length <= 0; the splits' shares differ by one block at most."""
    kb = plan.key_block
    for length in _lengths(s, kb):
        covered = np.zeros(s, int)
        for k0, n in plan.key_ranges(length):
            assert n >= 0 and (n == 0 or k0 % kb == 0)
            covered[k0:k0 + n] += 1
        need = s if length <= 0 else min(s, -(-length // kb) * kb)
        assert (covered[:need] == 1).all() and (covered[need:] == 0).all()
        shares = [-(-n // kb) for _, n in plan.key_ranges(length)]
        assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("s", PLAN_S)
@pytest.mark.parametrize("d", PLAN_D)
def test_in_block_plans_fit_and_cover_every_row_and_walked_key_once(d, s):
    for t in PLAN_T:
        plans = [p for p in port.candidate_plans(t, s, d, 4) if port.instance(p) == "in_block"]
        if d > port.IN_MAX_D:  # 256 output columns a block: D = 264 takes the strip or slices
            assert plans == [] and port.in_block_plan(t, s, d, 4) is None
            plan = port.attention_plan(t, s, d, 4)
            assert plan.smem_bytes <= port.MAX_SMEM
            assert port.instance(plan) == "strip" or plan.slices == 2
            continue
        assert {p.key_block for p in plans} == {port.IN_KEY_BLOCK} == {40}
        assert port.in_block_plan(t, s, d, 4) in plans
        for plan in plans:
            dp = -(-plan.d_kernel // port.IN_COLS) * port.IN_COLS
            # Q's parts, four raw slots of a 40 x 32 piece, six split slots
            # of its two parts, an mbarrier a raw slot and two a split slot
            assert plan.smem_bytes == 2 * 64 * dp * 4 + 4 * 5120 + 6 * 10240 + 8 * 16
            assert plan.smem_bytes <= port.MAX_SMEM == 232448
            assert plan.row_blocks * 64 >= t > (plan.row_blocks - 1) * 64  # each row once
            assert plan.pieces == 0 and plan.slices == 1
            assert plan.workspace_floats == (0 if plan.splits == 1
                                             else plan.splits * 4 * t * (plan.d_kernel + 2))
            _check_walk(plan, s)


@pytest.mark.parametrize("t", [1, 320])
@pytest.mark.parametrize("s", [9, 75, 160, 512])
def test_in_block_plans_skip_the_key_blocks_past_each_length(s, t):
    """Every split count the planner may choose, every length class."""
    kb = port.IN_KEY_BLOCK
    for splits in range(1, -(-s // kb) + 1):
        _check_walk(port.LongAttentionPlan(t, s, 64, 3, splits, in_block=True, key_block=kb), s)


SHORT_ARITHMETIC = [(8, 1), (9, 1), (75, 1), (75, 2), (160, 2), (160, 4), (512, 1), (512, 13)]


@pytest.mark.parametrize("s,splits", SHORT_ARITHMETIC,
                         ids=[f"S={s} splits={n}" for s, n in SHORT_ARITHMETIC])
def test_in_block_3xtf32_holds_float64_and_pallas(s, splits):
    """The kernel's arithmetic with the plan's key blocks of 40 keys (the
    last padded to the n-tile), the blocks past each length skipped and the
    rest shared over the splits, within 1e-5 of float64 and of the Pallas
    kernel; a length-0 row averages all S values."""
    lengths = [0, 1, s // 2 + 1, s, s + 3]
    t, d = 5, 64
    q, k, v, lens = _inputs(len(lengths), t, s, d, lengths, seed=s + splits)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    plan = port.LongAttentionPlan(t, s, d, len(lengths), splits, in_block=True,
                                  key_block=port.IN_KEY_BLOCK)
    got = port.masked_attention_reference_3xtf32(tq, tk, tv, tl, key_pad=port.N_TILE,
                                                 key_block=plan.key_block, key_splits=plan.splits)
    want64 = port.masked_attention_reference(tq.double(), tk.double(), tv.double(), tl)
    assert torch.isfinite(got).all()
    assert (got.double() - want64).abs().max() < 1e-5
    pallas = np.asarray(_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                          interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    torch.testing.assert_close(got[0], tv[0].mean(0).expand(t, d), **TOL)


@pytest.mark.parametrize("s", [21, 75, 160, 512])
def test_plain_matches_pallas_up_to_512_keys(s):
    lengths = [0, s // 3 + 1, s, s + 5]
    t, d = 9, 256
    q, k, v, lens = _inputs(len(lengths), t, s, d, lengths, seed=s)
    got = port.masked_cross_attention(*(torch.from_numpy(a) for a in (q, k, v, lens))).numpy()
    pallas = np.asarray(_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                          interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), (t, d)), **TOL)


def test_in_block_plan_sends_its_ints():
    plan = port.LongAttentionPlan(150, 75, 256, 48, 2, in_block=True, key_block=40)
    ws = plan.workspace_floats
    assert ws == 2 * 48 * 150 * 258
    assert plan.ints() == [48, 150, 75, 256, 256, 3, 2, 1, 40, plan.smem_bytes, 48, ws >> 30,
                           ws & (2**30 - 1), 1]
    assert len(plan.ints()) == port.LONG_PLAN_INTS


PLANNED = [(48, 75, 75), (48, 150, 75), (88, 40, 40), (88, 80, 40), (16, 50, 50),
           (16, 120, 120), (100, 150, 75), (8, 320, 160), (4, 640, 160), (3, 75, 21),
           (4, 750, 750), (70_000, 2, 3)]


@pytest.mark.parametrize("b,t,s", PLANNED, ids=[f"{b}x{t}x{s}" for b, t, s in PLANNED])
def test_the_planner_takes_the_least_modelled_time(b, t, s):
    """Among every plan it may choose (ties to the first: the in-block
    instance, then fewer splits), the strip's model over its margin; every
    main-path shape up to 512 keys on the in-block instance, the tiny
    blocks of B = 70,000 on the strip, past 512 keys the split pass."""
    plans = port.candidate_plans(t, s, 256, b)
    pick = port.attention_plan(t, s, 256, b)
    assert pick in plans
    assert port.routing_cost(pick) == min(port.routing_cost(p) for p in plans)
    want = "split_pass" if s > port.S_MAX else "strip" if b == 70_000 else "in_block"
    assert port.instance(pick) == want
