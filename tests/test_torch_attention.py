"""Masked cross-attention of the PyTorch port against the JAX package.

The port's plain version (what its wrapper runs for CPU tensors) is held to
both JAX paths: the einsum oracle ``_attention_xla`` and the Pallas kernel
in interpret mode, at the cases of ``tests/test_attention_kernel.py`` plus
the edge lengths (0, < S, = S, > S).  Tolerance 1e-5 as there: both sides
are fp32 with D <= 256 terms per dot product.  The CUDA kernel itself is
held to the plain version on the card by ``chip_smoke.py``; here its
arithmetic (3xTF32: both products as three TF32 products of the operands'
high and low parts) is held to the JAX package in plain PyTorch, with the
keys padded as the kernel's tiles pad them, and the strip instance's tile
plan is checked (the in-block instance's plans: ``test_torch_short_keys.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.masked_attention import _attention_pallas, _attention_xla
from vcagan_torch import tracing
from vcagan_torch.kernels import _build
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
    before = tracing.counters()
    out = port.masked_cross_attention(q, k, v, lens)
    assert tracing.counters() == before  # no kernel call, no launch
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


# ---- the kernel's fp32 arithmetic (3xTF32) in plain PyTorch


@pytest.mark.parametrize("b,t,s,d,lengths", [*CASES, (2, 75, 75, 256, [75, 40])])
def test_3xtf32_holds_fp32_accuracy_where_one_tf32_product_does_not(b, t, s, d, lengths):
    q, k, v, lens = _inputs(b, t, s, d, lengths, seed=b * 1000 + t)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    got = port.masked_attention_reference_3xtf32(*args).numpy()
    np.testing.assert_allclose(got, np.asarray(_attention_xla(jq, jk, jv, jl)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_attention_pallas(jq, jk, jv, jl, interpret=True)), **TOL
    )
    one_pass = port.masked_attention_reference_3xtf32(*args, passes=1).numpy()
    assert np.abs(one_pass - np.asarray(_attention_xla(jq, jk, jv, jl))).max() > 1e-5


@pytest.mark.parametrize("key_pad", [port.N_TILE, port.KEY_TILE])
def test_padded_keys_get_weight_zero(key_pad):
    """S = 21 padded to the kernel's tiles with zero rows of K and V (score
    -inf, weight 0): a length-0 row still averages the 21 real values."""
    b, t, s, d = 4, 9, 21, 256
    q, k, v, lens = _inputs(b, t, s, d, [0, 5, 21, 30], seed=11)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    got = port.masked_attention_reference_3xtf32(*args, key_pad=key_pad).numpy()
    want = np.asarray(_attention_xla(*(jnp.asarray(a) for a in (q, k, v, lens))))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), (t, d)), **TOL)
    np.testing.assert_array_equal(got, port.masked_attention_reference_3xtf32(*args).numpy())


# ---- the tile plan


PLAN_CASES = [("att1", 75, 75, 256), ("att2", 150, 75, 256), ("LRS max", 640, 160, 256),
              *((f"T={t} S={s}", t, s, 256) for t in (1, 17) for s in (1, 8, 9, 160, port.S_MAX)),
              ("D=64", 33, 21, 64), ("D=128", 33, 21, 128), ("D=72", 33, 21, 72),
              ("D=80", 33, 21, 80)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_fits_shared_memory_and_covers_every_row_once(case):
    _, t, s, d = case
    plan = port.strip_plan(t, s, d)
    assert plan.smem_bytes <= port.MAX_SMEM == 232448
    assert plan.smem_bytes == 4 * (16 * plan.tiles * (plan.q_stride + plan.p_stride)
                                   + 2 * plan.key_tile * max(plan.k_stride, plan.v_stride))
    assert 1 <= plan.tiles <= port.TILES and plan.warps == plan.tiles * plan.split <= 8
    assert plan.split == (port.SPLIT if plan.d_chunk > 8 else 1)  # D=72: chunks of 8
    assert plan.key_tile == port.KEY_TILE
    assert plan.d_chunk == (64 if d % 64 == 0 else 8) and d % plan.d_chunk == 0
    # tile i of block r owns rows 16 (r * tiles + i) ... + 15
    covered = np.zeros(plan.row_tiles * plan.tiles * 16, int)
    for r in range(plan.row_tiles):
        for i in range(plan.tiles):
            covered[16 * (r * plan.tiles + i):16 * (r * plan.tiles + i + 1)] += 1
    assert (covered[:t] == 1).all() and len(covered) - t < 16 * plan.tiles
    # strides put a fragment's rows on different banks
    assert plan.q_stride % 8 == 4 and plan.k_stride % 8 == 4 and plan.p_stride % 8 == 4
    assert plan.v_stride % 32 in (8, 24)
    assert plan.key_block == 0 and plan.key_blocks() == [(0, s)]  # one strip of all S keys
    assert plan.ints(3) == [3, t, s, d, d, plan.warps, plan.d_chunk, plan.row_tiles, 0,
                            plan.smem_bytes]
    assert len(plan.ints(3)) == port.PLAN_INTS


@pytest.mark.parametrize("t,tiles,blocks", [(75, 3, 2), (150, 4, 3), (1, 1, 1), (640, 4, 10)])
def test_plan_spreads_the_tiles_over_the_blocks(t, tiles, blocks):
    """75 rows are 2 blocks of 3 tiles, not 4 + 1."""
    plan = port.strip_plan(t, 75, 256)
    assert (plan.tiles, plan.row_tiles, plan.warps) == (tiles, blocks, tiles * port.SPLIT)


@pytest.mark.parametrize("t,s,d", [(75, 75, 100), (75, 75, 4), (75, 0, 256), (0, 75, 256),
                                   (64, 512, 4096)])
def test_plan_refuses_what_the_kernel_does_not_take(t, s, d):
    """No key (S = 0) and no query row (T = 0) have no plan.  D = 100 and 4,
    once refused, have a strip plan at D padded to 104 and 8 (the scale of
    the true D), and the planner's plan is for the true D; (64, 512, 4096),
    whose strip does not fit shared memory, takes the key-blocked instance,
    in column slices of 256."""
    if s < 1 or t < 1:
        with pytest.raises(ValueError):
            port.attention_plan(t, s, d)
        return
    plan = port.attention_plan(t, s, d)
    assert plan.d == d and plan.d_kernel == -(-d // 8) * 8 and plan.smem_bytes <= port.MAX_SMEM
    if d == 4096:
        assert plan.key_block == port.KEY_BLOCK and plan.slices == 16
    else:
        strip = port.strip_plan(t, s, d)
        assert strip.key_block == 0 and strip.ints(1)[3:5] == [strip.d_kernel, d]


def test_plan_takes_keys_past_s_max():
    """S_MAX + 1 keys, once refused, take the key-blocked plan of the split
    pass; S_MAX keys keep a one-strip plan and the in-block instance's."""
    assert port.strip_plan(75, port.S_MAX, 256).key_block == 0
    assert port.in_block_plan(75, port.S_MAX, 256) is not None
    assert port.strip_plan(75, port.S_MAX + 1, 256) is None
    assert port.in_block_plan(75, port.S_MAX + 1, 256) is None
    plan = port.attention_plan(75, port.S_MAX + 1, 256)
    assert plan.key_block == port.KEY_BLOCK and plan.smem_bytes <= port.MAX_SMEM
    assert plan.key_blocks() == [(k0, 64) for k0 in range(0, 512, 64)] + [(512, 1)]


def test_an_edited_shared_header_rebuilds_every_kernel(tmp_path, monkeypatch):
    for name in ("masked_attention", "fused_block"):
        assert "tf32.cuh" in [p.rsplit("/", 1)[-1] for p in _build.sources(name)]
    for f in ("masked_attention.cu", "fused_block.cu", "tf32.cuh"):
        (tmp_path / f).write_bytes(open(f"{_build.CSRC}/{f}", "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = {name: _build.library_path(name) for name in ("masked_attention", "fused_block")}
    (tmp_path / "tf32.cuh").write_text((tmp_path / "tf32.cuh").read_text() + "\n// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path
