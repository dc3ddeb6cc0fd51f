"""The port's two kernels at every width the JAX package runs.

The JAX package's attention kernel takes any ``attention_dim`` (the
attention's D), any S and B; so does the port's, which pads D to a multiple
of 8 with zeros (``padded_attention``) and plans every such shape.  The
fused block's C is a width of the ResNet trunk, 64, 128, 256 or 512 in both
packages whatever ``stem_channels`` is: the kernel takes those at any N
(chunks of images past 2^31 elements) and refuses C not a multiple of 64.
On the CPU:

- the JAX ``AVAttention`` at ``attention_dim`` 12, 100 and 264 (the last at
  S = 600 with a length 0) against the port's, weights carried across as
  ``tests/test_torch_modules.py`` carries them: the output and the
  gradients of the inputs and of every weight, at that file's tolerance;
- the padding that the attention's CUDA wrapper does, run around the plain
  version, against the unpadded plain version (rtol 1e-6);
- the planners: a plan for every D in {4, 12, 100, 264, 512, 1024, 4096}
  x S in {75, 512, 600, 750} at B = 70,000, and for the trunk's widths at
  its maps (crop 112 and 224) up to N = 50,000, each within the kernels'
  limits (``tests/test_torch_fused_block.py`` holds the refusal of C not a
  multiple of 64);
- the JAX ``fused_block_xla`` at C = 16, 40 and 100 against
  ``fused_block_reference``, the plain version the port runs on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_block import BF16_TOL, FP32_TOL, _check_plan, _jax_args, _mats, _torch_args
from vcagan.kernels.fused_block import fused_block_xla
from vcagan.nn import AVAttention as JaxAVAttention
from vcagan_torch.io.weights import as_tensors, attention_state
from vcagan_torch.kernels import fused_block as fb
from vcagan_torch.kernels import masked_attention as attn
from vcagan_torch.nn import AVAttention
from _torch_threads import _one_thread  # noqa: F401  (autouse)

MODULE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_modules.py
PAD_TOL = dict(rtol=1e-6, atol=1e-6)
F_BINS, C_IN, SENT, INNER = 4, 8, 16, 32


# ---- the attention


ATTENTION_CASES = [(12, 9, 7, [9, 4, 0]), (100, 21, 5, [21, 0, 13]),
                   (264, 600, 6, [0, 600, 257, 650])]


@pytest.mark.parametrize("d,s,t,lengths", ATTENTION_CASES,
                         ids=[f"D={c[0]} S={c[1]}" for c in ATTENTION_CASES])
def test_attention_module_matches_jax_at_width(d, s, t, lengths):
    rng = np.random.default_rng(d)
    b = len(lengths)
    sent = rng.standard_normal((b, s, SENT)).astype(np.float32)
    g = rng.standard_normal((b, F_BINS, t, C_IN)).astype(np.float32)  # JAX (B, F, T, C)
    cot = rng.standard_normal((b, F_BINS, t, INNER // F_BINS)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jax_module = JaxAVAttention(out_dim=d, inner_dim=INNER)
    params = jax_module.init(jax.random.PRNGKey(d), jnp.asarray(sent), jnp.asarray(g),
                             jnp.asarray(lens))["params"]

    def apply(p, sent, g):
        return jax_module.apply({"params": p}, sent, g, jnp.asarray(lens))

    want, vjp = jax.vjp(jax.jit(apply), params, jnp.asarray(sent), jnp.asarray(g))
    d_params, d_sent, d_g = vjp(jnp.asarray(cot))

    module = AVAttention(F_BINS * C_IN, d, INNER, SENT)
    module.load_state_dict(as_tensors(attention_state(params, F_BINS)), strict=True)
    t_sent = torch.from_numpy(sent).requires_grad_()
    t_g = torch.from_numpy(g).permute(0, 3, 1, 2).detach().requires_grad_()  # (B, C, F, T)
    got = module(t_sent, t_g, torch.from_numpy(lens))
    got.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    assert got.shape == (b, INNER // F_BINS, F_BINS, t)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               **MODULE_TOL)
    np.testing.assert_allclose(t_sent.grad.numpy(), np.asarray(d_sent), **MODULE_TOL)
    np.testing.assert_allclose(t_g.grad.permute(0, 2, 3, 1).numpy(), np.asarray(d_g),
                               **MODULE_TOL)
    grads = attention_state(jax.tree.map(np.asarray, d_params), F_BINS)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], err_msg=name, **MODULE_TOL)


@pytest.mark.parametrize("d", [4, 12, 100, 64])
def test_padded_attention_around_the_plain_version_is_the_plain_version(d):
    """What ``masked_attention_cuda`` does around its kernel, done around
    the plain version: zero columns to a multiple of 8, the true D's scale,
    the first D columns of the result."""
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((3, 5, d), (3, 21, d), (3, 21, d)))
    lens = torch.tensor([21, 0, 8], dtype=torch.int32)
    seen = []

    def attend(q, k, v, lengths):  # the plain version, scaled by the true D as the plans are
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        scale = math.sqrt(q.shape[-1] / d)
        return attn.masked_attention_reference(q * scale, k, v, lengths)

    got = attn.padded_attention(q, k, v, lens, attend)
    assert seen == [(attn.kernel_d(d),) * 3] and attn.kernel_d(d) % 8 == 0
    assert got.shape == (3, 5, d) and got.is_contiguous()
    torch.testing.assert_close(got, attn.masked_attention_reference(q, k, v, lens), **PAD_TOL)


ATTENTION_PLAN_D = [4, 12, 100, 264, 512, 1024, 4096]
ATTENTION_PLAN_S = [75, 512, 600, 750]
B_LARGE = 70_000


@pytest.mark.parametrize("s", ATTENTION_PLAN_S)
@pytest.mark.parametrize("d", ATTENTION_PLAN_D)
def test_attention_plans_every_width_at_a_large_batch(d, s):
    t = 150
    for b in (1, 4, B_LARGE):
        plan = attn.attention_plan(t, s, d, b)
        assert plan.d == d and plan.d_kernel == attn.kernel_d(d)
        assert plan.smem_bytes <= attn.MAX_SMEM
        if isinstance(plan, attn.AttentionPlan):  # the strip: S <= 512, B any
            assert s <= attn.S_MAX and plan.d_kernel % plan.d_chunk == 0
            ints = plan.ints(b)
            assert len(ints) == attn.PLAN_INTS and ints[:5] == [b, t, s, plan.d_kernel, d]
            continue
        assert plan.slices == -(-plan.d_kernel // attn.SLICE_D) >= 1
        assert plan.slices == 1 or plan.smem_bytes == 3 * 4 * 16384 + 32  # Q streams past 256
        assert 1 <= plan.launch_b <= attn.MAX_GRID_B and plan.launches * plan.launch_b >= b
        assert (plan.launches - 1) * plan.launch_b < b
        assert plan.workspace_floats <= attn.WORKSPACE_FLOATS or plan.launch_b == 1
        ints = plan.ints()
        assert len(ints) == attn.LONG_PLAN_INTS and ints[:5] == [b, t, s, plan.d_kernel, d]
        assert (ints[11] << 30) + ints[12] == plan.workspace_floats
        assert ints[13] == int(plan.in_block) and (not plan.in_block or plan.slices == 1)
    # the shapes the strip planned before keep a strip plan; up to 256
    # columns the planner may route them to the in-block instance instead
    if d % 8 == 0 and s <= attn.S_MAX and d <= 1024:
        assert attn.strip_plan(t, s, d, 4) is not None
        assert attn.instance(attn.attention_plan(t, s, d, 4)) == (
            "strip" if d > attn.IN_MAX_D else "in_block")


def test_attention_plan_refuses_no_key_and_no_query_row_only():
    for t, s, d in ((75, 0, 12), (0, 75, 12), (75, 75, 0)):
        with pytest.raises(ValueError):
            attn.attention_plan(t, s, d)


# ---- the fused block


@pytest.mark.parametrize("c", [16, 40, 100])
def test_fused_block_plain_version_matches_xla_at_width(c):
    args = _mats(2, 6, 5, c, seed=c)
    got = fb.fused_basic_block(*_torch_args(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(fused_block_xla(*_jax_args(args))),
                               **FP32_TOL)
    got = fb.fused_basic_block(*_torch_args(args, torch.bfloat16))
    want = fused_block_xla(*_jax_args(args, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


TRUNK_MAPS = {112: (28, 14, 7, 4), 224: (56, 28, 14, 7)}  # crop_size: the four stages' maps
TRUNK_WIDTHS = (64, 128, 256, 512)  # vcagan/nn/resnet.py: the stages' widths


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("crop", sorted(TRUNK_MAPS))
def test_fused_block_plans_the_trunk_at_its_maps_and_any_batch(crop, stage):
    c, hw = TRUNK_WIDTHS[stage], TRUNK_MAPS[crop][stage]
    for dtype in (torch.float32, torch.bfloat16):
        for n in (3, 3600, 50_000):  # 50,000 x 56 x 56 x 64 passes 2^31: chunks of images
            plan = fb.plan_fused_block(n, hw, hw, c, dtype)
            assert (plan.n, plan.h, plan.w, plan.c) == (n, hw, hw, c)
            assert plan.smem <= fb.MAX_SMEM
        _check_plan(fb.plan_fused_block(3, hw, hw, c, dtype), dtype)

