"""The port's fused ResNet block against the JAX package's.

The same numpy inputs go through ``vcagan.kernels.fused_block`` (the lax-conv
oracle ``fused_block_xla`` and the Pallas kernel in interpret mode, as
``tests/test_fused_block.py`` runs it) and through the port's
``fused_basic_block``, which on CPU tensors runs its plain version,
``fused_block_reference`` (the CUDA kernel is held to that same plain version
on the card by ``chip_smoke.py``).

Tolerances: fp32 rtol = atol = 2e-5, the JAX file's own bound (sums of up to
9*512 terms taken in another order); bf16 rtol = atol = 0.05 with a bf16
output, as the JAX file's bf16 case.

What the kernel reads and how it tiles is Python, so it is held here too:
the packed weights round-trip; the kernel's fp32 arithmetic (three TF32
products a multiply, ``fused_block_reference_3xtf32``) agrees with float64
and with the JAX package to 1e-4 where one TF32 product misses 1e-5; and
the tile plan fits shared memory and covers every pixel exactly once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.fused_block import _fused_block_pallas, fused_block_xla
from vcagan.nn.resnet import ResNetTrunk as JaxResNetTrunk
from vcagan_torch import tracing
from vcagan_torch.kernels import fused_block as fb
from vcagan_torch.nn import ResNetTrunk

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)

# (N, H, W, C, nb): the two cases of tests/test_fused_block.py (nb=2 with N=5
# pads N to a multiple), then one small case per shape class of the trunk.
CASES = [
    (5, 9, 9, 64, 2),
    (3, 5, 5, 16, 3),
    (2, 28, 28, 64, 1),
    (2, 14, 14, 128, 2),
    (2, 7, 7, 256, 2),
    (2, 4, 4, 512, 2),
]


def _mats(n, h, w, c, seed=0):
    """As ``tests/test_fused_block.py::_mats``; wider blocks get weights of
    variance 1/(9C) so that the outputs stay of order 1."""
    r = np.random.default_rng(seed)
    scale = 0.05 if c <= 64 else (9 * c) ** -0.5
    x = r.standard_normal((n, h, w, c)).astype(np.float32)
    w1 = (r.standard_normal((3, 3, c, c)) * scale).astype(np.float32)
    w2 = (r.standard_normal((3, 3, c, c)) * scale).astype(np.float32)
    b1 = (r.standard_normal(c) * 0.1).astype(np.float32)
    b2 = (r.standard_normal(c) * 0.1).astype(np.float32)
    # slopes of either sign: PReLU keeps x where x >= 0 whatever the slope
    a1 = (r.standard_normal(c) * 0.25).astype(np.float32)
    a2 = (r.standard_normal(c) * 0.25).astype(np.float32)
    return x, w1, b1, a1, w2, b2, a2


def _jax_args(args, dtype=jnp.float32):
    return (jnp.asarray(args[0], dtype), *(jnp.asarray(a) for a in args[1:]))


def _torch_args(args, dtype=torch.float32):
    return (torch.from_numpy(args[0]).to(dtype), *(torch.from_numpy(a) for a in args[1:]))


@pytest.mark.parametrize("n,h,w,c,nb", CASES)
def test_plain_version_matches_xla_and_pallas_interpret_fp32(n, h, w, c, nb):
    args = _mats(n, h, w, c, seed=c + h)
    got = fb.fused_basic_block(*_torch_args(args))
    assert got.shape == (n, h, w, c) and got.dtype == torch.float32 and got.is_contiguous()
    want = fused_block_xla(*_jax_args(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    kernel = _fused_block_pallas(*_jax_args(args), nb=nb, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **FP32_TOL)


@pytest.mark.parametrize("n,h,w,c,nb", [CASES[0], CASES[4]])
def test_plain_version_matches_xla_and_pallas_interpret_bf16(n, h, w, c, nb):
    args = _mats(n, h, w, c, seed=1)
    got = fb.fused_basic_block(*_torch_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    for want in (
        fused_block_xla(*_jax_args(args, jnp.bfloat16)),
        _fused_block_pallas(*_jax_args(args, jnp.bfloat16), nb=nb, interpret=True),
    ):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL
        )


def test_ring_of_h_outside_the_image_is_zero():
    """x = 0 and a large b1: h is PReLU(b1) on the image and zero around it.
    Evaluating conv1 on the ring instead would change every border pixel."""
    n, h, w, c = 2, 6, 5, 16
    x, w1, b1, a1, w2, b2, a2 = _mats(n, h, w, c, seed=3)
    args = (np.zeros_like(x), w1, b1 + 3.0, a1, w2, b2, a2)
    got = fb.fused_basic_block(*_torch_args(args)).numpy()
    want = np.asarray(fused_block_xla(*_jax_args(args)))
    border = np.ones((h, w), bool)
    border[1:-1, 1:-1] = False
    np.testing.assert_allclose(got[:, border], want[:, border], **FP32_TOL)
    # the trap's answer: h = PReLU(b1) on the ring too, i.e. every pixel
    # gets the centre's full 3x3 sum
    assert np.abs(got[:, border] - got[:, 2:3, 2, :]).max() > 0.1
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_cpu_takes_the_plain_version_and_other_devices_raise():
    args = _torch_args(_mats(1, 4, 4, 16))
    before = tracing.counters()
    out = fb.fused_basic_block(*args)
    assert tracing.counters() == before  # counts kernel calls and launches only
    torch.testing.assert_close(out, fb.fused_block_reference(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no fused block for device meta"):
        fb.fused_basic_block(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        fb.fused_block_cuda(*args)  # never a quiet fall back to the plain version
    assert tracing.counters() == before


def _trunk_pair():
    torch.manual_seed(0)
    plain = ResNetTrunk(fold_bn=True, fused=False)
    fused = ResNetTrunk(fold_bn=True, fused=True)
    return plain, fused


def test_same_state_dict_keys_with_and_without_fused():
    plain, fused = _trunk_pair()
    a, b = plain.state_dict(), fused.state_dict()
    assert list(a) == list(b)
    assert {k: (v.shape, v.dtype) for k, v in a.items()} == {
        k: (v.shape, v.dtype) for k, v in b.items()
    }
    assert "layer1.0.conv1.bias" in a and not any("bn" in k for k in a)
    # five identity-shortcut blocks go through the kernel wrapper, the three
    # projection blocks do not (vcagan/nn/resnet.py:74-88)
    blocks = [m for m in fused.modules() if hasattr(m, "fused")]
    assert [m.fused for m in blocks] == [True, True, False, True, False, True, False, True]


def test_fused_trunk_matches_unfused_trunk_and_jax_on_shared_params():
    plain, fused = _trunk_pair()
    # perturb the init so that biases and slopes all differ; small steps on
    # the convolution weights keep the maps of order 1 through 8 blocks
    state = {k: v + (0.002 if v.dim() == 4 else 0.05) * torch.randn_like(v)
             for k, v in plain.state_dict().items()}
    plain.load_state_dict(state)
    fused.load_state_dict(state)  # also repacks the kernel's weight copies
    x = np.random.default_rng(1).standard_normal((3, 28, 28, 64)).astype(np.float32)
    with torch.no_grad():
        y1 = plain(torch.from_numpy(x).permute(0, 3, 1, 2))
        y2 = fused(torch.from_numpy(x).permute(0, 3, 1, 2))  # channels-last view
        y3 = fused(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())  # NCHW memory
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), **FP32_TOL)
    np.testing.assert_allclose(y3.numpy(), y2.numpy(), rtol=0, atol=0)

    params = {}
    for key, value in state.items():  # layer1.0.conv1.weight -> layer1_0/conv1/kernel
        stage, block, *rest = key.split(".")
        node = params.setdefault(f"{stage}_{block}", {})
        value = value.numpy()
        if rest[0] == "downsample":
            node = node.setdefault("down_conv", {})
        elif rest[0].startswith("relu"):
            node.setdefault("act" + rest[0][-1], {})["alpha"] = value
            continue
        else:
            node = node.setdefault(rest[0], {})
        node["kernel" if rest[-1] == "weight" else "bias"] = (
            value.transpose(2, 3, 1, 0) if value.ndim == 4 else value
        )
    want = JaxResNetTrunk(fold_bn=True, fused=True).apply(
        {"params": params}, jnp.asarray(x), train=False
    )
    np.testing.assert_allclose(y2.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


# ---- what the kernel reads: packed weights


@pytest.mark.parametrize("c", [16, 48, 64, 128])
def test_pack_weights_round_trip(c):
    w = torch.from_numpy(_mats(1, 1, 1, c, seed=c)[1])
    packed = fb.pack_weights(w, torch.bfloat16)
    assert packed.dtype == torch.bfloat16 and packed.shape == (9 * c * c,)
    assert torch.equal(fb.unpack_weights(packed, c, torch.bfloat16), w.to(torch.bfloat16))

    packed = fb.pack_weights(w, torch.float32)
    assert packed.dtype == torch.float32 and packed.shape == (2 * 9 * c * c,)
    hi, lo = fb.unpack_weights(packed, c, torch.float32)
    for part in (hi, lo):  # TF32 values: rounding them again changes nothing
        assert torch.equal(fb.round_tf32(part), part)
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - w).abs() <= 2.0**-21 * w.abs()).all()
    assert (hi - w).abs().max() > 1e-6  # and hi alone is not w


def test_pack_weights_lays_out_core_matrices():
    """A core matrix is 8 output channels x 16 bytes of input channels, 128
    bytes; a k-step's two halves follow each other, then (fp32) the lo parts,
    then the next 8 output channels."""
    c = 64
    w = torch.from_numpy(_mats(1, 1, 1, c, seed=5)[1])
    tap, ks, j = 4, 1, 5  # tap (1, 1); k-step; output channels 8 j .. 8 j + 7
    bf = fb.pack_weights(w, torch.bfloat16).reshape(9, c // 16, c // 8, 2, 8, 8)
    for half in (0, 1):  # [output][k] of input channels 16 ks + 8 half ..
        want = w[1, 1, 16 * ks + 8 * half:16 * ks + 8 * half + 8, 8 * j:8 * j + 8].T
        assert torch.equal(bf[tap, ks, j, half], want.to(torch.bfloat16))
    fp = fb.pack_weights(w, torch.float32).reshape(9, c // 8, c // 8, 2, 2, 8, 4)
    for part, values in enumerate(fb.split_tf32(w)):
        for half in (0, 1):
            want = values[1, 1, 8 * ks + 4 * half:8 * ks + 4 * half + 4, 8 * j:8 * j + 8].T
            assert torch.equal(fp[tap, ks, j, part, half], want)


# ---- the kernel's fp32 arithmetic in plain PyTorch


@pytest.mark.parametrize("n,h,w,c,nb", [(3, 9, 9, 16, 2), (2, 7, 7, 64, 2)])
def test_3xtf32_holds_fp32_accuracy_where_one_tf32_product_does_not(n, h, w, c, nb):
    args = _mats(n, h, w, c, seed=7)
    t_args = _torch_args(args)
    got = fb.fused_block_reference_3xtf32(*t_args).numpy()
    want64 = fb.fused_block_reference(*(a.double() for a in t_args)).numpy()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want64, **tol)
    np.testing.assert_allclose(got, np.asarray(fused_block_xla(*_jax_args(args))), **tol)
    kernel = _fused_block_pallas(*_jax_args(args), nb=nb, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), **tol)
    # far inside the tolerance: the split keeps about 2^-21 a product ...
    assert np.abs(got - want64).max() < 1e-5
    # ... which one TF32 product a multiply does not
    single = fb.fused_block_reference_3xtf32(*t_args, passes=1).numpy()
    assert np.abs(single - want64).max() > 1e-5


# ---- the tile plan

TRUNK = {"layer1_0": (28, 28, 64), "layer1_1": (28, 28, 64), "layer2_1": (14, 14, 128),
         "layer3_1": (7, 7, 256), "layer4_1": (4, 4, 512)}
PLAN_CASES = [
    *((f"{name}-{kind}-N{n}", n, *shape, dtype)
      for name, shape in TRUNK.items()
      for kind, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))
      for n in (1, 7, 150, 3600)),
    ("ragged-11x5x64-fp32", 13, 11, 5, 64, torch.float32),
    ("ragged-11x5x192-bf16", 13, 11, 5, 192, torch.bfloat16),
    ("5x5x64-bf16", 3, 5, 5, 64, torch.bfloat16),
    ("9x9x64-fp32", 5, 9, 9, 64, torch.float32),
    ("31x3x192-fp32", 37, 31, 3, 192, torch.float32),
    ("3x33x320-bf16", 301, 3, 33, 320, torch.bfloat16),
]


def _check_plan(plan, dtype):
    """Shared memory, the kernel's limits, and the cover: every output pixel
    stored once, h inside the block's rows."""
    n, h, w, c = plan.n, plan.h, plan.w, plan.c
    k_step = 16 if dtype == torch.bfloat16 else 8
    assert plan.smem <= fb.MAX_SMEM == 232448
    assert plan.smem == fb._smem_bytes(c, plan.itemsize, plan.g, plan.xr, plan.hr, w, plan.bn,
                                       plan.ks, plan.stages)
    assert len(plan.ints()) == 14 and plan.ints()[-1] == plan.smem
    assert c % plan.bn == 0 and (c // k_step) % plan.ks == 0 and 2 <= plan.stages <= fb.MAX_STAGES
    assert plan.warps_m in (4, 8) and plan.wn * plan.mt <= 256
    assert plan.tiles == -(-h // plan.r) and (plan.g == 1 or plan.tiles == 1)
    assert plan.blocks == -(-n // plan.g) * plan.tiles

    written = np.zeros((n, h, w), np.int32)
    for block in range(plan.blocks):
        px = fb.block_pixels(plan, block)
        im, row, col = px["stores"].T
        np.add.at(written, (im, row, col), 1)
        # h: every pixel lands in the block's h rows, each in a place of its
        # own, never in the row of zeros that follows them, and only pixels
        # of the image are stored (there is no ring to keep zero)
        assert px["h_index"].min() >= 0 and px["h_index"].max() < plan.g * plan.hr * w
        assert len(np.unique(px["h_index"])) == len(px["h_index"])
        assert px["h_pixels"][:, 1].min() >= 0 and px["h_pixels"][:, 1].max() < h
        # phase 2 finds h on the output rows and their neighbours in the
        # image; phase 1 finds x on h's rows and their neighbours
        out_rows, h_rows, x_rows = px["out_rows"], px["h_rows"], px["x_rows"]
        for have, need in ((h_rows, out_rows), (x_rows, h_rows)):
            assert have.start <= max(need.start - 1, 0) and have.stop >= min(need.stop + 1, h)
        assert set(px["h_pixels"][:, 1]) == set(h_rows)
    assert (written == 1).all()


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_fits_shared_memory_and_covers_every_pixel_once(case):
    _, n, h, w, c, dtype = case
    plan = fb.plan_fused_block(n, h, w, c, dtype)
    assert (plan.n, plan.h, plan.w, plan.c) == (n, h, w, c)
    _check_plan(plan, dtype)


@pytest.mark.parametrize("case", [PLAN_CASES[i] for i in (1, 13, 21, 29, 37, 41, 45)],
                         ids=lambda case: case[0])
def test_every_candidate_the_planner_weighs_is_a_plan_the_kernel_takes(case):
    """The planner's pick is the cheapest candidate; the others (timed on
    the card by ``tune_fused_block``) tile the problem just as well."""
    _, n, h, w, c, dtype = case
    plans = fb.candidate_plans(n, h, w, c, dtype)
    assert fb.plan_fused_block(n, h, w, c, dtype) == min(plans, key=lambda p: p.cost)
    assert len({dataclasses.astuple(p) for p in plans}) == len(plans) > 20
    assert len({(p.r, p.g) for p in plans}) > 1 and len({p.ks for p in plans}) > 1
    for plan in plans[:: max(1, len(plans) // 12)]:
        _check_plan(plan, dtype)


def test_plan_refuses_what_the_kernel_does_not_take():
    for c in (16, 48, 96):  # the tensor-core tiles are 64 channels wide
        with pytest.raises(ValueError, match="multiple of 64"):
            fb.plan_fused_block(2, 4, 4, c, torch.float32)
    with pytest.raises(ValueError, match="no kernel for"):
        fb.plan_fused_block(2, 4, 4, 64, torch.float64)
    with pytest.raises(ValueError, match="fits"):  # one row of h alone is too much
        fb.plan_fused_block(1, 4, 4096, 512, torch.float32)
    assert fb.candidate_plans(1, 4, 4096, 512, torch.float32) == []


def test_tuning_script_imports_on_the_cpu_and_needs_a_card(monkeypatch):
    from vcagan_torch.kernels import tune_fused_block

    monkeypatch.setattr("sys.argv", ["tune_fused_block", "--top", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tune_fused_block.main()
