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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.kernels.fused_block import _fused_block_pallas, fused_block_xla
from vcagan.nn.resnet import ResNetTrunk as JaxResNetTrunk
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
    before = fb.LAUNCHES
    out = fb.fused_basic_block(*args)
    assert fb.LAUNCHES == before  # counts kernel launches only
    torch.testing.assert_close(out, fb.fused_block_reference(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no fused block for device meta"):
        fb.fused_basic_block(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        fb.fused_block_cuda(*args)  # never a quiet fall back to the plain version
    assert fb.LAUNCHES == before


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
