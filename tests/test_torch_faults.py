"""Two faults of the PyTorch port against the JAX package, and their repairs.

- The CUDA kernels fill their result through ctypes, so it has no
  ``grad_fn``: under grad mode an input that requires grad would silently get
  no gradient, where the JAX kernel is differentiable
  (``vcagan/kernels/masked_attention.py:173-191``).  ``masked_attention_cuda``
  and ``fused_block_cuda`` refuse such inputs, and say so before they check
  the device, so the CPU reaches the check.  The plain versions (CPU
  tensors) stay differentiable.
- ``load_serving_npz`` raises on a leaf that no module reads, as the JAX
  reader does (``vcagan/io/serving_npz.py:101-103``).
"""

import os

import numpy as np
import pytest
import torch

from vcagan_torch.io.weights import load_serving_npz
from vcagan_torch.kernels import fused_block as fb
from vcagan_torch.kernels import masked_attention as attn

SERVING_NPZ = os.path.join(os.path.dirname(__file__), "..", "data", "soak_serving_q8.npz")


def _attention_inputs(grad):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g) for shape in ((2, 5, 64), (2, 7, 64), (2, 7, 64)))
    q.requires_grad_(grad)
    return q, k, v, torch.tensor([7, 3], dtype=torch.int32)


def _block_inputs(grad_on):
    c = 64
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 4, c, generator=g)
    w1, w2 = (torch.randn(3, 3, c, c, generator=g) / 24 for _ in range(2))
    b1, b2 = torch.zeros(c), torch.zeros(c)
    a1, a2 = torch.full((c,), 0.25), torch.full((c,), 0.25)
    args = dict(x=x, w1=w1, b1=b1, a1=a1, w2=w2, b2=b2, a2=a2)
    if grad_on:
        args[grad_on].requires_grad_(True)
    return args


def _packed(args):
    return (args["x"], fb.pack_weights(args["w1"].detach(), torch.float32), args["b1"], args["a1"],
            fb.pack_weights(args["w2"].detach(), torch.float32), args["b2"], args["a2"])


def test_attention_kernel_refuses_inputs_that_require_grad():
    q, k, v, lengths = _attention_inputs(grad=True)
    with pytest.raises(RuntimeError, match="forward only.*: q"):
        attn.masked_attention_cuda(q, k, v, lengths)
    # without grad mode, the next check is the device's
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        attn.masked_attention_cuda(q, k, v, lengths)


@pytest.mark.parametrize("grad_on", ["x", "b1", "a2"])
def test_fused_block_kernel_refuses_inputs_that_require_grad(grad_on):
    args = _block_inputs(grad_on)
    with pytest.raises(RuntimeError, match=f"forward only.*: {grad_on}"):
        fb.fused_block_cuda(*_packed(args))
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA device"):
        fb.fused_block_cuda(*_packed(args))


def test_plain_versions_stay_differentiable():
    q, k, v, lengths = _attention_inputs(grad=True)
    attn.masked_cross_attention(q, k, v, lengths).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
    args = _block_inputs("x")
    fb.fused_basic_block(**args).sum().backward()
    assert args["x"].grad is not None and args["x"].grad.abs().sum() > 0


def _copy_npz_with(tmp_path, extra):
    with np.load(SERVING_NPZ) as z:
        arrays = {key: z[key] for key in z.files}
    arrays.update(extra)
    path = tmp_path / "serving.npz"
    np.savez(path, **arrays)
    return str(path)


@pytest.mark.parametrize("leaf", ["params/gen/att3/q/kernel", "params/v_front/fc/stray",
                                  "stats/post/bn_out/mean"])
def test_serving_npz_with_an_unmatched_leaf_is_refused(tmp_path, leaf):
    path = _copy_npz_with(tmp_path, {leaf: np.zeros((4, 4), np.float16)})
    with pytest.raises(KeyError, match="unmatched leaves") as err:
        load_serving_npz(path)
    assert leaf in str(err.value)


def test_unaltered_serving_npz_still_loads():
    with np.load(SERVING_NPZ) as z:
        assert any(key.startswith("q8s:") for key in z.files)  # scales read with their leaf
    states = load_serving_npz(SERVING_NPZ)
    assert {name: len(sd) for name, sd in states.items()} == {"v_front": 155, "gen": 214,
                                                               "post": 21}
