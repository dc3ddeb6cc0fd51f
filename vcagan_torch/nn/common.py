"""Shared layers: per-channel PReLU, LeakyReLU(0.2), BatchNorm (eval, and
train mode as flax's), dropout from an explicit generator, convolutions
that compute in a given dtype and a dense layer that computes in fp32;
``recomputed``, a call whose activations the backward recomputes; and
``init_like_jax``, the JAX package's weight initialisation.

The port keeps PyTorch's channels-first layout inside its modules (NCHW,
NCDHW, (B, C, T)); public inputs and outputs keep the JAX package's layout.

Compute dtypes follow the JAX modules (``vcagan/nn/common.py:20-63``): in
the bf16 serving mode the parameters stay fp32 and each layer casts them at
the call.  A convolution casts its input, weight and bias to its
``compute_dtype`` (flax's ``nn.Conv(dtype=...)``); PReLU casts its slopes to
the input's dtype; BatchNorm takes bf16 in, normalises with its fp32
statistics and gives bf16 out.  A Python constant that JAX multiplies into
a bf16 array is weakly typed, so it is rounded to bf16 first
(``rounded``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import math
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vcagan_torch.parallel.collectives import all_reduce_sum
from vcagan_torch.parallel.mesh import active_layout, draw_rows

_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "vcagan_torch_recomputing", default=False)
# recomputes of each remat site since the count was last cleared (the tests
# and chip_smoke.py read it; nothing in the step does)
RECOMPUTES: collections.Counter = collections.Counter()

INV_SQRT2 = 1.0 / math.sqrt(2.0)
# The std of the unit normal truncated at +-2, by which flax's lecun_normal
# divides its scale so that the truncated draw has std 1 / sqrt(fan_in).
TRUNCATED_UNIT_STD = 0.87962566103423978
BN_EPS = 1e-5
LEAKY_SLOPE = 0.2


def fp32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast up to fp32 where it is narrower (bf16); fp32 and float64
    stay as they are (float64: the data-parallel gate's exact check,
    ``vcagan_torch/parallel/dryrun.py``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rounded(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``: rounded
    to that type (the product of two bf16 values is exact in fp32, so the
    one rounding of the result then matches)."""
    return float(torch.tensor(value, dtype=dtype))


class PReLU(nn.PReLU):
    """Per-channel parametric ReLU, slopes initialised to 0.25; the fp32
    slopes are cast to the input's dtype (``vcagan/nn/common.py:32``)."""

    def __init__(self, channels: int):
        super().__init__(channels, init=0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, rounded(LEAKY_SLOPE, x.dtype))


class LeakyReLU(nn.Module):
    """``leaky_relu`` as a layer (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


class _FlaxBatchNorm:
    """Train mode as flax's ``BatchNorm`` (``vcagan/nn/common.py:46-64``):
    normalise with the batch's mean and biased variance, and move the
    running variance with that same biased variance, where PyTorch's own
    moves it with the unbiased one.  Eval mode is PyTorch's.

    Under an active layout of more than one rank (``vcagan_torch.parallel``)
    the batch is the global one, as in the JAX package's sharded step: one
    differentiable all-reduce over the world of the per-channel [count,
    sum, sum of squares] in the statistics' dtype (fp32), and the variance
    E[x^2] - E[x]^2 (flax's ``use_fast_variance``).  The model ranks of a
    data index hold the same rows: their copies add to the counts as to
    the sums, so they cancel (and their gradients too), and every rank
    holds the same statistics.

    Inside a recompute (``recomputed``) the running statistics and
    ``num_batches_tracked`` stay where the forward moved them: train mode
    never reads them, so the output is the forward's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        layout = active_layout()
        if layout is not None and layout.world > 1:
            return self._global_forward(x, layout.group)
        if not _RECOMPUTING.get():
            with torch.no_grad():
                var, mean = torch.var_mean(x.to(self.running_mean.dtype),
                                           dim=[0, *range(2, x.dim())], correction=0)
                self._move_statistics(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _move_statistics(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        dims = [0, *range(2, x.dim())]
        xf = x.to(self.running_mean.dtype)
        count = xf.new_full((x.shape[1],), x.numel() // x.shape[1])
        stats = all_reduce_sum(torch.stack([count, xf.sum(dims), xf.square().sum(dims)]), group)
        mean = stats[1] / stats[0]
        var = torch.clamp(stats[2] / stats[0] - mean.square(), min=0.0)
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self._move_statistics(mean, var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * scale
        return (xf * scale.view(shape) + shift.view(shape)).to(x.dtype)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


def batch_norm(channels: int, dims: int = 2, folded: bool = False) -> nn.Module:
    """BatchNorm{1,2,3}d with the reference's eps and momentum.  In eval mode
    it is the running-statistics affine, computed in fp32 and given out in
    the input's dtype; in train mode it follows flax (``_FlaxBatchNorm``).
    ``folded``: the affine lives in the preceding convolution
    (``vcagan_torch/nn/fold.py``) and an ``nn.Identity`` keeps its place, so
    the names of the layers after it do not move."""
    if folded:
        return nn.Identity()
    cls = {1: BatchNorm1d, 2: BatchNorm2d, 3: BatchNorm3d}[dims]
    return cls(channels, eps=BN_EPS, momentum=0.1)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn from
    ``generator`` (required whenever a mask is drawn), at the global batch's
    shape under a layout of several data ranks (``draw_rows``; the leading
    axis is the batch's, or batch x time's)."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws its mask from an explicit generator")
    keep = draw_rows(lambda n: torch.empty((n, *x.shape[1:]), device=x.device).bernoulli_(
        1.0 - rate, generator=generator), x.shape[0])
    # flax divides by the keep probability, a constant rounded to x's dtype
    return torch.where(keep.bool(), x / rounded(1.0 - rate, x.dtype), 0.0)


class _Recompute:
    """The context of one checkpointed call's recomputes: the call's
    generator set to its state at the forward (and given back the state
    found), the layout that was active at the forward active again (the
    backward may run on another thread, where it is not), and BatchNorm
    told not to move its statistics a second time.  It is entered once for
    each recompute."""

    def __init__(self, site: str, generator: torch.Generator | None):
        self.site = site
        self.generator = generator
        self.state = None if generator is None else generator.get_state()
        self.layout = active_layout()

    def __enter__(self):
        RECOMPUTES[self.site] += 1
        if self.generator is not None:
            self.found = self.generator.get_state()
            self.generator.set_state(self.state)
        self.stack = contextlib.ExitStack()
        if self.layout is not None:
            self.stack.enter_context(self.layout.active())
        self.token = _RECOMPUTING.set(True)

    def __exit__(self, *exc) -> bool:
        _RECOMPUTING.reset(self.token)
        self.stack.close()
        if self.generator is not None:
            self.generator.set_state(self.found)
        return False


def recomputed(site: str, fn: Callable, *args, generator: torch.Generator | None = None):
    """``fn(*args)`` that keeps only its inputs and outputs for the backward:
    a backward that needs its activations runs it again first (the JAX
    package's ``jax.checkpoint`` / ``nn.remat``), through non-reentrant
    ``torch.utils.checkpoint``, which also works under ``create_graph``.

    What a recompute must not repeat: its dropout masks come from
    ``generator`` as at the forward, which is then left where the recompute
    found it, so the step draws on exactly as without the recompute
    (``checkpoint``'s ``preserve_rng_state`` keeps only the global RNGs);
    train-mode BatchNorm normalises without moving its statistics again;
    under a data layout its statistics' all-reduce runs again, on every
    rank at the same point of the same backward.  A recompute that does not
    give the forward's saved tensors back (shape, dtype, device) raises.
    ``RECOMPUTES[site]`` counts the recomputes."""
    ctx = _Recompute(site, generator)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=lambda: (contextlib.nullcontext(), ctx))


class _ComputeDtype:
    """A convolution whose input, weight and bias are cast to
    ``compute_dtype`` at the call; the parameters keep their own dtype.

    On the CPU a bf16 convolution runs in fp32 on the bf16-rounded operands
    and rounds its result to bf16, as XLA's CPU backend computes one (and as
    the card accumulates in fp32).  PyTorch's own CPU bf16 convolution
    differentiates twice wrongly once a map reaches 80 x 80: with it, the
    R1 penalty's gradient into the largest discriminator lay 6.7 times as
    far from fp32 as the JAX package's
    (``tests/test_torch_train_bf16.py::test_bf16_r1_gradient``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        operands = [x.to(dtype), self.weight.to(dtype),
                    None if self.bias is None else self.bias.to(dtype)]
        if dtype != torch.bfloat16 or x.device.type != "cpu":
            return self._conv_forward(*operands)
        return self._conv_forward(*(t if t is None else t.float() for t in operands)).to(dtype)


class Linear(nn.Linear):
    """A dense layer that computes in its parameters' dtype (fp32): a bf16
    input is cast up, as flax's ``nn.Dense`` with no ``dtype`` promotes its
    input to the fp32 kernel's type (the discriminators' heads and the sync
    critic's projection, ``vcagan/nn/discriminator.py:109, 126, 173``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Conv1d(_ComputeDtype, nn.Conv1d):
    pass


class Conv2d(_ComputeDtype, nn.Conv2d):
    pass


class Conv3d(_ComputeDtype, nn.Conv3d):
    pass


class FoldableModule(nn.Module):
    """A module with a ``fold_bn`` mode.  Folded weights carry frozen
    statistics, so a folded module refuses training mode; a subclass ends
    its ``__init__`` with ``self.eval()`` when folded."""

    def __init__(self, fold_bn: bool):
        super().__init__()
        self.fold_bn = fold_bn

    def train(self, mode: bool = True):
        if mode and self.fold_bn:
            raise RuntimeError("fold_bn is an eval-only mode")
        return super().train(mode)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initialiser (``nn.initializers.lecun_normal``):
    a normal truncated at +-2 of the unit normal, scaled so that its std is
    1 / sqrt(fan_in).  Fans are counted on the JAX kernel's layout, receptive
    field x in and receptive field x out, which are PyTorch's for an (out,
    in, k...) weight.  Drawn as ``jax.random.truncated_normal`` draws it, by
    the inverse of the normal's CDF on a uniform draw."""
    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(weight)
    scale = math.sqrt(1.0 / fan_in) / TRUNCATED_UNIT_STD
    edge = math.erf(2.0 / math.sqrt(2.0))  # the unit normal's +-2 as erf(x / sqrt(2))
    weight.uniform_(-edge, edge, generator=generator).erfinv_().mul_(math.sqrt(2.0) * scale)
    return weight.clamp_(-2.0 * scale, 2.0 * scale)


def he_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The ResNet convolutions' initialiser (``vcagan/nn/common.py:40-43``):
    an untruncated normal of std sqrt(2 / fan_out)."""
    _, fan_out = nn.init._calculate_fan_in_and_fan_out(weight)
    return weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def init_like_jax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every random leaf of ``module`` (on the CPU) from ``generator``
    with the distribution that the JAX package's counterpart gives it:
    - a convolution's or dense layer's kernel by its ``kernel_init``
      attribute where it has one (``he_normal_fan_out_``: every ResNet
      ``BasicBlock`` convolution, ``vcagan/nn/resnet.py:31, 96, 108, 123``),
      else ``lecun_normal_`` (flax's ``nn.Conv`` / ``nn.Dense`` default, and
      the stem, ``vcagan/nn/visual_front.py:40-43``);
    - every convolution and dense bias exactly 0 (the flax default,
      ``resnet.py:32``, ``visual_front.py:47-48``), the folded ones too;
    - the GRU's weights and biases U(+-1 / sqrt(hidden)), as PyTorch's own
      and ``vcagan/nn/gru.py:41-56`` draw them.
    BatchNorm and PReLU keep the constants they were built with.  A module
    that holds other parameters raises.  Modules that keep packed copies of
    their weights (``repack``) refresh them.  Returns ``module``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.GRU):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters(recurse=False):
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)):
                getattr(m, "kernel_init", lecun_normal_)(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif not isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.PReLU)) and next(
                    m.parameters(recurse=False), None) is not None:
                raise TypeError(f"init_like_jax: no rule for the parameters of {type(m).__name__}")
        for m in module.modules():
            if hasattr(m, "repack"):
                m.repack()
    return module
