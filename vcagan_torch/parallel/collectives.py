"""The collectives of the parallel step.

The data axis (each over a layout's data group):

- ``all_reduce_sum``: a sum over the ranks that autograd differentiates
  (its backward sums the incoming gradient over the ranks), for the global
  BatchNorm statistics.  ``torch.distributed.nn.functional.all_reduce``
  does this too, but warns that it is deprecated, and its replacement in
  ``torch.distributed._functional_collectives`` has no autograd.
- ``all_reduce_mean_``: the gradients' mean over the ranks, coalesced into
  fp32 buckets, one call a bucket, written back into the tensors.
- ``mean_metrics``: a dict of 0-dim tensors averaged over the ranks in one
  call.

The model axis (each over a layout's model group), around a product whose
weight's output columns are split over the group
(``vcagan_torch/nn/attention.py``):

- ``copy_to_model``: the product's input, the same on every model rank.
  Identity forward; its backward sums over the group, since each rank's
  input gradient is only its columns' part, ``dy_slice @ W_slice``.
- ``gather_columns``: the product's output columns, gathered in model-rank
  order.  Its backward keeps this rank's columns of the incoming gradient
  and sums nothing: the work after the gather is the same on every model
  rank, so each already holds the whole gradient (a reduce-scatter would
  multiply it by the group's size).

Each runs inside a span (``vcagan_torch.tracing``) named ``model_axis.*`` or
``data_axis.*``, whose range a profile of the step reads where tracing is
on.

The step takes its gradients with ``torch.autograd.grad`` into lists and
R1 differentiates twice, so ``DistributedDataParallel``'s hooks on
``.grad`` do not apply.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from vcagan_torch.tracing import span

BUCKET_BYTES = 64 << 20  # fp32 bytes a gradient all-reduce call


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name):
        ctx.group, ctx.name = group, name
        out = x.clone(memory_format=torch.contiguous_format)
        with span(name):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # each rank's loss reads the sum, so its gradient is the sum of theirs
        return _AllReduceSum.apply(grad, ctx.group, ctx.name), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group, "data_axis.all_reduce_sum")


def _bucket_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> int:
    """Replace each tensor of ``tensors`` (in place) by its mean over the
    ranks: the tensors are flattened in order into fp32 buckets (float64
    ones for float64 tensors) of up to ``BUCKET_BYTES``, one all-reduce a
    bucket.  Returns the bytes reduced."""
    world = dist.get_world_size(group)
    total = 0
    bucket: List[torch.Tensor] = []
    size = 0

    def reduce(items):
        flat = torch.cat([t.reshape(-1).to(_bucket_dtype(t)) for t in items])
        with span("data_axis.gradient_mean"):
            dist.all_reduce(flat, group=group)
        flat.div_(world)
        for t, part in zip(items, flat.split([t.numel() for t in items])):
            t.copy_(part.view_as(t))
        return flat.numel() * flat.element_size()

    for t in tensors:
        nbytes = t.numel() * _bucket_dtype(t).itemsize
        if bucket and size + nbytes > BUCKET_BYTES:
            total += reduce(bucket)
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        total += reduce(bucket)
    return total


def mean_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each 0-dim metric averaged over the ranks, in one all-reduce."""
    keys = list(metrics)
    stacked = torch.stack([metrics[k] for k in keys])
    dist.all_reduce(stacked, group=group)
    stacked.div_(dist.get_world_size(group))
    return dict(zip(keys, stacked.unbind()))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group, "model_axis.input_gradient_sum"), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, the input of a product whose columns are split over the model
    group ``group``; its gradient is summed over the group."""
    return _CopyToModel.apply(x, group)


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(ctx.size)]
        with span("model_axis.gather_columns"):
            dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """The last dimension of ``x`` gathered over the model group ``group``
    in rank order; its gradient is this rank's columns of the output's."""
    return _GatherColumns.apply(x, group)
