"""The process layout: ranks, devices, the (data, model) groups and the
draws of the global batch.

Port of ``vcagan/parallel/mesh.py:35-112``.  The JAX package declares a
(data, model) device mesh and lets GSPMD insert the collectives; here each
process drives one device.  The world of D x M ranks is laid out as
``make_mesh`` lays out devices, row-major: rank ``r`` has data index
``r // M`` and model index ``r % M``.  The ranks of one data index form a
model group, the ranks of one model index a data group.

- The batch is split over the data axis and replicated over the model
  axis: every model rank of a data group holds the same rows.
- The parameters are replicated, except the four attention projections of
  ``vcagan/parallel/mesh.py:60-75``, whose output columns are split over
  the model group (``vcagan_torch/parallel/shard.py``).
- The step reduces what the sharded JAX step reduces: the gradients, a
  mean over the data axis (``collectives.all_reduce_mean_``); the
  BatchNorm statistics in train mode, over the global batch
  (``vcagan_torch/nn/common.py``), as flax's BatchNorm reduces over the
  whole sharded batch axis; the metrics, a mean over the data axis.  Only
  the split leaves' gradients reduce over the data group; the rest reduce
  over the world, where the M model copies of each data index's share add
  up and divide out (the counts of the BatchNorm statistics count them
  too): the same mean in exact arithmetic, and the same bits on every
  rank where the copies differ in their last bits, as the card's backward
  convolutions make them (``vcagan_torch/train/step.py``).

Randomness does not depend on the layout: a draw whose leading axis is the
batch (dropout masks, the decoder's noise, the input pipeline's augment
draws) is made at the global batch's shape from the same seeded generator
on every rank, and the rank keeps its data index's rows (``draw_rows``).
So D x M ranks compute one process's step on the concatenated batch, up to
reassociation, as the JAX sharded step does with dropout on.  The layout is
consulted while it is ``active()``: the train step and the Trainer's input
pipeline activate it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from vcagan_torch.parallel.multihost import batch_rows, local_device
from vcagan_torch.runtime import resolve_device

_ACTIVE: contextvars.ContextVar[Optional["DataLayout"]] = contextvars.ContextVar(
    "vcagan_torch_data_layout", default=None)


@dataclasses.dataclass(frozen=True)
class DataLayout:
    """``world`` ranks of the process group ``group`` (None: one process,
    no group), this process's ``rank`` and its ``device``; ``model`` ranks
    a model group.  ``data_group``: the ranks of this rank's model index
    (the world's group where ``model`` is 1); ``model_group``: the ranks
    of its data index (None where ``model`` is 1)."""

    world: int
    rank: int
    device: torch.device
    group: Any = None
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        if self.model == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def data(self) -> int:
        """Ranks a data group: the data axis's size."""
        return self.world // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch``: its data
        index's share."""
        return batch_rows(global_batch, self.data, self.data_rank)

    @contextlib.contextmanager
    def active(self):
        """Make this the layout that BatchNorm, the draws and the split
        attention projections consult."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)


def _groups(world: int, rank: int, model: int) -> tuple[Any, Any]:
    """(data group, model group) of ``rank``.  Every rank creates every
    group, in the same order, as ``torch.distributed.new_group`` requires:
    the model groups (one a data index), then the data groups (one a model
    index)."""
    data = world // model
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    return data_groups[rank % model], model_groups[rank // model]


def make_layout(model_parallel: int = 1, batch_size: Optional[int] = None,
                device=None) -> DataLayout:
    """The layout of this process: the default process group's world and
    rank where one is initialised (``initialize_distributed``), else one
    process, with ``model_parallel`` ranks a model group.  The device:
    ``device`` where given, else the rank's card (``local_device``;
    ``resolve_device``: raises without CUDA).

    Raises where ``model_parallel`` does not divide the world (as
    ``make_mesh`` does with the devices) and where the data size does not
    divide ``batch_size``: the JAX Trainer quietly runs on the largest
    subset of devices that divides the batch (``vcagan/train/loop.py:70-78``),
    a process group cannot leave ranks idle."""
    if dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    data = world // model_parallel
    if batch_size is not None and batch_size % data:
        raise ValueError(
            f"train.batch_size {batch_size} is not divisible by the data size {data}: "
            f"model_parallel {model_parallel} of world size {world}; the JAX Trainer would run "
            f"on gcd = {math.gcd(batch_size, data)} x {model_parallel} devices, a process group "
            "cannot leave ranks idle: use a world that divides the batch")
    dev = resolve_device(device)
    if device is None:
        dev = local_device()
    if model_parallel == 1:
        return DataLayout(world, rank, dev, group)
    data_group, model_group = _groups(world, rank, model_parallel)
    return DataLayout(world, rank, dev, group, model_parallel, data_group, model_group)


def active_layout() -> Optional[DataLayout]:
    """The layout the running step or pipeline has activated, if any."""
    return _ACTIVE.get()


def draw_rows(draw: Callable[[int], Any], rows: int) -> Any:
    """``draw(rows)``: a tensor, or a tuple of tensors, with ``rows`` rows.
    Under an active layout of N > 1 data ranks it is ``draw(N * rows)`` with
    this rank's data index's rows kept, so every rank's generator advances as
    one process's does on the global batch, and the data ranks' rows
    concatenate to that process's draw.  Otherwise it is ``draw(rows)``, unchanged."""
    layout = active_layout()
    if layout is None or layout.data == 1:
        return draw(rows)
    out = draw(rows * layout.data)
    keep = slice(layout.data_rank * rows, (layout.data_rank + 1) * rows)
    if isinstance(out, tuple):
        kept = [t[keep] for t in out]
        return type(out)(*kept) if hasattr(out, "_fields") else tuple(kept)
    return out[keep]
