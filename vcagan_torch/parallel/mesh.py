"""The data-parallel layout: ranks, devices and the draws of the global batch.

Port of the data axis of ``vcagan/parallel/mesh.py:35-112``.  The JAX
package declares a (data, model) device mesh and lets GSPMD insert the
collectives; here each process drives one device and holds a full replica
of the state, the batch is split over the ranks of one process group, and
the step reduces what the sharded JAX step reduces:

- the gradients, a mean over the ranks (``collectives.all_reduce_mean_``);
- the BatchNorm statistics in train mode, over the global batch
  (``vcagan_torch/nn/common.py``), as flax's BatchNorm reduces over the
  whole sharded batch axis;
- the metrics, a mean over the ranks.

Randomness does not depend on the world size: a draw whose leading axis is
the batch (dropout masks, the decoder's noise, the input pipeline's augment
draws) is made at the global batch's shape from the same seeded generator
on every rank, and the rank keeps its own rows (``draw_rows``).  So N ranks
compute one process's step on the concatenated batch, up to reassociation,
as the JAX sharded step does with dropout on.  The layout is consulted
while it is ``active()``: the train step and the Trainer's input pipeline
activate it.

The model axis (``model_parallel`` > 1: the four column-sharded attention
projections of ``vcagan/parallel/mesh.py:60-75``) is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from vcagan_torch.configs import MODEL_AXIS_ITEM
from vcagan_torch.parallel.multihost import batch_rows, local_rank
from vcagan_torch.runtime import resolve_device

_ACTIVE: contextvars.ContextVar[Optional["DataLayout"]] = contextvars.ContextVar(
    "vcagan_torch_data_layout", default=None)


@dataclasses.dataclass(frozen=True)
class DataLayout:
    """``world`` ranks of the process group ``group`` (None: one process,
    no group), this process's ``rank`` and its ``device``."""

    world: int
    rank: int
    device: torch.device
    group: Any = None

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch``."""
        return batch_rows(global_batch, self.world, self.rank)

    @contextlib.contextmanager
    def active(self):
        """Make this the layout that BatchNorm and the draws consult."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)


def make_layout(model_parallel: int = 1, batch_size: Optional[int] = None,
                device=None) -> DataLayout:
    """The layout of this process: the default process group's world and
    rank where one is initialised (``initialize_distributed``), else one
    process.  The device: ``device`` where given, else the rank's card,
    ``cuda:LOCAL_RANK`` (``resolve_device``: raises without CUDA).

    ``model_parallel`` > 1 raises (the model axis is not ported).  The JAX
    Trainer quietly runs on the largest subset of devices that divides the
    batch (``vcagan/train/loop.py:70-77``); a process group cannot leave
    ranks idle, so a world that does not divide ``batch_size`` raises."""
    if model_parallel != 1:
        raise ValueError(f"model_parallel={model_parallel} is not ported: {MODEL_AXIS_ITEM}")
    if dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if batch_size is not None and batch_size % world:
        raise ValueError(
            f"train.batch_size {batch_size} is not divisible by the world size {world}; "
            f"the JAX Trainer would run on gcd = {math.gcd(batch_size, world)} devices, a "
            "process group cannot leave ranks idle: use a world that divides the batch")
    dev = resolve_device(device)
    if device is None:
        dev = torch.device("cuda", local_rank())
    return DataLayout(world, rank, dev, group)


def active_layout() -> Optional[DataLayout]:
    """The layout the running step or pipeline has activated, if any."""
    return _ACTIVE.get()


def draw_rows(draw: Callable[[int], Any], rows: int) -> Any:
    """``draw(rows)``: a tensor, or a tuple of tensors, with ``rows`` rows.
    Under an active layout of N > 1 ranks it is ``draw(N * rows)`` with this
    rank's rows kept, so every rank's generator advances as one process's
    does on the global batch, and the ranks' rows concatenate to that
    process's draw.  Otherwise it is ``draw(rows)``, unchanged."""
    layout = active_layout()
    if layout is None or layout.world == 1:
        return draw(rows)
    out = draw(rows * layout.world)
    keep = slice(layout.rank * rows, (layout.rank + 1) * rows)
    if isinstance(out, tuple):
        kept = [t[keep] for t in out]
        return type(out)(*kept) if hasattr(out, "_fields") else tuple(kept)
    return out[keep]
