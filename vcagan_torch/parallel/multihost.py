"""Process-group initialisation and the per-rank slice of the global batch.

Port of ``vcagan/parallel/multihost.py:24-69``.  One process drives one
device, as ``torchrun`` starts them:

- ``initialize_distributed`` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or the
  JAX package's names for the same things (``COORDINATOR_ADDRESS``,
  ``NUM_PROCESSES``, ``PROCESS_ID``), or explicit arguments, and joins the
  default process group: NCCL on the card, gloo where the caller asks for it
  (the CPU).  A single-process run is left as it is.
- ``local_batch_slice`` is the rank's half-open share of the global batch,
  which the feed decodes (``epoch(..., process_slice=...)``).

``globalize`` has no counterpart: the JAX package assembles one global
array from the hosts' slices, while here each rank keeps its own rows and
the step reduces the gradients (``vcagan_torch/parallel/collectives.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# Long enough for rank 0's validation, checkpoint and media, which the
# other ranks wait out at the next collective.
GROUP_TIMEOUT = datetime.timedelta(minutes=60)


def _env_int(*names: str, default: int) -> int:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def local_rank() -> int:
    """The rank's device index on its host (torchrun's ``LOCAL_RANK``; 0
    where it is not set)."""
    return _env_int("LOCAL_RANK", default=0)


def local_device() -> torch.device:
    """The rank's card: ``cuda:LOCAL_RANK``, wrapped round the host's cards
    where gloo ranks share them (``VCAGAN_DIST_BACKEND=gloo``; NCCL refuses
    two ranks on one card)."""
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(), 1))


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Join the default process group when the run has more than one
    process; returns False and does nothing in a single-process run, as the
    JAX function does.

    ``backend``: "nccl" (the default; the rank's card is made current
    first, ``local_device``) or "gloo" (the CPU, or ranks that share a
    card); where it is not given, the environment's ``VCAGAN_DIST_BACKEND``
    names it.  ``init_method``
    defaults to ``tcp://MASTER_ADDR:MASTER_PORT``, else
    ``tcp://COORDINATOR_ADDRESS``."""
    if dist.is_initialized():
        return True
    world = world_size if world_size is not None else _env_int(
        "WORLD_SIZE", "NUM_PROCESSES", default=0)
    rank = rank if rank is not None else _env_int("RANK", "PROCESS_ID", default=-1)
    if init_method is None:
        env = os.environ
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif env.get("COORDINATOR_ADDRESS"):
            init_method = f"tcp://{env['COORDINATOR_ADDRESS']}"
    if not init_method or world <= 1 or rank < 0:
        return False
    backend = backend or os.environ.get("VCAGAN_DIST_BACKEND") or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    return True


def batch_rows(global_batch_size: int, world: int, rank: int) -> slice:
    """The half-open [start, stop) of the global batch that ``rank`` of
    ``world`` feeds."""
    if global_batch_size % world != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {world} processes"
        )
    per = global_batch_size // world
    return slice(rank * per, (rank + 1) * per)


def local_batch_slice(global_batch_size: int) -> slice:
    """The half-open [start, stop) of the global batch this rank feeds."""
    if not dist.is_initialized():
        return batch_rows(global_batch_size, 1, 0)
    return batch_rows(global_batch_size, dist.get_world_size(), dist.get_rank())
