"""Data-parallel training over processes, one device each: the port of
``vcagan/parallel/`` (its data axis).  ``dryrun`` (the equivalence gate)
imports the training package and is imported on its own."""

from vcagan_torch.parallel.collectives import all_reduce_mean_, all_reduce_sum, mean_metrics
from vcagan_torch.parallel.mesh import DataLayout, active_layout, draw_rows, make_layout
from vcagan_torch.parallel.multihost import initialize_distributed, local_batch_slice

__all__ = [
    "DataLayout",
    "active_layout",
    "all_reduce_mean_",
    "all_reduce_sum",
    "draw_rows",
    "initialize_distributed",
    "local_batch_slice",
    "make_layout",
    "mean_metrics",
]
