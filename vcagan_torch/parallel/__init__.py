"""Parallel training over processes, one device each: the port of
``vcagan/parallel/``, its data axis and its model axis.  ``shard`` (the
model axis's split of the attention projections) and ``dryrun`` (the
equivalence gate) import the training package and are imported on their
own."""

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
