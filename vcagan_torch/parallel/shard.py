"""The model axis's split of the parameters and optimizer states.

Port of ``_MODEL_SHARDED``, ``_param_spec`` and ``state_shardings``
(``vcagan/parallel/mesh.py:61-107``).  Where ``model_parallel`` > 1, a 2-D
leaf whose flax path holds ``att1/q``, ``att2/q``, ``att1/mel`` or
``att2/mel`` and ends in ``kernel`` is split along its output columns over
the model group, where that width divides by ``model_parallel``; every
other leaf, the biases among them, is replicated.  The optimizer's moments
of a split leaf are split the same way (Adam and weight decay are
elementwise).  A torch ``Linear.weight`` is (out, in), the transpose of
flax's kernel, so JAX's axis 1 is the port's axis 0.  (The converter's
permutation of ``q``'s input rows, ``tools/convert_torch_ckpt.py:205-214``,
is on the other axis.)

``ModelSplit`` keeps this rank's slices: ``split_`` cuts a freshly seeded
full module (``VCAGANModules.create(seed=...)`` on every rank, so the
slices are one process's initial weights), and ``full`` gathers the whole
leaves and moments over the model group for work that needs them (rank 0's
validation and checkpoints, a ``--checkpoint`` restore of a port
checkpoint or a JAX train state, ``save_serving_npz`` of the state
dicts), then cuts them again.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from vcagan_torch.parallel.mesh import DataLayout
from vcagan_torch.train.models import GENERATOR_SIDE

# vcagan/parallel/mesh.py:75-80
SPLIT_SCOPES = ("att1/q", "att2/q", "att1/mel", "att2/mel")


def jax_path(module: str, key: str) -> str:
    """The flax path of a dense layer's parameter: ``("gen",
    "att1.q.weight")`` -> ``"gen/att1/q/kernel"``.  Exact for the port's
    ``Linear`` layers; other layers keep the port's own names, which the
    split rule does not match."""
    *scope, leaf = key.split(".")
    return "/".join([module, *scope, "kernel" if leaf == "weight" else leaf])


def split_axis(path: str, shape: Sequence[int], model_parallel: int) -> Optional[int]:
    """``_param_spec``'s rule for a port parameter of full ``shape`` at
    ``path`` (``jax_path``): the port axis its columns are split along (0),
    or None where it is replicated."""
    if (model_parallel > 1 and len(shape) == 2 and path.endswith("kernel")
            and any(scope in path for scope in SPLIT_SCOPES)
            and shape[0] % model_parallel == 0):
        return 0
    return None


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A split weight: the module's name (``"gen"``), the parameter's key
    (``"att1.q.weight"``) and its ``Linear``."""

    module: str
    key: str
    linear: nn.Linear


def split_leaves(modules, model_parallel: int) -> List[Leaf]:
    """The weights of ``modules`` (a ``VCAGANModules``) that the model axis
    splits at ``model_parallel``, judged on their full widths."""
    leaves = []
    for name, module in modules.named():
        for sub_name, sub in module.named_modules():
            key = f"{sub_name}.weight"
            if isinstance(sub, nn.Linear) and split_axis(
                    jax_path(name, key), (sub.out_features, sub.in_features),
                    model_parallel) is not None:
                leaves.append(Leaf(name, key, sub))
    return leaves


class ModelSplit:
    """This rank's share of the split leaves of a train state under
    ``layout`` (nothing is split where ``layout.model`` is 1)."""

    def __init__(self, modules, layout: DataLayout):
        self.layout = layout
        self.leaves = split_leaves(modules, layout.model)
        g_params = modules.parameters(GENERATOR_SIDE)  # the G optimizer's order
        self.index = [next(i for i, p in enumerate(g_params) if p is leaf.linear.weight)
                      for leaf in self.leaves]

    def _slice(self, t: torch.Tensor) -> torch.Tensor:
        return t.chunk(self.layout.model, dim=0)[self.layout.model_rank].clone()

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.layout.model)]
        dist.all_gather(parts, t.contiguous(), group=self.layout.model_group)
        return torch.cat(parts, dim=0)

    def _apply(self, fn: Callable[[torch.Tensor], torch.Tensor], state=None) -> None:
        for leaf, i in zip(self.leaves, self.index):
            weight = leaf.linear.weight
            weight.data = fn(weight.data)
            if state is None:
                continue
            for name in ("mu", "nu", "nu_max"):
                moments = getattr(state.g_opt_state, name)
                if moments is not None:
                    moments[i] = fn(moments[i])

    @torch.no_grad()
    def split_(self) -> None:
        """Keep this rank's columns of each full split weight (before
        ``create_train_state``, which then builds the moments on the
        slices)."""
        self._apply(self._slice)

    @contextlib.contextmanager
    def full(self, state):
        """The split weights and their moments of ``state`` whole while the
        block runs (an all-gather over the model group: every rank enters),
        then this rank's columns of whatever they hold at its end (a
        checkpoint restored inside is split)."""
        if not self.leaves:
            yield state
            return
        with torch.no_grad():
            self._apply(self._gather, state)
        try:
            yield state
        finally:
            with torch.no_grad():
                self._apply(self._slice, state)
