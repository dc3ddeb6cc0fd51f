"""JAX train states into the port's ``GANTrainState``.

The JAX package checkpoints its whole train state with orbax
(``vcagan/io/checkpoint.py:48-83``): params, batch statistics, both optax
states and the step.  orbax imports jax, so the port does not read those
directories: ``tools/export_jax_train_state.py``, run beside the JAX
package, writes one as a flat ``.npz`` of flax-path leaves (``step``,
``g_params/<mod>/...``, ``d_params/<mod>/...``, ``batch_stats/<mod>/...``,
and ``g_opt`` / ``d_opt`` with ``count``, ``mu/...``, ``nu/...`` and under
AMSGrad ``nu_max/...``).  ``load_jax_train_state`` fills a port state
from it with numpy and torch alone:

- params and batch statistics through ``from_jax``;
- each optimizer's moments through the same per-leaf mapping (every one of
  ``vcagan_torch/io/weights.py``'s is a transpose or a row permutation, so
  a moment maps exactly as its parameter does), in the order of
  ``modules.parameters(GENERATOR_SIDE / DISCRIMINATOR_SIDE)``;
- ``AdamState.count`` the chain's count, ``step`` the JAX step.

A leaf that no module reads raises, as ``load_serving_npz`` does.
``restore_train_state`` is what the CLIs' ``--checkpoint`` calls: a port
checkpoint directory, such an ``.npz``, or an orbax directory, which it
refuses with the exporter's command.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from vcagan_torch.io.checkpoint import CheckpointManager, _load_opt_state
from vcagan_torch.io.weights import _leaf_paths, from_jax
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE
from vcagan_torch.train.state import GANTrainState

EXPORTER = ("python tools/export_jax_train_state.py --checkpoint <orbax_dir> --out state.npz "
            "[--recipe GRID|LRS2|LRS3] [--bf16]")
MOMENTS = ("mu", "nu", "nu_max")


def orbax_refusal(path: str) -> NotImplementedError:
    """The error for an orbax directory given where the port reads a
    checkpoint: it names the exporter's command."""
    return NotImplementedError(
        f"{path} is an orbax checkpoint of the JAX package, which the port does not read: "
        f"export it with `{EXPORTER}` (beside the JAX package) and pass the .npz")


def is_orbax(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))


def read_jax_train_state(path: str) -> Dict[str, Any]:
    """The exported ``.npz`` as nested dicts of numpy leaves by flax path."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


def _side_list(states, modules, names) -> list[torch.Tensor]:
    """The tensors of ``states`` in the order of ``modules.parameters(names)``."""
    return [states[name][key] for name in names
            for key, _ in getattr(modules, name).named_parameters()]


def _unmatched(what: str, trees: Dict[str, Any], read: set, kind: str) -> None:
    extra = sorted(set(_leaf_paths(trees, kind)) - read)
    if extra:
        more = " ..." if len(extra) > 5 else ""
        raise KeyError(f"{what} has unmatched leaves: {extra[:5]}{more}")


@torch.no_grad()
def load_jax_train_state(path: str, state: GANTrainState) -> GANTrainState:
    """Fill ``state`` (its modules' tensors, both optimizers' and the step)
    in place from an ``.npz`` of ``tools/export_jax_train_state.py``;
    returns ``state``."""
    tree = read_jax_train_state(path)
    params = {**tree["g_params"], **tree["d_params"]}
    stats = tree.get("batch_stats", {})
    read: set = set()
    states = from_jax(params, stats, read)
    _unmatched(path, params, read, "params")
    _unmatched(path, stats, read, "stats")
    if sorted(states) != sorted(GENERATOR_SIDE + DISCRIMINATOR_SIDE):
        raise KeyError(f"{path} holds the modules {sorted(states)}, not all seven")
    state.modules.load_state_dicts(states)

    g_opt, d_opt = tree["g_opt"], tree["d_opt"]
    moments = {}
    for name in MOMENTS:
        if (name in g_opt) != (name in d_opt):
            raise KeyError(f"{path}: {name} in one optimizer only")
        if name not in g_opt:
            moments[name] = None
            continue
        read = set()
        moment_tree = {**g_opt[name], **d_opt[name]}
        moments[name] = from_jax(moment_tree, stats, read)
        _unmatched(f"{path} ({name})", moment_tree, read, "params")
    device = next(iter(state.modules.v_front.parameters())).device
    for opt_state, opt, names in ((state.g_opt_state, g_opt, GENERATOR_SIDE),
                                  (state.d_opt_state, d_opt, DISCRIMINATOR_SIDE)):
        saved = {name: None if moments[name] is None else
                 [t.to(device) for t in _side_list(moments[name], state.modules, names)]
                 for name in MOMENTS}
        _load_opt_state(opt_state, {**saved, "count": opt["count"]})
    state.step = int(tree["step"])
    return state


def restore_train_state(state: GANTrainState, path: str,
                        generator: Optional[torch.Generator] = None) -> GANTrainState:
    """``--checkpoint`` of the CLIs: an ``.npz`` exported from a JAX train
    state (``load_jax_train_state``; the generator keeps its seed), else one
    of the port's checkpoint directories (with the run's generator); an
    orbax directory raises ``orbax_refusal``."""
    if is_orbax(path):
        raise orbax_refusal(path)
    if path.endswith(".npz"):
        return load_jax_train_state(path, state)
    return CheckpointManager(os.path.dirname(path) or ".").restore(state, path,
                                                                   generator=generator)
