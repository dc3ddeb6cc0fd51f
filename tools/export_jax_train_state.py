"""Export a JAX package's orbax checkpoint to an ``.npz`` that the PyTorch
port (``vcagan_torch``) reads.

Reading an orbax directory needs orbax (which imports jax) or tensorstore;
the port imports neither, so the conversion runs here, beside the JAX
package that wrote the checkpoint.

    # a train state saved by vcagan.io.checkpoint.CheckpointManager
    python tools/export_jax_train_state.py --checkpoint <ckpt_dir>/Epoch_0003_... \\
        --out state.npz [--recipe GRID|LRS2|LRS3] [--bf16]
    # the variables of an ASR model (vcagan/cli/asr_grid.py, asr_lrw.py)
    python tools/export_jax_train_state.py --asr --checkpoint <orbax_dir> --out variables.npz

A train state: the template is ``vcagan.train.create_train_state`` for the
recipe (abstract, by ``jax.eval_shape``), the state is restored with
``CheckpointManager.restore`` and written as one flat ``.npz`` of flax-path
leaves: ``step``, ``g_params/<mod>/...``, ``d_params/<mod>/...``,
``batch_stats/<mod>/...`` and, for each of ``g_opt`` and ``d_opt``, its
``count`` and ``mu/<mod>/...``, ``nu/<mod>/...`` and (AMSGrad, the GRID
recipe) ``nu_max/<mod>/...``.  The optax chain keeps two counts, the
moments' and the learning-rate schedule's; they must agree.  The port
loads the file with ``vcagan_torch.io.jax_state.load_jax_train_state``,
and its CLIs take it as ``--checkpoint``.

An ASR model's variables: restored without a template and written as the
``variables`` entry that ``python -m vcagan.cli.asr_grid --checkpoint``
and the port's ``load_asr`` read.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _key(prefix: str, key_path) -> str:
    return prefix + "".join(
        f"/{getattr(k, 'key', getattr(k, 'idx', getattr(k, 'name', k)))}" for k in key_path)


def _flatten(prefix: str, tree, out: Dict[str, np.ndarray]) -> None:
    import jax

    for key_path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[_key(prefix, key_path)] = np.asarray(leaf)


def recipe_config(recipe: str = "GRID", bf16: bool = False):
    """The JAX package's training recipe: GRID, LRS2 or LRS3."""
    from vcagan.configs import grid_config, lrs_config

    overrides = {"model.use_bfloat16": bf16}
    return grid_config(**overrides) if recipe == "GRID" else lrs_config(recipe, **overrides)


def template(config):
    """The abstract train state of ``config``'s recipe (shapes and dtypes)."""
    import jax

    from vcagan.train import VCAGANModules, create_train_state

    modules = VCAGANModules.create(config.model)
    return jax.eval_shape(
        lambda: create_train_state(jax.random.PRNGKey(0), modules, config.train)[0])


def opt_leaves(prefix: str, opt_state, out: Dict[str, np.ndarray]) -> None:
    """The optax chain's moments and count under ``prefix``; raises unless the
    moments' count equals the schedule's."""
    import optax

    moments = [s for s in opt_state
               if isinstance(s, (optax.ScaleByAdamState, optax.ScaleByAmsgradState))]
    schedules = [s for s in opt_state if isinstance(s, optax.ScaleByScheduleState)]
    if len(moments) != 1 or len(schedules) != 1:
        raise ValueError(f"{prefix}: not the recipe's optax chain: {opt_state}")
    m, sched = moments[0], schedules[0]
    if int(m.count) != int(sched.count):
        raise ValueError(f"{prefix}: the moments' count {int(m.count)} and the schedule's "
                         f"{int(sched.count)} differ")
    out[f"{prefix}/count"] = np.asarray(m.count)
    names = ("mu", "nu", "nu_max") if isinstance(m, optax.ScaleByAmsgradState) else ("mu", "nu")
    for name in names:
        _flatten(f"{prefix}/{name}", getattr(m, name), out)


def export_train_state(checkpoint: str, out: str, config) -> Dict[str, np.ndarray]:
    """Restore the train state at ``checkpoint`` (an orbax directory written
    by ``vcagan.io.checkpoint.CheckpointManager``) in the structure of
    ``config``'s recipe and write it to ``out``.  Returns the leaves."""
    from vcagan.io.checkpoint import CheckpointManager

    checkpoint = os.path.abspath(checkpoint)
    state = CheckpointManager(os.path.dirname(checkpoint)).restore(template(config), checkpoint)
    leaves: Dict[str, np.ndarray] = {"step": np.asarray(state.step)}
    for prefix, tree in (("g_params", state.g_params), ("d_params", state.d_params),
                         ("batch_stats", state.batch_stats)):
        _flatten(prefix, tree, leaves)
    opt_leaves("g_opt", state.g_opt_state, leaves)
    opt_leaves("d_opt", state.d_opt_state, leaves)
    np.savez(out, **leaves)
    return leaves


def export_asr_variables(checkpoint: str, out: str) -> None:
    """An ASR model's orbax variables as the ``variables`` npz entry."""
    import jax
    import orbax.checkpoint as ocp

    variables = ocp.StandardCheckpointer().restore(os.path.abspath(checkpoint))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    np.savez(out, variables=np.asarray(variables, dtype=object))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="the orbax checkpoint directory")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--recipe", default="GRID", choices=("GRID", "LRS2", "LRS3"))
    p.add_argument("--bf16", action="store_true", help="the state of a --bf16 run")
    p.add_argument("--asr", action="store_true", help="an ASR model's variables")
    args = p.parse_args(argv)
    if args.asr:
        export_asr_variables(args.checkpoint, args.out)
    else:
        leaves = export_train_state(args.checkpoint, args.out,
                                    recipe_config(args.recipe, args.bf16))
        print(f"{args.out}: step {int(leaves['step'])}, {len(leaves)} leaves")


if __name__ == "__main__":
    main()
