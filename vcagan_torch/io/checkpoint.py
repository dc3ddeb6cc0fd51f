"""Checkpoints with the reference's metric-named best-pointer semantics.

Port of ``vcagan/io/checkpoint.py:25-95``.  The reference torch.saves the
seven state_dicts into files named
``Epoch_%04d_stoi_%.3f_estoi_%.3f_pesq_%.3f.ckpt`` and keeps one
``Best_*.ckpt``, deleting the one before (reference: train.py:303-322); it
does not save the optimizers.  Here each checkpoint is a directory of that
name (as the JAX package's orbax checkpoints are) holding one ``torch.save``
of the whole train state: every module's state dict, both optimizers'
states and the step, and the state of the run's ``torch.Generator`` where
one is given.  A restore gives back all of it bit for bit, so the steps
after it draw what the run would have drawn.  The data's position (the
epoch's shuffle and window draws) is not saved: a resumed run starts a new
epoch (``--start_epoch``), as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import shutil
from typing import Optional

import torch

from vcagan_torch.train.state import AdamState, GANTrainState

STATE_FILE = "train_state.pt"


def _opt_state(state: AdamState) -> dict:
    return {field.name: getattr(state, field.name) for field in dataclasses.fields(state)}


@torch.no_grad()
def _load_opt_state(state: AdamState, saved: dict) -> None:
    """Copy a saved optimizer state into ``state``'s tensors in place."""
    if (saved["nu_max"] is None) != (state.nu_max is None):
        raise ValueError("the checkpoint's optimizer and this one differ in AMSGrad")
    for name in ("mu", "nu", "nu_max"):
        mine, theirs = getattr(state, name), saved[name]
        if mine is None:
            continue
        if len(mine) != len(theirs):
            raise ValueError(f"optimizer {name}: {len(theirs)} tensors saved, {len(mine)} here")
        torch._foreach_copy_(mine, theirs)
    state.count = int(saved["count"])


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric = self._scan_best()

    # -------------------------------------------------------------- naming

    @staticmethod
    def _name(epoch: int, stoi: float, estoi: float, pesq: float) -> str:
        return f"Epoch_{epoch:04d}_stoi_{stoi:.3f}_estoi_{estoi:.3f}_pesq_{pesq:.3f}"

    def _scan_best(self) -> float:
        best = 0.0
        for path in glob.glob(os.path.join(self.directory, "Best_*")):
            m = re.search(r"stoi_([0-9.]+)_", os.path.basename(path))
            if m:
                best = max(best, float(m.group(1).rstrip(".")))
        return best

    # ---------------------------------------------------------------- save

    def save(self, state: GANTrainState, epoch: int, stoi: float = 0.0, estoi: float = 0.0,
             pesq: float = 0.0, generator: Optional[torch.Generator] = None) -> str:
        """Save a checkpoint (with ``generator``'s state where given);
        replace Best_* when STOI improves (the reference's best-by-STOI,
        train.py:311-322).  Returns its path."""
        name = self._name(epoch, stoi, estoi, pesq)
        path = os.path.join(self.directory, name)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save({
            "step": state.step,
            "modules": state.modules.state_dicts(),
            "g_opt_state": _opt_state(state.g_opt_state),
            "d_opt_state": _opt_state(state.d_opt_state),
            "generator": None if generator is None else generator.get_state(),
        }, os.path.join(path, STATE_FILE))

        if stoi > self.best_metric:
            self.best_metric = stoi
            for prev in glob.glob(os.path.join(self.directory, "Best_*")):
                shutil.rmtree(prev, ignore_errors=True)
            # hard links: Best_* outlives its Epoch_* directory without a
            # second copy of the state on disk
            shutil.copytree(path, os.path.join(self.directory, "Best_" + name),
                            copy_function=os.link)
        return path

    # ---------------------------------------------------------------- load

    def restore(self, state: GANTrainState, path: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> GANTrainState:
        """Load a checkpoint into ``state`` in place (its modules' tensors,
        both optimizers' and the step), and into ``generator`` the state
        saved with it, and return ``state``.  Without ``path``, the latest
        epoch's."""
        if path is None:
            path = self.latest()
            if path is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(iter(state.modules.v_front.parameters())).device
        saved = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                           weights_only=True)
        state.modules.load_state_dicts(saved["modules"])
        _load_opt_state(state.g_opt_state, saved["g_opt_state"])
        _load_opt_state(state.d_opt_state, saved["d_opt_state"])
        state.step = int(saved["step"])
        if generator is not None:
            if saved["generator"] is None:
                raise ValueError(f"{path} holds no generator state")
            generator.set_state(saved["generator"].cpu())
        return state

    def latest(self) -> Optional[str]:
        epochs = []
        for path in glob.glob(os.path.join(self.directory, "Epoch_*")):
            m = re.match(r"Epoch_(\d+)_", os.path.basename(path))
            if m:
                epochs.append((int(m.group(1)), path))
        return max(epochs)[1] if epochs else None

    def best(self) -> Optional[str]:
        paths = glob.glob(os.path.join(self.directory, "Best_*"))
        return paths[0] if paths else None
