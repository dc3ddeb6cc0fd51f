"""ASR evaluation models: the GRID character recognizer and the LRW word
classifier, in eval mode only.

Port of ``vcagan/eval/asr_models.py`` (reference evaluation stacks,
SURVEY.md §2.5):
- GRID: ``AudioFront`` 32/64 channels, k = 5, PReLU block -> 256-d a step
  (ASR_model/GRID/src/models/audio_front.py:11-25), 2-layer biGRU(256) +
  Linear(512 -> 28) over 27 characters and the blank (classifier.py:3-16);
  greedy decoding and WER/CER in ``vcagan_torch.eval.text``.
- LRW: ``AudioFront`` 128/256 channels, k = 3, ReLU block -> 512-d,
  2-layer biGRU(512), the mean over time, Linear(1024 -> 500)
  (ASR_model/LRW/src/models/classifier.py:4-24).

Each model is a ``front`` (the reference's ``Audio_front`` state dict:
``frontend.0-5``, ``Res_block.0``, ``Linear``) and a ``back`` (its
``Backend``: ``gru.*``, ``fc.*``), so the reference checkpoints' two state
dicts load as they are.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vcagan_torch.io.weights import asr_from_jax
from vcagan_torch.nn.audio_front import AudioFront
from vcagan_torch.nn.common import Linear, init_like_jax
from vcagan_torch.nn.gru import BiGRU
from vcagan_torch.runtime import resolve_device, use_full_fp32

StateDict = Dict[str, torch.Tensor]


class Backend(nn.Module):
    """2-layer biGRU -> Linear; ``pool``: the mean over time before the
    Linear (one logit vector a clip)."""

    def __init__(self, in_dim: int, hidden: int, classes: int, pool: bool):
        super().__init__()
        self.gru = BiGRU(in_dim, hidden, num_layers=2, dropout=0.3)
        self.fc = Linear(2 * hidden, classes)
        self.pool = pool

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.gru(feats)
        return self.fc(x.mean(dim=1) if self.pool else x)


class ASRModel(nn.Module):
    """Log-mel (B, 80, T) -> logits; built in eval mode, which it keeps."""

    def __init__(self, front: AudioFront, back: Backend):
        super().__init__()
        self.front, self.back = front, back
        self.eval()

    def train(self, mode: bool = True) -> "ASRModel":
        if mode:
            raise NotImplementedError("the ASR models are ported for evaluation only")
        return super().train(False)

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.back(self.front(mel))

    def load_state_dicts(self, front: StateDict, back: StateDict) -> "ASRModel":
        self.front.load_state_dict(front, strict=True)
        self.back.load_state_dict(back, strict=True)
        return self


class GridASR(ASRModel):
    """(B, 80, T) -> per-step character logits (B, T // 4, 28)."""

    def __init__(self, vocab_size: int = 28):
        super().__init__(AudioFront(32, 64, 256, kernel=5, res_relu_type="prelu"),
                         Backend(256, 256, vocab_size, pool=False))


class LRWClassifier(ASRModel):
    """(B, 80, T) -> word logits (B, num_classes)."""

    def __init__(self, num_classes: int = 500):
        super().__init__(AudioFront(128, 256, 512, kernel=3, res_relu_type="relu"),
                         Backend(512, 512, num_classes, pool=True))


def _reference_lrw(path: str) -> Tuple[StateDict, StateDict]:
    """The reference LRW checkpoint (ASR_model/LRW/test.py:56-58): a dict of
    ``a_front_state_dict`` and ``a_back_state_dict``, which carry the port's
    names."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["a_front_state_dict"], ckpt["a_back_state_dict"]


def load_asr(kind: str, checkpoint: Optional[str] = None, num_classes: int = 500,
             device=None) -> ASRModel:
    """The ASR CLIs' model (``vcagan/cli/asr_grid.py:49-71``,
    ``asr_lrw.py:39-62``), ``kind`` "grid" or "lrw", on ``device``: CUDA
    unless the caller names another one (``resolve_device``), in true fp32.

    ``checkpoint``: an ``.npz`` holding ``variables``, the JAX package's
    flax tree (``asr_from_jax``); for LRW any other file is the reference
    torch checkpoint; a directory (an orbax checkpoint) is refused with the
    command of ``tools/export_jax_train_state.py --asr`` that exports it to
    such an ``.npz``.  None:
    the JAX package's initialisation drawn from seed 0 (``init_like_jax``),
    the JAX CLIs' smoke mode."""
    device = resolve_device(device)
    if device.type == "cuda":
        use_full_fp32()
    with torch.random.fork_rng(devices=[]):  # construction draws PyTorch's init
        model = GridASR() if kind == "grid" else LRWClassifier(num_classes)
    init_like_jax(model, torch.Generator().manual_seed(0))
    if checkpoint is not None:
        if os.path.isdir(checkpoint):
            raise NotImplementedError(
                f"{checkpoint} is a directory (an orbax checkpoint of the JAX package), which "
                "the port does not read: export it with `python tools/export_jax_train_state.py "
                "--asr --checkpoint <orbax_dir> --out variables.npz` and pass the .npz")
        if kind == "lrw" and not checkpoint.endswith(".npz"):
            states = _reference_lrw(checkpoint)
        else:
            with np.load(checkpoint, allow_pickle=True) as z:
                variables = z["variables"].item()
            states = asr_from_jax(variables, kind)
        model.load_state_dicts(*states)
    return model.to(device)
