"""Bidirectional multi-layer GRU of the visual front.

Port of ``vcagan/nn/gru.py:31-111``.  ``torch.nn.GRU`` has the same gate
order (r|z|n) and gate math as the JAX layer; its weights are (3H, in)
where the flax tree keeps (in, 3H) (``vcagan_torch.io.weights`` transposes).
The recurrence is not a TPU kernel of the JAX package, so it runs as
PyTorch's own GRU (cuDNN on the card).  It stays fp32 in the bf16 mode: its
input is cast to fp32 (``vcagan/nn/gru.py:104``).
"""

from __future__ import annotations

import torch
from torch import nn


class BiGRU(nn.GRU):
    """(B, T, C) -> (B, T, 2H); dropout between layers in train mode only."""

    def __init__(self, input_size: int = 512, hidden: int = 512, num_layers: int = 2,
                 dropout: float = 0.3):
        super().__init__(
            input_size, hidden, num_layers, batch_first=True, bidirectional=True,
            dropout=dropout,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())[0]
