"""Bidirectional multi-layer GRU of the visual front.

Port of ``vcagan/nn/gru.py:31-111``.  ``torch.nn.GRU`` has the same gate
order (r|z|n) and gate math as the JAX layer; its weights are (3H, in)
where the flax tree keeps (in, 3H) (``vcagan_torch.io.weights`` transposes).
The recurrence is not a TPU kernel of the JAX package, so it runs as
PyTorch's own GRU (cuDNN on the card).  It stays fp32 in the bf16 mode: its
input is cast to fp32 (``vcagan/nn/gru.py:104``).

In train mode the layers run one call each, with the inter-layer dropout
drawn between them from the caller's generator (``vcagan/nn/gru.py:109-110``);
``nn.GRU``'s own dropout would draw from the global generator on the CPU and
from cuDNN's dropout state on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from vcagan_torch.nn.common import dropout, fp32_or_wider


class BiGRU(nn.GRU):
    """(B, T, C) -> (B, T, 2H); dropout between layers in train mode only."""

    def __init__(self, input_size: int = 512, hidden: int = 512, num_layers: int = 2,
                 dropout: float = 0.3):
        super().__init__(
            input_size, hidden, num_layers, batch_first=True, bidirectional=True,
            dropout=dropout,
        )

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = fp32_or_wider(x)
        if not self.training:
            return super().forward(x)[0]
        per_layer = len(self._flat_weights) // self.num_layers  # both directions' 4 tensors
        for layer in range(self.num_layers):
            if layer:
                x = dropout(x, self.dropout, True, generator)
            weights = self._flat_weights[layer * per_layer:(layer + 1) * per_layer]
            h0 = x.new_zeros(2, x.shape[0], self.hidden_size)
            x = torch._VF.gru(x, h0, weights, self.bias, 1, 0.0, True, True, True)[0]
        return x
