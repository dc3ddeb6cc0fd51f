"""Audio front: mel -> one feature vector every 4 mel frames.

Port of ``vcagan/nn/audio_front.py:19-66`` (reference
``src/models/audio_front.py:5-36``): conv k x k stride 2 -> BN -> PReLU ->
conv k x k stride 2 -> BN -> PReLU -> ``BasicBlock(ch2)`` -> the frequency
axis flattened -> ``Linear``.  The ASR stacks (``vcagan_torch/eval/
asr_models.py``) and the sync critic (``nn/discriminator.py``) build on it.

Attribute names are the reference's, which ``tools/convert_torch_ckpt.py``
reads (``frontend.0-5``, ``Res_block.0``, ``Linear``).  The map keeps the
reference (freq, time) layout, (B, C, F, T); the JAX module runs time-major
with swapped kernels, and with both paddings k // 2 the two layouts compute
the same thing.  ``Linear`` reads each step's (C, F) map flattened c-major,
as the reference does; the JAX module flattens (F, C), and the weight
converters permute the rows (``vcagan_torch/io/weights.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from vcagan_torch.nn.common import Conv2d, Linear, PReLU, batch_norm
from vcagan_torch.nn.resnet import BasicBlock


class AudioFront(nn.Module):
    """(B, n_mels, T) mel -> (B, T // 4, out_dim).  The defaults are the
    reference audio front (128/256 channels, k = 3, plain-ReLU block ->
    512); the GRID ASR front is (32, 64, 256, 5, "prelu")."""

    def __init__(self, ch1: int = 128, ch2: int = 256, out_dim: int = 512, kernel: int = 3,
                 res_relu_type: str = "relu", n_mels: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, pad = kernel, kernel // 2
        self.frontend = nn.Sequential(
            Conv2d(1, ch1, k, 2, pad, compute_dtype=dtype), batch_norm(ch1), PReLU(ch1),
            Conv2d(ch1, ch2, k, 2, pad, compute_dtype=dtype), batch_norm(ch2), PReLU(ch2),
        )
        self.Res_block = nn.Sequential(BasicBlock(ch2, ch2, dtype=dtype, relu_type=res_relu_type))
        freq = n_mels
        for _ in range(2):
            freq = (freq + 2 * pad - k) // 2 + 1
        self.Linear = Linear(ch2 * freq, out_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.Res_block(self.frontend(mel[:, None]))  # (B, C, F, T // 4)
        return self.Linear(x.permute(0, 3, 1, 2).flatten(2))  # c-major rows
