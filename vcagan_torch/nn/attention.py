"""Visual-context cross-attention (AVAttention).

Port of ``vcagan/nn/attention.py:28-50``: the generator's feature map
queries the sentence features; keys past each clip's length are masked; the
attended context is projected back to a (freq, channel) map.  The k/v/q/mel
denses are fp32 in either compute dtype: they take no dtype in JAX, where
flax promotes a bf16 map with fp32 kernels to fp32
(``vcagan/nn/attention.py:41-42``), so ``g`` is cast up first and the
context comes out fp32.

Flatten orders follow the reference state dict, which the converter
(``tools/convert_torch_ckpt.py:205-214``) maps onto the flax tree: ``q``'s
input rows are c-major (index c*F + f, the converter permutes them to the
JAX f-major order), while ``mel``'s output rows are not permuted, so they
stay f-major (index f*c_out + c) as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from vcagan_torch.kernels.masked_attention import masked_cross_attention
from vcagan_torch.nn.common import fp32_or_wider


class AVAttention(nn.Module):
    def __init__(self, in_features: int, out_dim: int = 256, inner_dim: int = 1280,
                 sent_dim: int = 512):
        super().__init__()
        self.k = nn.Linear(sent_dim, out_dim)
        self.v = nn.Linear(sent_dim, out_dim)
        self.q = nn.Linear(in_features, out_dim)
        self.mel = nn.Linear(out_dim, inner_dim)

    def forward(self, sent: torch.Tensor, g: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """sent (B, S, 512), g (B, C, F, T), lengths (B,) -> (B, c_out, F, T)."""
        b, c, f, t = g.shape
        k = self.k(sent)
        v = self.v(sent)
        q = self.q(fp32_or_wider(g).permute(0, 3, 1, 2).reshape(b, t, c * f))  # c-major rows
        ctx = masked_cross_attention(q, k, v, lengths)  # (B, T, D)
        out = self.mel(ctx).reshape(b, t, f, -1)  # f-major rows
        return out.permute(0, 3, 2, 1)
