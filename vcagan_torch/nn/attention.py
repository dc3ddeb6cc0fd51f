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

Under a layout with a model axis (``vcagan_torch.parallel``), ``q`` and
``mel`` hold their rank's output columns (``vcagan_torch/parallel/shard.py``,
the JAX package's ``vcagan/parallel/mesh.py:60-86``).  Each such product
takes its input through ``copy_to_model``, gathers its columns over the
model group and adds the full, replicated bias after the gather, so the
attention kernel gets the whole ``q`` (D wide, as the JAX kernel's
partitioning rule keeps it) and ``mel``'s output leaves the module whole,
as the JAX step pins it to the batch's sharding.  ``k`` and ``v`` stay
whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vcagan_torch.kernels.masked_attention import masked_cross_attention
from vcagan_torch.nn.common import fp32_or_wider
from vcagan_torch.parallel.collectives import copy_to_model, gather_columns
from vcagan_torch.parallel.mesh import active_layout


def column_parallel(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear(x)``; where ``linear`` holds a slice of its output columns,
    the slice's product gathered over the active layout's model group, then
    the whole bias."""
    if linear.weight.shape[0] == linear.out_features:
        return linear(x)
    layout = active_layout()
    if layout is None or layout.model_group is None:
        raise RuntimeError(f"{linear} holds {linear.weight.shape[0]} of its "
                           f"{linear.out_features} output columns: it runs under the active "
                           "layout of its model group")
    group = layout.model_group
    return gather_columns(F.linear(copy_to_model(x, group), linear.weight), group) + linear.bias


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
        q_in = fp32_or_wider(g).permute(0, 3, 1, 2).reshape(b, t, c * f)  # c-major rows
        q = column_parallel(self.q, q_in)
        ctx = masked_cross_attention(q, k, v, lengths)  # (B, T, D)
        out = column_parallel(self.mel, ctx).reshape(b, t, f, -1)  # f-major rows
        return out.permute(0, 3, 2, 1)
