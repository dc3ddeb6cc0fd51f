"""TF32 rounding and the hi/lo split of fp32 values, in plain PyTorch.

The kernels' fp32 forms do every product on the tensor cores as three TF32
products (3xTF32): each operand a = hi + lo, both parts TF32 values, and
a*b = lo_a*hi_b + hi_a*lo_b + hi_a*hi_b.  These helpers round exactly as the
kernels do (``vcagan_torch/csrc/tf32.cuh``), so the plain versions of that
arithmetic (``fused_block_reference_3xtf32``,
``masked_attention_reference_3xtf32``) can be held to the kernels.
"""

from __future__ import annotations

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits; ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds), still stored as fp32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t = hi + lo to about 2^-21 relative, both parts TF32 values."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)
