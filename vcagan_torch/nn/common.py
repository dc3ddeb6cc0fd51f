"""Shared layers: per-channel PReLU, LeakyReLU(0.2), eval BatchNorm.

The port keeps PyTorch's channels-first layout inside its modules (NCHW,
NCDHW, (B, C, T)); public inputs and outputs keep the JAX package's layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

INV_SQRT2 = 1.0 / math.sqrt(2.0)
BN_EPS = 1e-5


def prelu(channels: int) -> nn.PReLU:
    """Per-channel parametric ReLU, slopes initialised to 0.25."""
    return nn.PReLU(channels, init=0.25)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def batch_norm(channels: int, dims: int = 2, folded: bool = False) -> nn.Module:
    """BatchNorm{1,2,3}d with the reference's eps and momentum; the port
    serves in eval mode, where it is the running-statistics affine.
    ``folded``: the affine lives in the preceding convolution
    (``vcagan_torch/nn/fold.py``) and an ``nn.Identity`` keeps its place, so
    the names of the layers after it do not move."""
    if folded:
        return nn.Identity()
    cls = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[dims]
    return cls(channels, eps=BN_EPS, momentum=0.1)


class FoldableModule(nn.Module):
    """A module with a ``fold_bn`` mode.  Folded weights carry frozen
    statistics, so a folded module refuses training mode; a subclass ends
    its ``__init__`` with ``self.eval()`` when folded."""

    def __init__(self, fold_bn: bool):
        super().__init__()
        self.fold_bn = fold_bn

    def train(self, mode: bool = True):
        if mode and self.fold_bn:
            raise RuntimeError("fold_bn is an eval-only mode")
        return super().train(mode)
