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


def batch_norm(channels: int, dims: int = 2) -> nn.Module:
    """BatchNorm{1,2,3}d with the reference's eps and momentum; the port
    serves in eval mode, where it is the running-statistics affine."""
    cls = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[dims]
    return cls(channels, eps=BN_EPS, momentum=0.1)
