"""ResNet-18 trunk for per-frame lip features, NCHW.

Port of ``vcagan/nn/resnet.py:49-164`` (the unfolded path): BasicBlock
conv3x3-BN-PReLU-conv3x3-BN (+ shortcut) -> PReLU, layout [2,2,2,2], a
1x1 stride-2 conv + BN projection where the shape changes, and a global
spatial mean.  Attribute names follow the reference state dict
(``layer1.0.conv1``, ``bn1``, ``relu1``, ``downsample.0/1``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vcagan_torch.nn.common import batch_norm, prelu


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.relu1 = prelu(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(planes)
        self.relu2 = prelu(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False), batch_norm(planes)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + residual)


class ResNetTrunk(nn.Module):
    """(N, 64, H, W) -> stacked BasicBlocks -> global mean -> (N, 512)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), in_planes: int = 64):
        super().__init__()
        plan = [(64, 1), (128, 2), (256, 2), (512, 2)]
        for stage, (planes, first_stride) in enumerate(plan):
            blocks = []
            for block in range(layers[stage]):
                blocks.append(
                    BasicBlock(in_planes, planes, first_stride if block == 0 else 1)
                )
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))
