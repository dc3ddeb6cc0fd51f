"""ResNet-18 trunk for per-frame lip features, NCHW.

Port of ``vcagan/nn/resnet.py:49-164``: BasicBlock
conv3x3-BN-PReLU-conv3x3-BN (+ shortcut) -> PReLU (``relu_type="relu"``:
plain parameter-free ReLUs, as in the sync critic), layout [2,2,2,2], a
1x1 stride-2 conv + BN projection where the shape changes, and a global
spatial mean.  Attribute names follow the reference state dict
(``layer1.0.conv1``, ``bn1``, ``relu1``, ``downsample.0/1``).

``fold_bn``: serving mode; every conv -> BN pair was folded into a biased
convolution (``vcagan_torch/nn/fold.py``), an ``nn.Identity`` stands where
the BatchNorm was.  ``fused`` (needs ``fold_bn``): the identity-shortcut
blocks (5 of the 8) each run as one launch of the fused block kernel
(``vcagan_torch/kernels/fused_block.py``), on ``torch.channels_last``
memory, where the kernel's (N, H, W, C) layout is a view; the projection
blocks keep the library convolutions.  The state-dict keys are the same
with and without ``fused``.

The convolutions' kernels are drawn He-normal by fan-out
(``vcagan/nn/common.py:40-43``; ``init_like_jax`` reads ``kernel_init``).

``dtype``: the compute dtype (``vcagan/nn/resnet.py:60-164``); in bf16 the
convolutions, BatchNorm outputs and PReLUs are bf16 and so is the spatial
mean (summed in fp32), while the parameters stay fp32.  The fused blocks
take bf16 x with fp32 biases and slopes (``vcagan/nn/resnet.py:86-88``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vcagan_torch.kernels.fused_block import fused_basic_block, pack_weights
from vcagan_torch.nn.common import Conv2d, FoldableModule, PReLU, batch_norm, he_normal_fan_out_


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A convolution's (O, I, kh, kw) weight in the kernel's (kh, kw, I, O) order."""
    return conv.weight.detach().permute(2, 3, 1, 0).contiguous()


class BasicBlock(FoldableModule):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 fold_bn: bool = False, fused: bool = False,
                 dtype: torch.dtype = torch.float32, relu_type: str = "prelu"):
        super().__init__(fold_bn)
        if fused and (not fold_bn or relu_type != "prelu"):
            raise ValueError("fused requires fold_bn=True (serving mode) and PReLU")
        self.dtype = dtype
        act = {"prelu": lambda: PReLU(planes), "relu": nn.ReLU}[relu_type]
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, bias=fold_bn, compute_dtype=dtype)
        self.bn1 = batch_norm(planes, folded=fold_bn)
        self.relu1 = act()
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=fold_bn, compute_dtype=dtype)
        self.bn2 = batch_norm(planes, folded=fold_bn)
        self.relu2 = act()
        # vcagan/nn/resnet.py:96, 108, 123
        self.conv1.kernel_init = self.conv2.kernel_init = he_normal_fan_out_
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride, bias=fold_bn, compute_dtype=dtype),
                batch_norm(planes, folded=fold_bn),
            )
            self.downsample[0].kernel_init = he_normal_fan_out_
        self.fused = fused and self.downsample is None
        if self.fused:
            # The kernel's weight order, repacked when weights are loaded and
            # not per call; not part of the state dict.  The plain version
            # (CPU) reads (kh, kw, I, O); the kernel reads that packed for
            # the tensor cores, in the compute dtype (the type of x).
            for name in ("w1_hwio", "w2_hwio", "w1_packed", "w2_packed"):
                self.register_buffer(name, None, persistent=False)
            self.repack()
            self.register_load_state_dict_post_hook(BasicBlock._repack_after_load)
        if fold_bn:
            self.eval()

    def repack(self) -> None:
        """Refresh the kernel's copies of the weights, packed for the compute
        dtype (a fused block; others keep none); ``load_state_dict`` and
        ``init_like_jax`` do it, a caller that writes ``conv1``/``conv2``
        weights in place must."""
        if not self.fused:
            return
        self.w1_hwio = _hwio(self.conv1)
        self.w2_hwio = _hwio(self.conv2)
        self.w1_packed = pack_weights(self.w1_hwio.float(), self.dtype)
        self.w2_packed = pack_weights(self.w2_hwio.float(), self.dtype)

    @staticmethod
    def _repack_after_load(module: "BasicBlock", incompatible_keys) -> None:
        module.repack()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            # no copy when x is already of the compute dtype and channels-last
            x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
            out = fused_basic_block(
                x.permute(0, 2, 3, 1), self.w1_hwio, self.conv1.bias, self.relu1.weight,
                self.w2_hwio, self.conv2.bias, self.relu2.weight,
                packed=(self.w1_packed, self.w2_packed),
            )
            return out.permute(0, 3, 1, 2)
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + residual)


class ResNetTrunk(FoldableModule):
    """(N, 64, H, W) -> stacked BasicBlocks -> global mean -> (N, 512)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), in_planes: int = 64,
                 fold_bn: bool = False, fused: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(fold_bn)
        plan = [(64, 1), (128, 2), (256, 2), (512, 2)]
        for stage, (planes, first_stride) in enumerate(plan):
            blocks = []
            for block in range(layers[stage]):
                blocks.append(
                    BasicBlock(in_planes, planes, first_stride if block == 0 else 1,
                               fold_bn=fold_bn, fused=fused, dtype=dtype)
                )
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        if fold_bn:
            self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))
