"""Visual front: 3-D conv stem -> per-frame ResNet-18 -> biGRU context.

Port of ``vcagan/nn/visual_front.py:54-130``.  The JAX stem
conv is a space-to-depth rewrite for the TPU (``s2d_stem_conv3d``) that
computes exactly a k(5,7,7) s(1,2,2) pad (2,3,3) conv; here it is that plain
``nn.Conv3d``.  Public layout as in JAX: video (B, T, H, W, 1) ->
``phon``, ``sent`` (B, T, 512).  In train mode the dropout after the trunk
(``:118``) and the biGRU's between its layers draw their masks from the
``generator`` passed to ``forward``.

``fold_bn``: serving mode; the stem convolution carries the folded
BatchNorm as a bias (``vcagan/nn/visual_front.py:75-84``) and the trunk is
folded too.  ``fused`` is passed to the trunk (``:114-117``), which then
gets its frames channels-last.

Compute dtype (``config.use_bfloat16``, ``vcagan/nn/visual_front.py:35-130``):
the stem convolution (its folded bias cast to bf16 too, ``:50``), BatchNorm,
PReLU, pool and trunk compute in it, so ``phon`` is bf16 in the bf16 mode;
the biGRU takes its input in fp32 (``vcagan/nn/gru.py:104``) and ``fc`` is an
fp32 dense, so ``sent`` is fp32.

``remat_stem`` (the step's ``remat="stem"``, ``vcagan/nn/visual_front.py:
87-99``): the stem chain (convolution, BatchNorm, PReLU, max-pool) keeps
only its input and its pooled output for the backward, which recomputes
the rest (``recomputed``); it applies where autograd records the forward.

Where the front is ``fused`` and computes in bf16, the stem chain runs as
one launch of the fused stem kernel (``vcagan_torch/kernels/fused_stem.py``;
on the CPU its plain version, which keeps the card's rounding points), and
its output, (B*T, H', W', C) channels-last, is the trunk's input as it
stands; the module keeps a packed copy of the convolution's weight for it,
refreshed at load (``repack``).  Elsewhere (unfolded, fp32, C not a
multiple of 64) the chain of layers runs.

A call is traced (``vcagan_torch.tracing``) as ``v_front.stem``, then
``v_front.trunk`` (the frames' layout, the trunk and its dropout), then
``v_front.gru`` (the sentence encoder and ``fc``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vcagan_torch.configs import ModelConfig
from vcagan_torch.kernels.fused_stem import CHANNEL_MULTIPLE, fused_stem, pack_stem_weights
from vcagan_torch.nn.common import (
    Conv3d, FoldableModule, PReLU, batch_norm, dropout, recomputed)
from vcagan_torch.nn.gru import BiGRU
from vcagan_torch.nn.resnet import ResNetTrunk
from vcagan_torch.runtime import compute_dtype
from vcagan_torch.tracing import span


class VisualFront(FoldableModule):
    def __init__(self, config: ModelConfig | None = None, fold_bn: bool = False,
                 fused: bool = False):
        super().__init__(fold_bn)
        if fused and not fold_bn:
            raise ValueError("fused requires fold_bn=True (serving mode)")
        self.fused = fused
        m = config or ModelConfig()
        dtype = compute_dtype(m)
        c = m.stem_channels
        self.frontend = nn.Sequential(
            Conv3d(1, c, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3), bias=fold_bn,
                   compute_dtype=dtype),
            batch_norm(c, dims=3, folded=fold_bn),
            PReLU(c),
            nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)),
        )
        self.resnet = ResNetTrunk(m.resnet_layers, in_planes=c, fold_bn=fold_bn, fused=fused,
                                  dtype=dtype)
        self.dropout_rate = m.frontend_dropout
        self.sentence_encoder = BiGRU(m.feature_dim, m.gru_hidden, m.gru_layers, m.gru_dropout)
        self.fc = nn.Linear(2 * m.gru_hidden, m.feature_dim)
        self.feature_dim = m.feature_dim
        # the stem kernel's weight order, repacked when weights are loaded and
        # not per call; not part of the state dict
        self.kernel_stem = fused and dtype == torch.bfloat16 and c % CHANNEL_MULTIPLE == 0
        if self.kernel_stem:
            self.register_buffer("stem_packed", None, persistent=False)
            self.repack()
            self.register_load_state_dict_post_hook(VisualFront._repack_after_load)
        if fold_bn:
            self.eval()

    def repack(self) -> None:
        """Refresh the stem kernel's copy of the convolution's weight (where
        the kernel runs); ``load_state_dict`` and ``init_like_jax`` do it, a
        caller that writes ``frontend.0.weight`` in place must."""
        if self.kernel_stem:
            self.stem_packed = pack_stem_weights(self.frontend[0].weight.detach())

    @staticmethod
    def _repack_after_load(module: "VisualFront", incompatible_keys) -> None:
        module.repack()

    def stem(self, video: torch.Tensor, remat_stem: bool = False) -> torch.Tensor:
        """(B, T, H, W, 1) -> (B, C, T, H', W'): channels-last memory where
        the kernel computes it."""
        if self.kernel_stem:
            conv, act = self.frontend[0], self.frontend[2]
            y = fused_stem(video, conv.weight, conv.bias, act.weight, packed=self.stem_packed)
            return y.view(*video.shape[:2], *y.shape[1:]).permute(0, 4, 1, 2, 3)
        x = video.permute(0, 4, 1, 2, 3)
        return recomputed("stem", self.frontend, x) if remat_stem else self.frontend(x)

    def forward(self, video: torch.Tensor, generator: torch.Generator | None = None,
                remat_stem: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = video.shape[:2]
        with span("v_front.stem"):
            x = self.stem(video, remat_stem)
        with span("v_front.trunk"):
            if self.fused:
                # (B*T, H', W', C) in memory, seen as NCHW: a view of the stem
                # kernel's output, else the one copy that the flatten below
                # makes too, into the layout the fused blocks read
                frames = x.permute(0, 2, 3, 4, 1).reshape(b * t, *x.shape[3:], x.shape[1])
                frames = frames.permute(0, 3, 1, 2)
            else:
                frames = x.transpose(1, 2).flatten(0, 1)
            x = dropout(self.resnet(frames), self.dropout_rate, self.training, generator)
        phon = x.reshape(b, t, self.feature_dim)  # (B*T, 512) -> (B, T, 512)
        with span("v_front.gru"):
            sent = self.fc(self.sentence_encoder(phon, generator))
        return phon, sent
