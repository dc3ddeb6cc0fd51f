"""Visual front: 3-D conv stem -> per-frame ResNet-18 -> biGRU context.

Port of ``vcagan/nn/visual_front.py:54-130`` in eval mode.  The JAX stem
conv is a space-to-depth rewrite for the TPU (``s2d_stem_conv3d``) that
computes exactly a k(5,7,7) s(1,2,2) pad (2,3,3) conv; here it is that plain
``nn.Conv3d``.  Public layout as in JAX: video (B, T, H, W, 1) ->
``phon``, ``sent`` (B, T, 512).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vcagan_torch.configs import ModelConfig
from vcagan_torch.nn.common import batch_norm, prelu
from vcagan_torch.nn.gru import BiGRU
from vcagan_torch.nn.resnet import ResNetTrunk


class VisualFront(nn.Module):
    def __init__(self, config: ModelConfig | None = None):
        super().__init__()
        m = config or ModelConfig()
        c = m.stem_channels
        self.frontend = nn.Sequential(
            nn.Conv3d(1, c, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3), bias=False),
            batch_norm(c, dims=3),
            prelu(c),
            nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)),
        )
        self.resnet = ResNetTrunk(m.resnet_layers, in_planes=c)
        self.dropout = nn.Dropout(m.frontend_dropout)
        self.sentence_encoder = BiGRU(m.feature_dim, m.gru_hidden, m.gru_layers, m.gru_dropout)
        self.fc = nn.Linear(2 * m.gru_hidden, m.feature_dim)
        self.feature_dim = m.feature_dim

    def forward(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = video.shape[:2]
        x = self.frontend(video.permute(0, 4, 1, 2, 3))  # (B, C, T, H', W')
        x = self.dropout(self.resnet(x.transpose(1, 2).flatten(0, 1)))  # (B*T, 512)
        phon = x.reshape(b, t, self.feature_dim)
        sent = self.fc(self.sentence_encoder(phon))
        return phon, sent
