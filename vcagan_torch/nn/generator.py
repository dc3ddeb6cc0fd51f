"""Mel generator (Decoder), Postnet, and their residual blocks, NCHW.

Port of ``vcagan/nn/generator.py:30-234`` in eval mode.  Inside, the
spectrogram maps are (B, C, F, T); the public layouts are the JAX ones:
``noise`` (B, 20, T, 128), mels (B, F, T'), postnet output (B, 321, T').
Attribute names follow the reference state dict (``decode.0``, ``g1.2``,
``att1.q``, ``attconv1``, ``to_mel1.2``, ``postnet.0`` ... ``postnet.6``).

Compute dtype (``config.use_bfloat16``, ``vcagan/nn/generator.py:37-234``):
every convolution, BatchNorm output and activation of the decoder and the
postnet is bf16 in the bf16 mode, with fp32 parameters, and so are the
noise, ``mel1..3`` and the postnet's output.  The attention stays fp32
(``vcagan_torch/nn/attention.py``); its context is rounded to bf16 where
``attconv1/2`` take it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vcagan_torch.configs import ModelConfig
from vcagan_torch.nn.attention import AVAttention
from vcagan_torch.nn.common import (
    INV_SQRT2,
    Conv1d,
    Conv2d,
    FoldableModule,
    LeakyReLU,
    batch_norm,
    leaky_relu,
    rounded,
)
from vcagan_torch.parallel.mesh import draw_rows
from vcagan_torch.runtime import compute_dtype


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest-neighbour upsample of (B, C, F, T) in F and T."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class GenResBlk(nn.Module):
    """BN-LReLU-conv5x5 twice, optional x2 nearest upsample, 1x1 shortcut
    on a channel change, output scaled by 1/sqrt(2)."""

    def __init__(self, in_channels: int, out_channels: int, upsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upsample = upsample
        self.norm1 = batch_norm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 5, padding=2, compute_dtype=dtype)
        self.norm2 = batch_norm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 5, padding=2, compute_dtype=dtype)
        self.conv1x1 = None
        if in_channels != out_channels:
            self.conv1x1 = Conv2d(in_channels, out_channels, 1, bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.norm1(x))
        if self.upsample:
            h = _nearest_up2(h)
        h = self.conv2(leaky_relu(self.norm2(self.conv1(h))))
        sc = _nearest_up2(x) if self.upsample else x
        if self.conv1x1 is not None:
            sc = self.conv1x1(sc)
        h = h + sc
        return h * rounded(INV_SQRT2, h.dtype)


class ResBlk1D(nn.Module):
    """LReLU-conv5 twice + 1x1 shortcut, 1/sqrt(2) scaling, on (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv1d(in_channels, in_channels, 5, padding=2, compute_dtype=dtype)
        self.conv2 = Conv1d(in_channels, out_channels, 5, padding=2, compute_dtype=dtype)
        self.conv1x1 = None
        if in_channels != out_channels:
            self.conv1x1 = Conv1d(in_channels, out_channels, 1, bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(leaky_relu(self.conv1(leaky_relu(x))))
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        h = h + sc
        return h * rounded(INV_SQRT2, h.dtype)


def _to_mel(channels: int, dtype: torch.dtype) -> nn.Sequential:
    """BN -> LReLU -> 1x1 conv -> tanh head."""
    return nn.Sequential(
        batch_norm(channels), LeakyReLU(), Conv2d(channels, 1, 1, compute_dtype=dtype), nn.Tanh()
    )


def _blocks(plan, dtype: torch.dtype, upsample_first: bool = False) -> nn.Sequential:
    return nn.Sequential(
        *(
            GenResBlk(cin, cout, upsample=upsample_first and i == 0, dtype=dtype)
            for i, (cin, cout) in enumerate(plan)
        )
    )


class Decoder(nn.Module):
    """Normalised log-mels at three scales, with visual-context attention
    after the first two stages.  PHON is tiled over the 20 coarse bins as
    the synthesis input; SENT feeds the attention keys and values."""

    def __init__(self, config: ModelConfig | None = None):
        super().__init__()
        m = config or ModelConfig()
        self.dtype = dtype = compute_dtype(m)
        self.base_bins = m.mel_base_bins
        self.noise_dim = m.noise_dim
        c_in = m.feature_dim + m.noise_dim
        self.decode = _blocks([(c_in, 512), (512, 256), (256, 256)], dtype)
        self.g1 = _blocks([(256, 128), (128, 128), (128, 128)], dtype)
        self.g2 = _blocks([(128, 64), (64, 64), (64, 64)], dtype, upsample_first=True)
        self.g3 = _blocks([(64, 32), (32, 32), (32, 32)], dtype, upsample_first=True)
        f1, f2 = m.mel_base_bins, 2 * m.mel_base_bins
        inner = m.attention_inner
        self.att1 = AVAttention(128 * f1, m.attention_dim, inner, m.feature_dim)
        self.att2 = AVAttention(64 * f2, m.attention_dim, inner, m.feature_dim)
        self.attconv1 = Conv2d(128 + inner // f1, 128, 5, padding=2, compute_dtype=dtype)
        self.attconv2 = Conv2d(64 + inner // f2, 64, 5, padding=2, compute_dtype=dtype)
        self.to_mel1 = _to_mel(128, dtype)
        self.to_mel2 = _to_mel(64, dtype)
        self.to_mel3 = _to_mel(32, dtype)

    def forward(
        self,
        sent: torch.Tensor,
        phon: torch.Tensor,
        lengths: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """sent, phon (B, T, 512); lengths (B,) int32; ``noise`` (B, 20, T,
        128) in the JAX layout, or drawn from ``generator`` when None, in
        the compute dtype (an injected one is cast to it)."""
        b, t, c = phon.shape
        f = self.base_bins
        if noise is None:  # at the global batch's shape under a data-parallel layout
            noise = draw_rows(lambda n: torch.randn(
                (n, f, t, self.noise_dim), generator=generator, device=phon.device,
                dtype=self.dtype,
            ), b)
        x = torch.cat(
            [phon.to(self.dtype).transpose(1, 2)[:, :, None, :].expand(b, c, f, t),
             noise.to(self.dtype).permute(0, 3, 1, 2)],
            dim=1,
        )
        g1 = self.g1(self.decode(x))
        # the fp32 context joins the map and both go into attconv1/2 in the
        # compute dtype (vcagan/nn/generator.py:176-178, :192-194)
        c1 = self.att1(sent, g1, lengths).to(self.dtype)
        x = self.attconv1(torch.cat([g1, c1], dim=1))
        g2 = self.g2(x)
        c2 = self.att2(sent, g2, lengths).to(self.dtype)
        x = self.attconv2(torch.cat([g2, c2], dim=1))
        g3 = self.g3(x)
        return self.to_mel1(g1)[:, 0], self.to_mel2(g2)[:, 0], self.to_mel3(g3)[:, 0]


class Postnet(FoldableModule):
    """Normalised mel (B, 80, T) -> linear magnitudes (B, 321, T).
    ``fold_bn``: ``postnet.1`` is folded into ``postnet.0``
    (``vcagan/nn/generator.py:218-226``)."""

    def __init__(self, config: ModelConfig | None = None, n_mels: int = 80,
                 fold_bn: bool = False):
        super().__init__(fold_bn)
        m = config or ModelConfig()
        dtype = compute_dtype(m)
        ch = m.postnet_channels
        self.postnet = nn.Sequential(
            Conv1d(n_mels, 128, 7, padding=3, compute_dtype=dtype),
            batch_norm(128, dims=1, folded=fold_bn),
            LeakyReLU(),
            ResBlk1D(128, ch, dtype),
            ResBlk1D(ch, ch, dtype),
            ResBlk1D(ch, ch, dtype),
            Conv1d(ch, m.linear_bins, 1, bias=False, compute_dtype=dtype),
        )
        if fold_bn:
            self.eval()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.postnet(mel)
