"""The multi-scale mel discriminators and the audio-visual sync critic.

Port of ``vcagan/nn/discriminator.py`` (reference ``generator.py:51-92``,
``267-361``).  Attribute names follow the reference state dicts that
``tools/convert_torch_ckpt.py:253-308`` reads: ``main.0`` (input conv),
``main.{i+1}`` (ResBlks), ``uncond.1/4``, ``cond.1/3/6``; for the sync
critic ``frontend.0-5``, ``Res_block.0`` and ``Linear``.

Layouts: a mel is (B, F, T) as the decoder gives it, seen as a (B, 1, F, T)
image with frequency as H.  The sync critic keeps that reference layout;
the JAX module runs time-major with swapped kernels, which the converter
accounts for (``conv2d_swapped``).  Its ``Linear`` reads the (C=256, F=20)
map of each step flattened c-major, as the reference does.

Compute dtype (``config.use_bfloat16``, ``vcagan/nn/discriminator.py:34,
77, 146``): the convolutions, the sync critic's BatchNorms, PReLUs and
``BasicBlock`` compute in it, the parameters stay fp32.  The dense layers
take no dtype in JAX, so they promote a bf16 input to fp32: the logits and
the sync critic's audio features are fp32 in either mode, and so is every
loss taken from them.  Constants that meet a bf16 array (the ResBlk's
1/sqrt(2), the leaky slope) are rounded to bf16 first, as JAX's weak typing
does.

The discriminators' convolutions are ``DiscConv2d``: ``Conv2d``'s forward
(the compute dtype's cast, the CPU bf16 path), differentiated by
``conv2d_twice``, whose input gradient is itself a convolution that
autograd differentiates once more.  R1 (``vcagan_torch/nn/losses.py``
``r1_penalty``) takes the gradient of the logits into the mel with a graph,
and the D backward differentiates that gradient into the weights: on
``conv2d_twice`` that second derivative is the backward of
``conv_transpose2d``, cuDNN's ordinary weight-gradient and forward
convolutions, where PyTorch's own ``Conv2d`` would run its generic
``_convolution_double_backward`` (a convolution whose filter is the whole
feature map and whose channels are the batch).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from vcagan_torch import tracing
from vcagan_torch.configs import ModelConfig
from vcagan_torch.nn.common import INV_SQRT2, Conv2d, LeakyReLU, Linear, leaky_relu, rounded
from vcagan_torch.nn.audio_front import AudioFront
from vcagan_torch.runtime import compute_dtype

PHASE_BLOCKS = {"1": 2, "2": 3, "3": 4}


def _wanted(ctx, i: int) -> bool:
    """Whether the running backward uses the gradient of input ``i`` of a
    custom Function's node: where the engine reports that it will not
    execute the input's node (``autograd.grad`` into other inputs), no.  A
    leaf that ``autograd.grad`` captures is one it will not report on, so
    that, and anything the engine cannot say, counts as used."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    try:
        return bool(torch._C._will_engine_execute_node(node))
    except (AttributeError, RuntimeError):
        return True


class _Conv2dTwice(torch.autograd.Function):
    """A stride-1, dilation-1, one-group 2-D convolution whose backward is
    differentiable ops: the input gradient is ``conv_transpose2d`` (cuDNN's
    backward-data, as for ``F.conv2d``), so a backward taken with a graph
    differentiates again through ``conv_transpose2d``'s own backward.  The
    weight and bias gradients are ``aten.convolution_backward``'s, each
    computed only where the running backward uses it (``_wanted``): R1's
    gradient into the mel needs no weight gradient, nor does the G
    backward through the discriminators."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        tracing.count("disc_conv.calls")
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        ctx.bias_size = None if bias is None else list(bias.shape)
        return F.conv2d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        if torch.is_grad_enabled():
            tracing.count("disc_conv.graph_backwards")
        grad_x = grad_w = grad_b = None
        if _wanted(ctx, 0):
            grad_x = F.conv_transpose2d(grad, weight, padding=ctx.padding)
        want_w, want_b = _wanted(ctx, 1), _wanted(ctx, 2)
        if want_w or want_b:
            _, grad_w, grad_b = torch.ops.aten.convolution_backward(
                grad, x, weight, ctx.bias_size, [1, 1], list(ctx.padding), [1, 1], False,
                [0, 0], 1, [False, want_w, want_b])
        return grad_x, grad_w, grad_b, None


def conv2d_twice(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` for stride 1, dilation 1, one group and zero padding
    (``int`` or a pair), through ``_Conv2dTwice``; anything else raises."""
    if _pair(stride) != (1, 1) or _pair(dilation) != (1, 1) or groups != 1:
        raise ValueError(f"conv2d_twice takes stride 1, dilation 1 and one group, not stride "
                         f"{stride}, dilation {dilation}, groups {groups}")
    if isinstance(padding, str) or len(_pair(padding)) != 2:
        raise ValueError(f"conv2d_twice takes an int or a pair of padding, not {padding!r}")
    return _Conv2dTwice.apply(x, weight, bias, _pair(padding))


class DiscConv2d(Conv2d):
    """A discriminator convolution: ``Conv2d`` (input, weight and bias cast
    to the compute dtype; on the CPU a bf16 convolution in fp32 on the
    rounded operands) on ``conv2d_twice``, so that R1's second derivative
    runs on cuDNN's weight-gradient kernels.  Counters (``vcagan_torch.
    tracing``): ``disc_conv.calls`` a forward (a recompute's too),
    ``disc_conv.graph_backwards`` a backward taken with a graph."""

    def _conv_forward(self, x, weight, bias):
        if self.padding_mode != "zeros":
            raise ValueError(f"DiscConv2d pads with zeros, not {self.padding_mode!r}")
        return conv2d_twice(x, weight, bias, self.stride, self.padding, self.dilation,
                            self.groups)


class ResBlk(nn.Module):
    """LReLU-conv5 (+ 2x2 average pool) twice, a learned 1x1 shortcut on a
    channel change, scaled by 1/sqrt(2) (``vcagan/nn/discriminator.py:27-62``)."""

    def __init__(self, in_channels: int, out_channels: int, downsample: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample = downsample
        self.conv1 = DiscConv2d(in_channels, in_channels, 5, padding=2, compute_dtype=dtype)
        self.conv2 = DiscConv2d(in_channels, out_channels, 5, padding=2, compute_dtype=dtype)
        self.conv1x1 = None
        if in_channels != out_channels:
            self.conv1x1 = DiscConv2d(in_channels, out_channels, 1, bias=False,
                                      compute_dtype=dtype)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 2) if self.downsample else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(leaky_relu(self._pool(self.conv1(leaky_relu(x)))))
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        h = h + self._pool(sc)
        return h * rounded(INV_SQRT2, h.dtype)


class SpatialMean(nn.Module):
    """(B, C, H, W) -> (B, C): the heads' global average."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class Discriminator(nn.Module):
    """One scale of the mel discriminator (``vcagan/nn/discriminator.py:65-130``).
    ``phase`` "1"/"2"/"3" takes the (20, T) / (40, 2T) / (80, 4T) mel through
    2/3/4 downsampling blocks to a (ch, 5, T/4) map; two heads, one
    unconditional and one conditioned on the time mean of ``sent``."""

    def __init__(self, phase: str = "1", config: ModelConfig | None = None,
                 sent_dim: int = 512, num_class: int = 1):
        super().__init__()
        m = config or ModelConfig()
        dtype = compute_dtype(m)
        self.phase = phase
        self.repeat = PHASE_BLOCKS[phase]
        ch = m.disc_base_channels
        layers: list[nn.Module] = [DiscConv2d(1, ch, 5, padding=2, compute_dtype=dtype)]
        for _ in range(self.repeat):
            out = min(ch * 2, m.disc_max_channels)
            layers.append(ResBlk(ch, out, dtype=dtype))
            ch = out
        self.main = nn.Sequential(*layers)
        self.uncond = nn.Sequential(
            LeakyReLU(), DiscConv2d(ch, ch, 5, compute_dtype=dtype), LeakyReLU(), SpatialMean(),
            Linear(ch, num_class),
        )
        self.cond = nn.Sequential(
            LeakyReLU(), DiscConv2d(ch + sent_dim, ch, 5, padding=2, compute_dtype=dtype),
            LeakyReLU(), DiscConv2d(ch, ch, 5, compute_dtype=dtype), LeakyReLU(), SpatialMean(),
            Linear(ch, num_class),
        )

    def forward(self, mel: torch.Tensor, sent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel (B, F, T), sent (B, T_v, 512) -> unconditional and conditional
        logits, (B, num_class) each."""
        need = 5 * 2 ** self.repeat
        if mel.shape[2] // 2 ** self.repeat < 5:
            raise ValueError(
                f"Discriminator phase {self.phase}: time dim {mel.shape[2]} downsamples below "
                f"the 5x5 VALID head (needs >= {need} mel frames, i.e. video window >= 20 frames)"
            )
        x = self.main(mel[:, None])
        b, _, h, w = x.shape
        c = sent.mean(dim=1)[:, :, None, None].expand(b, sent.shape[2], h, w)
        return self.uncond(x), self.cond(torch.cat([x, c.to(x.dtype)], dim=1))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis (``vcagan/nn/discriminator.py:192-194``)."""
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=eps)


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """sum(a*b) / max(||a|| ||b||, eps) over the last axis (``:197-202``)."""
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return (a * b).sum(-1) / torch.clamp(den, min=eps)


class SyncDiscriminator(AudioFront):
    """Audio-visual sync critic (``vcagan/nn/discriminator.py:131-190``): the
    reference audio front (128/256 channels, k = 3, plain-ReLU block) maps
    the mel (B, 80, 4S) to 512-d features, one per video frame, and
    ``forward`` gives the per-sample loss against ``v_feat``."""

    def __init__(self, config: ModelConfig | None = None, n_mels: int = 80):
        m = config or ModelConfig()
        super().__init__(128, 256, m.feature_dim, 3, "relu", n_mels, compute_dtype(m))
        self.temp = m.sync_temp

    def forward(self, v_feat: torch.Tensor, mel: torch.Tensor, gen: bool = False) -> torch.Tensor:
        """v_feat (B, S, 512), mel (B, 80, 4S) -> (B,): symmetric InfoNCE
        over the cosine matrix / temp; with ``gen``, 5 - mean |cos|."""
        a_feat = super().forward(mel)
        if gen:
            return 5.0 - cosine(v_feat, a_feat).abs().mean(dim=1)
        v_n, a_n = l2_normalize(v_feat), l2_normalize(a_feat)  # bf16 phon in bf16, fp32 a_feat
        dtype = torch.promote_types(v_n.dtype, a_n.dtype)
        sim = torch.einsum("bsd,btd->bst", v_n.to(dtype), a_n.to(dtype)) / self.temp
        nce_va = torch.diagonal(torch.log_softmax(sim, dim=2), dim1=1, dim2=2).mean(dim=1)
        nce_av = torch.diagonal(torch.log_softmax(sim, dim=1), dim1=1, dim2=2).mean(dim=1)
        return -0.5 * (nce_va + nce_av)
