"""Plain PyTorch reference of VCA-GAN's seven modules, in float32.

A frozen copy of the model's mathematics, written with plain ``torch``
operations and no kernel: the visual front (3-D stem, ResNet-18 trunk,
biGRU), the decoder with its two length-masked attentions, the postnet,
the three mel discriminators and the sync critic.  The parameter names are
those of the state dicts the benchmark hands to the program, so one dict
loads into both.  It imports nothing of the program.

``quant`` rounds the operands of every convolution and product (a
``Quant``); the default keeps float32, ``Quant("fp8")`` is the control
that computes them in fp8 (e4m3, one scale a tensor).  Run the reference
with TF32 off (``plain_numerics``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LEAKY = 0.2
INV_SQRT2 = 1.0 / math.sqrt(2.0)
NEG_INF = -1e30


def plain_numerics() -> None:
    """float32 products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to an fp8 ``dtype`` under one scale a tensor (amax -> the
    type's largest finite value)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """The operand of a product in fp8 as fp8 training computes it: e4m3
    forward, its gradient rounded to e5m2 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


class Quant:
    """The precision of the reference's products: "fp32" keeps operands as
    they are; "fp8" rounds each operand to e4m3 first."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32" or x.device.type == "meta":
            return x
        return _RoundFp8.apply(x)


class Ref(nn.Module):
    """Base: holds the precision and applies it around convolutions and
    dense products."""

    def __init__(self, quant: Quant):
        super().__init__()
        object.__setattr__(self, "quant", quant)  # not a submodule

    def conv(self, m: nn.modules.conv._ConvNd, x: torch.Tensor) -> torch.Tensor:
        return m._conv_forward(self.quant(x), self.quant(m.weight), m.bias)

    def dense(self, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.quant(x), self.quant(m.weight), m.bias)


def bn(m: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, training: bool) -> torch.Tensor:
    """Eval: the running statistics' affine.  Train: the batch's mean and
    biased variance (the running statistics are not read and not moved)."""
    if training:
        return F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0, BN_EPS)
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, BN_EPS)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout, the keep mask drawn as a float32 Bernoulli tensor
    of x's shape from ``generator``."""
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate,
                                                          generator=drawn_by(generator, x))
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def drawn_by(generator: torch.Generator | None, x: torch.Tensor):
    """``generator``, or None where ``x`` is on the meta device (counting
    work draws nothing)."""
    return None if x.device.type == "meta" else generator


def _bn2(c):
    return nn.BatchNorm2d(c, eps=BN_EPS)


@dataclasses.dataclass(frozen=True)
class Widths:
    """The model's sizes (the configuration file's ``model`` section); the
    defaults are the published ones."""

    stem_channels: int = 64
    feature_dim: int = 512
    gru_hidden: int = 512
    gru_layers: int = 2
    gru_dropout: float = 0.3
    frontend_dropout: float = 0.3
    noise_dim: int = 128
    mel_base_bins: int = 20
    attention_dim: int = 256
    attention_inner: int = 1280
    postnet_channels: int = 256
    linear_bins: int = 321
    disc_base_channels: int = 32
    disc_max_channels: int = 512

    @classmethod
    def of(cls, model: dict) -> "Widths":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in model.items() if k in names})


# ---------------------------------------------------------------- visual front


class BasicBlock(Ref):
    def __init__(self, quant, cin, cout, stride=1, prelu=True):
        super().__init__(quant)
        self.prelu = prelu
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = _bn2(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = _bn2(cout)
        if prelu:
            self.relu1, self.relu2 = nn.PReLU(cout), nn.PReLU(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            _bn2(cout))

    def act(self, i, x):
        return F.prelu(x, getattr(self, f"relu{i}").weight) if self.prelu else F.relu(x)

    def forward(self, x, training):
        out = self.act(1, bn(self.bn1, self.conv(self.conv1, x), training))
        out = bn(self.bn2, self.conv(self.conv2, out), training)
        res = x if self.downsample is None else bn(
            self.downsample[1], self.conv(self.downsample[0], x), training)
        return self.act(2, out + res)


class Trunk(Ref):
    def __init__(self, quant, cin=64):
        super().__init__(quant)
        for stage, (planes, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            blocks = [BasicBlock(quant, cin, planes, stride), BasicBlock(quant, planes, planes)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            cin = planes

    def forward(self, x, training):
        for stage in range(1, 5):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, training)
        return x.mean(dim=(2, 3))


class BiGRU(Ref):
    """Two bidirectional GRU layers written out step by step (gates r|z|n)."""

    def __init__(self, quant, size=512, hidden=512, layers=2):
        super().__init__(quant)
        self.hidden, self.layers = hidden, layers
        for layer in range(layers):
            cin = size if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                self.register_parameter(f"weight_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden, cin)))
                self.register_parameter(f"weight_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden, hidden)))
                self.register_parameter(f"bias_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden)))
                self.register_parameter(f"bias_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden)))

    def direction(self, x, layer, sfx):
        w_ih, w_hh = getattr(self, f"weight_ih_l{layer}{sfx}"), getattr(self, f"weight_hh_l{layer}{sfx}")
        b_ih, b_hh = getattr(self, f"bias_ih_l{layer}{sfx}"), getattr(self, f"bias_hh_l{layer}{sfx}")
        b, t, _ = x.shape
        gi = F.linear(self.quant(x), self.quant(w_ih), b_ih)  # (B, T, 3H)
        w_hh_q = self.quant(w_hh)
        h = x.new_zeros(b, self.hidden)
        steps = range(t - 1, -1, -1) if sfx else range(t)
        out = [None] * t
        for i in steps:
            gh = F.linear(self.quant(h), w_hh_q, b_hh)
            ir, iz, in_ = gi[:, i].chunk(3, dim=1)
            hr, hz, hn = gh.chunk(3, dim=1)
            r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
            n = torch.tanh(in_ + r * hn)
            h = (1.0 - z) * n + z * h
            out[i] = h
        return torch.stack(out, dim=1)

    def forward(self, x, training, generator=None, rate=0.3):
        for layer in range(self.layers):
            if layer and training:
                x = dropout(x, rate, generator)
            x = torch.cat([self.direction(x, layer, ""), self.direction(x, layer, "_reverse")], -1)
        return x


class VisualFront(Ref):
    def __init__(self, quant, w: Widths):
        super().__init__(quant)
        c = w.stem_channels
        self.w = w
        self.frontend = nn.Sequential(
            nn.Conv3d(1, c, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False),
            nn.BatchNorm3d(c, eps=BN_EPS), nn.PReLU(c))
        self.resnet = Trunk(quant, c)
        self.sentence_encoder = BiGRU(quant, w.feature_dim, w.gru_hidden, w.gru_layers)
        self.fc = nn.Linear(2 * w.gru_hidden, w.feature_dim)

    def forward(self, video, training=False, generator=None):
        """video (B, T, H, W, 1) -> phon, sent (B, T, feature_dim)."""
        b, t = video.shape[:2]
        x = self.conv(self.frontend[0], video.permute(0, 4, 1, 2, 3))
        x = F.prelu(bn(self.frontend[1], x, training), self.frontend[2].weight)
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.resnet(x.transpose(1, 2).flatten(0, 1), training)
        if training:
            x = dropout(x, self.w.frontend_dropout, generator)
        phon = x.reshape(b, t, self.w.feature_dim)
        sent = self.dense(self.fc, self.sentence_encoder(phon, training, generator,
                                                         self.w.gru_dropout))
        return phon, sent


# ------------------------------------------------------------- decoder, postnet


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class GenResBlk(Ref):
    def __init__(self, quant, cin, cout, upsample=False):
        super().__init__(quant)
        self.upsample = upsample
        self.norm1 = _bn2(cin)
        self.conv1 = nn.Conv2d(cin, cout, 5, padding=2)
        self.norm2 = _bn2(cout)
        self.conv2 = nn.Conv2d(cout, cout, 5, padding=2)
        self.conv1x1 = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x, training):
        h = lrelu(bn(self.norm1, x, training))
        if self.upsample:
            h = _up2(h)
        h = self.conv(self.conv2, lrelu(bn(self.norm2, self.conv(self.conv1, h), training)))
        sc = _up2(x) if self.upsample else x
        if self.conv1x1 is not None:
            sc = self.conv(self.conv1x1, sc)
        return (h + sc) * INV_SQRT2


class Attention(Ref):
    def __init__(self, quant, cin, dim, inner, sent):
        super().__init__(quant)
        self.k, self.v = nn.Linear(sent, dim), nn.Linear(sent, dim)
        self.q, self.mel = nn.Linear(cin, dim), nn.Linear(dim, inner)

    def forward(self, sent, g, lengths):
        """sent (B, S, 512), g (B, C, F, T) -> (B, inner / F, F, T)."""
        b, c, f, t = g.shape
        k, v = self.dense(self.k, sent), self.dense(self.v, sent)
        q = self.dense(self.q, g.permute(0, 3, 1, 2).reshape(b, t, c * f))
        scores = torch.einsum("btd,bsd->bts", self.quant(q), self.quant(k)) / math.sqrt(q.shape[-1])
        keep = torch.arange(k.shape[1], device=q.device)[None, None, :] < lengths[:, None, None]
        probs = torch.softmax(torch.where(keep, scores, NEG_INF), dim=-1)
        ctx = torch.einsum("bts,bsd->btd", self.quant(probs), self.quant(v))
        return self.dense(self.mel, ctx).reshape(b, t, f, -1).permute(0, 3, 2, 1)


class ToMel(Ref):
    def __init__(self, quant, c):
        super().__init__(quant)
        self.add_module("0", _bn2(c))
        self.add_module("2", nn.Conv2d(c, 1, 1))

    def forward(self, x, training):
        x = lrelu(bn(getattr(self, "0"), x, training))
        return torch.tanh(self.conv(getattr(self, "2"), x))[:, 0]


class Decoder(Ref):
    def __init__(self, quant, w: Widths):
        super().__init__(quant)
        self.w = w
        f1, f2, inner = w.mel_base_bins, 2 * w.mel_base_bins, w.attention_inner

        def stage(plan, up=False):
            return nn.Sequential(*(GenResBlk(quant, a, b, up and i == 0)
                                   for i, (a, b) in enumerate(plan)))

        self.decode = stage([(w.feature_dim + w.noise_dim, 512), (512, 256), (256, 256)])
        self.g1 = stage([(256, 128), (128, 128), (128, 128)])
        self.g2 = stage([(128, 64), (64, 64), (64, 64)], True)
        self.g3 = stage([(64, 32), (32, 32), (32, 32)], True)
        self.att1 = Attention(quant, 128 * f1, w.attention_dim, inner, w.feature_dim)
        self.att2 = Attention(quant, 64 * f2, w.attention_dim, inner, w.feature_dim)
        self.attconv1 = nn.Conv2d(128 + inner // f1, 128, 5, padding=2)
        self.attconv2 = nn.Conv2d(64 + inner // f2, 64, 5, padding=2)
        self.to_mel1, self.to_mel2, self.to_mel3 = ToMel(quant, 128), ToMel(quant, 64), ToMel(quant, 32)

    @staticmethod
    def _run(stage, x, training):
        for block in stage:
            x = block(x, training)
        return x

    def forward(self, sent, phon, lengths, noise, training=False):
        """noise (B, F, T, noise_dim) -> mel1 (B, F, T), mel2 (B, 2F, 2T), mel3 (B, 4F, 4T)."""
        b, t, c = phon.shape
        f = self.w.mel_base_bins
        x = torch.cat([phon.transpose(1, 2)[:, :, None, :].expand(b, c, f, t),
                       noise.permute(0, 3, 1, 2)], dim=1)
        g1 = self._run(self.g1, self._run(self.decode, x, training), training)
        x = self.conv(self.attconv1, torch.cat([g1, self.att1(sent, g1, lengths)], dim=1))
        g2 = self._run(self.g2, x, training)
        x = self.conv(self.attconv2, torch.cat([g2, self.att2(sent, g2, lengths)], dim=1))
        g3 = self._run(self.g3, x, training)
        return (self.to_mel1(g1, training), self.to_mel2(g2, training),
                self.to_mel3(g3, training))


class ResBlk1D(Ref):
    def __init__(self, quant, cin, cout):
        super().__init__(quant)
        self.conv1 = nn.Conv1d(cin, cin, 5, padding=2)
        self.conv2 = nn.Conv1d(cin, cout, 5, padding=2)
        self.conv1x1 = nn.Conv1d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x):
        h = self.conv(self.conv2, lrelu(self.conv(self.conv1, lrelu(x))))
        sc = x if self.conv1x1 is None else self.conv(self.conv1x1, x)
        return (h + sc) * INV_SQRT2


class Postnet(Ref):
    def __init__(self, quant, w: Widths):
        super().__init__(quant)
        ch = w.postnet_channels
        self.postnet = nn.Sequential(
            nn.Conv1d(80, 128, 7, padding=3), nn.BatchNorm1d(128, eps=BN_EPS), nn.Identity(),
            ResBlk1D(quant, 128, ch), ResBlk1D(quant, ch, ch), ResBlk1D(quant, ch, ch),
            nn.Conv1d(ch, w.linear_bins, 1, bias=False))

    def forward(self, mel, training=False):
        """(B, 80, T) -> (B, 321, T)."""
        p = self.postnet
        x = lrelu(bn(p[1], self.conv(p[0], mel), training))
        x = p[5](p[4](p[3](x)))
        return self.conv(p[6], x)


# -------------------------------------------------------------- discriminators


class ResBlk(Ref):
    def __init__(self, quant, cin, cout):
        super().__init__(quant)
        self.conv1 = nn.Conv2d(cin, cin, 5, padding=2)
        self.conv2 = nn.Conv2d(cin, cout, 5, padding=2)
        self.conv1x1 = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x):
        h = self.conv(self.conv2, lrelu(F.avg_pool2d(self.conv(self.conv1, lrelu(x)), 2)))
        sc = x if self.conv1x1 is None else self.conv(self.conv1x1, x)
        return (h + F.avg_pool2d(sc, 2)) * INV_SQRT2


class Discriminator(Ref):
    BLOCKS = {"1": 2, "2": 3, "3": 4}

    def __init__(self, quant, phase, w: Widths):
        super().__init__(quant)
        ch = w.disc_base_channels
        layers: List[nn.Module] = [nn.Conv2d(1, ch, 5, padding=2)]
        for _ in range(self.BLOCKS[phase]):
            layers.append(ResBlk(quant, ch, min(ch * 2, w.disc_max_channels)))
            ch = min(ch * 2, w.disc_max_channels)
        self.main = nn.Sequential(*layers)
        self.uncond = nn.Sequential(nn.Identity(), nn.Conv2d(ch, ch, 5), nn.Identity(),
                                    nn.Identity(), nn.Linear(ch, 1))
        self.cond = nn.Sequential(nn.Identity(), nn.Conv2d(ch + w.feature_dim, ch, 5, padding=2),
                                  nn.Identity(), nn.Conv2d(ch, ch, 5), nn.Identity(),
                                  nn.Identity(), nn.Linear(ch, 1))

    def forward(self, mel, sent) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.conv(self.main[0], mel[:, None])
        for block in list(self.main)[1:]:
            x = block(x)
        b, _, h, w = x.shape
        u = lrelu(self.conv(self.uncond[1], lrelu(x))).mean(dim=(2, 3))
        c = sent.mean(dim=1)[:, :, None, None].expand(b, sent.shape[2], h, w)
        y = lrelu(self.conv(self.cond[1], lrelu(torch.cat([x, c], dim=1))))
        y = lrelu(self.conv(self.cond[3], y)).mean(dim=(2, 3))
        return self.dense(self.uncond[4], u), self.dense(self.cond[6], y)


class SyncDiscriminator(Ref):
    """The audio front (128/256 channels, k 3, a ReLU block) and the
    InfoNCE / cosine losses of the sync critic."""

    def __init__(self, quant, w: Widths):
        super().__init__(quant)
        self.frontend = nn.Sequential(
            nn.Conv2d(1, 128, 3, 2, 1), _bn2(128), nn.PReLU(128),
            nn.Conv2d(128, 256, 3, 2, 1), _bn2(256), nn.PReLU(256))
        self.Res_block = nn.Sequential(BasicBlock(quant, 256, 256, prelu=False))
        self.Linear = nn.Linear(256 * 20, w.feature_dim)

    def features(self, mel, training):
        f = self.frontend
        x = F.prelu(bn(f[1], self.conv(f[0], mel[:, None]), training), f[2].weight)
        x = F.prelu(bn(f[4], self.conv(f[3], x), training), f[5].weight)
        x = self.Res_block[0](x, training)
        return self.dense(self.Linear, x.permute(0, 3, 1, 2).flatten(2))

    def forward(self, v_feat, mel, gen=False, training=True):
        a = self.features(mel, training)
        if gen:
            den = torch.clamp(torch.linalg.vector_norm(v_feat, dim=-1)
                              * torch.linalg.vector_norm(a, dim=-1), min=1e-8)
            return 5.0 - ((v_feat * a).sum(-1) / den).abs().mean(dim=1)

        def unit(x):
            return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=1e-12)

        sim = torch.einsum("bsd,btd->bst", unit(v_feat), unit(a))
        va = torch.diagonal(torch.log_softmax(sim, dim=2), dim1=1, dim2=2).mean(dim=1)
        av = torch.diagonal(torch.log_softmax(sim, dim=1), dim1=1, dim2=2).mean(dim=1)
        return -0.5 * (va + av)


GENERATOR_SIDE = ("v_front", "gen", "post")
DISCRIMINATOR_SIDE = ("dis1", "dis2", "dis3", "s_dis")


def build(names, widths: Widths, quant: Quant | None = None, device="meta") -> dict:
    """The reference modules named (of ``GENERATOR_SIDE`` and
    ``DISCRIMINATOR_SIDE``), their parameters uninitialised on ``device``."""
    q, w = quant or Quant(), widths
    make = {"v_front": lambda: VisualFront(q, w), "gen": lambda: Decoder(q, w),
            "post": lambda: Postnet(q, w), "s_dis": lambda: SyncDiscriminator(q, w),
            **{f"dis{p}": (lambda p=p: Discriminator(q, p, w)) for p in "123"}}
    with torch.device(device):
        return {name: make[name]() for name in names}


def load(names, widths: Widths, states, device, quant: Quant | None = None,
         training: bool = False) -> dict:
    """The reference modules named, holding copies of ``states`` on ``device``."""
    mods = build(names, widths, quant)
    for name, m in mods.items():
        m.load_state_dict({k: v.to(device, copy=True) for k, v in states[name].items()},
                          strict=True, assign=True)
        m.train(training)
    return mods
