"""Plain PyTorch reference of the adversarial train step.

One step, in the order of the reference recipe: a generator-side forward in
train mode (the decoder's noise, then the dropout masks after the trunk and
between the GRU layers, drawn in that order from the step's generator); the
D loss (real logits with R1 through a second-order gradient, fake logits,
the sync critic's InfoNCE on the real mel with a live ``phon``) and its
gradient into the discriminators and ``phon``; the D update; the G loss with
the updated discriminators (adversarial, the sync critic's cosine on a
detached ``phon``, L1 on three mel scales and on the postnet's spec); the G
update with the D phase's ``phon`` gradient added.  Both optimizers are
optax's chain: decayed weights added to the gradient, Adam or AMSGrad on
bias-corrected moments, -lr.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import dsp, model

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainSpec:
    lr: float
    weight_decay: float
    amsgrad: bool
    recon_weight: float
    sync_dis_weight: float
    recon_on_denormalized: bool


class Adam:
    def __init__(self, params: List[torch.Tensor], spec: TrainSpec):
        self.params, self.spec, self.count = params, spec, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.nu_max = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            g = g + self.spec.weight_decay * p
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            nu_hat = nu / c2
            if self.spec.amsgrad:
                torch.maximum(nu_max, nu_hat, out=nu_max)
                nu_hat = nu_max
            p.sub_(self.spec.lr * (mu / c1) / (nu_hat.sqrt() + EPS))


def gan_loss(logits, real):
    return F.softplus(-logits if real else logits).mean()


def mel_pyramid(mel):
    f, t = mel.shape[1:]
    return tuple(F.interpolate(mel[:, None], size=(f // k, t // k), mode="bilinear",
                               align_corners=False, antialias=True)[:, 0] for k in (4, 2))


def l1(a, b):
    return (a - b).abs().mean()


class TrainStep:
    """Holds the seven reference modules and both optimizers; ``__call__``
    makes one step on (video, mel, spec, vid_len, mel_len) and returns the
    two losses (0-dim tensors)."""

    def __init__(self, modules: Dict[str, torch.nn.Module], spec: TrainSpec, widths: model.Widths):
        self.m, self.spec, self.w = modules, spec, widths
        self.g_params = [p for n in model.GENERATOR_SIDE for p in modules[n].parameters()]
        self.d_params = [p for n in model.DISCRIMINATOR_SIDE for p in modules[n].parameters()]
        self.g_opt, self.d_opt = Adam(self.g_params, spec), Adam(self.d_params, spec)

    def __call__(self, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        m, spec = self.m, self.spec
        video, mel, lin, vid_len, _ = batch
        b, w = video.shape[:2]
        noise = torch.randn((b, self.w.mel_base_bins, w, self.w.noise_dim), device=video.device,
                            generator=model.drawn_by(generator, video))
        phon, sent = m["v_front"](video, True, generator)
        gens = m["gen"](sent, phon, vid_len, noise, training=True)
        sent_sg = sent.detach()
        mels = (*mel_pyramid(mel), mel)
        dis = [m["dis1"], m["dis2"], m["dis3"]]

        real, r1, fake = [], [], []
        for d, mel_k in zip(dis, mels):
            x = mel_k.detach().requires_grad_()
            u, c = d(x, sent_sg)
            real.append(gan_loss(u, True) + gan_loss(c, True))
            (g,) = torch.autograd.grad(u.sum(), x, create_graph=True)
            r1.append(g.flatten(1).square().sum(1).mean())
        for d, g_k in zip(dis, gens):
            u, c = d(g_k.detach(), sent_sg)
            fake.append(gan_loss(u, False) + gan_loss(c, False))
        sync = m["s_dis"](phon, mels[2]).mean()
        dis_loss = (sum(real) + sum(r1) + sum(fake)) / 3.0 + spec.sync_dis_weight * sync
        grads = torch.autograd.grad(dis_loss, self.d_params + [phon], allow_unused=True)
        d_grads = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(self.d_params, grads[:-1])]
        dphon = grads[-1]
        self.d_opt.update(d_grads)
        del d_grads, grads

        post = m["post"](gens[2], training=True)
        adv = sum(gan_loss(u, True) + gan_loss(c, True)
                  for u, c in (d(g_k, sent_sg) for d, g_k in zip(dis, gens)))
        g_sync = m["s_dis"](phon.detach(), gens[2], gen=True).mean()
        g_adv = adv / 3.0 + g_sync
        if spec.recon_on_denormalized:
            recon = sum(l1(dsp.mel_denormalize(g), dsp.mel_denormalize(t))
                        for g, t in zip(gens, mels)) / 3.0
        else:
            recon = sum(l1(g, t) for g, t in zip(gens, mels)) / 3.0
        recon = recon + l1(post, lin)
        gen_loss = g_adv + spec.recon_weight * recon
        grads = torch.autograd.grad([gen_loss, phon], self.g_params, [None, dphon],
                                    allow_unused=True)
        self.g_opt.update([torch.zeros_like(p) if g is None else g
                           for p, g in zip(self.g_params, grads)])
        return {"dis_loss": dis_loss.detach(), "gen_loss": gen_loss.detach()}
