"""The adversarial train step.

Port of ``vcagan/train/step.py`` (reference GRID/LRS step,
``train.py:155-237``, ``train_LRS.py:168-248``), in fp32 with TF32 off or
with the modules in bf16 (``ModelConfig.use_bfloat16``), in the JAX step's
order of work:

1. one generator-side forward in train mode (visual front, decoder), its
   dropout masks and the decoder's noise drawn from the step's generator.
   The JAX step traces it twice and XLA merges the two, so its BatchNorm
   statistics move once a step; here it runs once;
2. the D loss: real logits, R1 and fake logits at three mel scales with
   ``g`` and ``sent`` detached, plus ``sync_dis_weight`` x the sync
   critic's InfoNCE on the real mel with a live ``phon``; its gradient
   reaches the discriminators and, through ``phon``, the visual front: the
   reference's deliberate leak (``train.py:210``), which the G update adds
   in when ``sync_leak``;
3. the D update;
4. the G loss with the updated D: adversarial at three scales, gen-mode sync
   on a detached ``phon``, L1 reconstruction at three scales (on
   denormalised mels for GRID) plus L1 of the postnet against ``spec``;
5. the G update, with the leaked gradients added.

In bf16 every loss is fp32, as in the JAX step (``vcagan/train/step.py:22``):
the discriminators' logits and the sync critic's features come out of fp32
dense layers, R1 differentiates into the fp32 mel (its gradient and square
are fp32), and the L1 terms cast both sides.  The attention stays fp32.

The sync critic runs in both phases, so its statistics move twice a step
(real mel, then ``g3``), as in the reference.  Gradients are taken with
``torch.autograd.grad`` into lists: nothing accumulates in ``.grad``.
``d_phase`` and ``remat`` change how the D loss is batched and which
activations the backward recomputes, not the step's results
(``make_train_step``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vcagan_torch.configs import TrainConfig
from vcagan_torch.dsp.audio import mel_denormalize
from vcagan_torch.nn.common import fp32_or_wider, recomputed
from vcagan_torch.nn.losses import gan_loss, joint_r1_penalties, r1_penalty
from vcagan_torch.parallel.collectives import all_reduce_mean_, mean_metrics
from vcagan_torch.parallel.mesh import DataLayout, draw_rows
from vcagan_torch.tracing import span
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE, VCAGANModules
from vcagan_torch.train.state import GANTrainState, Optimizer

Metrics = Dict[str, torch.Tensor]


class Batch(NamedTuple):
    """One training batch, padded to static shapes.

    video:   (B, W, 112, 112, 1) normalised grey frames
    mel:     (B, 80, 4W) normalised log-mel in [-1, 1]
    spec:    (B, 321, 4W) linear magnitudes (GRID) / normalised (LRS)
    vid_len: (B,) int32 true video frame counts
    mel_len: (B,) int32 true mel frame counts
    """

    video: torch.Tensor
    mel: torch.Tensor
    spec: torch.Tensor
    vid_len: torch.Tensor
    mel_len: torch.Tensor

    def to(self, device) -> "Batch":
        return Batch(*(x.to(device) for x in self))


def mel_pyramid(mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 80, T) -> the quarter- and half-scale mels.  ``jax.image.resize``
    (``vcagan/train/step.py:58-66``) antialiases when it downsamples, which
    is ``antialias=True`` here."""
    b, f, t = mel.shape
    img = mel[:, None]
    return tuple(
        F.interpolate(img, size=(f // k, t // k), mode="bilinear", align_corners=False,
                      antialias=True)[:, 0]
        for k in (4, 2)
    )


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (fp32_or_wider(a) - fp32_or_wider(b)).abs().mean()


def _global_norm(grads: Sequence[torch.Tensor], split: Sequence[bool] = (),
                 model_group=None) -> torch.Tensor:
    """The L2 norm over all of ``grads``.  Where ``split[i]`` marks a leaf
    that holds only this rank's columns, its squared norm is summed over
    ``model_group`` first, so the norm is the whole gradient's."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group is None or not any(split):
        return torch.linalg.vector_norm(norms)
    squares = norms.square()
    mask = torch.tensor(split, device=norms.device)
    split_sum = squares[mask].sum()
    with span("model_axis.norm_sum"):
        dist.all_reduce(split_sum, group=model_group)
    return torch.sqrt(squares[~mask].sum() + split_sum)


def _split_mask(modules: VCAGANModules, params: Sequence[torch.Tensor]) -> List[bool]:
    """For each of ``params``, whether it holds only some of its ``Linear``'s
    output columns (the model axis's split, ``vcagan_torch/parallel/shard.py``)."""
    sliced = {id(m.weight) for _, module in modules.named(GENERATOR_SIDE)
              for m in module.modules()
              if isinstance(m, nn.Linear) and m.weight.shape[0] != m.out_features}
    return [id(p) in sliced for p in params]


def _grads(outputs: Sequence[torch.Tensor], params: List[torch.Tensor],
           grad_outputs: Sequence[torch.Tensor | None] | None = None) -> List[torch.Tensor]:
    """The vector-Jacobian product of ``outputs`` (a scalar loss, or several
    with ``grad_outputs``) into ``params``; a parameter the outputs do not
    reach gets zeros, as in JAX."""
    grads = torch.autograd.grad(outputs, params, grad_outputs, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def parse_remat(remat: str) -> frozenset:
    """The remat sites of ``remat`` as the JAX step reads them
    (``vcagan/train/step.py:155-166``): comma-separated, blanks dropped,
    "none" ignored; an unknown site, or "vfront" with "stem", raises."""
    sites = {tok.strip() for tok in remat.split(",") if tok.strip()}
    unknown = sites - {"none", "vfront", "stem", "r1"}
    if unknown:
        raise ValueError(f"unknown remat site(s) {sorted(unknown)}; valid: none, vfront, stem, r1")
    if {"vfront", "stem"} <= sites:
        raise ValueError("remat sites 'vfront' and 'stem' are mutually exclusive "
                         "('vfront' already drops everything 'stem' drops)")
    return frozenset(sites - {"none"})


def make_train_step(
    modules: VCAGANModules,
    g_tx: Optimizer,
    d_tx: Optimizer,
    config: TrainConfig | None = None,
    donate: bool = True,
    sync_leak: bool = True,
    mesh=None,
    remat: str = "none",
    compiler_options="auto",
    d_phase: str = "ref",
    on_phase: Callable[[str], None] | None = None,
):
    """Returns ``step(state, batch, generator) -> (state, metrics)``, which
    updates the modules and optimizer states in place; the metrics are
    0-dim tensors on the device (no sync).  ``sync_leak=False`` leaves the
    D phase's sync gradient out of the visual front's update.
    ``on_phase(name)``, where given, is called as each part ends:
    "gen_forward", "d_loss", "d_backward", "d_update", "g_loss",
    "g_backward", "g_update" (the D phase is d_loss + d_backward, the G
    phase g_loss + g_backward).  A step is traced (``vcagan_torch.tracing``)
    as the span ``train.step`` and, inside it, one span a part,
    ``train.<name>``, each ending where ``on_phase(name)`` is called, so
    that the parts follow each other and cover the step.

    ``mesh``: a layout (``vcagan_torch.parallel.DataLayout``) with a
    process group, each rank stepping on its data index's rows of the
    global batch.  The step then runs under the layout (BatchNorm over the
    global batch, draws at its shape, the split attention projections over
    the model group), takes the mean of the D gradients and of the G
    gradients (the leaked ``phon`` gradient joined in; ``dphon`` itself is
    local), so the gradient norms are the reduced gradients' (a split
    leaf's square summed over the model group), and returns the metrics'
    means; ``on_phase`` is then also called with "d_reduce" and "g_reduce"
    after each reduction.  A split leaf's gradient is averaged over the
    data group; every other gradient, and the metrics, over the world.
    Over the world the model ranks' copies of one data index's gradient
    add M times and the mean divides by M: the data group's mean in exact
    arithmetic, and the same bits on every rank where the copies differ in
    their last bits (the card's backward convolutions sum in no fixed
    order), so the replicated leaves stay equal.

    ``d_phase`` (``vcagan/train/step.py:236-275``), the same mathematics
    either way: "ref" runs a real and a fake discriminator forward a scale,
    R1 differentiating the real one, one R1 input gradient a scale;
    "batched" runs one forward a scale on the 2B batch [real mel;
    fake.detach()] with ``sent`` doubled, the real and fake terms sliced
    from its logits (the discriminators are norm-free and work per sample,
    so slicing is exact), and R1 on a B-row forward of the real mels a
    scale, the three penalties from one input gradient over the three
    jointly, as the JAX step's ``_r1_terms_joint``.  Taking R1 from the
    real rows of the 2B forward instead (one forward a scale) ran slower
    on an H100: the penalty's double backward then runs over all 2B rows,
    the fake half's with zero gradients (chip_smoke.py phase 15, the GRID
    fp32 step 2755.8 ms against 2394.2 for "ref", bf16 581.8 against
    481.1).  With bf16 modules the concatenation promotes the bf16 fake
    mel to fp32, as ``jnp.concatenate`` does; the first convolution casts
    both halves to bf16, as in "ref".

    ``remat``: comma-separated sites whose activations the backward
    recomputes instead of holding (``parse_remat``; ``nn.common.
    recomputed``): "stem" the visual front's stem chain, "vfront" the whole
    visual front call, "r1" each discriminator forward that R1
    differentiates ("ref": the shared real forward a scale; "batched": the
    B-row R1 forward); "r1" combines with either of the others.  The step's
    results do not change: dropout masks are redrawn as at the forward and
    the generator ends where it would without remat, and BatchNorm
    statistics move once.  With the sync leak the D backward stops at
    ``phon``, so the "stem" and "vfront" regions recompute once a step, in
    the G backward.  An "r1" region recomputes twice a step: once for R1's
    input gradient and once in the D backward, which needs the forward's
    activations again (two backward passes; a checkpoint recomputes for
    each one that reaches it).

    ``donate`` is accepted either way: the step updates the state in
    place, which is what the JAX step's buffer donation buys.
    ``compiler_options``: "auto" and None are accepted (off the TPU the
    JAX package's "auto" is None, ``_tpu_compiler_options``); a dict of
    XLA options raises, there being no XLA compiler to pass it to."""
    cfg = config or TrainConfig()
    sites = parse_remat(remat)
    if d_phase not in ("ref", "batched"):
        raise ValueError(f"unknown d_phase {d_phase!r}; valid: ref, batched")
    if compiler_options not in ("auto", None):
        raise ValueError(f"compiler_options={compiler_options!r}: XLA compiler options have "
                         "no compiler to go to in the port; pass \"auto\" or None")
    if mesh is not None and not (isinstance(mesh, DataLayout) and mesh.group is not None):
        raise ValueError(f"mesh={mesh!r} is not ported: the port's mesh is a DataLayout "
                         "with a process group (vcagan_torch.parallel.make_layout)")
    group = None if mesh is None else mesh.group
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    mark = on_phase or (lambda name: None)
    dis = (modules.dis1, modules.dis2, modules.dis3)
    g_params = modules.parameters(GENERATOR_SIDE)  # v_front's first
    d_params = modules.parameters(DISCRIMINATOR_SIDE)

    def discriminate(d, x, sent):
        return recomputed("r1", d, x, sent) if "r1" in sites else d(x, sent)

    def visual_front(video, generator):
        if "vfront" in sites:
            return recomputed("vfront", modules.v_front, video, generator, generator=generator)
        return modules.v_front(video, generator, remat_stem="stem" in sites)

    def gan_terms_ref(sent_sg, mels, gens):
        real_terms, r1_terms, fake_terms = [], [], []
        for d, mel_k in zip(dis, mels):
            x = mel_k.detach().requires_grad_()
            u, c = discriminate(d, x, sent_sg)
            real_terms.append(gan_loss(u, real=True) + gan_loss(c, real=True))
            r1_terms.append(r1_penalty(u, x))
        for d, g_k in zip(dis, gens):
            u, c = d(g_k.detach(), sent_sg)
            fake_terms.append(gan_loss(u, real=False) + gan_loss(c, real=False))
        return real_terms, r1_terms, fake_terms

    def gan_terms_batched(sent_sg, mels, gens):
        b = sent_sg.shape[0]
        sent2 = torch.cat([sent_sg, sent_sg])
        real_terms, fake_terms = [], []
        for d, mel_k, g_k in zip(dis, mels, gens):
            u, c = d(torch.cat([mel_k.detach(), g_k.detach()]), sent2)
            real_terms.append(gan_loss(u[:b], real=True) + gan_loss(c[:b], real=True))
            fake_terms.append(gan_loss(u[b:], real=False) + gan_loss(c[b:], real=False))
        reals = [mel_k.detach().requires_grad_() for mel_k in mels]
        logits = [discriminate(d, x, sent_sg)[0] for d, x in zip(dis, reals)]
        return real_terms, joint_r1_penalties(logits, reals), fake_terms

    gan_terms = gan_terms_batched if d_phase == "batched" else gan_terms_ref

    def d_loss(phon, sent_sg, mels, gens):
        real_terms, r1_terms, fake_terms = gan_terms(sent_sg, mels, gens)
        # the only D-phase path into the visual front (reference train.py:186,210)
        sync_loss = modules.s_dis(phon if sync_leak else phon.detach(), mels[2]).mean()
        r1 = sum(r1_terms) / 3.0
        dis_loss = (sum(real_terms) / 3.0 + r1 + sum(fake_terms) / 3.0
                    + cfg.sync_dis_weight * sync_loss)
        return dis_loss, {"d_sync_loss": sync_loss.detach(), "r1": r1.detach()}

    def g_loss(phon, sent_sg, mels, gens, spec):
        gs = modules.post(gens[2])
        adv = sum(gan_loss(u, real=True) + gan_loss(c, real=True)
                  for u, c in (d(g_k, sent_sg) for d, g_k in zip(dis, gens)))
        g_sync_loss = modules.s_dis(phon.detach(), gens[2], gen=True).mean()
        g_adv = adv / 3.0 + g_sync_loss
        if cfg.recon_on_denormalized:  # GRID (reference train.py:226-228)
            recon = sum(_l1(mel_denormalize(g), mel_denormalize(m))
                        for g, m in zip(gens, mels)) / 3.0
        else:  # LRS (reference train_LRS.py:233-235)
            recon = sum(_l1(g, m) for g, m in zip(gens, mels)) / 3.0
        recon = recon + _l1(gs, spec)
        gen_loss = g_adv + cfg.recon_weight * recon
        return gen_loss, {"g_loss": g_adv.detach(), "recon_loss": recon.detach(),
                          "g_sync_loss": g_sync_loss.detach()}

    def step(state: GANTrainState, batch: Batch, generator: torch.Generator
             ) -> tuple[GANTrainState, Metrics]:
        if state.modules is not modules:
            raise ValueError("the state holds other modules than this step's")
        with span("train.step"), contextlib.nullcontext() if mesh is None else mesh.active():
            return local_step(state, batch, generator)

    def local_step(state: GANTrainState, batch: Batch, generator: torch.Generator
                   ) -> tuple[GANTrainState, Metrics]:
        with span("train.gen_forward"):
            b, w = batch.video.shape[:2]
            gen = modules.gen
            noise = draw_rows(lambda n: torch.randn((n, gen.base_bins, w, gen.noise_dim),
                                                    generator=generator,
                                                    device=batch.video.device), b)
            phon, sent = visual_front(batch.video, generator)
            gens = gen(sent, phon, batch.vid_len, noise=noise)
            sent_sg = sent.detach()
            mels = (*mel_pyramid(batch.mel), batch.mel)
        mark("gen_forward")

        with span("train.d_loss"):
            dis_loss, d_aux = d_loss(phon, sent_sg, mels, gens)
        mark("d_loss")
        with span("train.d_backward"):
            # with the leak the backward stops at phon, whose gradient the G
            # phase's backward carries on through the visual front
            grads = _grads([dis_loss], d_params + [phon] if sync_leak else d_params)
            d_grads, dphon = grads[:len(d_params)], grads[len(d_params):]
            dis_loss = dis_loss.detach()  # frees the D phase's graph
        mark("d_backward")
        if group is not None:
            with span("train.d_reduce"):
                all_reduce_mean_(d_grads, group)
            mark("d_reduce")
        with span("train.d_update"):
            d_grad_norm = _global_norm(d_grads)
            d_tx.update(d_grads, state.d_opt_state, d_params)
            del d_grads
        mark("d_update")

        with span("train.g_loss"):
            gen_loss, g_aux = g_loss(phon, sent_sg, mels, gens, batch.spec)
        mark("g_loss")
        with span("train.g_backward"):
            if sync_leak:  # reference train.py:210 "accumulate v_front grad"
                g_grads = _grads([gen_loss, phon], g_params, [None, dphon[0]])
            else:
                g_grads = _grads([gen_loss], g_params)
            split = _split_mask(modules, g_params)
        mark("g_backward")
        if group is not None:
            with span("train.g_reduce"):
                all_reduce_mean_([g for g, s in zip(g_grads, split) if not s], group)
                if any(split):
                    all_reduce_mean_([g for g, s in zip(g_grads, split) if s], data_group)
            mark("g_reduce")
        with span("train.g_update"):
            g_grad_norm = _global_norm(g_grads, split, model_group)
            g_tx.update(g_grads, state.g_opt_state, g_params)
        mark("g_update")

        state.step += 1
        metrics = {
            "dis_loss": dis_loss,
            "gen_loss": gen_loss.detach(),
            **g_aux,
            **d_aux,
            "g_grad_norm": g_grad_norm,
            "d_grad_norm": d_grad_norm,
        }
        if group is not None:
            metrics = mean_metrics(metrics, group)
        return state, metrics

    return step


def make_eval_step(modules: VCAGANModules, flip_tta: bool = False):
    """Inference forward of ``vcagan/train/step.py:479-532``: video -> (g3
    mel, postnet spec), the generator side in eval mode under no_grad (its
    train/eval modes are put back after).  With ``flip_tta`` g3 is the mean
    over the clip and its width-flipped copy (reference test.py:131-140).

    Returns ``eval_step(video, vid_len, generator, noise=None)``; ``noise``
    (2, B, 20, T, 128), optional, replaces the two passes' draws from
    ``generator`` (the first pass takes ``noise[0]``)."""
    side = [module for _, module in modules.named(GENERATOR_SIDE)]

    @torch.no_grad()
    def eval_step(video: torch.Tensor, vid_len: torch.Tensor, generator: torch.Generator,
                  noise: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        modes = [module.training for module in side]
        try:
            for module in side:
                module.eval()

            def forward(vid, n):
                phon, sent = modules.v_front(vid)
                return modules.gen(sent, phon, vid_len, noise=n, generator=generator)[2]

            g3 = forward(video, None if noise is None else noise[0])
            if flip_tta:
                g3_flip = forward(video.flip(3), None if noise is None else noise[1])
                g3 = (g3 + g3_flip) / 2.0
            return g3, modules.post(g3)
        finally:
            for module, mode in zip(side, modes):
                module.train(mode)

    return eval_step
