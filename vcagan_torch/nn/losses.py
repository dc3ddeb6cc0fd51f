"""GAN losses: the non-saturating softplus loss and the R1 gradient penalty.

Port of ``vcagan/nn/losses.py:19-36`` and of the joint penalties of
``vcagan/train/step.py:254-275`` (reference ``generator.py:363-366``
and ``train.py:188-194``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


def gan_loss(logits: torch.Tensor, real: bool) -> torch.Tensor:
    """mean softplus(-x) for real targets, mean softplus(x) for fake."""
    return F.softplus(-logits if real else logits).mean()


def r1_penalty(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batch mean of ||d sum(logits) / d x||^2 per sample, ``logits`` the
    per-sample logits computed from ``x`` (which requires grad).  The
    gradient is taken with ``create_graph=True``, so the penalty
    differentiates again into the discriminator's parameters.  The
    discriminators' convolutions are ``DiscConv2d``
    (``vcagan_torch/nn/discriminator.py``): this gradient runs through
    their ``conv_transpose2d`` (cuDNN's backward-data) and takes no weight
    gradient, and the second derivative into the weights is
    ``conv_transpose2d``'s backward, cuDNN's weight-gradient and forward
    convolutions, not PyTorch's ``_convolution_double_backward``.  The JAX
    function takes the logit function and runs its own forward; here the
    caller's forward, which also gives the real-logit loss, is shared."""
    (grad,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    return grad.flatten(1).square().sum(1).mean()


def joint_r1_penalties(logits: Sequence[torch.Tensor],
                       xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``r1_penalty`` of each (``logits[i]``, ``xs[i]``) pair, from one
    gradient of the logits' total sum into all of ``xs`` jointly: each
    ``xs[i]`` reaches only its own logits, so each gradient is the one
    ``r1_penalty`` takes, in one backward pass instead of one a pair
    (``d_phase="batched"``)."""
    grads = torch.autograd.grad(sum(u.sum() for u in logits), list(xs), create_graph=True)
    return [g.flatten(1).square().sum(1).mean() for g in grads]
