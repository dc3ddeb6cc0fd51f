"""Train state and the two optimizers.

Port of ``vcagan/train/state.py``: one optimizer over the generator side
{v_front, gen, post}, one over the discriminator side {dis1..3, s_dis}
(reference ``train.py:78-89``), each the optax chain
``add_decayed_weights(wd) -> scale_by_amsgrad() | scale_by_adam() ->
scale_by_learning_rate(schedule)``.

The update is written out here, in place on the parameters, because
``torch.optim.Adam(amsgrad=True)`` is another algorithm: it keeps the
maximum of the raw second moments and corrects it afterwards, where optax
keeps the maximum of the bias-corrected ones.  The two agree at the first
step and part from the second.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from vcagan_torch.configs import TrainConfig
from vcagan_torch.runtime import resolve_device, use_full_fp32
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE, VCAGANModules
from vcagan_torch.train.schedule import multistep_schedule

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax's defaults, which the JAX package keeps


@dataclasses.dataclass
class AdamState:
    """``count`` updates so far; first and second moments, and with AMSGrad
    the running maximum of the bias-corrected second moment."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    nu_max: List[torch.Tensor] | None


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in fp32, as optax computes it (``decay**count`` of a
    weakly typed float and an int32 count)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """Coupled weight decay (added to the gradient), then Adam or AMSGrad
    moments with optax's b1, b2, eps and eps_root 0, then -lr *
    schedule(count) with count the updates made before this one."""

    def __init__(self, weight_decay: float, amsgrad: bool, schedule: Callable[[int], float]):
        self.weight_decay, self.amsgrad, self.schedule = weight_decay, amsgrad, schedule

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        return AdamState(0, zeros(), zeros(), zeros() if self.amsgrad else None)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> None:
        """One update of ``params`` and ``state``, both in place."""
        g = torch._foreach_add(grads, params, alpha=self.weight_decay)
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - B2)
        lr = self.schedule(state.count)
        state.count += 1
        mu_hat = torch._foreach_div(state.mu, _bias_correction(B1, state.count))
        nu_hat = torch._foreach_div(state.nu, _bias_correction(B2, state.count))
        if self.amsgrad:
            torch._foreach_maximum_(state.nu_max, nu_hat)
            nu_hat = state.nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(params, mu_hat, alpha=-lr)


def make_optimizer(lr: float, weight_decay: float, amsgrad: bool, milestones: Sequence[int],
                   gamma: float, steps_per_epoch: int) -> Optimizer:
    return Optimizer(weight_decay, amsgrad,
                     multistep_schedule(lr, milestones, gamma, steps_per_epoch))


@dataclasses.dataclass
class GANTrainState:
    """The update count, the modules (both sides' parameters and BatchNorm
    statistics) and both optimizers' states."""

    step: int
    modules: VCAGANModules
    g_opt_state: AdamState
    d_opt_state: AdamState


def create_train_state(modules: VCAGANModules, config: TrainConfig | None = None,
                       steps_per_epoch: int = 1, device=None
                       ) -> tuple[GANTrainState, Optimizer, Optimizer]:
    """Put ``modules`` (initialised by ``VCAGANModules.create(seed=...)`` or
    loaded) on the device, CUDA unless ``device="cpu"``, in train mode with
    TF32 off, and build both optimizers.  Returns (state, g_tx, d_tx).
    Where the model axis has cut the split leaves first
    (``vcagan_torch.parallel.shard.ModelSplit.split_``), their moments are
    built on the slices: Adam and weight decay are elementwise."""
    cfg = config or TrainConfig()
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_full_fp32()
    modules.to(dev).train()
    g_tx, d_tx = (make_optimizer(cfg.lr, cfg.weight_decay, cfg.amsgrad, cfg.lr_milestones,
                                 cfg.lr_gamma, steps_per_epoch) for _ in range(2))
    state = GANTrainState(
        step=0, modules=modules,
        g_opt_state=g_tx.init(modules.parameters(GENERATOR_SIDE)),
        d_opt_state=d_tx.init(modules.parameters(DISCRIMINATOR_SIDE)),
    )
    return state, g_tx, d_tx
