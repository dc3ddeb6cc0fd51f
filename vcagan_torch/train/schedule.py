"""Learning-rate schedule.

Port of ``vcagan/train/schedule.py:17-30``: the reference's
``MultiStepLR(milestones, gamma)`` stepped per epoch, as a function of the
optimizer's update count given the steps in an epoch.
"""

from __future__ import annotations

from typing import Callable, Sequence


def multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """count -> base_lr * gamma ** (milestones passed by epoch
    count // steps_per_epoch)."""
    miles = sorted(milestones)

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** sum(epoch >= m for m in miles)

    return schedule
