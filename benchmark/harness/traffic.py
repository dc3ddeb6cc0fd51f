"""What the kinds share: seeds derived from the run's seed, clip lengths
drawn the same way for every seed, and the program's model configuration
from a configuration file."""

from __future__ import annotations

import statistics

import numpy as np


def batch_seed(seed: int, index: int) -> int:
    """A 63-bit seed for item ``index`` of the run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed % 2 ** 63, index]).generate_state(1, np.uint64)[0] >> 1)


def block_lengths(spec: dict, block: int) -> np.ndarray:
    """``block`` clip lengths: ``{"fixed": T}``, or ``{"lognormal": {"median",
    "sigma", "min", "max"}}`` as the distribution's quantiles at (i + 0.5) /
    block, rounded and cut to [min, max].  The same for every seed; a seed
    only orders them."""
    if "fixed" in spec:
        return np.full(block, spec["fixed"])
    ln = spec["lognormal"]
    normal = statistics.NormalDist()
    q = np.array([normal.inv_cdf((i + 0.5) / block) for i in range(block)])
    return np.clip(np.rint(ln["median"] * np.exp(ln["sigma"] * q)), ln["min"], ln["max"]).astype(int)


def model_config(cls, config: dict):
    """The program's ``ModelConfig`` (``cls``) of a configuration file."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()})
