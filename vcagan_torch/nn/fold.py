"""Eval-time BatchNorm folding on the port's state dicts.

Port of ``vcagan/nn/fold.py:56-122``.  In eval mode BatchNorm is a
per-channel affine, so a convolution followed by its BatchNorm is exactly a
biased convolution:

    BN(conv(x, k)) = conv(x, k * s) + b,   s = weight / sqrt(var + eps)
                                           b = (conv_bias - mean) * s + bias

Pairs go by the reference state-dict names: ``convN``/``bnN`` and
``downsample.0``/``downsample.1`` in the ResNet blocks, ``frontend.0``/
``frontend.1`` (the stem) and ``postnet.0``/``postnet.1``.  The decoder's
``norm1``/``norm2`` and ``to_melN.0`` come before a nonlinearity and a
convolution, cannot be folded, and stay.  A folded dict has no paired
BatchNorm left, so folding it again changes nothing.  Apply the result to
modules built with ``fold_bn=True``.
"""

from __future__ import annotations

from typing import Dict

import torch

from vcagan_torch.nn.common import BN_EPS

StateDict = Dict[str, torch.Tensor]

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
# last component(s) of a BatchNorm's prefix -> those of the conv it follows
_PAIRS = {
    "bn1": "conv1",
    "bn2": "conv2",
    "downsample.1": "downsample.0",
    "frontend.1": "frontend.0",
    "postnet.1": "postnet.0",
}


def _paired_conv(bn_prefix: str) -> str | None:
    for bn_tail, conv_tail in _PAIRS.items():
        if bn_prefix == bn_tail or bn_prefix.endswith("." + bn_tail):
            return bn_prefix[: len(bn_prefix) - len(bn_tail)] + conv_tail
    return None


def fold_conv_bn(state: StateDict) -> StateDict:
    """Fold every paired conv -> BatchNorm of one module's state dict.  The
    folded BatchNorm's entries go; every other entry is passed through."""
    out = dict(state)
    for key in state:
        if not key.endswith(".running_var"):
            continue
        bn = key[: -len(".running_var")]
        conv = _paired_conv(bn)
        if conv is None or f"{conv}.weight" not in state:
            continue
        s = state[f"{bn}.weight"] / torch.sqrt(state[f"{bn}.running_var"] + BN_EPS)
        weight = state[f"{conv}.weight"]
        out[f"{conv}.weight"] = weight * s.reshape(-1, *([1] * (weight.dim() - 1)))
        old_bias = state.get(f"{conv}.bias", 0.0)
        out[f"{conv}.bias"] = (old_bias - state[f"{bn}.running_mean"]) * s + state[f"{bn}.bias"]
        for leaf in _BN_LEAVES:
            out.pop(f"{bn}.{leaf}", None)
    return out


def fold_generator_side(states: Dict[str, StateDict]) -> Dict[str, StateDict]:
    """{v_front, gen, post} state dicts -> their folded forms (v_front and
    post lose every BatchNorm; gen is untouched)."""
    return {name: fold_conv_bn(sd) for name, sd in states.items()}
