"""Device selection and numerics (fp32, or the bf16 serving mode) for the
port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  Raises where CUDA is asked for (explicitly or by default)
    and absent; it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def use_full_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits), which breaks parity with the fp32 reference; the port's fp32
    numerics need true fp32 everywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_dtype(config) -> torch.dtype:
    """The dtype the convolutions, BatchNorm outputs and activations compute
    in: bf16 when ``config.use_bfloat16`` (the JAX package's serving mode,
    ``vcagan/train/models.py:56``), else fp32.  Parameters stay fp32 either
    way; each module casts them at the call, as flax's ``dtype`` does."""
    return torch.bfloat16 if config.use_bfloat16 else torch.float32
