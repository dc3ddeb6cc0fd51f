"""Device selection and fp32 numerics for the port's entry points."""

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
