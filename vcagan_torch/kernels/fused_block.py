"""Fused folded-BN ResNet block: PReLU(conv3x3(PReLU(conv3x3(x, w1) + b1, a1),
w2) + b2 + x, a2), stride 1, SAME zero padding, C_in = C_out.

``fused_basic_block`` computes a whole identity-shortcut BasicBlock whose
BatchNorms were folded into the convolutions.  On a CUDA tensor it launches
the hand-written Hopper kernel in ``vcagan_torch/csrc/fused_block.cu`` (which
replaces the TPU kernel ``_block_kernel`` / ``_fused_block_pallas`` of
``vcagan/kernels/fused_block.py:78-130``; its bound and design are noted in
the source): one launch, and the activation between the two convolutions
never reaches device memory.  On a CPU tensor it runs the plain PyTorch
version, ``fused_block_reference``, the twin of the JAX package's
``fused_block_xla``.  Forward only.

Layout as in the JAX function: x (N, H, W, C) channels last, w (3, 3, C, C)
as (kh, kw, c_in, c_out), b and a (C,) fp32.  x is fp32 or bf16; sums are
fp32; for bf16 the weights are rounded to bf16 and so are the intermediate
activation and the output.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from vcagan_torch.kernels import _build

CHANNEL_MULTIPLE = 16  # the kernel takes C = 16, 32, 48, ...
LAUNCHES = 0  # kernel launches so far; reset by the caller that counts


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def fused_block_reference(x, w1, b1, a1, w2, b2, a2) -> torch.Tensor:
    """Plain version: two convolutions summed in fp32, the activation between
    them rounded to ``x.dtype``."""

    def conv(inp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:  # NHWC fp32 -> NHWC fp32
        kernel = w.to(x.dtype).to(inp.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(inp.permute(0, 3, 1, 2), kernel, padding=1).permute(0, 2, 3, 1)

    compute = torch.float64 if x.dtype == torch.float64 else torch.float32
    x32 = x.to(compute)
    h = _prelu(conv(x32, w1) + b1.to(compute), a1.to(compute)).to(x.dtype).to(compute)
    y = conv(h, w2) + b2.to(compute) + x32
    return _prelu(y, a2.to(compute)).to(x.dtype).contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("fused_block")
    lib.vcagan_fused_block.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.vcagan_fused_block.restype = ctypes.c_int
    lib.vcagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_block_cuda(x, w1, b1, a1, w2, b2, a2) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on any input it
    does not take and on a launch error."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(
            f"x must be a 4-D float32 or bfloat16 tensor, got {x.dtype} {tuple(x.shape)}"
        )
    n, h, w, c = x.shape
    if n < 1 or h < 1 or w < 1 or c < CHANNEL_MULTIPLE or c % CHANNEL_MULTIPLE:
        raise ValueError(
            f"the kernel takes N, H, W >= 1 and C a multiple of {CHANNEL_MULTIPLE}, "
            f"got {tuple(x.shape)}"
        )
    if n * h * w >= 2**31:
        raise ValueError(f"N*H*W must stay below 2^31, got {n * h * w}")
    shapes = {"w1": (3, 3, c, c), "w2": (3, 3, c, c), "b1": (c,), "a1": (c,), "b2": (c,),
              "a2": (c,)}
    tensors = {"x": x, "w1": w1, "b1": b1, "a1": a1, "w2": w2, "b2": b2, "a2": a2}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name != "x" and (t.dtype != torch.float32 or tuple(t.shape) != shapes[name]):
            raise ValueError(
                f"{name} must be float32 of shape {shapes[name]}, got {t.dtype} {tuple(t.shape)}"
            )
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.vcagan_fused_block(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), a1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), a2.data_ptr(), out.data_ptr(), n, h, w, c,
        int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.vcagan_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_block kernel launch failed ({err}): {msg}")
    LAUNCHES += 1
    return out


def fused_basic_block(x, w1, b1, a1, w2, b2, a2) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H, W, C).  CPU tensors take the plain version;
    CUDA tensors the kernel; anything else raises."""
    if x.device.type == "cpu":
        return fused_block_reference(x, w1, b1, a1, w2, b2, a2)
    if x.device.type == "cuda":
        return fused_block_cuda(x, w1, b1, a1, w2, b2, a2)
    raise ValueError(f"no fused block for device {x.device}")
