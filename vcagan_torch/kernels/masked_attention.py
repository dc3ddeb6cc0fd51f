"""Length-masked cross-attention: softmax(q k^T / sqrt(d), masked) v.

``masked_cross_attention`` is the AVAttention core.  On a CUDA tensor it
launches the hand-written Hopper kernel in ``vcagan_torch/csrc/
masked_attention.cu`` (which replaces the TPU kernel ``_attention_kernel`` /
``_attention_pallas`` of ``vcagan/kernels/masked_attention.py:50-121``; its
bound and design are noted in the source).  On a CPU tensor it runs the
plain PyTorch version, ``masked_attention_reference``, which is the
einsum/softmax twin of the JAX package's ``_attention_xla``.  Forward only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vcagan_torch.kernels import _build

NEG_INF = -1e30  # mask value; not -inf, so an all-masked row stays finite
LAUNCHES = 0  # kernel launches so far; reset by the caller that counts


def masked_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version: (B,T,D), (B,S,D), (B,S,D), (B,) -> (B,T,D)."""
    scores = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(q.shape[-1])
    key_idx = torch.arange(k.shape[1], device=q.device)[None, None, :]
    mask = key_idx < lengths.to(q.device)[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bts,bsd->btd", probs, v)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("masked_attention")
    lib.vcagan_masked_attention.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ]
    lib.vcagan_masked_attention.restype = ctypes.c_int
    lib.vcagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def masked_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on any input it
    does not take and on a launch error."""
    global LAUNCHES
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on the same CUDA device as q, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError(f"{name} must be a 3-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    b, t, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, d) or v.shape != (b, s, d) or lengths.shape != (b,):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} lengths {tuple(lengths.shape)}"
        )
    if s == 0 or d == 0 or b > 65535:
        raise ValueError(f"the kernel takes S >= 1, D >= 1 and B <= 65535, got {b, t, s, d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.vcagan_masked_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, s, d, q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.vcagan_cuda_error_string(err).decode()
        raise RuntimeError(f"masked_attention kernel launch failed ({err}): {msg}")
    LAUNCHES += 1
    return out


def masked_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Keys at positions >= lengths[b] get zero weight.  CPU tensors take the
    plain version; CUDA tensors the kernel; anything else raises."""
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, lengths)
    if q.device.type == "cuda":
        return masked_attention_cuda(q, k, v, lengths)
    raise ValueError(f"no masked attention for device {q.device}")
