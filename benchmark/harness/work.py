"""The work behind the benchmark's shares: the card's published peaks, the
least time of the fused block and of the attention at their shapes, the
model's FLOPs counted on the plain reference, and Griffin-Lim's FFT work.

Least time is max(bytes / bandwidth, FLOPs / rate): each input read once
and each output written once; bf16 work at the bf16 tensor-core rate,
float32 work that the kernels compute as 3xTF32 at a third of the TF32
rate.  Peaks of one NVIDIA H100 SXM (data sheet, dense): HBM3 3.35 TB/s,
bf16 989 TFLOP/s, TF32 495 TFLOP/s, float32 67 TFLOP/s.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
N_FFT, GL_ROUNDS = 640, 60


def least_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def fused_block_work(n: int, h: int, w: int, c: int, itemsize: int):
    """(bytes, FLOPs) of one identity block over N images: x read and the
    output written once, both 3x3 weights (in x's type), float32 biases
    and slopes read once; two convolutions of 2 * 9 C^2 H W N FLOPs."""
    nbytes = 2 * n * h * w * c * itemsize + 2 * 9 * c * c * itemsize + 4 * 4 * c
    return nbytes, 2 * 2 * 9 * c * c * h * w * n


def fused_block_least_s(n: int, h: int, w: int, c: int, dtype: torch.dtype) -> float:
    itemsize = torch.empty((), dtype=dtype).element_size()
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else TF32_FLOP_PER_S / 3
    return least_s(*fused_block_work(n, h, w, c, itemsize), rate)


def attention_work(b: int, t: int, s: int, d: int, valid_keys: int | None = None):
    """(bytes, FLOPs) of softmax(q k^T / sqrt(D), masked) v in float32: q and
    the lengths read and the output written in full, k and v only in their
    unmasked rows; 4 T D FLOPs a valid key (the two products)."""
    valid = b * s if valid_keys is None else valid_keys
    return 4 * (2 * b * t * d + 2 * valid * d + b), 4 * t * valid * d


def attention_least_s(b, t, s, d, valid_keys=None) -> float:
    return least_s(*attention_work(b, t, s, d, valid_keys), TF32_FLOP_PER_S / 3)


def attention_calls_least_s(calls) -> float:
    """The least time of the attention calls ``trace.wrap_attention`` kept:
    ((B, T, D), S, lengths) each, masked keys not counted."""
    return sum(attention_least_s(q[0], q[1], s, q[2], int(lengths.clamp(0, s).sum()))
               for q, s, lengths in calls)


def griffin_lim_fft_flops(b: int, frames: int) -> float:
    """Griffin-Lim's FFT form: 2.5 n log2 n FLOPs a real 640-point
    transform, two a round a frame and one at the end, whatever form runs."""
    return (2 * GL_ROUNDS + 1) * b * frames * 2.5 * N_FFT * math.log2(N_FFT)


def griffin_lim_fft_least_s(b: int, frames: int) -> float:
    """The FFT form's least time: the magnitudes and phase read once and the
    waveform written once, its FLOPs at the float32 rate."""
    nbytes = 2 * b * frames * 321 * 4 + b * 160 * (frames - 1) * 4
    return least_s(nbytes, griffin_lim_fft_flops(b, frames), FP32_FLOP_PER_S)


class _FlopCount(TorchDispatchMode):
    """Adds up PyTorch's FLOP formulas (``flop_counter.flop_registry``: the
    matrix products and convolutions, forward and backward) over every
    operation dispatched.  ``FlopCounterMode`` tracks modules by hooks that
    ``autograd.grad`` with ``create_graph`` refuses, so it is not used."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def counted_flops(fn) -> float:
    """FLOPs of the matrix products and convolutions that ``fn()`` runs
    (forward and backward, at any order); run it on meta tensors to count
    without computing."""
    with _FlopCount() as counter:
        fn()
    return float(counter.total)
