"""The visual front's stem in one launch, bf16: PReLU(conv3d(video, w) + b, a)
max-pooled, written channels-last for the fused trunk.

``fused_stem`` computes the chain that ``VisualFront`` runs on the folded
serving path (``vcagan/nn/visual_front.py:35-50``, ``:90-99``): the
convolution k(5,7,7) s(1,2,2) p(2,3,3) of a one-channel video, its folded
bias, PReLU and the max-pool (1,3,3) s(1,2,2) p(0,1,1), with the rounding
points of the bf16 mode:

1. the video is rounded to bf16 (``x.to(bf16)``);
2. the weights are rounded to bf16;
3. the 245 products are summed in fp32 and the sum is rounded to bf16;
4. the bf16-rounded bias is added and the result rounded to bf16;
5. PReLU with bf16 slopes, rounded to bf16 (slopes of either sign);
6. the max over each 3x3 window, the pool's padding as -inf.

On a CUDA tensor it launches the hand-written Hopper kernel in
``vcagan_torch/csrc/fused_stem.cu`` (which replaces no TPU kernel; its bound
and design are noted in the source): one launch, the products on the
tensor cores, and nothing but the pooled map reaches device memory.  On a
CPU tensor it runs the plain PyTorch version, ``fused_stem_reference``.
Forward only.

Layout: video (B, T, H, W, 1) fp32 as ``Synthesizer`` hands it over, the
weight in ``nn.Conv3d``'s (C, 1, 5, 7, 7), bias and slopes (C,) fp32; out
(B*T, H', W', C) bf16 with H' = ceil(ceil(H/2)/2), the (N, H, W, C) layout
of ``fused_basic_block``.  Any B, T, H, W (T < 5 too: time pads with zero
frames); C a multiple of 64, one block's tile of output channels; anything
else raises.

What the kernel reads besides the video is prepared here, where the CPU
tests reach it: ``pack_stem_weights`` lays the weight out once, at load, as
the tensor cores read it from shared memory, and ``plan_fused_stem``
chooses the band of pooled rows and the frames a block computes and their
shared-memory size, passed to the C entry point as plain ints, which
refuses a plan that does not fit.  A kernel call counts one in
``stem.calls`` and its launches in ``stem.launches``
(``vcagan_torch.tracing``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from vcagan_torch import tracing
from vcagan_torch.kernels import _build, refuse_grad

CHANNEL_MULTIPLE = 64  # output channels a block computes
KERNEL = (5, 7, 7)  # frames, rows, columns of the convolution's window
# The contraction: k = 2 * pair + e, pair = dt * 28 + dy * 4 + j, the tap
# column dx = 2 j - 1 + e; dx = -1 (j = 0, e = 0) and the pairs past 140
# carry zero weights.  A pair is two neighbouring input columns that start
# at an even column, so the kernel reads it as one 32-bit word.
PAIRS = 5 * 7 * 4
K_STEPS = 18  # of 16 values: 288 rows of K, 280 of them in the window
K_ROWS = 16 * K_STEPS

MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
SMS = 132  # streaming multiprocessors of an H100, for the plan's wave count
THREADS = 256  # two warpgroups
TILES_A_WARPGROUP = 4  # tiles of 64 pixels a warpgroup accumulates at once
STEP_BYTES = CHANNEL_MULTIPLE * 16 * 2  # packed bytes of a k-step
WEIGHT_BYTES = K_STEPS * STEP_BYTES
PIXEL_BYTES = (CHANNEL_MULTIPLE + 8) * 2  # a pixel of the convolution tile
PARAM_BYTES = 2 * CHANNEL_MULTIPLE * 2 + 16  # bias and slopes as bf16, a zero row
FRAMES = 5  # the ring of input frames


def conv_size(h: int) -> int:
    """Rows (or columns) of the convolution's output: k 7, stride 2, pad 3."""
    return (h - 1) // 2 + 1


def pooled_size(h: int) -> int:
    """Rows (or columns) of the stem's output: the pool after the convolution."""
    return (conv_size(h) - 1) // 2 + 1


# ---- the plain version


def fused_stem_reference(video, weight, bias, slope) -> torch.Tensor:
    """Plain version: the rounding points above, in PyTorch's own layers
    (on the CPU the convolution is fp32 on bf16 values; on the card cuDNN
    with TF32 off).  Any C."""
    b, t = video.shape[:2]
    bf16 = torch.bfloat16
    x = video.to(bf16).float().permute(0, 4, 1, 2, 3)
    flags = (torch.backends.cudnn.flags(enabled=True, allow_tf32=False) if video.is_cuda
             else contextlib.nullcontext())
    with flags:
        y = F.conv3d(x, weight.to(bf16).float(), None, stride=(1, 2, 2), padding=(2, 3, 3))
    y = y.to(bf16) + bias.to(bf16)[:, None, None, None]
    y = F.prelu(y, slope.to(bf16))
    y = F.max_pool3d(y, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1).reshape(b * t, *y.shape[3:], y.shape[1]).contiguous()


# ---- weights in the order the kernel reads them


def stem_matrix(weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, 5, 7, 7) -> the (288, C) matrix of the contraction, fp32, with
    zero rows where no tap is (the column before the window and the rows
    past 280)."""
    c = weight.shape[0]
    taps = weight.new_zeros(5, 7, 8, c)
    taps[:, :, 1:] = weight[:, 0].permute(1, 2, 3, 0)
    return torch.cat([taps.reshape(2 * PAIRS, c), weight.new_zeros(K_ROWS - 2 * PAIRS, c)])


def pack_stem_weights(weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, 5, 7, 7) fp32 -> the flat bf16 tensor the kernel reads.

    Each 64 output channels are one block's: [chunk][k-step][8 outputs]
    [2 halves of k][output][8 k], the core matrices of 8 output channels x
    16 bytes of k that ``wgmma`` reads from shared memory without swizzle
    (``pack_weights`` of the fused block lays out each tap the same way)."""
    c = weight.shape[0]
    if (tuple(weight.shape) != (c, 1, *KERNEL) or c % CHANNEL_MULTIPLE
            or weight.dtype != torch.float32):
        raise ValueError(f"weight must be float32 (C, 1, 5, 7, 7), C a multiple of "
                         f"{CHANNEL_MULTIPLE}, got {weight.dtype} {tuple(weight.shape)}")
    # k = 16 s + 8 half + kk; c = 64 chunk + 8 j + r
    v = stem_matrix(weight).to(torch.bfloat16).reshape(K_STEPS, 2, 8, c // 64, 8, 8)
    return v.permute(3, 0, 4, 1, 5, 2).reshape(-1).contiguous()


# ---- the plan


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class StemPlan:
    """One launch's tiling.  A block computes the pooled rows [p0, p0 + p)
    of one clip's frames [t0, t0 + tc) for 64 output channels.  It keeps
    the packed weights, a ring of the five input frames of a step as bf16
    bands of ``band_rows`` rows x 2 W' + 6 columns (W' the convolution's
    width; the window's pad columns as zeros), one frame's fp32 band in
    flight, and the convolution rows [2 p0 - 1, 2 p0 + 2 p) of a frame,
    ``conv_rows`` at most, PReLU'd, from which it pools."""

    b: int
    t: int
    h: int
    w: int
    c: int
    p: int
    tc: int
    smem: int
    cost: float = dataclasses.field(compare=False, default=0.0)

    @property
    def ho(self) -> int:
        return conv_size(self.h)

    @property
    def hp(self) -> int:
        return pooled_size(self.h)

    @property
    def wp(self) -> int:
        return pooled_size(self.w)

    @property
    def conv_rows(self) -> int:
        return min(2 * self.p + 1, self.ho)

    @property
    def band_rows(self) -> int:
        return 2 * self.conv_rows + 5

    @property
    def bands(self) -> int:
        return _ceil_div(self.hp, self.p)

    @property
    def chunks(self) -> int:
        return _ceil_div(self.t, self.tc)

    @property
    def blocks(self) -> int:
        return self.b * self.chunks * self.bands * (self.c // CHANNEL_MULTIPLE)

    def ints(self) -> list[int]:
        """What the C entry point takes, in its order."""
        return [self.b, self.t, self.h, self.w, self.c, self.p, self.tc, self.smem]


def _smem_bytes(p: int, h: int, w: int) -> int:
    """Packed weights, the ring of five bf16 bands, one fp32 band in flight,
    the convolution tile (which holds the first five fp32 bands at the
    block's start), bias and slopes, a zero row."""
    conv_rows = min(2 * p + 1, conv_size(h))
    band = (2 * conv_rows + 5) * (2 * conv_size(w) + 6)
    slot, staging = _round16(2 * band), _round16(4 * band)
    tile = conv_rows * conv_size(w) * PIXEL_BYTES
    return WEIGHT_BYTES + FRAMES * slot + staging + max(tile, FRAMES * staging) + PARAM_BYTES


def _block_cost(p: int, tc: int, h: int, w: int) -> float:
    """Clock cycles a block takes, roughly: per frame the products (32
    cycles a tile a k-step on the tensor cores, half as much again for the
    shared-memory reads of A and B), the epilogues, the pool, the next
    band's conversion and two barriers; and the start (weights, five
    bands)."""
    conv_rows, wo, wp = min(2 * p + 1, conv_size(h)), conv_size(w), pooled_size(w)
    tiles = _ceil_div(conv_rows * wo, 64)
    rounds = _ceil_div(tiles, 2 * TILES_A_WARPGROUP)
    band = (2 * conv_rows + 5) * (2 * wo + 6)
    step = (48 * K_STEPS * tiles + 900 * rounds + 100 * _ceil_div(p * wp * 8, THREADS)
            + 20 * _ceil_div(band // 2, THREADS) + 400)
    return 6000 + tc * step


def candidate_plans(b: int, t: int, h: int, w: int, c: int) -> list[StemPlan]:
    """Every tiling the kernel takes for this problem that fits ``MAX_SMEM``,
    each with its cost (waves of one block an SM x ``_block_cost``)."""
    if min(b, t, h, w) < 1 or c < CHANNEL_MULTIPLE or c % CHANNEL_MULTIPLE:
        raise ValueError(f"the stem kernel takes B, T, H, W >= 1 and C a multiple of "
                         f"{CHANNEL_MULTIPLE}, got {(b, t, h, w, c)}")
    if max(h, w) >= 32768:
        raise ValueError(f"the stem kernel takes H, W below 32768, got {(h, w)}")
    plans = []
    hp = pooled_size(h)
    for p in range(1, hp + 1):
        smem = _smem_bytes(p, h, w)
        if smem > MAX_SMEM:
            break  # grows with p
        for tc in range(1, t + 1):
            plan = StemPlan(b, t, h, w, c, p, tc, smem)
            if plan.blocks > 2**31 - 1:
                continue
            cost = _ceil_div(plan.blocks, SMS) * _block_cost(p, tc, h, w)
            plans.append(dataclasses.replace(plan, cost=cost))
    return plans


@functools.lru_cache(maxsize=None)
def plan_fused_stem(b: int, t: int, h: int, w: int, c: int) -> StemPlan:
    """The cheapest tiling by ``_block_cost`` that fits ``MAX_SMEM``; of
    equals, the widest band and the most frames."""
    plans = candidate_plans(b, t, h, w, c)
    if not plans:
        raise ValueError(f"no stem tile of {(b, t, h, w, c)} fits {MAX_SMEM} bytes")
    return min(plans, key=lambda plan: (plan.cost, -plan.p, -plan.tc))


# ---- the kernel


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("fused_stem")
    lib.vcagan_fused_stem.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    lib.vcagan_fused_stem.restype = ctypes.c_int
    lib.vcagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_stem_cuda(video, packed, bias, slope) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, tiled by
    ``plan_fused_stem``; the weights come packed by ``pack_stem_weights``.
    Raises on any input the kernel does not take and on a launch error.
    Forward only: it raises where autograd would need its result's
    gradient."""
    refuse_grad("stem", video=video, packed=packed, bias=bias, slope=slope)
    if video.device.type != "cuda":
        raise ValueError(f"video must lie on a CUDA device, got {video.device}")
    if video.dtype != torch.float32 or video.dim() != 5 or video.shape[-1] != 1:
        raise ValueError(f"video must be float32 (B, T, H, W, 1), got {video.dtype} "
                         f"{tuple(video.shape)}")
    b, t, h, w, _ = video.shape
    c = bias.numel()
    plan = plan_fused_stem(b, t, h, w, c)  # raises on shapes the kernel does not take
    shapes = {"packed": (K_ROWS * c,), "bias": (c,), "slope": (c,)}
    tensors = {"video": video, "packed": packed, "bias": bias, "slope": slope}
    for name, x in tensors.items():
        if x.device != video.device:
            raise ValueError(f"{name} must lie on {video.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        want = torch.bfloat16 if name == "packed" else torch.float32
        if name != "video" and (x.dtype != want or tuple(x.shape) != shapes[name]):
            raise ValueError(f"{name} must be {want} of shape {shapes[name]}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    out = torch.empty((b * t, plan.hp, plan.wp, c), dtype=torch.bfloat16, device=video.device)
    lib = _lib()
    ints = plan.ints()
    err = lib.vcagan_fused_stem(
        video.data_ptr(), packed.data_ptr(), bias.data_ptr(), slope.data_ptr(), out.data_ptr(),
        (ctypes.c_int * len(ints))(*ints), len(ints), video.device.index,
        torch.cuda.current_stream(video.device).cuda_stream,
    )
    if err != 0:
        msg = lib.vcagan_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_stem kernel launch failed ({err}): {msg}; plan {plan}")
    tracing.count("stem.calls")
    tracing.count("stem.launches")  # one launch a call
    return out


def fused_stem(video, weight, bias, slope, packed=None) -> torch.Tensor:
    """video (B, T, H, W, 1) -> (B*T, H', W', C) bf16.  C must be a multiple
    of 64.  CPU tensors take the plain version; CUDA tensors the kernel,
    with ``packed`` = ``pack_stem_weights(weight)`` if the caller packed it
    at load, else packed here; anything else raises."""
    c = weight.shape[0]
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"the stem kernel takes C a multiple of {CHANNEL_MULTIPLE}, got {c}")
    if video.device.type == "cpu":
        return fused_stem_reference(video, weight, bias, slope)
    if video.device.type != "cuda":
        raise ValueError(f"no fused stem for device {video.device}")
    return fused_stem_cuda(video, pack_stem_weights(weight) if packed is None else packed,
                           bias, slope)
