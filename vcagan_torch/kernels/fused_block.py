"""Fused folded-BN ResNet block: PReLU(conv3x3(PReLU(conv3x3(x, w1) + b1, a1),
w2) + b2 + x, a2), stride 1, SAME zero padding, C_in = C_out.

``fused_basic_block`` computes a whole identity-shortcut BasicBlock whose
BatchNorms were folded into the convolutions.  On a CUDA tensor it launches
the hand-written Hopper kernel in ``vcagan_torch/csrc/fused_block.cu`` (which
replaces the TPU kernel ``_block_kernel`` / ``_fused_block_pallas`` of
``vcagan/kernels/fused_block.py:78-130``; its bounds and design are noted in
the source): one launch, both convolutions on the tensor cores, and the
activation between them never reaches device memory.  On a CPU tensor it
runs the plain PyTorch version, ``fused_block_reference``, the twin of the
JAX package's ``fused_block_xla``.  Forward only.

Layout as in the JAX function: x (N, H, W, C) channels last, w (3, 3, C, C)
as (kh, kw, c_in, c_out), b and a (C,) fp32.  x is fp32 or bf16; sums are
fp32.  For bf16 the weights are rounded to bf16 and so are the intermediate
activation and the output.  For fp32 the kernel does every product as three
TF32 products (3xTF32: each operand split into a TF32 high part and a TF32
low part, the two cross terms summed first, then the high product), which
keeps fp32 accuracy to about 2^-21 relative a product;
``fused_block_reference_3xtf32`` is that arithmetic in plain PyTorch.

What the kernel reads besides x is prepared here, where the CPU tests reach
it: ``pack_weights`` lays a (3, 3, C, C) weight out once, at load, as the
tensor cores read it from shared memory, and ``plan_fused_block`` chooses
the tile (rows or whole images a block, warps along the pixels, the ring of
weight stages) and its shared-memory size.  The plan goes to the C entry
point as plain ints, which refuses one that does not fit.

The kernel takes C a multiple of 64, the widths of both packages' ResNet
trunks (64, 128, 256, 512, whatever ``stem_channels`` is), and any N: where
N*H*W*C passes 2^31 - 1 (the kernel's offsets are 32-bit) the C entry point
launches chunks of images one after another (``kernel_launches``).  A
kernel call counts one in ``fused_block.calls`` and its launches in
``fused_block.launches`` (``vcagan_torch.tracing``); a block's call is
traced as the span ``fused_block``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from vcagan_torch import tracing
from vcagan_torch.kernels import _build, refuse_grad
from vcagan_torch.kernels._tf32 import round_tf32, split_tf32  # noqa: F401  (re-exported)

CHANNEL_MULTIPLE = 64  # the kernel takes C = 64, 128, 192, ...

MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
WARPS = 8  # a block is 256 threads
MAX_STAGES = 5  # buffers of the weight ring (at most)
SMS = 132  # streaming multiprocessors of an H100, for the plan's wave count


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _conv(inp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC input, (3, 3, I, O) weight of the same type -> NHWC, SAME padding."""
    return F.conv2d(inp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def fused_block_reference(x, w1, b1, a1, w2, b2, a2) -> torch.Tensor:
    """Plain version: two convolutions summed in fp32, the activation between
    them rounded to ``x.dtype``."""
    compute = torch.float64 if x.dtype == torch.float64 else torch.float32

    def conv(inp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _conv(inp, w.to(x.dtype).to(compute))

    x32 = x.to(compute)
    h = _prelu(conv(x32, w1) + b1.to(compute), a1.to(compute)).to(x.dtype).to(compute)
    y = conv(h, w2) + b2.to(compute) + x32
    return _prelu(y, a2.to(compute)).to(x.dtype).contiguous()


def fused_block_reference_3xtf32(x, w1, b1, a1, w2, b2, a2, passes: int = 3) -> torch.Tensor:
    """The fp32 block with every product done as the kernel's fp32 form does
    it: operands split into TF32 parts, lo*hi + hi*lo first, then hi*hi, all
    summed in fp32.  ``passes=1`` keeps the hi*hi product only (single-pass
    TF32), to show what the split buys."""

    def conv(inp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        a_hi, a_lo = split_tf32(inp)
        w_hi, w_lo = split_tf32(w)
        if passes == 1:
            return _conv(a_hi, w_hi)
        return (_conv(a_lo, w_hi) + _conv(a_hi, w_lo)) + _conv(a_hi, w_hi)

    h = _prelu(conv(x, w1) + b1, a1)
    return _prelu(conv(h, w2) + b2 + x, a2).contiguous()


# ---- weights in the order the kernel reads them


def _k_step(dtype: torch.dtype) -> int:
    """Input channels one tensor-core instruction contracts."""
    return 16 if dtype == torch.bfloat16 else 8


def pack_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, C, C) fp32 -> the flat tensor the kernel streams.

    The contraction runs over k = tap * C + c_in in steps of 16 (bf16) or 8
    (fp32) input channels.  ``wgmma`` reads a step's weights straight from
    shared memory as core matrices of 8 output channels x 16 bytes of input
    channels, 128 bytes each, without swizzle, so that is how they stand:
    bf16: [step][8 outputs][2 halves of k][output][8 k] as bf16;
    fp32: [step][8 outputs][hi, lo][2 halves of k][output][4 k] as fp32, hi
    and lo the TF32 parts of ``split_tf32``.
    """
    c = w.shape[2]
    if tuple(w.shape) != (3, 3, c, c) or c % 16 or w.dtype != torch.float32:
        raise ValueError(
            f"w must be float32 (3, 3, C, C), C a multiple of 16, got {tuple(w.shape)}"
        )
    if dtype == torch.bfloat16:
        # c_in = 16 ks + 8 khalf + k; c_out = 8 j + r
        v = w.to(torch.bfloat16).reshape(9, c // 16, 2, 8, c // 8, 8)
        return v.permute(0, 1, 4, 2, 5, 3).reshape(-1).contiguous()
    if dtype == torch.float32:
        # c_in = 8 ks + 4 khalf + k; c_out = 8 j + r
        v = torch.stack(split_tf32(w)).reshape(2, 9, c // 8, 2, 4, c // 8, 8)
        return v.permute(1, 2, 5, 0, 3, 6, 4).reshape(-1).contiguous()
    raise ValueError(f"no packing for {dtype}")


def unpack_weights(packed: torch.Tensor, c: int, dtype: torch.dtype):
    """Inverse of ``pack_weights``: the (3, 3, C, C) bf16 weight, or the
    (hi, lo) pair of fp32 weights."""
    if dtype == torch.bfloat16:
        v = packed.reshape(9, c // 16, c // 8, 2, 8, 8)
        return v.permute(0, 1, 3, 5, 2, 4).reshape(3, 3, c, c).contiguous()
    v = packed.reshape(9, c // 8, c // 8, 2, 2, 8, 4).permute(3, 0, 1, 4, 6, 2, 5)
    hi, lo = v.reshape(2, 3, 3, c, c).contiguous()
    return hi, lo


# ---- the tile plan


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's tiling.  A block computes ``g`` whole images (``r == h``)
    or ``r`` output rows of one image; it keeps h (``hr`` rows an image) for
    all channels in shared memory, one pixel a row of ``c + pad`` elements,
    plus one row of zeros that stands for every pixel outside the image, and
    streams the rest: the packed weights through ``stages`` buffers of
    ``ks`` k-steps x ``bn`` output channels, and the x tile (``xr`` rows an
    image) through two buffers of ``ks`` k-steps of channels.
    Its 8 warps are ``warps_m`` (8 or 4: a warpgroup's four stand together)
    along the pixels x ``8 // warps_m`` along the channels; a warpgroup
    accumulates up to ``mt`` tiles of 64 pixels x ``wn`` channels."""

    n: int
    h: int
    w: int
    c: int
    itemsize: int
    r: int
    g: int
    tiles: int
    xr: int
    hr: int
    warps_m: int
    wn: int
    ks: int
    stages: int
    smem: int
    cost: float = dataclasses.field(compare=False, default=0.0)

    @property
    def mt(self) -> int:
        return _tiles_a_warp(self.itemsize, self.wn)

    @property
    def bn(self) -> int:
        return WARPS // self.warps_m * self.wn

    @property
    def blocks(self) -> int:
        return -(-self.n // self.g) * self.tiles

    @property
    def pixel_stride(self) -> int:
        """Elements a pixel's row takes in shared memory: the padding makes
        16 neighbouring pixels' rows fall on different banks."""
        return self.c + (8 if self.itemsize == 2 else 4)

    def ints(self) -> list[int]:
        """What the C entry point takes, in its order."""
        return [self.n, self.h, self.w, self.c, self.r, self.g, self.tiles, self.xr, self.hr,
                self.warps_m, self.wn, self.ks, self.stages, self.smem]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(c, itemsize, g, xr, hr, w, bn, ks, stages) -> int:
    """Weight ring, two x slices (``ks`` k-steps of channels, every pixel of
    the x tile), h and the zero row, biases and slopes, the x tile's pixel
    table, an mbarrier a ring buffer."""
    stride = (c + (8 if itemsize == 2 else 4)) * itemsize
    k_step, wbytes = (16, 2) if itemsize == 2 else (8, 8)
    x_pixels = g * xr * w
    return (stages * ks * bn * k_step * wbytes + 2 * x_pixels * (ks * 32 + 16)
            + (g * hr * w + 1) * stride + 16 * c + _ceil_div(x_pixels, 4) * 16
            + 8 * MAX_STAGES + 8)


def _tiles_a_warp(itemsize: int, wn: int) -> int:
    """Tiles (64 pixels x ``wn`` channels) a warpgroup accumulates at once, at
    most; each of its warps holds 16 of a tile's pixels.  128 accumulator
    registers in bf16; 64 in fp32, whose k-step also holds a fresh sum."""
    return 2 if itemsize == 4 else 256 // wn


def _block_cost(m1, m2, c, itemsize, warps_m, wn, bn, ks, stages) -> float:
    """Clock cycles a block needs, roughly: per k-step the largest of the
    tensor cores' time, the shared-memory reads of the operands, the weight
    slice's way from L2 and the share of L2's latency that the stages in
    flight do not cover, plus a barrier a stage and an epilogue a pass."""
    k_step, wbytes, products = (16, 2, 1) if itemsize == 2 else (8, 8, 3)
    nt, chunks, k_steps = wn // 8, c // bn, 9 * c // k_step
    tiles_a_warp = _tiles_a_warp(itemsize, wn)
    ahead = stages - 2 if itemsize == 2 and ks >= 2 and stages >= 3 else stages - 1
    latency = 2500 / (ahead * ks)
    total = 0.0
    for m in (m1, m2):
        left = _ceil_div(m, 16)
        while left > 0:
            mt = min(tiles_a_warp, _ceil_div(left, warps_m))
            left -= warps_m * tiles_a_warp
            mma = mt * nt * products * 8  # 8 warps on 4 tensor cores, 4 cycles each
            # shared-memory reads at 128 bytes a cycle: A fragments by the
            # warps, B by the tensor cores
            lds = WARPS * 4 * mt + 2 * mt * wn * products // 4
            l2 = bn * k_step * wbytes / 16  # about 16 bytes a cycle a block
            # the operands' reads share shared memory with the weight copies
            # every stage ends in a barrier with the tensor cores drained
            step = max(mma + lds / 2, l2, latency) + (1500 if itemsize == 4 else 1000) / ks
            total += chunks * (k_steps * step + 300 * mt * nt + 600)
    return total + 6000  # the block's set-up


def candidate_plans(n: int, h: int, w: int, c: int, dtype: torch.dtype) -> list[Plan]:
    """Every tiling the kernel takes for this problem that fits ``MAX_SMEM``,
    each with its cost by ``_block_cost`` (``plan_fused_block`` takes the
    cheapest; ``tune_fused_block`` times them on the card)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"no kernel for {dtype}")
    if n < 1 or h < 1 or w < 1 or c < CHANNEL_MULTIPLE or c % CHANNEL_MULTIPLE:
        raise ValueError(
            f"the kernel takes N, H, W >= 1 and C a multiple of {CHANNEL_MULTIPLE}, "
            f"got {(n, h, w, c)}"
        )
    itemsize = 2 if dtype == torch.bfloat16 else 4
    # a warpgroup's tile: 64 pixels x 64 (bf16 also 128 or 256) channels; the
    # widest first, so that of two plans of one cost the one that reads A
    # once for more channels is taken
    widths = tuple(wn for wn in ((256, 128, 64) if itemsize == 2 else (64,)) if c % wn == 0)
    k_steps_tap = c // _k_step(dtype)
    plans = []
    tilings = [(r, 1) for r in range(1, h)] + [(h, g) for g in range(1, min(n, 64) + 1)]
    for r, g in tilings:
        tiles = _ceil_div(h, r)
        xr, hr = (h, h) if r == h else (r + 4, r + 2)
        m1, m2 = g * min(hr, h) * w, g * r * w
        waves = _ceil_div(_ceil_div(n, g) * tiles, SMS)
        for wn in widths:
            for warps_m in (8, 4):
                bn = WARPS // warps_m * wn
                if c % bn:
                    continue
                for stages in range(2, MAX_STAGES + 1):
                    for ks in (8, 4, 2, 1):
                        smem = _smem_bytes(c, itemsize, g, xr, hr, w, bn, ks, stages)
                        if k_steps_tap % ks or smem > MAX_SMEM:
                            continue
                        cost = waves * _block_cost(m1, m2, c, itemsize, warps_m, wn, bn, ks,
                                                   stages)
                        plans.append(Plan(n, h, w, c, itemsize, r, g, tiles, xr, hr, warps_m,
                                          wn, ks, stages, smem, cost))
    return plans


@functools.lru_cache(maxsize=None)
def plan_fused_block(n: int, h: int, w: int, c: int, dtype: torch.dtype) -> Plan:
    """The cheapest tiling by ``_block_cost`` that fits ``MAX_SMEM``."""
    plans = candidate_plans(n, h, w, c, dtype)
    if not plans:
        raise ValueError(f"no tile of {(n, h, w, c)} {dtype} fits {MAX_SMEM} bytes")
    return min(plans, key=lambda plan: plan.cost)  # the first of equals


def kernel_launches(plan: Plan) -> int:
    """The kernel launches of one call: the C entry point's chunks of
    images whose elements stay below 2^31."""
    per_launch = min(plan.n, (2**31 - 1) // (plan.h * plan.w * plan.c))
    return _ceil_div(plan.n, per_launch)


def block_pixels(plan: Plan, block: int) -> dict:
    """What one block touches, as the kernel indexes it, for the CPU tests
    that hold the plan: ``h_index`` (where phase 1 stores each of its pixels
    in the block's h, in pixels) and ``h_pixels`` (their image, row, col);
    ``stores`` (image, row, col of every output pixel phase 2 writes, images
    past N left out); ``x_rows`` / ``h_rows`` / ``out_rows``, the image rows
    of the x tile, of h and of the output."""
    p = plan
    tile, n0 = block % p.tiles, block // p.tiles * p.g
    r0 = tile * p.r
    x0, h0 = (0, 0) if p.tiles == 1 else (r0 - 2, r0 - 1)
    h_lo, h_hi = max(r0 - 1, 0), min(r0 + p.r + 1, p.h)
    o_hi = min(r0 + p.r, p.h)

    def rows(first: int, count: int):  # pixel m of the phase -> image, row, col
        m = np.arange(p.g * count * p.w)
        gi, rem = np.divmod(m, count * p.w)
        return gi, first + rem // p.w, rem % p.w

    gi, row, col = rows(h_lo, h_hi - h_lo)
    h_index = (gi * p.hr + row - h0) * p.w + col
    h_pixels = np.stack([n0 + gi, row, col], axis=1)
    gi, row, col = rows(r0, o_hi - r0)
    stores = np.stack([n0 + gi, row, col], axis=1)[n0 + gi < p.n]
    return dict(h_index=h_index, h_pixels=h_pixels, stores=stores,
                x_rows=range(max(x0, 0), min(x0 + p.xr, p.h)), h_rows=range(h_lo, h_hi),
                out_rows=range(r0, o_hi))


# ---- the kernel


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("fused_block")
    lib.vcagan_fused_block.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    lib.vcagan_fused_block.restype = ctypes.c_int
    lib.vcagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_block_cuda(x, w1_packed, b1, a1, w2_packed, b2, a2, plan=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; the weights come packed
    for ``x.dtype`` by ``pack_weights``.  ``plan`` (for timing tilings) takes
    the place of ``plan_fused_block``'s.  Raises on any input the kernel does
    not take, on a plan that is not of this problem and on a launch error.
    Forward only: it raises where autograd would need its result's gradient.
    N*H*W*C past 2^31 - 1 goes in chunks of images (the C entry point's,
    ``kernel_launches``)."""
    refuse_grad("fused_block", x=x, w1_packed=w1_packed, b1=b1, a1=a1, w2_packed=w2_packed,
                b2=b2, a2=a2)
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(
            f"x must be a 4-D float32 or bfloat16 tensor, got {x.dtype} {tuple(x.shape)}"
        )
    n, h, w, c = x.shape
    if plan is None:
        plan = plan_fused_block(n, h, w, c, x.dtype)  # raises on shapes the kernel does not take
    elif (plan.n, plan.h, plan.w, plan.c, plan.itemsize) != (n, h, w, c, x.element_size()):
        raise ValueError(f"{plan} is not a plan for {x.dtype} {(n, h, w, c)}")
    packed = (9 * c * c * (1 if x.dtype == torch.bfloat16 else 2),)
    shapes = {"w1_packed": packed, "w2_packed": packed, "b1": (c,), "a1": (c,), "b2": (c,),
              "a2": (c,)}
    tensors = {"x": x, "w1_packed": w1_packed, "b1": b1, "a1": a1, "w2_packed": w2_packed,
               "b2": b2, "a2": a2}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        want = x.dtype if name.endswith("packed") else torch.float32
        if name != "x" and (t.dtype != want or tuple(t.shape) != shapes[name]):
            raise ValueError(
                f"{name} must be {want} of shape {shapes[name]}, got {t.dtype} {tuple(t.shape)}"
            )
    out = torch.empty_like(x)
    lib = _lib()
    ints = plan.ints()
    err = lib.vcagan_fused_block(
        x.data_ptr(), w1_packed.data_ptr(), b1.data_ptr(), a1.data_ptr(), w2_packed.data_ptr(),
        b2.data_ptr(), a2.data_ptr(), out.data_ptr(), (ctypes.c_int * len(ints))(*ints),
        len(ints), int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.vcagan_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_block kernel launch failed ({err}): {msg}; plan {plan}")
    tracing.count("fused_block.calls")
    tracing.count("fused_block.launches", kernel_launches(plan))
    return out


def fused_basic_block(x, w1, b1, a1, w2, b2, a2, packed=None) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H, W, C).  CPU tensors take the plain version;
    CUDA tensors the kernel, with ``packed`` = (``pack_weights(w1, x.dtype)``,
    ``pack_weights(w2, x.dtype)``) if the caller packed them at load, else
    packed here; anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused block for device {x.device}")
    with tracing.span("fused_block"):
        if x.device.type == "cpu":
            return fused_block_reference(x, w1, b1, a1, w2, b2, a2)
        w1p, w2p = packed if packed is not None else (
            pack_weights(w1, x.dtype), pack_weights(w2, x.dtype))
        return fused_block_cuda(x, w1p, b1, a1, w2p, b2, a2)
