"""Length-masked cross-attention: softmax(q k^T / sqrt(d), masked) v.

``masked_cross_attention`` is the AVAttention core.  On a CUDA tensor it
launches the hand-written Hopper kernel in ``vcagan_torch/csrc/
masked_attention.cu`` (which replaces the TPU kernel ``_attention_kernel`` /
``_attention_pallas`` of ``vcagan/kernels/masked_attention.py:50-121``; its
bound and design are noted in the source): both products on the tensor
cores, in fp32 as 3xTF32 (each operand split into a TF32 high and low part,
the cross terms lo*hi + hi*lo summed apart from hi*hi), which keeps about
2^-21 relative a product.  On a CPU tensor it runs the plain PyTorch version,
``masked_attention_reference``, which is the einsum/softmax twin of the JAX
package's ``_attention_xla``.  ``masked_attention_reference_3xtf32`` is the
kernel's arithmetic in plain PyTorch, for the tests and the card's checks.

The kernel is forward only, as the TPU kernel is.  Gradients go through
``MaskedAttention``, an ``autograd.Function`` whose forward is the kernel
(the plain version on CPU tensors) and whose backward recomputes the plain
version under autograd and returns its VJP, as the JAX package's custom VJP
does with ``_attention_xla`` (``vcagan/kernels/masked_attention.py:173-191``).

The tile plan (``attention_plan``: warps a block, key tile, D chunk, key
block, shared memory, grid) is chosen here, where the CPU tests reach it,
and goes to the C entry point as plain ints, which refuses one that does not
match.  The kernel takes D a multiple of 8 and any S >= 1: up to ``S_MAX``
keys in one score strip a tile, past it in blocks of ``KEY_BLOCK`` keys
with an online softmax (``masked_attention_reference_3xtf32(...,
key_block=)`` is that arithmetic in plain PyTorch).  Other shapes raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from vcagan_torch.kernels import _build, refuse_grad
from vcagan_torch.kernels._tf32 import split_tf32

NEG_INF = -1e30  # mask value; not -inf, so an all-masked row stays finite
LAUNCHES = 0  # kernel launches so far; reset by the caller that counts

MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
TILES = 4  # 16-row query tiles a block, at most
SPLIT = 2  # warps a tile, each computing every other n-tile of a piece
# (one warp where the D chunk is a single n-tile of 8 columns)
ROWS = 16  # query rows of one tile (the m16n8k8 fragment's M)
KEY_TILE = 32  # keys of one streamed K or V piece
N_TILE = 8  # keys (QK^T) or columns (PV) of one tensor-core product
D_CHUNKS = (64, 8)  # the D chunk: 64 where it divides D (the model's 256), else 8
S_MAX = 512  # keys of the one-strip plan: the score strips of 4 tiles at D = 256 fit
KEY_BLOCK = 256  # keys of a block past S_MAX (a multiple of KEY_TILE)
PLAN_INTS = 9


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


def masked_attention_reference_3xtf32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    passes: int = 3, key_pad: int = 1, key_block: int = 0,
) -> torch.Tensor:
    """The fp32 function with both products done as the kernel does them:
    operands split into TF32 parts, lo*hi + hi*lo first, then hi*hi, summed
    in fp32; P = softmax of the scaled, masked scores is split too.
    ``passes=1`` keeps the hi*hi products only (single-pass TF32), to show
    what the split buys.  ``key_pad``: pad the keys with zero rows of K and V
    to a multiple of it, as the kernel's tiles do, and give the padded keys
    weight exactly 0 (score -inf), so the result does not change.

    ``key_block`` > 0: the key-blocked kernel's arithmetic (S > ``S_MAX``).
    The keys go in blocks of ``key_block`` (the last one padded to
    ``key_pad``); each row keeps its running maximum m, the sum l of
    exp(s - m) and the unnormalised output O: a block with maximum m_blk
    sets m_new = max(m, m_blk), alpha = exp(m - m_new) (0 before the first
    block), e = exp(s - m_new), l = l alpha + sum e, O = O alpha + e V; the
    result is O / l."""

    def product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a_hi, a_lo = split_tf32(a)
        b_hi, b_lo = split_tf32(b)
        if passes == 1:
            return torch.einsum(eq, a_hi, b_hi)
        return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + torch.einsum(
            eq, a_hi, b_hi
        )

    def scores(k_blk: torch.Tensor, start: int) -> torch.Tensor:
        """Scaled, masked scores of keys start..., padded to ``key_pad``."""
        n = k_blk.shape[1]
        sc = product("btd,bsd->bts", q, k_blk) / math.sqrt(q.shape[-1])
        key_idx = start + torch.arange(n, device=q.device)[None, None, :]
        mask = key_idx < lengths.to(q.device)[:, None, None]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        return torch.where(key_idx < s, sc, torch.full_like(sc, -math.inf))

    def pad(x: torch.Tensor) -> torch.Tensor:
        extra = -x.shape[1] % key_pad
        return torch.cat([x, x.new_zeros(x.shape[0], extra, x.shape[2])], 1) if extra else x

    s = k.shape[1]
    if not key_block:
        k, v = pad(k), pad(v)
        probs = torch.softmax(scores(k, 0), dim=-1)
        return product("bts,bsd->btd", probs, v)
    m = l = o = None
    for start in range(0, s, key_block):
        k_blk, v_blk = pad(k[:, start:start + key_block]), pad(v[:, start:start + key_block])
        sc = scores(k_blk, start)
        m_blk = sc.amax(-1, keepdim=True)
        m_new = m_blk if m is None else torch.maximum(m, m_blk)
        e = torch.exp(sc - m_new)
        pv = product("bts,bsd->btd", e, v_blk)
        if m is None:
            l, o = e.sum(-1, keepdim=True), pv
        else:
            alpha = torch.exp(m - m_new)
            l, o = l * alpha + e.sum(-1, keepdim=True), o * alpha + pv
        m = m_new
    return o / l


# ---- the tile plan


def _split(d_chunk: int) -> int:
    """Warps a 16-row tile: the kernel's instance for ``d_chunk``."""
    return SPLIT if d_chunk > N_TILE else 1


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One launch's tiling.  A block is one sample and ``tiles`` tiles of 16
    query rows, each computed by ``split`` warps (``warps`` in all, which
    share the n-tiles of every product); the grid is (``row_tiles``, B).
    K, then V, stream through a ring of two buffers in pieces of
    ``key_tile`` keys x ``d_chunk`` columns.  ``key_block`` 0: all S keys
    in one score strip a tile; else the keys in blocks of ``key_block``
    (``key_blocks``), K then V pieces a block, with an online softmax and
    the output sums in shared memory.  Row strides in floats (``*_stride``)
    are padded so that the rows of a tensor-core fragment fall on different
    shared-memory banks.  ``split`` and ``key_tile`` are fixed by the kernel
    (its D-chunk instance and a constant), not chosen."""

    t: int
    s: int
    d: int
    warps: int
    d_chunk: int
    row_tiles: int
    key_block: int = 0

    @property
    def split(self) -> int:
        return _split(self.d_chunk)

    @property
    def key_tile(self) -> int:
        return KEY_TILE

    @property
    def tiles(self) -> int:
        return self.warps // self.split

    @property
    def q_stride(self) -> int:
        return self.d + 4  # 4 (mod 8): A fragments read rows g, cols t

    @property
    def p_stride(self) -> int:
        keys = self.key_block or self.s
        return -(-keys // N_TILE) * N_TILE + 4  # the strip's keys padded to the n-tile

    @property
    def o_stride(self) -> int:
        return self.d + (8 - self.d) % 32  # float2 at rows g, cols 2t: 8 (mod 32)

    @property
    def k_stride(self) -> int:
        return self.d_chunk + 4  # K is B "col": rows g, cols t, like A

    @property
    def v_stride(self) -> int:
        # V is B "row": rows t, cols g, so the stride must be 8 or 24 (mod 32)
        return self.d_chunk if self.d_chunk % 16 == 8 else self.d_chunk + 8

    @property
    def smem_bytes(self) -> int:
        """Q rows, one score strip a tile, two K/V buffers, and key-blocked
        the output sums and each row's alpha and l (the formula of
        ``smem_bytes`` in the CUDA source)."""
        rows = ROWS * self.tiles
        ring = 2 * self.key_tile * max(self.k_stride, self.v_stride)
        blocked = rows * self.o_stride + 2 * rows if self.key_block else 0
        return 4 * (rows * self.q_stride + rows * self.p_stride + ring + blocked)

    def key_blocks(self) -> list[tuple[int, int]]:
        """(first key, keys) of each block the kernel walks, in order."""
        step = self.key_block or self.s
        return [(k0, min(step, self.s - k0)) for k0 in range(0, self.s, step)]

    def ints(self, b: int) -> list[int]:
        """What the C entry point takes, in its order."""
        return [b, self.t, self.s, self.d, self.warps, self.d_chunk, self.row_tiles,
                self.key_block, self.smem_bytes]


@functools.lru_cache(maxsize=256)
def attention_plan(t: int, s: int, d: int) -> AttentionPlan:
    """The plan for q (B,t,d), k and v (B,s,d); raises for a shape the kernel
    does not take.  Up to ``S_MAX`` keys one strip a tile, past it blocks of
    ``KEY_BLOCK`` keys.  The 16-row tiles are spread evenly over the blocks
    (75 rows: 2 blocks of 3 tiles, not 4 + 1); a plan over the
    shared-memory budget takes fewer tiles a block."""
    if d < N_TILE or d % N_TILE:
        raise ValueError(f"the attention kernel takes D a multiple of {N_TILE}, got D={d}")
    if s < 1:
        raise ValueError(f"the attention kernel takes S >= 1 keys, got S={s}")
    if t < 1:
        raise ValueError(f"no plan for T={t} query rows")
    d_chunk = next(c for c in D_CHUNKS if d % c == 0)
    split = _split(d_chunk)
    all_tiles = -(-t // ROWS)
    tiles = -(-all_tiles // -(-all_tiles // TILES))
    while True:
        plan = AttentionPlan(t, s, d, tiles * split, d_chunk, -(-all_tiles // tiles),
                             0 if s <= S_MAX else KEY_BLOCK)
        if plan.smem_bytes <= MAX_SMEM:
            return plan
        if tiles == 1:
            raise ValueError(f"the attention kernel does not fit D={d}, S={s}: "
                             f"{plan.smem_bytes} bytes of shared memory, {MAX_SMEM} at most")
        tiles -= 1


# ---- the kernel


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("masked_attention")
    lib.vcagan_masked_attention.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
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
    does not take and on a launch error.  Its result has no gradient, so it
    raises where autograd would need one: ``masked_cross_attention`` is the
    differentiable entry."""
    global LAUNCHES
    refuse_grad("masked_attention", q=q, k=k, v=v)
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on the same CUDA device as q, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError(f"{name} must be a 3-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    b, t, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, d) or v.shape != (b, s, d) or lengths.shape != (b,):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} lengths {tuple(lengths.shape)}"
        )
    if b > 65535:
        raise ValueError(f"the kernel takes B <= 65535, got {b}")
    out = torch.empty_like(q)
    if t == 0 or b == 0:
        return out
    ints = (ctypes.c_int * PLAN_INTS)(*attention_plan(t, s, d).ints(b))
    lib = _lib()
    err = lib.vcagan_masked_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ctypes.addressof(ints), PLAN_INTS, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.vcagan_cuda_error_string(err).decode()
        raise RuntimeError(f"masked_attention kernel launch failed ({err}): {msg}")
    LAUNCHES += 1
    return out


class MaskedAttention(torch.autograd.Function):
    """The attention with a gradient: forward by the kernel on CUDA tensors
    (the plain version on CPU tensors), backward by autograd of the plain
    version recomputed from the saved q, k, v (no backward kernel, as in the
    JAX package).  ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        ctx.save_for_backward(q, k, v, lengths)
        if q.device.type == "cuda":
            return masked_attention_cuda(q, k, v, lengths)
        return masked_attention_reference(q, k, v, lengths)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = masked_attention_reference(*inputs, lengths)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None


def masked_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Keys at positions >= lengths[b] get zero weight.  CPU tensors take the
    plain version; CUDA tensors the kernel; anything else raises.  Where
    autograd needs the result's gradient, both go through
    ``MaskedAttention``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no masked attention for device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return MaskedAttention.apply(q, k, v, lengths)
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, lengths)
    return masked_attention_cuda(q, k, v, lengths)
