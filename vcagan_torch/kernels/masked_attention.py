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

The plan (``attention_plan``) is chosen here, where the CPU tests reach
it, and goes to the C entry point as plain ints, which refuses one that
does not match.  The kernels compute with D a multiple of 8 (``kernel_d``);
``padded_attention`` gives them any other D padded with zero columns, and
the plan carries the true D for the scale.  Three instances, among whose
plans (``candidate_plans``) the planner takes the least modelled time on
the card (``routing_cost``):

- up to ``S_MAX`` keys and ``IN_MAX_D`` columns, the in-block instance
  (``LongAttentionPlan(in_block=True)``): one launch a call, a block of 64
  query rows on ``wgmma`` whose producer warpgroups split the K and V pieces
  the TMA unit brings into their TF32 parts in shared memory, over the key
  blocks of ``IN_KEY_BLOCK`` keys below the sample's length with an online
  softmax, key splits and a combine launch where a call has few blocks;
- up to ``S_MAX`` keys, where it fits shared memory, the strip instance
  (``AttentionPlan``: warps a block, key tile, D chunk, shared memory,
  grid): all keys in one score strip a tile, on ``mma.sync``; the planner
  takes it where it is far faster (many blocks of few rows) and where D
  passes ``IN_MAX_D``;
- past ``S_MAX`` keys, and where D passes ``IN_MAX_D`` and no strip fits,
  the split pass (``LongAttentionPlan``): a first launch splits Q, K and V
  once into their TF32 parts, then a block is one warpgroup's 64 query rows
  and 256 output columns (D past 256 takes column slices, each computing
  the scores again) on ``wgmma`` over one split's share of the key blocks of
  ``KEY_BLOCK`` keys, and a third launch combines the splits.

``masked_attention_reference_3xtf32(..., key_block=, key_splits=)`` is the
key-blocked instances' arithmetic in plain PyTorch.  Every instance takes
any B: the entry points launch chunks of at most 65535 samples (and, for
the split pass and the key splits, of a workspace under 2^31 floats) one
after another.  Only S = 0 (no key) and T = 0 (``masked_attention_cuda``
returns the empty output) have no plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from vcagan_torch import tracing
from vcagan_torch.kernels import _build, refuse_grad
from vcagan_torch.kernels._tf32 import split_tf32

NEG_INF = -1e30  # mask value; not -inf, so an all-masked row stays finite

MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
MAX_GRID_B = 65535  # samples a launch: the grid's y (strip) and z (past S_MAX) axes
TILES = 4  # 16-row query tiles a block, at most
SPLIT = 2  # warps a tile, each computing every other n-tile of a piece
# (one warp where the D chunk is a single n-tile of 8 columns)
ROWS = 16  # query rows of one tile (the m16n8k8 fragment's M)
KEY_TILE = 32  # keys of one streamed K or V piece
N_TILE = 8  # keys (QK^T) or columns (PV) of one tensor-core product
D_CHUNKS = (64, 8)  # the D chunk: 64 where it divides D (the model's 256), else 8
S_MAX = 512  # keys of the one-strip plan: the score strips of 4 tiles at D = 256 fit
PLAN_INTS = 10

# Past S_MAX keys (``LongAttentionPlan``): a block is one warpgroup's 64 query
# rows over a share of the key blocks, on wgmma.
KEY_BLOCK = 64  # keys a key block: the N of Q K^T's wgmma
LONG_ROWS = 64  # query rows a block: the wgmma tile's M
LONG_CHUNK = 64  # D columns a piece of Q, K or V
SLICE_D = 256  # output columns a block: its sums stay in registers, 128 a thread
LONG_SLOTS = 3  # pieces in shared memory: in use, arrived, arriving
PART_FLOATS = KEY_BLOCK * LONG_CHUNK  # a piece's hi (or lo) part
SMS = 132  # streaming multiprocessors of an H100 SXM
LONG_PLAN_INTS = 14
# A launch's workspace, at most (8 GB): more samples go in chunks that reuse
# it.  One sample may pass it (the C side's offsets are 64-bit).
WORKSPACE_FLOATS = 2**31 - 1
# The split model's costs (``LongAttentionPlan.cost_us``), fitted to the
# kernel's times on an NVIDIA H100 80GB HBM3 at 700 W (``python3 -m
# vcagan_torch.kernels.tune_attention``): a block's time a key block, its
# fixed time (Q's copy, the epilogue), and the combine's bytes rate.
KEY_BLOCK_US = 7.5
BLOCK_US = 4.0
COMBINE_BYTES_PER_US = 2.5e6
# The in-block instance (``LongAttentionPlan(in_block=True)``): one launch,
# a consumer and two producer warpgroups a block; pieces of IN_COLS columns.
IN_COLS = 32
IN_RAW_SLOTS = 4
IN_SPLIT_SLOTS = 6
IN_KEY_BLOCK = 40  # keys a key block: Q K^T's N (the consumer's 248 registers)
IN_MAX_D = 256  # the consumer's output registers: 256 columns
# The instances' models of a call's microseconds, fitted to their times on
# an NVIDIA H100 80GB HBM3 at 700.00 W (``python3 -m
# vcagan_torch.kernels.tune_attention --short``, the rows up to 512 keys).
# In-block (``LongAttentionPlan.cost_us``): a call, then a wave of blocks
# (one an SM): its Q (a part a chunk of 32 columns) and its share of key
# blocks (a part a chunk), then the combine's bytes at COMBINE_BYTES_PER_US.
IN_CALL_US = 2.7
IN_WAVE_US, IN_WAVE_CHUNK_US = 1.06, 0.87
IN_KEY_BLOCK_US, IN_KEY_BLOCK_CHUNK_US = 0.3, 0.925
# The strip (``AttentionPlan.cost_us``): a call, then a wave of co-resident
# blocks (blocks sharing an SM take STRIP_SHARE longer each): a fixed part
# and the K and V pieces times the block's row tiles, a piece's time growing
# with its D chunk.
STRIP_CALL_US = 15.48
STRIP_WAVE_US = 0.683
STRIP_PIECE_US, STRIP_PIECE_CHUNK_US = 0.2634, 0.0701
STRIP_SHARE = 0.1
# The strip's model is within 24% of its times (the in-block one within 20%
# where a wave is full, 35% where it is not; PERF.md section 6): the strip is
# routed only where its model is this share of the in-block one's or less.
STRIP_MARGIN = 0.8


def masked_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
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
    passes: int = 3, key_pad: int = 1, key_block: int = 0, key_splits: int = 1,
) -> torch.Tensor:
    """The fp32 function with both products done as the kernel does them:
    operands split into TF32 parts, lo*hi + hi*lo first, then hi*hi, summed
    in fp32; P = softmax of the scaled, masked scores is split too.
    ``passes=1`` keeps the hi*hi products only (single-pass TF32), to show
    what the split buys.  ``key_pad``: pad the keys with zero rows of K and V
    to a multiple of it, as the kernel's tiles do, and give the padded keys
    weight exactly 0 (score -inf), so the result does not change.

    ``key_block`` > 0: the arithmetic of the key-blocked instances (past
    ``S_MAX`` keys, and the in-block instance), all samples at once.  A
    sample walks the key blocks of ``key_block`` keys
    (the last one padded to ``key_pad``) that hold a key below its length
    (all of them for a length <= 0), shared out over ``key_splits`` splits
    as ``LongAttentionPlan.key_ranges`` shares them.  In each split a row
    keeps its running maximum m, the sum l of exp(s - m) and the
    unnormalised output O: a block with maximum m_blk sets m_new = max(m,
    m_blk), alpha = exp(m - m_new) (0 before the first block), e = exp(s -
    m_new), l = l alpha + sum e, O = O alpha + e V.  The splits that walked
    a block combine: M = max m_i, the result is sum exp(m_i - M) O_i / sum
    exp(m_i - M) l_i."""

    def product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a_hi, a_lo = split_tf32(a)
        b_hi, b_lo = split_tf32(b)
        if passes == 1:
            return torch.einsum(eq, a_hi, b_hi)
        return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + torch.einsum(
            eq, a_hi, b_hi
        )

    def scores(q: torch.Tensor, k_blk: torch.Tensor, lengths: torch.Tensor,
               start: int) -> torch.Tensor:
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
        probs = torch.softmax(scores(q, k, lengths, 0), dim=-1)
        return product("bts,bsd->btd", probs, v)
    # The key-blocked walk, every sample at once: block i belongs to split n
    # of a sample that walks w blocks where n w // splits <= i < (n + 1) w //
    # splits (``key_ranges``); a sample outside a block keeps its m, l, O.
    lens = lengths.to(q.device).long()
    walked = (torch.where(lens >= 1, lens.clamp(max=s), torch.full_like(lens, s))
              + key_block - 1) // key_block
    rows = (q.shape[0], q.shape[1], 1)
    parts = []
    for n in range(key_splits):
        first, end = n * walked // key_splits, (n + 1) * walked // key_splits
        m = torch.full(rows, -math.inf, dtype=q.dtype, device=q.device)
        l = torch.zeros(rows, dtype=q.dtype, device=q.device)
        o = torch.zeros_like(q[..., :v.shape[2]])
        for i in range(-(-s // key_block)):
            take = ((first <= i) & (i < end))[:, None, None]
            if not take.any():
                continue
            start = i * key_block
            k_blk, v_blk = pad(k[:, start:start + key_block]), pad(v[:, start:start + key_block])
            sc = scores(q, k_blk, lengths, start)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))  # finite: a key < S
            e = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)  # 0 before the first block
            m = torch.where(take, m_new, m)
            l = torch.where(take, l * alpha + e.sum(-1, keepdim=True), l)
            o = torch.where(take, o * alpha + product("bts,bsd->btd", e, v_blk), o)
        parts.append((m, l, o))
    top = torch.stack([m for m, _, _ in parts]).amax(0)  # finite: a split walked a block
    w = [torch.exp(m - top) for m, _, _ in parts]  # 0 for a split without a block
    return (sum(wi * o for wi, (_, _, o) in zip(w, parts))
            / sum(wi * l for wi, (_, l, _) in zip(w, parts)))


# ---- D padded to the kernels' multiple of 8


def kernel_d(d: int) -> int:
    """The D the kernels compute with: D rounded up to a multiple of
    ``N_TILE`` (8), at least 8."""
    return max(N_TILE, -(-d // N_TILE) * N_TILE)


def padded_attention(q, k, v, lengths, attend):
    """``attend(q', k', v', lengths)`` on q, k and v with D padded with
    zero columns to ``kernel_d(D)``; the first D columns of its output.
    Zero columns add nothing to q k^T and give zero output columns, so the
    result is the unpadded one where ``attend`` scales the scores by the
    true D (the plans carry it).  Where D needs no padding, ``attend`` gets
    the tensors themselves."""
    d = q.shape[-1]
    pad = kernel_d(d) - d
    if not pad:
        return attend(q, k, v, lengths)
    out = attend(*(F.pad(x, (0, pad)) for x in (q, k, v)), lengths)
    return out[..., :d].contiguous()


# ---- the tile plan


def _split(d_chunk: int) -> int:
    """Warps a 16-row tile: the kernel's instance for ``d_chunk``."""
    return SPLIT if d_chunk > N_TILE else 1


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One launch's tiling up to ``S_MAX`` keys (the strip instance).  A
    block is one sample and ``tiles`` tiles of 16 query rows, each computed
    by ``split`` warps (``warps`` in all, which share the n-tiles of every
    product); the grid is (``row_tiles``, B).  K, then V, stream through a
    ring of two buffers in pieces of ``key_tile`` keys x ``d_chunk``
    columns; all S keys stand in one score strip a tile (``key_block`` 0).
    Row strides in floats (``*_stride``) are padded so that the rows of a
    tensor-core fragment fall on different shared-memory banks.  ``split``
    and ``key_tile`` are fixed by the kernel (its D-chunk instance and a
    constant), not chosen.  ``d`` is the true D; the kernel computes with
    ``d_kernel`` (``kernel_d``), whose padded columns are zeros."""

    t: int
    s: int
    d: int
    warps: int
    d_chunk: int
    row_tiles: int
    b: int = 1

    @property
    def key_block(self) -> int:
        return 0

    @property
    def d_kernel(self) -> int:
        return kernel_d(self.d)

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
        return self.d_kernel + 4  # 4 (mod 8): A fragments read rows g, cols t

    @property
    def p_stride(self) -> int:
        return -(-self.s // N_TILE) * N_TILE + 4  # the strip's keys padded to the n-tile

    @property
    def k_stride(self) -> int:
        return self.d_chunk + 4  # K is B "col": rows g, cols t, like A

    @property
    def v_stride(self) -> int:
        # V is B "row": rows t, cols g, so the stride must be 8 or 24 (mod 32)
        return self.d_chunk if self.d_chunk % 16 == 8 else self.d_chunk + 8

    @property
    def smem_bytes(self) -> int:
        """Q rows, one score strip a tile, two K/V buffers (the formula of
        ``smem_bytes`` in the CUDA source)."""
        rows = ROWS * self.tiles
        ring = 2 * self.key_tile * max(self.k_stride, self.v_stride)
        return 4 * (rows * self.q_stride + rows * self.p_stride + ring)

    def key_blocks(self) -> list[tuple[int, int]]:
        """(first key, keys) of each block the kernel walks: the one strip."""
        return [(0, self.s)]

    def cost_us(self) -> float:
        """The strip's model: waves of co-resident blocks (as many as
        shared memory and the SM's warps allow), each a fixed part and its K
        and V pieces times its row tiles."""
        b = min(self.b, MAX_GRID_B)
        blocks = self.row_tiles * b
        resident = max(1, min(MAX_SMEM // (self.smem_bytes + 1024), 64 // self.warps))
        waves = -(-blocks // (SMS * resident))
        sharing = min(-(-blocks // SMS), resident)
        pieces = 2 * -(-self.s // self.key_tile) * (self.d_kernel // self.d_chunk)
        wave = STRIP_WAVE_US + pieces * self.tiles * (
            STRIP_PIECE_US + STRIP_PIECE_CHUNK_US * self.d_chunk / 64)
        return STRIP_CALL_US + -(-self.b // b) * waves * (1 + STRIP_SHARE * (sharing - 1)) * wave

    def describe(self) -> str:
        return (f"{self.row_tiles} x {self.tiles} tiles of 16 rows, {self.split} warps a tile, "
                f"D chunk {self.d_chunk}")

    def ints(self, b: int) -> list[int]:
        """What the C entry point takes, in its order: B (any: the entry
        point launches chunks of ``MAX_GRID_B`` samples), T, S, the kernel's
        D and the true D, then the tiling."""
        return [b, self.t, self.s, self.d_kernel, self.d, self.warps, self.d_chunk,
                self.row_tiles, self.key_block, self.smem_bytes]


def key_ranges(s: int, length: int, key_block: int, splits: int) -> list[tuple[int, int]]:
    """(first key, keys) each split walks, as the kernel past ``S_MAX`` keys
    shares them out (keys 0 for a split with no block): the blocks of
    ``key_block`` keys that hold a key below ``length`` (all of them for a
    length <= 0, whose rows average the S values), ``splits`` contiguous
    shares of them that differ by at most one block."""
    keys = min(length, s) if length >= 1 else s
    blocks = -(-keys // key_block)
    ranges = []
    for i in range(splits):
        b0, b1 = i * blocks // splits, (i + 1) * blocks // splits
        ranges.append((b0 * key_block, min(b1 * key_block, s) - b0 * key_block))
    return ranges


@dataclasses.dataclass(frozen=True)
class LongAttentionPlan:
    """One call of a key-blocked instance: the in-block one (``in_block``,
    up to ``S_MAX`` keys and ``IN_MAX_D`` columns; below) or the split
    pass (past ``S_MAX`` keys, or where D passes ``IN_MAX_D`` and no strip
    fits).  The split pass: a first launch splits Q, K and V once into their
    TF32 parts, in
    ``pieces`` pieces of 64 rows x ``LONG_CHUNK`` columns laid out as wgmma
    reads them.  The attention's grid is (``row_blocks`` x ``slices``,
    ``splits``, samples): a block is one warpgroup, 64 query rows of one
    sample and ``SLICE_D`` output columns (its slice; D past it takes more
    slices, each computing the scores again) over one split's share of its
    key blocks (``key_ranges``), the pieces brought by bulk copies.  With one
    split the blocks write the output; with more, each writes its rows'
    maximum m, sum l and unnormalised output O and a third launch combines
    them.  The workspace (``workspace_floats`` fp32 values) holds the
    pieces, then those partials, of one launch of ``launch_b`` samples:
    ``b`` samples go in ``launches`` such launches, one after another.
    Shared memory holds Q's parts (D padded to ``LONG_CHUNK``; past
    ``SLICE_D`` Q streams with K instead), ``LONG_SLOTS`` slots of a piece's
    parts and an mbarrier each (``smem_bytes``; the formula of
    ``long_smem_bytes`` in the CUDA source).  ``d`` is the true D; the
    kernel computes with ``d_kernel`` (``kernel_d``).  ``batch``: samples a
    launch, 0 for all of them up to ``MAX_GRID_B``.

    The in-block instance (``key_block`` ``IN_KEY_BLOCK``): one launch (and
    the combine for more than one split), no split pass, so no pieces in
    the workspace, only the splits' partials.  A block is 64 query rows of
    one sample and all of D: a consumer warpgroup on wgmma and two producer
    warpgroups that split the K and V pieces of ``IN_COLS`` columns the TMA
    unit brings (``IN_RAW_SLOTS`` raw slots, ``IN_SPLIT_SLOTS`` split
    slots); shared memory holds Q's parts and both rings (``smem_bytes``;
    ``in_smem_bytes`` in the CUDA source)."""

    t: int
    s: int
    d: int
    b: int
    splits: int
    batch: int = 0
    in_block: bool = False
    key_block: int = KEY_BLOCK

    @property
    def d_kernel(self) -> int:
        return kernel_d(self.d)

    @property
    def launch_b(self) -> int:
        return self.batch or min(self.b, MAX_GRID_B)

    @property
    def launches(self) -> int:
        return -(-self.b // self.launch_b)

    @property
    def row_blocks(self) -> int:
        return -(-self.t // LONG_ROWS)

    @property
    def key_blocks_all(self) -> int:
        return -(-self.s // self.key_block)

    @property
    def chunks(self) -> int:
        return -(-self.d_kernel // LONG_CHUNK)

    @property
    def slices(self) -> int:
        return -(-self.d_kernel // SLICE_D)

    @property
    def blocks(self) -> int:
        """Blocks of one launch."""
        return self.row_blocks * self.slices * self.splits * self.launch_b

    @property
    def smem_bytes(self) -> int:
        if self.in_block:  # Q's parts, the raw ring, the split ring, the mbarriers
            return (2 * LONG_ROWS * -(-self.d_kernel // IN_COLS) * IN_COLS * 4
                    + (IN_RAW_SLOTS + 2 * IN_SPLIT_SLOTS) * IN_KEY_BLOCK * IN_COLS * 4
                    + 8 * (IN_RAW_SLOTS + 2 * IN_SPLIT_SLOTS))
        if self.slices > 1:  # a slot holds a K piece's parts and a Q piece's
            return LONG_SLOTS * 4 * 4 * PART_FLOATS + 8 * (LONG_SLOTS + 1)
        return (2 * self.chunks + 2 * LONG_SLOTS) * 4 * PART_FLOATS + 8 * (LONG_SLOTS + 1)

    @property
    def pieces(self) -> int:
        """Pieces of one launch's split pass: Q's, then K's and V's."""
        if self.in_block:
            return 0
        return self.chunks * self.launch_b * (self.row_blocks + 2 * self.key_blocks_all)

    @property
    def partial_floats(self) -> int:
        if self.splits == 1:
            return 0
        return self.splits * self.launch_b * self.t * (self.d_kernel + 2)

    @property
    def workspace_floats(self) -> int:
        return 2 * PART_FLOATS * self.pieces + self.partial_floats

    def key_blocks(self) -> list[tuple[int, int]]:
        """(first key, keys) of each key block of S, in order."""
        kb = self.key_block
        return [(k0, min(kb, self.s - k0)) for k0 in range(0, self.s, kb)]

    def key_ranges(self, length: int) -> list[tuple[int, int]]:
        return key_ranges(self.s, length, self.key_block, self.splits)

    def cost_us(self) -> float:
        """The models, a launch: waves of blocks (one an SM), each a
        key-block share long, plus the combine's bytes (each split's O read,
        the output written).  The split pass: a key block's time grows with
        the pieces it takes past the 4 + 4 of D = 256 (the scores over all of
        D, the slice's V).  The in-block instance: a wave's Q and a key
        block's pieces grow with D's chunks of ``IN_COLS``."""
        waves = -(-self.blocks // SMS)
        share = -(-self.key_blocks_all // self.splits)
        combine = 0.0
        if self.splits > 1:
            combine = ((self.splits + 1) * self.launch_b * self.t * self.d_kernel * 4
                       / COMBINE_BYTES_PER_US)
        if self.in_block:
            nq = -(-self.d_kernel // IN_COLS)
            wave = (IN_WAVE_US + IN_WAVE_CHUNK_US * nq
                    + share * (IN_KEY_BLOCK_US + IN_KEY_BLOCK_CHUNK_US * nq))
            return IN_CALL_US + self.launches * (waves * wave + combine)
        work = max(1.0, (self.chunks + self.chunks / self.slices) / 8)
        return self.launches * (waves * (share * KEY_BLOCK_US * work + BLOCK_US) + combine)

    def describe(self) -> str:
        launches = f"{self.launches} launches of {self.launch_b} samples, " if (
            self.launches > 1) else ""
        slices = f" x {self.slices} column slices" if self.slices > 1 else ""
        mode = "in-block split" if self.in_block else "split pass"
        return (f"{mode}: {launches}{self.row_blocks}{slices} x {self.splits} x {self.launch_b} = "
                f"{self.blocks} blocks of {LONG_ROWS} rows, {self.splits} key split(s) over "
                f"{self.key_blocks_all} key blocks of {self.key_block}, {self.smem_bytes} B "
                f"shared, workspace {self.workspace_floats * 4 / 1e6:.2f} MB ({self.pieces} split "
                f"pieces, {self.partial_floats * 4 / 1e6:.2f} MB of partials)")

    def ints(self) -> list[int]:
        """What the C entry point past ``S_MAX`` keys takes, in its order:
        B, T, S, the kernel's D, the true D, the grid, shared bytes, samples
        a launch and the workspace floats as two ints (high, low 30 bits)."""
        ws = self.workspace_floats
        return [self.b, self.t, self.s, self.d_kernel, self.d, self.row_blocks, self.splits,
                self.slices, self.key_block, self.smem_bytes, self.launch_b, ws >> 30,
                ws & (2**30 - 1), int(self.in_block)]


def _key_blocked_plans(t: int, s: int, d: int, b: int, **kind) -> list[LongAttentionPlan]:
    """A key-blocked instance's plans, a split count each.  Where a launch's
    workspace passes ``WORKSPACE_FLOATS``, the samples go in chunks that
    keep it below (one sample at least); a split count whose one sample
    alone passes it is left out (one split always stays)."""
    plans = []
    key_block = kind.get("key_block", KEY_BLOCK)
    for n in range(1, min(-(-s // key_block), MAX_GRID_B) + 1):
        plan = LongAttentionPlan(t, s, d, b, n, **kind)
        if plan.workspace_floats > WORKSPACE_FLOATS:
            per_sample = plan.workspace_floats // plan.launch_b
            plan = dataclasses.replace(plan, batch=max(1, WORKSPACE_FLOATS // per_sample))
            if n > 1 and plan.workspace_floats > WORKSPACE_FLOATS:
                continue  # one sample's partials alone pass it: fewer splits do
        plans.append(plan)
    return plans


def _long_plans(t: int, s: int, d: int, b: int) -> list[LongAttentionPlan]:
    """The split pass's plans (``cost_us`` picks among them: a block takes
    229 KB of shared memory, so an SM runs one at a time and a wave past
    the first costs a whole share; (4, 750, 750) runs 96 blocks of 6 key
    blocks, one wave, faster than 192 of 3)."""
    return _key_blocked_plans(t, s, d, b)


def strip_plan(t: int, s: int, d: int, b: int = 1) -> AttentionPlan | None:
    """The one-strip plan up to ``S_MAX`` keys where one fits shared memory,
    else None: the 16-row tiles spread evenly over the blocks (75 rows: 2
    blocks of 3 tiles, not 4 + 1), fewer tiles a block where a strip is over
    the budget; ``b`` counts in its cost only."""
    if s > S_MAX:
        return None
    d_chunk = next(c for c in D_CHUNKS if kernel_d(d) % c == 0)
    split = _split(d_chunk)
    all_tiles = -(-t // ROWS)
    tiles = -(-all_tiles // -(-all_tiles // TILES))
    while tiles:
        plan = AttentionPlan(t, s, d, tiles * split, d_chunk, -(-all_tiles // tiles), b)
        if plan.smem_bytes <= MAX_SMEM:
            return plan
        tiles -= 1
    return None


def _in_block_plans(t: int, s: int, d: int, b: int) -> list[LongAttentionPlan]:
    """The in-block instance's plans (D up to ``IN_MAX_D``)."""
    if kernel_d(d) > IN_MAX_D:
        return []
    return _key_blocked_plans(t, s, d, b, in_block=True, key_block=IN_KEY_BLOCK)


def candidate_plans(t: int, s: int, d: int, b: int = 1) -> list:
    """Every plan ``attention_plan`` chooses among for the shape: up to
    ``S_MAX`` keys and ``IN_MAX_D`` columns the in-block instance's (each
    key block and split count) and the strip's; past ``IN_MAX_D`` columns
    the strip's where one fits shared memory, else the split pass's; past
    ``S_MAX`` keys the split pass's (each split count)."""
    strip = strip_plan(t, s, d, b)
    if s > S_MAX:
        return _long_plans(t, s, d, b)
    if kernel_d(d) > IN_MAX_D:
        return [strip] if strip else _long_plans(t, s, d, b)
    return _in_block_plans(t, s, d, b) + ([strip] if strip else [])


def routing_cost(plan) -> float:
    """What ``attention_plan`` minimises: the modelled microseconds, the
    strip's over ``STRIP_MARGIN``."""
    return plan.cost_us() / (STRIP_MARGIN if isinstance(plan, AttentionPlan) else 1.0)


def instance(plan) -> str:
    """The kernel instance a plan launches."""
    if isinstance(plan, AttentionPlan):
        return "strip"
    return "in_block" if plan.in_block else "split_pass"


def kernel_launches(plan, b: int) -> int:
    """The kernel launches of one call of ``plan`` on ``b`` samples: the
    strip one a chunk of ``MAX_GRID_B`` samples; the key-blocked instances,
    a chunk of ``launch_b`` samples each, the in-block attention or the split
    pass and its attention, and the combine where there is more than one
    split."""
    if isinstance(plan, AttentionPlan):
        return -(-b // MAX_GRID_B)
    return plan.launches * ((1 if plan.in_block else 2) + (plan.splits > 1))


def in_block_plan(t: int, s: int, d: int, b: int = 1) -> LongAttentionPlan | None:
    """The in-block instance's plan of least modelled time for the shape,
    whether or not ``attention_plan`` routes it there (chip_smoke and the
    tuner hold the instance at every shape it takes); None where it takes
    none (past ``S_MAX`` keys or ``IN_MAX_D`` columns)."""
    plans = _in_block_plans(t, s, d, b) if s <= S_MAX else []
    return min(plans, key=lambda p: p.cost_us()) if plans else None


@functools.lru_cache(maxsize=256)
def attention_plan(t: int, s: int, d: int, b: int = 1) -> AttentionPlan | LongAttentionPlan:
    """The plan for q (b,t,d), k and v (b,s,d), any D >= 1 and B; raises
    for S or T < 1: the least ``routing_cost`` of ``candidate_plans`` (ties
    to the first: the in-block instance, fewer splits).  Every main path's
    shape up to 512 keys takes the in-block instance; the strip takes
    shapes of many blocks of few rows (B = 70,000 x T = 2) and, up to 512
    keys, D past ``IN_MAX_D`` where it fits."""
    if d < 1:
        raise ValueError(f"the attention kernel takes D >= 1, got D={d}")
    if s < 1:
        raise ValueError(f"the attention kernel takes S >= 1 keys, got S={s}")
    if t < 1:
        raise ValueError(f"no plan for T={t} query rows")
    return min(candidate_plans(t, s, d, b), key=routing_cost)


# ---- the kernel


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("masked_attention")
    lib.vcagan_masked_attention.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p
    ]
    lib.vcagan_masked_attention.restype = ctypes.c_int
    lib.vcagan_masked_attention_long.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p
    ]
    lib.vcagan_masked_attention_long.restype = ctypes.c_int
    lib.vcagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def masked_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    plan: LongAttentionPlan | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on any input it
    does not take and on a launch error.  Its result has no gradient, so it
    raises where autograd would need one: ``masked_cross_attention`` is the
    differentiable entry.  Past ``S_MAX`` keys ``plan`` may name the split
    count (as a tuner does); by default ``attention_plan`` chooses it.  The
    lengths stay on the device: the kernels read them.  D not a multiple of
    8 goes through ``padded_attention`` (copies of q, k and v with zero
    columns, and of the output's first D columns).  Counted
    (``vcagan_torch.tracing``): one in ``attention.calls``, and its
    ``kernel_launches`` in ``attention.launches`` and
    ``attention.launches.<instance>``."""
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
    if t == 0 or b == 0:
        return torch.empty_like(q)
    plan = plan or attention_plan(t, s, d, b)
    if isinstance(plan, LongAttentionPlan) and (plan.b, plan.t, plan.s, plan.d) != (b, t, s, d):
        raise ValueError(f"the plan {plan} is not for B={b} T={t} S={s} D={d}")
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def attend(q, k, v, lengths):
        out = torch.empty_like(q)
        pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                    out.data_ptr())
        if isinstance(plan, LongAttentionPlan):
            ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=q.device)
            ints = (ctypes.c_int * LONG_PLAN_INTS)(*plan.ints())
            err = lib.vcagan_masked_attention_long(
                *pointers, ws.data_ptr(), ctypes.addressof(ints), LONG_PLAN_INTS,
                q.device.index, stream,
            )
        else:
            ints = (ctypes.c_int * PLAN_INTS)(*plan.ints(b))
            err = lib.vcagan_masked_attention(
                *pointers, ctypes.addressof(ints), PLAN_INTS, q.device.index, stream,
            )
        if err != 0:
            msg = lib.vcagan_cuda_error_string(err).decode()
            raise RuntimeError(f"masked_attention kernel launch failed ({err}): {msg}")
        return out

    out = padded_attention(q, k, v, lengths, attend)
    launches = kernel_launches(plan, b)
    tracing.count("attention.calls")
    tracing.count("attention.launches", launches)
    tracing.count(f"attention.launches.{instance(plan)}", launches)
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
    ``MaskedAttention``.  Traced as the span ``attention`` (the forward)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no masked attention for device {q.device}")
    with tracing.span("attention"):
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return MaskedAttention.apply(q, k, v, lengths)
        if q.device.type == "cpu":
            return masked_attention_reference(q, k, v, lengths)
        return masked_attention_cuda(q, k, v, lengths)
