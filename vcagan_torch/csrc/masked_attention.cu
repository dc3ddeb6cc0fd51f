// Length-masked cross-attention, forward, fp32:
//   out[b] = softmax(q[b] k[b]^T / sqrt(D), keys >= lengths[b] -> -1e30) v[b]
// q (B,T,D), k/v (B,S,D), lengths (B,) int32, out (B,T,D); all contiguous,
// 16-byte aligned; D a multiple of 8, any S >= 1, T >= 1 and B >= 1.  Any
// other D reaches the kernels padded with zero columns to a multiple of 8
// (vcagan_torch/kernels/masked_attention.py::padded_attention): zero
// columns add nothing to q k^T and give zero output columns, and the plan
// carries the true D (d_scale), whose square root scales the scores.
// Batches of more than 65535 samples (the grid's limit on its y and z axes)
// go in chunks of samples, launched one after another by the entry point.
//
// Replaces the TPU kernel vcagan/kernels/masked_attention.py:50-121
// (_attention_kernel / _attention_pallas), which holds one sample's whole
// (T,S) score matrix in VMEM.  Edge semantics are the JAX ones: the mask
// value is -1e30, not -inf, so a row with lengths[b] <= 0 averages all S
// values of v instead of giving NaN; lengths[b] >= S masks nothing.
//
// Bound on an H100 SXM (3.35 TB/s; tensor cores 495 TFLOP/s TF32, so 165
// TFLOP/s for fp32 done as three TF32 products) at the serving path's
// shapes, B=48, D=256, each input read once and the output written once:
//   att1  T=75,  S=75: q,k,v,out 3.69 MB each = 14.7 MB -> 4.4 us;
//                       4*B*T*S*D = 0.28 GFLOP at 165 TFLOP/s -> 1.7 us
//   att2  T=150, S=75: q,out 7.37 MB, k,v 3.69 MB = 22.1 MB -> 6.6 us;
//                       0.55 GFLOP -> 3.4 us
// so both are bound by bytes.  (The earlier FMA kernel's bound divided by
// the 67 TFLOP/s of fp32 outside the tensor cores, which made att2 bound by
// operations; that was the bound of that design, not of the card.)
//
// Three instances; the planner (masked_attention.py::attention_plan) routes
// each shape to the one its models of the card's times favour:
// - up to 512 keys and D up to 256, the in-block instance (wgmma, one launch
//   a call, the operands split in the block; below), but for the shapes of
//   many blocks of few rows where the strip is faster (B = 70,000 x T = 2);
// - up to 512 keys otherwise, the strip instance (mma.sync; below that);
// - past 512 keys, the split pass (wgmma over operands split by a first
//   launch; last).
//
// Up to 512 keys and D up to 256: the in-block instance.  The bound is the
// bytes (above), and a call moves little: what costs is latency and the
// shared memory's bandwidth, which the 3xTF32 products read three times.
// - A block is 64 query rows (wgmma's M) and three warpgroups: a consumer,
//   which runs the products and the softmax, and two producers.  Q's rows
//   are loaded once by the whole block (global loads, zeros past T and D)
//   and split into their TF32 hi and lo parts in shared memory, laid out as
//   wgmma reads them (K-major core matrices, no swizzle: the split pass's
//   layout); 128 KB at D = 256, so an SM runs one block.
// - K, then V, of each key block of 40 keys (Q K^T's N: at 64 the
//   consumer's registers spilled; 40 walks S = 75 in two blocks, 7% of the
//   keys padding) come in pieces of 32 columns: the TMA unit brings a
//   piece as fp32 (a box of 32 x 40 of a (B S, D) tensor map; zeros past D,
//   the rows past the sample's keys zeroed by the producer) into a ring of
//   four raw slots, one mbarrier each; producer warpgroup j mod 2 reads
//   piece j, splits it and writes its parts into a ring of six split slots
//   (V transposed: key 2i + h of a k-step at k-position 4h + i, where P's A
//   fragment holds it); each thread's reads and writes of a piece fall on
//   distinct banks.  A producer's writes are made visible to wgmma by a
//   proxy fence (MEMBAR and FENCE.VIEW.ASYNC): no load of the thread may be
//   in flight there, or the fence waits for it, which is why the raw pieces
//   come by TMA (the copies of global loads or cp.async into the thread's
//   own registers or slots made each piece wait a memory latency).
// - The consumer: for each key block, the scores of its 64 rows x 40 keys
//   over two pieces at a time (8 k-steps, a fresh 3xTF32 sum: lo*hi, hi*lo,
//   hi*hi, wgmma m64n40k8 with A and B from shared memory), the online
//   softmax in the accumulator registers (as past 512 keys), P's parts as
//   the A fragments of P.V (m64n32k8, A from registers) over each V piece,
//   the output's 256 columns in 128 registers.  Key blocks at or past each
//   length >= 1 are not walked.
// - Registers: 384 threads have 168 each at launch; setmaxnreg gives the
//   consumer 248 and the producers 128.
// - Grid fill: key splits over the grid's y axis and the combine launch, as
//   past 512 keys, where a call has too few blocks (LRS rows: B = 8 or 16).
//   The 64-row M wastes up to 41% of a block's rows (T = 75: 128 rows for
//   75), but the rows' products do not set the pace: a key block's products
//   at D = 256 are 2 x 64 x 40 x 256 x 2 x 3 = 7.9 MFLOP, 2.1 us of an SM's
//   tensor cores, of the ~7.5 us a key block adds to a wave on the card
//   (tune_attention --short); the producers' pieces take the rest.
//
// Up to 512 keys otherwise, the strip instance (both products on the tensor
// cores, mma.sync m16n8k8 TF32):
// - A block is one sample and `tiles` tiles of 16 query rows (one m16
//   fragment each).  wgmma's 64-row tile would waste up to 53 rows of a
//   75- or 150-row sample; the 16-row tile wastes at most 15.  The plan
//   (vcagan_torch/kernels/masked_attention.py::attention_plan) spreads the
//   tiles over the blocks: 75 rows are 2 blocks of 3 tiles.  A tile is
//   computed by two warps, each taking every other n-tile of every product
//   (keys in QK^T, columns in P.V) and half the rows of the softmax (one
//   warp where the D chunk is a single n-tile): the serving shapes give
//   only 240-480 tiles for 132 SMs, so a tile's chain of products is the
//   time (one warp a tile: 0.0491 / 0.0593 ms at att1 / att2; two:
//   0.0398 / 0.0594, att2 held back by 144 blocks on 132 SMs).
// - The block's Q rows are copied to shared memory once (cp.async).  K, then
//   V, stream through a ring of two buffers in pieces of 32 keys x d_chunk
//   (64 at D = 256) columns: K pieces walk (key tile, chunk), V pieces
//   (chunk, key tile).  Piece p+1's copy (cp.async, 16 bytes a thread) runs
//   under piece p's products; two __syncthreads a piece.  Every warp of the
//   block uses each piece, so K and V are read once a block (from L2 by
//   every row tile of a sample).
// - QK^T: a tile's 16 rows times a piece's (up to) 4 key n-tiles; a key
//   tile's scores sum over the D chunks in registers; after the last chunk
//   they are scaled, masked and stored in the tile's 16 x S strip of shared
//   memory.  The strip is needed because the m16n8k8 C layout is not its A
//   layout (P is the A operand of P.V).
// - The padding trap: S is padded to the n-tile of 8 keys.  Padded keys get
//   score -inf (weight exactly 0), masked real keys -1e30, so a row with
//   length 0 still averages exactly the S real values; padded rows of the K
//   and V pieces are zero-filled by cp.async (so 0 * V stays 0).
// - Softmax in the strip, tile by tile: lane 4g + t owns rows g and g + 8
//   (as in the C fragment; one of the two each when a tile has two warps)
//   and the columns t, t+4, ...; max and sum by quad shuffles; expf;
//   P = e / sum written back in place; a barrier before P.V.
// - P.V: for each D chunk, the tile's 16 x d_chunk output (8 n-tiles, 4 a
//   warp) over the V pieces of that chunk; P's A fragments are read from
//   the strip.  A chunk of 64 keeps a thread's sums and fresh sums at 48
//   registers; all 256 columns at once would be 192.
// - fp32 as 3xTF32: each operand split into hi = tf32(a), lo = tf32(a - hi)
//   by integer round-and-mask (tf32.cuh); the cross terms lo*hi + hi*lo are
//   summed apart from hi*hi and added to it at the end of a piece.  The
//   tensor cores add with truncation, so a piece's products (at most 8
//   k-steps) go into fresh sums that an ordinary fp32 add puts on the
//   running sum (left in the tensor cores over D = 256, the error against
//   float64 grew from 2e-6 to 8e-6 of the 1e-5 allowed).
// - A warp issues its products in order and waits for each operand, and the
//   grid gives an SM only a few warps, so nothing else hides a wait: a k-step
//   loads and splits all its B fragments first, then issues the products
//   tile by tile in three rounds (lo*hi, hi*hi, hi*lo), so that no product
//   waits on the one before it; D chunks are template instances so that
//   the k-steps unroll: 64 columns wherever 64 divides D (the model's D is
//   256), else 8 (any other multiple of 8).  (The first version, 3 chained
//   products a tile, took 0.1 ms at both serving shapes.)
// - Bank conflicts are avoided by padding rows, not by a swizzle: Q, K and
//   the strip are read as rows g, columns t (stride 4 mod 8 floats); V as
//   rows t, columns g (stride 8 or 24 mod 32 floats).
//
// Past 512 keys, and at S <= 512 where D passes 256 and no strip plan fits
// shared memory, the split pass (three launches a call).  The
// strip of 16 x S scores a tile is what caps the strip instance at S = 512
// (four strips, Q and the K/V ring fill the 227 KB at D = 256).  Past it the
// bound is the operations (4 T S D flops of the keys below each length,
// against 4 (2 T D + 2 S D) bytes): 10.2 us at (4, 750, 750) with lengths
// 0, 750, 730, 711; 0.104 ms at (1, 4096, 4096).
// - Key blocks of 64 (Q K^T's N).  A sample walks only the key blocks that
//   hold a key below its length: a block at or past lengths[b] >= 1 would
//   add exactly 0 (exp(-1e30 - m) underflows for the finite m of a real
//   score), so it is neither split nor read; the block at the boundary is
//   masked key by key.  A length <= 0 walks all S keys (every one -1e30, so
//   the rows average the S values, as the JAX function); lengths[b] >= S
//   masks nothing.  The kernels read the lengths: the host never does.
// - Each operand is split into its TF32 hi and lo parts ONCE a call, by a
//   first launch (split_pieces_kernel) that reads it: Q, K and V in pieces
//   of 64 rows x 64 columns (zeros past T, S or D), each piece's two parts
//   laid out as wgmma reads them from shared memory (K-major core matrices
//   of 8 rows x 16 bytes, no swizzle, the fused block's layout), 32 KB a
//   piece, in the workspace.  V is transposed there (wgmma takes TF32
//   operands K-major only, and P.V contracts over keys).  Split in shared
//   memory by the attention block's own warpgroup under its products, the
//   copies and the split took several times the products' time (clock64
//   around each phase), and every row block split the same K and V again.
// - The attention: grid (row blocks, key splits, B); a block is ONE
//   warpgroup (128 threads) and 64 query rows (wgmma's M; T = 750, 1026,
//   1280, 1500 or 4096 wastes under 9% of its rows).  Shared memory holds
//   Q's parts (128 KB at D = 256) for the whole walk and three slots of a
//   K or V piece (hi and lo, 32 KB each): thread 0 asks the TMA unit for
//   piece j + 2 by bulk copies counted on the slot's mbarrier as soon as
//   piece j's products are issued (the slot piece j - 1 left).
// - Products: wgmma.mma_async TF32, m64n64k8 for Q K^T with A (Q) and B (K)
//   from shared memory, m64n32k8 for P.V with A (P) from registers and B
//   (V) from shared memory.  The scores of a key block stay in the
//   accumulator registers: scaled, masked, the online softmax (m, alpha,
//   l by quad shuffles) and P = exp(s - m) split into its parts right
//   there.  The accumulator gives a thread keys 2t and 2t + 1 of each 8;
//   P.V's A fragment wants lane columns t and t + 4, so the keys of each
//   k-step stand permuted in the transposed V (key 2i + h at k-position
//   4h + i): no shuffle.
// - 3xTF32 as in the strip instance: lo*hi, hi*lo, then hi*hi into a sum
//   that is fresh every piece (8 k-steps); an ordinary fp32 add puts it on
//   the scores or on the output.  The output of 64 rows x 256 columns
//   stays in registers (128 a thread), rescaled by alpha each key block;
//   P.V goes 32 columns at a time, so that the output, P's parts and the
//   fresh sum fit in 255 registers.
// - D past 256: column slices.  The grid's x axis is (row block, slice): a
//   block computes 256 columns of O (its slice; 4 chunks of 64) and the
//   scores again over all of D, which costs D / 256 times the Q K^T work.
//   Q's parts (128 KB at D = 256) no longer fit beside the ring, so Q
//   streams through it with K: a slot then holds a K piece and the Q piece
//   of the same columns (64 KB; three slots, 192 KB), and a key block is
//   D / 64 such pieces, then the slice's V pieces.  The softmax's m and l
//   are the same in every slice (the same scores in the same order); slice
//   0 writes them.
// - Key splits fill the card.  A sample's walked key blocks are shared out
//   over `splits` blocks in contiguous shares that differ by at most one
//   key block.  With one split a block writes O / l; with more, each writes
//   its rows' maximum m, sum l and unnormalised O (fp32) to the workspace
//   (splits x B x T x (D + 2) floats after the pieces), and a third launch
//   (combine_splits_kernel) writes M = max m_i, out = sum e^(m_i - M) O_i /
//   sum e^(m_i - M) l_i.  A split with no key block (more splits than the
//   sample walks) writes m = -inf and l = 0, and the combine skips its O.
//   The plan (attention_plan -> LongAttentionPlan) takes the split count
//   of least modelled time: waves of blocks x their share of key blocks,
//   plus the combine's bytes.  A launch's workspace is kept below 2^31
//   floats (8 GB) by launching the samples in chunks (`batch` a launch)
//   that reuse it one after another on the stream; one sample alone may
//   pass it (offsets are 64-bit; the plan sends the size as two ints).  A
//   block holds 229 KB of shared memory, so an SM runs one block at a
//   time and a wave past the first costs a whole share: at (4, 750, 750)
//   96 blocks (one wave of 6 key blocks) beat 192 (two waves of 3) on the
//   card.  Plans at D = 256 (229,408 of the
//   232,448 bytes of shared memory):
//     (4, 750, 750):   12 x 2 x 4 =  96 blocks, 1 wave;  workspace 25.1 MB
//                      (576 pieces; 6.2 MB of partials)
//     (4, 1500, 750):  24 x 4 x 4 = 384 blocks, 3 waves; 49.9 MB (24.8)
//     (8, 1026, 513):  17 x 3 x 8 = 408 blocks, 4 waves; 62.1 MB (25.4)
//     (2, 1280, 640):  20 x 3 x 2 = 120 blocks, 1 wave;  18.4 MB (7.9)
//     (1, 4096, 4096): 64 x 2 x 1 = 128 blocks, 1 wave;  33.6 MB (8.5)

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kRows = 16;          // query rows of a warp
constexpr int kKeyTile = 32;       // keys of a piece
constexpr int kKeyNT = kKeyTile / 8;
constexpr int kMaxChunk = 64;      // D columns of a piece, at most
constexpr int kMaxWarps = 8;
constexpr int kMaxKeys = 512;      // the strip instance's keys, at most
constexpr int kMaxSmem = 232448;   // 227 KB a block may use
constexpr int kPlanInts = 10;
constexpr int kMaxGridB = 65535;  // samples a launch: the grid's y and z axes
constexpr float kMasked = -1e30f;

// One strip of all S <= 512 keys (key_block is 0: the instance past 512
// keys has a plan and an entry point of its own).  d_scale: the true D,
// whose square root scales the scores (D is it rounded up to 8).
struct Plan {
  int B, T, S, D, d_scale, warps, d_chunk, row_tiles, key_block, smem;
};

// Warps a 16-row tile: two share the n-tiles of a chunk of 64 columns; a
// chunk of 8 is a single n-tile, computed by one warp.
__host__ __device__ constexpr int split_of(int dc) { return dc > 8 ? 2 : 1; }

// Row strides in floats, as AttentionPlan has them.
__host__ __device__ constexpr int q_stride(int D) { return D + 4; }
__host__ __device__ constexpr int p_stride(int S) { return (S + 7) / 8 * 8 + 4; }
__host__ __device__ constexpr int k_stride(int dc) { return dc + 4; }
__host__ __device__ constexpr int v_stride(int dc) { return dc % 16 == 8 ? dc : dc + 8; }
__host__ __device__ constexpr int buf_floats(int dc) {
  return kKeyTile * (k_stride(dc) > v_stride(dc) ? k_stride(dc) : v_stride(dc));
}

// Q rows, one score strip of S keys a 16-row tile, two K/V buffers.
size_t smem_bytes(int tiles, int S, int D, int dc) {
  const size_t rows = static_cast<size_t>(kRows) * tiles;
  return sizeof(float) *
         (rows * q_stride(D) + rows * p_stride(S) + 2 * static_cast<size_t>(buf_floats(dc)));
}

bool plan_ok(const Plan& p) {
  if (p.B < 1 || p.T < 1 || p.S < 1) return false;
  if (p.S > kMaxKeys || p.key_block != 0) return false;
  if (p.D < 8 || p.D % 8 != 0) return false;
  if (p.d_scale < 1 || p.d_scale > p.D || p.d_scale <= p.D - 8) return false;
  if (p.d_chunk != 8 && p.d_chunk != kMaxChunk) return false;
  if (p.D % p.d_chunk != 0) return false;
  const int split = split_of(p.d_chunk);
  if (p.warps < 1 || p.warps > kMaxWarps || p.warps % split != 0) return false;
  const int rows = kRows * (p.warps / split);
  if (p.row_tiles != (p.T + rows - 1) / rows) return false;
  const size_t smem = smem_bytes(p.warps / split, p.S, p.D, p.d_chunk);
  return smem == static_cast<size_t>(p.smem) && smem <= static_cast<size_t>(kMaxSmem);
}

// 16 bytes global -> shared; `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// D (16 x 8) += A (16 x 8; a thread holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)) * B (8 x 8; (t, g), (t + 4, g)); D: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).  g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows g, g + 8 and columns t, t + 4 from `a` (at row g,
// column t) with row stride `st`, split into TF32 parts.
__device__ __forceinline__ void load_a(const float* a, int st, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8 * st], hi[1], lo[1]);
  split_tf32(a[4], hi[2], lo[2]);
  split_tf32(a[8 * st + 4], hi[3], lo[3]);
}

__device__ __forceinline__ void load_b(float b0, float b1, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(b0, hi[0], lo[0]);
  split_tf32(b1, hi[1], lo[1]);
}

// One k-step of 3xTF32 products on a warp's M n-tiles (the first `m` of
// them): the small cross terms go into `cross`, hi * hi into `hihi`,
// issued tile by tile in three rounds so that no product waits on the one
// before it.
template <int M>
__device__ __forceinline__ void k_step_3xtf32(float (&hihi)[M][4], float (&cross)[M][4],
                                              const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                              const uint32_t (&b_hi)[M][2],
                                              const uint32_t (&b_lo)[M][2], int m) {
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < m) mma_tf32(cross[i], a_lo, b_hi[i]);
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < m) mma_tf32(hihi[i], a_hi, b_hi[i]);
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < m) mma_tf32(cross[i], a_hi, b_lo[i]);
}

// sum += hihi + cross, with an ordinary fp32 add (the tensor cores truncate).
template <int N>
__device__ __forceinline__ void add_fresh(float (&sum)[N][4], const float (&hihi)[N][4],
                                          const float (&cross)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += hihi[n][e] + cross[n][e];
}

// SPLIT warps compute a 16-row tile; warp `part` of them takes the n-tiles
// part, part + SPLIT, ... of every product (its i-th is n = i * SPLIT + part).
// One strip of all S keys, P normalised in it.
template <int DC, int SPLIT = split_of(DC)>
__global__ void __launch_bounds__(kMaxWarps * 32)
masked_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, const Plan p) {
  constexpr int kst = k_stride(DC), vst = v_stride(DC), buf = buf_floats(DC);
  constexpr int kMK = kKeyNT / SPLIT;     // a warp's key n-tiles of a piece
  constexpr int kMV = DC / 8 / SPLIT;     // a warp's column n-tiles of a piece
  static_assert(kMV >= 1, "a D chunk of 8 is not split");
  extern __shared__ __align__(16) float smem[];
  const int T = p.T, S = p.S, D = p.D;
  const int tiles = p.warps / SPLIT;               // 16-row tiles of the block
  const int qst = q_stride(D), pst = p_stride(S);
  float* qs = smem;                                // 16 tiles x qst
  float* strips = qs + kRows * tiles * qst;        // tiles x 16 x pst
  float* ring = strips + kRows * tiles * pst;      // 2 x buf

  const int tid = threadIdx.x, nthreads = 32 * p.warps;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int tile = warp / SPLIT, part = warp % SPLIT;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows * tiles;
  const int row0 = t0 + kRows * tile;              // this warp's first row
  const bool active = row0 < T;                    // warp-uniform
  const int length = lengths[b];
  const float sqrt_d = sqrtf(static_cast<float>(p.d_scale));
  float* strip = strips + tile * kRows * pst;

  const float* kb_ptr = k + static_cast<size_t>(b) * S * D;
  const float* vb_ptr = v + static_cast<size_t>(b) * S * D;
  const int chunks = D / DC;
  const int kt = (S + kKeyTile - 1) / kKeyTile;  // key tiles
  const int pieces = 2 * kt * chunks;            // K then V pieces

  // Piece pc: K or V, its key tile j and its D chunk c.  K pieces walk
  // (j, c), V pieces (c, j).
  struct Piece {
    int i;
    bool is_v;
    int j, c;
  };
  auto piece_of = [&](int pc) {
    Piece x;
    x.i = pc;
    const int kp = kt * chunks;
    x.is_v = x.i >= kp;
    if (x.is_v) x.i -= kp;
    x.j = x.is_v ? x.i % kt : x.i / chunks;
    x.c = x.is_v ? x.i / kt : x.i % chunks;
    return x;
  };

  // The block's query rows (zeros past T).
  {
    const float* qb = q + static_cast<size_t>(b) * T * D;
    const int vecs = D / 4;
    for (int i = tid; i < kRows * tiles * vecs; i += nthreads) {
      const int r = i / vecs, c = i - r * vecs;
      const bool ok = t0 + r < T;
      cp_async16(qs + r * qst + 4 * c, ok ? qb + static_cast<size_t>(t0 + r) * D + 4 * c : q, ok);
    }
  }
  // Piece `pc` into its ring buffer: 32 keys x DC columns, zeros past S.
  auto load_piece = [&](int pc) {
    const Piece x = piece_of(pc);
    const int key0 = x.j * kKeyTile;
    const float* src = (x.is_v ? vb_ptr : kb_ptr) + static_cast<size_t>(key0) * D + x.c * DC;
    float* dst = ring + (pc & 1) * buf;
    const int st = x.is_v ? vst : kst;
    constexpr int vecs = DC / 4;
    for (int e = tid; e < kKeyTile * vecs; e += nthreads) {
      const int r = e / vecs, c4 = e % vecs;
      const bool ok = key0 + r < S;
      cp_async16(dst + r * st + 4 * c4, ok ? src + static_cast<size_t>(r) * D + 4 * c4 : kb_ptr,
                 ok);
    }
  };

  float score[kMK][4];   // a key tile's scores, summed over the D chunks
  float acc[kMV][4];     // a D chunk of the output, summed over the keys

  load_piece(0);
  cp_async_commit();  // with the query rows
  for (int pc = 0; pc < pieces; ++pc) {
    if (pc + 1 < pieces) load_piece(pc + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // piece pc (and the query rows) visible to all warps
    const float* piece = ring + (pc & 1) * buf;
    const Piece x = piece_of(pc);
    const int key0 = x.j * kKeyTile;              // the piece's first key
    if (!x.is_v) {
      // ---- scores: 16 rows x (up to) 4 n-tiles of keys, over DC columns
      const int j = x.j, c = x.c;
      const int n_tiles = min(kKeyNT, (S - key0 + 7) / 8);
      const int m = (n_tiles - part + SPLIT - 1) / SPLIT;  // of them this warp's
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kMK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) score[i][e] = 0.f;
      }
      if (active) {
        float hihi[kMK][4] = {}, cross[kMK][4] = {};
        const float* qa = qs + (kRows * tile + g) * qst + c * DC + t4;
        const float* kk = piece + (8 * part + g) * kst + t4;  // key 8n + g, column t
#pragma unroll
        for (int ks = 0; ks < DC / 8; ++ks) {
          uint32_t a_hi[4], a_lo[4], b_hi[kMK][2], b_lo[kMK][2];
          load_a(qa + 8 * ks, qst, a_hi, a_lo);
#pragma unroll
          for (int i = 0; i < kMK; ++i) {  // rows past S are zeros
            const float* kn = kk + 8 * SPLIT * i * kst + 8 * ks;
            load_b(kn[0], kn[4], b_hi[i], b_lo[i]);
          }
          k_step_3xtf32<kMK>(hihi, cross, a_hi, a_lo, b_hi, b_lo, m);
        }
        add_fresh<kMK>(score, hihi, cross);
        if (c == chunks - 1) {  // scale, mask and store the key tile's scores
#pragma unroll
          for (int i = 0; i < kMK; ++i) {
            if (i < m) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = j * kKeyTile + 8 * (i * SPLIT + part) + 2 * t4 + (e & 1);
                const float sc = score[i][e] / sqrt_d;
                strip[(g + 8 * (e >> 1)) * pst + key] =
                    key >= S ? -INFINITY : (key < length ? sc : kMasked);
              }
            }
          }
        }
      }
    } else {
      const int c = x.c, j = x.j;
      if (x.i == 0) {
        // ---- softmax of the tile's strip; lane 4g + t: rows g, g + 8 (one
        // of them each if the tile has two warps)
        const int cols = (S + 7) / 8 * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!active || h % SPLIT != part) continue;
          float* row = strip + (g + 8 * h) * pst;
          float m = -INFINITY;
          for (int xx = t4; xx < cols; xx += 4) m = fmaxf(m, row[xx]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          float sum = 0.f;
          for (int xx = t4; xx < cols; xx += 4) {
            const float e = expf(row[xx] - m);
            row[xx] = e;
            sum += e;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          for (int xx = t4; xx < cols; xx += 4) row[xx] = row[xx] / sum;
        }
        __syncthreads();  // P of the whole tile visible to its warps
      }
      // ---- P.V: 16 rows x DC columns, over (up to) 32 keys
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < kMV; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      }
      if (active) {
        const int k_steps = min(kKeyNT, (S - key0 + 7) / 8);
        float hihi[kMV][4] = {}, cross[kMV][4] = {};
        const float* pa = strip + g * pst + j * kKeyTile + t4;
        const float* vv = piece + t4 * vst + 8 * part + g;  // key t, column 8n + g
#pragma unroll
        for (int ks = 0; ks < kKeyNT; ++ks) {
          if (ks < k_steps) {  // the strip ends at S rounded up to 8
            uint32_t a_hi[4], a_lo[4], b_hi[kMV][2], b_lo[kMV][2];
            load_a(pa + 8 * ks, pst, a_hi, a_lo);
#pragma unroll
            for (int i = 0; i < kMV; ++i) {
              const float* vn = vv + 8 * ks * vst + 8 * SPLIT * i;
              load_b(vn[0], vn[4 * vst], b_hi[i], b_lo[i]);
            }
            k_step_3xtf32<kMV>(hihi, cross, a_hi, a_lo, b_hi, b_lo, kMV);
          }
        }
        add_fresh<kMV>(acc, hihi, cross);
        if (j == kt - 1) {  // the chunk is complete over all keys
#pragma unroll
          for (int i = 0; i < kMV; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = kRows * tile + g + 8 * h;  // the row within the block
              const int row = t0 + r;
              const int col = c * DC + 8 * (i * SPLIT + part) + 2 * t4;
              const float2 val = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
              if (row < T) {
                *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * T + row) * D + col) =
                    val;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer of piece pc is free for piece pc + 2
  }
}

template <int DC>
cudaError_t launch(const Plan& p, const float* q, const float* k, const float* v,
                   const int* lengths, float* out, cudaStream_t stream) {
  const auto kernel = masked_attention_kernel<DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  // chunks of at most kMaxGridB samples, one launch each
  for (int b0 = 0; b0 < p.B; b0 += kMaxGridB) {
    Plan c = p;
    c.B = min(kMaxGridB, p.B - b0);
    const size_t qo = static_cast<size_t>(b0) * p.T * p.D, ko = static_cast<size_t>(b0) * p.S * p.D;
    kernel<<<dim3(c.row_tiles, c.B), 32 * c.warps, c.smem, stream>>>(q + qo, k + ko, v + ko,
                                                                       lengths + b0, out + qo, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Past 512 keys: a split pass, then one warpgroup a block of 64 query rows
// with the keys split over the grid's y axis, on wgmma, then the combine
// (design notes in the header).

constexpr int kLongRows = 64;      // query rows a block: the wgmma tile's M
constexpr int kLongKeys = 64;      // keys a key block: the N of Q K^T
constexpr int kLongChunk = 64;     // D columns a piece: Q K^T's fresh sum, P.V's N
constexpr int kSliceChunks = 4;    // chunks of O a block holds: 256 columns, 128 registers a thread
constexpr int kLongThreads = 128;  // one warpgroup
constexpr int kLongSlots = 3;      // pieces in shared memory: in use, arrived, arriving
constexpr int kLongPlanInts = 14;
constexpr int kPart = kLongKeys * kLongChunk;  // floats of a piece's hi (or lo) part
constexpr int kPartBytes = kPart * 4;          // 16 KB
constexpr int kKStep = 512;                    // floats a k-step: 8 groups x 2 halves x 32
constexpr int kVStep = kLongChunk * 8;         // floats a k-step (8 keys) of a V piece
static_assert(kLongRows == kLongKeys, "a piece is 64 rows of Q, K or V");

// d_scale: the true D (D is it rounded up to 8); slices: column slices of
// 256 (1 up to D = 256); batch: samples a launch; workspace floats of a
// launch = ws_hi * 2^30 + ws_lo; mode: kSplitPass (the split pass, then the
// attention on its pieces) or kInBlock (one launch that splits in the block).
struct LongPlan {
  int B, T, S, D, d_scale, row_blocks, splits, slices, key_block, smem, batch, ws_hi, ws_lo, mode;
};
constexpr int kSplitPass = 0, kInBlock = 1;

// The in-block instance (design notes in the header): a block is three
// warpgroups, the consumer's 64 query rows on wgmma and two producers that
// split the pieces the TMA unit brings (32 columns of a key block's K or V
// rows) into a ring the consumer reads.
constexpr int kInKeys = 40;                  // keys a key block: the N of Q K^T
constexpr int kInCols = 32;                  // D columns a piece
constexpr int kInProducers = 2;              // producer warpgroups: piece j is the (j mod 2)-th's
constexpr int kInRawSlots = 2 * kInProducers;  // raw pieces in flight: two a producer
constexpr int kInSplitSlots = 6;             // split pieces: a pair in use, four written ahead
constexpr int kInRawBytes = kInKeys * kInCols * 4;   // 5 KB: KB rows of 32 floats
constexpr int kInPartBytes = kInKeys * kInCols * 4;  // a piece's hi (or lo) part
constexpr int kInSlotBytes = 2 * kInPartBytes;
constexpr int kInThreads = 128 * (1 + kInProducers);  // the consumer warpgroup, the producers'
constexpr int kInChunks = 8;                 // 32-column chunks of O: D <= 256
constexpr int kInBars = kInRawSlots + 2 * kInSplitSlots;
// Registers a thread: 168 at launch (384 threads); the consumer's 248 hold
// the output (128), the scores and P's parts; the producers' 128 are ample
// (128 x 248 + 256 x 128 = 64,512 of the SM's 65,536).
constexpr int kInConsumerRegs = 248, kInProducerRegs = 128;
constexpr int kInQLoads = (kLongRows * kInChunks * kInCols / 4 + kInThreads - 1) / kInThreads;

__host__ __device__ constexpr int in_cols(int D) { return (D + kInCols - 1) / kInCols * kInCols; }

// Q's parts (D padded to the piece), the raw ring, the split ring, the
// mbarriers (each raw slot's, each split slot's full and free).
size_t in_smem_bytes(int D) {
  return 2 * static_cast<size_t>(kLongRows) * in_cols(D) * 4 + kInRawSlots * kInRawBytes +
         kInSplitSlots * kInSlotBytes + 8 * kInBars;
}

__host__ __device__ constexpr int long_chunks(int D) { return (D + kLongChunk - 1) / kLongChunk; }
__host__ __device__ constexpr int long_slices(int D) {
  return (long_chunks(D) + kSliceChunks - 1) / kSliceChunks;
}

// Up to D = 256, Q's parts (D padded to the chunk) stay for the whole walk
// and a slot holds a K or V piece's parts; past it Q streams, and a slot
// holds a K piece's and a Q piece's.  Then an mbarrier for Q and one a slot.
size_t long_smem_bytes(int D) {
  const bool streamed = long_slices(D) > 1;
  const size_t q = streamed ? 0 : 2 * static_cast<size_t>(long_chunks(D)) * kPartBytes;
  return q + kLongSlots * (streamed ? 4 : 2) * static_cast<size_t>(kPartBytes) +
         8 * (kLongSlots + 1);
}

// Pieces of the split pass of a launch of p.B samples: Q's (B x row blocks
// x chunks), then K's and V's (B x key blocks x chunks each); each a hi part
// and a lo part.
long long long_pieces(const LongPlan& p) {
  if (p.mode == kInBlock) return 0;
  const long long blocks_k = (p.S + kLongKeys - 1) / kLongKeys;
  return static_cast<long long>(long_chunks(p.D)) * p.B * (p.row_blocks + 2 * blocks_k);
}

// Floats of the workspace of a launch of p.B samples: the split pieces;
// then, for more than one split, each split's unnormalised output rows,
// each row's maximum, its sum.
long long long_workspace(const LongPlan& p) {
  const long long partials =
      p.splits == 1 ? 0 : static_cast<long long>(p.splits) * p.B * p.T * (p.D + 2);
  return 2LL * kPart * long_pieces(p) + partials;
}

bool long_plan_ok(const LongPlan& p) {
  if (p.B < 1 || p.T < 1 || p.S < 1) return false;
  if (p.D < 8 || p.D % 8 != 0) return false;
  if (p.d_scale < 1 || p.d_scale > p.D || p.d_scale <= p.D - 8) return false;
  if (p.row_blocks != (p.T + kLongRows - 1) / kLongRows) return false;
  if (p.slices != long_slices(p.D) ||
      static_cast<long long>(p.row_blocks) * p.slices > 0x7fffffffLL)
    return false;
  const bool in_block = p.mode == kInBlock;
  if (p.mode != kSplitPass && !in_block) return false;
  if (in_block ? p.key_block != kInKeys || p.slices != 1
               : p.key_block != kLongKeys)
    return false;
  if (p.splits < 1 || p.splits > (p.S + p.key_block - 1) / p.key_block || p.splits > kMaxGridB)
    return false;
  if (p.batch < 1 || p.batch > p.B || p.batch > kMaxGridB) return false;
  const size_t smem = in_block ? in_smem_bytes(p.D) : long_smem_bytes(p.D);
  if (static_cast<size_t>(p.smem) != smem || p.smem > kMaxSmem) return false;
  if (p.ws_hi < 0 || p.ws_lo < 0 || p.ws_lo >= (1 << 30)) return false;
  LongPlan launch = p;
  launch.B = p.batch;
  return long_pieces(launch) <= 0x7fffffffLL &&
         long_workspace(launch) == (static_cast<long long>(p.ws_hi) << 30) + p.ws_lo;
}

// Key blocks sample b walks: none at or past a length >= 1 (they weigh
// exactly 0: exp(-1e30 - m) underflows for the finite m of a real score);
// all S keys for a length <= 0, whose rows average the S values.
__device__ __forceinline__ int walked_blocks(int length, int S, int key_block = kLongKeys) {
  const int keys = length >= 1 ? min(length, S) : S;
  return (keys + key_block - 1) / key_block;
}

// fp32 -> its TF32 parts (tf32.cuh), as floats.
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split_tf32(x.x, h, l);
  hi.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  split_tf32(x.y, h, l);
  hi.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  split_tf32(x.z, h, l);
  hi.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  split_tf32(x.w, h, l);
  hi.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

__device__ __forceinline__ float4 load4(const float* base, int row, int rows, int col, int D) {
  if (row >= rows || col >= D) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(base + static_cast<size_t>(row) * D + col));
}

// The split pass: each piece of 64 rows x 64 columns (zeros past T, S or
// D) split once into its TF32 parts, laid out as wgmma reads them from
// shared memory: K-major core matrices of 8 rows x 4 values (16 bytes), the
// two halves of a k-step 32 floats apart, groups of 8 rows 64 apart, a
// k-step 512.  Q's and K's rows are the operand's rows (M or N), their
// columns its k; V's columns are P.V's N and its keys P.V's k, so V is
// transposed here; and key 2i + h of a k-step stands at k-position 4h + i,
// where P's A fragment holds it (lane column i for h 0, i + 4 for h 1).
// A block a piece (a row block of Q or a key block of K or V: both 64
// rows); the key blocks a sample does not walk are skipped.
__global__ void __launch_bounds__(256)
split_pieces_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ parts, const LongPlan p) {
  const int chunks = long_chunks(p.D), blocks_k = (p.S + kLongKeys - 1) / kLongKeys;
  const int piece = blockIdx.x;
  const int c = piece % chunks;
  int blk = piece / chunks;
  const float* src = q;
  int rows = p.T, kind = 0;  // 0: Q, 1: K, 2: V
  if (blk >= p.B * p.row_blocks) {
    blk -= p.B * p.row_blocks;
    kind = 1 + blk / (p.B * blocks_k);
    blk %= p.B * blocks_k;
    src = kind == 1 ? k : v;
    rows = p.S;
  }
  const int per_b = kind == 0 ? p.row_blocks : blocks_k;
  const int b = blk / per_b, rb = blk % per_b;
  if (kind > 0 && rb >= walked_blocks(lengths[b], p.S)) return;
  src += static_cast<size_t>(b) * rows * p.D;
  float* hi = parts + 2 * static_cast<size_t>(kPart) * piece;
  float* lo = hi + kPart;
  const int row0 = rb * kLongRows, col0 = c * kLongChunk;
  if (kind < 2) {
#pragma unroll
    for (int it = 0; it < kPart / 4 / 256; ++it) {
      const int e = threadIdx.x + 256 * it;
      const int rl = e & 7, c4 = (e >> 3) & 15, rh = e >> 7;  // row 8 rh + rl, columns 4 c4 ...
      float4 h, l;
      split4(load4(src, row0 + 8 * rh + rl, rows, col0 + 4 * c4, p.D), h, l);
      const int off = (c4 >> 1) * kKStep + rh * 64 + (c4 & 1) * 32 + rl * 4;
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  } else {
    // keys 8 (kq / 2) + kq % 2 + {0, 2, 4, 6} x columns 4 cq ...: a 4 x 4
    // block, transposed
    const int kq = threadIdx.x >> 4, cq = threadIdx.x & 15;
    const int key = row0 + 8 * (kq >> 1) + (kq & 1);
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = load4(src, key + 2 * i, rows, col0 + 4 * cq, p.D);
    const int base = (kq >> 1) * kVStep + (cq >> 1) * 64 + (kq & 1) * 32 + (cq & 1) * 16;
    const float4 cols[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                            make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                            make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                            make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 h, l;
      split4(cols[j], h, l);
      *reinterpret_cast<float4*>(hi + base + 4 * j) = h;
      *reinterpret_cast<float4*>(lo + base + 4 * j) = l;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// A wgmma operand in shared memory, K-major without swizzle: core matrices
// of 8 rows x 16 bytes; the two halves of a k-step 128 bytes apart (the
// leading offset), groups of 8 rows 256 apart (the stride offset).  The
// fused block's weights are laid out the same way.
__device__ __forceinline__ uint64_t core_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of a finished sum above the wait.
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- bulk copies (the TMA unit, no tensor map), counted on an mbarrier;
// they arrive through the async proxy, the one wgmma reads through.
__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
__device__ __forceinline__ void mbarrier_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// D (64 x 64 fp32: a thread holds rows 16 warp + g and + 8, columns 2t and
// 2t + 1 of every 8) = or += A (64 x 8) * B (8 x 64), both TF32 by
// descriptor; `add` 0 starts a fresh sum.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(add));
}
// D (64 x 32) = or += A (64 x 8 from registers: a thread holds rows 16
// warp + g and + 8, columns t and t + 4: a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4)) * B (8 x 32 by descriptor).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

// Grid (row blocks x slices, splits, B).  Block (r + row_blocks z, split,
// b): query rows 64 r ... of sample b, output columns 256 z ..., over the
// split-th share of the key blocks the sample walks; with one split it
// writes the output, else its rows' m, l and unnormalised O.  Shared memory
// (kStreamed false, one slice): Q's parts (chunk c: hi at 2c, lo at 2c + 1
// parts), three slots of a K or V piece's parts, the mbarriers.  kStreamed
// (D past 256): three slots of a K piece's parts and then a Q piece's (or
// a V piece's parts), the mbarriers.
template <bool kStreamed>
__global__ void __launch_bounds__(kLongThreads, 1)
long_attention_kernel(const float* __restrict__ parts, const int* __restrict__ lengths,
                      float* __restrict__ out, float* __restrict__ ws, const LongPlan p) {
  extern __shared__ __align__(128) unsigned char lsmem[];
  const int T = p.T, S = p.S, D = p.D;
  const int tid = threadIdx.x, lane = tid & 31;
  // The warp's number by a shuffle, so that the compiler knows it to be the
  // same in all lanes.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  // One slice (D <= 256): the values below are constants the compiler
  // folds, so that no slice arithmetic stays live at 255 registers (it cost
  // the rows past 512 keys 3-9% on the card).
  const int rb = kStreamed ? blockIdx.x % p.row_blocks : blockIdx.x;
  const int z = kStreamed ? blockIdx.x / p.row_blocks : 0;
  const int split = blockIdx.y, b = blockIdx.z;
  const int row0 = rb * kLongRows;
  const int length = lengths[b];
  const int walked = walked_blocks(length, S);
  const int kb0 = static_cast<int>(static_cast<long long>(split) * walked / p.splits);
  const int kb1 = static_cast<int>(static_cast<long long>(split + 1) * walked / p.splits);
  const size_t ws_rows = static_cast<size_t>(p.splits) * p.B * T;
  const size_t part = (static_cast<size_t>(split) * p.B + b) * T;  // this split's rows
  if (kb0 == kb1) {  // no key block (more splits than blocks): m = -inf, l = 0, O unread
    for (int r = tid; z == 0 && r < kLongRows && row0 + r < T; r += kLongThreads) {
      ws[ws_rows * D + part + row0 + r] = -INFINITY;
      ws[ws_rows * (D + 1) + part + row0 + r] = 0.f;
    }
    return;
  }

  const int chunks = long_chunks(D), blocks_k = (S + kLongKeys - 1) / kLongKeys;
  const int c0 = z * kSliceChunks;                               // the slice's first chunk of O
  const int nv = kStreamed ? min(kSliceChunks, chunks - c0) : chunks;  // and its chunks
  constexpr uint32_t kSlotBytes = (kStreamed ? 4 : 2) * kPartBytes;
  const uint32_t q_u = smem_u32(lsmem);                             // Q's parts
  const uint32_t slots_u = q_u + (kStreamed ? 0 : 2 * chunks * kPartBytes);  // slot s
  const uint32_t bars_u = slots_u + kLongSlots * kSlotBytes;        // Q's, then a slot's
  // The split pieces of this block's Q rows, and of sample b's K and V.
  const float* q_parts =
      parts + 2LL * kPart * chunks * (static_cast<long long>(b) * p.row_blocks + rb);
  const float* k_parts =
      parts + 2LL * kPart * chunks * (static_cast<long long>(p.B) * p.row_blocks + b * blocks_k);
  const float* v_parts = k_parts + 2LL * kPart * chunks * p.B * blocks_k;
  const int per_block = chunks + nv;  // pieces a key block: K (and Q) chunks, the slice's V
  const int pieces = (kb1 - kb0) * per_block;
  // Piece j (of this block's walk) into slot j % 3 (thread 0).
  auto fetch = [&](int j) {
    if (j >= pieces) return;
    const int blk = kb0 + j / per_block, r = j % per_block;
    const bool is_k = r < chunks;
    const float* src =
        is_k ? k_parts + 2LL * kPart * (blk * chunks + r)
             : v_parts + 2LL * kPart * (static_cast<long long>(blk) * chunks + c0 + r - chunks);
    const uint32_t bar = bars_u + 8 * (1 + j % kLongSlots);
    const uint32_t dst = slots_u + (j % kLongSlots) * kSlotBytes;
    mbarrier_expect(bar, (kStreamed && is_k ? 4 : 2) * kPartBytes);
    bulk_copy(dst, src, kPartBytes, bar);
    bulk_copy(dst + kPartBytes, src + kPart, kPartBytes, bar);
    if (kStreamed && is_k) {  // Q's piece of the same columns
      const float* qs = q_parts + 2LL * kPart * r;
      bulk_copy(dst + 2 * kPartBytes, qs, kPartBytes, bar);
      bulk_copy(dst + 3 * kPartBytes, qs + kPart, kPartBytes, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kLongSlots; ++i) mbarrier_init(bars_u + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (!kStreamed) {
      mbarrier_expect(bars_u, 2 * chunks * kPartBytes);
      for (int c = 0; c < 2 * chunks; ++c)
        bulk_copy(q_u + c * kPartBytes, q_parts + static_cast<size_t>(c) * kPart, kPartBytes,
                  bars_u);
    }
    fetch(0);
    fetch(1);
  }
  __syncthreads();  // the barriers initialised
  if (!kStreamed) mbarrier_wait(bars_u, 0);

  float o[kSliceChunks][32];  // unnormalised output, chunk c: columns 64 (c0 + c) ...
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: the maximum so far
  float l_run[2] = {0.f, 0.f};              // and this thread's share of sum exp(s - m)
  const float scale = 1.f / sqrtf(static_cast<float>(p.d_scale));
  int j = 0;  // the piece in use
  // Wait for piece j, then (thread 0, once the products are issued) fetch
  // piece j + 2 into the slot piece j - 1 left: every warp waited for those
  // products and passed the barrier that ends each piece.
  auto arrive = [&]() { mbarrier_wait(bars_u + 8 * (1 + j % kLongSlots), (j / kLongSlots) & 1); };
  auto slot_of = [&]() { return slots_u + (j % kLongSlots) * kSlotBytes; };
  auto next_piece = [&]() {
    __syncthreads();
    ++j;
  };
  for (int blk = kb0; blk < kb1; ++blk) {
    // ---- scores of 64 rows x 64 keys, a fresh 3xTF32 sum a chunk of D
    float s[32];
    auto scores_chunk = [&](int c) {
      arrive();
      const uint32_t b_hi = slot_of(), b_lo = b_hi + kPartBytes;
      const uint32_t a_hi = kStreamed ? b_hi + 2 * kPartBytes : q_u + 2 * c * kPartBytes;
      const uint32_t a_lo = a_hi + kPartBytes;
      float fresh[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) fresh[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kLongChunk / 8; ++ks) {
        const uint32_t o_k = ks * kKStep * 4;
        wgmma_ss_n64(fresh, core_desc(a_lo + o_k), core_desc(b_hi + o_k), ks > 0);
        wgmma_ss_n64(fresh, core_desc(a_hi + o_k), core_desc(b_lo + o_k), 1);
        wgmma_ss_n64(fresh, core_desc(a_hi + o_k), core_desc(b_hi + o_k), 1);
      }
      wgmma_commit();
      if (tid == 0) fetch(j + 2);
      wgmma_wait0();
      pin(fresh);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = c == 0 ? fresh[i] : s[i] + fresh[i];
      next_piece();
    };
    if (kStreamed) {
#pragma unroll 1
      for (int c = 0; c < chunks; ++c) scores_chunk(c);
    } else {
#pragma unroll
      for (int c = 0; c < kSliceChunks; ++c)
        if (c < chunks) scores_chunk(c);
    }
    // ---- online softmax in registers: scale, mask, rescale to the new max
    const int key0 = blk * kLongKeys + 2 * t4;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * (i >> 2) + (i & 1);
      const float sc = s[i] * scale;
      s[i] = key >= S ? -INFINITY : (key < length ? sc : kMasked);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // finite: a walked block holds a key < S (a score or -1e30)
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = m_run[h] == -INFINITY ? 0.f : expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
    // P = exp(s - m) as P.V's A fragments: k-step j is keys 8j ..., key
    // 8j + 2t in lane column t, key 8j + 2t + 1 in column t + 4.
    uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float e = expf(s[i] - m_run[h]);
      l_run[h] += e;
      const int a = (i & 1) * 2 + h;  // (g, t) (g + 8, t) (g, t + 4) (g + 8, t + 4)
      split_tf32(e, p_hi[i >> 2][a], p_lo[i >> 2][a]);
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int c = 0; c < kSliceChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    }
    // ---- O += P.V over the slice's chunks, a fresh 3xTF32 sum a half of a
    // chunk (32 columns: the output, P and a 64-column sum would leave too
    // few registers)
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < nv) {
        arrive();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t b_hi = slot_of() + half * 4 * 256, b_lo = b_hi + kPartBytes;
          float fresh[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) fresh[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kLongKeys / 8; ++ks) {
            const uint32_t o_k = ks * kVStep * 4;
            wgmma_rs_n32(fresh, p_lo[ks], core_desc(b_hi + o_k), ks > 0);
            wgmma_rs_n32(fresh, p_hi[ks], core_desc(b_lo + o_k), 1);
            wgmma_rs_n32(fresh, p_hi[ks], core_desc(b_hi + o_k), 1);
          }
          wgmma_commit();
          if (half == 0 && tid == 0) fetch(j + 2);
          wgmma_wait0();
          pin(fresh);
#pragma unroll
          for (int i = 0; i < 16; ++i) o[c][16 * half + i] += fresh[i];
        }
        next_piece();
      }
    }
  }

  // ---- the rows' sums over their quads; O / l, or the split's partials
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  const int r0 = row0 + 16 * warp + g;
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) {
    if (c < nv) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = (c0 + c) * kLongChunk + 8 * n + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= T || col >= D) continue;
          float2 val = make_float2(o[c][4 * n + 2 * h], o[c][4 * n + 2 * h + 1]);
          if (p.splits == 1) {
            val = make_float2(val.x / l_run[h], val.y / l_run[h]);
            *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * T + row) * D + col) = val;
          } else {
            *reinterpret_cast<float2*>(ws + (part + row) * D + col) = val;
          }
        }
      }
    }
  }
  if (p.splits > 1 && t4 == 0 && z == 0) {  // the same m and l in every slice
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < T) {
        ws[ws_rows * D + part + row] = m_run[h];
        ws[ws_rows * (D + 1) + part + row] = l_run[h];
      }
    }
  }
}

// out = sum_i exp(m_i - M) O_i / sum_i exp(m_i - M) l_i over the splits i,
// M = max_i m_i (finite: every sample walks at least one key block); a
// split with m_i = -inf walked no key block and its O_i is not read.  A
// thread: 4 columns of one of the B T rows.
__global__ void __launch_bounds__(256)
combine_splits_kernel(const float* __restrict__ ws, float* __restrict__ out, long long rows,
                      int D, int splits) {
  const int per_row = D / 4;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= rows * per_row) return;
  const long long row = i / per_row;
  const int c4 = static_cast<int>(i - row * per_row);
  const size_t all = static_cast<size_t>(splits) * rows;
  const float* ws_m = ws + all * D;
  const float* ws_l = ws_m + all;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_m[static_cast<size_t>(s) * rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t at = static_cast<size_t>(s) * rows + row;
    const float m = ws_m[at];
    if (m == -INFINITY) continue;
    const float w = expf(m - mx);
    l += w * ws_l[at];
    const float4 x = *reinterpret_cast<const float4*>(ws + at * D + 4 * c4);
    acc = make_float4(acc.x + w * x.x, acc.y + w * x.y, acc.z + w * x.z, acc.w + w * x.w);
  }
  *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * D + 4 * c4) =
      make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

// ---------------------------------------------------------------------------
// The in-block instance: one launch, the operands split in the block.

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// A box of the tensor `map` (columns x0 ..., rows y0 ...; zeros past its
// edges) into shared memory by the TMA unit, counted on the mbarrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x0, int y0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(bar)
      : "memory");
}
// A producer warpgroup's own barrier (1 or 2; barrier 0 is __syncthreads').
__device__ __forceinline__ void producer_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// The warpgroup's registers a thread: the consumer's grow to hold the
// output and the scores, the producers' shrink to make room.
template <int N> __device__ __forceinline__ void regs_grow() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_shrink() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Writes of the generic proxy (st.shared) made visible to the async proxy,
// through which wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The same box into L2 only, ahead of its load.
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int x0, int y0) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(x0), "r"(y0)
               : "memory");
}

// D (64 x 40 fp32: a thread holds rows 16 warp + g and + 8, columns 2t and
// 2t + 1 of every 8) = or += A (64 x 8) * B (8 x 40), both TF32 by
// descriptor: the scores of a key block.
__device__ __forceinline__ void wgmma_ss_n40(float (&d)[20], uint64_t da, uint64_t db, int add) {
  asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
        "%20, %21, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(da), "l"(db), "r"(add));
}

// Where (row, 4 c4 ... 4 c4 + 3) of a 32-column piece of `rows` rows stands
// as a wgmma operand: K-major core matrices of 8 rows x 4 values, the two
// halves of a k-step 32 floats apart, groups of 8 rows 64 apart, k-steps of
// 8 columns 8 x rows floats apart (split_pieces_kernel's layout).
__host__ __device__ constexpr int core_offset(int row, int c4, int rows) {
  return (c4 >> 1) * (rows * 8) + (row >> 3) * 64 + (c4 & 1) * 32 + (row & 7) * 4;
}

// Piece j of a block's walk: for each key block (of KB keys from the
// block's first, kb0), its K pieces, then its V pieces, 32 columns each (nq
// of them cover D).  Computed from j, so that no walk state stays live.
struct InPiece {
  int row0;   // its first row in the (B S, D) tensor of K or V
  int rows;   // of them that are the sample's keys (the rest are read as zeros)
  bool is_v;
  int c;      // its chunk of 32 columns
  __device__ InPiece(int b, int S, int kb0, int nq, int j) {
    const int blk = j / (2 * nq), r = j - 2 * nq * blk;
    is_v = r >= nq;
    c = is_v ? r - nq : r;
    const int key0 = (kb0 + blk) * kInKeys;
    rows = min(kInKeys, S - key0);
    row0 = b * S + key0;
  }
};

// A producer thread's share of a piece and its places.  Of a K piece: rows
// 8 rh + rl, columns 4 ((rl + sh) mod 8) ... (a quarter warp reads eight
// 16-byte columns of the raw rows and writes eight rows of a core matrix:
// no bank conflict on either side); of a V piece: column `lane` of keys 8 ks
// + h + {0, 2, 4, 6} for 2 ks + h = warp + 4 i (a warp reads 32 columns of
// a raw row), written transposed (key 2 i + h of a k-step at k-position 4 h
// + i; a quarter warp writes eight columns: no conflict).
struct InShares {
  int k_raw[4], k_dst[4];
  int lane, warp;
  __device__ void init(int ptid) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = ptid + 128 * it, rl = e & 7, row = 8 * (e >> 6) + rl, c4 = (rl + (e >> 3)) & 7;
      k_raw[it] = row * kInCols + 4 * c4;
      k_dst[it] = row < kInKeys ? core_offset(row, c4, kInKeys) : -1;
    }
    lane = ptid & 31;
    warp = ptid >> 5;
  }
  // Reads this thread's share of a K or V piece from its raw slot, zeros in
  // the rows past the sample's keys (the TMA box reads the next sample's
  // there).
  __device__ void read(bool is_v, const float* rp, int rows, float4 (&val)[4]) const {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      if (!is_v) {
        val[it] = k_raw[it] < rows * kInCols ? *reinterpret_cast<const float4*>(rp + k_raw[it])
                                             : zero;
      } else {
        const int u = warp + 4 * it, key = 8 * (u >> 1) + (u & 1);
        const float* col = rp + key * kInCols + lane;
        auto at = [&](int i) { return key + 2 * i < rows ? col[2 * i * kInCols] : 0.f; };
        val[it] = u < kInKeys / 4 ? make_float4(at(0), at(1), at(2), at(3)) : zero;
      }
    }
  }
  // Splits a share into its TF32 parts and writes them at `hi` (and lo_off
  // floats on).
  __device__ void write(bool is_v, float* hi, int lo_off, const float4 (&val)[4]) const {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      int off;
      if (!is_v) {
        off = k_dst[it];
      } else {
        const int u = warp + 4 * it;
        off = u < kInKeys / 4
                  ? (u >> 1) * (kInCols * 8) + (lane >> 3) * 64 + (u & 1) * 32 + (lane & 7) * 4
                  : -1;
      }
      if (off < 0) continue;
      float4 h4, l4;
      split4(val[it], h4, l4);
      *reinterpret_cast<float4*>(hi + off) = h4;
      *reinterpret_cast<float4*>(hi + lo_off + off) = l4;
    }
  }
};

// Grid (row blocks, splits, B); 384 threads: warpgroup 0 the consumer,
// warpgroups 1 and 2 the producers.  Block (r, split, b): query rows 64 r
// ... of sample b over the split-th share of the key blocks of 40 keys it
// walks.  Shared memory: Q's hi parts (64 rows x D padded to 32; k-step k
// at 512 k floats) and then its lo parts, the raw slots (a piece's 40 rows
// of 32 floats), the split slots (a piece's hi part, then its lo part 5 KB
// on), the mbarriers (the raw slots', then the split slots' fills, then
// their frees).
__global__ void __launch_bounds__(kInThreads, 1)
in_block_attention_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const int* __restrict__ lengths, float* __restrict__ out,
                          float* __restrict__ ws, const LongPlan p) {
  constexpr int KB = kInKeys;
  extern __shared__ __align__(128) unsigned char ismem[];
  const int T = p.T, S = p.S, D = p.D;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rb = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int row0 = rb * kLongRows;
  const int length = lengths[b];
  const int walked = walked_blocks(length, S, KB);
  const int kb0 = static_cast<int>(static_cast<long long>(split) * walked / p.splits);
  const int kb1 = static_cast<int>(static_cast<long long>(split + 1) * walked / p.splits);
  const size_t ws_rows = static_cast<size_t>(p.splits) * p.B * T;
  const size_t part = (static_cast<size_t>(split) * p.B + b) * T;  // this split's rows
  if (kb0 == kb1) {  // no key block (more splits than blocks): m = -inf, l = 0, O unread
    for (int r = tid; r < kLongRows && row0 + r < T; r += kInThreads) {
      ws[ws_rows * D + part + row0 + r] = -INFINITY;
      ws[ws_rows * (D + 1) + part + row0 + r] = 0.f;
    }
    return;
  }
  const int Dp = in_cols(D), nq = Dp / kInCols;  // a key block's K (and V) pieces
  const int pieces = (kb1 - kb0) * 2 * nq;       // the walk: K's, then V's, a key block
  float* const qs = reinterpret_cast<float*>(ismem);  // Q's hi parts, then its lo parts
  float* const raw = qs + 2 * kLongRows * Dp;
  float* const slots = raw + kInRawSlots * (kInRawBytes / 4);
  const uint32_t q_u = smem_u32(qs), slots_u = smem_u32(slots);
  const uint32_t bars_u = slots_u + kInSplitSlots * kInSlotBytes;
  auto raw_bar = [&](int i) { return bars_u + 8 * (i % kInRawSlots); };
  auto full_bar = [&](int i) { return bars_u + 8 * (kInRawSlots + i % kInSplitSlots); };
  auto free_bar = [&](int i) {
    return bars_u + 8 * (kInRawSlots + kInSplitSlots + i % kInSplitSlots);
  };
  if (tid == 0) {
    for (int i = 0; i < kInRawSlots; ++i) mbarrier_init(raw_bar(i), 1);  // the TMA's bytes
    for (int i = 0; i < kInSplitSlots; ++i) {
      mbarrier_init(full_bar(i), 4);  // one arrival a producer warp
      mbarrier_init(free_bar(i), 4);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers initialised
  // The producer's first thread brings the raw pieces by TMA (a box of 32
  // columns x KB rows of K or V, counted on the raw slot's mbarrier): the
  // first four now, piece j + 4 once every producer thread has read piece j.
  // The TMA's copies are not the thread's own loads, so its fence (for the
  // split parts it writes) does not wait on them.
  auto piece = [&](int j) { return InPiece(b, S, kb0, nq, j); };
  auto fetch = [&](int j) {
    if (j >= pieces) return;
    const InPiece x = piece(j);
    mbarrier_expect(raw_bar(j), KB * kInCols * 4);
    tma_load_2d(smem_u32(raw + (j % kInRawSlots) * (kInRawBytes / 4)), x.is_v ? &tm_v : &tm_k,
                x.c * kInCols, x.row0, raw_bar(j));
  };
  if (tid == 128) {
#pragma unroll
    for (int j = 0; j < kInRawSlots; ++j) fetch(j);
    for (int j = kInRawSlots; j < pieces; ++j) {  // the rest of the walk into L2
      const InPiece x = piece(j);
      tma_prefetch_2d(x.is_v ? &tm_v : &tm_k, x.c * kInCols, x.row0);
    }
  }
  // ---- Q's 64 rows by the whole block, once: loaded (zeros past T and D),
  // split and written where wgmma reads them (row 8 rh + rl, columns 4 ((rl
  // + sh) mod 8) ... of each piece of 32 columns: no bank conflict)
  {
    const float* qb = q + (static_cast<size_t>(b) * T + row0) * D;
    const int rows_q = min(kLongRows, T - row0);
    float4 x[kInQLoads];
#pragma unroll
    for (int it = 0; it < kInQLoads; ++it) {
      const int e = tid + kInThreads * it, f = e & 511, rl = f & 7, row = 8 * (f >> 6) + rl;
      const int col = (e >> 9) * kInCols + 4 * ((rl + (f >> 3)) & 7);
      x[it] = e < 512 * nq && row < rows_q && col < D
                  ? __ldg(reinterpret_cast<const float4*>(qb + static_cast<size_t>(row) * D + col))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < kInQLoads; ++it) {
      const int e = tid + kInThreads * it, f = e & 511, rl = f & 7, row = 8 * (f >> 6) + rl;
      if (e >= 512 * nq) continue;
      const int off = (e >> 9) * (4 * kLongRows * 8) + core_offset(row, (rl + (f >> 3)) & 7, kLongRows);
      float4 h4, l4;
      split4(x[it], h4, l4);
      *reinterpret_cast<float4*>(qs + off) = h4;
      *reinterpret_cast<float4*>(qs + kLongRows * Dp + off) = l4;
    }
    fence_proxy_async();
  }
  __syncthreads();  // Q's parts in place

  if (tid >= 128) {
    // ==== the producers: warpgroup 1 + w takes the pieces j = w mod 2.
    // Piece j is read from its raw slot once the TMA's bytes landed, split
    // into its TF32 parts and written where the consumer reads them once it
    // has freed the split slot; the TMA brings piece j + 4 into the raw
    // slot (a lane of one of the warpgroup's warps, in turn, asks for it).
    regs_shrink<kInProducerRegs>();
    const int wg = (tid >> 7) - 1, pwarp = (tid >> 5) & 3;
    InShares sh;
    sh.init(tid & 127);
    for (int j = wg; j < pieces; j += kInProducers) {
      const InPiece x = piece(j);
      float4 val[4];
      mbarrier_wait(raw_bar(j), (j / kInRawSlots) & 1);
      sh.read(x.is_v, raw + (j % kInRawSlots) * (kInRawBytes / 4), x.rows, val);
      producer_sync(1 + wg);  // every thread of the warpgroup has read the raw slot
      if (lane == 0 && pwarp == (j / kInProducers) % 4) fetch(j + kInRawSlots);
      mbarrier_wait(free_bar(j), ((j / kInSplitSlots) & 1) ^ 1);
      sh.write(x.is_v, slots + (j % kInSplitSlots) * (kInSlotBytes / 4), kInPartBytes / 4, val);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbarrier_arrive(full_bar(j));
    }
    return;
  }
  regs_grow<kInConsumerRegs>();

  // ==== the consumer: scores, the online softmax, P.V, on wgmma.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  float o[kInChunks][16];  // unnormalised output, chunk c: columns 32 c ...
#pragma unroll
  for (int c = 0; c < kInChunks; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[c][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: the maximum so far
  float l_run[2] = {0.f, 0.f};              // and this thread's share of sum exp(s - m)
  const float scale = 1.f / sqrtf(static_cast<float>(p.d_scale));
  const uint32_t q_lo_bytes = kLongRows * Dp * 4;
  int jc = 0;  // the consumer's piece
  auto slot_u = [&](int i) { return slots_u + (i % kInSplitSlots) * kInSlotBytes; };
  for (int blk = kb0; blk < kb1; ++blk) {
    // ---- scores of 64 rows x KB keys: a fresh 3xTF32 sum over each two
    // pieces (8 k-steps), both waited for before their products are issued
    float s[KB / 2], fresh[KB / 2];
#pragma unroll
    for (int c = 0; c < kInChunks; c += 2) {
      if (c < nq) {
        const int two = c + 1 < nq;
        mbarrier_wait(full_bar(jc), (jc / kInSplitSlots) & 1);
        if (two) mbarrier_wait(full_bar(jc + 1), ((jc + 1) / kInSplitSlots) & 1);
        wgmma_fence();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (half == 0 || two) {
            const uint32_t b_hi = slot_u(jc + half), b_lo = b_hi + kInPartBytes;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              const uint32_t a_hi = q_u + (4 * (c + half) + ks) * (kLongRows * 8 * 4);
              const uint32_t a_lo = a_hi + q_lo_bytes, o_b = ks * (KB * 8 * 4);
              wgmma_ss_n40(fresh, core_desc(a_lo), core_desc(b_hi + o_b), half || ks);
              wgmma_ss_n40(fresh, core_desc(a_hi), core_desc(b_lo + o_b), 1);
              wgmma_ss_n40(fresh, core_desc(a_hi), core_desc(b_hi + o_b), 1);
            }
          }
        }
        wgmma_commit();
        wgmma_wait0();
        pin(fresh);
        if (lane == 0) {
          mbarrier_arrive(free_bar(jc));
          if (two) mbarrier_arrive(free_bar(jc + 1));
        }
        jc += 1 + two;
#pragma unroll
        for (int i = 0; i < KB / 2; ++i) s[i] = c == 0 ? fresh[i] : s[i] + fresh[i];
      }
    }
    // ---- online softmax in registers: scale, mask, rescale to the new max
    const int key0 = blk * KB + 2 * t4;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KB / 2; ++i) {
      const int key = key0 + 8 * (i >> 2) + (i & 1);
      const float sc = s[i] * scale;
      s[i] = key >= S ? -INFINITY : (key < length ? sc : kMasked);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // finite: a walked block holds a key < S (a score or -1e30)
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = m_run[h] == -INFINITY ? 0.f : expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
    // P = exp(s - m) as P.V's A fragments (key 8j + 2t in lane column t,
    // 8j + 2t + 1 in column t + 4, as V's k-positions stand)
    uint32_t p_hi[KB / 8][4], p_lo[KB / 8][4];
#pragma unroll
    for (int i = 0; i < KB / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float e = expf(s[i] - m_run[h]);
      l_run[h] += e;
      const int a = (i & 1) * 2 + h;
      split_tf32(e, p_hi[i >> 2][a], p_lo[i >> 2][a]);
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int c = 0; c < kInChunks; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    }
    // ---- O += P.V, a fresh 3xTF32 sum a piece (32 columns, KB / 8 k-steps)
#pragma unroll
    for (int c = 0; c < kInChunks; ++c) {
      if (c < nq) {
        mbarrier_wait(full_bar(jc), (jc / kInSplitSlots) & 1);
        const uint32_t b_hi = slot_u(jc), b_lo = b_hi + kInPartBytes;
        float f16[16];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KB / 8; ++ks) {
          const uint32_t o_k = ks * (kInCols * 8 * 4);
          wgmma_rs_n32(f16, p_lo[ks], core_desc(b_hi + o_k), ks > 0);
          wgmma_rs_n32(f16, p_hi[ks], core_desc(b_lo + o_k), 1);
          wgmma_rs_n32(f16, p_hi[ks], core_desc(b_hi + o_k), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        pin(f16);
        if (lane == 0) mbarrier_arrive(free_bar(jc));
        ++jc;
#pragma unroll
        for (int i = 0; i < 16; ++i) o[c][i] += f16[i];
      }
    }
  }

  // ---- the rows' sums over their quads; O / l, or the split's partials
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  const int r0 = row0 + 16 * warp + g;
#pragma unroll
  for (int c = 0; c < kInChunks; ++c) {
    if (c < nq) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = c * kInCols + 8 * n + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= T || col >= D) continue;
          float2 val = make_float2(o[c][4 * n + 2 * h], o[c][4 * n + 2 * h + 1]);
          if (p.splits == 1) {
            val = make_float2(val.x / l_run[h], val.y / l_run[h]);
            *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * T + row) * D + col) = val;
          } else {
            *reinterpret_cast<float2*>(ws + (part + row) * D + col) = val;
          }
        }
      }
    }
  }
  if (p.splits > 1 && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < T) {
        ws[ws_rows * D + part + row] = m_run[h];
        ws[ws_rows * (D + 1) + part + row] = l_run[h];
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no link to libcuda); null where it is missing.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  return encode;
}

// The (rows, D) fp32 tensor at `base` for TMA boxes of 32 columns x
// `box_rows` rows, no swizzle (rows of 128 bytes), zeros past its edges.
bool encode_rows(CUtensorMap* map, const float* base, long long rows, int D, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {kInCols, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The split pass (or the in-block instance's TMA maps), the attention, and
// for more than one split the combine, on `stream`, for each chunk of
// `batch` samples in turn.  The workspace: the split pieces, then the
// partials, of one chunk (the chunks reuse it).
cudaError_t launch_long(const LongPlan& p, const float* q, const float* k, const float* v,
                        const int* lengths, float* out, float* ws, cudaStream_t stream) {
  const bool in_block = p.mode == kInBlock;
  const auto kernel = p.slices > 1 ? long_attention_kernel<true> : long_attention_kernel<false>;
  const auto in_kernel = in_block_attention_kernel;
  cudaError_t err = in_block
      ? cudaFuncSetAttribute(in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem)
      : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  for (int b0 = 0; b0 < p.B; b0 += p.batch) {
    LongPlan c = p;
    c.B = min(p.batch, p.B - b0);
    const size_t qo = static_cast<size_t>(b0) * p.T * p.D, ko = static_cast<size_t>(b0) * p.S * p.D;
    const long long pieces = long_pieces(c);
    float* partials = ws + 2LL * kPart * pieces;
    const dim3 grid(c.row_blocks * c.slices, c.splits, c.B);
    if (in_block) {
      CUtensorMap tm_k, tm_v;
      const long long rows = static_cast<long long>(c.B) * c.S;
      if (!encode_rows(&tm_k, k + ko, rows, c.D, c.key_block) ||
          !encode_rows(&tm_v, v + ko, rows, c.D, c.key_block))
        return cudaErrorInvalidValue;
      in_kernel<<<grid, kInThreads, c.smem, stream>>>(q + qo, tm_k, tm_v, lengths + b0, out + qo,
                                                      partials, c);
    } else {
      split_pieces_kernel<<<static_cast<unsigned>(pieces), 256, 0, stream>>>(
          q + qo, k + ko, v + ko, lengths + b0, ws, c);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      kernel<<<grid, kLongThreads, c.smem, stream>>>(ws, lengths + b0, out + qo, partials, c);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (c.splits == 1) continue;
    const long long rows = static_cast<long long>(c.B) * c.T;
    combine_splits_kernel<<<static_cast<unsigned>((rows * (c.D / 4) + 255) / 256), 256, 0,
                            stream>>>(partials, out + qo, rows, c.D, c.splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns the CUDA error (0 on success).
// The library links its own CUDA runtime, so it selects the device itself.
// `plan`: the ints of vcagan_torch/kernels/masked_attention.py::
// AttentionPlan.ints(B); a plan that does not match refuses the launch.
int vcagan_masked_attention(const float* q, const float* k, const float* v, const int* lengths,
                            float* out, const int* plan, int plan_len, int device, void* stream) {
  if (plan_len != kPlanInts) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8], plan[9]};
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.d_chunk == kMaxChunk ? launch<kMaxChunk>(p, q, k, v, lengths, out, s)
                               : launch<8>(p, q, k, v, lengths, out, s);
  return static_cast<int>(err);
}

// The key-blocked instances: the in-block one (mode 1: the attention and,
// for more than one split, the combine) and the split pass (mode 0: the
// split pass, the attention and the combine), on `stream`, for each chunk
// of the plan's `batch` samples.  `plan`: the ints of
// vcagan_torch/kernels/masked_attention.py::LongAttentionPlan.ints();
// `workspace`: that plan's workspace floats, 16-byte aligned (none for the
// in-block instance with one split).
int vcagan_masked_attention_long(const float* q, const float* k, const float* v,
                                 const int* lengths, float* out, float* workspace,
                                 const int* plan, int plan_len, int device, void* stream) {
  if (plan_len != kLongPlanInts) return static_cast<int>(cudaErrorInvalidValue);
  const LongPlan p{plan[0], plan[1], plan[2],  plan[3],  plan[4],  plan[5],  plan[6],
                   plan[7], plan[8], plan[9], plan[10], plan[11], plan[12], plan[13]};
  const bool no_workspace = p.ws_hi == 0 && p.ws_lo == 0;
  if (!long_plan_ok(p) || (workspace == nullptr && !no_workspace) ||
      reinterpret_cast<uintptr_t>(workspace) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_long(p, q, k, v, lengths, out, workspace, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
