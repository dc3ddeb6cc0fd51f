// Length-masked cross-attention, forward, fp32:
//   out[b] = softmax(q[b] k[b]^T / sqrt(D), keys >= lengths[b] -> -1e30) v[b]
// q (B,T,D), k/v (B,S,D), lengths (B,) int32, out (B,T,D); all contiguous,
// 16-byte aligned; D a multiple of 8, any S >= 1.
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
// Design (both products on the tensor cores, mma.sync m16n8k8 TF32):
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
// - Past 512 keys (the key-blocked instance, BLOCKED = true).  The strip of
//   16 x S scores a tile is what caps S: four of them, Q and the K/V ring
//   fill the 227 KB at S = 512 and D = 256.  So for S > 512 the keys go in
//   blocks of `key_block` (256; the plan's) through the same strip, with an
//   online softmax: after a block's scores, each row's block maximum m_blk,
//   m_new = max(m, m_blk), alpha = exp(m - m_new) (0 where m is still -inf,
//   before the first block, never NaN), e = exp(s - m_new) written back in
//   the strip, l = l * alpha + sum(e); then P.V over the block's V pieces
//   with e as P, and at the end of each D chunk the tile's output sum in
//   shared memory (16 x D fp32 a tile: 16 KB at D = 256, too many registers
//   for a thread) becomes O * alpha + (this block's e.V).  The last block
//   writes (O * alpha + e.V) / l to the output.  Every block holds a real
//   key (blocks start at multiples of 256 < S; padding is under 8 keys and
//   sits in the last block), so m is finite after the first block: -1e30
//   keys average as in the strip form and -inf keys weigh exactly 0.  The
//   K/V ring walks (block, K pieces, V pieces), so the copy of the next
//   block's first K piece runs under the last V piece of this one.  One
//   pass over the keys, as the strip form: each key's scores are computed
//   once.  S <= 512 takes the strip instance (BLOCKED = false), as before.
//   Past 512 keys the bound is the operations (4 T S D flops against
//   4 (2 T D + 2 S D) bytes): 10.2 us at (4, 750, 750), 0.104 ms at
//   (1, 4096, 4096).  The first version runs 35x and 16x those
//   (chip_smoke, phase 12): (4, 750, 750) is 48 blocks of 4 tiles for 132
//   SMs, and each tile's chain of products over all S keys is the time.
//
// What holds it back (9x its bound): for every 3 products a warp loads 2 B
// values and splits them, and every warp of a block splits the same K and
// V values again.  Later work: K/V pieces and Q split once into shared
// memory, a grid balanced over the SMs, wgmma with A from registers, K/V by
// TMA, a swizzled layout, a persistent grid.

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
constexpr int kMaxKeys = 512;       // the strip form's keys, and a key block's
constexpr int kMaxSmem = 232448;   // 227 KB a block may use
constexpr int kPlanInts = 9;
constexpr float kMasked = -1e30f;

// key_block 0: one strip of all S <= 512 keys; else keys in blocks of it.
struct Plan {
  int B, T, S, D, warps, d_chunk, row_tiles, key_block, smem;
};

// Warps a 16-row tile: two share the n-tiles of a chunk of 64 columns; a
// chunk of 8 is a single n-tile, computed by one warp.
__host__ __device__ constexpr int split_of(int dc) { return dc > 8 ? 2 : 1; }

// Row strides in floats, as AttentionPlan has them.
__host__ __device__ constexpr int q_stride(int D) { return D + 4; }
__host__ __device__ constexpr int p_stride(int S) { return (S + 7) / 8 * 8 + 4; }
__host__ __device__ constexpr int k_stride(int dc) { return dc + 4; }
__host__ __device__ constexpr int v_stride(int dc) { return dc % 16 == 8 ? dc : dc + 8; }
// The output sums (key-blocked form): float2 at rows g, columns 2t, so the
// stride is 8 (mod 32) floats.
__host__ __device__ constexpr int o_stride(int D) { return D + ((8 - D) % 32 + 32) % 32; }
__host__ __device__ constexpr int buf_floats(int dc) {
  return kKeyTile * (k_stride(dc) > v_stride(dc) ? k_stride(dc) : v_stride(dc));
}

// Q rows, one score strip a 16-row tile (of S keys, or of a key block),
// two K/V buffers; key-blocked, also the output sums and a tile's alpha
// and l by row.
size_t smem_bytes(int tiles, int S, int D, int dc, int key_block) {
  const size_t rows = static_cast<size_t>(kRows) * tiles;
  size_t floats = rows * q_stride(D) + rows * p_stride(key_block ? key_block : S) +
                  2 * static_cast<size_t>(buf_floats(dc));
  if (key_block) floats += rows * o_stride(D) + 2 * rows;
  return sizeof(float) * floats;
}

bool plan_ok(const Plan& p) {
  if (p.B < 1 || p.B > 65535 || p.T < 1 || p.S < 1) return false;
  if (p.key_block == 0 ? p.S > kMaxKeys
                       : p.key_block % kKeyTile != 0 || p.key_block < kKeyTile ||
                             p.key_block > kMaxKeys)
    return false;
  if (p.D < 8 || p.D % 8 != 0) return false;
  if (p.d_chunk != 8 && p.d_chunk != kMaxChunk) return false;
  if (p.D % p.d_chunk != 0) return false;
  const int split = split_of(p.d_chunk);
  if (p.warps < 1 || p.warps > kMaxWarps || p.warps % split != 0) return false;
  const int rows = kRows * (p.warps / split);
  if (p.row_tiles != (p.T + rows - 1) / rows) return false;
  const size_t smem = smem_bytes(p.warps / split, p.S, p.D, p.d_chunk, p.key_block);
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
// BLOCKED: the keys in blocks of p.key_block with an online softmax (S > 512);
// else one block of all S keys, P normalised in the strip.
template <int DC, bool BLOCKED, int SPLIT = split_of(DC)>
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
  const int KB = BLOCKED ? p.key_block : S;        // keys of a block (the last: the rest)
  const int tiles = p.warps / SPLIT;               // 16-row tiles of the block
  const int qst = q_stride(D), pst = p_stride(KB), ost = o_stride(D);
  float* qs = smem;                                // 16 tiles x qst
  float* strips = qs + kRows * tiles * qst;        // tiles x 16 x pst
  float* ring = strips + kRows * tiles * pst;      // 2 x buf
  float* osum = ring + 2 * buf;                    // BLOCKED: tiles x 16 x ost
  float* alpha_s = osum + kRows * tiles * ost;     // BLOCKED: a row's rescale
  float* l_s = alpha_s + kRows * tiles;            // BLOCKED: a row's running sum

  const int tid = threadIdx.x, nthreads = 32 * p.warps;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int tile = warp / SPLIT, part = warp % SPLIT;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows * tiles;
  const int row0 = t0 + kRows * tile;              // this warp's first row
  const bool active = row0 < T;                    // warp-uniform
  const int length = lengths[b];
  const float sqrt_d = sqrtf(static_cast<float>(D));
  float* strip = strips + tile * kRows * pst;

  const float* kb_ptr = k + static_cast<size_t>(b) * S * D;
  const float* vb_ptr = v + static_cast<size_t>(b) * S * D;
  const int chunks = D / DC;
  const int blocks = BLOCKED ? (S + KB - 1) / KB : 1;
  const int kt_full = (KB + kKeyTile - 1) / kKeyTile;  // key tiles of a block
  const int kt_last = (S - (blocks - 1) * KB + kKeyTile - 1) / kKeyTile;
  const int per_block = 2 * kt_full * chunks;           // K then V pieces of a block
  const int pieces = (blocks - 1) * per_block + 2 * kt_last * chunks;

  // Piece pc: its key block kb, the block's key tiles kt, K or V, its key
  // tile j within the block and its D chunk c.  K pieces walk (j, c), V
  // pieces (c, j).
  struct Piece {
    int kb, kt, i;
    bool is_v;
    int j, c;
  };
  auto piece_of = [&](int pc) {
    Piece x;
    x.kb = 0;
    x.i = pc;
    if constexpr (BLOCKED) {
      x.kb = min(pc / per_block, blocks - 1);
      x.i = pc - x.kb * per_block;
    }
    x.kt = x.kb == blocks - 1 ? kt_last : kt_full;
    const int kp = x.kt * chunks;
    x.is_v = x.i >= kp;
    if (x.is_v) x.i -= kp;
    x.j = x.is_v ? x.i % x.kt : x.i / chunks;
    x.c = x.is_v ? x.i / x.kt : x.i % chunks;
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
    const int key0 = x.kb * KB + x.j * kKeyTile;
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
  float acc[kMV][4];     // a D chunk of the output, summed over a block's keys
  float m_run[2] = {-INFINITY, -INFINITY};  // BLOCKED: rows g, g + 8: max so far
  float l_run[2] = {0.f, 0.f};              // and the sum of exp(s - max)

  load_piece(0);
  cp_async_commit();  // with the query rows
  for (int pc = 0; pc < pieces; ++pc) {
    if (pc + 1 < pieces) load_piece(pc + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();  // piece pc (and the query rows) visible to all warps
    const float* piece = ring + (pc & 1) * buf;
    const Piece x = piece_of(pc);
    const int kbase = x.kb * KB;                  // the block's first key
    const int key0 = kbase + x.j * kKeyTile;      // the piece's first key
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
                const int col = j * kKeyTile + 8 * (i * SPLIT + part) + 2 * t4 + (e & 1);
                const int key = kbase + col;
                const float sc = score[i][e] / sqrt_d;
                strip[(g + 8 * (e >> 1)) * pst + col] =
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
        const int cols = (min(KB, S - kbase) + 7) / 8 * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!active || h % SPLIT != part) continue;
          float* row = strip + (g + 8 * h) * pst;
          float m = -INFINITY;
          for (int xx = t4; xx < cols; xx += 4) m = fmaxf(m, row[xx]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if constexpr (BLOCKED) {
            // m is finite: the block holds a real key (score or -1e30)
            const float m_new = fmaxf(m_run[h], m);
            const float alpha = m_run[h] == -INFINITY ? 0.f : expf(m_run[h] - m_new);
            float sum = 0.f;
            for (int xx = t4; xx < cols; xx += 4) {
              const float e = expf(row[xx] - m_new);
              row[xx] = e;
              sum += e;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l_run[h] = l_run[h] * alpha + sum;
            m_run[h] = m_new;
            if (t4 == 0) {
              alpha_s[kRows * tile + g + 8 * h] = alpha;
              l_s[kRows * tile + g + 8 * h] = l_run[h];
            }
          } else {
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
        }
        __syncthreads();  // P of the whole tile (and alpha, l) visible to its warps
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
          if (ks < k_steps) {  // the strip ends at the block's keys rounded up to 8
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
        if (j == x.kt - 1) {  // the chunk is complete over the block's keys
#pragma unroll
          for (int i = 0; i < kMV; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = kRows * tile + g + 8 * h;  // the row within the block
              const int row = t0 + r;
              const int col = c * DC + 8 * (i * SPLIT + part) + 2 * t4;
              float2 val = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
              if constexpr (BLOCKED) {
                float2* o = reinterpret_cast<float2*>(osum + r * ost + col);
                if (x.kb > 0) {  // O * alpha + this block's e.V
                  const float a = alpha_s[r];
                  const float2 prev = *o;
                  val = make_float2(prev.x * a + val.x, prev.y * a + val.y);
                }
                if (x.kb < blocks - 1) {
                  *o = val;
                  continue;
                }
                const float l = l_s[r];
                val = make_float2(val.x / l, val.y / l);
              }
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

template <int DC, bool BLOCKED>
cudaError_t launch(const Plan& p, const float* q, const float* k, const float* v,
                   const int* lengths, float* out, cudaStream_t stream) {
  const auto kernel = masked_attention_kernel<DC, BLOCKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.row_tiles, p.B);
  kernel<<<grid, 32 * p.warps, p.smem, stream>>>(q, k, v, lengths, out, p);
  return cudaGetLastError();
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
               plan[5], plan[6], plan[7], plan[8]};
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.key_block == 0) {
    err = p.d_chunk == kMaxChunk ? launch<kMaxChunk, false>(p, q, k, v, lengths, out, s)
                                 : launch<8, false>(p, q, k, v, lengths, out, s);
  } else {
    err = p.d_chunk == kMaxChunk ? launch<kMaxChunk, true>(p, q, k, v, lengths, out, s)
                                 : launch<8, true>(p, q, k, v, lengths, out, s);
  }
  return static_cast<int>(err);
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
