// The visual front's stem on the folded bf16 serving path, forward, one launch:
//   y   = bf16(bf16(conv3d(bf16(video), bf16(w))) + bf16(b))   k(5,7,7) s(1,2,2) p(2,3,3)
//   y   = bf16(PReLU(y, bf16(a)))
//   out = max_pool3d(y, (1,3,3), s(1,2,2), p(0,1,1))            pad -inf
// video (B,T,H,W,1) fp32; w packed by
// vcagan_torch/kernels/fused_stem.py::pack_stem_weights from (C,1,5,7,7); b, a
// (C,) fp32; out (B*T, H', W', C) bf16 channels innermost, the layout the fused
// ResNet blocks read.  The 245 products of an output are summed in fp32; the
// rounding points are those of the module chain (vcagan/nn/visual_front.py:
// 35-50, 90-99).  Time and space pad with zeros; any B, T, H, W; C a multiple
// of 64.
//
// Replaces no TPU kernel: the JAX stem is XLA's convolution
// (vcagan/nn/common.py:67-114, s2d_stem_conv3d) and XLA's pool.  It was added
// because on an H100 the chain of library calls took 31.9 ms of a 104 ms
// B=48 x 75 serving batch: an fp32 cuDNN convolution, a bias pass, a PReLU
// pass, max_pool3d_with_indices (int64 indices nobody reads) and a permute
// copy into the trunk's layout, each over a 1.4 GB map.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): at (B, T) = (48, 75),
// 112x112, C = 64, the convolution makes 3600 x 56 x 56 x 64 = 722.5 M outputs
// of 245 multiply-adds, 354 GFLOP, 0.358 ms; the bytes are the video read once
// (180.6 MB fp32) and the pooled map written once (361 MB bf16), 0.162 ms.  So
// the stem is bound by its operations.
//
// Design (an implicit GEMM, pixels x 64 output channels over k = the window,
// on wgmma bf16 with fp32 accumulators in registers):
// - The 1-channel input makes im2col rows short and misaligned (a window of 7
//   columns starts at the odd column 2w-3).  K is ordered so that every
//   32-bit value of A is two neighbouring input columns that start at an even
//   column: the 7 taps of a window row become 4 pairs, (-1,0) (1,2) (3,4)
//   (5,6) with tap -1's weight zero, so k = 5 x 7 x 8 = 280, padded to 288
//   (18 k-steps of 16; the 14% of zero products is the price of one aligned
//   32-bit load a value).  A comes from REGISTERS (one address a pixel, as in
//   fused_block.cu), B, the packed weights, from shared memory, where they
//   stay for the block's life (36,864 bytes for 64 channels).
// - A block owns a band of P pooled rows (the 2P+1 convolution rows under
//   them, one of them again computed by the neighbouring band) of one clip
//   and walks over TC of its frames.  The five input frames a step reads are
//   kept as bf16 bands in a ring in shared memory, with the zero columns and
//   rows of the padding written in, so that no read is masked: each input
//   frame is read from device memory once a band, as fp32, by cp.async into a
//   staging band while the step before it computes, then rounded to bf16 into
//   the ring slot that the frame five steps back leaves.  The first five come
//   in together at the start, through the convolution tile's space.
// - 8 warps, two warpgroups; a step's tiles of 64 pixels go round the
//   warpgroups, each accumulating up to 4 at once.  The 18 k-steps are
//   unrolled so that a value's window row and frame are constants: its
//   address is the ring slot of the frame + the pixel's row + a constant;
//   the next k-step's values are read while this k-step's products run.
// - Epilogue in registers (bf16x2): round the sum, add the bias, PReLU as
//   fma(a, min(y, 0), max(y, 0)), each rounded once as the chain rounds them;
//   the tile goes to shared memory as [pixel][channel] (16 bytes of padding a
//   pixel against bank conflicts), and after a barrier the 3x3 / stride-2 max
//   is taken there and stored, 16 bytes (8 channels) a thread, into the
//   channels-last output.  Nothing else reaches device memory.
// - Per k-step the tensor cores take 32 cycles a tile while shared memory
//   serves that tile's A (2 KB) and B (2 KB) at 128 bytes a cycle, so the
//   products run at about the shared-memory rate; the plan (P, TC) is made in
//   Python (plan_fused_stem) to fill the 132 SMs in whole waves, and checked
//   here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB a block may use
constexpr int kPlanInts = 8;
constexpr int kChunk = 64;                            // output channels a block
constexpr int kSteps = 18;                            // k-steps of 16 values
constexpr int kPairs = 140;                           // 5 frames x 7 rows x 4 column pairs
constexpr int kStepBytes = kChunk * 16 * 2;           // packed bytes a k-step
constexpr int kWeightBytes = kSteps * kStepBytes;     // 36,864
constexpr int kPixelBytes = (kChunk + 8) * 2;         // a pixel of the convolution tile
constexpr int kParamBytes = 2 * kChunk * 2 + 16;      // bias and slopes as bf16, a zero row
constexpr int kFrames = 5;                            // the ring
constexpr int kMT = 4;                                // tiles a warpgroup at once

struct Plan {
  int B, T, H, W, C;
  int P, TC;  // pooled rows a band; frames a block
  int smem;
};

// What the kernel derives from the plan (the same formulas as
// fused_stem.py's StemPlan and _smem_bytes).
struct Geo {
  int B, T, H, W, C, P, TC;
  int Ho, Wo, Hp, Wp;
  int conv_rows, band_rows, row_elems;  // capacity of the tile; a band's rows, its row's elements
  int bands, chunks, cchunks;
  int slot, staging, scratch;  // bytes
};

int round16(int n) { return (n + 15) / 16 * 16; }
int ceil_div(int a, int b) { return (a + b - 1) / b; }

Geo geometry(const Plan& p) {
  Geo g;
  g.B = p.B; g.T = p.T; g.H = p.H; g.W = p.W; g.C = p.C; g.P = p.P; g.TC = p.TC;
  g.Ho = (p.H - 1) / 2 + 1;
  g.Wo = (p.W - 1) / 2 + 1;
  g.Hp = (g.Ho - 1) / 2 + 1;
  g.Wp = (g.Wo - 1) / 2 + 1;
  g.conv_rows = std::min(2 * p.P + 1, g.Ho);
  g.band_rows = 2 * g.conv_rows + 5;
  g.row_elems = 2 * g.Wo + 6;
  g.bands = ceil_div(g.Hp, p.P);
  g.chunks = ceil_div(p.T, p.TC);
  g.cchunks = p.C / kChunk;
  const int band = g.band_rows * g.row_elems;
  g.slot = round16(2 * band);
  g.staging = round16(4 * band);
  g.scratch = std::max(g.conv_rows * g.Wo * kPixelBytes, kFrames * g.staging);
  return g;
}

long long smem_bytes(const Geo& g) {
  return static_cast<long long>(kWeightBytes) + kFrames * g.slot + g.staging + g.scratch +
         kParamBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
// One fp32 value, or 4 zero bytes where `valid` is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int size = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(size)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds_u32(const unsigned char* base, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

// ---- wgmma (as in fused_block.cu): D (64 pixels x 64 channels, fp32, in the
// registers of a warpgroup's 4 warps, 16 rows each: a thread holds rows g8 and
// g8 + 8, columns 2 t4 and 2 t4 + 1 of every 8 channels) += A (64 x 16 bf16
// from registers: a0 (g8, 2 t4 ..), a1 (g8 + 8, 2 t4 ..), a2 (g8, 2 t4 + 8 ..),
// a3 (g8 + 8, 2 t4 + 8 ..), two values a register, the lower k in the lower
// half) * B (16 x 64, read by the tensor cores from shared memory: core
// matrices of 8 output channels x 16 bytes of k, the two halves of a k-step
// 128 bytes apart, groups of 8 channels 256 bytes apart, no swizzle).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A's registers of k-step `s` for the first L tiles.  Pair q = 8 s + 4 h + t4
// is (frame dt, window row dy, column pair t4): its word stands at the ring
// slot of frame dt (`slot_o[dt]`) + dy rows + the pixel's own offset (`rb`,
// which holds 4 t4 already).  The pairs past 140 read the zero row.
template <int L>
__device__ __forceinline__ void load_a(uint32_t (&a)[L][4], const unsigned char* smem,
                                       const uint32_t (&rb)[kMT][2], const uint32_t (&slot_o)[5],
                                       uint32_t row_bytes, uint32_t zero_o, int s) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 8 * s + 4 * h;
    const bool pad = q >= kPairs;
    const int dt = pad ? 0 : q / 28, dy = pad ? 0 : (q % 28) / 4;
    const uint32_t off = slot_o[dt] + dy * row_bytes;
#pragma unroll
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        a[i][2 * h + rh] = lds_u32(smem, pad ? zero_o : off + rb[i][rh]);
    }
  }
}

// The 18 k-steps of the first L tiles: each k-step's products are issued,
// then the next k-step's A is read into the other set of registers once the
// products before them are through.
template <int L>
__device__ __forceinline__ void products(float (&acc)[kMT][32], const unsigned char* smem,
                                         uint32_t w_u, const uint32_t (&rb)[kMT][2],
                                         const uint32_t (&slot_o)[5], uint32_t row_bytes,
                                         uint32_t zero_o) {
  uint32_t a[2][L][4];
  load_a<L>(a[0], smem, rb, slot_o, row_bytes, zero_o, 0);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < L; ++i)
      wgmma_m64n64k16(acc[i], a[s & 1][i], b_descriptor(w_u + s * kStepBytes));
    wgmma_commit();
    if (s + 1 < kSteps) {
      wgmma_wait<1>();  // the products that read the other set are through
      load_a<L>(a[(s + 1) & 1], smem, rb, slot_o, row_bytes, zero_o, s + 1);
    }
  }
  wgmma_wait<0>();
}

__device__ __forceinline__ uint32_t max8(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_stem_kernel(const float* __restrict__ video, const unsigned char* __restrict__ wpk,
                  const float* __restrict__ bias, const float* __restrict__ slope,
                  __nv_bfloat16* __restrict__ out, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  // The warp's number by a shuffle, so that the compiler knows it to be the
  // same in all lanes.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, wi = warp & 3;  // warpgroup; warp in it
  const int g8 = lane >> 2, t4 = lane & 3;

  // block -> (channel chunk, band, frame chunk, clip), the channel chunk
  // fastest: blocks that run together share their input frames in L2.
  int rest = blockIdx.x;
  const int cc = rest % g.cchunks;
  rest /= g.cchunks;
  const int band = rest % g.bands;
  rest /= g.bands;
  const int chunk = rest % g.chunks;
  const int clip = rest / g.chunks;
  const int p0 = band * g.P, p1 = min(p0 + g.P, g.Hp);
  const int h0 = max(2 * p0 - 1, 0), h1 = min(2 * p1, g.Ho);  // convolution rows
  const int M = (h1 - h0) * g.Wo;                             // pixels a step
  const int t0 = chunk * g.TC, t1 = min(t0 + g.TC, g.T);
  const int row0 = 2 * h0 - 3;  // input row of a band's row 0
  const int rp = g.row_elems, band_elems = g.band_rows * g.row_elems;
  const uint32_t row_bytes = 2 * rp;

  // Shared memory: weights | ring of 5 bf16 bands | fp32 band in flight |
  // convolution tile (the first 5 fp32 bands at the start) | bias, slopes
  // (bf16) | a zero row.
  const uint32_t ring_o = kWeightBytes, stage_o = ring_o + kFrames * g.slot;
  const uint32_t tile_o = stage_o + g.staging, param_o = tile_o + g.scratch;
  const uint32_t zero_o = param_o + 2 * kChunk * 2;
  const uint32_t smem_u = smem_u32(smem);
  __nv_bfloat16* params = reinterpret_cast<__nv_bfloat16*>(smem + param_o);

  // One input frame's band into an fp32 band at `dst_o`: the rows and
  // columns of the padding, and frames outside the clip, as zeros.
  auto load_frame = [&](int f, uint32_t dst_o) {
    const bool in_clip = f >= 0 && f < g.T;
    const float* frame = video + (static_cast<size_t>(clip) * g.T + (in_clip ? f : 0)) *
                                     static_cast<size_t>(g.H) * g.W;
    for (int idx = tid; idx < band_elems; idx += kThreads) {
      const int r = idx / rp, c = idx - r * rp;
      const int row = row0 + r, col = c - 4;
      const bool ok = in_clip && row >= 0 && row < g.H && col >= 0 && col < g.W;
      cp_async4(smem_u + dst_o + 4 * idx, ok ? frame + static_cast<size_t>(row) * g.W + col : video,
                ok);
    }
  };
  // An fp32 band at `src_o` rounded to bf16 into the ring slot at `dst_o`.
  auto convert = [&](uint32_t src_o, uint32_t dst_o) {
    for (int i = tid; i < band_elems / 2; i += kThreads) {
      const float2 v = *reinterpret_cast<const float2*>(smem + src_o + 8 * i);
      *reinterpret_cast<__nv_bfloat162*>(smem + dst_o + 4 * i) = __floats2bfloat162_rn(v.x, v.y);
    }
  };

  // ---- the start: weights, the first five frames, bias and slopes.
  const unsigned char* wsrc = wpk + static_cast<size_t>(cc) * kWeightBytes;
  for (int i = tid; i < kWeightBytes / 16; i += kThreads)
    cp_async16(smem_u + 16 * i, wsrc + 16 * i);
  for (int i = 0; i < kFrames; ++i) load_frame(t0 - 2 + i, tile_o + i * g.staging);
  cp_async_commit();
  for (int i = tid; i < kChunk; i += kThreads) {
    params[i] = __float2bfloat16_rn(bias[cc * kChunk + i]);
    params[kChunk + i] = __float2bfloat16_rn(slope[cc * kChunk + i]);
  }
  if (tid < 4) reinterpret_cast<uint32_t*>(smem + zero_o)[tid] = 0u;
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0; i < kFrames; ++i) convert(tile_o + i * g.staging, ring_o + i * g.slot);
  __syncthreads();

  const int tiles = (M + 63) / 64;
  const int rounds = (tiles + 2 * kMT - 1) / (2 * kMT);
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  // This thread's channels 8 j + 2 t4, +1: their bias and slopes, kept in
  // registers for every epilogue.
  __nv_bfloat162 bias2[8], slope2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bias2[j] = *reinterpret_cast<const __nv_bfloat162*>(params + 8 * j + 2 * t4);
    slope2[j] = *reinterpret_cast<const __nv_bfloat162*>(params + kChunk + 8 * j + 2 * t4);
  }
  __nv_bfloat16* clip_out = out + static_cast<size_t>(clip) * g.T * g.Hp * g.Wp * g.C + cc * kChunk;

#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int k = t - t0;
    const bool more = t + 1 < t1;
    // The frame the next step adds, in flight while this step computes.
    if (more) load_frame(t + 3, stage_o);
    cp_async_commit();
    // Frames t - 2 .. t + 2 stand in slots (k + dt) % 5.
    uint32_t slot_o[5];
#pragma unroll
    for (int dt = 0; dt < 5; ++dt) slot_o[dt] = ring_o + ((k + dt) % kFrames) * g.slot;

#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      // This warpgroup's tiles: first, first + 2, ... (L of them).
      const int first = round * 2 * kMT + wg;
      const int L = min(kMT, max(0, (tiles - first + 1) / 2));
      if (L == 0) continue;
      // Each fragment row's pixel: its offset in a band (rows past M read
      // pixel 0 and store nothing).
      uint32_t rb[kMT][2];
      int pix[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (first + 2 * i) * 64 + wi * 16 + g8 + 8 * half;
          const int r = m < M ? m / g.Wo : 0, c = m < M ? m - r * g.Wo : 0;
          pix[i][half] = m < M ? m : -1;
          rb[i][half] = (2 * r * rp + 2 * c) * 2 + 4 * t4;
        }
      }
      float acc[kMT][32];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
      switch (L) {
        case 1: products<1>(acc, smem, smem_u, rb, slot_o, row_bytes, zero_o); break;
        case 2: products<2>(acc, smem, smem_u, rb, slot_o, row_bytes, zero_o); break;
        case 3: products<3>(acc, smem, smem_u, rb, slot_o, row_bytes, zero_o); break;
        default: products<4>(acc, smem, smem_u, rb, slot_o, row_bytes, zero_o); break;
      }
      // Epilogue: rows g8 and g8 + 8 of each tile, channels 8 j + 2 t4, +1.
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (i < L && pix[i][half] >= 0) {
            unsigned char* dst = smem + tile_o + pix[i][half] * kPixelBytes;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              __nv_bfloat162 y = __floats2bfloat162_rn(acc[i][4 * j + 2 * half],
                                                       acc[i][4 * j + 2 * half + 1]);
              y = __hadd2(y, bias2[j]);
              y = __hfma2(slope2[j], __hmin2(y, zero2), __hmax2(y, zero2));
              *reinterpret_cast<__nv_bfloat162*>(dst + 2 * (8 * j + 2 * t4)) = y;
            }
          }
        }
      }
    }
    if (more) cp_async_wait_all();
    __syncthreads();  // the tile is whole; the oldest slot is read; the next band is in

    // The pool: pooled row pr takes convolution rows 2 pr - 1 .. 2 pr + 1 of
    // the image (the tile's rows from h0), columns likewise; 8 channels a
    // thread.  A window that leaves the image reads its edge again, which
    // leaves the max as it is, so the nine reads are always made, together.
    __nv_bfloat16* frame_out = clip_out + static_cast<size_t>(t) * g.Hp * g.Wp * g.C;
    const int items = (p1 - p0) * g.Wp * 8;
    for (int idx = tid; idx < items; idx += kThreads) {
      const int cg = idx & 7, pixel = idx >> 3;
      const int prl = pixel / g.Wp, pc = pixel - prl * g.Wp, pr = p0 + prl;
      const int ys[3] = {max(2 * pr - 1, 0) - h0, 2 * pr - h0, min(2 * pr + 1, g.Ho - 1) - h0};
      const int xs[3] = {max(2 * pc - 1, 0), 2 * pc, min(2 * pc + 1, g.Wo - 1)};
      const unsigned char* col0 = smem + tile_o + cg * 16;
      uint4 v[9];
#pragma unroll
      for (int y = 0; y < 3; ++y)
#pragma unroll
        for (int x = 0; x < 3; ++x)
          v[3 * y + x] =
              *reinterpret_cast<const uint4*>(col0 + (ys[y] * g.Wo + xs[x]) * kPixelBytes);
      uint4 m = v[4];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        m.x = max8(m.x, v[e].x);
        m.y = max8(m.y, v[e].y);
        m.z = max8(m.z, v[e].z);
        m.w = max8(m.w, v[e].w);
      }
      const size_t at = (static_cast<size_t>(pr) * g.Wp + pc) * g.C + cg * 8;
      *reinterpret_cast<uint4*>(frame_out + at) = m;
    }
    // The next step's frame into the slot of frame t - 2.
    if (more) convert(stage_o, ring_o + (k % kFrames) * g.slot);
    __syncthreads();  // the tile is free; the slot is written; the staging band is free
  }
}

// The plan is made in Python; refuse one that does not describe this problem
// or does not fit a block.
bool plan_ok(const Plan& p) {
  if (p.B < 1 || p.T < 1 || p.H < 1 || p.W < 1 || p.C < kChunk || p.C % kChunk != 0) return false;
  if (p.H >= 32768 || p.W >= 32768) return false;
  const Geo g = geometry(p);
  if (p.P < 1 || p.P > g.Hp || p.TC < 1 || p.TC > p.T) return false;
  const long long blocks = static_cast<long long>(p.B) * g.chunks * g.bands * g.cchunks;
  if (blocks > 2147483647LL) return false;
  const long long smem = smem_bytes(g);
  return smem == p.smem && smem <= kMaxSmem;
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns the CUDA error (0 on success).
// The library links its own CUDA runtime, so it selects the device itself.
// `plan`: the ints of vcagan_torch/kernels/fused_stem.py::StemPlan.ints().
// Pointers 16-byte aligned.
int vcagan_fused_stem(const float* video, const void* wpk, const float* bias, const float* slope,
                      void* out, const int* plan, int plan_len, int device, void* stream) {
  if (plan_len != kPlanInts) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.B = plan[0]; p.T = plan[1]; p.H = plan[2]; p.W = plan[3]; p.C = plan[4];
  p.P = plan[5]; p.TC = plan[6]; p.smem = plan[7];
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geo g = geometry(p);
  const long long blocks = static_cast<long long>(p.B) * g.chunks * g.bands * g.cchunks;
  fused_stem_kernel<<<static_cast<unsigned>(blocks), kThreads, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      video, static_cast<const unsigned char*>(wpk), bias, slope,
      static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
