// Fused folded-BN ResNet BasicBlock (stride 1, identity shortcut), forward:
//   h   = PReLU(conv3x3(x, w1) + b1, a1)        rounded to x's type
//   out = PReLU(conv3x3(h, w2) + b2 + x, a2)    rounded to x's type
// x, out (N,H,W,C) channels innermost, fp32 or bf16; w1, w2 (3,3,C,C) as
// [tap][c_in][c_out], fp32 (rounded to bf16 on the fly when x is bf16);
// b*, a* (C,) fp32.  Both convolutions pad with zeros (SAME) and sum in
// fp32.  C must be a multiple of 16.
//
// Replaces the TPU kernel vcagan/kernels/fused_block.py:78-130
// (_block_kernel / _fused_block_pallas), which holds whole images and two
// zero-padded copies in VMEM and computes each convolution as 9 shifted
// channel contractions.  What it is for is kept: ONE launch computes the
// whole block and h never goes to device memory.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
// cores): flops = 2 convs * 2*9*C*C*H*W*N, bytes = x read + out written +
// both weights.  At N = 3600 each of 28x28x64, 14x14x128, 7x7x256 is
// 0.416 TFLOP -> 6.2 ms and 4x4x512 is 0.544 TFLOP -> 8.1 ms, while the
// bytes give at most 0.43 ms: the block is bound by operations.
//
// Design (fp32 FMA from shared memory):
// - One thread block computes one tile: G whole images, or R output rows
//   of one image.  The tile's h, with a ring of one pixel and ALL C
//   channels, lives in shared memory as hs[c][image][row][col]; nothing else
//   of activation size is kept.  A row tile needs h on R+2 rows, so the two
//   ring rows are recomputed by the neighbouring tiles (x is read on R+4
//   rows).
// - The ring of h outside the image is zero, as conv2's SAME padding
//   wants, not conv1 evaluated there: hs is zeroed first and phase 1 only
//   writes pixels inside the image.
// - Each phase is an implicit GEMM, pixels x c_out over 9 taps x c_in.
//   A thread owns a strip of TM pixels of one row x 8 output channels in
//   registers.  Per input channel and kernel row it reads the strip's TM+2
//   inputs once and uses them for all three horizontal taps, so the loop
//   is 3*8*TM FMAs to TM+2 scalar and 6 vector loads.  TM = 7 divides the
//   trunk's widths 28, 14 and 7 (and 7 floats between lanes spread over
//   all banks); TM = 4 serves maps up to 4 wide.  The block owns 256/CG
//   strips x NC = 8*CG output channels per pass and loops over passes and
//   over chunks of NC output channels.
// - The weights do not fit (2.4 MB a conv at C=256): per step a slice
//   [9 taps][KC c_in][NC c_out] is streamed through shared memory (from L2
//   after the first blocks).  In phase 1 the x patch of the same KC input
//   channels (with its zero border) is staged beside it; in phase 2 the
//   operand is hs itself.  A step's slices are loaded into registers
//   before the previous step's FMAs and stored to shared memory after
//   them, so the loads' latency hides behind the arithmetic at no cost in
//   shared memory.  The residual re-reads x from global memory.
// - The launcher searches R, G and NC for the fewest strip slots per output
//   pixel that fit the 227 KB of a block (make_plan).
// - N need not be a multiple of G: images past N load zeros and store
//   nothing.  The grid is one-dimensional (N/G * row tiles blocks).
// Later work: wgmma (TF32/bf16) for the products, TMA for the slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 8;                // output channels per thread
constexpr int kSlack = 8;             // a ragged strip reads past its row
constexpr size_t kMaxSmem = 232448;   // 227 KB a block may use

struct Geom {
  int N, H, W, C;
  int R, G;        // output rows per tile; images per block
  int tiles;       // row tiles per image
  int spr;         // strips per row
  int xs_stride;   // floats per channel of the staged x patch
  int hs_stride;   // elements per channel of hs
  int tab_len;     // entries of the patch offset table (padded to 4)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A value after the round trip through the storage type.
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

// Input channels per step for a pass of nc output channels: the step's
// weight slice waits in 9 * KC * nc / 256 registers a thread.
constexpr int step_channels(int nc) { return nc > 64 ? 4 : 8; }

// Pass widths in order of preference among plans of equal cost (measured on
// an H100 at the trunk's shapes: 128 beats 64, which stages x twice as
// often, and 256, where a warp spans four channel groups).
constexpr int kPassWidths[] = {128, 64, 256, 16};

template <int CG> struct Tile {
  static constexpr int NC = CG * kTN;              // output channels per pass
  static constexpr int PG = kThreads / CG;         // strips per pass
  static constexpr int KC = step_channels(NC);     // input channels per step
};

// A step's operands travel global memory -> registers -> shared memory:
// the loads of step s+1 are started before the FMAs of step s and land while
// they run; after the FMAs (and a barrier) the registers are stored.

// Weight slice [9][KC][NC] of w[tap][ci0 + kc][co0 + n].
template <typename T, int CG> struct WeightStage {
  static constexpr int NC = Tile<CG>::NC, KC = Tile<CG>::KC, Q = NC / 4;
  static constexpr int kTotal = 9 * KC * Q;
  static constexpr int kLoads = (kTotal + kThreads - 1) / kThreads;
  float4 v[kLoads];

  __device__ __forceinline__ void fetch(const float* __restrict__ w, int C, int ci0, int co0,
                                        int tid) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < kTotal) {
        const int row = idx / Q;  // tap * KC + kc
        const int tap = row / KC;
        v[k] = load4(w + (static_cast<size_t>(tap) * C + ci0 + row - tap * KC) * C + co0 +
                     4 * (idx - row * Q));
      }
    }
  }

  __device__ __forceinline__ void store(float* Ws, int tid) const {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < kTotal) {
        float4 r = v[k];
        r.x = rounded<T>(r.x);
        r.y = rounded<T>(r.y);
        r.z = rounded<T>(r.z);
        r.w = rounded<T>(r.w);
        store4(Ws + 4 * idx, r);  // [row][4 * q] with row * NC + 4 * q = 4 * idx
      }
    }
  }
};

// The x patch of KC input channels, all positions of `tab`, transposed to
// channel-major Xs[kc][pos].  At most kPatchLoads float4 a thread
// (make_plan sees to it).
constexpr int kPatchLoads = 5;

template <typename T, int KC> struct PatchStage {
  float4 v[kPatchLoads];

  __device__ __forceinline__ void fetch(const T* __restrict__ x, const int* tab, int npos,
                                        int C, int ci0, int tid) {
#pragma unroll
    for (int k = 0; k < kPatchLoads; ++k) {
      const int idx = tid + k * kThreads;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < npos * (KC / 4)) {
        const int pos = idx / (KC / 4);
        const int off = tab[pos];
        if (off >= 0) {
          v[k] = load4(x + static_cast<size_t>(off) * C + ci0 + 4 * (idx - pos * (KC / 4)));
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* Xs, int xs_stride, int npos, int tid) const {
#pragma unroll
    for (int k = 0; k < kPatchLoads; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < npos * (KC / 4)) {
        const int pos = idx / (KC / 4);
        float* dst = Xs + 4 * (idx - pos * (KC / 4)) * xs_stride + pos;
        dst[0] = v[k].x;
        dst[xs_stride] = v[k].y;
        dst[2 * xs_stride] = v[k].z;
        dst[3 * xs_stride] = v[k].w;
      }
    }
  }
};

// A strip of a pass: image gi of the block, row r of the phase's rows,
// first column c0; dead past the phase's last strip.
struct Strip {
  int gi, r, c0;
  bool live;
};

__device__ __forceinline__ Strip strip_of(int sid, int rows, int spr, int nstrips, int tm) {
  Strip s;
  s.live = sid < nstrips;
  s.gi = sid / (rows * spr);
  const int rem = sid - s.gi * rows * spr;
  s.r = rem / spr;
  s.c0 = (rem - s.r * spr) * tm;
  return s;
}

// acc[i][j] += sum over 9 taps and KC channels of a[kc][base + dy*Wp + i + dx]
// * Ws[dy][dx][kc][8*cg + j].  `a` is channel-major with `a_stride` elements
// a channel and rows of Wp elements.
template <typename A, int CG, int TM>
__device__ __forceinline__ void fma_taps(const A* a, int a_stride, int base, const float* Ws,
                                         int Wp, int cg, float (&acc)[TM][kTN]) {
  constexpr int NC = Tile<CG>::NC, KC = Tile<CG>::KC;
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
    const A* arow = a + base + dy * Wp;
    const float* wrow = Ws + dy * 3 * KC * NC + cg * kTN;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      float av[TM + 2];
#pragma unroll
      for (int i = 0; i < TM + 2; ++i) av[i] = to_float(arow[kc * a_stride + i]);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 b0 = load4(wrow + (dx * KC + kc) * NC);
        const float4 b1 = load4(wrow + (dx * KC + kc) * NC + 4);
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i + dx], bv[j], acc[i][j]);
        }
      }
    }
  }
}

template <typename T, int CG, int TM>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ a1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ a2, T* __restrict__ out, const Geom g) {
  constexpr int NC = Tile<CG>::NC, PG = Tile<CG>::PG, KC = Tile<CG>::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ws = reinterpret_cast<float*>(smem_raw);   // [9][KC][NC]
  float* Xs = Ws + 9 * KC * NC;                      // [KC][xs_stride]
  int* tab = reinterpret_cast<int*>(Xs + KC * g.xs_stride);
  T* hs = reinterpret_cast<T*>(tab + g.tab_len);     // [C][hs_stride]

  const int tid = threadIdx.x;
  const int pg = tid % PG;  // lanes of a warp: neighbouring strips,
  const int cg = tid / PG;  // few channel groups (weights broadcast)
  const int tile = blockIdx.x % g.tiles;
  const int n0 = (blockIdx.x / g.tiles) * g.G;
  const int r0 = tile * g.R;
  const int H = g.H, W = g.W, C = g.C;
  const int Wp = W + 2;
  const int xrows = g.R + 4;  // patch rows: image rows r0-2 .. r0+R+1
  const int hrows = g.R + 2;  // h rows:     image rows r0-1 .. r0+R
  const int rows_out = min(g.R, H - r0);
  const int hr_lo = r0 == 0 ? 1 : 0;          // h rows inside the image
  const int hr_hi = min(hrows, H - r0 + 1);
  const int rows_h = hr_hi - hr_lo;
  const int npos = g.G * xrows * Wp;

  // Offset (in pixels) of every patch position in x, or -1 for the zero
  // border and for images past N.
  for (int pos = tid; pos < npos; pos += kThreads) {
    const int gi = pos / (xrows * Wp);
    const int rem = pos - gi * xrows * Wp;
    const int xr = rem / Wp;
    const int ir = r0 - 2 + xr;
    const int ic = rem - xr * Wp - 1;
    const int n = n0 + gi;
    const bool inside = n < g.N && ir >= 0 && ir < H && ic >= 0 && ic < W;
    tab[pos] = inside ? (n * H + ir) * W + ic : -1;
  }
  for (int i = tid; i < C * g.hs_stride; i += kThreads) hs[i] = from_float<T>(0.f);
  // (the barriers at the head of phase 1 order both before their use)

  // ---- phase 1: h on the tile and its ring rows, into hs.
  const int n1 = g.G * rows_h * g.spr;
  for (int co0 = 0; co0 < C; co0 += NC) {
    for (int pass0 = 0; pass0 < n1; pass0 += PG) {
      const Strip st = strip_of(pass0 + pg, rows_h, g.spr, n1, TM);
      const int base = st.live ? st.gi * xrows * Wp + (hr_lo + st.r) * Wp + st.c0 : 0;
      float acc[TM][kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      }
      WeightStage<T, CG> wst;
      PatchStage<T, KC> xst;
      __syncthreads();  // tab is written (first pass)
      wst.fetch(w1, C, 0, co0, tid);
      xst.fetch(x, tab, npos, C, 0, tid);
      for (int ci0 = 0; ci0 < C; ci0 += KC) {
        __syncthreads();  // previous step's reads of Ws and Xs are done
        wst.store(Ws, tid);
        xst.store(Xs, g.xs_stride, npos, tid);
        __syncthreads();
        if (ci0 + KC < C) {
          wst.fetch(w1, C, ci0 + KC, co0, tid);
          xst.fetch(x, tab, npos, C, ci0 + KC, tid);
        }
        fma_taps<float, CG, TM>(Xs, g.xs_stride, base, Ws, Wp, cg, acc);
      }
      if (st.live) {
        const int hpos = st.gi * hrows * Wp + (hr_lo + st.r) * Wp + st.c0 + 1;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int co = co0 + cg * kTN + j;
          const float bias = b1[co], slope = a1[co];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (st.c0 + i < W) {
              hs[co * g.hs_stride + hpos + i] = from_float<T>(prelu(acc[i][j] + bias, slope));
            }
          }
        }
      }
    }
  }

  // ---- phase 2: out on the tile, from hs.
  const int n2 = g.G * rows_out * g.spr;
  for (int co0 = 0; co0 < C; co0 += NC) {
    for (int pass0 = 0; pass0 < n2; pass0 += PG) {
      const Strip st = strip_of(pass0 + pg, rows_out, g.spr, n2, TM);
      const int base = st.live ? st.gi * hrows * Wp + st.r * Wp + st.c0 : 0;
      float acc[TM][kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      }
      WeightStage<T, CG> wst;
      wst.fetch(w2, C, 0, co0, tid);
      for (int ci0 = 0; ci0 < C; ci0 += KC) {
        __syncthreads();  // hs written (first step) / Ws reads done
        wst.store(Ws, tid);
        __syncthreads();
        if (ci0 + KC < C) wst.fetch(w2, C, ci0 + KC, co0, tid);
        fma_taps<T, CG, TM>(hs + static_cast<size_t>(ci0) * g.hs_stride, g.hs_stride, base,
                            Ws, Wp, cg, acc);
      }
      const int n = n0 + st.gi;
      if (st.live && n < g.N) {
        const size_t pix0 = (static_cast<size_t>(n) * H + r0 + st.r) * W + st.c0;
        const int co = co0 + cg * kTN;
        const float4 bb0 = load4(b2 + co), bb1 = load4(b2 + co + 4);
        const float4 aa0 = load4(a2 + co), aa1 = load4(a2 + co + 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (st.c0 + i >= W) continue;
          const size_t at = (pix0 + i) * C + co;
          const float4 r0v = load4(x + at), r1v = load4(x + at + 4);
          float4 y0, y1;
          y0.x = prelu(acc[i][0] + bb0.x + r0v.x, aa0.x);
          y0.y = prelu(acc[i][1] + bb0.y + r0v.y, aa0.y);
          y0.z = prelu(acc[i][2] + bb0.z + r0v.z, aa0.z);
          y0.w = prelu(acc[i][3] + bb0.w + r0v.w, aa0.w);
          y1.x = prelu(acc[i][4] + bb1.x + r1v.x, aa1.x);
          y1.y = prelu(acc[i][5] + bb1.y + r1v.y, aa1.y);
          y1.z = prelu(acc[i][6] + bb1.z + r1v.z, aa1.z);
          y1.w = prelu(acc[i][7] + bb1.w + r1v.w, aa1.w);
          store4(out + at, y0);
          store4(out + at + 4, y1);
        }
      }
    }
  }
}

struct Plan {
  Geom g;
  int CG, TM;
  size_t smem;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Tile and thread layout for one problem; false if no tile fits.  Every
// (R rows of one image | G whole images) x NC is tried; the plan with the
// fewest strip slots per output pixel wins: tiles * passes * PG slots serve
// G * H * W pixels.  Ties go by kPassWidths, then to the smaller tile.
bool make_plan(int N, int H, int W, int C, size_t esize, Plan* best) {
  const int TM = W <= 4 ? 4 : 7;
  const int spr = ceil_div(W, TM);
  bool found = false;
  long long best_slots = 0, best_pixels = 1;
  for (int NC : kPassWidths) {
    if (C % NC != 0) continue;
    const int CG = NC / kTN, PG = kThreads / CG, KC = step_channels(NC);
    for (int R = 1; R <= H; ++R) {
      const int g_max = R == H ? (N < 64 ? N : 64) : 1;
      for (int G = 1; G <= g_max; ++G) {
        if (G > 1 && G * H * W > 1024) break;
        Geom g;
        g.N = N; g.H = H; g.W = W; g.C = C; g.R = R; g.G = G;
        g.tiles = ceil_div(H, R);
        g.spr = spr;
        const int npos = G * (R + 4) * (W + 2);
        const int xs = npos + kSlack;
        g.xs_stride = xs + ((4 - xs % 8) + 8) % 8;  // = 4 mod 8: spreads the banks
        g.hs_stride = G * (R + 2) * (W + 2) + kSlack;
        g.tab_len = (npos + 3) / 4 * 4;
        const size_t smem =
            sizeof(float) * (9 * KC * NC + static_cast<size_t>(KC) * g.xs_stride) +
            sizeof(int) * g.tab_len + static_cast<size_t>(C) * g.hs_stride * esize;
        if (smem > kMaxSmem || npos * (KC / 4) > kPatchLoads * kThreads) {
          break;  // a larger G only needs more
        }
        const int rows_h = R + 2 < H ? R + 2 : H;
        const int passes = ceil_div(G * rows_h * spr, PG) + ceil_div(G * R * spr, PG);
        const long long slots = static_cast<long long>(g.tiles) * passes * PG;
        const long long pixels = static_cast<long long>(G) * H * W;
        if (!found || slots * best_pixels < best_slots * pixels) {
          found = true;
          best_slots = slots;
          best_pixels = pixels;
          best->g = g;
          best->CG = CG;
          best->TM = TM;
          best->smem = smem;
        }
      }
    }
  }
  return found;
}

template <typename T, int CG, int TM>
cudaError_t launch(const Plan& p, const void* x, const float* w1, const float* b1,
                   const float* a1, const float* w2, const float* b2, const float* a2,
                   void* out, cudaStream_t stream) {
  auto kernel = fused_block_kernel<T, CG, TM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((p.g.N + p.g.G - 1) / p.g.G) * p.g.tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), w1, b1, a1, w2, b2, a2, static_cast<T*>(out), p.g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Plan& p, const void* x, const float* w1, const float* b1,
                     const float* a1, const float* w2, const float* b2, const float* a2,
                     void* out, cudaStream_t s) {
#define FB_CASE(cg)                                                              \
  case cg:                                                                       \
    return p.TM == 4 ? launch<T, cg, 4>(p, x, w1, b1, a1, w2, b2, a2, out, s)   \
                     : launch<T, cg, 7>(p, x, w1, b1, a1, w2, b2, a2, out, s)
  switch (p.CG) {
    FB_CASE(2);
    FB_CASE(8);
    FB_CASE(16);
    FB_CASE(32);
  }
#undef FB_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns the CUDA error (0 on success).
// The library links its own CUDA runtime, so it selects the device itself.
// N*H*W must be below 2^31, C a multiple of 16, pointers 16-byte aligned.
int vcagan_fused_block(const void* x, const float* w1, const float* b1, const float* a1,
                       const float* w2, const float* b2, const float* a2, void* out, int N,
                       int H, int W, int C, int is_bf16, int device, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 16 || C % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  if (!make_plan(N, H, W, C, is_bf16 ? 2 : 4, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<__nv_bfloat16>(plan, x, w1, b1, a1, w2, b2, a2, out, s)
                : dispatch<float>(plan, x, w1, b1, a1, w2, b2, a2, out, s);
  return static_cast<int>(err);
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
