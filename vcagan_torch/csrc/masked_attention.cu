// Length-masked cross-attention, forward, fp32:
//   out[b] = softmax(q[b] k[b]^T / sqrt(D), keys >= lengths[b] -> -1e30) v[b]
// q (B,T,D), k/v (B,S,D), lengths (B,) int32, out (B,T,D); all contiguous.
//
// Replaces the TPU kernel vcagan/kernels/masked_attention.py:50-121
// (_attention_kernel / _attention_pallas), which holds one sample's whole
// (T,S) score matrix in VMEM.  Edge semantics are the JAX ones: the mask
// value is -1e30, not -inf, so a row with lengths[b] <= 0 averages all S
// values of v instead of giving NaN; lengths[b] >= S masks nothing.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores) at the serving path's shapes, B=48, D=256, each input read once
// and the output written once:
//   att1  T=75,  S=75: q,k,v,out 3.69 MB each = 14.7 MB -> 4.4 us;
//                       4*B*T*S*D = 0.28 GFLOP        -> 4.1 us  (bytes)
//   att2  T=150, S=75: q,out 7.37 MB, k,v 3.69 MB = 22.1 MB -> 6.6 us;
//                       0.55 GFLOP                    -> 8.3 us  (operations)
// The two products are small, so the score strip never leaves the SM.
//
// Design (first, simple version): one block per (sample b, tile of kRows
// query rows).  The block reads lengths[b] itself (the TPU kernel had it
// scalar-prefetched).  Blocks run in parallel in no order, so nothing is
// carried between them; every block streams its sample's K through shared
// memory in tiles of kKeys keys to fill a (kRows x S) fp32 score strip in
// shared memory, runs the masked row softmax there (one warp per row), and
// then reads V straight from global memory, one coalesced row per key, for
// the P.V product kept in registers.  K and V are never held whole: at
// S=160, D=256 they would take 320 KB, more than the 227 KB a block may use.
// All arithmetic is fp32 FMA; moving both products to wgmma is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;     // query rows per block
constexpr int kKeys = 32;     // keys per K tile (one per lane)
constexpr int kThreads = 256; // 8 warps
constexpr int kRowGroups = kThreads / kKeys;          // 8
constexpr int kRowsPerThread = kRows / kRowGroups;    // 2
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

static_assert(kRows % kRowGroups == 0, "rows must split over row groups");

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, int T, int S, int D) {
  extern __shared__ float smem[];
  float* qs = smem;              // kRows x D        query tile
  float* ps = qs + kRows * D;    // kRows x S        scores, then probabilities
  float* ks = ps + kRows * S;    // kKeys x (D + 1)  key tile, padded rows

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int rows = min(kRows, T - t0);
  const int tid = threadIdx.x;
  const int length = lengths[b];
  const float sqrt_d = sqrtf(static_cast<float>(D));

  const float* qb = q + (static_cast<size_t>(b) * T + t0) * D;
  const float* kb = k + static_cast<size_t>(b) * S * D;
  const float* vb = v + static_cast<size_t>(b) * S * D;

  for (int i = tid; i < kRows * D; i += kThreads) {
    qs[i] = (i / D) < rows ? qb[i] : 0.f;
  }

  // ---- scores: lane = key within the tile, warp = row group.  A warp's
  // threads share a row (q reads broadcast) and read 32 different key rows
  // whose D+1 stride puts them in 32 different banks.
  const int kd = D + 1;
  const int key = tid % kKeys;
  const int row0 = tid / kKeys;
  for (int s0 = 0; s0 < S; s0 += kKeys) {
    const int nk = min(kKeys, S - s0);
    __syncthreads();  // q tile written / previous key tile consumed
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      ks[j * kd + d] = j < nk ? kb[static_cast<size_t>(s0 + j) * D + d] : 0.f;
    }
    __syncthreads();
    if (key < nk) {
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
      const float* kj = ks + key * kd;
      for (int d = 0; d < D; ++d) {
        const float kv = kj[d];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          acc[r] = fmaf(qs[(row0 + r * kRowGroups) * D + d], kv, acc[r]);
        }
      }
      const int j = s0 + key;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        ps[(row0 + r * kRowGroups) * S + j] = j < length ? acc[r] / sqrt_d : kMasked;
      }
    }
  }
  __syncthreads();

  // ---- masked row softmax in shared memory, one warp per row.
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* pr = ps + r * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) pr[j] = pr[j] / sum;
  }
  __syncthreads();

  // ---- P.V: each thread owns one column d of the output tile and keeps
  // its kRows sums in registers; V rows are read coalesced from global.
  float* ob = out + (static_cast<size_t>(b) * T + t0) * D;
  for (int d = tid; d < D; d += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < S; ++j) {
      const float vj = vb[static_cast<size_t>(j) * D + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(ps[r * S + j], vj, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) ob[static_cast<size_t>(r) * D + d] = acc[r];
    }
  }
}

// Shared memory one block needs, in bytes.
size_t smem_bytes(int S, int D) {
  return sizeof(float) * (static_cast<size_t>(kRows) * D +
                          static_cast<size_t>(kRows) * S +
                          static_cast<size_t>(kKeys) * (D + 1));
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns cudaGetLastError() (0 on
// success).  The library links its own CUDA runtime, so it selects the
// device itself.
int vcagan_masked_attention(const float* q, const float* k, const float* v,
                            const int* lengths, float* out, int B, int T, int S,
                            int D, int device, void* stream) {
  const size_t smem = smem_bytes(S, D);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, B);
  masked_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, lengths, out, T, S, D);
  return static_cast<int>(cudaGetLastError());
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
