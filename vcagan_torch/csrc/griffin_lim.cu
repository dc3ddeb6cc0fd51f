// Griffin-Lim on the fp32 serving path, 60 rounds of (ISTFT, STFT, phase
// projection), each round four launches on one stream:
//   c2r         cuFFT, the spectrum (B*T, bins) -> raw frames (B*T, n_fft)
//   gl_reframe  raw frames -> the next STFT's windowed frames (B*T, n_fft)
//   r2c         cuFFT, windowed frames -> spectrum
//   gl_project  spectrum <- mag * z * rsqrt(|z|^2 + 1e-16), in place
// and around them one gl_project that makes the first spectrum from the
// initial phase and, after the last round, one c2r and one gl_overlap_add
// that writes the trimmed, corrected waveform (B, hop * (T - 1)).
//
// The arithmetic is griffin_lim's (vcagan_torch/dsp/griffin_lim.py, the FFT
// form, with dsp/stft.py's istft_complex and stft) in fp32, rounded at the
// same points: the c2r's 1/n_fft scale and the window are two products as
// torch.fft.irfft and the window product make them; the overlap-add sums a
// sample's frames in the order of overlap_add's shifted adds; every sum and
// product is written with __fadd_rn / __fmul_rn, so that no multiply-add is
// contracted where the torch chain rounds twice.  n_fft = 4 hop = win.
//
// Replaces no TPU kernel: the JAX package's Griffin-Lim is XLA's FFTs and
// fusions (vcagan/dsp/griffin_lim.py:36-79).  It was added because on an H100
// the torch chain of a round is about twenty launches, most of them a pass
// over a (48, 300, 640) fp32 frame tensor or the (48, 300, 321) spectrum: 34.7
// ms of a 73.6 ms B=48 x 300-frame serving batch.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores):
// the transforms' 2.5 n log2 n flops, 121 a call at (48, 300), 0.388 ms with
// the spectrum read and the waveform written once (benchmark/harness/work.py
// griffin_lim_fft_least_s).  A round as four launches moves about 315 MB:
// the two transforms 74 MB each, gl_reframe 37 MB in and out, gl_project
// 37 + 18.5 MB in and 37 MB out; 94 us a round at the full rate.
//
// Design (hop a multiple of 4, so that every load and store but those of the
// reflected ends moves 16 bytes):
// - cuFFT is called here on buffers the wrapper owns, so the c2r may overwrite
//   its input (torch.fft.irfft copies the spectrum before every c2r for that
//   reason, then scales the frames in a pass of its own); the 1/n_fft scale
//   moves into gl_reframe.  Both plans share one workspace that the wrapper
//   allocates through PyTorch.
// - gl_reframe: a block owns `tile` output frames of one clip.  It computes the
//   (tile + 3) hop samples of the re-padded signal those frames read into
//   shared memory, each sample from the four raw frames that overlap there
//   (reflected at both ends of the clip's signal), the window and the
//   window-sum-square correction, and writes the frames from there.  Frames
//   that neighbour each other share the samples; the raw frames' reads of
//   neighbouring blocks meet in L2.  No overlap-added, padded or unfolded
//   signal reaches device memory.  Four neighbouring samples lie in one hop
//   block, so a thread computes them from one 16-byte load of each frame.
// - gl_project: two complex values a thread, in place.

#include <cuda_runtime.h>
#include <cufft.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanInts = 7;
constexpr int kMaxSmem = 232448;

struct Plan {
  int B, T, n_fft, hop, rounds, tile, smem;
};

// What the kernels derive from the plan (the formulas of
// vcagan_torch/kernels/griffin_lim.py's GriffinLimPlan).
struct Geo {
  int T, n_fft, hop, bins;
  int L;      // samples of a clip's waveform: hop (T - 1)
  int pad;    // n_fft / 2, the centring pad
  int tile;   // output frames a gl_reframe block
  int tiles;  // blocks a clip
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

Geo geometry(const Plan& p) {
  Geo g;
  g.T = p.T; g.n_fft = p.n_fft; g.hop = p.hop; g.bins = p.n_fft / 2 + 1;
  g.L = p.hop * (p.T - 1);
  g.pad = p.n_fft / 2;
  g.tile = p.tile;
  g.tiles = ceil_div(p.T, p.tile);
  return g;
}

long long smem_bytes(const Plan& p) {
  return 4LL * ((p.tile + 3LL) * p.hop + p.n_fft);
}

bool plan_ok(const Plan& p) {
  return p.B >= 1 && p.T >= 4 && p.hop >= 4 && p.hop % 4 == 0 && p.n_fft == 4 * p.hop &&
         p.rounds >= 0 &&
         p.tile >= 1 && p.tile <= p.T && p.smem == smem_bytes(p) && p.smem <= kMaxSmem &&
         static_cast<long long>(p.B) * ceil_div(p.T, p.tile) <= 0x7fffffffLL;
}

// Sample p (pad <= p < pad + L) of the overlap-added signal times its
// correction: block j = p / hop holds chunk k of frame j - k, k = 0..3, added
// in that order (overlap_add's shifted adds), each raw sample scaled by
// 1/n_fft and windowed.
__device__ __forceinline__ float signal_at(const float* __restrict__ frames,
                                           const float* __restrict__ win,
                                           const float* __restrict__ corr, float inv_n,
                                           const Geo& g, int p) {
  const int j = p / g.hop, r = p - j * g.hop;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = j - k;
    if (f >= 0 && f < g.T) {
      const int m = r + k * g.hop;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__ldg(frames + static_cast<long long>(f) * g.n_fft
                                                     + m), inv_n), win[m]));
    }
  }
  return __fmul_rn(acc, __ldg(corr + p));
}

// signal_at of the four samples p .. p + 3 (p a multiple of 4): they lie in one
// hop block, so each frame's four values are one aligned 16-byte load.
__device__ __forceinline__ float4 signal_at4(const float* __restrict__ frames,
                                             const float* __restrict__ win,
                                             const float* __restrict__ corr, float inv_n,
                                             const Geo& g, int p) {
  const int j = p / g.hop, r = p - j * g.hop;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = j - k;
    if (f >= 0 && f < g.T) {
      const int m = r + k * g.hop;
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          frames + static_cast<long long>(f) * g.n_fft + m));
      const float4 w = *reinterpret_cast<const float4*>(win + m);
      acc.x = __fadd_rn(acc.x, __fmul_rn(__fmul_rn(x.x, inv_n), w.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(__fmul_rn(x.y, inv_n), w.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(__fmul_rn(x.z, inv_n), w.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(__fmul_rn(x.w, inv_n), w.w));
    }
  }
  const float4 c = __ldg(reinterpret_cast<const float4*>(corr + p));
  return make_float4(__fmul_rn(acc.x, c.x), __fmul_rn(acc.y, c.y), __fmul_rn(acc.z, c.z),
                     __fmul_rn(acc.w, c.w));
}

// Position s of the clip's signal (length L) for s in [-pad, L + pad): the
// reflection of torch's reflect pad, no edge sample repeated.
__device__ __forceinline__ int reflect(int s, int L) {
  return s < 0 ? -s : (s >= L ? 2 * (L - 1) - s : s);
}

__global__ void __launch_bounds__(kThreads)
gl_reframe(const float* __restrict__ frames, const float* __restrict__ win,
           const float* __restrict__ corr, float inv_n, float* __restrict__ out, Geo g) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);  // n_fft
  float* sig = w + g.n_fft;                    // (tile + 3) hop
  const int clip = blockIdx.x / g.tiles;
  const int t0 = (blockIdx.x - clip * g.tiles) * g.tile;
  const int nt = min(g.tile, g.T - t0);
  const float* fr = frames + static_cast<long long>(clip) * g.T * g.n_fft;
  for (int n = threadIdx.x; n < g.n_fft; n += kThreads) w[n] = win[n];
  __syncthreads();
  // the re-padded samples t0 hop + i: a quad lies wholly inside the clip's
  // signal or wholly in one reflected end (pad and L are multiples of 4)
  const int quads = (nt + 3) * g.hop / 4;
  const int q0 = t0 * g.hop - g.pad;
  for (int i = threadIdx.x; i < quads; i += kThreads) {
    const int s = q0 + 4 * i;
    float4 v;
    if (s >= 0 && s < g.L) {
      v = signal_at4(fr, w, corr, inv_n, g, s + g.pad);
    } else {
      v.x = signal_at(fr, w, corr, inv_n, g, reflect(s, g.L) + g.pad);
      v.y = signal_at(fr, w, corr, inv_n, g, reflect(s + 1, g.L) + g.pad);
      v.z = signal_at(fr, w, corr, inv_n, g, reflect(s + 2, g.L) + g.pad);
      v.w = signal_at(fr, w, corr, inv_n, g, reflect(s + 3, g.L) + g.pad);
    }
    reinterpret_cast<float4*>(sig)[i] = v;
  }
  __syncthreads();
  const int row = g.n_fft / 4;  // quads a frame
  float4* o = reinterpret_cast<float4*>(out + (static_cast<long long>(clip) * g.T + t0) * g.n_fft);
  for (int i = threadIdx.x; i < nt * row; i += kThreads) {
    const int t = i / row, n = 4 * (i - t * row);
    const float4 x = *reinterpret_cast<const float4*>(sig + t * g.hop + n);
    const float4 a = *reinterpret_cast<const float4*>(w + n);
    o[i] = make_float4(__fmul_rn(x.x, a.x), __fmul_rn(x.y, a.y), __fmul_rn(x.z, a.z),
                       __fmul_rn(x.w, a.w));
  }
}

// One value of gl_project: mag * (cos a, sin a) where `angle` is given, else
// mag * z * rsqrt(zr^2 + zi^2 + 1e-16).
__device__ __forceinline__ float2 project(float2 z, float m, const float* a) {
  float re, im;
  if (a != nullptr) {
    re = cosf(*a);
    im = sinf(*a);
  } else {
    const float inv = rsqrtf(__fadd_rn(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)),
                                       1e-16f));
    re = __fmul_rn(z.x, inv);
    im = __fmul_rn(z.y, inv);
  }
  return make_float2(__fmul_rn(m, re), __fmul_rn(m, im));
}

// spec (n complex values, interleaved) <- project(spec), two values a thread
// (one 16-byte load and store); `angle`, where given, the initial phase.
__global__ void __launch_bounds__(kThreads)
gl_project(float2* __restrict__ spec, const float* __restrict__ mag,
           const float* __restrict__ angle, long long n) {
  const long long i = 2 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (i + 1 < n) {
    const float4 z = reinterpret_cast<const float4*>(spec)[i / 2];
    const float2 m = reinterpret_cast<const float2*>(mag)[i / 2];
    float2 a = angle != nullptr ? reinterpret_cast<const float2*>(angle)[i / 2]
                                : make_float2(0.f, 0.f);
    const float2 lo = project(make_float2(z.x, z.y), m.x, angle != nullptr ? &a.x : nullptr);
    const float2 hi = project(make_float2(z.z, z.w), m.y, angle != nullptr ? &a.y : nullptr);
    reinterpret_cast<float4*>(spec)[i / 2] = make_float4(lo.x, lo.y, hi.x, hi.y);
  } else if (i < n) {
    spec[i] = project(spec[i], mag[i], angle != nullptr ? angle + i : nullptr);
  }
}

// out (B, L) <- the trimmed, corrected signal of the raw frames.
__global__ void __launch_bounds__(kThreads)
gl_overlap_add(const float* __restrict__ frames, const float* __restrict__ win,
               const float* __restrict__ corr, float inv_n, float* __restrict__ out, Geo g,
               long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long clip = i / g.L;
  const int s = static_cast<int>(i - clip * g.L);
  out[i] = signal_at(frames + clip * g.T * g.n_fft, win, corr, inv_n, g, s + g.pad);
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// cuFFT's errors come back negative, CUDA's positive.
int fft_error(cufftResult r) { return r == CUFFT_SUCCESS ? 0 : -static_cast<int>(r); }

}  // namespace

extern "C" {

// Two plans of `batch` real transforms of n_fft points, c2r and r2c, in the
// plain contiguous layout, with no workspace of their own: `handles` gets
// them, `work_bytes` the workspace they share (the larger of the two).
int vcagan_gl_make_plans(int n_fft, long long batch, int device, int* handles,
                         unsigned long long* work_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long n = n_fft;
  size_t work[2] = {0, 0};
  const cufftType types[2] = {CUFFT_C2R, CUFFT_R2C};
  for (int i = 0; i < 2; ++i) {
    cufftHandle h;
    cufftResult r = cufftCreate(&h);
    if (r == CUFFT_SUCCESS) r = cufftSetAutoAllocation(h, 0);
    if (r == CUFFT_SUCCESS)
      r = cufftMakePlanMany64(h, 1, &n, nullptr, 1, 0, nullptr, 1, 0, types[i], batch, &work[i]);
    if (r != CUFFT_SUCCESS) {
      cufftDestroy(h);
      if (i == 1) cufftDestroy(handles[0]);
      return fft_error(r);
    }
    handles[i] = h;
  }
  *work_bytes = work[0] > work[1] ? work[0] : work[1];
  return 0;
}

int vcagan_gl_destroy_plans(const int* handles) {
  cufftResult a = cufftDestroy(handles[0]), b = cufftDestroy(handles[1]);
  return fft_error(a != CUFFT_SUCCESS ? a : b);
}

// One Griffin-Lim call, every launch on `stream` of `device`.  `plan`: the
// ints of GriffinLimPlan.ints().  mag (B, T, bins); angle (B, T, bins) the
// initial phase; spec (B, T, bins) complex, frames and framed (B, T, n_fft),
// out (B, hop (T - 1)), all fp32, 16-byte aligned and owned by the call (spec
// and frames are overwritten); win (n_fft); corr (hop (T + 3)), the window-sum-square
// correction; `handles` from vcagan_gl_make_plans for batch B T, `work` their
// workspace.  Returns 0, a CUDA error (> 0) or a cuFFT error (< 0).
int vcagan_griffin_lim(const float* mag, const float* angle, void* spec, float* frames,
                       float* framed, float* out, const float* win, const float* corr,
                       float inv_n, const int* plan, int plan_len, const int* handles,
                       void* work, int device, void* stream) {
  if (plan_len != kPlanInts) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.B = plan[0]; p.T = plan[1]; p.n_fft = plan[2]; p.hop = plan[3]; p.rounds = plan[4];
  p.tile = plan[5]; p.smem = plan[6];
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gl_reframe, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cufftHandle c2r = handles[0], r2c = handles[1];
  for (cufftHandle h : {c2r, r2c}) {
    cufftResult r = cufftSetStream(h, s);
    if (r == CUFFT_SUCCESS) r = cufftSetWorkArea(h, work);
    if (r != CUFFT_SUCCESS) return fft_error(r);
  }
  const Geo g = geometry(p);
  const long long values = static_cast<long long>(p.B) * p.T * g.bins;
  const long long samples = static_cast<long long>(p.B) * g.L;
  const unsigned reframe_blocks = static_cast<unsigned>(p.B * g.tiles);
  float2* z = static_cast<float2*>(spec);
  cufftComplex* zc = static_cast<cufftComplex*>(spec);

  gl_project<<<blocks_for((values + 1) / 2), kThreads, 0, s>>>(z, mag, angle, values);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int round = 0; round < p.rounds; ++round) {
    cufftResult r = cufftExecC2R(c2r, zc, frames);
    if (r != CUFFT_SUCCESS) return fft_error(r);
    gl_reframe<<<reframe_blocks, kThreads, p.smem, s>>>(frames, win, corr, inv_n, framed, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    r = cufftExecR2C(r2c, framed, zc);
    if (r != CUFFT_SUCCESS) return fft_error(r);
    gl_project<<<blocks_for((values + 1) / 2), kThreads, 0, s>>>(z, mag, nullptr, values);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const cufftResult r = cufftExecC2R(c2r, zc, frames);
  if (r != CUFFT_SUCCESS) return fft_error(r);
  gl_overlap_add<<<blocks_for(samples), kThreads, 0, s>>>(frames, win, corr, inv_n, out, g,
                                                           samples);
  return static_cast<int>(cudaGetLastError());
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
