// Fused folded-BN ResNet BasicBlock (stride 1, identity shortcut), forward:
//   h   = PReLU(conv3x3(x, w1) + b1, a1)        rounded to x's type
//   out = PReLU(conv3x3(h, w2) + b2 + x, a2)    rounded to x's type
// x, out (N,H,W,C) channels innermost, fp32 or bf16; w1, w2 packed by
// vcagan_torch/kernels/fused_block.py::pack_weights from (3,3,C,C); b*, a*
// (C,) fp32.  Both convolutions pad with zeros (SAME) and sum in fp32.  C
// must be a multiple of 64.  Any N: where N*H*W*C passes 2^31 - 1 (the
// kernel's element offsets are 32-bit), the entry point launches chunks of
// images that stay below it, one after another.
//
// Replaces the TPU kernel vcagan/kernels/fused_block.py:78-130
// (_block_kernel / _fused_block_pallas), which holds whole images and two
// zero-padded copies in VMEM and computes each convolution as 9 shifted
// channel contractions on the matrix unit.  What it is for is kept: ONE
// launch computes the whole block and h never goes to device memory.
//
// Bound on an H100 SXM (3.35 TB/s; tensor cores 989 TFLOP/s bf16, 495
// TFLOP/s TF32): flops = 2 convs * 2*9*C*C*H*W*N, bytes = x read + out
// written + both weights.  At N = 3600 each of 28x28x64, 14x14x128, 7x7x256
// is 0.416 TFLOP and 4x4x512 is 0.544 TFLOP against at most 1.4 GB, so the
// block is bound by operations in both forms:
//   bf16 in and out: one product a multiply at 989 TFLOP/s, 0.42 ms a launch
//     (0.55 ms at 4x4x512);
//   fp32 in and out: three TF32 products a multiply (3xTF32, below), 165
//     TFLOP/s effective, 2.52 ms a launch (3.30 ms at 4x4x512).
//
// Design (both convolutions as implicit GEMMs on the tensor cores, pixels x
// c_out over k = 9 taps x c_in, fp32 accumulators in registers):
// - The instruction is wgmma.mma_async (m64nNk16 bf16, m64n64k8 TF32) with A
//   from REGISTERS and B from shared memory.  A warpgroup's A tile is 64
//   pixels; each of its 4 warps brings its 16 rows as a register fragment
//   (ldmatrix for bf16, plain loads for fp32) whose rows each have an address
//   of their own, so a row is a pixel and a tap is a shift of that address.
//   x and h are kept as [pixel][channel] rows of the image itself, WITHOUT a
//   padded ring: a tap that leaves the image points its row at one shared
//   row of zeros.  That is SAME padding, it makes the "ring of h is zero"
//   rule hold by construction (nothing is ever stored outside the image),
//   and no tensor-core row is spent on ring positions (50% of a padded 4x4
//   grid).  A through a shared-memory descriptor would need the padded grid.
// - One block (2 warpgroups) computes one tile: G whole images, or R output
//   rows of one image (then h is computed on R+2 rows, the two border rows
//   again by the neighbouring tiles).  Shared memory holds h for ALL
//   channels (a pixel's row is padded by 16 bytes so that the rows of a
//   fragment fall on different banks); everything else streams.
// - The weights do not fit (up to 9.4 MB a convolution): they are streamed
//   from L2 through a ring of 2-5 stages, each one tap of `ks` k-steps x BN
//   output channels, one __syncthreads a stage; the loads of the next stages
//   run under the products of this one, across passes and across the two
//   convolutions.  They were packed at load as the instruction's core
//   matrices (8 channels x 16 bytes, no swizzle), so a k-step of a stage is
//   one contiguous piece: one thread asks the TMA unit for it with a bulk
//   copy (cp.async.bulk, no tensor map) that is counted on the buffer's
//   mbarrier, after the stage's first products are under way; the k-steps
//   of a stage go round the warps, because asking holds the asking warp
//   (and with it its warpgroup) up for some hundred cycles.  The copies
//   arrive through the asynchronous proxy, through which the tensor cores
//   read B, so no proxy fence is needed; B needs no registers.  (cp.async by
//   all threads cost every warp some 700 cycles of address arithmetic and
//   copy instructions a stage, with the tensor cores idle.)
// - x streams too (cp.async, every pixel has its own source), in slices of
//   `ks` k-steps of channels for all pixels of the tile (two buffers; a
//   slice comes with the first of its 9 taps), so
//   that only h limits the pixels a block holds, and the weights a launch
//   reads from L2 fall as the pixels a block holds rise (4x4x512 fp32: 4
//   images a block where the resident x patch left 2).
//   The residual re-reads x from device memory (L2).
// - 8 warps = warps_m (8 or 4) along the pixels x 8/warps_m along the
//   channels; a warpgroup accumulates up to 256/WN (bf16; WN = 64, 128, 256)
//   or 2 (fp32, WN = 64) tiles of 64 pixels x WN channels, the 16-pixel
//   tiles dealt round robin over the warps so that a ragged count spreads;
//   rows past the end read the zero row and store nothing.  Images past N
//   load zeros and store nothing.
// - All SMs stream the same weights; in step they would all ask the same
//   few L2 slices at once.  Each block starts its walk over the channel
//   slices of a (pass, chunk) at a different slice (a sum does not care).
// - fp32 form, 3xTF32: every operand a = a_hi + a_lo, a_hi = a rounded to
//   TF32, a_lo = a - a_hi rounded to TF32; the product is a_lo*b_hi +
//   a_hi*b_lo first, then a_hi*b_hi, summed in fp32.  That keeps about
//   2^-21 relative a product, so the fp32 form holds the fp32 tolerances.
//   The products of a stage (at most 8 k-steps) go into a fresh sum, which
//   an ordinary fp32 add puts on the accumulator: the tensor cores add with
//   truncation, and a sum left in them over k = 9*C drifts by 1e-4 at
//   C = 512, while adding after every k-step leaves them idle.  The
//   weights' parts are packed at load; x and h are kept in fp32 in shared
//   memory and split where they are read (5 integer and float instructions
//   a value, each value then used for 64 channels x 3 products).
// - The plan (R, G, warps_m, WN, ks, stages, shared-memory bytes) is made in
//   Python (plan_fused_block) and checked here.
// Later work: a warp's own instructions between its products (the split of
// A in fp32, tap offsets, drain, adds, epilogues) still take longer than the
// products, and with two warps a scheduler nothing hides them: wider N for
// fp32, warpgroups half a k-step apart, a cluster sharing one multicast
// weight load, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kMaxSmem = 232448;     // 227 KB a block may use
constexpr int kMaxStages = 5;
constexpr int kPlanInts = 14;

struct Plan {
  int N, H, W, C;
  int R, G, tiles;   // output rows a tile; images a block; row tiles an image
  int XR, HR;        // rows of the x patch and of h kept for an image
  int warps_m, WN;   // warps along the pixels; channels a warp
  int KS, stages;    // k-steps a stage; stages of the ring
  int smem;
};

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int kStep = 8;    // input channels an instruction
  static constexpr int kPad = 4;     // elements added to a pixel's row
  static constexpr int kWBytes = 8;  // packed bytes a weight (hi and lo)
  static constexpr int kRows = 2;    // fragment rows a lane addresses a tile
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int kStep = 16;
  static constexpr int kPad = 8;
  static constexpr int kWBytes = 2;
  static constexpr int kRows = 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int size = valid ? 16 : 0;  // 0: writes 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(size)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `n` of this thread's copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// ---- bulk copies (the TMA unit, no tensor map): one thread asks for `bytes`
// contiguous bytes; they arrive through the asynchronous proxy, the one the
// tensor cores read shared memory through, and are counted on an mbarrier.
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
// Wait until the barrier's phase of parity `parity` is complete.
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// Plain loads from shared memory (the compiler may schedule them freely).
__device__ __forceinline__ float lds_f32(const unsigned char* base, uint32_t off) {
  return *reinterpret_cast<const float*>(base + off);
}
// ---- wgmma: D (64 pixels x N channels, fp32, in the registers of a
// warpgroup's 4 warps, 16 rows each: a thread holds rows g8 and g8 + 8,
// columns 2 * t4 and 2 * t4 + 1 of every 8 channels) += A (64 x 16 bf16 or
// 64 x 8 TF32, from registers: each warp's 16 rows as ldmatrix.x4 delivers
// them, so a row still has an address of its own) * B (16 or 8 x N, read by
// the tensor cores straight from shared memory through a descriptor).
// B stands in shared memory as pack_weights lays it out: core matrices of 8
// output channels x 8 input channels (16 bytes a row, 128 bytes each), the
// two halves of a k-step 128 bytes apart (the leading offset), the groups of
// 8 channels 256 bytes apart (the stride offset), no swizzle.
// (fp32: 4 input channels a 16-byte row, and a group's hi and lo parts side
// by side, so the groups are 512 bytes apart and the lo parts start at 256.)
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr, int group_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(group_bytes >> 4) << 32);
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
// The instruction's last operands: scale-d (the predicate: add to D),
// scale-a 1, scale-b 1, B not transposed (input channels run along a core
// matrix's rows).
template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
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
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// TF32: D (64 x 64) = or += A (64 x 8; a thread holds (g8, t4), (g8 + 8, t4),
// (g8, t4 + 4), (g8 + 8, t4 + 4)) * B (8 x 64); `add` 0 starts a fresh sum.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The rows of one phase's GEMM: pixel m of the block is image gi, image
// row `row`, column `col`.
struct Rows {
  int per, row0, W;  // pixels an image; first image row; width
  __device__ __forceinline__ void at(int m, int& gi, int& row, int& col) const {
    gi = m / per;
    const int rem = m - gi * per;
    const int rr = rem / W;
    row = row0 + rr;
    col = rem - rr * W;
  }
};

// The products of one stage (`KS` k-steps of B at `b_u`, `chunk_bytes`
// apart) on the first L of the warpgroup's tiles, whose rows stand at the
// offsets a_o.  bf16: each tile of 64 pixels x N channels takes one
// instruction a k-step.  A's fragments for the
// next k-step are read while this k-step's products run (two sets of
// registers; a set is free again once the group before the last is through).
// With `keep` the stage's last group stays in flight over the barrier that
// follows (KS is even then, so that group reads the second set of registers
// while the next stage's first fragments go into the first).
// `after_first` (the block's next loads) runs once the first k-step's
// products are under way, so that the tensor cores work meanwhile.
template <int N, int MT, int L, typename F>
__device__ __forceinline__ void stage_wgmma_bf16(float (&acc)[MT][N / 8][4], uint32_t smem_u,
                                                 const uint32_t (&a_o)[MT][1], uint32_t b_u,
                                                 int KS, int chunk_bytes, bool keep,
                                                 F&& after_first) {
  uint32_t a[2][L][4];
#pragma unroll
  for (int i = 0; i < L; ++i) ldmatrix_x4(a[0][i], smem_u + a_o[i][0]);
#pragma unroll 1
  for (int ks = 0; ks < KS; ks += 2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (ks + half < KS) {
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < L; ++i) {
          Wgmma<N>::run(reinterpret_cast<float(&)[N / 2]>(acc[i]), a[half][i],
                        b_descriptor(b_u + (ks + half) * chunk_bytes, 256));
        }
        wgmma_commit();
        if (half == 0 && ks == 0) after_first();
        if (ks + half + 1 < KS) {
          wgmma_wait<1>();  // the other set's products are through
#pragma unroll
          for (int i = 0; i < L; ++i)
            ldmatrix_x4(a[half ^ 1][i], smem_u + a_o[i][0] + (ks + half + 1) * 32);
        }
      }
    }
  }
  // Before the barrier after which a buffer is refilled: this stage's, or
  // with `keep` the stage's before it.
  if (keep) {
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
}

// fp32 as 3xTF32: a k-step's three products (small terms first) go into a
// sum that is fresh at every stage; at the stage's end an ordinary fp32 add
// puts it on the accumulator.  The tensor cores add with truncation, so a
// sum kept in them over all of k = 9 * C drifts by about 1e-4 at C = 512;
// over a stage's at most 24 products the drift stays below fp32 rounding,
// and the ordinary add rounds to nearest.  Inside the stage nothing waits
// for a product but the registers of A: the next k-step's values are read
// and split while this k-step's products run.
template <int L>
__device__ __forceinline__ void load_split(uint32_t (&hi)[L][4], uint32_t (&lo)[L][4],
                                           const unsigned char* smem,
                                           const uint32_t (&a_o)[2][2], int k_off) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    // a0 (g8, t4), a1 (g8 + 8, t4), a2 (g8, t4 + 4), a3 (g8 + 8, t4 + 4)
    split_tf32(lds_f32(smem, a_o[i][0] + k_off), hi[i][0], lo[i][0]);
    split_tf32(lds_f32(smem, a_o[i][1] + k_off), hi[i][1], lo[i][1]);
    split_tf32(lds_f32(smem, a_o[i][0] + k_off + 16), hi[i][2], lo[i][2]);
    split_tf32(lds_f32(smem, a_o[i][1] + k_off + 16), hi[i][3], lo[i][3]);
  }
}

template <int L, typename F>
__device__ __forceinline__ void stage_wgmma_tf32(float (&acc)[2][8][4], const unsigned char* smem,
                                                 const uint32_t (&a_o)[2][2], uint32_t b_u,
                                                 int KS, int chunk_bytes, F&& after_first) {
  float sum[L][32];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) sum[i][e] = 0.f;
  uint32_t hi[2][L][4], lo[2][L][4];
  load_split<L>(hi[0], lo[0], smem, a_o, 0);
#pragma unroll 1
  for (int ks = 0; ks < KS; ks += 2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (ks + half < KS) {
        const uint64_t b_hi = b_descriptor(b_u + (ks + half) * chunk_bytes, 512);
        const uint64_t b_lo = b_descriptor(b_u + (ks + half) * chunk_bytes + 256, 512);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < L; ++i) {
          wgmma_tf32_n64(sum[i], lo[half][i], b_hi, ks + half > 0);
          wgmma_tf32_n64(sum[i], hi[half][i], b_lo, 1);
          wgmma_tf32_n64(sum[i], hi[half][i], b_hi, 1);
        }
        wgmma_commit();
        if (half == 0 && ks == 0) after_first();
        if (ks + half + 1 < KS) {
          wgmma_wait<1>();  // the other set's products are through
          load_split<L>(hi[half ^ 1], lo[half ^ 1], smem, a_o, (ks + half + 1) * 32);
        }
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e / 4][e % 4] += sum[i][e];
}

template <typename T, int WN>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_kernel(const T* __restrict__ x, const unsigned char* __restrict__ w1p,
                   const float* __restrict__ b1, const float* __restrict__ a1,
                   const unsigned char* __restrict__ w2p, const float* __restrict__ b2,
                   const float* __restrict__ a2, T* __restrict__ out, const Plan p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kStep = Traits<T>::kStep, kRows = Traits<T>::kRows;
  // Tiles (64 pixels x WN channels) a warpgroup accumulates: 128 accumulator
  // registers a thread in bf16; 64 in fp32, whose k-step also has its sum.
  constexpr int kMT = kBf16 ? 256 / WN : 2;
  constexpr int kEsize = static_cast<int>(sizeof(T));
  constexpr int NT = WN / 8;  // n-tiles of 8 channels a warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31;
  // The warp's number by a shuffle, so that the compiler knows it (and the B
  // descriptors made from it) to be the same in all lanes.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment row and column group
  const int warp_m = warp % p.warps_m, warp_n = warp / p.warps_m;
  const int H = p.H, W = p.W, C = p.C;
  const int BN = kWarps / p.warps_m * WN;
  const int chunks = C / BN;
  const int h_stride = (C + Traits<T>::kPad) * kEsize;   // bytes a pixel of h
  const int x_stride = p.KS * 32 + 16;                   // bytes a pixel of an x slice
  const int steps_tap = C / kStep;                       // k-steps a tap
  const int slices = steps_tap / p.KS;                   // channel slices of KS k-steps
  const int row_bytes = C * kStep * Traits<T>::kWBytes;  // packed bytes a k-step, all channels
  const int chunk_bytes = BN * kStep * Traits<T>::kWBytes;
  const int stage_bytes = p.KS * chunk_bytes;
  const int spc = 9 * slices;  // stages a (pass, chunk): slice-major, the 9 taps inside
  // Blocks walk the slices of a (pass, chunk) from different starts, so that
  // the SMs do not all ask L2 for the same weights at the same time.
  const int rot = static_cast<int>(blockIdx.x * 0.6180339887 * slices) % slices;

  const int tile = blockIdx.x % p.tiles;
  const int n0 = (blockIdx.x / p.tiles) * p.G;
  const int r0 = tile * p.R;
  const bool whole = p.tiles == 1;
  const int x0 = whole ? 0 : r0 - 2;  // image row of the x tile's row 0
  const int h0 = whole ? 0 : r0 - 1;  // image row of h's row 0
  const int h_lo = max(r0 - 1, 0), h_hi = min(r0 + p.R + 1, H);  // h rows in the image
  const int o_hi = min(r0 + p.R, H);
  const int M1 = p.G * (h_hi - h_lo) * W, M2 = p.G * (o_hi - r0) * W;
  const int slots = p.warps_m * kMT;  // 16-pixel tiles a pass
  const int passes1 = ((M1 + 15) / 16 + slots - 1) / slots;
  const int passes2 = ((M2 + 15) / 16 + slots - 1) / slots;
  const int x_pixels = p.G * p.XR * W;
  const int slice_bytes = x_pixels * x_stride;

  // Shared memory: weight ring | two x slices | h | zero row | b1 a1 b2 a2 |
  // the x tile's pixels in device memory | an mbarrier a ring buffer.
  unsigned char* xs = smem + p.stages * stage_bytes;
  unsigned char* hs = xs + 2 * slice_bytes;
  unsigned char* zero = hs + p.G * p.HR * W * h_stride;
  float* params = reinterpret_cast<float*>(zero + h_stride);
  int* tab = reinterpret_cast<int*>(params + 4 * C);
  const uint32_t bars_u = smem_u32(tab) + (x_pixels + 3) / 4 * 16;
  // Byte offsets from `smem`, and its address for cp.async and ldmatrix.
  const uint32_t smem_u = smem_u32(smem);
  const uint32_t xs_o = xs - smem, hs_o = hs - smem, zero_o = zero - smem;

  // Element of x (N*H*W*C index) where each pixel of the x tile starts, -1
  // outside the image or past N; the zero row; the biases and slopes.
  for (int pix = tid; pix < x_pixels; pix += kThreads) {
    const int gi = pix / (p.XR * W);
    const int rem = pix - gi * p.XR * W;
    const int xr = rem / W;
    const int row = x0 + xr, col = rem - xr * W, n = n0 + gi;
    tab[pix] = n < p.N && row >= 0 && row < H ? ((n * H + row) * W + col) * C : -1;
  }
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) mbarrier_init(bars_u + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < h_stride / 4; i += kThreads) reinterpret_cast<uint32_t*>(zero)[i] = 0u;
  for (int i = tid; i < C; i += kThreads) {
    params[i] = b1[i];
    params[C + i] = a1[i];
    params[2 * C + i] = b2[i];
    params[3 * C + i] = a2[i];
  }
  __syncthreads();

  // ---- the stream, in the order the products consume it: phase 1's
  // (pass, chunk) pairs, then phase 2's; inside a pair the channel slices
  // (from slice `rot` on, wrapping), inside a slice the 9 taps.  A stage is
  // one tap of one slice of the weights; in phase 1 the first tap of a slice
  // also brings that slice of x (all pixels of the tile).  All counters step
  // without a division: this runs once a stage.
  const int lg_pixel = __ffs(2 * p.KS) - 1;  // 16-byte pieces a pixel of an x slice
  int l_left = (passes1 + passes2) * chunks * spc, l_pairs = passes1 * chunks;
  int l_tap = 0, l_done = 0, l_slice = rot, l_chunk = 0, l_slot = 0, x_loaded = 0;
  auto start_load = [&]() {
    if (l_left > 0) {
      --l_left;
      const bool first = l_pairs > 0;
      // The weights: a bulk copy a k-step, counted on the buffer's mbarrier.
      // Asking costs the asking warp some hundred cycles a copy, so the
      // k-steps go round the warps (0, 2, 4, 6, 1, 3, 5, 7) and warp 1 or 7
      // tells the barrier how many bytes to expect (the count may run
      // negative until it does).
      if (lane == 0) {
        const uint32_t dst = smem_u + l_slot * stage_bytes, bar = bars_u + 8 * l_slot;
        if (warp == (p.KS < 8 ? 1 : 7)) mbarrier_expect(bar, stage_bytes);
        const int ks = (warp >> 1) + 4 * (warp & 1);
        if (ks < p.KS) {
          const size_t k_step = static_cast<size_t>(l_tap * steps_tap + l_slice * p.KS + ks);
          bulk_copy(dst + ks * chunk_bytes,
                    (first ? w1p : w2p) + k_step * row_bytes +
                        static_cast<size_t>(l_chunk) * chunk_bytes,
                    chunk_bytes, bar);
        }
      }
      if (first && l_tap == 0) {
        const uint32_t xdst = smem_u + xs_o + (x_loaded & 1) * slice_bytes;
        const unsigned char* xsrc =
            reinterpret_cast<const unsigned char*>(x) + l_slice * p.KS * 32;
        for (int idx = tid; idx < (x_pixels << lg_pixel); idx += kThreads) {
          const int pix = idx >> lg_pixel, piece = idx - (pix << lg_pixel);
          const int at = tab[pix];
          cp_async16(xdst + pix * x_stride + piece * 16,
                     xsrc + static_cast<size_t>(max(at, 0)) * kEsize + piece * 16, at >= 0);
        }
        ++x_loaded;
      }
      if (++l_slot == p.stages) l_slot = 0;
      if (++l_tap == 9) {
        l_tap = 0;
        if (++l_slice == slices) l_slice = 0;
        if (++l_done == slices) {  // the pair is through; l_slice is back at rot
          l_done = 0;
          if (++l_chunk == chunks) l_chunk = 0;
          --l_pairs;
        }
      }
    }
    cp_async_commit();  // always, so that the x slices' groups stay counted
  };
  // Stages asked for ahead of the one in use.  bf16 with room in the ring
  // asks for one less: the buffer refilled after a barrier is then the one
  // of the stage before the last, and the last stage's final products may
  // still run over the barrier.
  const bool keep = kBf16 && p.KS >= 2 && p.stages >= 3;
  const int ahead = p.stages - (keep ? 2 : 1);
  for (int j = 0; j < ahead; ++j) start_load();
  int c_slot = 0, x_used = 0;
  uint32_t c_parity = 0;

  // Offset of the warpgroup's B tile inside a k-step of a stage.
  const uint32_t b_warp = warp_n * (WN / 8) * (kBf16 ? 256 : 512);
  // What a lane adds to a row's offset: ldmatrix lanes 16-31 address the
  // second 8 channels; an fp32 lane reads channel t4 (and t4 + 4).
  const uint32_t lane_k = kBf16 ? (lane >> 4) * 16 : t4 * 4;

#pragma unroll 1
  for (int phase = 0; phase < 2; ++phase) {
    const int M = phase == 0 ? M1 : M2;
    const int passes = phase == 0 ? passes1 : passes2;
    Rows rows;
    rows.per = (phase == 0 ? h_hi - h_lo : o_hi - r0) * W;
    rows.row0 = phase == 0 ? h_lo : r0;
    rows.W = W;
    // The operand: phase 1 reads the x slices, phase 2 reads h.
    const int src_rows = phase == 0 ? p.XR : p.HR, src_row0 = phase == 0 ? x0 : h0;
    const int a_stride = phase == 0 ? x_stride : h_stride;
    const float* bias = params + 2 * phase * C;
    const float* slope = bias + C;

#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      // Warp's tiles: pass * slots + i * warps_m + warp_m, i < kMT.  `most`
      // is the largest count of tiles a warp of the block has in this pass:
      // every warp computes that many (the others wait at the barrier
      // anyway), tiles past the end on the zero row.
      const int tile0 = pass * slots + warp_m;
      const int tiles_left = (M + 15) / 16 - pass * slots;
      const int most = min(kMT, (tiles_left + p.warps_m - 1) / p.warps_m);

      // The fragment rows this lane addresses: bf16 (ldmatrix) one row a
      // tile, lane & 15; fp32 rows g8 and g8 + 8.
      int pix_i[kMT][kRows];  // the row's pixel in the operand's tile
      int rc[kMT][kRows];     // image row << 16 | column; -1: no such pixel
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int m = (tile0 + i * p.warps_m) * 16 + (kBf16 ? (lane & 15) : g8 + 8 * k);
          int gi, row, col;
          rows.at(m, gi, row, col);
          rc[i][k] = m < M ? (row << 16 | col) : -1;
          pix_i[i][k] = (gi * src_rows + row - src_row0) * W + col;
        }
      }

#pragma unroll 1
      for (int chunk = 0; chunk < chunks; ++chunk) {
        float acc[kMT][NT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll 1
        for (int done = 0, slice = rot; done < slices; ++done) {
          if (phase == 0) ++x_used;  // the next x slice
          const uint32_t a_base = (phase == 0 ? xs_o + ((x_used - 1) & 1) * slice_bytes
                                              : hs_o + slice * p.KS * 32) + lane_k;
#pragma unroll 1
          for (int tap = 0; tap < 9; ++tap) {
            cp_async_wait(ahead - 1);                     // this thread's part of the x slice
            mbarrier_wait(bars_u + 8 * c_slot, c_parity);  // the stage's weights
            __syncthreads();  // the slice is there; the buffers to refill are free
            const uint32_t buf = c_slot * stage_bytes;
            if (++c_slot == p.stages) {
              c_slot = 0;
              c_parity ^= 1;
            }

            // The rows' offsets at this stage's tap.
            const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
            uint32_t a_o[kMT][kRows];
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                const int row = (rc[i][k] >> 16) + dy, col = (rc[i][k] & 0xffff) + dx;
                const bool in = rc[i][k] >= 0 && row >= 0 && row < H && col >= 0 && col < W;
                a_o[i][k] = in ? a_base + (pix_i[i][k] + dy * W + dx) * a_stride : zero_o + lane_k;
              }
            }
            const uint32_t b_u = smem_u + buf + b_warp;
            auto products = [&](auto count) {
              constexpr int L = decltype(count)::value;
              if constexpr (L > kMT) {
                return;  // `most` never exceeds kMT
              } else if constexpr (kBf16) {
                stage_wgmma_bf16<WN, kMT, L>(acc, smem_u, a_o, b_u, p.KS, chunk_bytes, keep,
                                             start_load);
              } else {
                stage_wgmma_tf32<L>(acc, smem, a_o, b_u, p.KS, chunk_bytes, start_load);
              }
            };
            switch (most) {
              case 1: products(std::integral_constant<int, 1>{}); break;
              case 2: products(std::integral_constant<int, 2>{}); break;
              case 3: products(std::integral_constant<int, 3>{}); break;
              default: products(std::integral_constant<int, 4>{}); break;
            }
          }
          if (++slice == slices) slice = 0;
        }

        if (keep) wgmma_wait<0>();  // the accumulators are complete
        // ---- epilogue of (pass, chunk): accumulator rows g8 and g8 + 8 of
        // each tile, columns 2 * t4 and 2 * t4 + 1 of each n-tile.  Phase 1
        // stores h; phase 2 adds x and stores the output.
        int at[kMT][2];  // phase 1: offset of the pixel's row of h; phase 2: pixel of x and out
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (tile0 + i * p.warps_m) * 16 + g8 + 8 * half;
            int gi, row, col;
            rows.at(m, gi, row, col);
            const bool ok = m < M && (phase == 0 || n0 + gi < p.N);
            at[i][half] = !ok ? -1
                          : phase == 0
                              ? static_cast<int>(hs_o) +
                                    ((gi * p.HR + row - h0) * W + col) * h_stride
                              : ((n0 + gi) * H + row) * W + col;
          }
        }
        const int co0 = chunk * BN + warp_n * WN + 2 * t4;
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (at[i][half] >= 0) {
              const size_t g = static_cast<size_t>(at[i][half]) * C + co0;
              float2 res[NT];  // the residual, all loads in flight together
              if (phase == 1) {
#pragma unroll
                for (int j = 0; j < NT; ++j) res[j] = load2(x + g + 8 * j);
              }
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const int co = co0 + 8 * j;
                const float2 bb = load2(bias + co), aa = load2(slope + co);
                const float v0 = acc[i][j][2 * half] + bb.x, v1 = acc[i][j][2 * half + 1] + bb.y;
                if (phase == 0) {
                  store2(reinterpret_cast<T*>(smem + at[i][half]) + co, prelu(v0, aa.x),
                         prelu(v1, aa.y));
                } else {
                  store2(out + g + 8 * j, prelu(v0 + res[j].x, aa.x), prelu(v1 + res[j].y, aa.y));
                }
              }
            }
          }
        }
      }
    }
    // Phase 2's first stage passes a __syncthreads before any warp reads h.
  }
  cp_async_wait(0);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The plan is made in Python; refuse one that does not describe this
// problem or does not fit a block.
bool plan_ok(const Plan& p, bool bf16) {
  const int step = bf16 ? 16 : 8, wbytes = bf16 ? 2 : 8, esize = bf16 ? 2 : 4;
  if (p.N < 1 || p.H < 1 || p.W < 1 || p.C < 64 || p.C % 64 != 0) return false;
  if (p.R < 1 || p.R > p.H || p.G < 1 || p.tiles != ceil_div(p.H, p.R)) return false;
  if (p.tiles > 1 && p.G != 1) return false;
  const bool whole = p.tiles == 1;
  if (p.XR != (whole ? p.H : p.R + 4) || p.HR != (whole ? p.H : p.R + 2)) return false;
  if (p.H >= 32768 || p.W >= 32768) return false;
  if (static_cast<long long>(p.H) * p.W * p.C > 0x7fffffffLL) return false;  // one image
  // the 4 warps of a warpgroup stand along the pixels
  if (p.warps_m != 4 && p.warps_m != 8) return false;
  if (p.WN != 64 && !(bf16 && (p.WN == 128 || p.WN == 256))) return false;
  const int BN = kWarps / p.warps_m * p.WN;
  if (p.C % BN != 0) return false;
  if ((p.KS != 1 && p.KS != 2 && p.KS != 4 && p.KS != 8) || (p.C / step) % p.KS != 0) return false;
  if (p.stages < 2 || p.stages > kMaxStages) return false;
  const long long stride = static_cast<long long>(p.C + (bf16 ? 8 : 4)) * esize;
  const long long x_pixels = static_cast<long long>(p.G) * p.XR * p.W;
  const long long smem = static_cast<long long>(p.stages) * p.KS * BN * step * wbytes +
                         2 * x_pixels * (p.KS * 32 + 16) +
                         (static_cast<long long>(p.G) * p.HR * p.W + 1) * stride + 16 * p.C +
                         (x_pixels + 3) / 4 * 16 + 8 * kMaxStages + 8;
  return smem == p.smem && smem <= kMaxSmem;
}

template <typename T, int WN>
cudaError_t launch(const Plan& p, const void* x, const void* w1p, const float* b1,
                   const float* a1, const void* w2p, const float* b2, const float* a2, void* out,
                   cudaStream_t stream) {
  auto kernel = fused_block_kernel<T, WN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  // Chunks of images whose elements stay below 2^31, one launch each.
  const long long image = static_cast<long long>(p.H) * p.W * p.C;
  const int per_launch = static_cast<int>(std::min<long long>(p.N, 0x7fffffffLL / image));
  for (int n0 = 0; n0 < p.N; n0 += per_launch) {
    Plan c = p;
    c.N = std::min(per_launch, p.N - n0);
    const long long blocks = static_cast<long long>(ceil_div(c.N, c.G)) * c.tiles;
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    const size_t at = static_cast<size_t>(n0) * image;
    kernel<<<static_cast<unsigned>(blocks), kThreads, c.smem, stream>>>(
        static_cast<const T*>(x) + at, static_cast<const unsigned char*>(w1p), b1, a1,
        static_cast<const unsigned char*>(w2p), b2, a2, static_cast<T*>(out) + at, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns the CUDA error (0 on success).
// The library links its own CUDA runtime, so it selects the device itself.
// `plan`: the ints of vcagan_torch/kernels/fused_block.py::Plan.ints().
// C a multiple of 64, H*W*C below 2^31 (N*H*W*C may pass it: the images go
// in chunks), pointers 16-byte aligned.
int vcagan_fused_block(const void* x, const void* w1p, const float* b1, const float* a1,
                       const void* w2p, const float* b2, const float* a2, void* out,
                       const int* plan, int plan_len, int is_bf16, int device, void* stream) {
  if (plan_len != kPlanInts) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.N = plan[0]; p.H = plan[1]; p.W = plan[2]; p.C = plan[3];
  p.R = plan[4]; p.G = plan[5]; p.tiles = plan[6]; p.XR = plan[7]; p.HR = plan[8];
  p.warps_m = plan[9]; p.WN = plan[10]; p.KS = plan[11]; p.stages = plan[12];
  p.smem = plan[13];
  if (!plan_ok(p, is_bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = p.WN == 256   ? launch<__nv_bfloat16, 256>(p, x, w1p, b1, a1, w2p, b2, a2, out, s)
          : p.WN == 128 ? launch<__nv_bfloat16, 128>(p, x, w1p, b1, a1, w2p, b2, a2, out, s)
                        : launch<__nv_bfloat16, 64>(p, x, w1p, b1, a1, w2p, b2, a2, out, s);
  } else {
    err = launch<float, 64>(p, x, w1p, b1, a1, w2p, b2, a2, out, s);
  }
  return static_cast<int>(err);
}

const char* vcagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
