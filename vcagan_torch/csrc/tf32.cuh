// The split of an fp32 value into two TF32 values for 3xTF32 products:
// a = hi + lo to about 2^-21 relative.  Shared by the kernels' fp32 forms;
// vcagan_torch/kernels/_tf32.py rounds the same way in plain PyTorch.
#pragma once

#include <stdint.h>

namespace {

// fp32 -> nearest TF32 value (low 13 mantissa bits zero, ties away from
// zero, as cvt.rna.tf32.f32; integer instructions, which run at full rate).
__device__ __forceinline__ uint32_t round_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
// a = hi + lo with both parts TF32 values.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(a);
  lo = round_tf32(a - __uint_as_float(hi));
}

}  // namespace
