// Helpers every kernel library of the port shares: the precision codes,
// f32 / bf16 conversions, the bf16 split of an f32 value, and the error
// string entry point the Python side reads a cudaError_t through.
//
// The precision ladder (capital_tpu/ops/pallas_dot.py, restated for this
// card):
//   PREC_HIGHEST  f32 FFMA; never TF32.
//   PREC_HIGH     hi = RNE bf16(x), lo = bf16(x - hi); three bf16 tensor-
//                 core products with f32 accumulation: hi*hi + hi*lo +
//                 lo*hi.
//   PREC_DEFAULT  one bf16 pass; bf16 inputs always.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace capital {

enum Prec { PREC_HIGHEST = 0, PREC_HIGH = 1, PREC_DEFAULT = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to nearest-even on the bf16 grid, bit for bit as
// capital_tpu/ops/pallas_dot.py::_split_f32 does it.
__device__ __forceinline__ float bf16_hi(float x) {
  uint32_t u = __float_as_uint(x);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(u);
}

}  // namespace capital

extern "C" const char* capital_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
