// Shared helpers for the hand-written Hopper kernels of the TFR U-Net.
//
// Every kernel takes float32 or bfloat16 activations (dtype code 0 / 1),
// converts to float32 on load, accumulates in float32 and rounds once on
// store.  Layouts are contiguous NCHW, frames on the batch axis:
// x[t, c, y, x] at ((t * C + c) * H + y) * W + x.  Offsets into a frame
// plane are 64-bit: a (40, 72, 720, 1280) activation has 2.6e9 elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace shiftnet {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v > 0.f ? v : a * v;
}

// Deterministic warp sum: a fixed shuffle tree, no atomics.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace shiftnet
