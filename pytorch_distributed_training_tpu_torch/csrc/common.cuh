// Helpers shared by the port's CUDA kernels: dtype conversion and warp
// reductions. Plain CUDA, no PyTorch headers (see ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace pdt {

// dtype codes passed from Python (ops/_build.py callers)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch/XLA cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Widest row the one-warp-per-row LayerNorm kernels take: 64 floats a lane.
constexpr int kMaxRowWidth = 2048;

// Sum the per-warp partial rows red[w * h + j] (w < warps) of a block into
// out[j], warp 0's first, in that fixed order (no atomics: two runs give
// the same bits). Every thread of the block must call it.
__device__ __forceinline__ void sum_warp_rows(const float* red, int warps,
                                              int h, float* out) {
  __syncthreads();
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * h + j];
    out[j] = s;
  }
  __syncthreads();
}

}  // namespace pdt

extern "C" const char* pdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
