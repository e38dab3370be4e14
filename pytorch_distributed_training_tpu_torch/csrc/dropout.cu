// Dropout mask-scale for Hopper (sm_90a).
//
// Replaces the Pallas kernel _mask_scale_kernel of
// pytorch_distributed_training_tpu/ops/dropout.py (launched by
// _mask_scale_from_seed): a tensor of {0, 1/(1-rate)} in the target dtype,
// element i kept when bits(seed, site, i) >= threshold (philox.cuh; the
// threshold is ops/dropout.py mask_threshold). The caller multiplies its
// activation by it (raw_dropout), so only the mask-scale tensor, never the
// random words, touches device memory.
//
// Bound: bytes. The output is written once (2 bytes an element in bf16);
// nothing is read. Philox4x32-10 costs ~10 rounds of two 32-bit
// multiplies per four elements, some 15 integer operations an element,
// which stays under the card's integer rate at the memory rate. Design: a
// grid-stride loop in which each thread takes one group of four
// consecutive elements, draws one Philox block for it and writes four
// outputs. Any element count is taken (the last group is masked), so the
// JAX package's fallback for shapes that do not tile by 128 lanes has no
// counterpart here.

#include "common.cuh"
#include "philox.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
mask_scale_kernel(T* __restrict__ out, uint64_t n, uint32_t seed,
                  uint32_t site, uint32_t threshold, float keep_scale) {
  const uint64_t groups = (n + 3) >> 2;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t g = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       g < groups; g += stride) {
    const pdt::Philox4 r = pdt::philox4x32_10(g, seed, site);
    const uint64_t i0 = g << 2;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint64_t i = i0 + t;
      if (i < n) {
        out[i] = pdt::from_f32<T>(r.v[t] >= threshold ? keep_scale : 0.f);
      }
    }
  }
}

}  // namespace

// out [n] (float32 or bfloat16, by out_dtype). Returns the cudaError_t of
// the launch.
extern "C" int pdt_mask_scale(void* out, long long n, unsigned seed,
                              unsigned site, unsigned threshold,
                              float keep_scale, int out_dtype, int blocks,
                              void* stream) {
  if (n <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t count = static_cast<uint64_t>(n);
  if (out_dtype == pdt::kBF16) {
    mask_scale_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<__nv_bfloat16*>(out), count, seed, site, threshold,
        keep_scale);
  } else if (out_dtype == pdt::kF32) {
    mask_scale_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<float*>(out), count, seed, site, threshold, keep_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
