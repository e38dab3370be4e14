// LayerNorm forward and backward for Hopper (sm_90a).
//
// Forward. Replaces the Pallas kernel _fwd_kernel of
// pytorch_distributed_training_tpu/ops/layer_norm.py (launched by _fwd): a
// row-wise LayerNorm over the last axis with float32 statistics, the
// biased variance mean((x - mean)^2), eps inside the rsqrt, float32
// scale/bias, output cast to the requested dtype. The formula is the
// plain version's (ops/layer_norm.py reference_layer_norm) step by step.
//
// Bound: bytes. A row is read once and written once (plus the shared
// scale/bias, which stay in L1/L2); the arithmetic is ~8 float ops per
// element, far below the card's rate. Design: one warp per row, four rows
// per block; each lane keeps its ceil(H/32) elements in registers (two-pass
// mean then centred variance, both warp-shuffle reductions), so the row is
// never re-read from memory. Lanes read neighbouring elements, so each
// warp load is coalesced. No minimum row count: decode runs at num_slots
// rows, unlike the TPU kernel's 16-row tile floor.
//
// Backward. Replaces the Pallas kernel _bwd_kernel of the same file
// (launched by _bwd): dx = _ln_dx(xhat, dy, scale, rstd) in x's dtype,
// with the statistics recomputed from x (_ln_stats), and float32 partial
// sums of dy * xhat and dy for dscale and dbias, one row per block, which
// the wrapper sums with torch.sum as the JAX package sums its per-block
// partials outside its kernel.
//
// Bound: bytes. x and dy are read once and dx written once (3 x 2 MiB at
// 1024 x 1024 bf16, 1.9 us at 3.35 TB/s); the partial rows add
// blocks x H x 8 bytes. Design: the forward's layout (one warp per row,
// the row of x and dy in registers, lane-strided columns), so the
// recomputed statistics use the forward's summation order. A warp walks
// rows blockIdx.x * 4 + warp, then + 4 * gridDim.x; each lane keeps its
// columns' dscale/dbias sums in registers across those rows, and the
// block adds its four warps' rows through shared memory in a fixed order.
// No atomics, so two runs give the same bits.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block

template <typename Tin, typename Tout, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const Tin* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      Tout* __restrict__ y, int rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const Tin* xr = x + static_cast<size_t>(row) * h;
  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = i * 32 + lane;
    v[i] = j < h ? pdt::to_f32(xr[j]) : 0.f;
    sum += v[i];
  }
  const float inv_h = 1.f / static_cast<float>(h);
  const float mean = pdt::warp_sum(sum) * inv_h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = i * 32 + lane;
    if (j < h) {
      const float c = v[i] - mean;
      v[i] = c;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(pdt::warp_sum(sq) * inv_h + eps);
  Tout* yr = y + static_cast<size_t>(row) * h;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = i * 32 + lane;
    if (j < h) yr[j] = pdt::from_f32<Tout>(v[i] * rstd * scale[j] + bias[j]);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, int rows, int h, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const Tin* xp = static_cast<const Tin*>(x);
  Tout* yp = static_cast<Tout*>(y);
#define PDT_LN_CASE(VPT)                                                  \
  if (h <= 32 * (VPT)) {                                                  \
    layer_norm_fwd_kernel<Tin, Tout, VPT>                                 \
        <<<grid, block, 0, stream>>>(xp, scale, bias, yp, rows, h, eps);  \
    return cudaGetLastError();                                            \
  }
  PDT_LN_CASE(1)
  PDT_LN_CASE(2)
  PDT_LN_CASE(4)
  PDT_LN_CASE(8)
  PDT_LN_CASE(16)
  PDT_LN_CASE(32)
  PDT_LN_CASE(64)
#undef PDT_LN_CASE
  return cudaErrorInvalidValue;  // h > 2048: the wrapper refuses it first
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      float* __restrict__ dscale_part,
                      float* __restrict__ dbias_part, int rows, int h,
                      float eps) {
  __shared__ float red[kWarps * pdt::kMaxRowWidth];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float fh = static_cast<float>(h);
  float ps[VPT], pb[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) ps[i] = pb[i] = 0.f;
  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * h;
    float v[VPT], g[VPT];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = i * 32 + lane;
      v[i] = j < h ? pdt::to_f32(x[base + j]) : 0.f;
      g[i] = j < h ? pdt::to_f32(dy[base + j]) : 0.f;
      sum += v[i];
    }
    const float mean = pdt::warp_sum(sum) / fh;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = i * 32 + lane;
      if (j < h) {
        v[i] -= mean;
        sq += v[i] * v[i];
      }
    }
    const float rstd = rsqrtf(pdt::warp_sum(sq) / fh + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = i * 32 + lane;
      v[i] *= rstd;  // xhat
      const float wdy = j < h ? g[i] * scale[j] : 0.f;
      s1 += wdy * v[i];
      s2 += wdy;
    }
    const float c1 = pdt::warp_sum(s1) / fh;
    const float c2 = pdt::warp_sum(s2) / fh;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = i * 32 + lane;
      if (j < h) {
        const float wdy = g[i] * scale[j];
        dx[base + j] = pdt::from_f32<T>((wdy - v[i] * c1 - c2) * rstd);
        ps[i] += g[i] * v[i];
        pb[i] += g[i];
      }
    }
  }
  float* mine = red + warp * h;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = i * 32 + lane;
    if (j < h) mine[j] = ps[i];
  }
  pdt::sum_warp_rows(red, kWarps, h,
                     dscale_part + static_cast<size_t>(blockIdx.x) * h);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = i * 32 + lane;
    if (j < h) mine[j] = pb[i];
  }
  pdt::sum_warp_rows(red, kWarps, h,
                     dbias_part + static_cast<size_t>(blockIdx.x) * h);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const float* scale,
                       void* dx, float* dscale_part, float* dbias_part,
                       int rows, int h, float eps, int blocks,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
#define PDT_LN_BWD_CASE(VPT)                                                \
  if (h <= 32 * (VPT)) {                                                    \
    layer_norm_bwd_kernel<T, VPT><<<blocks, kWarps * 32, 0, stream>>>(      \
        xp, dyp, scale, dxp, dscale_part, dbias_part, rows, h, eps);        \
    return cudaGetLastError();                                              \
  }
  PDT_LN_BWD_CASE(1)
  PDT_LN_BWD_CASE(2)
  PDT_LN_BWD_CASE(4)
  PDT_LN_BWD_CASE(8)
  PDT_LN_BWD_CASE(16)
  PDT_LN_BWD_CASE(32)
  PDT_LN_BWD_CASE(64)
#undef PDT_LN_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx [rows, h] (float32 or bfloat16, by dtype), scale [h] float32,
// dscale_part/dbias_part [blocks, h] float32. Returns the cudaError_t of
// the launch.
extern "C" int pdt_layer_norm_bwd(const void* x, const void* dy,
                                  const void* scale, void* dx,
                                  void* dscale_part, void* dbias_part,
                                  int rows, int h, float eps, int dtype,
                                  int blocks, void* stream) {
  if (rows <= 0 || h <= 0 || h > pdt::kMaxRowWidth || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  float* ps = static_cast<float*>(dscale_part);
  float* pb = static_cast<float*>(dbias_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch_bwd<__nv_bfloat16>(x, dy, s, dx, ps, pb, rows, h, eps,
                                    blocks, st);
  else if (dtype == pdt::kF32)
    err = launch_bwd<float>(x, dy, s, dx, ps, pb, rows, h, eps, blocks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// x [rows, h] (float32 or bfloat16, by x_dtype), scale/bias [h] float32,
// y [rows, h] (by y_dtype). Returns the cudaError_t of the launch.
extern "C" int pdt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, int rows, int h,
                                  float eps, int x_dtype, int y_dtype,
                                  void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == pdt::kBF16 && y_dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, s, b, y, rows, h, eps, st);
  else if (x_dtype == pdt::kBF16 && y_dtype == pdt::kF32)
    err = launch<__nv_bfloat16, float>(x, s, b, y, rows, h, eps, st);
  else if (x_dtype == pdt::kF32 && y_dtype == pdt::kBF16)
    err = launch<float, __nv_bfloat16>(x, s, b, y, rows, h, eps, st);
  else if (x_dtype == pdt::kF32 && y_dtype == pdt::kF32)
    err = launch<float, float>(x, s, b, y, rows, h, eps, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
