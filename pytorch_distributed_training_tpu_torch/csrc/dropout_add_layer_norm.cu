// Dropout + residual add + LayerNorm, forward and backward, for Hopper
// (sm_90a): the post-LN tail of a BERT block, y = LN(x + dropout(h)).
//
// Forward. Replaces the Pallas kernel _dal_fwd_kernel of
// pytorch_distributed_training_tpu/ops/layer_norm.py (launched by
// _dal_fwd): keep = bits(seed, site, i) >= threshold for the flat index i
// of [rows, H] (philox.cuh), s = x + keep * h / (1 - rate) in float32, the
// LayerNorm of s with float32 statistics, y in the output dtype, and s
// stored in h's dtype when a backward will need it (s_out may be null).
//
// Backward. Replaces _dal_bwd_kernel (launched by _dal_bwd): the
// statistics recomputed from the stored (rounded) s, ds = _ln_dx(...),
// dx = ds, dh = keep * ds / (1 - rate) with keep regenerated from the same
// (seed, site, i), and float32 partial rows of dy * xhat and dy that the
// wrapper sums with torch.sum.
//
// Bound: bytes. Training forward reads h and x and writes y and s
// (4 x 2 MiB at 1024 x 1024 bf16, 2.5 us at 3.35 TB/s); the backward reads
// s and dy and writes dh and dx (the same 8.4 MB). The mask never touches
// memory. Design: one warp per row, the row in registers; each lane owns
// groups of four consecutive columns (j = (c * 32 + lane) * 4 + t), so one
// Philox block serves a lane's four elements and warp loads stay
// contiguous. The statistics are two warp-shuffle passes (mean, then the
// centred variance), as in layer_norm.cu. The backward walks rows
// blockIdx.x * 4 + warp, then + 4 * gridDim.x, keeps each lane's dscale and
// dbias sums in registers and adds the block's four warps through shared
// memory in a fixed order: no atomics, so two runs give the same bits.

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block

template <typename T, typename Tout, int C>
__global__ void __launch_bounds__(kWarps * 32)
dal_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
               const float* __restrict__ scale,
               const float* __restrict__ bias, Tout* __restrict__ y,
               T* __restrict__ s_out, int rows, int hdim, float eps,
               uint32_t seed, uint32_t site, uint32_t threshold,
               float keep_scale, int dropout) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint64_t base = static_cast<uint64_t>(row) * hdim;
  pdt::PhiloxStream rng(seed, site);
  const float fh = static_cast<float>(hdim);
  float v[4 * C];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = (c * 32 + lane) * 4 + t;
      const int k = c * 4 + t;
      v[k] = 0.f;
      if (j < hdim) {
        // _rn intrinsics: a rounded product, then a rounded sum, never a
        // fused multiply-add, so s is the plain version's s bit for bit
        float hv = pdt::to_f32(h[base + j]);
        if (dropout) {
          hv = rng.bits(base + j) >= threshold ? __fmul_rn(hv, keep_scale)
                                               : 0.f;
        }
        v[k] = __fadd_rn(pdt::to_f32(x[base + j]), hv);
        if (s_out != nullptr) s_out[base + j] = pdt::from_f32<T>(v[k]);
      }
      sum += v[k];
    }
  }
  const float mean = pdt::warp_sum(sum) / fh;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = (c * 32 + lane) * 4 + t;
      const int k = c * 4 + t;
      if (j < hdim) {
        v[k] -= mean;
        sq += v[k] * v[k];
      }
    }
  }
  const float rstd = rsqrtf(pdt::warp_sum(sq) / fh + eps);
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = (c * 32 + lane) * 4 + t;
      if (j < hdim) {
        y[base + j] = pdt::from_f32<Tout>(v[c * 4 + t] * rstd * scale[j] +
                                          bias[j]);
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarps * 32)
dal_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dy,
               const float* __restrict__ scale, T* __restrict__ dh,
               T* __restrict__ dx, float* __restrict__ dscale_part,
               float* __restrict__ dbias_part, int rows, int hdim, float eps,
               uint32_t seed, uint32_t site, uint32_t threshold,
               float keep_scale, int dropout) {
  __shared__ float red[kWarps * pdt::kMaxRowWidth];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float fh = static_cast<float>(hdim);
  float ps[4 * C], pb[4 * C];
#pragma unroll
  for (int k = 0; k < 4 * C; ++k) ps[k] = pb[k] = 0.f;
  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const uint64_t base = static_cast<uint64_t>(row) * hdim;
    float v[4 * C], g[4 * C];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = (c * 32 + lane) * 4 + t;
        const int k = c * 4 + t;
        v[k] = j < hdim ? pdt::to_f32(s[base + j]) : 0.f;
        g[k] = j < hdim ? pdt::to_f32(dy[base + j]) : 0.f;
        sum += v[k];
      }
    }
    const float mean = pdt::warp_sum(sum) / fh;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = (c * 32 + lane) * 4 + t;
        const int k = c * 4 + t;
        if (j < hdim) {
          v[k] -= mean;
          sq += v[k] * v[k];
        }
      }
    }
    const float rstd = rsqrtf(pdt::warp_sum(sq) / fh + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = (c * 32 + lane) * 4 + t;
        const int k = c * 4 + t;
        v[k] *= rstd;  // xhat
        const float wdy = j < hdim ? g[k] * scale[j] : 0.f;
        s1 += wdy * v[k];
        s2 += wdy;
      }
    }
    const float c1 = pdt::warp_sum(s1) / fh;
    const float c2 = pdt::warp_sum(s2) / fh;
    pdt::PhiloxStream rng(seed, site);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = (c * 32 + lane) * 4 + t;
        const int k = c * 4 + t;
        if (j < hdim) {
          const float ds = (g[k] * scale[j] - v[k] * c1 - c2) * rstd;
          dx[base + j] = pdt::from_f32<T>(ds);
          float dhv = ds;
          if (dropout) {
            dhv = rng.bits(base + j) >= threshold ? __fmul_rn(ds, keep_scale)
                                                  : 0.f;
          }
          dh[base + j] = pdt::from_f32<T>(dhv);
          ps[k] += g[k] * v[k];
          pb[k] += g[k];
        }
      }
    }
  }
  float* mine = red + warp * hdim;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = (c * 32 + lane) * 4 + t;
      if (j < hdim) mine[j] = ps[c * 4 + t];
    }
  }
  pdt::sum_warp_rows(red, kWarps, hdim,
                     dscale_part + static_cast<size_t>(blockIdx.x) * hdim);
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = (c * 32 + lane) * 4 + t;
      if (j < hdim) mine[j] = pb[c * 4 + t];
    }
  }
  pdt::sum_warp_rows(red, kWarps, hdim,
                     dbias_part + static_cast<size_t>(blockIdx.x) * hdim);
}

struct DropoutArgs {
  uint32_t seed, site, threshold;
  float keep_scale;
  int dropout;
};

template <typename T, typename Tout>
cudaError_t launch_fwd(const void* h, const void* x, const float* scale,
                       const float* bias, void* y, void* s_out, int rows,
                       int hdim, float eps, DropoutArgs d,
                       cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const T* hp = static_cast<const T*>(h);
  const T* xp = static_cast<const T*>(x);
  Tout* yp = static_cast<Tout*>(y);
  T* sp = static_cast<T*>(s_out);
#define PDT_DAL_FWD_CASE(C)                                                 \
  if (hdim <= 128 * (C)) {                                                  \
    dal_fwd_kernel<T, Tout, C><<<grid, kWarps * 32, 0, stream>>>(           \
        hp, xp, scale, bias, yp, sp, rows, hdim, eps, d.seed, d.site,       \
        d.threshold, d.keep_scale, d.dropout);                              \
    return cudaGetLastError();                                              \
  }
  PDT_DAL_FWD_CASE(1)
  PDT_DAL_FWD_CASE(2)
  PDT_DAL_FWD_CASE(4)
  PDT_DAL_FWD_CASE(8)
  PDT_DAL_FWD_CASE(16)
#undef PDT_DAL_FWD_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* s, const void* dy, const float* scale,
                       void* dh, void* dx, float* dscale_part,
                       float* dbias_part, int rows, int hdim, float eps,
                       DropoutArgs d, int blocks, cudaStream_t stream) {
  const T* sp = static_cast<const T*>(s);
  const T* dyp = static_cast<const T*>(dy);
  T* dhp = static_cast<T*>(dh);
  T* dxp = static_cast<T*>(dx);
#define PDT_DAL_BWD_CASE(C)                                                 \
  if (hdim <= 128 * (C)) {                                                  \
    dal_bwd_kernel<T, C><<<blocks, kWarps * 32, 0, stream>>>(               \
        sp, dyp, scale, dhp, dxp, dscale_part, dbias_part, rows, hdim, eps, \
        d.seed, d.site, d.threshold, d.keep_scale, d.dropout);              \
    return cudaGetLastError();                                              \
  }
  PDT_DAL_BWD_CASE(1)
  PDT_DAL_BWD_CASE(2)
  PDT_DAL_BWD_CASE(4)
  PDT_DAL_BWD_CASE(8)
  PDT_DAL_BWD_CASE(16)
#undef PDT_DAL_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// h, x [rows, hdim] (dtype), y [rows, hdim] (y_dtype), s_out [rows, hdim]
// (dtype) or null, scale/bias [hdim] float32. dropout = 0 skips the mask
// (rate 0). Returns the cudaError_t of the launch.
extern "C" int pdt_dal_fwd(const void* h, const void* x, const void* scale,
                           const void* bias, void* y, void* s_out, int rows,
                           int hdim, float eps, unsigned seed, unsigned site,
                           unsigned threshold, float keep_scale, int dropout,
                           int dtype, int y_dtype, void* stream) {
  if (rows <= 0 || hdim <= 0 || hdim > pdt::kMaxRowWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs d{seed, site, threshold, keep_scale, dropout};
  cudaError_t err;
  if (dtype == pdt::kBF16 && y_dtype == pdt::kBF16)
    err = launch_fwd<__nv_bfloat16, __nv_bfloat16>(h, x, sc, bi, y, s_out,
                                                   rows, hdim, eps, d, st);
  else if (dtype == pdt::kBF16 && y_dtype == pdt::kF32)
    err = launch_fwd<__nv_bfloat16, float>(h, x, sc, bi, y, s_out, rows,
                                           hdim, eps, d, st);
  else if (dtype == pdt::kF32 && y_dtype == pdt::kBF16)
    err = launch_fwd<float, __nv_bfloat16>(h, x, sc, bi, y, s_out, rows,
                                           hdim, eps, d, st);
  else if (dtype == pdt::kF32 && y_dtype == pdt::kF32)
    err = launch_fwd<float, float>(h, x, sc, bi, y, s_out, rows, hdim, eps,
                                   d, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// s, dy, dh, dx [rows, hdim] (dtype), scale [hdim] float32,
// dscale_part/dbias_part [blocks, hdim] float32. Returns the cudaError_t of
// the launch.
extern "C" int pdt_dal_bwd(const void* s, const void* dy, const void* scale,
                           void* dh, void* dx, void* dscale_part,
                           void* dbias_part, int rows, int hdim, float eps,
                           unsigned seed, unsigned site, unsigned threshold,
                           float keep_scale, int dropout, int dtype,
                           int blocks, void* stream) {
  if (rows <= 0 || hdim <= 0 || hdim > pdt::kMaxRowWidth || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  float* ps = static_cast<float*>(dscale_part);
  float* pb = static_cast<float*>(dbias_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs d{seed, site, threshold, keep_scale, dropout};
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch_bwd<__nv_bfloat16>(s, dy, sc, dh, dx, ps, pb, rows, hdim,
                                    eps, d, blocks, st);
  else if (dtype == pdt::kF32)
    err = launch_bwd<float>(s, dy, sc, dh, dx, ps, pb, rows, hdim, eps, d,
                            blocks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
