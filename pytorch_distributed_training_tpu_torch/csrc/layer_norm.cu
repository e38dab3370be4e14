// LayerNorm forward and backward for Hopper (sm_90a).
//
// Forward. Replaces the Pallas kernel _fwd_kernel of
// pytorch_distributed_training_tpu/ops/layer_norm.py (launched by _fwd): a
// row-wise LayerNorm over the last axis with float32 statistics, the
// biased variance mean((x - mean)^2), eps inside the rsqrt, float32
// scale/bias, output cast to the requested dtype. The formula is the
// plain version's (ops/layer_norm.py reference_layer_norm) step by step:
// mean, then the centred variance, both from the row held in registers,
// then (x - mean) * rstd * scale + bias.
//
// Bound: bytes. A row is read once and written once (plus the shared
// scale/bias, which stay in L1/L2); ~8 float ops an element. At the decode
// tick (8 rows) there are too few bytes for the rate to matter, and the
// time is the chain of dependent steps, so the design keeps that chain to
// one memory trip: every load of a thread (x as 16-byte chunks, 8 bf16 or
// 4 float32; scale and bias as float4) is issued at the start, before the
// two reductions, and y leaves as 16-byte (or 8-byte) stores.
//
// Row mapping. A row belongs to `wpr` warps (32 * wpr threads); thread t
// of the row takes chunks t, t + 32 * wpr, ... . With one warp a row the
// reductions are warp shuffles only; with several, the warps' sums meet in
// shared memory behind a named barrier of the row's warps alone, summed in
// warp order. A block holds `slots` rows. The wrapper picks (wpr, slots)
// from the shape alone (ops/layer_norm.py _row_plan): a block a row and
// one chunk a thread while rows are few, as at the decode tick, so the
// row's loads spread over many threads and SMs; a warp or two a row and
// several rows a block when rows are many.
//
// Vector and scalar variants. The 16-byte loads need every row to start
// on a 16-byte boundary: x, y, scale and bias aligned and H a multiple of
// the chunk. Otherwise (a contiguous view at an odd storage offset, an H
// such as 1000 in bf16) the same kernel runs with one element a chunk
// (VEC 1), lane-strided.
//
// Backward. Replaces the Pallas kernel _bwd_kernel of the same file
// (launched by _bwd): dx = _ln_dx(xhat, dy, scale, rstd) in x's dtype,
// with the statistics recomputed from x (_ln_stats), and the float32
// column sums dscale = sum(dy * xhat), dbias = sum(dy) over the rows.
//
// Bound: bytes. x and dy read once, dx written once (3 x 2 MiB at 1024 x
// 1024 bf16, 1.9 us at 3.35 TB/s). Two passes, launched back to back by
// one call, with no partial rows in device memory and no atomics:
//   1. dx pass: the forward's row mapping and 16-byte loads (x, dy and
//      scale issued together at the start, scale once a row), the mean,
//      the centred variance, then sum(wdy * xhat) and sum(wdy) in one
//      reduction; writes dx and the row's (mean, rstd), 8 bytes a row.
//   2. column pass: a block owns two 16-byte chunks of columns (16 bf16
//      or 8 float32; 32 single columns on the scalar path) over every
//      row, so no sum crosses blocks: thread `group` takes rows group, group +
//      groups, ... in order, recomputing xhat = (x - mean) * rstd as pass
//      1 formed it, then the groups of a warp meet by xor-butterfly and
//      the warps in warp order. It reads x and dy a second time, from L2
//      where pass 1 left them.
// Each sum's order is fixed by the shape, so two runs give the same bits.
// (One launch that summed the columns across blocks, through clusters or
// a last-block ticket, spent more on its barriers and on the rows each
// block had to walk than this second pass costs.) The row helpers and the
// column pass live in layer_norm_rows.cuh, shared with
// dropout_add_layer_norm.cu.

#include "layer_norm_rows.cuh"

namespace {

using pdt::kColumnThreads;
using pdt::kMaxRowWarps;
using pdt::kMaxSlots;
using pdt::kMaxThreads;
using pdt::load_pack;
using pdt::max_floats;
using pdt::row_sum;
using pdt::store_pack;
using pdt::unpack;

// ------------------------------------------------------------------ forward

template <typename Tin, typename Tout, int VEC, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_fwd_kernel(const Tin* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, Tout* __restrict__ y,
                      int rows, int h, float eps, int wpr) {
  __shared__ float red[kMaxSlots][2][2 * kMaxRowWarps];
  const int tpr = wpr * 32;
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  if (row >= rows) return;  // the row's warps leave together
  const int n = h / VEC;
  const size_t base = static_cast<size_t>(row) * h;
  float v[CPT][VEC], s[CPT][VEC], b[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      unpack(load_pack<Tin, VEC>(x + base + k * VEC), v[c]);
      unpack(load_pack<float, VEC>(scale + k * VEC), s[c]);
      unpack(load_pack<float, VEC>(bias + k * VEC), b[c]);
    }
  }
  float sum[1] = {0.f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (c * tpr + t < n) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[0] += v[c][i];
    }
  }
  row_sum(sum, red[slot][0], wpr, t >> 5, slot);
  const float fh = static_cast<float>(h);
  const float mean = sum[0] / fh;
  float sq[1] = {0.f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (c * tpr + t < n) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] -= mean;
        sq[0] += v[c][i] * v[c][i];
      }
    }
  }
  row_sum(sq, red[slot][1], wpr, t >> 5, slot);
  const float rstd = rsqrtf(sq[0] / fh + eps);
  Tout* yr = y + base;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = v[c][i] * rstd * s[c][i] + b[c][i];
      store_pack<Tout, VEC>(yr + k * VEC, o);
    }
  }
}

// The smallest instantiated chunk count >= cpt (a power of two), launched.
template <typename Tin, typename Tout, int VEC, int CPT = 1>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias,
                       void* y, int rows, int h, float eps, int wpr,
                       int slots, int cpt, cudaStream_t stream) {
  if constexpr (CPT * VEC > max_floats<VEC>()) {
    return cudaErrorInvalidValue;
  } else {
    if (cpt > CPT)
      return launch_fwd<Tin, Tout, VEC, 2 * CPT>(x, scale, bias, y, rows, h,
                                                 eps, wpr, slots, cpt, stream);
    const dim3 grid((rows + slots - 1) / slots);
    layer_norm_fwd_kernel<Tin, Tout, VEC, CPT>
        <<<grid, slots * wpr * 32, 0, stream>>>(
            static_cast<const Tin*>(x), scale, bias, static_cast<Tout*>(y),
            rows, h, eps, wpr);
    return cudaGetLastError();
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_fwd_vec(const void* x, const float* scale,
                           const float* bias, void* y, int rows, int h,
                           float eps, int vec, int wpr, int slots, int cpt,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Tin);
  if (vec == kVec)
    return launch_fwd<Tin, Tout, kVec>(x, scale, bias, y, rows, h, eps, wpr,
                                       slots, cpt, stream);
  return launch_fwd<Tin, Tout, 1>(x, scale, bias, y, rows, h, eps, wpr, slots,
                                  cpt, stream);
}

// ----------------------------------------------------------------- backward

// dx of a row, and its (mean, rstd) for the column pass: the forward's
// mapping and loads (x, dy and scale chunks all issued at the start), three
// reductions (the mean, the centred variance, then sum(wdy * xhat) and
// sum(wdy) together).
template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ scale, T* __restrict__ dx,
                         float2* __restrict__ stats, int rows, int h,
                         float eps, int wpr) {
  __shared__ float red[kMaxSlots][3][2 * kMaxRowWarps];
  const int tpr = wpr * 32;
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int warp = t >> 5;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  if (row >= rows) return;  // the row's warps leave together
  const int n = h / VEC;
  const size_t base = static_cast<size_t>(row) * h;
  const float fh = static_cast<float>(h);
  float v[CPT][VEC], g[CPT][VEC], w[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      unpack(load_pack<T, VEC>(x + base + k * VEC), v[c]);
      unpack(load_pack<T, VEC>(dy + base + k * VEC), g[c]);
      unpack(load_pack<float, VEC>(scale + k * VEC), w[c]);
    }
  }
  float st[1] = {0.f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (c * tpr + t < n) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) st[0] += v[c][i];
    }
  }
  row_sum(st, red[slot][0], wpr, warp, slot);
  const float mean = st[0] / fh;
  float sq[1] = {0.f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (c * tpr + t < n) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] -= mean;
        sq[0] += v[c][i] * v[c][i];
      }
    }
  }
  row_sum(sq, red[slot][1], wpr, warp, slot);
  const float rstd = rsqrtf(sq[0] / fh + eps);
  float cs[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (c * tpr + t < n) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] *= rstd;  // xhat
        g[c][i] *= w[c][i];  // wdy
        cs[0] += g[c][i] * v[c][i];
        cs[1] += g[c][i];
      }
    }
  }
  row_sum(cs, red[slot][2], wpr, warp, slot);
  const float c1 = cs[0] / fh;
  const float c2 = cs[1] / fh;
  T* dxr = dx + base;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = (g[c][i] - v[c][i] * c1 - c2) * rstd;
      store_pack<T, VEC>(dxr + k * VEC, o);
    }
  }
  if (t == 0) stats[row] = make_float2(mean, rstd);
}

// The column pass (layer_norm_rows.cuh), under a symbol of this library.
template <typename T, int VEC, int CB>
__global__ void __launch_bounds__(kColumnThreads)
layer_norm_bwd_params_kernel(const T* __restrict__ x,
                             const T* __restrict__ dy,
                             const float2* __restrict__ stats,
                             float* __restrict__ dscale,
                             float* __restrict__ dbias, int rows, int h) {
  pdt::column_pass<T, VEC, CB>(x, dy, stats, dscale, dbias, rows, h);
}

template <typename T, int VEC, int CPT = 1>
cudaError_t launch_bwd(const void* x, const void* dy, const float* scale,
                       void* dx, float2* stats, float* dscale, float* dbias,
                       int rows, int h, float eps, int wpr, int slots,
                       int cpt, cudaStream_t stream) {
  if constexpr (CPT * VEC > max_floats<VEC>()) {
    return cudaErrorInvalidValue;
  } else {
    if (cpt > CPT)
      return launch_bwd<T, VEC, 2 * CPT>(x, dy, scale, dx, stats, dscale,
                                         dbias, rows, h, eps, wpr, slots,
                                         cpt, stream);
    const T* xp = static_cast<const T*>(x);
    const T* dyp = static_cast<const T*>(dy);
    layer_norm_bwd_dx_kernel<T, VEC, CPT>
        <<<(rows + slots - 1) / slots, slots * wpr * 32, 0, stream>>>(
            xp, dyp, scale, static_cast<T*>(dx), stats, rows, h, eps, wpr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    layer_norm_bwd_params_kernel<T, VEC, pdt::column_chunks<VEC>()>
        <<<pdt::column_blocks<VEC>(h), kColumnThreads, 0, stream>>>(
            xp, dyp, stats, dscale, dbias, rows, h);
    return cudaGetLastError();
  }
}

}  // namespace

// x, dy, dx [rows, h] (float32 or bfloat16, by dtype), scale [h] float32,
// stats [rows] float2 scratch (each row's mean and rstd, written by the dx
// pass and read by the column pass), dscale/dbias [h] float32. vec:
// elements a chunk (1, or 16 bytes of the dtype); wpr: warps a row; slots:
// rows a block of the dx pass (slots * wpr <= 16). Launches the two passes
// on the stream; returns the cudaError_t of the launches.
extern "C" int pdt_layer_norm_bwd(const void* x, const void* dy,
                                  const void* scale, void* dx, void* stats,
                                  void* dscale, void* dbias, int rows, int h,
                                  float eps, int dtype, int vec, int wpr,
                                  int slots, void* stream) {
  const int esize = dtype == pdt::kBF16 ? 2 : 4;
  int cpt = 0;
  if ((dtype != pdt::kBF16 && dtype != pdt::kF32) ||
      !pdt::check_plan(rows, h, esize, vec, wpr, slots, &cpt,
                       {x, dy, dx, scale}))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  float2* sp = static_cast<float2*>(stats);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pdt::kBF16) {
    err = vec == 1
        ? launch_bwd<__nv_bfloat16, 1>(x, dy, s, dx, sp, ds, db, rows, h, eps,
                                       wpr, slots, cpt, st)
        : launch_bwd<__nv_bfloat16, 8>(x, dy, s, dx, sp, ds, db, rows, h, eps,
                                       wpr, slots, cpt, st);
  } else {
    err = vec == 1
        ? launch_bwd<float, 1>(x, dy, s, dx, sp, ds, db, rows, h, eps, wpr,
                               slots, cpt, st)
        : launch_bwd<float, 4>(x, dy, s, dx, sp, ds, db, rows, h, eps, wpr,
                               slots, cpt, st);
  }
  return static_cast<int>(err);
}

// x [rows, h] (float32 or bfloat16, by x_dtype), scale/bias [h] float32,
// y [rows, h] (by y_dtype). vec: elements a chunk (1, or 16 bytes of x's
// dtype); wpr: warps a row; slots: rows a block (slots * wpr <= 16).
// Returns the cudaError_t of the launch.
extern "C" int pdt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, int rows, int h,
                                  float eps, int x_dtype, int y_dtype,
                                  int vec, int wpr, int slots,
                                  void* stream) {
  const bool dtypes_ok = (x_dtype == pdt::kBF16 || x_dtype == pdt::kF32) &&
                         (y_dtype == pdt::kBF16 || y_dtype == pdt::kF32);
  const int esize = x_dtype == pdt::kBF16 ? 2 : 4;
  int cpt = 0;
  if (!dtypes_ok || !pdt::check_plan(rows, h, esize, vec, wpr, slots, &cpt,
                                     {x, y, scale, bias}))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == pdt::kBF16 && y_dtype == pdt::kBF16)
    err = launch_fwd_vec<__nv_bfloat16, __nv_bfloat16>(
        x, s, b, y, rows, h, eps, vec, wpr, slots, cpt, st);
  else if (x_dtype == pdt::kBF16)
    err = launch_fwd_vec<__nv_bfloat16, float>(x, s, b, y, rows, h, eps, vec,
                                               wpr, slots, cpt, st);
  else if (y_dtype == pdt::kBF16)
    err = launch_fwd_vec<float, __nv_bfloat16>(x, s, b, y, rows, h, eps, vec,
                                               wpr, slots, cpt, st);
  else
    err = launch_fwd_vec<float, float>(x, s, b, y, rows, h, eps, vec, wpr,
                                       slots, cpt, st);
  return static_cast<int>(err);
}
