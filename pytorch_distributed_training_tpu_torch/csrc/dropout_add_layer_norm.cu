// Dropout + residual add + LayerNorm, forward and backward, for Hopper
// (sm_90a): the post-LN tail of a BERT block, y = LN(x + dropout(h)).
//
// Forward. Replaces the Pallas kernel _dal_fwd_kernel of
// pytorch_distributed_training_tpu/ops/layer_norm.py (launched by
// _dal_fwd): keep = bits(seed, site, i) >= threshold for the flat index i
// of [rows, H] (philox.cuh), s = x + keep * h / (1 - rate) in float32
// (a rounded product, then a rounded sum, never a fused multiply-add, so
// s is the plain version's bit for bit), the LayerNorm of that float32 s,
// y in the output dtype, and s stored in h's dtype when a backward will
// need it (s_out may be null).
//
// Backward. Replaces _dal_bwd_kernel (launched by _dal_bwd): the
// statistics recomputed from the stored (rounded) s, ds = _ln_dx(...),
// dx = ds, dh = keep * ds / (1 - rate) from the float32 ds, with keep
// regenerated from the same (seed, site, i), and the float32 column sums
// dscale = sum(dy * xhat), dbias = sum(dy).
//
// Bound: bytes. The training forward reads h and x and writes y and s
// (4 x 2 MiB at 1024 x 1024 bf16, 2.5 us at 3.35 TB/s); the backward
// reads s and dy and writes dh and dx (the same 8.4 MB); the eval forward
// (rate 0, no s) reads h and x and writes y. The mask never touches
// memory; its Philox4x32-10 rounds (in the SASS of the mask loop, 5.1
// instructions an element on the FMA-heavy pipe and 7.8 on the ALU pipe
// forward, 4.9 and 8.0 backward, at 64 a clock per SM each) are few
// beside the bytes at the card's rate, but they lengthen each thread's
// chain, so they run while the thread's loads are in flight.
//
// Design: the LayerNorm kernels' (layer_norm.cu), on the row machinery of
// layer_norm_rows.cuh.
//   Forward: a row belongs to `wpr` warps, thread t taking chunks t,
//   t + 32 * wpr, ... of 16 bytes (8 bf16 or 4 float32), on the LayerNorm
//   forward's plan (ops/layer_norm.py _row_plan). A thread issues all its
//   h and x loads at the start and draws its mask while they are in
//   flight: a bf16 chunk of 8 starts on a flat index that is a multiple of
//   8, so it is exactly two Philox groups, each drawn once, and a float32
//   chunk one. s leaves as 16-byte stores as soon as it is formed; then
//   scale and bias are issued as float4 (h, x, scale and bias held at once
//   spill at 32 values a thread), ahead of the reductions (the mean, then
//   the centred variance, in layer_norm.cu's order); y leaves after them.
//   Rate 0 compiles the mask out (DROP false).
//   Backward, one call, two passes launched back to back: the dx pass
//   (the LayerNorm dx pass's mapping; s, dy and scale issued together, the
//   mask drawn meanwhile, three reductions) writes dx, dh and each row's
//   (mean, rstd); the column pass (layer_norm_rows.cuh, under this
//   library's symbol dal_bwd_params_kernel) owns its columns over every
//   row. No partial rows, no second sum, no atomics: two runs give the
//   same bits.
//   Rows not 16-byte aligned (an odd storage offset, an H such as 1001)
//   take the same kernels with one element a chunk (VEC 1), each element
//   drawing its own Philox group.

#include "layer_norm_rows.cuh"
#include "philox.cuh"

namespace {

using pdt::kColumnThreads;
using pdt::kMaxRowWarps;
using pdt::kMaxSlots;
using pdt::kMaxThreads;
using pdt::load_pack;
using pdt::max_floats;
using pdt::Pack;
using pdt::row_sum;
using pdt::store_pack;
using pdt::unpack;

struct Dropout {
  uint32_t seed, site, threshold;
  float keep_scale;
};

// Keep bits of the VEC elements at flat indices i0, i0 + 1, ...: bit e for
// element i0 + e. With VEC 4 or 8, i0 is a multiple of VEC (rows 16-byte
// aligned, H a multiple of VEC), so the chunk is VEC / 4 whole Philox
// groups, each drawn once.
template <int VEC>
__device__ __forceinline__ uint32_t keep_bits(const Dropout& d, uint64_t i0) {
  if constexpr (VEC == 1) {
    pdt::PhiloxStream rng(d.seed, d.site);
    return rng.bits(i0) >= d.threshold ? 1u : 0u;
  } else {
    uint32_t m = 0;
#pragma unroll
    for (int g = 0; g < VEC / 4; ++g) {
      const pdt::Philox4 b = pdt::philox4x32_10((i0 >> 2) + g, d.seed,
                                                d.site);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m |= static_cast<uint32_t>(b.v[e] >= d.threshold) << (4 * g + e);
    }
    return m;
  }
}

// The thread's keep bits: bit c * VEC + i for element i of its chunk c
// (CPT * VEC <= 32, max_floats). One chunk at a time, so the registers of
// the Philox rounds do not pile up beside the loads in flight.
template <int VEC, int CPT>
__device__ __forceinline__ uint32_t thread_mask(const Dropout& d,
                                                size_t base, int t, int tpr,
                                                int n) {
  uint32_t m = 0;
#pragma unroll 1
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) m |= keep_bits<VEC>(d, base + k * VEC) << (c * VEC);
  }
  return m;
}

// ------------------------------------------------------------------ forward

template <typename T, typename Tout, int VEC, int CPT, bool DROP>
__global__ void __launch_bounds__(kMaxThreads)
dal_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
               const float* __restrict__ scale,
               const float* __restrict__ bias, Tout* __restrict__ y,
               T* __restrict__ s_out, int rows, int hdim, float eps,
               Dropout d, int wpr) {
  __shared__ float red[kMaxSlots][2][2 * kMaxRowWarps];
  const int tpr = wpr * 32;
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  if (row >= rows) return;  // the row's warps leave together
  const int n = hdim / VEC;
  const size_t base = static_cast<size_t>(row) * hdim;
  Pack<T, VEC> hp[CPT], xp[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      hp[c] = load_pack<T, VEC>(h + base + k * VEC);
      xp[c] = load_pack<T, VEC>(x + base + k * VEC);
    }
  }
  const uint32_t keep =
      DROP ? thread_mask<VEC, CPT>(d, base, t, tpr, n) : 0u;
  float v[CPT][VEC], sc[CPT][VEC], b[CPT][VEC];
  float sum[1] = {0.f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      float hv[VEC], xv[VEC];
      unpack(hp[c], hv);
      unpack(xp[c], xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (DROP)
          hv[i] = (keep >> (c * VEC + i)) & 1u
                      ? __fmul_rn(hv[i], d.keep_scale) : 0.f;
        v[c][i] = __fadd_rn(xv[i], hv[i]);
        sum[0] += v[c][i];
      }
      if (s_out != nullptr) store_pack<T, VEC>(s_out + base + k * VEC, v[c]);
    }
  }
  // scale and bias issued once h and x are spent (holding all four at once
  // spills at 32 values a thread), still ahead of the reductions
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      unpack(load_pack<float, VEC>(scale + k * VEC), sc[c]);
      unpack(load_pack<float, VEC>(bias + k * VEC), b[c]);
    }
  }
  row_sum(sum, red[slot][0], wpr, t >> 5, slot);
  const float fh = static_cast<float>(hdim);
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
      for (int i = 0; i < VEC; ++i)
        o[i] = v[c][i] * rstd * sc[c][i] + b[c][i];
      store_pack<Tout, VEC>(yr + k * VEC, o);
    }
  }
}

struct FwdArgs {
  const void *h, *x;
  const float *scale, *bias;
  void *y, *s_out;
  int rows, hdim;
  float eps;
  Dropout d;
  int wpr, slots, cpt;
};

// The smallest instantiated chunk count >= a.cpt (a power of two),
// launched.
template <typename T, typename Tout, int VEC, bool DROP, int CPT = 1>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (CPT * VEC > max_floats<VEC>()) {
    return cudaErrorInvalidValue;
  } else {
    if (a.cpt > CPT)
      return launch_fwd<T, Tout, VEC, DROP, 2 * CPT>(a, stream);
    dal_fwd_kernel<T, Tout, VEC, CPT, DROP>
        <<<(a.rows + a.slots - 1) / a.slots, a.slots * a.wpr * 32, 0,
           stream>>>(static_cast<const T*>(a.h), static_cast<const T*>(a.x),
                     a.scale, a.bias, static_cast<Tout*>(a.y),
                     static_cast<T*>(a.s_out), a.rows, a.hdim, a.eps, a.d,
                     a.wpr);
    return cudaGetLastError();
  }
}

template <typename T, typename Tout>
cudaError_t launch_fwd_vec(const FwdArgs& a, int vec, bool dropout,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return dropout ? launch_fwd<T, Tout, kVec, true>(a, stream)
                   : launch_fwd<T, Tout, kVec, false>(a, stream);
  return dropout ? launch_fwd<T, Tout, 1, true>(a, stream)
                 : launch_fwd<T, Tout, 1, false>(a, stream);
}

// ----------------------------------------------------------------- backward

// dx and dh of a row, and its (mean, rstd) for the column pass: the
// LayerNorm dx pass (layer_norm.cu) on s, with the forward's mask.
template <typename T, int VEC, int CPT, bool DROP>
__global__ void __launch_bounds__(kMaxThreads)
dal_bwd_dx_kernel(const T* __restrict__ s, const T* __restrict__ dy,
                  const float* __restrict__ scale, T* __restrict__ dh,
                  T* __restrict__ dx, float2* __restrict__ stats, int rows,
                  int hdim, float eps, Dropout d, int wpr) {
  __shared__ float red[kMaxSlots][3][2 * kMaxRowWarps];
  const int tpr = wpr * 32;
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int warp = t >> 5;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  if (row >= rows) return;  // the row's warps leave together
  const int n = hdim / VEC;
  const size_t base = static_cast<size_t>(row) * hdim;
  const float fh = static_cast<float>(hdim);
  float v[CPT][VEC], g[CPT][VEC], w[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      unpack(load_pack<T, VEC>(s + base + k * VEC), v[c]);
      unpack(load_pack<T, VEC>(dy + base + k * VEC), g[c]);
      unpack(load_pack<float, VEC>(scale + k * VEC), w[c]);
    }
  }
  const uint32_t keep =
      DROP ? thread_mask<VEC, CPT>(d, base, t, tpr, n) : 0u;
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
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = c * tpr + t;
    if (k < n) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = (g[c][i] - v[c][i] * c1 - c2) * rstd;
      store_pack<T, VEC>(dx + base + k * VEC, o);
      if constexpr (DROP) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          o[i] = (keep >> (c * VEC + i)) & 1u
                     ? __fmul_rn(o[i], d.keep_scale) : 0.f;
      }
      store_pack<T, VEC>(dh + base + k * VEC, o);
    }
  }
  if (t == 0) stats[row] = make_float2(mean, rstd);
}

// The column pass (layer_norm_rows.cuh), under a symbol of this library.
template <typename T, int VEC, int CB>
__global__ void __launch_bounds__(kColumnThreads)
dal_bwd_params_kernel(const T* __restrict__ s, const T* __restrict__ dy,
                      const float2* __restrict__ stats,
                      float* __restrict__ dscale, float* __restrict__ dbias,
                      int rows, int hdim) {
  pdt::column_pass<T, VEC, CB>(s, dy, stats, dscale, dbias, rows, hdim);
}

struct BwdArgs {
  const void *s, *dy;
  const float* scale;
  void *dh, *dx;
  float2* stats;
  float *dscale, *dbias;
  int rows, hdim;
  float eps;
  Dropout d;
  int wpr, slots, cpt;
};

template <typename T, int VEC, bool DROP, int CPT = 1>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  if constexpr (CPT * VEC > max_floats<VEC>()) {
    return cudaErrorInvalidValue;
  } else {
    if (a.cpt > CPT) return launch_bwd<T, VEC, DROP, 2 * CPT>(a, stream);
    const T* sp = static_cast<const T*>(a.s);
    const T* dyp = static_cast<const T*>(a.dy);
    dal_bwd_dx_kernel<T, VEC, CPT, DROP>
        <<<(a.rows + a.slots - 1) / a.slots, a.slots * a.wpr * 32, 0,
           stream>>>(sp, dyp, a.scale, static_cast<T*>(a.dh),
                     static_cast<T*>(a.dx), a.stats, a.rows, a.hdim, a.eps,
                     a.d, a.wpr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dal_bwd_params_kernel<T, VEC, pdt::column_chunks<VEC>()>
        <<<pdt::column_blocks<VEC>(a.hdim), kColumnThreads, 0, stream>>>(
            sp, dyp, a.stats, a.dscale, a.dbias, a.rows, a.hdim);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_bwd_vec(const BwdArgs& a, int vec, bool dropout,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return dropout ? launch_bwd<T, kVec, true>(a, stream)
                   : launch_bwd<T, kVec, false>(a, stream);
  return dropout ? launch_bwd<T, 1, true>(a, stream)
                 : launch_bwd<T, 1, false>(a, stream);
}

bool dtype_ok(int dtype) { return dtype == pdt::kBF16 || dtype == pdt::kF32; }

}  // namespace

// h, x [rows, hdim] (dtype), y [rows, hdim] (y_dtype), s_out [rows, hdim]
// (dtype) or null, scale/bias [hdim] float32. dropout = 0 skips the mask
// (rate 0). vec: elements a chunk (1, or 16 bytes of dtype); wpr: warps a
// row; slots: rows a block (slots * wpr <= 16). Returns the cudaError_t of
// the launch.
extern "C" int pdt_dal_fwd(const void* h, const void* x, const void* scale,
                           const void* bias, void* y, void* s_out, int rows,
                           int hdim, float eps, unsigned seed, unsigned site,
                           unsigned threshold, float keep_scale, int dropout,
                           int dtype, int y_dtype, int vec, int wpr,
                           int slots, void* stream) {
  FwdArgs a{h, x, static_cast<const float*>(scale),
            static_cast<const float*>(bias), y, s_out, rows, hdim, eps,
            Dropout{seed, site, threshold, keep_scale}, wpr, slots, 0};
  const int esize = dtype == pdt::kBF16 ? 2 : 4;
  if (!dtype_ok(dtype) || !dtype_ok(y_dtype) ||
      !pdt::check_plan(rows, hdim, esize, vec, wpr, slots, &a.cpt,
                       {h, x, y, s_out, scale, bias}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  cudaError_t err;
  if (dtype == pdt::kBF16 && y_dtype == pdt::kBF16)
    err = launch_fwd_vec<__nv_bfloat16, __nv_bfloat16>(a, vec, drop, st);
  else if (dtype == pdt::kBF16)
    err = launch_fwd_vec<__nv_bfloat16, float>(a, vec, drop, st);
  else if (y_dtype == pdt::kBF16)
    err = launch_fwd_vec<float, __nv_bfloat16>(a, vec, drop, st);
  else
    err = launch_fwd_vec<float, float>(a, vec, drop, st);
  return static_cast<int>(err);
}

// s, dy, dh, dx [rows, hdim] (dtype), scale [hdim] float32, stats [rows]
// float2 scratch (each row's mean and rstd, written by the dx pass and
// read by the column pass), dscale/dbias [hdim] float32. vec, wpr, slots:
// the dx pass's plan, as pdt_dal_fwd's. Launches the two passes on the
// stream; returns the cudaError_t of the launches.
extern "C" int pdt_dal_bwd(const void* s, const void* dy, const void* scale,
                           void* dh, void* dx, void* stats, void* dscale,
                           void* dbias, int rows, int hdim, float eps,
                           unsigned seed, unsigned site, unsigned threshold,
                           float keep_scale, int dropout, int dtype, int vec,
                           int wpr, int slots, void* stream) {
  BwdArgs a{s, dy, static_cast<const float*>(scale), dh, dx,
            static_cast<float2*>(stats), static_cast<float*>(dscale),
            static_cast<float*>(dbias), rows, hdim, eps,
            Dropout{seed, site, threshold, keep_scale}, wpr, slots, 0};
  const int esize = dtype == pdt::kBF16 ? 2 : 4;
  if (!dtype_ok(dtype) ||
      !pdt::check_plan(rows, hdim, esize, vec, wpr, slots, &a.cpt,
                       {s, dy, dh, dx, scale}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  const cudaError_t err =
      dtype == pdt::kBF16
          ? launch_bwd_vec<__nv_bfloat16>(a, vec, drop, st)
          : launch_bwd_vec<float>(a, vec, drop, st);
  return static_cast<int>(err);
}
