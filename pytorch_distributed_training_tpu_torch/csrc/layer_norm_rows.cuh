// Row machinery shared by the LayerNorm kernels (layer_norm.cu) and the
// dropout-add-LayerNorm kernels (dropout_add_layer_norm.cu): rows held as
// 16-byte chunks, the sums over a row's warps, the launch plan's checks,
// and the backward's column pass.
//
// Row mapping. A row belongs to `wpr` warps (32 * wpr threads); thread t
// of the row takes chunks t, t + 32 * wpr, ... of VEC elements: 16 bytes
// (8 bf16 or 4 float32) when every row starts on a 16-byte boundary, else
// one element (VEC 1). A block holds `slots` rows. The wrappers pick
// (vec, wpr, slots) from the shape and the pointers alone
// (ops/layer_norm.py _vec, _row_plan).
//
// Column pass. dscale = sum(dy * xhat) and dbias = sum(dy) over the rows,
// from x (or s), dy and each row's (mean, rstd) that a dx pass wrote: a
// block owns two 16-byte chunks of columns (32 single columns on the
// scalar path) over every row, so no sum crosses blocks and nothing is
// atomic. Each sum's order is fixed by the shape, so two runs give the
// same bits.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace pdt {

// Widest row the LayerNorm kernels take (ops/layer_norm.py _MAX_H).
constexpr int kMaxRowWidth = 2048;
constexpr int kMaxThreads = 512;   // a row pass's block: at most 16 warps
constexpr int kMaxSlots = kMaxThreads / 32;
constexpr int kMaxRowWarps = 16;   // warps a row
// the column pass: threads a block, and 16-byte chunks a block (32 single
// columns on the scalar path)
constexpr int kColumnThreads = 512;
template <int VEC>
constexpr int column_chunks() { return VEC == 1 ? 32 : 2; }

// Values of a row a thread holds (in a backward's dx pass, of each of its
// inputs), at most: the instantiations that stay within 128 registers
// unspilled.
template <int VEC>
constexpr int max_floats() { return VEC == 8 ? 32 : 16; }

// VEC elements of T, aligned for one 16-byte access (two for 8 float32)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Pack<T, VEC>& p,
                                       float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(p.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Named barrier of one row's warps (barrier 0 is __syncthreads').
__device__ __forceinline__ void row_barrier(int slot, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + slot), "r"(threads) : "memory");
}

// Sums each v[i] over the row's threads and leaves the same bits in all of
// them: a warp's lanes by xor-butterfly, then, with several warps a row,
// the warps' sums in warp order through red[i * kMaxRowWarps + warp]. Each
// reduction round of a row has a red area of its own, so a warp that runs
// ahead into the next round never overwrites sums still being read.
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], float* red, int wpr,
                                        int warp, int slot) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (wpr == 1) return;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * kMaxRowWarps + warp] = v[i];
  }
  row_barrier(slot, wpr * 32);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < wpr; ++w) s += red[i * kMaxRowWarps + w];
    v[i] = s;
  }
}

// The column pass's body, for a __global__ wrapper of each library (so a
// profile tells the two backwards apart): dscale and dbias of CB chunks
// of columns over every row. Thread (group, j) takes chunk j of rows
// group, group + groups, ... in order, with xhat = (x - mean) * rstd
// recomputed as the dx pass formed it; then the groups of a warp by
// xor-butterfly and the warps in warp order. Launch with kColumnThreads
// threads and column_blocks<VEC>(h) blocks.
template <typename T, int VEC, int CB>
__device__ __forceinline__ void column_pass(const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            const float2* __restrict__ stats,
                                            float* __restrict__ dscale,
                                            float* __restrict__ dbias,
                                            int rows, int h) {
  __shared__ float red[kColumnThreads / 32][CB][2][VEC];
  const int j = threadIdx.x % CB;
  const int group = threadIdx.x / CB;
  const int groups = blockDim.x / CB;
  const int n = h / VEC;
  const int k = blockIdx.x * CB + j;
  float ps[VEC], pb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) ps[i] = pb[i] = 0.f;
  if (k < n) {
    const size_t step = static_cast<size_t>(groups) * h;
    const T* xp = x + static_cast<size_t>(group) * h + k * VEC;
    const T* gp = dy + static_cast<size_t>(group) * h + k * VEC;
#pragma unroll 4
    for (int r = group; r < rows; r += groups, xp += step, gp += step) {
      float xv[VEC], gv[VEC];
      unpack(load_pack<T, VEC>(xp), xv);
      unpack(load_pack<T, VEC>(gp), gv);
      const float2 s = stats[r];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - s.x) * s.y;
        ps[i] += gv[i] * xhat;
        pb[i] += gv[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
#pragma unroll
    for (int o = 16; o >= CB; o >>= 1) {
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], o);
      pb[i] += __shfl_xor_sync(0xffffffffu, pb[i], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane < CB) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[warp][lane][0][i] = ps[i];
      red[warp][lane][1][i] = pb[i];
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < CB * VEC) {
    const int jj = threadIdx.x / VEC;
    const int i = threadIdx.x % VEC;
    const int kk = blockIdx.x * CB + jj;
    if (kk < n) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kColumnThreads / 32; ++w) {
        a += red[w][jj][0][i];
        b += red[w][jj][1][i];
      }
      dscale[kk * VEC + i] = a;
      dbias[kk * VEC + i] = b;
    }
  }
}

// Blocks of a column-pass launch over rows of h elements.
template <int VEC>
inline int column_blocks(int h) {
  return (h / VEC + column_chunks<VEC>() - 1) / column_chunks<VEC>();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Checks what the row kernels take: vec (elements a chunk) 1, or 16
// bytes of the element with every row 16-byte aligned; wpr a power of two
// up to kMaxRowWarps; slots rows a block within kMaxSlots warps; the
// chunks a thread (returned in *cpt).
inline bool check_plan(int rows, int h, int esize, int vec, int wpr,
                       int slots, int* cpt,
                       std::initializer_list<const void*> ptrs) {
  if (rows <= 0 || h <= 0 || h > kMaxRowWidth) return false;
  if (wpr <= 0 || wpr > kMaxRowWarps || (wpr & (wpr - 1)) != 0) return false;
  if (slots <= 0 || slots * wpr > kMaxSlots) return false;
  if (vec != 1) {
    if (vec * esize != 16 || h % vec != 0) return false;
    for (const void* p : ptrs)
      if (!aligned16(p)) return false;
  }
  const int n = h / vec;
  *cpt = (n + 32 * wpr - 1) / (32 * wpr);
  return true;
}

}  // namespace pdt
