// Dropout for Hopper (sm_90a): the mask-scale tensor, and the mask applied
// to an activation in the same pass.
//
// Replaces the Pallas kernel _mask_scale_kernel of
// pytorch_distributed_training_tpu/ops/dropout.py (launched by
// _mask_scale_from_seed): element i is kept when bits(seed, site, i) >=
// threshold (philox.cuh; the threshold is ops/dropout.py mask_threshold),
// and its mask-scale is 1/(1-rate) rounded to float32 and then to the
// tensor's dtype, else 0. One template, two modes:
//   mask-only (pdt_mask_scale): writes the mask-scale tensor itself, the
//     TPU kernel's own function;
//   apply (pdt_dropout_apply): reads x and writes y = x * mask-scale, the
//     product formed in float32 from x and the mask-scale in x's dtype and
//     rounded once to x's dtype, as the plain `x * mask_scale` rounds it.
//     A multiply, not a select: a non-finite x stays non-finite where it
//     is dropped (NaN * 0). The port's dropout runs its forward and its
//     backward (dy) through it, so no mask-scale tensor is ever stored.
//
// Bound: bytes. Mask-only writes 2 bytes an element in bf16 (4 in
// float32); apply reads and writes 4 (8). The mask's integer work, counted
// in the SASS of the bf16 main loop (nvcc 12.8), is 5.0 instructions an
// element on the FMA-heavy pipe (IMAD.WIDE.U32: a Philox round is two a
// group of four, and the key schedule, a function of (seed, site) only,
// is hoisted out of the loop) and 7.0 on the ALU pipe (LOP3, the compare,
// the select) in mask-only, 5.75 and 7.75 in apply. At 64 results a clock
// per SM a pipe that is 0.88 and 0.97 us at [8, 16, 128, 128] on an H100
// SXM at 1980 MHz, under the byte times of 1.25 and 2.50 us at 3.35 TB/s;
// but it is a dependent chain in each thread, so it must run while memory
// traffic is in flight.
//
// Design: a thread owns 16-byte chunks, 8 bf16 or 4 float32. A chunk
// starts on a flat index that is a multiple of its length, so it is two
// whole Philox groups (bf16) or one (float32), each drawn once, and it
// leaves as one 16-byte store. The grid is one wave of resident blocks
// (occupancy of the instantiation times the SMs) walking the chunks with
// a grid stride, a chunk a thread an iteration (two, for two independent
// Philox chains, were no faster); in apply mode a thread issues its x
// load before it draws the mask.
// Indices are 32-bit below 2^31 elements, 64-bit above. The ragged tail
// (n not a multiple of the chunk), and the whole tensor when x or y is not
// 16-byte aligned, take a scalar path in the same kernel: a group of four
// elements a thread, one Philox block each.

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

struct Mask {
  uint32_t seed, site, threshold;
  float scale;  // the mask-scale in the tensor's dtype, as a float
};

// A 16-byte chunk as floats, and back (round to nearest even).
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void split(uint32_t w, float& lo,
                                               float& hi) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xFFFF0000u);
  }
  static __device__ __forceinline__ uint32_t join(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in .x
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    split(u.x, f[0], f[1]);
    split(u.y, f[2], f[3]);
    split(u.z, f[4], f[5]);
    split(u.w, f[6], f[7]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(join(f[0], f[1]), join(f[2], f[3]), join(f[4], f[5]),
                      join(f[6], f[7]));
  }
};

// The mask-scale of element `word`'s draw, and y: x times it (apply) or
// the mask-scale itself.
template <bool APPLY>
__device__ __forceinline__ float masked(const Mask& m, uint32_t word,
                                        float x) {
  const float s = word >= m.threshold ? m.scale : 0.f;
  return APPLY ? __fmul_rn(x, s) : s;
}

template <typename T, typename Idx, bool APPLY>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, Idx n, Mask m) {
  using C = Chunk<T>;
  constexpr int VEC = C::kVec;
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  const Idx first = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(y) |
                         (APPLY ? reinterpret_cast<uintptr_t>(x) : 0);
  const Idx chunks = (addr & 15) == 0 ? n / VEC : 0;
#pragma unroll 1
  for (Idx c = first; c < chunks; c += stride) {
    float v[VEC];
    if constexpr (APPLY)
      C::unpack(*reinterpret_cast<const uint4*>(x + c * VEC), v);
#pragma unroll
    for (int g = 0; g < VEC / 4; ++g) {
      const pdt::Philox4 b = pdt::philox4x32_10(
          static_cast<uint64_t>(c * (VEC / 4) + g), m.seed, m.site);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& ve = v[4 * g + e];
        ve = masked<APPLY>(m, b.v[e], APPLY ? ve : 0.f);
      }
    }
    *reinterpret_cast<uint4*>(y + c * VEC) = C::pack(v);
  }
  // scalar groups of four: the ragged tail, or all of it when unaligned
  const Idx groups = n / 4 + (n % 4 != 0);
#pragma unroll 1
  for (Idx g = chunks * (VEC / 4) + first; g < groups; g += stride) {
    const pdt::Philox4 b =
        pdt::philox4x32_10(static_cast<uint64_t>(g), m.seed, m.site);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Idx i = g * 4 + e;
      if (i < n)
        y[i] = pdt::from_f32<T>(masked<APPLY>(
            m, b.v[e], APPLY ? pdt::to_f32<T>(x[i]) : 0.f));
    }
  }
}

// Blocks of one wave of `kernel` on device `dev`: its resident blocks an
// SM times the SMs (0 on an error).
template <typename K>
int wave_blocks(K kernel, int dev) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, typename Idx, bool APPLY>
cudaError_t launch(const void* x, void* y, long long n, const Mask& m,
                   cudaStream_t stream) {
  auto kernel = dropout_kernel<T, Idx, APPLY>;
  static int wave[64] = {};  // this instantiation's wave, per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return cudaErrorInvalidDevice;
  if (wave[dev] == 0) wave[dev] = wave_blocks(kernel, dev);
  if (wave[dev] == 0) return cudaErrorInvalidDevice;
  constexpr int VEC = Chunk<T>::kVec;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(y) |
        (APPLY ? reinterpret_cast<uintptr_t>(x) : 0)) & 15) == 0;
  const long long work = aligned ? n / VEC + (n % VEC != 0) : (n + 3) / 4;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < wave[dev] ? want : wave[dev]);
  dropout_kernel<T, Idx, APPLY><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<Idx>(n), m);
  return cudaGetLastError();
}

// 32-bit indices below 2^31 elements, 64-bit above
template <typename T, bool APPLY>
cudaError_t launch_width(const void* x, void* y, long long n, const Mask& m,
                         cudaStream_t stream) {
  return n < (1ll << 31) ? launch<T, uint32_t, APPLY>(x, y, n, m, stream)
                         : launch<T, uint64_t, APPLY>(x, y, n, m, stream);
}

template <bool APPLY>
int run(const void* x, void* y, long long n, unsigned seed, unsigned site,
        unsigned threshold, float scale, int dtype, void* stream) {
  if (n <= 0 || y == nullptr || (APPLY && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask m{seed, site, threshold, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pdt::kBF16)
    return static_cast<int>(
        launch_width<__nv_bfloat16, APPLY>(x, y, n, m, st));
  if (dtype == pdt::kF32)
    return static_cast<int>(launch_width<float, APPLY>(x, y, n, m, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out [n] = the mask-scale (float32 or bfloat16, by dtype); `scale` is
// the mask-scale in that dtype. Returns the cudaError_t of the launch.
extern "C" int pdt_mask_scale(void* out, long long n, unsigned seed,
                              unsigned site, unsigned threshold, float scale,
                              int dtype, void* stream) {
  return run<false>(nullptr, out, n, seed, site, threshold, scale, dtype,
                    stream);
}

// y [n] = x [n] * the mask-scale, both of dtype.
extern "C" int pdt_dropout_apply(const void* x, void* y, long long n,
                                 unsigned seed, unsigned site,
                                 unsigned threshold, float scale, int dtype,
                                 void* stream) {
  return run<true>(x, y, n, seed, site, threshold, scale, dtype, stream);
}
