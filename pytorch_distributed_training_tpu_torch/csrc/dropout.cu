// Dropout for Hopper (sm_90a): the mask-scale tensor, and the mask applied
// to an activation in the same pass, in the port's three mask streams.
//
// Replaces the Pallas kernel _mask_scale_kernel of
// pytorch_distributed_training_tpu/ops/dropout.py (launched by
// _mask_scale_from_seed): element i is kept when bits(seed, site, i) >=
// threshold (philox.cuh; the threshold is ops/dropout.py mask_threshold),
// and its mask-scale is 1/(1-rate) rounded to float32 and then to the
// tensor's dtype, else 0. The JAX package's other streams ("bits8",
// "exact": ops/dropout.py raw_dropout, jax.random bits there) are drawn
// from the same Philox words, so each is a pure function of (seed, site,
// i) too. One template, four modes:
//   mask-only (pdt_mask_scale): writes the mask-scale tensor itself, the
//     TPU kernel's own function;
//   apply (pdt_dropout_apply; the "kernel" and "bits32" streams): reads x
//     and writes y = x * mask-scale, the product formed in float32 from x
//     and the mask-scale in x's dtype and rounded once to x's dtype, as
//     the plain `x * mask_scale` rounds it. A multiply, not a select: a
//     non-finite x stays non-finite where it is dropped (NaN * 0). The
//     port's dropout runs its forward and its backward (dy) through it, so
//     no mask-scale tensor is ever stored;
//   bits8 (pdt_dropout_bits8): element i keeps when byte i % 4 (little
//     endian) of word i / 4 is >= t, t = min(max(round(rate * 256), 1),
//     255), and is multiplied by 1/(1 - t/256) in x's dtype, as apply
//     multiplies. Word w is bits(seed, site, w), so one Philox block (four
//     words) covers sixteen elements: a quarter of apply's draws;
//   exact (pdt_dropout_exact): u = bitcast_f32((word >> 9) | 0x3F800000)
//     - 1, JAX's uniform from the same word as apply's; y = u < 1 - rate ?
//     x / (1 - rate) : 0, the divisor in x's dtype and the quotient
//     rounded once. A select: a NaN where it is dropped becomes 0.
//
// Bound: bytes. Mask-only writes 2 bytes an element in bf16 (4 in
// float32); the other modes read and write 4 (8). The mask's integer work,
// counted in the SASS of the bf16 main loop (nvcc 12.8), is 5.0
// instructions an element on the FMA-heavy pipe (IMAD.WIDE.U32: a Philox
// round is two a group of four, and the key schedule, a function of
// (seed, site) only, is hoisted out of the loop) and 7.0 on the ALU pipe
// (LOP3, the compare, the select) in mask-only, 5.75 and 7.75 in apply.
// At 64 results a clock per SM a pipe that is 0.88 and 0.97 us at
// [8, 16, 128, 128] on an H100 SXM at 1980 MHz, under the byte times of
// 1.25 and 2.50 us at 3.35 TB/s; but it is a dependent chain in each
// thread, so it must run while memory traffic is in flight. bits8 draws a
// quarter of the blocks and adds a shift and a byte mask an element;
// exact adds a shift, an or and a float subtract and compare, and a
// division in place of the multiply (chip_smoke.py counts both loops).
//
// Design: a thread owns 16-byte chunks, 8 bf16 or 4 float32. A chunk
// starts on a flat index that is a multiple of its length, so it is two
// whole Philox groups (bf16) or one (float32), each drawn once, and it
// leaves as one 16-byte store; bits8 takes units of 16 elements (two or
// four chunks), one Philox block each. The grid is one wave of resident
// blocks (occupancy of the instantiation times the SMs) walking the
// chunks with a grid stride, a chunk a thread an iteration (two, for two
// independent Philox chains, were no faster); a thread issues its x load
// before it draws the mask.
// Indices are 32-bit below 2^31 elements, 64-bit above. The ragged tail
// (n not a multiple of the chunk), and the whole tensor when x or y is not
// 16-byte aligned, take a scalar path in the same kernel: a group of four
// elements a thread (sixteen in bits8), one Philox block each.

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// the modes; all but kMaskOnly read x
enum Mode { kMaskOnly = 0, kApply = 1, kBits8 = 2, kExact = 3 };

struct Mask {
  uint32_t seed, site;
  uint32_t threshold;  // a 32-bit word (mask-only, apply) or a byte (bits8)
  float scale;  // the mask-scale in the tensor's dtype (the divisor: exact)
  float keep;   // exact: kept when the uniform is below it
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

// y of one element from its draw `word`: the mask-scale itself
// (mask-only), x times it (apply; bits8 passes its byte as the word), or
// exact's select of x / (1 - rate).
template <int MODE>
__device__ __forceinline__ float masked(const Mask& m, uint32_t word,
                                        float x) {
  if constexpr (MODE == kExact) {
    const float u = __uint_as_float((word >> 9) | 0x3F800000u) - 1.f;
    return u < m.keep ? __fdiv_rn(x, m.scale) : 0.f;
  } else {
    const float s = word >= m.threshold ? m.scale : 0.f;
    return MODE == kMaskOnly ? s : __fmul_rn(x, s);
  }
}

// byte e % 4 of word e / 4 of a Philox block: bits8's draw of element e of
// its sixteen
__device__ __forceinline__ uint32_t byte_of(const pdt::Philox4& b, int e) {
  return (b.v[e >> 2] >> (8 * (e & 3))) & 0xFFu;
}

template <typename T, typename Idx, int MODE>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, Idx n, Mask m) {
  using C = Chunk<T>;
  constexpr int VEC = C::kVec;
  constexpr bool READ = MODE != kMaskOnly;
  // elements a Philox block covers, and a unit of the vector path
  constexpr int PER_BLOCK = MODE == kBits8 ? 16 : 4;
  constexpr int UNIT = MODE == kBits8 ? 16 : VEC;
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  const Idx first = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(y) |
                         (READ ? reinterpret_cast<uintptr_t>(x) : 0);
  const Idx units = (addr & 15) == 0 ? n / UNIT : 0;
#pragma unroll 1
  for (Idx c = first; c < units; c += stride) {
    float v[UNIT];
    if constexpr (READ) {
#pragma unroll
      for (int p = 0; p < UNIT / VEC; ++p)
        C::unpack(*reinterpret_cast<const uint4*>(x + c * UNIT + p * VEC),
                  *reinterpret_cast<float(*)[VEC]>(v + p * VEC));
    }
#pragma unroll
    for (int g = 0; g < UNIT / PER_BLOCK; ++g) {
      const pdt::Philox4 b = pdt::philox4x32_10(
          static_cast<uint64_t>(c * (UNIT / PER_BLOCK) + g), m.seed, m.site);
#pragma unroll
      for (int e = 0; e < PER_BLOCK; ++e) {
        float& ve = v[PER_BLOCK * g + e];
        const uint32_t word = MODE == kBits8 ? byte_of(b, e) : b.v[e & 3];
        ve = masked<MODE>(m, word, READ ? ve : 0.f);
      }
    }
#pragma unroll
    for (int p = 0; p < UNIT / VEC; ++p)
      *reinterpret_cast<uint4*>(y + c * UNIT + p * VEC) =
          C::pack(*reinterpret_cast<const float(*)[VEC]>(v + p * VEC));
  }
  // scalar blocks (four elements, sixteen in bits8): the ragged tail, or
  // all of it when unaligned
  const Idx blocks = n / PER_BLOCK + (n % PER_BLOCK != 0);
#pragma unroll 1
  for (Idx g = units * (UNIT / PER_BLOCK) + first; g < blocks; g += stride) {
    const pdt::Philox4 b =
        pdt::philox4x32_10(static_cast<uint64_t>(g), m.seed, m.site);
#pragma unroll
    for (int e = 0; e < PER_BLOCK; ++e) {
      const Idx i = g * PER_BLOCK + e;
      if (i < n) {
        const uint32_t word = MODE == kBits8 ? byte_of(b, e) : b.v[e & 3];
        y[i] = pdt::from_f32<T>(masked<MODE>(
            m, word, READ ? pdt::to_f32<T>(x[i]) : 0.f));
      }
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

template <typename T, typename Idx, int MODE>
cudaError_t launch(const void* x, void* y, long long n, const Mask& m,
                   cudaStream_t stream) {
  auto kernel = dropout_kernel<T, Idx, MODE>;
  static int wave[64] = {};  // this instantiation's wave, per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return cudaErrorInvalidDevice;
  if (wave[dev] == 0) wave[dev] = wave_blocks(kernel, dev);
  if (wave[dev] == 0) return cudaErrorInvalidDevice;
  const long long unit = MODE == kBits8 ? 16 : Chunk<T>::kVec;
  const long long per_block = MODE == kBits8 ? 16 : 4;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(y) |
        (MODE != kMaskOnly ? reinterpret_cast<uintptr_t>(x) : 0)) & 15) == 0;
  const long long work = aligned ? n / unit + (n % unit != 0)
                                 : (n + per_block - 1) / per_block;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < wave[dev] ? want : wave[dev]);
  dropout_kernel<T, Idx, MODE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<Idx>(n), m);
  return cudaGetLastError();
}

// 32-bit indices below 2^31 elements, 64-bit above
template <typename T, int MODE>
cudaError_t launch_width(const void* x, void* y, long long n, const Mask& m,
                         cudaStream_t stream) {
  return n < (1ll << 31) ? launch<T, uint32_t, MODE>(x, y, n, m, stream)
                         : launch<T, uint64_t, MODE>(x, y, n, m, stream);
}

template <int MODE>
int run(const void* x, void* y, long long n, const Mask& m, int dtype,
        void* stream) {
  if (n <= 0 || y == nullptr || (MODE != kMaskOnly && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pdt::kBF16)
    return static_cast<int>(
        launch_width<__nv_bfloat16, MODE>(x, y, n, m, st));
  if (dtype == pdt::kF32)
    return static_cast<int>(launch_width<float, MODE>(x, y, n, m, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out [n] = the mask-scale (float32 or bfloat16, by dtype); `scale` is
// the mask-scale in that dtype. Returns the cudaError_t of the launch.
extern "C" int pdt_mask_scale(void* out, long long n, unsigned seed,
                              unsigned site, unsigned threshold, float scale,
                              int dtype, void* stream) {
  return run<kMaskOnly>(nullptr, out, n, Mask{seed, site, threshold, scale,
                                               0.f},
                        dtype, stream);
}

// y [n] = x [n] * the mask-scale, both of dtype.
extern "C" int pdt_dropout_apply(const void* x, void* y, long long n,
                                 unsigned seed, unsigned site,
                                 unsigned threshold, float scale, int dtype,
                                 void* stream) {
  return run<kApply>(x, y, n, Mask{seed, site, threshold, scale, 0.f},
                     dtype, stream);
}

// y [n] = x [n] * bits8's mask-scale: `threshold` the byte t, `scale`
// 1/(1 - t/256) in x's dtype.
extern "C" int pdt_dropout_bits8(const void* x, void* y, long long n,
                                 unsigned seed, unsigned site,
                                 unsigned threshold, float scale, int dtype,
                                 void* stream) {
  return run<kBits8>(x, y, n, Mask{seed, site, threshold, scale, 0.f},
                     dtype, stream);
}

// y [n] = exact's select: x [n] / `divisor` (1 - rate in x's dtype) where
// the uniform is below `keep` (1 - rate in float32), else 0.
extern "C" int pdt_dropout_exact(const void* x, void* y, long long n,
                                 unsigned seed, unsigned site, float keep,
                                 float divisor, int dtype, void* stream) {
  return run<kExact>(x, y, n, Mask{seed, site, 0u, divisor, keep}, dtype,
                     stream);
}
