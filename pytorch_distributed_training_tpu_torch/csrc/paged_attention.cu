// Paged decode attention for Hopper (sm_90a): one query token per
// sequence, K/V read in place through a block table.
//
// Replaces the Pallas kernel _paged_kernel of
// pytorch_distributed_training_tpu/ops/paged_attention.py:238 (launched by
// _paged_pallas, 3-D q), float pools and its quantized branch (int8 pools,
// :250-255 and :274-277): for each (batch b, head h),
//   out = softmax(q . K[:len] * scale) @ V[:len]
// where token t of sequence b lives at page block_table[b, t / P], offset
// t % P of the [num_pages, P, heads, head_dim] pools. Positions at or past
// lengths[b] are masked; pages wholly past the length are never read (the
// TPU kernel's pl.when skip). The gather never happens in device memory.
//
// Bound: bytes. Each visible K and V row is read once, two multiply-adds
// an element: 0.000823 ms for the 2.72 MB of the serve decode tick (8
// sequences of 17-152 tokens, 16 heads of 64, bf16). At such sizes the
// kernel is bound by latency long before bytes: a few dependent trips to
// memory, and the instructions of the longest row, set its time. The
// design cuts the trips and spreads the instructions over many warps.
// - One block of kWarps warps per (b, h), grid (batch, heads): at the
//   serve shape 128 blocks and 2048 warps, where one warp per (b, h) gave
//   128.
// - Lanes lie along head_dim. A lane loads VEC consecutive elements of a
//   row as one 16-byte load (8 bf16, 4 float32 or 16 int8); G lanes cover
//   a row (NV loads each when one pass of G = 32 lanes is not enough), so
//   a warp load covers 32 / G tokens. Each group of G lanes scores its own
//   token with xor-shuffles inside the group.
// - Tokens go to warps in steps of kBlockTok: warp w takes the kU loads of
//   32 / G consecutive tokens from base + w * kWarpTok each step, and
//   issues all their K and V loads (and int8 scales) before it scores any
//   of them. The block-table entries of the next step load while this one
//   computes (the first step's before the length is known: the row always
//   has `windows` entries, and no page is read on their account).
// - Each group keeps its own online softmax (m, l, acc) in float32
//   registers, acc over the lane's own columns; V is loaded in K's layout.
//   A group with no visible token holds (-inf, 0, 0), and a merge weighs
//   such a state by an exact 0 without forming (-inf) - (-inf).
// - The groups of a warp merge by xor-shuffles, the warps in shared memory
//   in warp order: m = max m_w, l = sum l_w e^(m_w - m), acc likewise,
//   out = acc / l. One launch a call, no atomics: two calls give the same
//   bits. A sequence of length 0 gives zeros (the TPU kernel's l > 0
//   select).
// A head_dim whose row is not a multiple of 16 bytes, or pools not aligned
// to 16 bytes, take the same kernel with VEC = 1: G = 32 lanes, scalar
// loads, lane i owning columns i, i + 32, ... q is float32 in registers.
// The tensor cores have no role with one query row.
//
// int8 pools (pdt_paged_attention_decode_int8): K and V int8 beside fp32
// scale pools [num_pages, P, heads], one scale per (token, head); q
// float32 or bfloat16, output float32 (the TPU kernel's dequantized compute
// dtype). The TPU kernel dequantizes each element, page.astype(f32) *
// scale; here a token's score is (sum_d q_d k_d) * ks and its V row is
// weighed by p * vs: one multiply a token in place of one an element, the
// same float32 arithmetic in another order. The pools' bytes fall to
// D + 4 a (token, head) from 2 D (bf16).

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;         // warps a block, one block per (b, h)
constexpr int kLoads = 4;          // K (and V) loads a lane issues a step
constexpr int kMaxHeadDim = 256;

template <typename T>
__device__ __forceinline__ float as_f32(T x) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return static_cast<float>(x);
  } else {
    return pdt::to_f32(x);
  }
}

// VEC consecutive elements of a row, loaded as VEC scalars; elem(e) gives
// element e in float32
template <typename T, int VEC, bool kWide = VEC * sizeof(T) == 16>
struct Chunk {
  T v[VEC];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[e];
  }
  __device__ __forceinline__ float elem(int e) const { return as_f32(v[e]); }
};

// the same as one 16-byte load (ld.global.nc.v4), unpacked in registers
template <typename T, int VEC>
struct Chunk<T, VEC, true> {
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float elem(int e) const {
    constexpr int kPer = 4 / sizeof(T);  // elements a 32-bit word
    const int i = e / kPer;
    const unsigned w = i == 0 ? raw.x : i == 1 ? raw.y : i == 2 ? raw.z
                                                                : raw.w;
    const int k = e % kPer;
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(w);
    } else if constexpr (std::is_same<T, int8_t>::value) {
      // byte k, sign-extended
      return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
    } else {
      return __bfloat162float(
          __ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * k))));
    }
  }
};

// TQ: q's type; TKV: the pools' (int8 pools carry k_scales/v_scales, else
// those are null and unread); TO: the output's. VEC elements a load, G
// lanes a token, NV loads a lane a row (see the note above).
template <typename TQ, typename TKV, typename TO, int VEC, int G, int NV>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q,            // [B, H, D]
                    const TKV* __restrict__ k_pages,     // [N, P, H, D]
                    const TKV* __restrict__ v_pages,     // [N, P, H, D]
                    const float* __restrict__ k_scales,  // [N, P, H] or null
                    const float* __restrict__ v_scales,  // [N, P, H] or null
                    const int* __restrict__ block_table, // [B, W]
                    const int* __restrict__ lengths,     // [B]
                    TO* __restrict__ out,                // [B, H, D]
                    int heads, int head_dim, int page_size,
                    int page_shift, int windows, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kTpw = 32 / G;                  // tokens a warp load
  constexpr int kU = kLoads / NV > 0 ? kLoads / NV : 1;  // tokens a group
  constexpr int kWarpTok = kU * kTpw;           // a warp's, a step
  constexpr int kBlockTok = kWarps * kWarpTok;  // the block's, a step
  constexpr int kE = NV * VEC;                  // columns a lane
  __shared__ float acc_s[kWarps][kMaxHeadDim];
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float wt_s[kWarps];                // the warps' merge weights

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;   // the token of a warp load this lane serves
  const int lg = lane % G;    // this lane's place along the row
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int D = head_dim;
  const int* bt = block_table + static_cast<size_t>(b) * windows;
  const int tokens = windows * page_size;
  // token t lies on page entry t / P at offset t % P (shifts for P = 2^k)
  auto window_of = [&](int t) {
    return page_shift >= 0 ? t >> page_shift : t / page_size;
  };

  // first step's pages, before the length is known (in-row reads only)
  int page[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = warp * kWarpTok + u * kTpw + grp;
    page[u] = t < tokens ? __ldg(bt + window_of(t)) : 0;
  }
  const int len = min(__ldg(lengths + b), tokens);

  // q in float32 registers: lane lg owns columns (j * G + lg) * VEC + e
  const TQ* qr = q + (static_cast<size_t>(b) * heads + h) * D;
  bool act[NV];
  float qf[kE];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int d0 = (j * G + lg) * VEC;
    act[j] = d0 < D;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qf[j * VEC + e] = act[j] ? pdt::to_f32(qr[d0 + e]) : 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) acc[i] = 0.f;

  for (int base = warp * kWarpTok; base < len; base += kBlockTok) {
    // issue every load of the step: K, V rows and the int8 scales
    Chunk<TKV, VEC> kc[kU][NV];
    Chunk<TKV, VEC> vc[kU][NV];
    float ksc[kU];
    float vsc[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + u * kTpw + grp;
      ok[u] = t < len;
      ksc[u] = vsc[u] = 1.f;
      if (ok[u]) {
        const int w = window_of(t);
        const size_t slot =  // (page, offset, h) in the scale pools
            (static_cast<size_t>(page[u]) * page_size + (t - w * page_size)) *
                heads + h;
        const TKV* kr = k_pages + slot * D;
        const TKV* vr = v_pages + slot * D;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (act[j]) {
            kc[u][j].load(kr + (j * G + lg) * VEC);
            vc[u][j].load(vr + (j * G + lg) * VEC);
          }
        }
        if constexpr (kQuant) {
          ksc[u] = __ldg(k_scales + slot);
          vsc[u] = __ldg(v_scales + slot);
        }
      }
      // the next step's page, in flight while this one computes
      const int tn = t + kBlockTok;
      page[u] = tn < len ? __ldg(bt + window_of(tn)) : 0;
    }

    // scores: the lane's partial dot, summed over the group's G lanes
    float s[kU];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float part = 0.f;
      if (ok[u]) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (act[j]) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part = fmaf(qf[j * VEC + e], kc[u][j].elem(e), part);
          }
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      s[u] = ok[u] ? (kQuant ? part * ksc[u] : part) * scale : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }

    // the group's online softmax step; a group with no visible token in
    // this step (m_new still -inf) leaves its state alone
    if (m_new != -INFINITY) {
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kE; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u] - m_new);
        l += p;
        const float pv = kQuant ? p * vsc[u] : p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (act[j]) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j * VEC + e] =
                  fmaf(pv, vc[u][j].elem(e), acc[j * VEC + e]);
          }
        }
      }
      m = m_new;
    }
  }

  // merge the warp's groups: xor-shuffles over the group bits of the lane
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo);
    const float wa = m == -INFINITY ? 0.f : expf(m - mn);
    const float wb = mo == -INFINITY ? 0.f : expf(mo - mn);
    l = l * wa + lo * wb;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[i], o);
      acc[i] = acc[i] * wa + ao * wb;
    }
    m = mn;
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (act[j]) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc_s[warp][(j * G + lg) * VEC + e] = acc[j * VEC + e];
      }
    }
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps in warp order and write the row once
  if (threadIdx.x < kWarps) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    const float mw = m_s[threadIdx.x];
    wt_s[threadIdx.x] = mw == -INFINITY ? 0.f : expf(mw - mx);
  }
  __syncthreads();
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) lsum += l_s[w] * wt_s[w];
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  TO* o = out + (static_cast<size_t>(b) * heads + h) * D;
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += acc_s[w][d] * wt_s[w];
    o[d] = pdt::from_f32<TO>(a * inv);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* lengths;
  void* out;
  int batch, heads, head_dim, page_size, windows;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, typename TO, int VEC, int G, int NV>
cudaError_t go(const Args& a) {
  int shift = -1;  // log2 of the page size, when it is a power of 2
  if ((a.page_size & (a.page_size - 1)) == 0)
    for (shift = 0; (1 << shift) < a.page_size; ++shift) {
    }
  paged_decode_kernel<TQ, TKV, TO, VEC, G, NV>
      <<<dim3(a.batch, a.heads), dim3(kWarps * 32), 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.lengths,
          static_cast<TO*>(a.out), a.heads, a.head_dim, a.page_size, shift,
          a.windows, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch(const Args& a) {
  constexpr int kVec = 16 / sizeof(TKV);  // elements in 16 bytes
  const bool vec =
      a.head_dim % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) %
              16 == 0;
  if (vec) {  // G = the row's 16-byte pieces, to a power of 2
    const int n = a.head_dim / kVec;
    if (n <= 1) return go<TQ, TKV, TO, kVec, 1, 1>(a);
    if (n <= 2) return go<TQ, TKV, TO, kVec, 2, 1>(a);
    if (n <= 4) return go<TQ, TKV, TO, kVec, 4, 1>(a);
    if (n <= 8) return go<TQ, TKV, TO, kVec, 8, 1>(a);
    if (n <= 16) return go<TQ, TKV, TO, kVec, 16, 1>(a);
    if constexpr (kVec <= 8) {
      if (n <= 32) return go<TQ, TKV, TO, kVec, 32, 1>(a);
    }
    if constexpr (kVec == 4) {
      if (n <= 64) return go<TQ, TKV, TO, kVec, 32, 2>(a);
    }
  } else {  // scalar loads, one warp a row: lane i owns i, i + 32, ...
    if (a.head_dim <= 32) return go<TQ, TKV, TO, 1, 32, 1>(a);
    if (a.head_dim <= 64) return go<TQ, TKV, TO, 1, 32, 2>(a);
    if (a.head_dim <= 128) return go<TQ, TKV, TO, 1, 32, 4>(a);
    if (a.head_dim <= kMaxHeadDim) return go<TQ, TKV, TO, 1, 32, 8>(a);
  }
  return cudaErrorInvalidValue;  // head_dim > 256: the wrapper refuses it
}

bool bad_dims(int batch, int heads, int head_dim, int page_size,
              int windows) {
  return batch <= 0 || heads <= 0 || head_dim <= 0 || page_size <= 0 ||
         windows <= 0;
}

}  // namespace

// q [batch, heads, head_dim]; k_pages/v_pages [num_pages, page_size, heads,
// head_dim], all of one dtype (float32 or bfloat16, by dtype); block_table
// [batch, windows] int32; lengths [batch] int32; out like q. Returns the
// cudaError_t of the launch.
extern "C" int pdt_paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int batch,
    int heads, int head_dim, int page_size, int windows, float scale,
    int dtype, void* stream) {
  if (bad_dims(batch, heads, head_dim, page_size, windows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(lengths), out, batch, heads,
               head_dim, page_size, windows, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(a);
  else if (dtype == pdt::kF32)
    err = launch<float, float, float>(a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// int8 pools: k_pages/v_pages int8 [num_pages, page_size, heads, head_dim]
// with float32 k_scales/v_scales [num_pages, page_size, heads]; q float32
// or bfloat16 (by q_dtype); out float32 [batch, heads, head_dim]. The rest
// as pdt_paged_attention_decode.
extern "C" int pdt_paged_attention_decode_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, void* out, int batch, int heads, int head_dim,
    int page_size, int windows, float scale, int q_dtype, void* stream) {
  if (bad_dims(batch, heads, head_dim, page_size, windows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_table),
               static_cast<const int*>(lengths), out, batch, heads,
               head_dim, page_size, windows, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (q_dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, int8_t, float>(a);
  else if (q_dtype == pdt::kF32)
    err = launch<float, int8_t, float>(a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
