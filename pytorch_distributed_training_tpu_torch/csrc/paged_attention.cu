// Paged decode attention for Hopper (sm_90a): one query token per
// sequence, K/V read in place through a block table.
//
// Replaces the Pallas kernel _paged_kernel of
// pytorch_distributed_training_tpu/ops/paged_attention.py (launched by
// _paged_pallas, 3-D q), float pools and its quantized branch (int8 pools,
// :250-255 and :274-277): for each (batch b, head h),
//   out = softmax(q . K[:len] * scale) @ V[:len]
// where token t of sequence b lives at page block_table[b, t / P], offset
// t % P of the [num_pages, P, heads, head_dim] pools. Positions at or past
// lengths[b] are masked; pages wholly past the length are never read (the
// TPU kernel's pl.when skip). The gather never happens in device memory.
//
// Bound: bytes. Each visible K and V row is read once; two multiply-adds
// per element of each. Design: one warp per (b, h), four heads per block,
// grid (batch, ceil(heads / 4)). q sits in shared memory as float32. The
// warp walks the sequence 32 tokens at a time: lane i scores token
// base + i (a dot product over head_dim in float32), the warp reduces the
// chunk max and sum with shuffles and rescales its running (m, l, acc) as
// an online softmax, all in float32 registers; for P @ V each lane owns
// head_dim / 32 output columns and the warp reads each V row once,
// coalesced across lanes. The result acc / l is written once in the pool
// dtype. Idle sequences (length 1 on the null page 0) cost one token.
//
// int8 pools (pdt_paged_attention_decode_int8): K and V int8 beside fp32
// scale pools [num_pages, P, heads], one scale per (token, head); q
// float32 or bfloat16, output float32 (the TPU kernel's dequantized compute
// dtype). Each lane dequantizes its token's K row as float(k) * ks before
// the dot product, and P @ V scales each V row by its token's vs, as the
// TPU kernel's `page.astype(f32) * scale` does. The pools' bytes fall to
// D + 4 a (token, head) from 2 D (bf16); the arithmetic is unchanged.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;    // heads per block, one warp each
constexpr int kMaxDpl = 8;   // head_dim <= 256

// TQ: q's type; TKV: the pools' (int8 pools carry k_scales/v_scales, else
// those are null and unread); TO: the output's
template <typename TQ, typename TKV, typename TO, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q,            // [B, H, D]
                    const TKV* __restrict__ k_pages,     // [N, P, H, D]
                    const TKV* __restrict__ v_pages,     // [N, P, H, D]
                    const float* __restrict__ k_scales,  // [N, P, H] or null
                    const float* __restrict__ v_scales,  // [N, P, H] or null
                    const int* __restrict__ block_table, // [B, W]
                    const int* __restrict__ lengths,     // [B]
                    TO* __restrict__ out,                // [B, H, D]
                    int heads, int head_dim, int page_size, int windows,
                    float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  __shared__ float q_s[kWarps][DPL * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int h = blockIdx.y * kWarps + warp;
  if (h >= heads) return;  // whole warp leaves together; no block barrier
  const int D = head_dim;
  const TQ* qr = q + (static_cast<size_t>(b) * heads + h) * D;
  for (int d = lane; d < D; d += 32) q_s[warp][d] = pdt::to_f32(qr[d]);
  __syncwarp();

  const int len = min(lengths[b], windows * page_size);
  const int* bt = block_table + static_cast<size_t>(b) * windows;

  float m = -INFINITY;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int base = 0; base < len; base += 32) {
    const int t = base + lane;
    const bool valid = t < len;
    size_t row = 0;  // element offset of token t's head-h row in the pools
    float s = -INFINITY;
    float vsc = 1.f;  // int8 pools: token t's V scale, for P @ V below
    if (valid) {
      const int w = t / page_size;
      const int page = bt[w];
      const size_t slot =  // (page, offset, h) in the scale pools
          (static_cast<size_t>(page) * page_size + (t - w * page_size)) *
              heads + h;
      row = slot * D;
      const TKV* kr = k_pages + row;
      float dot = 0.f;
      if constexpr (kQuant) {
        const float ksc = k_scales[slot];
        vsc = v_scales[slot];
        for (int d = 0; d < D; ++d)
          dot += q_s[warp][d] * (static_cast<float>(kr[d]) * ksc);
      } else {
        for (int d = 0; d < D; ++d) dot += q_s[warp][d] * pdt::to_f32(kr[d]);
      }
      s = dot * scale;
    }
    // the chunk holds at least one valid token (base < len), so m_new is
    // finite and exp(-inf - m_new) == 0 wipes the empty initial state
    const float m_new = fmaxf(m, pdt::warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + pdt::warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    const int n = min(32, len - base);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const unsigned long long rj = __shfl_sync(
          0xffffffffu, static_cast<unsigned long long>(row), j);
      const TKV* vr = v_pages + rj;
      if constexpr (kQuant) {
        const float vj = __shfl_sync(0xffffffffu, vsc, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] += pj * (static_cast<float>(vr[d]) * vj);
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] += pj * pdt::to_f32(vr[d]);
        }
      }
    }
    m = m_new;
  }

  // length >= 1 by engine contract, so l > 0; the guard only keeps an
  // empty sequence at exact zeros (the TPU kernel's l > 0 select)
  const float inv = l > 0.f ? 1.f / l : 0.f;
  TO* o = out + (static_cast<size_t>(b) * heads + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o[d] = pdt::from_f32<TO>(acc[i] * inv);
  }
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* bt,
                   const int* lengths, void* out, int batch, int heads,
                   int head_dim, int page_size, int windows, float scale,
                   cudaStream_t stream) {
  const dim3 grid(batch, (heads + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const TQ* qp = static_cast<const TQ*>(q);
  const TKV* kp = static_cast<const TKV*>(k);
  const TKV* vp = static_cast<const TKV*>(v);
  TO* op = static_cast<TO*>(out);
#define PDT_PA_CASE(DPL)                                                   \
  if (head_dim <= 32 * (DPL)) {                                            \
    paged_decode_kernel<TQ, TKV, TO, DPL><<<grid, block, 0, stream>>>(     \
        qp, kp, vp, ks, vs, bt, lengths, op, heads, head_dim, page_size,   \
        windows, scale);                                                   \
    return cudaGetLastError();                                             \
  }
  PDT_PA_CASE(1)
  PDT_PA_CASE(2)
  PDT_PA_CASE(4)
  PDT_PA_CASE(kMaxDpl)
#undef PDT_PA_CASE
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
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, bt, ln, out, batch, heads,
        head_dim, page_size, windows, scale, st);
  else if (dtype == pdt::kF32)
    err = launch<float, float, float>(
        q, k_pages, v_pages, nullptr, nullptr, bt, ln, out, batch, heads,
        head_dim, page_size, windows, scale, st);
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
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, int8_t, float>(
        q, k_pages, v_pages, ks, vs, bt, ln, out, batch, heads, head_dim,
        page_size, windows, scale, st);
  else if (q_dtype == pdt::kF32)
    err = launch<float, int8_t, float>(
        q, k_pages, v_pages, ks, vs, bt, ln, out, batch, heads, head_dim,
        page_size, windows, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
