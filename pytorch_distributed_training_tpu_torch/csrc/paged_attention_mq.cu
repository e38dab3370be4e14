// Paged attention for a causal block of query tokens, for Hopper (sm_90a):
// speculative verify (q_len = spec_k + 1), chunked prefill and the tail of
// a prefix-cache hit (q_len = the chunk), K/V read in place through a block
// table.
//
// Replaces the Pallas kernel _paged_kernel_mq of
// pytorch_distributed_training_tpu/ops/paged_attention.py (launched by
// _paged_pallas_mq, 4-D q), float pools and its quantized branch (int8
// pools, :430-434 and :457-459): for each (batch b, query row r,
// head h), with Q rows and limit_r = lengths[b] - (Q - 1) + r,
//   out = softmax(q_r . K[:limit_r] * scale) @ V[:limit_r]
// where token t of sequence b lives at page block_table[b, t / P], offset
// t % P of the [num_pages, P, heads, head_dim] pools. Tokens at or past
// lengths[b] (the last row's horizon) are never read, so pages wholly past
// the length are skipped as the TPU kernel's pl.when does. As there: the
// running max starts at finfo(float32).min, not -inf; p is 0 on a masked
// lane (a row whose horizon ends before a chunk leaves its state alone,
// which is what the TPU kernel's where() gives); the normaliser is floored
// to 1 before the divide, so a row that sees nothing gives zeros.
//
// Bound: bytes. The visible K and V rows of each (sequence, head) are read
// once from device memory for all Q rows; a query row does two
// multiply-adds per element of each row it sees. Design, simple first: one
// block per (sequence, head), grid (batch, heads). The block stages 32
// tokens of K and V at a time in shared memory as float32 (K with a row
// stride of D + 1, so the 32 lanes scoring 32 tokens hit 32 banks) and
// every query row reuses them: that reuse is what a multi-row query adds
// over the decode kernel's warp per (sequence, head). q sits in shared
// memory as float32. Warps split the rows (row r to warp r % warps, up to 8
// rows a warp); each row keeps its online softmax (m, l) and its output
// columns (lane i owns columns i, i + 32, ...) in float32 registers across
// the chunks. Lane i scores token base + i; the warp reduces the chunk's max
// and sum with shuffles, rescales, and accumulates P @ V reading each V row
// once, coalesced across lanes. wgmma/TMA come later.
//
// int8 pools (pdt_paged_attention_mq_int8): K and V int8 beside fp32 scale
// pools [num_pages, P, heads], one scale per (token, head); q float32 or
// bfloat16, output float32. Staging dequantizes, float(k) * ks and
// float(v) * vs per element (the TPU kernel's `page.astype(f32) * scale`),
// so the scoring and P @ V loops are the float pools' own.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 32;       // tokens staged per step, one per lane
constexpr int kMaxRows = 8;      // query rows a warp owns
constexpr int kMaxWarps = 16;    // q_len <= kMaxRows * kMaxWarps = 128
constexpr int kMaxDpl = 8;       // head_dim <= 256
constexpr float kNegMin = -3.4028234663852886e38f;  // finfo(float32).min

// TQ: q's type; TKV: the pools' (int8 pools carry k_scales/v_scales, else
// those are null and unread); TO: the output's
template <typename TQ, typename TKV, typename TO, int DPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_mq_kernel(const TQ* __restrict__ q,            // [B, Q, H, D]
                const TKV* __restrict__ k_pages,     // [N, P, H, D]
                const TKV* __restrict__ v_pages,     // [N, P, H, D]
                const float* __restrict__ k_scales,  // [N, P, H] or null
                const float* __restrict__ v_scales,  // [N, P, H] or null
                const int* __restrict__ block_table, // [B, W]
                const int* __restrict__ lengths,     // [B]
                TO* __restrict__ out,                // [B, Q, H, D]
                int q_len, int heads, int head_dim, int page_size,
                int windows, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  const int D = head_dim;
  float* k_s = smem;                      // [kChunk][D + 1]
  float* v_s = k_s + kChunk * (D + 1);    // [kChunk][D]
  float* q_s = v_s + kChunk * D;          // [Q][D]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t tok_stride = static_cast<size_t>(heads) * D;

  for (int e = threadIdx.x; e < q_len * D; e += blockDim.x) {
    const int r = e / D;
    q_s[e] = pdt::to_f32(
        q[((static_cast<size_t>(b) * q_len + r) * heads + h) * D + (e - r * D)]);
  }
  const int len = min(lengths[b], windows * page_size);
  const int* bt = block_table + static_cast<size_t>(b) * windows;

  float m[kMaxRows], l[kMaxRows], acc[kMaxRows][DPL];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    m[i] = kNegMin;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int base = 0; base < len; base += kChunk) {
    const int n = min(kChunk, len - base);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
      const int j = e / D;
      const int d = e - j * D;
      const int t = base + j;
      const int w = t / page_size;
      const size_t tok =
          static_cast<size_t>(bt[w]) * page_size + (t - w * page_size);
      const size_t row = tok * tok_stride + static_cast<size_t>(h) * D + d;
      if constexpr (kQuant) {
        const size_t slot = tok * heads + h;  // (page, offset, h)
        k_s[j * (D + 1) + d] =
            static_cast<float>(k_pages[row]) * k_scales[slot];
        v_s[j * D + d] = static_cast<float>(v_pages[row]) * v_scales[slot];
      } else {
        k_s[j * (D + 1) + d] = pdt::to_f32(k_pages[row]);
        v_s[j * D + d] = pdt::to_f32(v_pages[row]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int r = warp + i * warps;
      if (r >= q_len) continue;  // whole warp together
      // tokens of this chunk row r sees: t < len - (Q - 1) + r
      const int nr = min(n, len - (q_len - 1) + r - base);
      if (nr <= 0) continue;     // horizon before the chunk: state unchanged
      const bool valid = lane < nr;
      float s = kNegMin;
      if (valid) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + lane * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      // lane 0 is valid (nr >= 1), so m_new is a real score and
      // exp(finfo.min - m_new) == 0 wipes the empty initial state
      const float m_new = fmaxf(m[i], pdt::warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + pdt::warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < nr; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = v_s + j * D;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] += pj * vr[d];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int r = warp + i * warps;
    if (r >= q_len) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    TO* o = out + ((static_cast<size_t>(b) * q_len + r) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = pdt::from_f32<TO>(acc[i][c] * inv);
    }
  }
}

template <typename TQ, typename TKV, typename TO, int DPL>
cudaError_t launch_dpl(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* bt,
                       const int* lengths, void* out, int batch, int q_len,
                       int heads, int head_dim, int page_size, int windows,
                       float scale, cudaStream_t stream) {
  auto kern = paged_mq_kernel<TQ, TKV, TO, DPL>;
  // the opt-in to more than 48 KB of dynamic shared memory, once per
  // instantiation, to the card's largest (later launches, a CUDA-graph
  // capture among them, make no attribute call)
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted != cudaSuccess) return opted;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kChunk) * (2 * head_dim + 1) +
       static_cast<size_t>(q_len) * head_dim);
  const int warps = min(kMaxWarps, max(4, q_len));
  kern<<<dim3(batch, heads), warps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, bt, lengths, static_cast<TO*>(out),
      q_len, heads, head_dim, page_size, windows, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* bt,
                   const int* lengths, void* out, int batch, int q_len,
                   int heads, int head_dim, int page_size, int windows,
                   float scale, cudaStream_t stream) {
#define PDT_PAMQ_CASE(DPL)                                                 \
  if (head_dim <= 32 * (DPL))                                              \
    return launch_dpl<TQ, TKV, TO, DPL>(q, k, v, ks, vs, bt, lengths, out, \
                                        batch, q_len, heads, head_dim,     \
                                        page_size, windows, scale, stream);
  PDT_PAMQ_CASE(1)
  PDT_PAMQ_CASE(2)
  PDT_PAMQ_CASE(4)
  PDT_PAMQ_CASE(kMaxDpl)
#undef PDT_PAMQ_CASE
  return cudaErrorInvalidValue;  // head_dim > 256: the wrapper refuses it
}

bool bad_dims(int batch, int q_len, int heads, int head_dim, int page_size,
              int windows) {
  return batch <= 0 || q_len <= 0 || q_len > kMaxRows * kMaxWarps ||
         heads <= 0 || head_dim <= 0 || page_size <= 0 || windows <= 0;
}

}  // namespace

// q [batch, q_len, heads, head_dim]; k_pages/v_pages [num_pages, page_size,
// heads, head_dim], all of one dtype (float32 or bfloat16, by dtype);
// block_table [batch, windows] int32; lengths [batch] int32, inclusive of
// the q_len query tokens; out like q. 1 <= q_len <= 128, head_dim <= 256.
// Returns the cudaError_t of the launch.
extern "C" int pdt_paged_attention_mq(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int batch,
    int q_len, int heads, int head_dim, int page_size, int windows,
    float scale, int dtype, void* stream) {
  if (bad_dims(batch, q_len, heads, head_dim, page_size, windows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, bt, ln, out, batch, q_len,
        heads, head_dim, page_size, windows, scale, st);
  else if (dtype == pdt::kF32)
    err = launch<float, float, float>(
        q, k_pages, v_pages, nullptr, nullptr, bt, ln, out, batch, q_len,
        heads, head_dim, page_size, windows, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// int8 pools: k_pages/v_pages int8 [num_pages, page_size, heads, head_dim]
// with float32 k_scales/v_scales [num_pages, page_size, heads]; q float32
// or bfloat16 (by q_dtype); out float32 [batch, q_len, heads, head_dim].
// The rest as pdt_paged_attention_mq.
extern "C" int pdt_paged_attention_mq_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, void* out, int batch, int q_len, int heads,
    int head_dim, int page_size, int windows, float scale, int q_dtype,
    void* stream) {
  if (bad_dims(batch, q_len, heads, head_dim, page_size, windows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == pdt::kBF16)
    err = launch<__nv_bfloat16, int8_t, float>(
        q, k_pages, v_pages, ks, vs, bt, ln, out, batch, q_len, heads,
        head_dim, page_size, windows, scale, st);
  else if (q_dtype == pdt::kF32)
    err = launch<float, int8_t, float>(
        q, k_pages, v_pages, ks, vs, bt, ln, out, batch, q_len, heads,
        head_dim, page_size, windows, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
