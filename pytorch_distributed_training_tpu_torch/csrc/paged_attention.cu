// Paged decode attention for Hopper (sm_90a): one query token per
// sequence, K/V read in place through a block table.
//
// Replaces the Pallas kernel _paged_kernel of
// pytorch_distributed_training_tpu/ops/paged_attention.py (launched by
// _paged_pallas, 3-D q, float pools): for each (batch b, head h),
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

#include "common.cuh"

namespace {

constexpr int kWarps = 4;    // heads per block, one warp each
constexpr int kMaxDpl = 8;   // head_dim <= 256

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,             // [B, H, D]
                    const T* __restrict__ k_pages,       // [N, P, H, D]
                    const T* __restrict__ v_pages,       // [N, P, H, D]
                    const int* __restrict__ block_table, // [B, W]
                    const int* __restrict__ lengths,     // [B]
                    T* __restrict__ out,                 // [B, H, D]
                    int heads, int head_dim, int page_size, int windows,
                    float scale) {
  __shared__ float q_s[kWarps][DPL * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int h = blockIdx.y * kWarps + warp;
  if (h >= heads) return;  // whole warp leaves together; no block barrier
  const int D = head_dim;
  const T* qr = q + (static_cast<size_t>(b) * heads + h) * D;
  for (int d = lane; d < D; d += 32) q_s[warp][d] = pdt::to_f32(qr[d]);
  __syncwarp();

  const int len = min(lengths[b], windows * page_size);
  const int* bt = block_table + static_cast<size_t>(b) * windows;
  const size_t tok_stride = static_cast<size_t>(heads) * D;

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
    if (valid) {
      const int w = t / page_size;
      const int page = bt[w];
      row = (static_cast<size_t>(page) * page_size + (t - w * page_size)) *
                tok_stride +
            static_cast<size_t>(h) * D;
      const T* kr = k_pages + row;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += q_s[warp][d] * pdt::to_f32(kr[d]);
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
      const T* vr = v_pages + rj;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pj * pdt::to_f32(vr[d]);
      }
    }
    m = m_new;
  }

  // length >= 1 by engine contract, so l > 0; the guard only keeps an
  // empty sequence at exact zeros (the TPU kernel's l > 0 select)
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* o = out + (static_cast<size_t>(b) * heads + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o[d] = pdt::from_f32<T>(acc[i] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* bt, const int* lengths, void* out, int batch,
                   int heads, int head_dim, int page_size, int windows,
                   float scale, cudaStream_t stream) {
  const dim3 grid(batch, (heads + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define PDT_PA_CASE(DPL)                                                   \
  if (head_dim <= 32 * (DPL)) {                                            \
    paged_decode_kernel<T, DPL><<<grid, block, 0, stream>>>(               \
        qp, kp, vp, bt, lengths, op, heads, head_dim, page_size, windows,  \
        scale);                                                            \
    return cudaGetLastError();                                             \
  }
  PDT_PA_CASE(1)
  PDT_PA_CASE(2)
  PDT_PA_CASE(4)
  PDT_PA_CASE(kMaxDpl)
#undef PDT_PA_CASE
  return cudaErrorInvalidValue;  // head_dim > 256: the wrapper refuses it
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
  if (batch <= 0 || heads <= 0 || head_dim <= 0 || page_size <= 0 ||
      windows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, out, batch, heads,
                                head_dim, page_size, windows, scale, st);
  else if (dtype == pdt::kF32)
    err = launch<float>(q, k_pages, v_pages, bt, ln, out, batch, heads,
                        head_dim, page_size, windows, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
