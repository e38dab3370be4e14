// Paged attention for a causal block of query tokens, for Hopper (sm_90a):
// speculative verify (q_len = spec_k + 1), chunked prefill and the tail of
// a prefix-cache hit (q_len = the chunk), K/V read in place through a block
// table.
//
// Replaces the Pallas kernel _paged_kernel_mq of
// pytorch_distributed_training_tpu/ops/paged_attention.py:417 (launched by
// _paged_pallas_mq, 4-D q), float pools and its quantized branch (int8
// pools, :430-434 and :457-459): for each (batch b, query row r, head h),
// with Q rows and limit_r = lengths[b] - (Q - 1) + r,
//   out = softmax(q_r . K[:limit_r] * scale) @ V[:limit_r]
// where token t of sequence b lives at page block_table[b, t / P], offset
// t % P of the [num_pages, P, heads, head_dim] pools. Tokens at or past
// lengths[b] (the last row's horizon) are never read, so pages wholly past
// the length are skipped as the TPU kernel's pl.when does. As there: the
// running max starts at finfo(float32).min, not -inf; p is 0 on a masked
// lane (a row whose horizon ends before a share of tokens leaves its state
// alone, which is what the TPU kernel's where() gives); the normaliser is
// floored to 1 before the divide, so a row that sees nothing gives zeros.
//
// Bound: bytes. The visible K and V rows of each (sequence, head) are read
// once from device memory for all Q rows (0.000911 ms at the verify shape,
// q [8, 5, 16, 64] over 22-157 tokens; 0.000078-0.000235 ms for a chunk of
// 32 rows over 32-160 tokens). At such sizes the kernel is bound by latency
// long before bytes: dependent trips to memory and the serial instructions
// of the longest walk set its time. The design (bf16 and int8 pools,
// paged_mq_mma_kernel) cuts both:
// - Grid (batch, heads, ceil(Q / 16)): one block a 16-row tile of the
//   query block, which stops at its own last row's horizon. The block's
//   warps split the tile's visible tokens, 16 a warp share (warp w takes
//   shares w, w + warps, ...), so a chunk of 32 rows over 160 tokens is 32
//   blocks of 10 busy warps taking one share each, not 16 blocks walking
//   the sequence.
// - A share's K and V rows (D contiguous elements at (page * P + offset) *
//   heads * D + h * D) go into the warp's own shared-memory tiles by 16-byte
//   cp.async copies, once for all 16 rows; the block-table entries of the
//   next share load, and its copies start, before the current share is
//   scored. Tile rows are padded by 16 bytes, so ldmatrix reads them
//   without bank conflicts. Rows that are not a multiple of 16 bytes, or
//   pools not aligned to 16 bytes, take an instantiation with scalar loads
//   (kVec false), head_dim 50 among them.
// - S = Q K^T on mma.sync.m16n8k16 (bf16 operands, float32 sums): q is
//   staged once a block in shared memory, rows past Q and columns past
//   head_dim zero, and read as A fragments by ldmatrix; a warp takes one
//   share at the serve shapes, so keeping them in registers would save no
//   load, and at head_dim 256 or float32 q (three pieces) they would take
//   64-192 registers. Each row's horizon masks its C fragments, and the
//   row-wise online softmax runs on them with 4-lane shuffles.
// - P V on the tensor cores with V through ldmatrix.trans. p is float32 in
//   the TPU kernel, multiplying V upcast to float32: here p is split into
//   three bf16 pieces, hi + mid + lo = p exactly, and each piece's product
//   with V is exact in float32, so P V is float32 arithmetic in another
//   order, not p rounded once.
// - Each warp keeps its own (m, l, acc) for the 16 rows; a warp whose share
//   lies wholly past a row's horizon leaves that row at (finfo.min, 0, 0),
//   which every merge weighs by exp(finfo.min - m) = 0 exactly. The warps
//   merge in shared memory in warp order, one thread a (warp, row) forming
//   its weight once; out = acc / l with l floored to 1. One launch a call,
//   no atomics: two calls give the same bits.
// - Warps a block: 16 up to head_dim 64, 8 to 128, 4 to 256, so that two
//   stages of K and V tiles a warp fit the block's shared memory.
//
// int8 pools (pdt_paged_attention_mq_int8): K and V int8 beside fp32 scale
// pools [num_pages, P, heads], one scale per (token, head); q float32 or
// bfloat16, output float32. The TPU kernel dequantizes each element,
// page.astype(f32) * scale. Here the int8 rows are staged by cp.async and
// converted to bf16 in shared memory (exact, |k| <= 127); a token's score
// is (sum_d q_d k_d) * ks, the column scale applied to the C fragment, and
// its V row is weighed by p * vs, split into three bf16 pieces. A float32 q
// is split into three bf16 pieces (three products of S), a bf16 q is one:
// float32 arithmetic in another order.
//
// float32 pools keep the FMA kernel paged_mq_kernel (off the serve path,
// whose pools are bf16 or int8): one block per (sequence, head) stages 32
// tokens of K and V at a time in shared memory as float32 and every query
// row reuses them; warps split the rows, lanes score one token each.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegMin = -3.4028234663852886e38f;  // finfo(float32).min

// ------------------------------------------- float32 pools: FMA kernel

constexpr int kChunk = 32;       // tokens staged per step, one per lane
constexpr int kMaxRows = 8;      // query rows a warp owns
constexpr int kMaxWarps = 16;    // q_len <= kMaxRows * kMaxWarps = 128
constexpr int kMaxDpl = 8;       // head_dim <= 256

template <int DPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_mq_kernel(const float* __restrict__ q,           // [B, Q, H, D]
                const float* __restrict__ k_pages,     // [N, P, H, D]
                const float* __restrict__ v_pages,     // [N, P, H, D]
                const int* __restrict__ block_table,   // [B, W]
                const int* __restrict__ lengths,       // [B]
                float* __restrict__ out,               // [B, Q, H, D]
                int q_len, int heads, int head_dim, int page_size,
                int windows, float scale) {
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
    q_s[e] = q[((static_cast<size_t>(b) * q_len + r) * heads + h) * D
               + (e - r * D)];
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
      k_s[j * (D + 1) + d] = k_pages[row];
      v_s[j * D + d] = v_pages[row];
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
    float* o = out + ((static_cast<size_t>(b) * q_len + r) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[i][c] * inv;
    }
  }
}

template <int DPL>
cudaError_t launch_fma(const float* q, const float* k, const float* v,
                       const int* bt, const int* lengths, float* out,
                       int batch, int q_len, int heads, int head_dim,
                       int page_size, int windows, float scale,
                       cudaStream_t stream) {
  auto kern = paged_mq_kernel<DPL>;
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
      q, k, v, bt, lengths, out, q_len, heads, head_dim, page_size, windows,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* bt, const int* lengths, void* out,
                       int batch, int q_len, int heads, int head_dim,
                       int page_size, int windows, float scale,
                       cudaStream_t stream) {
#define PDT_PAMQ_CASE(DPL)                                                  \
  if (head_dim <= 32 * (DPL))                                               \
    return launch_fma<DPL>(static_cast<const float*>(q),                    \
                           static_cast<const float*>(k),                    \
                           static_cast<const float*>(v), bt, lengths,       \
                           static_cast<float*>(out), batch, q_len, heads,   \
                           head_dim, page_size, windows, scale, stream);
  PDT_PAMQ_CASE(1)
  PDT_PAMQ_CASE(2)
  PDT_PAMQ_CASE(4)
  PDT_PAMQ_CASE(kMaxDpl)
#undef PDT_PAMQ_CASE
  return cudaErrorInvalidValue;  // head_dim > 256: the wrapper refuses it
}

// ------------------------------ bf16 and int8 pools: tensor-core kernel

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;  // query rows a block: one m16 tile
constexpr int kTok = 16;   // tokens a warp share: one k16 step of P V

// DP: head_dim rounded up to a power of two (>= 32), the width of the
// tiles; columns from head_dim on are zeros
template <typename TQ, typename TKV, int DP>
struct MqDims {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr int kPieces = std::is_same<TQ, float>::value ? 3 : 1;
  static constexpr int kWarps = DP <= 64 ? 16 : DP == 128 ? 8 : 4;
  static constexpr int kLd = DP + 8;      // bf16 row stride of a tile
  static constexpr int kAccLd = DP + 4;   // float row stride in the merge
  static constexpr int kTileElems = kTok * kLd;
  // a warp's region: bf16 pools two stages of K and V tiles; int8 pools
  // two stages of the int8 rows, one bf16 tile of each converted, and two
  // stages of the share's k and v scales. The merge reuses it for the
  // warp's [16][kAccLd] float32 acc.
  static constexpr int kWarpBytes =
      kQuant ? 2 * 2 * kTok * DP + 2 * kTileElems * 2 + 2 * 2 * kTok * 4
             : 2 * 2 * kTileElems * 2;
  static constexpr int kQBytes = kPieces * kRows * kLd * 2;
  static constexpr int kStateBytes = 3 * kWarps * kRows * 4;  // m, l, wt
  static constexpr int kSmem = kQBytes + kStateBytes + kWarps * kWarpBytes;
  static_assert(kWarpBytes >= kRows * kAccLd * 4, "merge fits the region");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

struct MqArgs {
  const void* q;        // [B, Q, H, D]
  const void* k;        // [N, P, H, D]
  const void* v;        // [N, P, H, D]
  const float* ks;      // [N, P, H] or null
  const float* vs;      // [N, P, H] or null
  const int* bt;        // [B, W]
  const int* lengths;   // [B]
  void* out;            // [B, Q, H, D]
  int q_len, heads, head_dim, page_size, page_shift, windows;
  float scale;
};

// int8 byte k of w, sign-extended, as a float
__device__ __forceinline__ float s8(uint32_t w, int k) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

// TQ: q's type; TKV: the pools' (int8 pools carry ks/vs); TO: the
// output's. DP: the tiles' width; kVec: 16-byte cp.async staging, else
// scalar loads.
template <typename TQ, typename TKV, typename TO, int DP, bool kVec>
__global__ void __launch_bounds__(MqDims<TQ, TKV, DP>::kWarps * 32)
paged_mq_mma_kernel(const MqArgs a) {
  using M = MqDims<TQ, TKV, DP>;
  constexpr bool kQuant = M::kQuant;
  constexpr int kW = M::kWarps;
  constexpr int kLd = M::kLd;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);      // [kPieces][16][kLd]
  float* m_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem4) + M::kQBytes);  // [kW][16]
  float* l_s = m_s + kW * kRows;
  float* wt_s = l_s + kW * kRows;
  unsigned char* regions = reinterpret_cast<unsigned char*>(wt_s + kW * kRows);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = a.head_dim, P = a.page_size, H = a.heads, Q = a.q_len;
  const int r0 = blockIdx.z * kRows;    // the tile's first query row
  const int rows = min(kRows, Q - r0);
  const int* bt = a.bt + static_cast<size_t>(b) * a.windows;
  const int tokens = a.windows * P;
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);
  // token t lies on page entry t / P at offset t % P (shifts for P = 2^k)
  auto window_of = [&](int tk) {
    return a.page_shift >= 0 ? tk >> a.page_shift : tk / P;
  };
  constexpr int kStep = kW * kTok;      // the block's tokens a step
  const int first = warp * kTok;

  // this warp's first share: the page of token first + (lane & 15), read
  // before the length is known (the row always has `windows` entries, and
  // no page is read on their account)
  int page = first + (lane & 15) < tokens
                 ? __ldg(bt + window_of(first + (lane & 15))) : 0;
  const int len = __ldg(a.lengths + b);
  // row r sees tokens < len - (Q - 1) + r; the tile's last row the most
  const int n = min(len - (Q - 1) + r0 + rows - 1, tokens);
  const int busy = n > 0 ? min(kW, (n + kTok - 1) / kTok) : 0;

  unsigned char* mine = regions + warp * M::kWarpBytes;
  bf16* Kt = reinterpret_cast<bf16*>(mine);  // bf16 tiles (stage 0 for int8)
  bf16* Vt = Kt + (kQuant ? 1 : 2) * M::kTileElems;
  int8_t* Kr = reinterpret_cast<int8_t*>(Vt + (kQuant ? 1 : 2)
                                              * M::kTileElems);
  int8_t* Vr = Kr + 2 * kTok * DP;         // int8 rows, two stages each
  float* ks_s = reinterpret_cast<float*>(Vr + 2 * kTok * DP);
  float* vs_s = ks_s + 2 * kTok;           // the share's scales, two stages

  // columns head_dim..DP of the 16-byte copies' targets stay zero
  if (kVec && D < DP && warp < busy) {
    uint4* z = reinterpret_cast<uint4*>(kQuant ? reinterpret_cast<void*>(Kr)
                                               : reinterpret_cast<void*>(Kt));
    const int n16 = kQuant ? 2 * 2 * kTok * DP / 16 : 2 * 2 * M::kTileElems / 8;
    for (int i = lane; i < n16; i += 32) z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  // K and V rows of the share at `base` into stage `st`: pg is the page of
  // token base + (lane & 15); rows of tokens at or past n are zeros
  auto stage_share = [&](int base, int st, int pg) {
    const int tk = base + (lane & 15);
    const bool ok = tk < n;
    const int ts = ok ? pg * P + (tk - window_of(tk) * P) : 0;  // pool token
    if constexpr (kQuant) {
      float* dst = (lane < 16 ? ks_s : vs_s) + st * kTok + (lane & 15);
      pdt::cp_async4(dst, (lane < 16 ? a.ks : a.vs)
                              + (static_cast<size_t>(ts) * H + h),
                     ok ? 4 : 0);
    }
    // bf16 pools land in the stage's tiles, int8 rows in the raw stage
    constexpr int kE = kVec ? 16 / sizeof(TKV) : 1;  // elements a copy
    constexpr int kCpr = DP / kE;                    // copies a padded row
    constexpr int kIters = kTok * kCpr / 32;
    constexpr int kDst = kQuant ? DP : kLd;          // target row stride
    TKV* kd = kQuant ? reinterpret_cast<TKV*>(Kr + st * kTok * DP)
                     : reinterpret_cast<TKV*>(Kt + st * M::kTileElems);
    TKV* vd = kQuant ? reinterpret_cast<TKV*>(Vr + st * kTok * DP)
                     : reinterpret_cast<TKV*>(Vt + st * M::kTileElems);
#pragma unroll 4
    for (int i = 0; i < kIters; ++i) {
      const int e = lane + 32 * i;
      const int r = e / kCpr, c = (e % kCpr) * kE;
      const int tr = __shfl_sync(kAll, ts, r);
      const bool in = base + r < n && c < D;
      const size_t off = (static_cast<size_t>(tr) * H + h) * D + c;
      if constexpr (kVec) {
        if (c < D) {
          pdt::cp_async16(kd + r * kDst + c, in ? kp + off : kp, in ? 16 : 0);
          pdt::cp_async16(vd + r * kDst + c, in ? vp + off : vp, in ? 16 : 0);
        }
      } else {
        kd[r * kDst + c] = in ? kp[off] : TKV{};
        vd[r * kDst + c] = in ? vp[off] : TKV{};
      }
    }
    pdt::cp_async_commit();
  };

  if (first < n) stage_share(first, 0, page);
  // the next share's page, in flight while q is staged
  {
    const int tk = first + kStep + (lane & 15);
    page = tk < n ? __ldg(bt + window_of(tk)) : 0;
  }

  // q rows r0..r0 + 15 of (b, h) in bf16 pieces (three for float32 q: hi +
  // mid + lo = q exactly), rows past Q and columns past head_dim zero
  {
    const TQ* qb = static_cast<const TQ*>(a.q);
    for (int e = threadIdx.x; e < kRows * DP; e += kW * 32) {
      const int r = e / DP, d = e % DP;
      float x = 0.f;
      if (r < rows && d < D)
        x = pdt::to_f32(qb[((static_cast<size_t>(b) * Q + r0 + r) * H + h)
                           * D + d]);
      const bf16 hi = __float2bfloat16_rn(x);
      sQ[r * kLd + d] = hi;
      if constexpr (M::kPieces == 3) {
        const float rem = x - __bfloat162float(hi);
        const bf16 mid = __float2bfloat16_rn(rem);
        sQ[(kRows + r) * kLd + d] = mid;
        sQ[(2 * kRows + r) * kLd + d] =
            __float2bfloat16_rn(rem - __bfloat162float(mid));
      }
    }
  }
  __syncthreads();

  // the thread's rows g and g + 8 of the tile: horizons, and state
  int lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    lim[hh] = min(len - (Q - 1) + r0 + g + 8 * hh, n);
  float m[2] = {kNegMin, kNegMin}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  int st = 0;
  for (int base = first; base < n; base += kStep, st ^= 1) {
    const int next = base + kStep;
    if (next < n) {
      stage_share(next, st ^ 1, page);
      const int tk = next + kStep + (lane & 15);
      page = tk < n ? __ldg(bt + window_of(tk)) : 0;
      pdt::cp_async_wait<1>();
    } else {
      pdt::cp_async_wait<0>();
    }
    __syncwarp();
    const bf16* Ks = Kt + (kQuant ? 0 : st * M::kTileElems);
    const bf16* Vs = Vt + (kQuant ? 0 : st * M::kTileElems);
    if constexpr (kQuant) {
      // the stage's int8 rows to bf16, 16 values a lane and step
      const int8_t* kr = Kr + st * kTok * DP;
      const int8_t* vr = Vr + st * kTok * DP;
#pragma unroll
      for (int i = 0; i < DP / 32; ++i) {  // kTok * DP / 16 copies
        const int e = lane + 32 * i;
        const int r = e / (DP / 16), c = (e % (DP / 16)) * 16;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const uint4 x = *reinterpret_cast<const uint4*>(
              (which ? vr : kr) + r * DP + c);
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
          uint32_t o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o[j] = pdt::pack_bf16(s8(w[j >> 1], 2 * (j & 1)),
                                  s8(w[j >> 1], 2 * (j & 1) + 1));
          bf16* dst = (which ? Vt : Kt) + r * kLd + c;
          reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
          reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
      }
      __syncwarp();
    }

    // S = Q K^T: 16 rows x 16 tokens, the thread's (rows g, g + 8; tokens
    // 8 nt + 2t + c)
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t kb[4];
      pdt::ldmatrix_x4(kb, Ks + ((lane >> 4) * 8 + (lane & 7)) * kLd
                               + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int pc = 0; pc < M::kPieces; ++pc) {
        uint32_t qa[4];
        pdt::ldmatrix_x4(qa, sQ + (pc * kRows + (lane & 15)) * kLd + kk * 16
                                 + (lane >> 4) * 8);
        pdt::mma_bf16(s[0], qa, kb[0], kb[1]);
        pdt::mma_bf16(s[1], qa, kb[2], kb[3]);
      }
    }

    // mask each row at its horizon; the rows' online softmax over the quad
    // of lanes sharing a row (l is this lane's part of the row sum)
    float ksc[2][2], vsc[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        ksc[nt][c] = kQuant ? ks_s[st * kTok + nt * 8 + 2 * t + c] : 1.f;
        vsc[nt][c] = kQuant ? vs_s[st * kTok + nt * 8 + 2 * t + c] : 1.f;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mt = kNegMin;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool valid = base + nt * 8 + 2 * t + c < lim[hh];
          float x = s[nt][2 * hh + c];
          if constexpr (kQuant) x *= ksc[nt][c];
          x = valid ? x * a.scale : kNegMin;
          s[nt][2 * hh + c] = x;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(kAll, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kAll, mt, 2));
      const float m_new = fmaxf(m[hh], mt);
      const float alpha = expf(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool valid = base + nt * 8 + 2 * t + c < lim[hh];
          const float p = valid ? expf(s[nt][2 * hh + c] - m_new) : 0.f;
          sum += p;
          s[nt][2 * hh + c] = kQuant ? p * vsc[nt][c] : p;
        }
      }
      l[hh] = l[hh] * alpha + sum;
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
    }

    // acc += P V: p (times vs) in three bf16 pieces as A fragments, V by
    // ldmatrix.trans
    uint32_t ph[4], pm[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a[0] (g, 2t..), a[1] (g + 8, 2t..), a[2] (g, 2t + 8..), a[3] (g +
      // 8, 2t + 8..): tokens 8 (i >> 1) + 2t, row half i & 1
      pdt::split_bf16x3(s[i >> 1][2 * (i & 1)], s[i >> 1][2 * (i & 1) + 1],
                        ph[i], pm[i], pl[i]);
    }
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t vb[4];
      pdt::ldmatrix_x4_trans(
          vb, Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dp * 16
                  + (lane >> 4) * 8);
      pdt::mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
      pdt::mma_bf16(acc[2 * dp], pm, vb[0], vb[1]);
      pdt::mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
      pdt::mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
      pdt::mma_bf16(acc[2 * dp + 1], pm, vb[2], vb[3]);
      pdt::mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
    }
    __syncwarp();  // this stage is free for the copies after next
  }

  // the warp's state into its own region (its copies are all done)
  if (warp < busy) {
    float* acc_w = reinterpret_cast<float*>(mine);  // [16][kAccLd]
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(kAll, l[hh], 1);
      l[hh] += __shfl_xor_sync(kAll, l[hh], 2);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        *reinterpret_cast<float2*>(acc_w + (g + 8 * hh) * M::kAccLd + j * 8
                                   + 2 * t) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
      if (t == 0) {
        m_s[warp * kRows + g + 8 * hh] = m[hh];
        l_s[warp * kRows + g + 8 * hh] = l[hh];
      }
    }
  }
  __syncthreads();

  // each busy warp's weight for each row, formed once: exp(m_w - max m)
  if (threadIdx.x < busy * kRows) {
    const int r = threadIdx.x % kRows;
    float mx = kNegMin;
    for (int w = 0; w < busy; ++w) mx = fmaxf(mx, m_s[w * kRows + r]);
    wt_s[threadIdx.x] = expf(m_s[threadIdx.x] - mx);
  }
  __syncthreads();

  // merge the warps in warp order; out = acc / l, l floored to 1
  TO* o = static_cast<TO*>(a.out);
  for (int e = threadIdx.x; e < rows * D; e += kW * 32) {
    const int r = e / D, d = e - r * D;
    float lsum = 0.f, x = 0.f;
    for (int w = 0; w < busy; ++w) {
      const float wt = wt_s[w * kRows + r];
      lsum += l_s[w * kRows + r] * wt;
      x += reinterpret_cast<const float*>(regions + w * M::kWarpBytes)
               [r * M::kAccLd + d] * wt;
    }
    o[((static_cast<size_t>(b) * Q + r0 + r) * H + h) * D + d] =
        pdt::from_f32<TO>(x / (lsum > 0.f ? lsum : 1.f));
  }
}

template <typename TQ, typename TKV, typename TO, int DP, bool kVec>
cudaError_t go_mma(const MqArgs& a, int batch, cudaStream_t stream) {
  using M = MqDims<TQ, TKV, DP>;
  auto kern = paged_mq_mma_kernel<TQ, TKV, TO, DP, kVec>;
  // the opt-in to more than 48 KB of dynamic shared memory, once per
  // instantiation (later launches, a CUDA-graph capture among them, make
  // no attribute call)
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, M::kSmem);
  if (opted != cudaSuccess) return opted;
  kern<<<dim3(batch, a.heads, (a.q_len + kRows - 1) / kRows),
         M::kWarps * 32, M::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch_mma(const MqArgs& a, int batch, cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(TKV);  // elements in 16 bytes
  const bool vec =
      a.head_dim % kE == 0 &&
      (reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) %
              16 == 0;
#define PDT_PAMQ_CASE(DP)                                             \
  if (a.head_dim <= (DP))                                             \
    return vec ? go_mma<TQ, TKV, TO, DP, true>(a, batch, stream)      \
               : go_mma<TQ, TKV, TO, DP, false>(a, batch, stream);
  PDT_PAMQ_CASE(32)
  PDT_PAMQ_CASE(64)
  PDT_PAMQ_CASE(128)
  PDT_PAMQ_CASE(256)
#undef PDT_PAMQ_CASE
  return cudaErrorInvalidValue;  // head_dim > 256: the wrapper refuses it
}

MqArgs mq_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* bt, const void* lengths, void* out,
               int q_len, int heads, int head_dim, int page_size,
               int windows, float scale) {
  int shift = -1;  // log2 of the page size, when it is a power of 2
  if ((page_size & (page_size - 1)) == 0)
    for (shift = 0; (1 << shift) < page_size; ++shift) {
    }
  return MqArgs{q, k, v, static_cast<const float*>(ks),
                static_cast<const float*>(vs), static_cast<const int*>(bt),
                static_cast<const int*>(lengths), out, q_len, heads,
                head_dim, page_size, shift, windows, scale};
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pdt::kBF16)
    err = launch_mma<bf16, bf16, bf16>(
        mq_args(q, k_pages, v_pages, nullptr, nullptr, block_table, lengths,
                out, q_len, heads, head_dim, page_size, windows, scale),
        batch, st);
  else if (dtype == pdt::kF32)
    err = launch_f32(q, k_pages, v_pages,
                     static_cast<const int*>(block_table),
                     static_cast<const int*>(lengths), out, batch, q_len,
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
  const MqArgs a = mq_args(q, k_pages, v_pages, k_scales, v_scales,
                           block_table, lengths, out, q_len, heads,
                           head_dim, page_size, windows, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == pdt::kBF16)
    err = launch_mma<bf16, int8_t, float>(a, batch, st);
  else if (q_dtype == pdt::kF32)
    err = launch_mma<float, int8_t, float>(a, batch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
