// Tensor-core building blocks for sm_90a, as inline PTX: asynchronous
// 16-byte copies into shared memory (cp.async), ldmatrix fragment loads and
// the bf16 mma.sync.m16n8k16 product with float32 accumulators. Plain CUDA,
// no PyTorch headers (see ops/_build.py).
//
// Fragments of mma.m16n8k16 (lane = 4 g + t, g < 8, t < 4), two bf16 a
// 32-bit register, the lower column in the low half:
//   A 16 x 16 (rows x k): a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..),
//                         a[2] (g, 2t + 8..),  a[3] (g + 8, 2t + 8..)
//   B 16 x 8 (k x cols):  b[0] (2t..2t+1, g), b[1] (2t + 8.., g)
//   C 16 x 8, float32:    c[0..1] (g, 2t..2t+1), c[2..3] (g + 8, 2t..)
// so the C fragments of two neighbouring 8-column tiles are, rounded to
// bf16 and packed, the A fragment of the 16-deep product that follows.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace pdt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// the 16 bytes are zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, r[i] receives the lane's (row g, columns 2t..2t+1) of it
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// the same, transposed: r[i] receives (rows 2t..2t+1, column g) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a b on the tensor cores: bf16 operands (each product exact in
// float32), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// x = hi + mid + lo exactly for float32 x (|x| >= 2^-110 or 0), each piece
// a bf16: hi the nearest bf16 of x, mid of what hi leaves, lo of what both
// leave, which fits a bf16 (24 bits of x, 8 a piece). Two neighbouring
// columns at once, packed as the pieces' fragment registers.
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;  // exact
  mid = pack_bf16(r0, r1);
  const float2 m = unpack_bf16(mid);
  lo = pack_bf16(r0 - m.x, r1 - m.y);        // exact, and exactly a bf16
}

}  // namespace pdt
