// Counter-based random bits shared by the dropout kernels (dropout.cu,
// dropout_add_layer_norm.cu).
//
// The TPU kernels draw their keep masks from the per-core hardware PRNG
// (pltpu.prng_seed / prng_random_bits), whose bits cannot be reproduced
// here. The port uses Philox4x32-10 (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC 2011) instead:
//
//   bits(seed, site, i) = philox4x32_10(counter = (i / 4 low, i / 4 high,
//                                                  0, 0),
//                                       key = (seed, site))[i % 4]
//
// for the flat element index i of the tensor being masked. It is a pure
// function of (seed, site, i), independent of how a launch is shaped, so a
// forward, its backward and a recomputation give the same mask, and the
// plain PyTorch version (ops/dropout.py philox_bits) gives the same bits.
// An element is kept when bits >= mask_threshold(rate) (ops/dropout.py).
#pragma once

#include <cstdint>

namespace pdt {

struct Philox4 {
  uint32_t v[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint64_t group, uint32_t k0,
                                                 uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(group);
  uint32_t c1 = static_cast<uint32_t>(group >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 out;
  out.v[0] = c0;
  out.v[1] = c1;
  out.v[2] = c2;
  out.v[3] = c3;
  return out;
}

// Bits of consecutive flat indices, one Philox call per group of four: a
// thread walking i, i+1, ... calls next(i) and pays for a new block only
// when i enters a new group.
struct PhiloxStream {
  uint32_t seed, site;
  uint64_t group = ~0ull;
  Philox4 block;

  __device__ __forceinline__ PhiloxStream(uint32_t seed_, uint32_t site_)
      : seed(seed_), site(site_) {}

  __device__ __forceinline__ uint32_t bits(uint64_t i) {
    const uint64_t g = i >> 2;
    if (g != group) {
      block = philox4x32_10(g, seed, site);
      group = g;
    }
    // a select, not block.v[i & 3]: a dynamic index would put the block
    // in local memory
    const uint32_t k = static_cast<uint32_t>(i & 3);
    return k == 0 ? block.v[0]
         : k == 1 ? block.v[1]
         : k == 2 ? block.v[2]
                  : block.v[3];
  }
};

}  // namespace pdt
