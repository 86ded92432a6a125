// Attention-probability dropout shared by kernel B (flash_attention_fwd.cu)
// and kernel E (flash_attention_bwd.cu): the keep decision of score
// (row, col) of head (b, h) is a pure function of those coordinates and
// the step's seed, so every kernel that tiles the scores differently
// regenerates the same mask, and the plain twin
// (ops/flash_attention.py dropout_keep_mask) computes the same bits.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) keyed by (seed, b * H + h), counter (row, col / 64, col % 4,
// 0); its 16 output bytes are the 16 columns col % 64 = 4 * i + col % 4,
// i = 0..15, byte i = bits 8 * (i % 4) of word i / 4.  That is the set of
// columns one thread of kernels B and E holds (n0 + j + 4 * i), so a
// thread draws its whole row slice of a 64-key tile with one call.
//
// A score is kept when its byte < threshold = round((1 - rate) * 256), and
// a kept probability is scaled by 256 / threshold, the exact inverse of
// the keep probability (deepspeed_tpu/ops/flash_attention.py
// _quantized_threshold / _keep_scale, 8-bit mode).  threshold 256 means
// no dropout.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 ds_philox4x32_10(uint4 c, uint32_t k0,
                                                  uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// The 16 keep bytes of columns n0 + lane4 + 4 * i (i = 0..15) of `row`,
// n0 a multiple of 64 and lane4 in [0, 4).
__device__ __forceinline__ uint4 ds_dropout_bytes(uint32_t seed, uint32_t bh,
                                                  int row, int n0,
                                                  int lane4) {
  return ds_philox4x32_10(
      make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(n0 >> 6),
                 static_cast<uint32_t>(lane4), 0u),
      seed, bh);
}

__device__ __forceinline__ uint32_t ds_byte(const uint4& w, int i) {
  const uint32_t word = (i >> 2) == 0 ? w.x : (i >> 2) == 1 ? w.y
                        : (i >> 2) == 2 ? w.z : w.w;
  return (word >> (8 * (i & 3))) & 0xFFu;
}
