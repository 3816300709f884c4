// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11; the Random123 constants) and the attention-dropout
// keep decision built on it.
//
// The keep mask of score element (bh, row, col) -- row a query, col a
// key, bh = batch * heads + head -- is a pure function of absolute
// coordinates:
//
//   bits = philox4x32_10(ctr = {col >> 2, row, bh, 0},
//                        key = {seed_lo, seed_hi})[col & 3]
//   keep = bits < threshold,  threshold = min(2^32 - 1,
//                                             round((1 - rate) * 2^32))
//
// (the threshold of the TPU kernel's `_dropout_threshold`,
// paddlefleetx_tpu/ops/pallas/flash_attention.py:62-67). It does not
// depend on any tile size, so the forward kernel, both backward kernels
// and the plain PyTorch version (ops/cuda/philox.py) rebuild the same
// mask whatever tiles they walk. One call yields the bits of four
// neighbouring keys of one row.
#pragma once

#include <stdint.h>

namespace pfx {

// Ten Philox rounds over a 128-bit counter.
static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                                      uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// What a kernel needs to drop attention probabilities: the seed split
// into the Philox key, the keep threshold and 1 / (1 - rate).
struct Dropout {
  uint32_t k0, k1, threshold;
  float scale;

  // The four words of keys (col & ~3) .. (col | 3) of `row`.
  __device__ __forceinline__ uint4 group(int bh, int row, int col) const {
    return philox4x32_10(
        make_uint4(static_cast<uint32_t>(col) >> 2,
                   static_cast<uint32_t>(row), static_cast<uint32_t>(bh),
                   0u),
        k0, k1);
  }
  __device__ __forceinline__ bool keep(uint32_t bits) const {
    return bits < threshold;
  }
  // Whether element (bh, row, col) is kept.
  __device__ __forceinline__ bool keep(int bh, int row, int col) const {
    const uint4 w = group(bh, row, col);
    const int i = col & 3;
    return keep(i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w);
  }
  // Keep bits of the key pair (col, col + 1), col even.
  __device__ __forceinline__ void keep_pair(int bh, int row, int col,
                                            bool* out) const {
    const uint4 w = group(bh, row, col);
    const bool lo = (col & 3) == 0;
    out[0] = keep(lo ? w.x : w.z);
    out[1] = keep(lo ? w.y : w.w);
  }
};

static inline Dropout make_dropout(unsigned long long seed,
                                   unsigned int threshold, float scale) {
  Dropout d;
  d.k0 = static_cast<uint32_t>(seed & 0xffffffffull);
  d.k1 = static_cast<uint32_t>(seed >> 32);
  d.threshold = threshold;
  d.scale = scale;
  return d;
}

}  // namespace pfx
