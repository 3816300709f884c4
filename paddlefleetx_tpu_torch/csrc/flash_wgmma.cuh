// The wgmma building blocks of the bf16 attention kernels: kernel 1's
// forward (csrc/flash_fwd.cu) and kernels 3 and 4's backward
// (csrc/flash_bwd.cu). Operands are [b, s, h, d] bf16 tensors read by
// TMA in boxes of 64 d values x 1 head x R rows (128-byte swizzle), a
// tile of R rows being D / 64 such boxes (one per 64-wide chunk of d,
// R * 128 bytes apart). Accumulators are in wgmma's m64nN layout:
// element 4 j + 2 hh + u of a thread of warp w, lane 4 g + t, is row
// 16 w + g + 8 hh, column 8 j + 2 t + u.
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace pfx {
namespace attn {

constexpr int kTile = 64;          // rows of a TMA box and of a block
constexpr int kBox = kTile * 128;  // bytes of a box: 64 x 64 bf16, swizzled
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;      // one warpgroup a block

// mbar_wait that traps after ~10 s (2e10 cycles) instead of spinning
// forever, so that a pipeline fault fails its launch rather than hanging
// the card; the clock is read only once a first poll has failed.
static __device__ __forceinline__ void bar_wait(uint64_t* bar,
                                                uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

// 2^x on the MUFU unit (ex2.approx.ftz: within 2 ulp; results below the
// normal range flush to 0).
static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from reusing kN k16 steps' A registers before the
// asynchronous products that read them are done.
template <int kN = 4>
static __device__ __forceinline__ void fence_u32(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The A fragments of the K / 16 k16 steps over a K-column accumulator
// (columns 16 kk .. 16 kk + 15 are accumulator blocks 2 kk and 2 kk + 1).
template <int K = kTile>
static __device__ __forceinline__ void acc_to_a(const float* d,
                                                uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// S (+)= A B^T over the head dim: A a K-major 64-row tile, B a K-major
// N-row tile (N 64 or 128), m64nN, D / 16 k16 steps; the first step
// overwrites S.
template <int D, int N = kTile>
static __device__ __forceinline__ void product_rows(float* d,
                                                    const unsigned char* a,
                                                    const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk % 4) * 32;
    const uint64_t da = wg_desc(a + (kk / 4) * kBox + col, 16, 1024);
    const uint64_t db = wg_desc(b + (kk / 4) * N * 128 + col, 16, 1024);
    if constexpr (N == 64)
      wgmma_m64n64_ss<0, 0>(d, da, db, kk > 0);
    else
      wgmma_m64n128_ss<0, 0>(d, da, db, kk > 0);
  }
}

// acc += A B over the K rows of a tile (K 64 or 128): A (64 x K, from
// registers) times the tile read MN-major (its K rows the reduction, its
// D columns the output's), m64nD, K / 16 k16 steps.
template <int D, int K = kTile>
static __device__ __forceinline__ void product_acc(float* acc,
                                                   uint32_t (*a)[4],
                                                   const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = wg_desc(b + kk * 2048, K * 128, 1024);
    if constexpr (D == 64)
      wgmma_m64n64_rs<1>(acc, a[kk], db);
    else
      wgmma_m64n128_rs<1>(acc, a[kk], db);
  }
}

// Four keep bits of one Philox group, bit i for key (col & ~3) + i.
static __device__ __forceinline__ uint32_t keep_nibble(const Dropout& drop,
                                                       int bh, int row,
                                                       int col) {
  const uint4 w = drop.group(bh, row, col);
  return static_cast<uint32_t>(drop.keep(w.x)) |
         static_cast<uint32_t>(drop.keep(w.y)) << 1 |
         static_cast<uint32_t>(drop.keep(w.z)) << 2 |
         static_cast<uint32_t>(drop.keep(w.w)) << 3;
}

// The keep bits of a 64-key block of an m64n64 score accumulator (rows
// queries, columns keys n0 ..): the lanes t and t ^ 1 hold two keys each
// of the same key quads, so this lane draws the 8 Philox groups (hh, j)
// with j % 2 == t % 2 (row_r[hh], keys n0 + 8 j + 4 (t / 2) ..) and one
// shuffle swaps the words: `even` holds the groups of even j, `odd` those
// of odd j. Element e = 4 j + 2 hh + u is then kept iff
// keep_bit(even, odd, e).
static __device__ __forceinline__ void keep_words(const Dropout& drop, int bh,
                                                  const int* row_r, int n0,
                                                  int t, uint32_t* even,
                                                  uint32_t* odd) {
  const int par = t & 1;
  uint32_t w = 0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = 2 * (n & 3) + par;
    w |= keep_nibble(drop, bh, row_r[n >> 2], n0 + 8 * j + 4 * (t >> 1))
         << (4 * n);
  }
  const uint32_t other = __shfl_xor_sync(kFullMask, w, 1) >> (2 * par);
  w >>= 2 * par;
  *even = par ? other : w;
  *odd = par ? w : other;
}

// Element e = 4 j + 2 hh + u of the block: key 2 t + u of quad (hh, j),
// bit 4 (4 hh + j / 2) + 2 (t % 2) + u of the word of j's parity (the
// words as keep_words shifted them); the word is picked at compile time.
static __device__ __forceinline__ bool keep_bit(uint32_t even, uint32_t odd,
                                                int e) {
  const int j = (e >> 2) & 7, hh = (e >> 1) & 1, u = e & 1;
  return (((j & 1) ? odd : even) >> (4 * (4 * hh + (j >> 1)) + u)) & 1u;
}

// The epilogue's staging: the warpgroup's 64 rows of `acc` (row hh of
// this thread times scale[hh]) as bf16 into the swizzled boxes at `st`,
// as TMA stores them.
template <int D>
static __device__ __forceinline__ void store_rows(const float* acc,
                                                  const float* scale,
                                                  unsigned char* st,
                                                  int tid) {
  const int r = (tid / 32) * 16 + (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(st + (j / 8) * kBox +
                                   swz(r + 8 * hh, 16 * (j % 8) + 4 * t)) =
          pack_bf16(acc[4 * j + 2 * hh] * scale[hh],
                    acc[4 * j + 2 * hh + 1] * scale[hh]);
}

// The 4-D tensor map of a [b, s, h, d] bf16 tensor, dims {d, h, s, b},
// boxes of 64 d values x 1 head x `rows` rows (rows * 128 bytes,
// swizzled).
inline bool map_bshd(CUtensorMap* map, const void* p, int b, int s, int h,
                     int d, int rows = kTile) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(h) * d * 2,
                                 static_cast<cuuint64_t>(s) * h * d * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_tensor_map(map, p, 4, dims, strides, box);
}

}  // namespace attn
}  // namespace pfx
