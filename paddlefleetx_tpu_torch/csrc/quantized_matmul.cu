// Weight-only int8 matmul for Hopper (sm_90a): kernel 7 of the port, the
// dense sites (qkv, out, fc1, fc2) under `quant_execution:
// weight_only_int8`, and its dx route, the input gradient of those sites.
//
// Replaces: paddlefleetx_tpu/ops/pallas/quantized_matmul.py `_qmm_kernel`
// (:44, launched by `_qmm_call`, pallas_call at :83), both where the
// forward launches it and where `_quantized_matmul_bwd` (:129-145)
// launches it again for the gradient. The forward computes
//   out[m, n] = (sum_k x[m, k] * float(w[n, k])) * scale[n]
// with an fp32 accumulator and the per-output-channel scale applied once
// at the write-out (exact: a factor per n commutes with the sum over k),
// cast to x's type. x is [M, K] bf16 or fp32, w the frozen int8 weight
// [N, K] (nn.Linear's layout, K contiguous), scale [N] fp32, out [M, N].
// The dx route computes
//   dx[m, k] = sum_n gs[m, n] * float(w[n, k])
// with gs = (g * scale) rounded to g's type by the wrapper, as the TPU
// route rounds it before its product, and no write-out scale (the TPU
// route passes unit scales): the reduction axis is N and the weight is
// the same [N, K] storage, read the other way. No transposed or widened
// copy of the weight exists in device memory on any route. K and N are
// multiples of 128 (the TPU kernel's admission, checked by the wrapper);
// M is any positive count (the TPU kernel asked for M % 8 == 0).
//
// Each call takes one of four routes, chosen from its shape by the
// wrapper's planner (ops/cuda/quantized_matmul.py `plan`) and passed in
// as `route` with a cluster size `splits`. A route that cannot take the
// shape returns cudaErrorInvalidValue (no route yields to another).
// Every route is one launch, uses no atomics, and sums in an order fixed
// by the shape and `splits`, so a relaunch is bit-equal.
//
// stream (bf16, M <= 32: the decode tick at M 8-16). What bounds it: the
//   int8 weight's bytes (M FLOPs a byte, far below the H100's ~295 bf16
//   FLOP/B; fc2 at M 16 moves 4 MB, 1.25 us at 3.35 TB/s), then the
//   latency of one launch. The first design gave each 64 x 64 tile one
//   block walking all of K with one 4 KB tile in flight: 16 blocks for
//   132 SMs at N 1024, 72 GB/s. The design: a cluster of `splits` blocks
//   (at most 8, the portable size) splits the reduction of each 64
//   output channels, so every site launches 64-256 blocks; each block
//   issues its whole slice (at most 512 deep: 32 KB of int8 and M x 1 KB
//   of bf16 activations) at once as TMA boxes, one mbarrier per 128-deep
//   stage, so one DRAM round trip covers the call. The operands are
//   swapped: the 64 output channels are the product's M side and the
//   tokens its N side (n8 tiles; rows past M arrive as zeros and are not
//   stored). mma.sync m16n8k16 (at these shapes the tensor cores are
//   idle whichever instruction feeds them); 8 warps, 4 m16 tiles x 2
//   halves of the slice. The forward permutes each 32-deep chunk's k
//   order alike in both operands, so a thread's A fragment of a row is
//   one 8-byte int8 load and its B fragment of a token one 16-byte load;
//   the dx route's A (w^T) comes from the int8 tile as stored by one
//   ldmatrix.trans of its bytes read as 16-bit pairs. Weight bytes are
//   widened four at a time by byte permutes (`widen4`). The reduction
//   reads no other block's memory: each warp pushes its partial rows
//   with st.async into the block that owns those channels, counted in
//   bytes on that block's mbarrier, and each block sums its channels'
//   2 x splits partials in a fixed order, scales (forward), casts and
//   stores; one cluster barrier, arrived at before the products and
//   waited for after them, orders the mbarriers' set-up before any push.
// wgmma (bf16, M > 32: the verify window at 80, a paged prefill chunk at
//   256, a contiguous prompt up to 512, the gradient phase's 4096;
//   forward and dx). What bounds it: the products on the tensor cores at
//   M 4096 (2 M K N FLOPs against a few MB), the weight bytes and the
//   fill of the card below. The first design ran mma.sync on 64 x 64
//   tiles with one register-staged tile, at 17 % of the bound at M 4096.
//   A first wgmma design widened the weight into a swizzled bf16 tile in
//   shared memory for wgmma's B: its shared-memory traffic (96 KB a
//   2.1-MFLOP stage: TMA in, the widening's read and write, both
//   operands read by every product) held it near 36 % of the bound. The
//   design: the product is out^T, so the weight is wgmma's A operand,
//   widened in the consumers' registers (wgmma's register-A form) and
//   never written back; the activations are its B, read K-major as TMA
//   stored them. Tiles of 128 channels x 128 tokens, two consumer
//   warpgroups of 64 channels each on wgmma m64n128k16, one producer
//   thread keeping a ring of 64-deep TMA stages in flight (the
//   activations' 16 KB box, 128-byte swizzle; the int8 weight's 8 KB
//   box as stored). A consumer widens the next stage's fragments while
//   the current stage's products run, into a second register set
//   (keeping a further group of products queued, by a third set or by
//   widening after a partial wait, ran slower). The forward reads each
//   fragment register's two bytes with one 4-byte load of the [n][64 k]
//   box (64-byte swizzle: a load's eight rows fall in distinct banks);
//   dx takes w^T with ldmatrix.trans on the [n][128 k] box (128-byte
//   swizzle), as the stream route does, which pairs a thread's two
//   accumulator rows as neighbouring channels. One kernel, templated on
//   kDx, covers both. The grid is persistent (one block an SM, channel
//   tile fastest); the epilogue scales (forward), casts, stages a
//   swizzled [128][64] box per warpgroup and stores it with TMA. Where
//   the tiles fill under half the card (M up to 256 at every site, 512
//   at out and fc2: 8-64 tiles), a cluster of 2, 4 or 8 blocks splits
//   the reduction of each tile instead (one tile a cluster, no more
//   clusters than the card holds at once: 66, 30 and 15 at one block an
//   SM), each block laying its fp32 partial tile over its ring and each
//   rank summing a share of the tokens in rank order through distributed
//   shared memory (64-row tiles would leave fc2 at M 512 with 64 blocks
//   each walking all 4096 of K).
// mma (bf16, the first design of this kernel, kept as a route the
//   planner sends no shape to): 128 threads, one 64 x 64 output tile a
//   block, 64-deep K tiles of x and of the widened weight staged in
//   shared memory (rows padded by 16 bytes), the next tile's global
//   loads issued into registers before the current tile's products;
//   mma.sync m16n8k16; the dx instance stages the weight tile as read and
//   takes B fragments with ldmatrix.trans.
// f32 (fp32 x, the parity route): the fp32 CUDA cores (TF32 would miss
//   fp32 parity), 256 threads each owning a 4 x 4 block of a 64 x 64 tile,
//   32-deep K tiles staged transposed; every output sums its K products
//   in order with fused multiply-adds; the dx instance fills the weight
//   tile from rows of k directly.
//
// Built for sm_90a with -Xptxas -v on the H100's machine (CUDA 12.8),
// registers a thread: qmm_wgmma_kernel 158 (forward) / 146 (dx),
// qmm_stream_kernel 55-63, qmm_mma_kernel 119 / 120, no spills;
// qmm_f32_kernel 48 (the forward, 8 bytes spilled) / 55.
//
// TMA's cuTensorMapEncodeTiled comes through the runtime's entry-point
// query (csrc/hopper.cuh), so the library links against nothing else.

#include <cooperative_groups.h>
#include <cuda.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using pfx::mapa;
using pfx::mbar_wait_cluster;
using pfx::st_async2;
using pfx::widen4;

// ---- route mma (bf16) and the fp32 kernel: the first design -----------


constexpr int kBM = 64;   // output rows of a tile
constexpr int kBN = 64;   // output columns of a tile

// ---- bf16 activations on the tensor cores -------------------------------

constexpr int kMmaThreads = 128;
constexpr int kMmaBK = 64;   // K depth of a staged tile
constexpr int kPad = 8;      // bf16 elements of row padding (16 B)
constexpr int kXLoads = kBM * kMmaBK / 8 / kMmaThreads;    // uint4 of x
constexpr int kWLoads = kBN * kMmaBK / 16 / kMmaThreads;   // uint4 of w

// Sixteen int8 weights widened to bf16 (exact: |w| <= 127) into dst.
__device__ __forceinline__ void widen16(const uint4& r, __nv_bfloat16* dst) {
  const uint32_t words[4] = {r.x, r.y, r.z, r.w};
  uint32_t packed[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = words[i / 2];
    const int sh = 16 * (i % 2);
    const float lo = static_cast<float>(
        static_cast<int8_t>((word >> sh) & 0xffu));
    const float hi = static_cast<float>(
        static_cast<int8_t>((word >> (sh + 8)) & 0xffu));
    packed[i] = pfx::pack_bf16(lo, hi);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  d[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// out [M, N] = x [M, K] @ B, B (k, n) = w[n K + k] (forward) or, with
// kDx, w[k N + n] (the dx route: here K is the gradient's reduction axis
// and N its output axis); the write-out multiplies by scale[n] unless
// kDx.
template <bool kDx>
__global__ void __launch_bounds__(kMmaThreads)
    qmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  static_assert(kBN == kMmaBK, "the widened tile is square either way");
  __shared__ __align__(16) __nv_bfloat16 xs[kBM][kMmaBK + kPad];
  // [n][k] for the forward, [k][n] (as read) for the dx route
  __shared__ __align__(16) __nv_bfloat16 ws[kBN][kMmaBK + kPad];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row group
  const int t = lane % 4;   // thread within the group
  // m16 tiles of this block that hold a row below M (uniform per block)
  const int live_mt = min(4, (M - m0 + 15) / 16);

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 xr[kXLoads], wr[kWLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int row = m0 + idx / (kMmaBK / 8);
      const int c8 = (idx % (kMmaBK / 8)) * 8;
      xr[i] = row < M ? pfx::load_raw(x + (long long)row * K + k0 + c8)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int r = idx / (kMmaBK / 16);
      const int c16 = (idx % (kMmaBK / 16)) * 16;
      wr[i] = kDx ? pfx::load_raw(w + (long long)(k0 + r) * N + n0 + c16)
                  : pfx::load_raw(w + (long long)(n0 + r) * K + k0 + c16);
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    __syncthreads();   // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + i * kMmaThreads;
      *reinterpret_cast<uint4*>(
          &xs[idx / (kMmaBK / 8)][(idx % (kMmaBK / 8)) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kMmaThreads;
      widen16(wr[i], &ws[idx / (kMmaBK / 16)][(idx % (kMmaBK / 16)) * 16]);
    }
    __syncthreads();
    if (k0 + kMmaBK < K) load(k0 + kMmaBK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      uint32_t b[2][2];
      if constexpr (kDx) {
        // matrices (k lo, n lo), (k hi, n lo), (k lo, n hi), (k hi, n hi)
        const int mat = lane / 8, i = lane % 8;
        uint32_t r[4];
        pfx::ldsm_x4_trans(r, &ws[kk * 16 + (mat & 1) * 8 + i]
                                 [warp * 16 + (mat >> 1) * 8]);
        b[0][0] = r[0];
        b[0][1] = r[1];
        b[1][0] = r[2];
        b[1][1] = r[3];
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* wrow = &ws[warp * 16 + nt * 8 + g][c];
          b[nt][0] = pfx::ld_u32(wrow);
          b[nt][1] = pfx::ld_u32(wrow + 8);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < live_mt) {
          const uint32_t a[4] = {pfx::ld_u32(&xs[mt * 16 + g][c]),
                                 pfx::ld_u32(&xs[mt * 16 + g + 8][c]),
                                 pfx::ld_u32(&xs[mt * 16 + g][c + 8]),
                                 pfx::ld_u32(&xs[mt * 16 + g + 8][c + 8])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            pfx::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }

  // write-out: the scale of each column (the forward), then the cast
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = n0 + warp * 16 + nt * 8 + t * 2;
    const float s0 = kDx ? 1.f : scale[col];
    const float s1 = kDx ? 1.f : scale[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mt * 16 + g + 8 * half;
        if (mt < live_mt && row < M) {
          const float v0 = acc[mt][nt][2 * half];
          const float v1 = acc[mt][nt][2 * half + 1];
          *reinterpret_cast<uint32_t*>(out + (long long)row * N + col) =
              kDx ? pfx::pack_bf16(v0, v1)
                  : pfx::pack_bf16(__fmul_rn(v0, s0), __fmul_rn(v1, s1));
        }
      }
    }
  }
}

// ---- fp32 activations on the CUDA cores ---------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BK = 32;

// The fp32 twin of qmm_mma_kernel, the same operands and kDx.
template <bool kDx>
__global__ void __launch_bounds__(kF32Threads)
    qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int N, int K) {
  // staged transposed ([k][row], [k][col]) with rows padded by 16 bytes
  __shared__ __align__(16) float xs[kF32BK][kBM + 4];
  __shared__ __align__(16) float ws[kF32BK][kBN + 4];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int ty = tid / 16;   // rows 4 ty .. 4 ty + 3 of the tile
  const int tx = tid % 16;   // columns 4 tx .. 4 tx + 3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    __syncthreads();   // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kBM * kF32BK / 4 / kF32Threads; ++i) {
      const int idx = tid + i * kF32Threads;
      const int r = idx / (kF32BK / 4);
      const int c4 = (idx % (kF32BK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        v = *reinterpret_cast<const float4*>(x + (long long)(m0 + r) * K +
                                             k0 + c4);
      xs[c4][r] = v.x;
      xs[c4 + 1][r] = v.y;
      xs[c4 + 2][r] = v.z;
      xs[c4 + 3][r] = v.w;
    }
    if (tid < kBN * kF32BK / 16) {
      if constexpr (kDx) {
        // a row of k, 16 output columns n as read
        const int kr = tid / (kBN / 16);
        const int c16 = (tid % (kBN / 16)) * 16;
        const uint4 r =
            pfx::load_raw(w + (long long)(k0 + kr) * N + n0 + c16);
        const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          ws[kr][c16 + e] = static_cast<float>(static_cast<int8_t>(
              (words[e / 4] >> (8 * (e % 4))) & 0xffu));
      } else {
        const int col = tid / (kF32BK / 16);
        const int c16 = (tid % (kF32BK / 16)) * 16;
        const uint4 r =
            pfx::load_raw(w + (long long)(n0 + col) * K + k0 + c16);
        const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          ws[c16 + e][col] = static_cast<float>(static_cast<int8_t>(
              (words[e / 4] >> (8 * (e % 4))) & 0xffu));
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }

  const int col = n0 + tx * 4;
  const float4 s = kDx ? make_float4(1.f, 1.f, 1.f, 1.f)
                       : *reinterpret_cast<const float4*>(scale + col);
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < M) {
      *reinterpret_cast<float4*>(out + (long long)row * N + col) =
          kDx ? make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3])
              : make_float4(__fmul_rn(acc[i][0], sv[0]),
                            __fmul_rn(acc[i][1], sv[1]),
                            __fmul_rn(acc[i][2], sv[2]),
                            __fmul_rn(acc[i][3], sv[3]));
    }
  }
}

// ---- the byte-permute widening of the stream and wgmma routes -----------

// Two bf16 from two bytes of `word` (byte 2 h and 2 h + 1, the first in
// the low half), exactly, by widen4's byte permutes.
__device__ __forceinline__ uint32_t widen2(uint32_t word, int h) {
  const uint32_t u = word ^ 0x80808080u;
  const uint32_t sel = 0x7650u | (2u * h);
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                          sel)),
                             8388736.f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                          sel + 1)),
                             8388736.f);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Bytes 0 and 2 (even), 1 and 3 (odd) of `word` as two bf16 pairs.
__device__ __forceinline__ void widen4_pairs(uint32_t word, uint32_t& even,
                                             uint32_t& odd) {
  uint32_t lo, hi;   // bytes (0, 1), (2, 3)
  widen4(word, lo, hi);
  even = __byte_perm(lo, hi, 0x5410);
  odd = __byte_perm(lo, hi, 0x7632);
}

// ---- route stream: decode-sized M, bound by the int8 weight's bytes ----

constexpr int kStThreads = 256;    // 8 warps: 4 m16 tiles x 2 halves
constexpr int kStTile = 64;        // output channels of a cluster's tile
constexpr int kStStage = 128;      // reduction depth of one TMA stage
constexpr int kStMaxSlice = 512;   // a block's reduction slice at most
constexpr int kStMaxM = 32;        // tokens at most (4 n8 tiles)

// The channels of a cluster's tile that each rank sums and stores.
__host__ __device__ inline int st_rows(int splits) {
  return (kStTile + splits - 1) / splits;
}
// Shared-memory layout from the 1024-byte aligned base: stage b's weight
// box (8 KB) at b * 8192, its two activation boxes (mpad rows of 128
// bytes each) after all weight boxes, the stages' mbarriers and the
// reduction's, then the slots the cluster's blocks push their partials
// into: [2 splits][st_rows][mpad] fp32.
__host__ __device__ inline int st_x_off(int stages) { return stages * 8192; }
__host__ __device__ inline int st_bar_off(int stages, int mpad) {
  return stages * (8192 + 2 * mpad * 128);
}
__host__ __device__ inline int st_slot_off(int stages, int mpad) {
  return (st_bar_off(stages, mpad) + 8 * (stages + 1) + 15) & ~15;
}
__host__ __device__ inline int st_smem(int stages, int mpad, int splits) {
  return 1024 + st_slot_off(stages, mpad) +
         2 * splits * st_rows(splits) * mpad * 4;
}

// One cluster of `splits` blocks per 64 output channels c0 .. c0 + 63;
// block `rank` reduces over r0 = rank * slice .. r0 + slice - 1. The
// forward: out [M, n_out] = x [M, red] @ w[c, r]^T * scale[c] (map_w:
// int8 [n_out rows, red], box 128 x 64, 128-byte swizzle). The dx route:
// out [M, n_out] = gs [M, red] @ w[r, c] (map_w: int8 [red rows, n_out],
// box 64 x 128, 64-byte swizzle). map_x: the bf16 activations [M, red],
// box 64 x mpad, 128-byte swizzle (rows past M arrive as zeros). kT: n8
// token tiles the accumulators hold (>= ceil(M / 8)).
template <bool kDx, int kT>
__global__ void __launch_bounds__(kStThreads)
    qmm_stream_kernel(const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_x,
                      const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, int M, int n_out,
                      int slice) {
  extern __shared__ unsigned char st_raw[];
  unsigned char* base =
      st_raw + ((1024 - (pfx::smem_addr(st_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / splits) * kStTile;
  const int r0 = rank * slice;
  const int stages = slice / kStStage;
  const int T = (M + 7) / 8;
  const int mpad = 8 * T;
  const int xbox = mpad * 128;
  const int rows = st_rows(splits);
  const int own = min(rows, kStTile - rank * rows);   // channels summed here
  unsigned char* xs = base + st_x_off(stages);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + st_bar_off(stages, mpad));
  uint64_t* red = bar + stages;
  float* slots = reinterpret_cast<float*>(base + st_slot_off(stages, mpad));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp & 3, half = warp >> 2;

  // the block's whole slice in flight at once: one TMA box of the
  // weight and two of the activations per 128-deep stage; the reduction
  // barrier expects the bytes every block of the cluster will push here
  if (tid == 0) {
    for (int b = 0; b < stages; ++b) pfx::mbar_init(&bar[b], 1);
    pfx::mbar_init(red, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    pfx::mbar_expect_tx(red, 2u * splits * own * mpad * 4);
    for (int b = 0; b < stages; ++b) {
      const int r = r0 + b * kStStage;
      pfx::mbar_expect_tx(&bar[b], 8192u + 2u * xbox);
      if (kDx)
        pfx::tma_load_2d(base + b * 8192, &map_w, &bar[b], c0, r);
      else
        pfx::tma_load_2d(base + b * 8192, &map_w, &bar[b], r, c0);
      pfx::tma_load_2d(xs + 2 * b * xbox, &map_x, &bar[b], r, 0);
      pfx::tma_load_2d(xs + (2 * b + 1) * xbox, &map_x, &bar[b], r + 64, 0);
    }
  }
  // every block's reduction barrier exists before any block pushes to it
  // (waited for after the products)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  float acc[kT][4];
#pragma unroll
  for (int tt = 0; tt < kT; ++tt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[tt][e] = 0.f;

  // Warp (mt, half) owns output channels 16 mt .. 16 mt + 15 (the
  // product's M side: the operands are swapped, the tokens are its N
  // side) over the 32-deep chunks c = half, half + 2, ... of the slice.
#pragma unroll 4
  for (int i = 0; i < slice / 64; ++i) {
    const int c = 2 * i + half;
    const int b = c >> 2, s = c & 3;
    pfx::mbar_wait(&bar[b], 0);
    const unsigned char* wb = base + b * 8192;
    const unsigned char* xb = xs + (2 * b + (s >> 1)) * xbox;
    uint32_t a[2][4];
    if constexpr (!kDx) {
      // The chunk's k order is permuted alike in both operands (it is
      // the reduction axis): thread t's k16 steps 0 and 1 take physical
      // k 8t .. 8t + 3 and 8t + 4 .. 8t + 7, so its A fragment of a row
      // is one 8-byte load of int8 and its B fragment of a token one
      // 16-byte load of bf16.
      const int byte = 32 * s + 8 * t;
      const uint2 w0 = *reinterpret_cast<const uint2*>(
          wb + pfx::swz(mt * 16 + g, byte));
      const uint2 w1 = *reinterpret_cast<const uint2*>(
          wb + pfx::swz(mt * 16 + g + 8, byte));
      widen4(w0.x, a[0][0], a[0][2]);
      widen4(w1.x, a[0][1], a[0][3]);
      widen4(w0.y, a[1][0], a[1][2]);
      widen4(w1.y, a[1][1], a[1][3]);
      const int xbyte = 64 * (s & 1) + 16 * t;
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        if (tt < T) {
          const uint4 xv = *reinterpret_cast<const uint4*>(
              xb + pfx::swz(tt * 8 + g, xbyte));
          pfx::mma_bf16(acc[tt], a[0], xv.x, xv.y);
          pfx::mma_bf16(acc[tt], a[1], xv.z, xv.w);
        }
      }
    } else {
      // A = w^T (rows: output channels, columns: the reduction n), read
      // from the weight as stored ([n][k]) with one ldmatrix.trans of the
      // bytes as 16-bit pairs: a thread gets (n 2t, k 2g), (2t, 2g + 1),
      // (2t + 1, 2g), (2t + 1, 2g + 1), so A row g is channel 16 mt + 2 g
      // and row g + 8 channel 16 mt + 2 g + 1
      uint32_t r[4];
      pfx::ldsm_x4_trans(r, reinterpret_cast<const __nv_bfloat16*>(
                                wb + pfx::swz64(32 * s + lane, mt * 16)));
      widen4_pairs(r[0], a[0][0], a[0][1]);
      widen4_pairs(r[1], a[0][2], a[0][3]);
      widen4_pairs(r[2], a[1][0], a[1][1]);
      widen4_pairs(r[3], a[1][2], a[1][3]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int xbyte = 64 * (s & 1) + 32 * q + 4 * t;
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          if (tt < T) {
            const int row = tt * 8 + g;
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(xb + pfx::swz(row, xbyte));
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
                xb + pfx::swz(row, xbyte + 16));
            pfx::mma_bf16(acc[tt], a[q], b0, b1);
          }
        }
      }
    }
  }

  // Each warp pushes its partial rows into slot 2 rank + half of the
  // block that owns them (channels q * rows .. of rank q); each block
  // then sums its channels' 2 splits slots in slot order, scales (the
  // forward), casts and stores. No block reads another's memory, so
  // none waits for the others to finish.
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const uint32_t slots_a = pfx::smem_addr(slots), red_a = pfx::smem_addr(red);
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {   // accumulator rows g and g + 8
    const int ch = kDx ? mt * 16 + 2 * g + e2 : mt * 16 + g + 8 * e2;
    const int q = ch / rows, rr = ch - q * rows;
    const uint32_t dst =
        mapa(slots_a + 4 * ((2 * rank + half) * rows + rr) * mpad, q);
    const uint32_t rb = mapa(red_a, q);
#pragma unroll
    for (int tt = 0; tt < kT; ++tt)
      if (tt < T)
        st_async2(dst + 4 * (tt * 8 + 2 * t), acc[tt][2 * e2],
                  acc[tt][2 * e2 + 1], rb);
  }
  mbar_wait_cluster(red, 0);
  for (int e = tid; e < own * M; e += kStThreads) {
    const int rr = e % own, token = e / own;
    const float* sp = slots + rr * mpad + token;
    float sum = sp[0];
    for (int j = 1; j < 2 * splits; ++j) sum += sp[j * rows * mpad];
    const int ch = c0 + rank * rows + rr;
    out[(long long)token * n_out + ch] =
        __float2bfloat16(kDx ? sum : __fmul_rn(sum, scale[ch]));
  }
}

// ---- route wgmma: large M, and the dx route at the gradient's M -------

constexpr int kWgThreads = 384;   // consumers 0-255, producer thread 256
constexpr int kWgBN = 128;        // output channels (weight rows) a tile
constexpr int kWgBM = 128;        // tokens a tile
constexpr int kWgBK = 64;         // reduction depth of a stage
constexpr int kWgX = kWgBM * kWgBK * 2;   // the activations' box, 16 KB
constexpr int kWgW = kWgBN * kWgBK;       // the int8 weight box, 8 KB
constexpr int kWgStage = kWgX + kWgW;
// A persistent block (splits 1) keeps a ring of 6 stages beside its
// staged output (two [128][64] bf16 boxes); a block of a cluster that
// splits the reduction has one tile, and lays its fp32 partial tile over
// a ring of 4 once its products are done, so two blocks fit on an SM.
constexpr int kWgRingPersistent = 6, kWgRingSplit = 4;
constexpr int kWgStaging = 2 * kWgBM * 128;
constexpr int kWgPartial = kWgBN * kWgBM * 4;
static_assert(kWgPartial <= kWgRingSplit * kWgStage, "the partial fits");
__host__ __device__ constexpr int wg_stages(int splits) {
  return splits == 1 ? kWgRingPersistent : kWgRingSplit;
}
__host__ __device__ constexpr int wg_bar_off(int splits) {
  return wg_stages(splits) * kWgStage + (splits == 1 ? kWgStaging : 0);
}
__host__ __device__ constexpr int wg_smem(int splits) {
  return 1024 + wg_bar_off(splits) + 2 * wg_stages(splits) * 8;
}

// The A fragments of one stage (four k16 steps): the int8 weight tile
// widened in registers.
// Forward: the tile is [128 n][64 k] as read (64-byte swizzle); A rows g
// and g + 8 of warp w are channels 16 w + g and 16 w + g + 8 (of the
// warpgroup's 64), and each fragment register is two bytes of one row,
// one 4-byte load (the eight rows g of a load fall in distinct banks
// under the swizzle).
// dx: the tile is [64 n][128 k] as read (128-byte swizzle), the channels
// its columns; ldmatrix.trans on the bytes read as 16-bit pairs gives a
// thread (n = 2t, k = 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1),
// two fragment registers' worth, so A rows g and g + 8 are channels
// 16 w + 2 g and 16 w + 2 g + 1.
template <bool kDx>
__device__ __forceinline__ void weight_frags(const unsigned char* w,
                                             int ch0, int lane,
                                             uint32_t (*a)[4]) {
  const int g = lane / 4, t = lane % 4;
  if constexpr (kDx) {
    const int mat = lane >> 3, i = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      uint32_t r[4];
      pfx::ldsm_x4_trans(r, reinterpret_cast<const __nv_bfloat16*>(
                                w + pfx::swz(16 * kk + 8 * mat + i, ch0)));
      widen4_pairs(r[0], a[kk][0], a[kk][1]);
      widen4_pairs(r[1], a[kk][2], a[kk][3]);
      widen4_pairs(r[2], a[kk + 1][0], a[kk + 1][1]);
      widen4_pairs(r[3], a[kk + 1][2], a[kk + 1][3]);
    }
  } else {
    const int r0 = ch0 + g, h = t & 1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int b = 16 * kk + 4 * (t >> 1);
      a[kk][0] = widen2(*reinterpret_cast<const uint32_t*>(
                            w + pfx::swz64(r0, b)), h);
      a[kk][1] = widen2(*reinterpret_cast<const uint32_t*>(
                            w + pfx::swz64(r0 + 8, b)), h);
      a[kk][2] = widen2(*reinterpret_cast<const uint32_t*>(
                            w + pfx::swz64(r0, b + 8)), h);
      a[kk][3] = widen2(*reinterpret_cast<const uint32_t*>(
                            w + pfx::swz64(r0 + 8, b + 8)), h);
    }
  }
}

// d += A B over a stage: A the weight fragments, B the activations box
// read K-major (kk steps 32 bytes in a row), four m64n128k16 products.
__device__ __forceinline__ void wg_product(float* d, const uint32_t (*a)[4],
                                           const __nv_bfloat16* x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    pfx::wgmma_m64n128_rs<0>(d, a[kk], pfx::wg_desc(x + kk * 16, 16, 1024));
}

__device__ __forceinline__ void fence_frags(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// A persistent grid over tiles of 128 output channels x 128 tokens
// (channel tile fastest), or, with a cluster of `splits` blocks, one tile
// a cluster and a slice of the reduction a block. The
// product is out^T: wgmma's A is the weight (from registers, widened
// there), its B the activations tile as TMA stored it (K-major). map_x:
// the bf16 activations [M, red] (x, or gs for dx), box 64 x 128, 128-byte
// swizzle. map_w: the int8 weight as stored, box 64 (k) x 128 (n) with
// 64-byte swizzle for the forward, 128 (k) x 64 (n) with 128-byte
// swizzle for dx. map_o: out [M, n_out] bf16, box 64 x 128, 128-byte
// swizzle. `red` is a multiple of 128 splits (whole pairs of stages).
template <bool kDx>
__global__ void __launch_bounds__(kWgThreads, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_o,
                     const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ out, int M, int n_out,
                     int red, int tiles_n, int tiles) {
  extern __shared__ unsigned char wg_raw[];
  unsigned char* base =
      wg_raw + ((1024 - (pfx::smem_addr(wg_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int stages = wg_stages(splits);
  unsigned char* so = base + stages * kWgStage;   // the staged output
  uint64_t* full = reinterpret_cast<uint64_t*>(base + wg_bar_off(splits));
  uint64_t* empty = full + stages;
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = red / splits;
  const int kbeg = rank * slice;
  const int steps = slice / kWgBK;   // even
  const int first = blockIdx.x / splits, stride = gridDim.x / splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      pfx::mbar_init(&full[s], 1);
      pfx::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // ---- producer: one thread issues every TMA load
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = first; tile < tiles; tile += stride) {
        const int c0 = (tile % tiles_n) * kWgBN;
        const int m0 = (tile / tiles_n) * kWgBM;
        for (int st = 0; st < steps; ++st) {
          const int k0 = kbeg + st * kWgBK;
          unsigned char* sx = base + stage * kWgStage;
          pfx::mbar_wait(&empty[stage], phase ^ 1);
          pfx::mbar_expect_tx(&full[stage], kWgStage);
          pfx::tma_load_2d(sx, &map_x, &full[stage], k0, m0);
          if (kDx)
            pfx::tma_load_2d(sx + kWgX, &map_w, &full[stage], c0, k0);
          else
            pfx::tma_load_2d(sx + kWgX, &map_w, &full[stage], k0, c0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    if (splits > 1) {   // the consumers' two cluster barriers a tile
      for (int tile = first; tile < tiles; tile += stride) {
        cluster.sync();
        cluster.sync();
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns channels c0 + 64 wg .. + 63; a
  // stage's weight fragments are widened while the previous stage's
  // products run, into the other of two register sets
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int ch0 = 64 * wg + 16 * warp;   // the warp's channels in the tile
  int stage = 0;
  uint32_t phase = 0;
  float d[kWgBM / 2];
  uint32_t a[2][4][4];
  for (int tile = first; tile < tiles; tile += stride) {
    const int c0 = (tile % tiles_n) * kWgBN;
    const int m0 = (tile / tiles_n) * kWgBM;
#pragma unroll
    for (int i = 0; i < kWgBM / 2; ++i) d[i] = 0.f;
    pfx::mbar_wait(&full[stage], phase);
    weight_frags<kDx>(base + stage * kWgStage + kWgX, ch0, lane, a[0]);
    for (int st = 0; st < steps; st += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(
            base + stage * kWgStage);
        pfx::fence_acc<kWgBM / 2>(d);
        pfx::wgmma_fence();
        wg_product(d, a[h], x);
        pfx::wgmma_commit();
        const int next = stage + 1 == stages ? 0 : stage + 1;
        const uint32_t nphase = next == 0 ? phase ^ 1 : phase;
        if (st + h + 1 < steps) {
          pfx::mbar_wait(&full[next], nphase);
          weight_frags<kDx>(base + next * kWgStage + kWgX, ch0, lane,
                            a[h ^ 1]);
        }
        pfx::wgmma_wait<0>();
        pfx::fence_acc<kWgBM / 2>(d);
        fence_frags(a[h]);
        __syncwarp();
        if (lane == 0) pfx::mbar_arrive(&empty[stage]);
        stage = next;
        phase = nphase;
      }
    }

    // d[4 j + 2 e + q]: channel c0 + ch0 + ce[e], token m0 + 8 j + 2 t +
    // q, with ce = (2 g, 2 g + 1) for dx and (g, g + 8) for the forward,
    // which scales each channel
    const int ce0 = kDx ? 2 * g : g, ce1 = kDx ? 2 * g + 1 : g + 8;
    float sc0 = 1.f, sc1 = 1.f;
    if (!kDx) {
      sc0 = scale[c0 + ch0 + ce0];
      sc1 = scale[c0 + ch0 + ce1];
    }
    if (splits == 1) {
      // the values into this warpgroup's swizzled [128][64] bf16 staging
      // box (dx: channel pairs as one word), then one TMA store (tokens
      // past M are not written); it runs on while the next tile's
      // products start
      unsigned char* stg = so + wg * (kWgBM * 128);
      if (tid == 0) pfx::bulk_wait_read();
      pfx::named_bar(1 + wg);   // the staging is free
#pragma unroll
      for (int j = 0; j < kWgBM / 8; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = 8 * j + 2 * t + q;
          if constexpr (kDx) {
            *reinterpret_cast<uint32_t*>(
                stg + pfx::swz(m, 2 * (16 * warp + ce0))) =
                pfx::pack_bf16(d[4 * j + q], d[4 * j + 2 + q]);
          } else {
            *reinterpret_cast<__nv_bfloat16*>(
                stg + pfx::swz(m, 2 * (16 * warp + ce0))) =
                __float2bfloat16(__fmul_rn(d[4 * j + q], sc0));
            *reinterpret_cast<__nv_bfloat16*>(
                stg + pfx::swz(m, 2 * (16 * warp + ce1))) =
                __float2bfloat16(__fmul_rn(d[4 * j + 2 + q], sc1));
          }
        }
      }
      pfx::fence_async_smem();
      pfx::named_bar(1 + wg);
      if (tid == 0) {
        pfx::tma_store_2d(&map_o, stg, c0 + 64 * wg, m0);
        pfx::bulk_commit();
      }
    } else {
      // the block's fp32 partial [token][channel] over the ring, once
      // both warpgroups' products are done (channel xor-swizzled by the
      // token, pairs kept together, against bank conflicts), then the
      // cluster's partials summed in rank order: rank r sums and stores
      // tokens r * 128 / splits .. + 128 / splits - 1
      float* part = reinterpret_cast<float*>(base);
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kWgBM / 8; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = 8 * j + 2 * t + q;
          const int sw = ((m >> 1) & 1) << 4;
          float* row = part + m * kWgBN;
          row[(ch0 + ce0) ^ sw] = d[4 * j + q];
          row[(ch0 + ce1) ^ sw] = d[4 * j + 2 + q];
        }
      }
      cluster.sync();
      const int rows = kWgBM / splits;
      for (int e = threadIdx.x; e < rows * (kWgBN / 2); e += 256) {
        const int m = rank * rows + e / (kWgBN / 2);
        const int c = 2 * (e % (kWgBN / 2));
        if (m0 + m >= M) continue;
        const int at = m * kWgBN + (c ^ (((m >> 1) & 1) << 4));
        float2 sum = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(part, 0) + at);
        for (int q = 1; q < splits; ++q) {
          const float2 p = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(part, q) + at);
          sum.x += p.x;
          sum.y += p.y;
        }
        if (!kDx) {
          const float2 s2 = *reinterpret_cast<const float2*>(scale + c0 + c);
          sum.x = __fmul_rn(sum.x, s2.x);
          sum.y = __fmul_rn(sum.y, s2.y);
        }
        *reinterpret_cast<uint32_t*>(out + (long long)(m0 + m) * n_out +
                                     c0 + c) = pfx::pack_bf16(sum.x, sum.y);
      }
      cluster.sync();   // every rank's partial stays until all have read it
    }
  }
  if (splits == 1 && tid == 0) pfx::bulk_wait();   // this warpgroup's stores
}

// ---- host side -----------------------------------------------------------

// A 2-D tensor map (cols contiguous, rows of cols * esize bytes) with
// boxes of box_cols x box_rows elements; loads read zeros past the
// edges, stores write nothing there.
bool map2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
           int esize, long long cols, long long rows, int box_cols,
           int box_rows, CUtensorMapSwizzle swizzle) {
  const pfx::EncodeTiled fn = pfx::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * esize)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr CUtensorMapDataType kInt8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;

// Raise `kern`'s dynamic shared-memory limit to `smem` on the current
// device, once: later launches that need no more skip the call.
cudaError_t allow_smem(const void* kern, int smem) {
  static std::mutex mu;
  static const void* fns[64];
  static int devs[64], limits[64], n = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n && !(fns[i] == kern && devs[i] == dev)) ++i;
  if (i < n && limits[i] >= smem) return cudaSuccess;
  rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem);
  if (rc == cudaSuccess && i < 64) {
    fns[i] = kern;
    devs[i] = dev;
    limits[i] = smem;
    if (i == n) ++n;
  }
  return rc;
}

// The current device's streaming multiprocessors, read once a device.
cudaError_t sm_count(int* sms) {
  static int counts[64] = {0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    int n = 0;
    rc = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    counts[dev] = n;
  }
  *sms = counts[dev];
  return cudaSuccess;
}

// A launch of `kern` on `grid` blocks in clusters of `splits`.
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), int grid, int threads, int smem,
                   int splits, cudaStream_t st, A&&... args) {
  cudaError_t rc = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kern, static_cast<A&&>(args)...);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of `splits` blocks of `kern` that fit on the card at once
// (cudaOccupancyMaxActiveClusters), or -1 when the query fails.
template <typename... P>
int max_clusters(void (*kern)(P...), int threads, int smem, int splits) {
  if (allow_smem(reinterpret_cast<const void*>(kern), smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n
                                                                       : -1;
}

// The stream route's instance for m tokens (n8 tiles 2 or 4).
template <bool kDx>
auto stream_kernel(int m) {
  return m <= 16 ? &qmm_stream_kernel<kDx, 2> : &qmm_stream_kernel<kDx, 4>;
}

bool stream_ok(int m, int n_out, int red, int splits) {
  return m >= 1 && m <= kStMaxM && splits >= 1 && splits <= 8 &&
         n_out % kStTile == 0 && red % (splits * kStStage) == 0 &&
         red / splits <= kStMaxSlice;
}

// Route stream: a (n_out / 64) x splits grid in clusters of splits.
template <bool kDx>
int launch_stream(const void* a, const int8_t* w, const float* scale,
                  void* out, int m, int n_out, int red, int splits,
                  cudaStream_t st) {
  if (!stream_ok(m, n_out, red, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = red / splits, mpad = 8 * ((m + 7) / 8);
  CUtensorMap mw, mx;
  const bool maps =
      (kDx ? map2d(&mw, w, kInt8, 1, n_out, red, 64, kStStage,
                   CU_TENSOR_MAP_SWIZZLE_64B)
           : map2d(&mw, w, kInt8, 1, red, n_out, kStStage, kStTile,
                   CU_TENSOR_MAP_SWIZZLE_128B)) &&
      map2d(&mx, a, kBf16, 2, red, m, 64, mpad, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(stream_kernel<kDx>(m), (n_out / kStTile) * splits,
                        kStThreads, st_smem(slice / kStStage, mpad, splits),
                        splits, st, mw, mx, scale,
                        static_cast<__nv_bfloat16*>(out), m, n_out, slice);
}

bool wgmma_ok(int m, int n_out, int red, int splits) {
  return m >= 1 && n_out % kWgBN == 0 &&
         (splits == 1 || splits == 2 || splits == 4 || splits == 8) &&
         red % (splits * 2 * kWgBK) == 0;
}

// Route wgmma: one persistent block an SM (splits 1), or one cluster of
// splits blocks a tile.
template <bool kDx>
int launch_wgmma(const void* a, const int8_t* w, const float* scale,
                 void* out, int m, int n_out, int red, int splits,
                 cudaStream_t st) {
  if (!wgmma_ok(m, n_out, red, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw, mo;
  const bool maps =
      map2d(&mx, a, kBf16, 2, red, m, kWgBK, kWgBM,
            CU_TENSOR_MAP_SWIZZLE_128B) &&
      (kDx ? map2d(&mw, w, kInt8, 1, n_out, red, kWgBN, kWgBK,
                   CU_TENSOR_MAP_SWIZZLE_128B)
           : map2d(&mw, w, kInt8, 1, red, n_out, kWgBK, kWgBN,
                   CU_TENSOR_MAP_SWIZZLE_64B)) &&
      map2d(&mo, out, kBf16, 2, n_out, m, 64, kWgBM,
            CU_TENSOR_MAP_SWIZZLE_128B);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t rc = sm_count(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tiles_n = n_out / kWgBN;
  const long long tiles = (long long)((m + kWgBM - 1) / kWgBM) * tiles_n;
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = splits == 1 ? static_cast<int>(tiles < sms ? tiles : sms)
                               : static_cast<int>(tiles) * splits;
  return launch_cluster(qmm_wgmma_kernel<kDx>, grid, kWgThreads,
                        wg_smem(splits), splits, st, mx, mw, mo, scale,
                        static_cast<__nv_bfloat16*>(out), m, n_out, red,
                        tiles_n, static_cast<int>(tiles));
}

// Route mma (bf16) and the fp32 kernel: a grid of 64 x 64 tiles.
template <bool kDx>
int launch_mma(const void* x, const int8_t* w, const float* scale, void* out,
               int m, int n, int k, int is_bf16, cudaStream_t st) {
  if ((m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  if (is_bf16) {
    qmm_mma_kernel<kDx><<<grid, kMmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale,
        static_cast<__nv_bfloat16*>(out), m, n, k);
  } else {
    qmm_f32_kernel<kDx><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), w, scale, static_cast<float*>(out), m,
        n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

enum { kRouteMma = 0, kRouteWgmma = 1, kRouteStream = 2 };

// One call of either instance: out [m, n_out] over the reduction red.
template <bool kDx>
int dispatch(const void* a, const void* w, const float* scale, void* out,
             int m, int n_out, int red, int is_bf16, int route, int splits,
             void* stream) {
  if (m <= 0 || n_out <= 0 || red <= 0 || n_out % 128 || red % 128 ||
      (!is_bf16 && (route != kRouteMma || splits != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteStream)
    return launch_stream<kDx>(a, wq, scale, out, m, n_out, red, splits, st);
  if (route == kRouteWgmma)
    return launch_wgmma<kDx>(a, wq, scale, out, m, n_out, red, splits, st);
  if (route != kRouteMma || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma<kDx>(a, wq, scale, out, m, n_out, red, is_bf16, st);
}

}  // namespace

// Kernel 7: out [m, n] = (x [m, k] @ w [n, k]^T) * scale [n], in x's type
// (bf16 when is_bf16, else fp32). `route`: 0 the mma.sync kernel (fp32:
// the CUDA-core kernel; splits 1), 1 wgmma (bf16; splits 1, or 2, 4 or 8
// blocks a cluster over k), 2 stream (bf16; m <= 128, clusters of splits
// (1-8) blocks over k, each a slice of at most 512 that is a multiple of
// 128). k and n are multiples of 128; every pointer is 16-byte aligned
// and contiguous. Returns a cudaError_t: 0 on a successful launch,
// cudaErrorInvalidValue for a route that does not take the shape; runs on
// `stream` and does not synchronise.
extern "C" int pfx_quantized_matmul(const void* x, const void* w,
                                    const float* scale, void* out, int m,
                                    int n, int k, int is_bf16, int route,
                                    int splits, void* stream) {
  return dispatch<false>(x, w, scale, out, m, n, k, is_bf16, route, splits,
                         stream);
}

// Kernel 7's dx route: dx [m, k] = gs [m, n] @ w [n, k], in gs's type
// (bf16 when is_bf16, else fp32), w the forward's int8 weight as stored
// (k contiguous), no scale; `route` and `splits` as above, the
// reduction now over n. k and n are multiples of 128; every pointer is
// 16-byte aligned and contiguous. Returns a cudaError_t: 0 on a
// successful launch; runs on `stream` and does not synchronise.
extern "C" int pfx_quantized_matmul_dx(const void* gs, const void* w,
                                       void* dx, int m, int n, int k,
                                       int is_bf16, int route, int splits,
                                       void* stream) {
  return dispatch<true>(gs, w, nullptr, dx, m, k, n, is_bf16, route, splits,
                        stream);
}

// The clusters of one call's kernel (route 1 or 2, forward or dx, m
// rows, the reduction red over `splits` blocks) that fit on the card at
// once, written to *count (cudaOccupancyMaxActiveClusters). Returns a
// cudaError_t: cudaErrorInvalidValue for a route or split the kernel
// does not take.
extern "C" int pfx_quantized_matmul_clusters(int route, int is_dx, int m,
                                             int red, int splits,
                                             int* count) {
  int n = -1;
  if (route == kRouteStream && stream_ok(m, kStTile, red, splits)) {
    const int stages = red / splits / kStStage, mpad = 8 * ((m + 7) / 8);
    n = is_dx ? max_clusters(stream_kernel<true>(m), kStThreads,
                             st_smem(stages, mpad, splits), splits)
              : max_clusters(stream_kernel<false>(m), kStThreads,
                             st_smem(stages, mpad, splits), splits);
  } else if (route == kRouteWgmma && wgmma_ok(m, kWgBN, red, splits)) {
    n = is_dx ? max_clusters(qmm_wgmma_kernel<true>, kWgThreads,
                             wg_smem(splits), splits)
              : max_clusters(qmm_wgmma_kernel<false>, kWgThreads,
                             wg_smem(splits), splits);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *count = n;
  return n < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}
