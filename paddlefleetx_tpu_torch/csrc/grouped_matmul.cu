// Grouped matmul for Hopper (sm_90a): kernels 8 and 9 of the port, the
// expert GEMMs of the MoE block under `moe_dispatch: sort_pallas` and
// the LoRA banks' grouped delta.
//
// Replaces: paddlefleetx_tpu/ops/pallas/grouped_matmul.py `_gmm_kernel`
// (:52, launched by `_gmm_forward`, pallas_call at :122) and
// `_gmm_dw_kernel` (:76, launched by `_gmm_dw`, pallas_call at :151).
//
// Kernel 8 (grouped_matmul):
//   out[g] = x[g] @ B[g / rep]  where counts[g] > 0, else zeros,
// x [G, C, K] and out [G, C, N] in x's type (bf16 or fp32), an fp32
// accumulator, every one of the C rows of a live group computed (the
// fc2 input's padding rows are gelu(b1), not zero: the TPU kernel's
// contract, kept). B [K, N] of expert e is read through strides: the
// forward passes w [Gw, K, N] as stored (N contiguous); the dx route of
// the gradient passes the same storage transposed, B = w[e]^T with K
// contiguous. Every route takes both layouts, so no transposed copy of
// w is made per step.
// Kernel 9 (grouped_matmul_dw):
//   dw[e] = sum over i < rep with counts[e rep + i] > 0 of
//           x[e rep + i]^T @ dy[e rep + i],
// x [G, C, K], dy [G, C, N] in one type, dw [Gw, K, N] fp32; an expert
// whose groups are all empty gets zeros.
//
// Each call takes one of four routes, chosen by the wrapper's planner
// (ops/cuda/grouped_matmul.py `plan`) and passed in as `route`; a route
// that cannot take the shape returns cudaErrorInvalidValue (no route
// yields to another). Every route is one launch, writes every output
// element (nothing is pre-zeroed), uses no atomics, and sums in an order
// fixed by the shape alone, so a call is bit-identical from run to run.
//
// (a) wgmma, bf16 outputs of at least 64 x 64 (the MoE recipe's six
//     calls: G 16, C 320, 1024 x 4096 and 4096 x 1024). What bounds it:
//     kernel 8 does 4.3e10 FLOPs against ~120 MB of device memory, above
//     the H100's ~295 bf16 FLOP/B: the tensor cores; kernel 9 writes
//     134 MB of fp32 dw against the same FLOPs: the bytes. Measured, both
//     stop at the operand traffic from L2 into the SMs: a tile re-reads
//     its A rows and B columns, and every call ran at ~6 TB/s of it. The
//     design: a tile of 128 rows by 128 or 256 columns (the planner takes
//     256 where that still makes 4 waves, fc1 and fc2_dx and both dw: a
//     quarter less L2 traffic for each product), two consumer warpgroups
//     of 64 rows each (wgmma m64n128k16 or m64n256k16, both operands in
//     shared memory, fp32 accumulators in registers; at 256 columns the
//     consumers take 232 registers with setmaxnreg and the producer 40)
//     and one producer thread that keeps a ring of 64-deep A and B tiles
//     in flight with TMA (4 stages of 32 KB, or 3 of 48 KB; 3-D tensor
//     maps over [G, C, K] / [Gw, K, N] / [G, C, N], 128-byte swizzle,
//     zeros past every edge, so the ragged C, K and N need no masking).
//     Each stage has a `full` mbarrier (TMA bytes) and an `empty` one
//     (one arrival per consumer warp); a consumer keeps one wgmma group
//     in flight and releases the stage before it. wgmma reads every
//     layout as stored: the forward's B N-major, the dx route's B
//     K-major, kernel 9's x (the A operand x^T) M-major and dy N-major,
//     so nothing is transposed in memory. The grid is persistent (one
//     block an SM) over (group, N tile, C tile), C tile fastest so that
//     neighbouring blocks share a B tile in L2; each block reads its
//     group's count itself and stores an empty group's tile as zeros
//     without a mainloop. Kernel 9 loops over an expert's live groups
//     inside the tile (the sum order is fixed). The epilogue stages a
//     warpgroup's rows as swizzled 8 KB boxes and stores them with TMA,
//     which runs on while the next tile's products start (kernel 9's
//     fp32 dw no longer leaves as 8-byte stores in the fragment layout).
//     128-row tiles: C 320 is 2.5 of them, but a 64-row tile re-reads
//     the group's whole B for every 64 rows (5 reads of 8 MB at fc1,
//     against 3), and a warpgroup with no live row (rows 320-383) skips
//     its products. Waves on 132 SMs, 13 live groups: fc1 (N 4096, 256
//     wide) 3 x 16 x 13 = 624 tiles, 4.7 waves; fc2 (N 1024, 128 wide)
//     3 x 8 x 13 = 312 tiles, 2.4 waves; kernel 9 fc1 (1024 x 4096, 256
//     wide) 8 x 16 x 7 live experts = 896 tiles, 6.8 waves.
// (b) split, bf16 outputs of at most 16 rows or 8 columns over a
//     reduction of at least 64 (the LoRA banks: `x @ A` at C 16, N = r
//     = 8, K 1024-4096; kernel 9's `lora_a` dw, N 8, C 4096; `lora_b`'s
//     dw, K 8). What bounds it: latency (C 16: a few hundred KB, a few
//     MFLOPs) or the bytes of the long operand (C 4096); route (c) gives
//     such a call one block per 64 x 128 tile (5 blocks on 132 SMs,
//     each walking K alone). The design: a cluster of `splits`
//     blocks (at most 8, the portable size) per 16 x 8, 64 x 8 or
//     16 x 64 output tile; each of a block's 8 warps takes every
//     (splits x 8)-th 32-deep slice of the reduction axis, stages it in
//     its own shared memory with 16-byte loads and multiplies with
//     mma.sync m16n8k16 (a tile this narrow gives wgmma nothing). The
//     partials are summed in a fixed order: the warps' in shared
//     memory, then the blocks' through distributed shared memory into
//     the cluster's rank 0, which stores the tile. No workspace, no
//     second launch, no memset.
// (c) mma, every other bf16 shape (ragged or unaligned K or N, odd
//     strides, reductions under 16 such as `(xA) @ B` with K = r = 8):
//     the first design of these kernels, kept. mma.sync m16n8k16, 128
//     threads a block, a 64 x 128 output tile, each of the 4 warps 64 x
//     32 of it; an empty group's block writes its tile of zeros and
//     returns; a live block walks K in 32-deep tiles staged in shared
//     memory (rows padded by 16 bytes), the next tile's global loads
//     issued into registers before the current tile's products; B with N
//     contiguous is staged [k][n] with ldmatrix.trans fragments, B with
//     K contiguous [n][k]; every edge masked, element loads where a row
//     is not 16-byte aligned. Kernel 9: a grid over (expert, K tile, N
//     tile), each block looping over its expert's groups and their C
//     rows, both operands through ldmatrix.trans.
// fp32 (the parity route; CUDA cores, FMAs in order over K; TF32 would
//     miss fp32 parity, as for kernels 1 and 7): 256 threads, a 64 x 64
//     tile, each thread a 4 x 4 block, every edge masked.
//
// Built for sm_90a with -Xptxas -v on the H100's machine (CUDA 12.8),
// registers a thread, no kernel spilling: gmm_wgmma_kernel 90 (128
// wide) / 168 (256 wide, before setmaxnreg), gmm_dw_wgmma_kernel 96 /
// 168; gmm_split_kernel and gmm_dw_split_kernel 46-150 (16 x 8 tiles
// 46-48, 64 x 8 94-123, 16 x 64 128-150); gmm_mma_kernel 132 (B
// N-major) / 154 (K-major), gmm_dw_mma_kernel 123.
//
// TMA needs cuTensorMapEncodeTiled, a driver-API call: it is taken from
// the runtime with cudaGetDriverEntryPoint(ByVersion), so the library
// links against nothing but the CUDA runtime.
// The mbarrier, TMA and wgmma helpers are csrc/hopper.cuh's.

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kBM = 64;    // output rows of a tile (C rows; K rows in dw)
constexpr int kBN = 128;   // output columns of a tile
constexpr int kBK = 32;    // reduction depth of a staged tile
constexpr int kPad = 8;    // bf16 elements of row padding (16 bytes)

// Eight bf16 at row[col .. col + 7] as one 16-byte vector: elements at
// or past `limit`, and all of them when !row_ok, read as zero. With
// `vec` every row starts 16-byte aligned, so a chunk inside the row
// loads as one vector.
__device__ __forceinline__ uint4 load8(const bf16* row, int col, int limit,
                                       bool row_ok, bool vec) {
  if (!row_ok) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && col + 8 <= limit)
    return *reinterpret_cast<const uint4*>(row + col);
  const unsigned short* q = reinterpret_cast<const unsigned short*>(row);
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = col + i < limit ? static_cast<uint32_t>(q[col + i]) : 0u;
  return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                    v[4] | (v[5] << 16), v[6] | (v[7] << 16));
}

// The B fragments of one k16 step for a warp's 4 n8 tiles from a tile
// staged [k][n] (N contiguous): columns n_base .. n_base + 31.
template <int kCols>
__device__ __forceinline__ void b_frags_trans(uint32_t (*b)[2],
                                              const bf16 (*s)[kCols],
                                              int k_base, int n_base,
                                              int lane) {
  const int mat = lane / 8, i = lane % 8;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    pfx::ldsm_x4_trans(r, &s[k_base + (mat & 1) * 8 + i]
                       [n_base + p * 16 + (mat >> 1) * 8]);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}

// Store a 64 x 128 fp32 accumulator tile (fragment layout of 4 warps,
// each 64 x 32) at out[row0.., col0..] with `ld` elements a row, rows
// below `rows` and columns below `cols` only.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, const float (*acc)[4][4],
                                           int row0, int col0, int rows,
                                           int cols, long long ld, bool vec,
                                           int warp, int lane) {
  const int gr = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + warp * 32 + nt * 8 + t * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + gr + 8 * half;
        if (row >= rows) continue;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        T* p = out + row * ld + col;
        if (vec && col + 1 < cols) {
          if constexpr (sizeof(T) == 2) {
            *reinterpret_cast<uint32_t*>(p) = pfx::pack_bf16(v0, v1);
          } else {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          }
        } else {
          if (col < cols) pfx::store_f(p, v0);
          if (col + 1 < cols) pfx::store_f(p + 1, v1);
        }
      }
    }
  }
}

// ---- kernel 8, bf16 -----------------------------------------------------

template <bool kBKContig>
__global__ void __launch_bounds__(kThreads)
    gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ counts, bf16* __restrict__ out,
                   int C, int K, int N, int rep, long long sw, long long ldb,
                   int vec) {
  // B (k, n) at k + n ldb (kBKContig: the dx route) or k ldb + n
  constexpr int kBRows = kBKContig ? kBN : kBK;
  constexpr int kBCols = kBKContig ? kBK : kBN;
  __shared__ __align__(16) bf16 as[kBM][kBK + kPad];
  __shared__ __align__(16) bf16 bs[kBRows][kBCols + kPad];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;   // fragment row group
  const int t = lane % 4;    // thread within the group
  bf16* o = out + (long long)g * C * N;

  if (counts[g] <= 0) {
    for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
      const int row = m0 + idx / kBN;
      const int col = n0 + idx % kBN;
      if (row < C && col < N)
        o[(long long)row * N + col] = __float2bfloat16(0.f);
    }
    return;
  }

  const bf16* xg = x + (long long)g * C * K;
  const bf16* wb = w + (long long)(g / rep) * sw;
  // m16 tiles of this block that hold a row below C (uniform per block)
  const int live_mt = min(4, (C - m0 + 15) / 16);
  constexpr int kALoads = kBM * kBK / 8 / kThreads;
  constexpr int kBLoads = kBK * kBN / 8 / kThreads;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 ar[kALoads], br[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = m0 + idx / (kBK / 8);
      const int c8 = (idx % (kBK / 8)) * 8;
      ar[i] = load8(xg + (long long)row * K, k0 + c8, K, row < C, vec);
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBCols / 8);
      const int c8 = (idx % (kBCols / 8)) * 8;
      if (kBKContig) {
        br[i] = load8(wb + (long long)(n0 + r) * ldb, k0 + c8, K,
                      n0 + r < N, vec);
      } else {
        br[i] = load8(wb + (long long)(k0 + r) * ldb, n0 + c8, N,
                      k0 + r < K, vec);
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(
          &as[idx / (kBK / 8)][(idx % (kBK / 8)) * 8]) = ar[i];
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(
          &bs[idx / (kBCols / 8)][(idx % (kBCols / 8)) * 8]) = br[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      uint32_t b[4][2];
      if constexpr (kBKContig) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* brow = &bs[warp * 32 + nt * 8 + gr][c];
          b[nt][0] = pfx::ld_u32(brow);
          b[nt][1] = pfx::ld_u32(brow + 8);
        }
      } else {
        b_frags_trans<kBCols + kPad>(b, bs, kk * 16, warp * 32, lane);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < live_mt) {
          const uint32_t a[4] = {pfx::ld_u32(&as[mt * 16 + gr][c]),
                                 pfx::ld_u32(&as[mt * 16 + gr + 8][c]),
                                 pfx::ld_u32(&as[mt * 16 + gr][c + 8]),
                                 pfx::ld_u32(&as[mt * 16 + gr + 8][c + 8])};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            pfx::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }
  store_tile(o, acc, m0, n0, C, N, N, vec, warp, lane);
}

// ---- kernel 9, bf16 -----------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    gmm_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const int* __restrict__ counts, float* __restrict__ dw,
                      int C, int K, int N, int rep, int vec) {
  // both staged as read: x rows [c][k] (the A operand x^T), dy [c][n]
  __shared__ __align__(16) bf16 xs[kBK][kBM + kPad];
  __shared__ __align__(16) bf16 ys[kBK][kBN + kPad];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;   // rows of dw: the K axis
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mat = lane / 8, li = lane % 8;
  const int live_mt = min(4, (K - m0 + 15) / 16);
  constexpr int kXLoads = kBK * kBM / 8 / kThreads;
  constexpr int kYLoads = kBK * kBN / 8 / kThreads;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  for (int gi = 0; gi < rep; ++gi) {
    const int g = e * rep + gi;
    if (counts[g] <= 0) continue;   // uniform per block
    const bf16* xg = x + (long long)g * C * K;
    const bf16* yg = dy + (long long)g * C * N;
    uint4 xr[kXLoads], yr[kYLoads];
    auto load = [&](int c0) {
#pragma unroll
      for (int i = 0; i < kXLoads; ++i) {
        const int idx = tid + i * kThreads;
        const int c = c0 + idx / (kBM / 8);
        xr[i] = load8(xg + (long long)c * K, m0 + (idx % (kBM / 8)) * 8, K,
                      c < C, vec);
      }
#pragma unroll
      for (int i = 0; i < kYLoads; ++i) {
        const int idx = tid + i * kThreads;
        const int c = c0 + idx / (kBN / 8);
        yr[i] = load8(yg + (long long)c * N, n0 + (idx % (kBN / 8)) * 8, N,
                      c < C, vec);
      }
    };
    load(0);
    for (int c0 = 0; c0 < C; c0 += kBK) {
      __syncthreads();   // the previous tile's readers are done
#pragma unroll
      for (int i = 0; i < kXLoads; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<uint4*>(
            &xs[idx / (kBM / 8)][(idx % (kBM / 8)) * 8]) = xr[i];
      }
#pragma unroll
      for (int i = 0; i < kYLoads; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<uint4*>(
            &ys[idx / (kBN / 8)][(idx % (kBN / 8)) * 8]) = yr[i];
      }
      __syncthreads();
      if (c0 + kBK < C) load(c0 + kBK);   // in flight during the products
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t b[4][2];
        b_frags_trans<kBN + kPad>(b, ys, kk * 16, warp * 32, lane);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < live_mt) {
            // x^T (m = k index, reduction = c): matrix j covers rows c
            // 8 (j >> 1) .. + 7 and columns m 8 (j & 1) .. + 7
            uint32_t a[4];
            pfx::ldsm_x4_trans(a, &xs[kk * 16 + (mat >> 1) * 8 + li]
                                [mt * 16 + (mat & 1) * 8]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              pfx::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
    }
  }
  store_tile(dw + (long long)e * K * N, acc, m0, n0, K, N, N, vec, warp,
             lane);
}

// ---- fp32 on the CUDA cores ---------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32B = 64;    // output tile edge
constexpr int kF32BK = 32;   // reduction depth of a staged tile

// Each thread's 4 x 4 block of a 64 x 64 fp32 tile, masked to rows x cols.
__device__ __forceinline__ void store_f32_tile(float* out,
                                               const float (*acc)[4],
                                               int row0, int col0, int rows,
                                               int cols, long long ld,
                                               int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < cols) out[row * ld + col] = acc[i][j];
    }
  }
}

// One staged k step of the 4 x 4 block: acc += a[ty 4 ..] b[tx 4 ..]^T.
__device__ __forceinline__ void fma_tile(float (*acc)[4],
                                         const float (*as)[kF32B + 4],
                                         const float (*bs)[kF32B + 4],
                                         int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kF32BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

template <bool kBKContig>
__global__ void __launch_bounds__(kF32Threads)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ counts, float* __restrict__ out,
                   int C, int K, int N, int rep, long long sw,
                   long long ldb) {
  // both staged [k][row] / [k][col] so each thread reads its 4 rows and
  // its 4 columns as one 16-byte load each
  __shared__ __align__(16) float as[kF32BK][kF32B + 4];
  __shared__ __align__(16) float bs[kF32BK][kF32B + 4];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kF32B;
  const int n0 = blockIdx.x * kF32B;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float* o = out + (long long)g * C * N;
  if (counts[g] <= 0) {
    store_f32_tile(o, acc, m0, n0, C, N, N, ty, tx);
    return;
  }
  const float* xg = x + (long long)g * C * K;
  const float* wb = w + (long long)(g / rep) * sw;
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kF32B * kF32BK; idx += kF32Threads) {
      const int r = idx / kF32BK, kk = idx % kF32BK;
      const int row = m0 + r, k = k0 + kk;
      as[kk][r] = row < C && k < K ? xg[(long long)row * K + k] : 0.f;
    }
    for (int idx = tid; idx < kF32B * kF32BK; idx += kF32Threads) {
      // walk the contiguous axis with neighbouring threads
      const int kk = kBKContig ? idx % kF32BK : idx / kF32B;
      const int c = kBKContig ? idx / kF32BK : idx % kF32B;
      const int k = k0 + kk, n = n0 + c;
      bs[kk][c] = k < K && n < N
                      ? wb[kBKContig ? (long long)n * ldb + k
                                     : (long long)k * ldb + n]
                      : 0.f;
    }
    __syncthreads();
    fma_tile(acc, as, bs, ty, tx);
  }
  store_f32_tile(o, acc, m0, n0, C, N, N, ty, tx);
}

__global__ void __launch_bounds__(kF32Threads)
    gmm_dw_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      const int* __restrict__ counts, float* __restrict__ dw,
                      int C, int K, int N, int rep) {
  __shared__ __align__(16) float xs[kF32BK][kF32B + 4];   // [c][k index]
  __shared__ __align__(16) float ys[kF32BK][kF32B + 4];   // [c][n]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kF32B;   // rows of dw: the K axis
  const int n0 = blockIdx.x * kF32B;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int gi = 0; gi < rep; ++gi) {
    const int g = e * rep + gi;
    if (counts[g] <= 0) continue;   // uniform per block
    const float* xg = x + (long long)g * C * K;
    const float* yg = dy + (long long)g * C * N;
    for (int c0 = 0; c0 < C; c0 += kF32BK) {
      __syncthreads();   // the previous tile's readers are done
      for (int idx = tid; idx < kF32B * kF32BK; idx += kF32Threads) {
        const int cc = idx / kF32B, j = idx % kF32B;
        const int c = c0 + cc;
        xs[cc][j] = c < C && m0 + j < K ? xg[(long long)c * K + m0 + j]
                                        : 0.f;
        ys[cc][j] = c < C && n0 + j < N ? yg[(long long)c * N + n0 + j]
                                        : 0.f;
      }
      __syncthreads();
      fma_tile(acc, xs, ys, ty, tx);
    }
  }
  store_f32_tile(dw + (long long)e * K * N, acc, m0, n0, K, N, N, ty, tx);
}

// ---- Hopper building blocks (csrc/hopper.cuh) ---------------------------

enum { kFwd = 0, kDx = 1, kDw = 2 };   // B N-major, B K-major, kernel 9

using pfx::bulk_commit;
using pfx::bulk_wait;
using pfx::bulk_wait_read;
using pfx::encode_tiled;
using pfx::EncodeTiled;
using pfx::fence_acc;
using pfx::fence_async_smem;
using pfx::mbar_arrive;
using pfx::mbar_expect_tx;
using pfx::mbar_init;
using pfx::mbar_wait;
using pfx::named_bar;
using pfx::smem_addr;
using pfx::swz;
using pfx::tma_load_3d;
using pfx::tma_store_3d;
using pfx::wg_desc;
using pfx::wgmma_commit;
using pfx::wgmma_fence;
using pfx::wgmma_m64n128;
using pfx::wgmma_m64n256;
using pfx::wgmma_wait;

// ---- route (a): the wgmma kernel (kernels 8 and 9) ----------------------

constexpr int kWgBM = 128;    // output rows of a tile: 2 warpgroups x 64
constexpr int kWgBK = 64;     // reduction depth of a stage (128 bytes)
constexpr int kWgThreads = 384;   // consumers 0-255, producer 256
// the staged output: a warpgroup's 64 rows as 8 KB TMA boxes of 64 x 128
// bytes (64 bf16 or 32 fp32 columns), 128-byte swizzled; 32 KB a
// warpgroup holds 256 bf16 columns or 128 fp32 ones at a time
constexpr int kWgOutBytes = 2 * 32768;

// A tile kBN = 128 or 256 columns wide: a ring of 4 stages of 32 KB or 3
// of 48 KB, beside the staged output.
template <int kBN>
struct WgShape {
  static constexpr int STAGES = kBN == 256 ? 3 : 4;
  static constexpr int A_ELEMS = kWgBM * kWgBK;
  static constexpr int B_ELEMS = kWgBK * kBN;
  static constexpr int SMEM = 1024 + STAGES * (A_ELEMS + B_ELEMS) * 2 +
                              kWgOutBytes + 2 * STAGES * 8;
};

// kFwd / kDx: out[g] (bf16 [G, rows = C, cols = N]) over red = K, the
// tiles over (g, N tile, C tile). kDw: dw[e] (fp32 [Gw, rows = K, cols =
// N]) over the live groups of expert e, red = C each. map_a: x [G, C, K]
// (box 64 x 128 rows; kDw: 64 K x 64 C). map_b: w [Gw, K, N] (box 64 N x
// 64 K), w^T (kDx: box 64 K x kBN N) or dy [G, C, N] (box 64 N x 64 C).
// map_o: out (box 64 N x 64 C) or dw (box 32 N x 64 K).
template <int kMode, int kBN>
__device__ __forceinline__ void wgmma_body(const CUtensorMap& map_a,
                                           const CUtensorMap& map_b,
                                           const CUtensorMap& map_o,
                                           const int* __restrict__ counts,
                                           int rows, int cols, int red,
                                           int rep, int groups, int tiles_m,
                                           int tiles_n) {
  using S = WgShape<kBN>;
  constexpr int kStages = S::STAGES;
  extern __shared__ unsigned char wg_raw[];
  unsigned char* base =
      wg_raw + ((1024 - (smem_addr(wg_raw) & 1023)) & 1023);
  bf16* sa = reinterpret_cast<bf16*>(base);
  bf16* sb = sa + kStages * S::A_ELEMS;
  unsigned char* so =
      reinterpret_cast<unsigned char*>(sb + kStages * S::B_ELEMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(so + kWgOutBytes);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_group = tiles_m * tiles_n;
  const int tiles = groups * per_group;
  const int reps = kMode == kDw ? rep : 1;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // ---- producer: one thread issues every TMA load
    if constexpr (kBN == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int grp = t / per_group, r = t % per_group;
      const int m0 = (r % tiles_m) * kWgBM, n0 = (r / tiles_m) * kBN;
      for (int gi = 0; gi < reps; ++gi) {
        const int g = kMode == kDw ? grp * rep + gi : grp;
        if (counts[g] <= 0) continue;
        const int gb = kMode == kDw ? g : g / rep;   // B's group
        for (int k0 = 0; k0 < red; k0 += kWgBK) {
          mbar_wait(&empty[stage], phase ^ 1);
          bf16* a = sa + stage * S::A_ELEMS;
          bf16* b = sb + stage * S::B_ELEMS;
          // a box wholly past the output's edge is not loaded: the
          // stale tile it leaves only reaches outputs that are not stored
          const bool a2 = kMode != kDw || m0 + 64 < rows;
          uint32_t bytes = kMode == kDw ? 8192u * (1 + a2) : 16384u;
          if (kMode == kDx) {
            bytes += kBN * 128u;
          } else {
#pragma unroll
            for (int j = 0; j < kBN / 64; ++j)
              if (j == 0 || n0 + 64 * j < cols) bytes += 8192u;
          }
          mbar_expect_tx(&full[stage], bytes);
          if (kMode == kDw) {
            tma_load_3d(a, &map_a, &full[stage], m0, k0, g);
            if (a2) tma_load_3d(a + 4096, &map_a, &full[stage], m0 + 64, k0,
                                g);
          } else {
            tma_load_3d(a, &map_a, &full[stage], k0, m0, g);
          }
          if (kMode == kDx) {
            tma_load_3d(b, &map_b, &full[stage], k0, n0, gb);
          } else {
#pragma unroll
            for (int j = 0; j < kBN / 64; ++j)
              if (j == 0 || n0 + 64 * j < cols)
                tma_load_3d(b + j * 4096, &map_b, &full[stage], n0 + 64 * j,
                            k0, gb);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of a tile
  if constexpr (kBN == 256)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % 128;
  int stage = 0;
  uint32_t phase = 0;
  float d[kBN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int grp = t / per_group, r = t % per_group;
    const int m0 = (r % tiles_m) * kWgBM, n0 = (r / tiles_m) * kBN;
    const bool mine = m0 + 64 * wg < rows;   // uniform per warpgroup
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) d[i] = 0.f;
    int prev = -1;
    for (int gi = 0; gi < reps; ++gi) {
      const int g = kMode == kDw ? grp * rep + gi : grp;
      if (counts[g] <= 0) continue;
      for (int k0 = 0; k0 < red; k0 += kWgBK) {
        mbar_wait(&full[stage], phase);
        if (mine) {
          const bf16* a = sa + stage * S::A_ELEMS + wg * 4096;
          const bf16* b = sb + stage * S::B_ELEMS;
          fence_acc<kBN / 2>(d);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWgBK / 16; ++kk) {
            // A: x rows K-major (kk steps 32 bytes in a row) or, for
            // kernel 9, x^T M-major (kk steps 16 rows of 128 bytes); B:
            // N-major 64-column chunks 8 KB apart, or (dx) K-major rows
            const uint64_t da =
                kMode == kDw ? wg_desc(a + kk * 16 * 64, 8192, 1024)
                             : wg_desc(a + kk * 16, 16, 1024);
            const uint64_t db =
                kMode == kDx ? wg_desc(b + kk * 16, 16, 1024)
                             : wg_desc(b + kk * 16 * 64, 8192, 1024);
            if constexpr (kBN == 256)
              wgmma_m64n256<kMode == kDw, kMode != kDx>(d, da, db);
            else
              wgmma_m64n128<kMode == kDw, kMode != kDx>(d, da, db);
          }
          wgmma_commit();
          wgmma_wait<1>();   // the previous stage's products are done
          fence_acc<kBN / 2>(d);
        }
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (mine) {
      wgmma_wait<0>();
      fence_acc<kBN / 2>(d);
    }
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    if (!mine) continue;

    // epilogue: the fragments into this warpgroup's swizzled staging
    // boxes, then TMA stores (the rows past C or K and the columns past N
    // are not written); the stores run on while the next tile's products
    // start, and a warpgroup waits for their reads only when it stages
    // again
    const int fr = warp * 16 + lane / 4, t4 = lane % 4;
    const int row0 = m0 + 64 * wg;
    unsigned char* st = so + wg * 32768;
#pragma unroll
    for (int h = 0; h < (kMode == kDw ? kBN / 128 : 1); ++h) {
      if (tid == 0) bulk_wait_read();
      named_bar(1 + wg);   // the staging is free
#pragma unroll
      for (int j = 0; j < (kMode == kDw ? 16 : kBN / 8); ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = fr + 8 * hh;
          if (kMode == kDw) {
            // columns 8 j + 2 t4 of this half: box j / 4, byte 32 (j % 4)
            // + 8 t4 of its row
            const float* q = &d[4 * (16 * h + j) + 2 * hh];
            *reinterpret_cast<float2*>(
                st + (j / 4) * 8192 + swz(r, 32 * (j % 4) + 8 * t4)) =
                make_float2(q[0], q[1]);
          } else {
            // columns 8 j + 2 t4: box j / 8, byte 16 (j % 8) + 4 t4
            *reinterpret_cast<uint32_t*>(
                st + (j / 8) * 8192 + swz(r, 16 * (j % 8) + 4 * t4)) =
                pfx::pack_bf16(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
          }
        }
      }
      fence_async_smem();
      named_bar(1 + wg);
      if (tid == 0) {
        constexpr int kBoxCols = kMode == kDw ? 32 : 64;
#pragma unroll
        for (int bx = 0; bx < (kMode == kDw ? 4 : kBN / 64); ++bx) {
          const int c0 = n0 + 128 * h + kBoxCols * bx;
          if (c0 < cols) tma_store_3d(&map_o, st + bx * 8192, c0, row0, grp);
        }
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait();   // every store of this warpgroup is done
}

// Kernel 8 (kFwd, kDx) and kernel 9 on route (a); kernel 9's own name
// keeps its device time apart in a profile.
template <int kMode, int kBN>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_o,
                     const int* __restrict__ counts, int rows, int cols,
                     int red, int rep, int groups, int tiles_m,
                     int tiles_n) {
  wgmma_body<kMode, kBN>(map_a, map_b, map_o, counts, rows, cols, red, rep,
                         groups, tiles_m, tiles_n);
}

template <int kBN>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_o,
                        const int* __restrict__ counts, int rows, int cols,
                        int red, int rep, int groups, int tiles_m,
                        int tiles_n) {
  wgmma_body<kDw, kBN>(map_a, map_b, map_o, counts, rows, cols, red, rep,
                       groups, tiles_m, tiles_n);
}

// ---- route (b): the split-reduction kernel (kernels 8 and 9) -----------

constexpr int kSpWarps = 8;
constexpr int kSpThreads = kSpWarps * 32;
constexpr int kSpBK = 32;   // reduction depth of one warp's step

// The output tile (16 kMT x 8 kNT) and a warp's staging: A as read (x
// rows [m][k]; kernel 9's x [c][m]), B as read ([k][n]; dx: [n][k]),
// rows padded by 16 bytes.
template <int kMT, int kNT, int kMode>
struct SplitShape {
  static constexpr int TM = 16 * kMT, TN = 8 * kNT;
  static constexpr int A_W = kMode == kDw ? TM : kSpBK;   // row width
  static constexpr int A_ROWS = kMode == kDw ? kSpBK : TM;
  static constexpr int B_W = kMode == kDx ? kSpBK : TN;
  static constexpr int B_ROWS = kMode == kDx ? TN : kSpBK;
  static constexpr int A_LD = A_W + 8, B_LD = B_W + 8;
  static constexpr int A_CHUNKS = A_ROWS * A_W / 8;   // 16-byte loads
  static constexpr int B_CHUNKS = B_ROWS * B_W / 8;
  static constexpr int WARP_ELEMS = A_ROWS * A_LD + B_ROWS * B_LD;
  static constexpr int STAGE_BYTES = kSpWarps * WARP_ELEMS * 2;
  static constexpr int RED_BYTES = kSpWarps * TM * TN * 4;
  static constexpr int PART_OFF =
      STAGE_BYTES > RED_BYTES ? STAGE_BYTES : RED_BYTES;
  static constexpr int SMEM = PART_OFF + TM * TN * 4;
};

// Two 8 x 8 bf16 matrices from shared memory, transposed (lanes 0-15
// give the row addresses): the B fragment of one n8 tile from [k][n].
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// One cluster of `splits` blocks (grid x = splits x N tiles) per output
// tile (blockIdx.y: the M tile, z: the group of kernel 8 / the expert of
// kernel 9). out: bf16 [G, C, N] (kFwd, kDx: B (k, n) at w + (g / rep)
// sw + k ldb + n, or + n ldb + k) or fp32 [Gw, K, N] (kDw).
template <int kMT, int kNT, int kMode>
__device__ __forceinline__ void split_body(const bf16* __restrict__ x,
                                           const bf16* __restrict__ b,
                                           const int* __restrict__ counts,
                                           void* __restrict__ out, int C,
                                           int K, int N, int rep, long long sw,
                                           long long ldb, int vec) {
  using S = SplitShape<kMT, kNT, kMode>;
  extern __shared__ __align__(16) unsigned char sp_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int grp = blockIdx.z;
  const int m0 = blockIdx.y * S::TM;
  const int n0 = (blockIdx.x / splits) * S::TN;
  const int rows = kMode == kDw ? K : C;
  const int red = kMode == kDw ? C : K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4, mat = lane / 8, li = lane % 8;

  if (kMode != kDw && counts[grp] <= 0) {   // uniform per cluster
    if (split == 0) {
      bf16* o = static_cast<bf16*>(out) + (long long)grp * C * N;
      for (int i = threadIdx.x; i < S::TM * S::TN; i += kSpThreads) {
        const int row = m0 + i / S::TN, col = n0 + i % S::TN;
        if (row < C && col < N)
          o[(long long)row * N + col] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  bf16* as = reinterpret_cast<bf16*>(sp_raw) + warp * S::WARP_ELEMS;
  bf16* bs = as + S::A_ROWS * S::A_LD;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int steps = (red + kSpBK - 1) / kSpBK;
  const int workers = splits * kSpWarps;
  for (int gi = 0; gi < (kMode == kDw ? rep : 1); ++gi) {
    const int g = kMode == kDw ? grp * rep + gi : grp;
    if (kMode == kDw && counts[g] <= 0) continue;   // uniform per block
    const bf16* xg = x + (long long)g * C * K;
    const bf16* bg = kMode == kDw ? b + (long long)g * C * N
                                  : b + (long long)(g / rep) * sw;
    for (int s = split * kSpWarps + warp; s < steps; s += workers) {
      const int r0 = s * kSpBK;
      uint4 av[S::A_CHUNKS / 32], bv[S::B_CHUNKS / 32];
#pragma unroll
      for (int j = 0; j < S::A_CHUNKS / 32; ++j) {
        const int i = lane + 32 * j;
        const int row = i / (S::A_W / 8), col = (i % (S::A_W / 8)) * 8;
        av[j] = kMode == kDw
                    ? load8(xg + (long long)(r0 + row) * K, m0 + col, K,
                            r0 + row < C, vec)
                    : load8(xg + (long long)(m0 + row) * K, r0 + col, K,
                            m0 + row < C, vec);
      }
#pragma unroll
      for (int j = 0; j < S::B_CHUNKS / 32; ++j) {
        const int i = lane + 32 * j;
        const int row = i / (S::B_W / 8), col = (i % (S::B_W / 8)) * 8;
        if (kMode == kDx)
          bv[j] = load8(bg + (long long)(n0 + row) * ldb, r0 + col, K,
                        n0 + row < N, vec);
        else if (kMode == kDw)
          bv[j] = load8(bg + (long long)(r0 + row) * N, n0 + col, N,
                        r0 + row < C, vec);
        else
          bv[j] = load8(bg + (long long)(r0 + row) * ldb, n0 + col, N,
                        r0 + row < K, vec);
      }
#pragma unroll
      for (int j = 0; j < S::A_CHUNKS / 32; ++j) {
        const int i = lane + 32 * j;
        *reinterpret_cast<uint4*>(
            &as[(i / (S::A_W / 8)) * S::A_LD + (i % (S::A_W / 8)) * 8]) =
            av[j];
      }
#pragma unroll
      for (int j = 0; j < S::B_CHUNKS / 32; ++j) {
        const int i = lane + 32 * j;
        *reinterpret_cast<uint4*>(
            &bs[(i / (S::B_W / 8)) * S::B_LD + (i % (S::B_W / 8)) * 8]) =
            bv[j];
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < kSpBK / 16; ++kk) {
        uint32_t bf[kNT][2];
        if constexpr (kMode == kDx) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const bf16* brow = &bs[(nt * 8 + gr) * S::B_LD + kk * 16 + 2 * t];
            bf[nt][0] = pfx::ld_u32(brow);
            bf[nt][1] = pfx::ld_u32(brow + 8);
          }
        } else if constexpr (kNT == 1) {
          uint32_t r2[2];
          ldsm_x2_trans(r2, &bs[(kk * 16 + (mat & 1) * 8 + li) * S::B_LD]);
          bf[0][0] = r2[0];
          bf[0][1] = r2[1];
        } else {
#pragma unroll
          for (int p = 0; p < kNT / 2; ++p) {
            uint32_t r4[4];
            pfx::ldsm_x4_trans(r4, &bs[(kk * 16 + (mat & 1) * 8 + li) *
                                           S::B_LD +
                                       p * 16 + (mat >> 1) * 8]);
            bf[2 * p][0] = r4[0];
            bf[2 * p][1] = r4[1];
            bf[2 * p + 1][0] = r4[2];
            bf[2 * p + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          uint32_t a[4];
          if constexpr (kMode == kDw) {
            pfx::ldsm_x4_trans(a, &as[(kk * 16 + (mat >> 1) * 8 + li) *
                                          S::A_LD +
                                      mt * 16 + (mat & 1) * 8]);
          } else {
            const bf16* ar = &as[(mt * 16 + gr) * S::A_LD + kk * 16 + 2 * t];
            a[0] = pfx::ld_u32(ar);
            a[1] = pfx::ld_u32(ar + 8 * S::A_LD);
            a[2] = pfx::ld_u32(ar + 8);
            a[3] = pfx::ld_u32(ar + 8 * S::A_LD + 8);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            pfx::mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
      __syncwarp();
    }
  }

  // the warps' partials, summed in warp order into this block's part
  __syncthreads();   // every warp is done with its staging
  float* red_s = reinterpret_cast<float*>(sp_raw);   // [warp][TM][TN]
  float* part = reinterpret_cast<float*>(sp_raw + S::PART_OFF);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float* p = &red_s[(warp * S::TM + mt * 16 + gr) * S::TN + nt * 8 +
                        2 * t];
      p[0] = acc[mt][nt][0];
      p[1] = acc[mt][nt][1];
      p[8 * S::TN] = acc[mt][nt][2];
      p[8 * S::TN + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < S::TM * S::TN; i += kSpThreads) {
    float sum = red_s[i];
#pragma unroll
    for (int w = 1; w < kSpWarps; ++w) sum += red_s[w * S::TM * S::TN + i];
    part[i] = sum;
  }
  // the blocks' parts, summed in rank order by rank 0 through
  // distributed shared memory
  cluster.sync();
  if (split == 0) {
    for (int i = threadIdx.x; i < S::TM * S::TN; i += kSpThreads) {
      float sum = part[i];
      for (int q = 1; q < splits; ++q)
        sum += cluster.map_shared_rank(part, q)[i];
      const int row = m0 + i / S::TN, col = n0 + i % S::TN;
      if (row < rows && col < N) {
        const long long at = ((long long)grp * rows + row) * N + col;
        if (kMode == kDw)
          static_cast<float*>(out)[at] = sum;
        else
          static_cast<bf16*>(out)[at] = __float2bfloat16(sum);
      }
    }
  }
  cluster.sync();   // the other blocks' parts stay until rank 0 has read
}

// Kernel 8 (kFwd, kDx) and kernel 9 on route (b), named apart as above.
template <int kMT, int kNT, int kMode>
__global__ void __launch_bounds__(kSpThreads)
    gmm_split_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b,
                     const int* __restrict__ counts, void* __restrict__ out,
                     int C, int K, int N, int rep, long long sw,
                     long long ldb, int vec) {
  split_body<kMT, kNT, kMode>(x, b, counts, out, C, K, N, rep, sw, ldb, vec);
}

template <int kMT, int kNT>
__global__ void __launch_bounds__(kSpThreads)
    gmm_dw_split_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b,
                        const int* __restrict__ counts, void* __restrict__ out,
                        int C, int K, int N, int rep, long long sw,
                        long long ldb, int vec) {
  split_body<kMT, kNT, kDw>(x, b, counts, out, C, K, N, rep, sw, ldb, vec);
}

// ---- host side -----------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A 3-D tensor map of bf16 (or, with f32, fp32) elements: dims {d0
// (contiguous), d1, d2}, element strides s1, s2, boxes of 128 bytes x
// box1 x 1, 128-byte swizzle; loads read zeros past the edges, stores
// write nothing there.
bool make_map(CUtensorMap* map, const void* ptr, long long d0, long long d1,
              long long d2, long long s1, long long s2, int box1,
              bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  // a stride of a dimension of extent 1 is never stepped: keep it legal
  const int esize = f32 ? 4 : 2;
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d1 > 1 ? s1 : d0) * esize,
      static_cast<cuuint64_t>(d2 > 1 ? s2 : d0 * d1) * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Route (a): one persistent block an SM (at most one a tile).
template <int kMode, int kBN>
int launch_wgmma_tile(const CUtensorMap& ma, const CUtensorMap& mb,
                      const CUtensorMap& mo, const int* counts, int rows,
                      int cols, int red, int rep, int groups,
                      cudaStream_t st) {
  constexpr int kSmem = WgShape<kBN>::SMEM;
  void (*kern)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
               const int*, int, int, int, int, int, int, int);
  if constexpr (kMode == kDw)
    kern = gmm_dw_wgmma_kernel<kBN>;
  else
    kern = gmm_wgmma_kernel<kMode, kBN>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int dev = 0, sms = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess)
    return static_cast<int>(rc);
  const int tiles_m = (rows + kWgBM - 1) / kWgBM;
  const int tiles_n = (cols + kBN - 1) / kBN;
  const long long tiles = (long long)groups * tiles_m * tiles_n;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, kWgThreads, kSmem, st>>>(ma, mb, mo, counts, rows, cols, red,
                                        rep, groups, tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

// Route (a) at a tile of 128 x tile_n, tile_n 128 or 256. The maps: x
// (A; rows of kernel 8, boxes 64 x 128 or, for kernel 9, 64 x 64), B
// (boxes 64 x 64, or 64 x tile_n for the dx route's K-major rows) and
// the output (boxes of 64 rows).
template <int kMode>
int launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb,
                 const CUtensorMap& mo, const int* counts, int rows,
                 int cols, int red, int rep, int groups, int tile_n,
                 cudaStream_t st) {
  if (tile_n == 256)
    return launch_wgmma_tile<kMode, 256>(ma, mb, mo, counts, rows, cols,
                                         red, rep, groups, st);
  if (tile_n == 128)
    return launch_wgmma_tile<kMode, 128>(ma, mb, mo, counts, rows, cols,
                                         red, rep, groups, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Route (b): `splits` blocks a cluster, one cluster an output tile.
template <int kMT, int kNT, int kMode>
int launch_split_tile(const bf16* x, const bf16* b, const int* counts,
                      void* out, int groups, int C, int K, int N, int rep,
                      long long sw, long long ldb, int vec, int splits,
                      cudaStream_t st) {
  using S = SplitShape<kMT, kNT, kMode>;
  void (*kern)(const bf16*, const bf16*, const int*, void*, int, int, int,
               int, long long, long long, int);
  if constexpr (kMode == kDw)
    kern = gmm_dw_split_kernel<kMT, kNT>;
  else
    kern = gmm_split_kernel<kMT, kNT, kMode>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int rows = kMode == kDw ? K : C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * ((N + S::TN - 1) / S::TN),
                     (rows + S::TM - 1) / S::TM, groups);
  cfg.blockDim = dim3(kSpThreads);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kern, x, b, counts, out, C, K, N, rep, sw,
                          ldb, vec);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The split route at a tile of 16 x 8, 64 x 8 or 16 x 64 (the wrapper's
// `plan`: 16 rows for an output of at most 16, 8 columns for one of at
// most 8) over clusters of 1-8 blocks.
template <int kMode>
int launch_split(const bf16* x, const bf16* b, const int* counts, void* out,
                 int groups, int C, int K, int N, int rep, long long sw,
                 long long ldb, int vec, int tile_m, int tile_n, int splits,
                 cudaStream_t st) {
  if (splits < 1 || splits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_m == 16 && tile_n == 8)
    return launch_split_tile<1, 1, kMode>(x, b, counts, out, groups, C, K, N,
                                          rep, sw, ldb, vec, splits, st);
  if (tile_m == 64 && tile_n == 8)
    return launch_split_tile<4, 1, kMode>(x, b, counts, out, groups, C, K, N,
                                          rep, sw, ldb, vec, splits, st);
  if (tile_m == 16 && tile_n == 64)
    return launch_split_tile<1, 8, kMode>(x, b, counts, out, groups, C, K, N,
                                          rep, sw, ldb, vec, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

enum { kRouteMma = 0, kRouteWgmma = 1, kRouteSplit = 2 };

// The tiles each route's kernels are built for.
bool tile_ok(int is_bf16, int route, int tm, int tn) {
  if (!is_bf16) return route == kRouteMma && tm == kF32B && tn == kF32B;
  if (route == kRouteMma) return tm == kBM && tn == kBN;
  if (route == kRouteWgmma) return tm == kWgBM && (tn == 128 || tn == 256);
  if (route == kRouteSplit)
    return (tm == 16 && (tn == 8 || tn == 64)) || (tm == 64 && tn == 8);
  return false;
}

}  // namespace

// Kernel 8: out [g, c, n] = x [g, c, k] @ B[g / rep] for counts[g] > 0,
// else zeros, in x's type (bf16 when is_bf16, else fp32). B (k, n) of
// expert e sits at w + e sw + k sbk + n sbn with sbn == 1 (the forward's
// [K, N]) or sbk == 1 (the dx route's transposed view). x, out and
// counts (int32 [g]) are contiguous. `route` and its output tile
// (tile_m x tile_n): 0 the mma.sync kernel, 64 x 128 (fp32: the
// CUDA-core kernel, 64 x 64); 1 wgmma, 128 x 128 or 128 x 256 (bf16; k,
// n, the B stride and sw multiples of 8, 16-byte aligned pointers); 2
// the split reduction, 16 x 8, 64 x 8 or 16 x 64 (bf16) over clusters of
// `splits` (1-8) blocks. Returns a cudaError_t: 0 on a successful
// launch, cudaErrorInvalidValue for a route or tile that does not take
// the shape; runs on `stream` and does not synchronise.
extern "C" int pfx_grouped_matmul(const void* x, const void* w,
                                  const int* counts, void* out, int g, int c,
                                  int k, int n, int rep, long long sw,
                                  long long sbk, long long sbn, int is_bf16,
                                  int route, int tile_m, int tile_n,
                                  int splits, void* stream) {
  if (g <= 0 || c <= 0 || k <= 0 || n <= 0 || rep <= 0 || g % rep ||
      g > 65535 || (sbn != 1 && sbk != 1) ||
      !tile_ok(is_bf16, route, tile_m, tile_n))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool k_contig = sbn != 1;
  const long long ldb = k_contig ? sbn : sbk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const int vec = k % 8 == 0 && n % 8 == 0 && ldb % 8 == 0 && sw % 8 == 0 &&
                  aligned16(x) && aligned16(w) && aligned16(out);
  if (route == kRouteWgmma) {
    if (!vec) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ma, mb, mo;
    const int gw = g / rep;
    if (!make_map(&ma, x, k, c, g, k, (long long)c * k, kWgBM) ||
        !(k_contig ? make_map(&mb, w, k, n, gw, ldb, sw, tile_n)
                   : make_map(&mb, w, n, k, gw, ldb, sw, kWgBK)) ||
        !make_map(&mo, out, n, c, g, n, (long long)c * n, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    return k_contig ? launch_wgmma<kDx>(ma, mb, mo, counts, c, n, k, rep, g,
                                        tile_n, st)
                    : launch_wgmma<kFwd>(ma, mb, mo, counts, c, n, k, rep,
                                         g, tile_n, st);
  }
  if (route == kRouteSplit) {
    return k_contig ? launch_split<kDx>(xb, wb, counts, out, g, c, k, n, rep,
                                        sw, ldb, vec, tile_m, tile_n, splits,
                                        st)
                    : launch_split<kFwd>(xb, wb, counts, out, g, c, k, n,
                                         rep, sw, ldb, vec, tile_m, tile_n,
                                         splits, st);
  }
  if (route != kRouteMma) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    const dim3 grid((n + kBN - 1) / kBN, (c + kBM - 1) / kBM, g);
    bf16* ob = static_cast<bf16*>(out);
    if (k_contig)
      gmm_mma_kernel<true><<<grid, kThreads, 0, st>>>(xb, wb, counts, ob, c,
                                                      k, n, rep, sw, ldb, vec);
    else
      gmm_mma_kernel<false><<<grid, kThreads, 0, st>>>(
          xb, wb, counts, ob, c, k, n, rep, sw, ldb, vec);
  } else {
    const dim3 grid((n + kF32B - 1) / kF32B, (c + kF32B - 1) / kF32B, g);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    if (k_contig)
      gmm_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(xf, wf, counts, of,
                                                         c, k, n, rep, sw,
                                                         ldb);
    else
      gmm_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(
          xf, wf, counts, of, c, k, n, rep, sw, ldb);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 9: dw [gw, k, n] fp32 = per expert e the sum over its rep = g /
// gw groups with counts > 0 of x[g]^T @ dy[g]; x [g, c, k] and dy [g, c,
// n] contiguous, bf16 when is_bf16, else fp32. `route`, its tile (over
// the output [k, n]) and `splits` as for kernel 8 (wgmma: k and n
// multiples of 8). Returns a cudaError_t: 0 on a successful launch,
// cudaErrorInvalidValue for a route or tile that does not take the
// shape; runs on `stream` and does not synchronise.
extern "C" int pfx_grouped_matmul_dw(const void* x, const void* dy,
                                     const int* counts, float* dw, int g,
                                     int gw, int c, int k, int n, int is_bf16,
                                     int route, int tile_m, int tile_n,
                                     int splits, void* stream) {
  if (g <= 0 || gw <= 0 || g % gw || c <= 0 || k <= 0 || n <= 0 ||
      gw > 65535 || !tile_ok(is_bf16, route, tile_m, tile_n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = g / gw;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* yb = static_cast<const bf16*>(dy);
  const int vec = k % 8 == 0 && n % 8 == 0 && aligned16(x) &&
                  aligned16(dy) && aligned16(dw);
  if (route == kRouteWgmma) {
    if (!vec) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ma, mb, mo;
    if (!make_map(&ma, x, k, c, g, k, (long long)c * k, kWgBK) ||
        !make_map(&mb, dy, n, c, g, n, (long long)c * n, kWgBK) ||
        !make_map(&mo, dw, n, k, gw, n, (long long)k * n, 64, true))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<kDw>(ma, mb, mo, counts, k, n, c, rep, gw, tile_n,
                             st);
  }
  if (route == kRouteSplit)
    return launch_split<kDw>(xb, yb, counts, dw, gw, c, k, n, rep, 0, 0, vec,
                             tile_m, tile_n, splits, st);
  if (route != kRouteMma) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    const dim3 grid((n + kBN - 1) / kBN, (k + kBM - 1) / kBM, gw);
    gmm_dw_mma_kernel<<<grid, kThreads, 0, st>>>(xb, yb, counts, dw, c, k, n,
                                                 rep, vec);
  } else {
    const dim3 grid((n + kF32B - 1) / kF32B, (k + kF32B - 1) / kF32B, gw);
    gmm_dw_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), counts,
        dw, c, k, n, rep);
  }
  return static_cast<int>(cudaGetLastError());
}
