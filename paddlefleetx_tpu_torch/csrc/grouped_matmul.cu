// Grouped matmul for Hopper (sm_90a): kernels 8 and 9 of the port, the
// expert GEMMs of the MoE block under `moe_dispatch: sort_pallas`.
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
// contiguous. A template parameter on B's layout serves both, so no
// transposed copy of w is made per step.
// Kernel 9 (grouped_matmul_dw):
//   dw[e] = sum over i < rep with counts[e rep + i] > 0 of
//           x[e rep + i]^T @ dy[e rep + i],
// x [G, C, K], dy [G, C, N] in one type, dw [Gw, K, N] fp32; an expert
// whose groups are all empty gets zeros.
//
// What bounds them on this card: at the MoE recipe's shapes (G 16,
// C 320, K x N 1024 x 4096 and 4096 x 1024, bf16) kernel 8 does 4.3e10
// FLOPs against ~120 MB (the bf16 expert weights are most of it), ~360
// FLOP/B, above the H100's ~295 bf16 FLOP/B: the products, on the
// tensor cores. Kernel 9 does the same FLOPs but writes the fp32 dw
// (134 MB of ~187 MB), ~230 FLOP/B: the bytes.
//
// What the design does about it:
// - bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulate), 128
//   threads a block, a 64 x 128 output tile, each of the 4 warps 64 x 32
//   of it. The block reads its group's count itself (the TPU's scalar
//   prefetch); an empty group's block writes its tile of zeros (the
//   output is not pre-zeroed) and returns. A live block walks K in
//   32-deep tiles inside the block (the TPU's sequential K grid axis),
//   staged in shared memory with rows padded by 16 bytes; the next
//   tile's global loads are issued into registers before the current
//   tile's products. The A operand (x, K contiguous) is read by 32-bit
//   fragment loads; a B tile with N contiguous is staged as it is read,
//   [k][n], and its fragments come from ldmatrix.trans; a B tile with K
//   contiguous is staged [n][k] and read like A. Every edge (C, N, K) is
//   masked; a shape whose rows are not 16-byte aligned (K or N not a
//   multiple of 8, odd strides) takes element loads instead of vectors.
// - Kernel 9: a grid over (expert, K tile, N tile); each block loops
//   over its expert's rep groups, skipping empty ones, and over their C
//   rows (the reduction axis) in 32-row tiles, and owns its dw tile: no
//   atomics, so the result is deterministic (the TPU's sequential group
//   axis becomes the in-block loop). Both operands are staged as read,
//   x as [c][k] and dy as [c][n], and both fragments come from
//   ldmatrix.trans.
// - fp32 (CUDA cores, FMAs in order over K; TF32 would miss fp32
//   parity, as for kernels 1 and 7): 256 threads, a 64 x 64 tile, each
//   thread a 4 x 4 block, element loads with every edge masked.
// wgmma, TMA and a persistent schedule are later work.

#include "common.cuh"

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Kernel 8: out [g, c, n] = x [g, c, k] @ B[g / rep] for counts[g] > 0,
// else zeros, in x's type (bf16 when is_bf16, else fp32). B (k, n) of
// expert e sits at w + e sw + k sbk + n sbn with sbn == 1 (the forward's
// [K, N]) or sbk == 1 (the dx route's transposed view). x, out and
// counts (int32 [g]) are contiguous. Returns a cudaError_t: 0 on a
// successful launch; runs on `stream` and does not synchronise.
extern "C" int pfx_grouped_matmul(const void* x, const void* w,
                                  const int* counts, void* out, int g, int c,
                                  int k, int n, int rep, long long sw,
                                  long long sbk, long long sbn, int is_bf16,
                                  void* stream) {
  if (g <= 0 || c <= 0 || k <= 0 || n <= 0 || rep <= 0 || g % rep ||
      g > 65535 || (sbn != 1 && sbk != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool k_contig = sbn != 1;
  const long long ldb = k_contig ? sbn : sbk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int vec = k % 8 == 0 && n % 8 == 0 && ldb % 8 == 0 && sw % 8 == 0 &&
                    aligned16(x) && aligned16(w) && aligned16(out);
    const dim3 grid((n + kBN - 1) / kBN, (c + kBM - 1) / kBM, g);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
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
// n] contiguous, bf16 when is_bf16, else fp32. Returns a cudaError_t: 0
// on a successful launch; runs on `stream` and does not synchronise.
extern "C" int pfx_grouped_matmul_dw(const void* x, const void* dy,
                                     const int* counts, float* dw, int g,
                                     int gw, int c, int k, int n, int is_bf16,
                                     void* stream) {
  if (g <= 0 || gw <= 0 || g % gw || c <= 0 || k <= 0 || n <= 0 ||
      gw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = g / gw;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int vec = k % 8 == 0 && n % 8 == 0 && aligned16(x) &&
                    aligned16(dy) && aligned16(dw);
    const dim3 grid((n + kBN - 1) / kBN, (k + kBM - 1) / kBM, gw);
    gmm_dw_mma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), counts, dw,
        c, k, n, rep, vec);
  } else {
    const dim3 grid((n + kF32B - 1) / kF32B, (k + kF32B - 1) / kF32B, gw);
    gmm_dw_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), counts,
        dw, c, k, n, rep);
  }
  return static_cast<int>(cudaGetLastError());
}
