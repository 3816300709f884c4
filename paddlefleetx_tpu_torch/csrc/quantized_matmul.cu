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
// [N, K] (nn.Linear's layout: K contiguous, the mma.sync `row.col` B
// operand as it stands), scale [N] fp32, out [M, N]. K and N are
// multiples of 128 (the TPU kernel's admission, checked by the wrapper);
// M is any positive count: the ragged M edge is masked here, where the
// TPU kernel asked for M % 8 == 0.
//
// What bounds it on this card: at decode (M = 8..80) the weight bytes,
// K N int8 against 2 M K N FLOPs - M FLOPs a byte, far below the H100's
// ~295 bf16 FLOP/B - so the least time is the weight over 3.35 TB/s,
// half of what the bf16 weight takes; at prefill (M in the hundreds) the
// products, on the tensor cores.
//
// What the design does about it: the weight is read as int8 and widened
// in shared memory (no wider copy of it exists in device memory), one
// 64 x 64 output tile per block.
// - bf16 x (qmm_mma_kernel): 128 threads; 64-deep K tiles of x and of
//   the widened weight staged in shared memory with rows padded by 16
//   bytes (each fragment read of a warp hits 32 distinct banks); the
//   next tile's global loads are issued into registers before the
//   current tile's products, so they are in flight during them. Warp w
//   owns output columns 16w..16w+15 of the tile across its four m16
//   tiles and skips the m16 tiles that lie past M, so at decode every
//   warp works on the one live tile. mma.sync m16n8k16 bf16, fp32
//   accumulate (the int8 -> bf16 widening is exact).
// - fp32 x (qmm_f32_kernel): the fp32 CUDA cores (TF32 would miss fp32
//   parity), 256 threads each owning a 4 x 4 block of the tile, 32-deep
//   K tiles staged transposed so each thread reads its 4 rows and its 4
//   columns as one 16-byte load each; every output sums its K products in
//   order with fused multiply-adds.
// At decode shapes (M = 16, N = 1024) that is 16 blocks for 132 SMs:
// split-K, wgmma and TMA are later work.
//
// The dx route (a second instance of each kernel, template kDx):
//   dx[m, k] = sum_n gs[m, n] * float(w[n, k])
// with gs = (g * scale) rounded to g's type by the wrapper, as the TPU
// route rounds it before its product, and no write-out scale (the TPU
// route passes unit scales). The reduction axis is now N and the weight
// is the same [N, K] storage, read the other way: the output axis K is
// the contiguous one. No transposed copy of the weight is made. What
// bounds it is what bounds the forward (the int8 weight's bytes at small
// M, the products at large M), and the design is the forward's with the
// B tile staged as read:
// - bf16: a 64 (n) x 64 (k) int8 tile read as 16-byte rows of k, widened
//   into shared memory as [n][k], the output axis contiguous; each warp's
//   B fragments for its 16 output columns come from one ldmatrix.trans
//   per k16 step (kernel 8's pattern for its N-contiguous B operand).
// - fp32: the CUDA-core kernel stages the weight [reduction][column]
//   already; the dx instance fills that tile from rows of k directly.

#include "common.cuh"

namespace {

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

template <bool kDx>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           int m, int n, int k, int is_bf16, cudaStream_t st) {
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

bool bad_shape(int m, int n, int k) {
  return m <= 0 || n <= 0 || k <= 0 || n % 128 || k % 128 ||
         (m + kBM - 1) / kBM > 65535;
}

}  // namespace

// Kernel 7: out [m, n] = (x [m, k] @ w [n, k]^T) * scale [n], in x's type
// (bf16 when is_bf16, else fp32). k and n are multiples of 128; every
// pointer is 16-byte aligned and contiguous. Returns a cudaError_t: 0 on
// a successful launch; runs on `stream` and does not synchronise.
extern "C" int pfx_quantized_matmul(const void* x, const void* w,
                                    const float* scale, void* out, int m,
                                    int n, int k, int is_bf16,
                                    void* stream) {
  if (bad_shape(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, static_cast<const int8_t*>(w), scale, out, m, n, k,
                       is_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel 7's dx route: dx [m, k] = gs [m, n] @ w [n, k], in gs's type
// (bf16 when is_bf16, else fp32), w the forward's int8 weight as stored
// (k contiguous), no scale. k and n are multiples of 128; every pointer
// is 16-byte aligned and contiguous. Returns a cudaError_t: 0 on a
// successful launch; runs on `stream` and does not synchronise.
extern "C" int pfx_quantized_matmul_dx(const void* gs, const void* w,
                                       void* dx, int m, int n, int k,
                                       int is_bf16, void* stream) {
  if (bad_shape(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's reduction axis is n here, its output axis k
  return launch<true>(gs, static_cast<const int8_t*>(w), nullptr, dx, m, k,
                      n, is_bf16, static_cast<cudaStream_t>(stream));
}
