// Flash-attention forward for Hopper (sm_90a), the port's prefill kernel.
//
// Replaces: paddlefleetx_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_flash_forward`, pallas_call at :362, and with dropout
// at :354). Computes O = softmax(mask(q k^T * scale) + bias) v and the
// per-row logsumexp, online over KV tiles, with scores and the running
// max / sum / accumulator in fp32.
//
// Dropout (training): the keep mask of each probability is Philox on
// its absolute (bh, query, key) coordinates (philox.cuh), so the
// backward kernels (flash_bwd.cu) rebuild it without storing it. As in
// the TPU kernel's `_online_update` (:150-175) the normaliser l and the
// lse sum the UNDROPPED p; only the P.V operand is masked and scaled by
// 1 / (1 - rate). The dropout code is a template branch: a rate-0
// launch runs the same instructions as the kernel without it.
//
// Layout: q, k, v and O are [b, s, h, d] (the JAX package's public
// layout), lse is [b, h, sq] fp32, bias is fp32 and broadcastable from
// [b0, h0, q0, skv] (the wrapper passes 0 strides for broadcast dims).
// Causal masking is top-left aligned (key j is live for query i iff
// j <= i) and is applied before the bias, as on the TPU.
//
// What bounds it on this card: the score and P.V products, 4 b h d
// FLOPs per live (query, key) pair; at prefill lengths (hundreds of
// tokens) that is far above the H100's ~295 FLOP/byte balance point, so
// the kernel is compute bound. bf16 inputs run the products on the
// tensor cores (989 TFLOP/s peak) through mma.sync, fp32 inputs on the
// fp32 CUDA cores (67 TFLOP/s; TF32 would miss fp32 parity). wgmma,
// TMA and warp specialisation are later work.
//
// What the design does about it: both kernels walk the KV tiles of one
// 64-row query tile (one block per (b*h, query tile)), load only tiles
// up to the tile's causal limit, mask the ragged sq / skv edges
// themselves (any length works; prefill buckets are 16, 32, ...), and
// keep q, the output rows and the running max / sum in registers.
// - bf16 (flash_fwd_mma_kernel): see the note above it.
// - fp32 (flash_fwd_kernel): 256 threads, four per query row, each
//   holding the scaled q row and a quarter of the output row; a 32-key
//   K/V tile is staged in shared memory (rows padded so the 16-byte
//   reads of the four threads of a row hit distinct banks, and the eight
//   rows of a warp broadcast); probabilities move between the four
//   threads of a row by warp shuffles, never through memory.

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kBlockM = 64;                  // query rows per block
constexpr int kBlockN = 32;                  // keys per K/V tile
constexpr int kTpr = 4;                      // threads per query row
constexpr int kThreads = kBlockM * kTpr;     // 256
constexpr int kKpt = kBlockN / kTpr;         // keys per thread per tile

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int h, int sq, int skv,
                     long long bias_sb, long long bias_sh, long long bias_sq,
                     float sm_scale, int causal, pfx::Dropout drop) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kGroups = D / 16;   // 4-wide output groups per thread
  constexpr int kKStride = D + 4;   // padded fp32 row, 16-byte aligned

  __shared__ __align__(16) float ks[kBlockN][kKStride];
  __shared__ __align__(16) float vs[kBlockN][D];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int r = tid / kTpr;   // row within the tile
  const int c = tid % kTpr;   // thread within the row's group of four
  const int row = q0 + r;
  const bool row_ok = row < sq;
  const long long tok_stride = (long long)h * D;   // one token in [b,s,h,d]

  float qr[D];
  {
    const float* qp = q +
                      ((long long)bi * sq + (row_ok ? row : 0)) * tok_stride +
                      (long long)hi * D;
#pragma unroll
    for (int dd = 0; dd < D; ++dd)
      qr[dd] = row_ok ? qp[dd] * sm_scale : 0.f;
  }
  // output dims of this thread: g*16 + c*4 + e, e in [0, 4)
  float acc[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  float m = pfx::kNegInf;
  float l = 0.f;

  const float* brow = nullptr;
  if (bias != nullptr)
    brow = bias + bi * bias_sb + hi * bias_sh +
           (long long)(row_ok ? row : 0) * bias_sq;

  // keys past the tile's last query row are dead under the causal mask
  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int j = idx / D;
      const int dd = idx % D;
      const int key = n0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < skv) {
        const long long off =
            ((long long)bi * skv + key) * tok_stride + (long long)hi * D + dd;
        kx = k[off];
        vx = v[off];
      }
      ks[j][dd] = kx;
      vs[j][dd] = vx;
    }
    __syncthreads();

    float s[kKpt];
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKpt; ++jj) {
      const int j = c + kTpr * jj;
      const int key = n0 + j;
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; dd += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dd]);
        dot += qr[dd] * kk.x + qr[dd + 1] * kk.y + qr[dd + 2] * kk.z +
               qr[dd + 3] * kk.w;
      }
      float sv = -INFINITY;   // past skv: excluded from max and sum
      if (key < skv) {
        sv = (causal && key > row) ? pfx::kNegInf : dot;
        if (brow != nullptr) sv += brow[key];
      }
      s[jj] = sv;
      mt = fmaxf(mt, sv);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKpt; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      ls += s[jj];
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    if (kDrop) {
      // only the P.V operand is dropped; l above summed the full p
#pragma unroll
      for (int jj = 0; jj < kKpt; ++jj)
        s[jj] = drop.keep(bh, row, n0 + c + kTpr * jj) ? s[jj] * drop.scale
                                                        : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
    // P.V: key j's probability lives in thread (j % 4) of the row group
#pragma unroll
    for (int jj = 0; jj < kKpt; ++jj) {
#pragma unroll
      for (int src = 0; src < kTpr; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[jj], src, kTpr);
        const int j = src + kTpr * jj;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[j][g * 16 + c * 4]);
          acc[g][0] += p * vv.x;
          acc[g][1] += p * vv.y;
          acc[g][2] += p * vv.z;
          acc[g][3] += p * vv.w;
        }
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    float* op = o + ((long long)bi * sq + row) * tok_stride + (long long)hi * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) op[g * 16 + c * 4 + e] = acc[g][e] / lc;
    if (c == 0) lse[(long long)bh * sq + row] = m + logf(lc);
  }
}

// ---- bf16: the same function on the tensor cores ------------------------
//
// One 128-thread block per (b*h, 64-row query tile); warp w owns rows
// 16w..16w+15 of the tile. Scores S = q k^T and O += P v run as
// mma.sync m16n8k16 (bf16 operands, fp32 accumulate) over 64-key tiles
// of K (row-major, [key][d]) and V (transposed into [d][key]) staged in
// shared memory with rows padded by 16 bytes, so each fragment read of
// a warp hits 32 distinct banks. The q fragments stay in registers for
// the whole walk; the score fragments become the P operand of the P.V
// product in registers (the m16n8k16 accumulator layout of two
// neighbouring n8 blocks is the A layout of one k16 step). Row max and
// the rescale use fp32 per (row, thread) with shuffles across the four
// threads that share a row; the row sums stay per thread until the end.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlockN = 64;   // keys per K/V tile
constexpr int kPad = 8;          // bf16 elements of row padding (16 B)

using pfx::ld_u32;
using pfx::mma_bf16;
using pfx::pack_bf16;

template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int h, int sq, int skv,
                         long long bias_sb, long long bias_sh,
                         long long bias_sq, float sm_scale, int causal,
                         pfx::Dropout drop) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kK = D / 16;              // k16 steps over head_dim
  constexpr int kNb = kMmaBlockN / 8;     // n8 blocks of scores per tile
  constexpr int kDb = D / 8;              // n8 blocks of the output
  constexpr int kChunks = D / 8;          // 16-byte chunks of a d-row

  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kMmaBlockN + kPad];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int t = lane % 4;   // thread within the group
  const int r0 = q0 + warp * 16 + g;   // this thread's two rows
  const int r1 = r0 + 8;
  const long long tok_stride = (long long)h * D;

  // q fragments: a0 (r0, c..c+1), a1 (r1, c..), a2 (r0, c+8..), a3 (r1, c+8..)
  uint32_t qa[kK][4];
  {
    const __nv_bfloat16* q_r0 =
        q + ((long long)bi * sq + r0) * tok_stride + (long long)hi * D;
    const __nv_bfloat16* q_r1 = q_r0 + 8 * tok_stride;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = r0 < sq ? ld_u32(q_r0 + c) : 0u;
      qa[kk][1] = r1 < sq ? ld_u32(q_r1 + c) : 0u;
      qa[kk][2] = r0 < sq ? ld_u32(q_r0 + c + 8) : 0u;
      qa[kk][3] = r1 < sq ? ld_u32(q_r1 + c + 8) : 0u;
    }
  }
  const float* b_r0 = nullptr;
  const float* b_r1 = nullptr;
  if (bias != nullptr) {
    const float* base = bias + bi * bias_sb + hi * bias_sh;
    b_r0 = base + (long long)min(r0, sq - 1) * bias_sq;
    b_r1 = base + (long long)min(r1, sq - 1) * bias_sq;
  }

  float acc[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {pfx::kNegInf, pfx::kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of each row's sum

  const int warp_last_row = q0 + warp * 16 + 15;
  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  for (int n0 = 0; n0 < kv_end; n0 += kMmaBlockN) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kMmaBlockN * kChunks;
         idx += kMmaThreads) {
      const int j = idx / kChunks;
      const int c8 = (idx % kChunks) * 8;
      const int key = n0 + j;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < skv) {
        const long long off =
            ((long long)bi * skv + key) * tok_stride + (long long)hi * D + c8;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[j][c8]) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c8 + e][j] = ve[e];
    }
    __syncthreads();
    // every key of this tile lies past every row of this warp
    if (causal && n0 > warp_last_row) continue;

    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const __nv_bfloat16* kr = &ks[nb * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[nb], qa[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }
    // scale, mask and bias; element e is row (e < 2 ? r0 : r1), key
    // n0 + nb*8 + 2t + (e & 1)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = n0 + nb * 8 + t * 2 + (e & 1);
        float sv = -INFINITY;   // past skv: excluded from max and sum
        if (key < skv) {
          sv = (causal && key > row) ? pfx::kNegInf : s[nb][e] * sm_scale;
          if (bias != nullptr) sv += (e < 2 ? b_r0 : b_r1)[key];
        }
        s[nb][e] = sv;
        mt[e >> 1] = fmaxf(mt[e >> 1], sv);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        l[e >> 1] += s[nb][e];
      }
    if (kDrop) {
      // only the P.V operand is dropped; l above summed the full p.
      // Elements (2i, 2i+1) of block nb are keys col, col + 1 of row i.
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bool kp[2];
          drop.keep_pair(bh, i == 0 ? r0 : r1, n0 + nb * 8 + t * 2, kp);
          s[nb][2 * i] = kp[0] ? s[nb][2 * i] * drop.scale : 0.f;
          s[nb][2 * i + 1] = kp[1] ? s[nb][2 * i + 1] * drop.scale : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < kDb; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // O += P v: k16 step kk of P is score blocks 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDb; ++j) {
        const __nv_bfloat16* vr = &vt[j * 8 + g][kk * 16 + t * 2];
        mma_bf16(acc[j], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? r0 : r1;
    if (row >= sq) continue;
    __nv_bfloat16* op =
        o + ((long long)bi * sq + row) * tok_stride + (long long)hi * D;
#pragma unroll
    for (int j = 0; j < kDb; ++j)
      *reinterpret_cast<uint32_t*>(&op[j * 8 + t * 2]) =
          pack_bf16(acc[j][2 * i] / l[i], acc[j][2 * i + 1] / l[i]);
    if (t == 0) lse[(long long)bh * sq + row] = m[i] + logf(l[i]);
  }
}

template <int D, bool kDrop>
int launch_fp32(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, int b, int h, int sq,
                int skv, long long bias_sb, long long bias_sh,
                long long bias_sq, float sm_scale, int causal,
                pfx::Dropout drop, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  flash_fwd_kernel<D, kDrop><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, h, sq,
      skv, bias_sb, bias_sh, bias_sq, sm_scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDrop>
int launch_mma(const void* q, const void* k, const void* v, const float* bias,
               void* o, float* lse, int b, int h, int sq, int skv,
               long long bias_sb, long long bias_sh, long long bias_sq,
               float sm_scale, int causal, pfx::Dropout drop,
               cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  flash_fwd_mma_kernel<D, kDrop><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(o), lse, h, sq, skv, bias_sb, bias_sh,
      bias_sq, sm_scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDrop>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int b, int h, int sq, int skv, int d,
           long long sb, long long sh, long long sqs, float sm_scale,
           int causal, int is_bf16, pfx::Dropout drop, cudaStream_t st) {
  if (is_bf16) {
    if (d == 64)
      return launch_mma<64, kDrop>(q, k, v, bias, o, lse, b, h, sq, skv, sb,
                                   sh, sqs, sm_scale, causal, drop, st);
    if (d == 128)
      return launch_mma<128, kDrop>(q, k, v, bias, o, lse, b, h, sq, skv, sb,
                                    sh, sqs, sm_scale, causal, drop, st);
  } else {
    if (d == 64)
      return launch_fp32<64, kDrop>(q, k, v, bias, o, lse, b, h, sq, skv, sb,
                                    sh, sqs, sm_scale, causal, drop, st);
    if (d == 128)
      return launch_fp32<128, kDrop>(q, k, v, bias, o, lse, b, h, sq, skv,
                                     sb, sh, sqs, sm_scale, causal, drop, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns a cudaError_t: 0 on a successful launch. The kernel runs on
// `stream` and does not synchronise; the caller allocates o and lse.
// `dropout` != 0 drops probabilities with the Philox mask of `seed`
// (keep iff bits < keep_threshold, kept ones scaled by keep_scale).
extern "C" int pfx_flash_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* o, float* lse, int b,
                             int h, int sq, int skv, int d, long long bias_sb,
                             long long bias_sh, long long bias_sq,
                             float sm_scale, int causal, int is_bf16,
                             int dropout, unsigned int keep_threshold,
                             float keep_scale, unsigned long long seed,
                             void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfx::Dropout drop = pfx::make_dropout(seed, keep_threshold,
                                              keep_scale);
  if (dropout)
    return launch<true>(q, k, v, bias, o, lse, b, h, sq, skv, d, bias_sb,
                        bias_sh, bias_sq, sm_scale, causal, is_bf16, drop, st);
  return launch<false>(q, k, v, bias, o, lse, b, h, sq, skv, d, bias_sb,
                       bias_sh, bias_sq, sm_scale, causal, is_bf16, drop, st);
}
