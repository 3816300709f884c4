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
// FLOPs per live (query, key) pair; at prefill and training lengths
// (hundreds of tokens and up) that is far above the H100's ~295
// FLOP/byte balance point, so the kernel is bound by the tensor cores
// (989 TFLOP/s bf16; the training call, b 8, h 16, s 1024, d 64, causal,
// 0.0174 ms) as long as the softmax between the two products (an exp,
// the masks, the row max and sum, and under dropout a quarter of a
// Philox4x32-10 call a score: 40 integer multiplies a call) hides behind
// them. fp32 runs on the CUDA cores (67 TFLOP/s; TF32 would miss fp32
// parity). Three routes, picked by the wrapper's plan (ops/cuda/
// flash_attention.py):
//
// - wgmma (flash_fwd_wgmma; bf16, d 64 and 128, any sq and skv, causal
//   or not, bias, dropout): a block is one warpgroup that owns 64 query
//   rows; three blocks share an SM with 64-key tiles at d 64 (ptxas then
//   allows 168 registers a thread), two otherwise. The block's Q arrives
//   once by
//   TMA; a ring of K and V tiles of BN keys (64, or 128 at d 64 where the
//   plan picks it) walks up to the causal limit, K and V each with
//   `full` mbarriers counting the TMA bytes, so thread 0 refills a K
//   slot as soon as the score product that read it is done and a V slot
//   once the P.V product is. Tensor maps are 4-D over [b, s, h, d]
//   (128-byte swizzle), so TMA zero-fills rows past sq / skv. S = Q K^T
//   is wgmma m64nBNk16 with both operands K-major from shared memory;
//   O += P V is m64nDk16 with P, the bf16 probabilities, as the register
//   A operand made from the S accumulator, and V read MN-major through
//   the descriptor's transpose bit (no transposed copy is staged). Each
//   step issues the next tile's S and this tile's P V together and runs
//   the next tile's softmax while P V is on the tensor cores; the ring
//   runs a tile ahead of both. The softmax is in the exp2 domain
//   (scale log2(e) folded into one FFMA with the running max); tiles
//   wholly inside the causal triangle and the key edge, without a bias,
//   take no mask. Dropout draws one Philox call per four scores (the
//   lanes t and t ^ 1 share each key quad and swap their words, as
//   kernel 4 does), while the products run. O leaves through the Q boxes
//   and a TMA store (rows past sq unwritten); lse, in natural log for
//   kernels 3 and 4, from the row max and sum. Grid (b h, 64-row tiles),
//   the longest causal walks first. What bounds it as built (PERF.md,
//   section 6): without dropout, latency: each step's score product and
//   softmax run in series (only P V overlaps), so three warpgroups an SM
//   leave the tensor cores mostly idle at the training call; with
//   dropout, Philox's integer work (20 wide multiplies a call) adds about
//   as much again.
// - mma (flash_fwd_mma_kernel, bf16): the first design on mma.sync,
//   kept so that chip_smoke.py can time it beside the wgmma route; no
//   path plans it. See the note above it.
// - fp32 (flash_fwd_kernel, the parity route): 256 threads, four per
//   query row, each holding the scaled q row and a quarter of the output
//   row; a 32-key K/V tile is staged in shared memory (rows padded so
//   the 16-byte reads of the four threads of a row hit distinct banks,
//   and the eight rows of a warp broadcast); probabilities move between
//   the four threads of a row by warp shuffles, never through memory.
//
// Both older kernels walk the KV tiles of one 64-row query tile (one
// block per (b*h, query tile)) up to the tile's causal limit and mask
// the ragged sq / skv edges themselves.

#include "flash_wgmma.cuh"

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

// ---- bf16 on wgmma (the planned route) ----------------------------------

using pfx::fence_acc;
using pfx::wgmma_commit;
using pfx::wgmma_fence;
using pfx::wgmma_wait;
namespace attn = pfx::attn;

// The shape of the wgmma route at head_dim D and BN keys a tile. BLOCKS
// share an SM: 3 at d 64 with 64-key tiles (ptxas then allows 168
// registers a thread), else 2 (255 registers: d 128's O accumulator is
// 64, and the 128-key tile's scores and two P operands are 128 more;
// at 168 they spilled). A deeper ring did not move the 64-key tile's
// time on the H100; at d 128 a third stage left one block an SM. Shared
// memory, from a
// 1024-byte aligned base: the block's 64 query rows (D / 64 boxes,
// which take O at the end); a ring of STAGES K tiles and STAGES V tiles
// (BN rows each); the barriers (Q, full_k, full_v).
template <int D, int BN>
struct WgShape {
  static constexpr int BLOCKS = D == 64 && BN == 64 ? 3 : 2;
  static constexpr int Q = (D / 64) * attn::kBox;
  static constexpr int KV = (D / 64) * BN * 128;   // one K or V tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int BYTES = 1024 + Q + STAGES * 2 * KV +
                               (1 + 2 * STAGES) * 8;
};

// Kernel 1, bf16: O and lse of the 64 queries q0 .. q0 + 63 of one
// (batch, head), over key tiles of BN; kBias: whether `bias` is given
// (a template branch, so that a call without one carries none of its
// registers).
template <int D, int BN, bool kDrop, bool kBias>
__global__ void __launch_bounds__(attn::kThreads, WgShape<D, BN>::BLOCKS)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o,
                    float* __restrict__ lse, const float* __restrict__ bias,
                    int h, int sq, int skv, long long bias_sb,
                    long long bias_sh, long long bias_sq, float sm_scale,
                    int causal, pfx::Dropout drop) {
  using S = WgShape<D, BN>;
  using attn::kTile;
  constexpr int kStages = S::STAGES;
  constexpr int kN = BN / 2;           // score accumulators a thread
  constexpr int kSteps = BN / 16;      // k16 steps of P V
  constexpr int kHalves = BN / 64;     // 64-key blocks of a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (pfx::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + S::Q;     // stage s: K at 2 s KV, V after it
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + 2 * kStages * S::KV);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + kStages;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  // causal: the longest walks (the last query tiles) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int kv_end = causal ? min(skv, q0 + kTile) : skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (tid == 0) {
    pfx::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      pfx::mbar_init(&full_k[s], 1);
      pfx::mbar_init(&full_v[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 feeds the ring: K of tile `it` once the score product that
  // read its stage is done, V once the P V product is
  auto load = [&](const CUtensorMap* map, uint64_t* full, int off, int it) {
    const int stage = it % kStages;
    unsigned char* tile = ring + 2 * stage * S::KV + off;
    pfx::mbar_expect_tx(&full[stage], S::KV);
    for (int c = 0; c < D / 64; ++c)
      pfx::tma_load_4d(tile + c * BN * 128, map, &full[stage], 64 * c, hi,
                       it * BN, bi);
  };
  if (tid == 0) {
    pfx::mbar_expect_tx(q_bar, S::Q);
    for (int c = 0; c < D / 64; ++c)
      pfx::tma_load_4d(qs + c * attn::kBox, &map_q, q_bar, 64 * c, hi, q0,
                       bi);
    for (int it = 0; it < kStages && it < n_tiles; ++it) {
      load(&map_k, full_k, 0, it);
      load(&map_v, full_v, S::KV, it);
    }
  }

  // accumulator element 4 j + 2 hh + u: query row_r[hh], key column
  // 8 j + 2 t + u of the tile
  const int row_r[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float* b_r[2] = {nullptr, nullptr};
  if constexpr (kBias) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      b_r[hh] = bias + bi * bias_sb + hi * bias_sh +
                (long long)min(row_r[hh], sq - 1) * bias_sq;
  }
  const float scale_log2 = sm_scale * attn::kLog2e;
  // the running max (log2 units) and this thread's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[kN];
  uint32_t pa[kSteps][4], pn[kSteps][4];
  uint32_t even[kHalves], odd[kHalves];   // the next tile's keep bits

  // scores of tile `it` in s -> the P operand p (dropped), the running
  // max and sum, and the factor alpha that rescales O
  auto softmax = [&](int it, uint32_t (*p)[4], float* alpha) {
    const int n0 = it * BN;
    // a tile wholly inside the causal triangle and the key edge needs no
    // mask; without a bias either it takes one FFMA and one ex2 a score
    const bool unmasked = n0 + BN <= skv && (!causal || n0 + BN <= q0 + 1);
    const bool inner = unmasked && !kBias;
    float mt[2] = {-INFINITY, -INFINITY};
    if (inner) {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], s[e]);
      mt[0] *= scale_log2;
      mt[1] *= scale_log2;
    } else {
      // causal-masked keys take NEG_INF before the bias, as the TPU
      // kernel; keys past skv take -inf (no weight in max or sum). The
      // bias is read at keys clamped into the row, so that no load waits
      // on a per-key condition and the compiler can issue them together.
#pragma unroll
      for (int e = 0; e < kN; e += 4) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = n0 + 8 * (e >> 2) + 2 * t + u;
          const bool live = unmasked || key < skv;
          float bv[2] = {0.f, 0.f};
          if constexpr (kBias) {
            const int kc = min(key, skv - 1);
            bv[0] = b_r[0][kc] * attn::kLog2e;
            bv[1] = b_r[1][kc] * attn::kLog2e;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float x = s[e + 2 * hh + u] * scale_log2;
            if (!unmasked && causal && key > row_r[hh])
              x = pfx::kNegInf * attn::kLog2e;
            x = live ? x + bv[hh] : -INFINITY;
            s[e + 2 * hh + u] = x;
            mt[hh] = fmaxf(mt[hh], x);
          }
        }
      }
    }
    float nm[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(attn::kFullMask, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(attn::kFullMask, mt[hh], 2));
      const float m_new = fmaxf(m[hh], mt[hh]);
      alpha[hh] = attn::ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
      nm[hh] = -m_new;
    }
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int hh = (e >> 1) & 1;
      const float pe = attn::ex2(inner ? fmaf(s[e], scale_log2, nm[hh])
                                       : s[e] + nm[hh]);
      l[hh] += pe;
      // only the P V operand is dropped (its 1 / (1 - rate) is applied to
      // O at the end); l summed the full p
      if constexpr (kDrop)
        s[e] = attn::keep_bit(even[e >> 5], odd[e >> 5], e) ? pe : 0.f;
      else
        s[e] = pe;
    }
    attn::acc_to_a<BN>(s, p);
  };
  auto keep = [&](int it) {
#pragma unroll
    for (int k = 0; k < kHalves; ++k)
      attn::keep_words(drop, bh, row_r, it * BN + 64 * k, t, &even[k],
                       &odd[k]);
  };

  // tile 0's scores; then each step issues the next tile's scores and
  // this tile's P V, and runs the next tile's softmax while P V runs
  attn::bar_wait(q_bar, 0);
  attn::bar_wait(&full_k[0], 0);
  wgmma_fence();
  attn::product_rows<D, BN>(s, qs, ring);
  wgmma_commit();
  if constexpr (kDrop) keep(0);
  wgmma_wait<0>();
  fence_acc<kN>(s);
  if (tid == 0 && kStages < n_tiles) load(&map_k, full_k, 0, kStages);
  float alpha[2];
  softmax(0, pa, alpha);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const bool more = it + 1 < n_tiles;
    wgmma_fence();
    if (more) {
      const int ns = (it + 1) % kStages;
      attn::bar_wait(&full_k[ns], ((it + 1) / kStages) & 1);
      attn::product_rows<D, BN>(s, qs, ring + 2 * ns * S::KV);
      wgmma_commit();
    }
    attn::bar_wait(&full_v[stage], (it / kStages) & 1);
    attn::product_acc<D, BN>(o, pa, ring + 2 * stage * S::KV + S::KV);
    wgmma_commit();
    if (more) {
      if constexpr (kDrop) keep(it + 1);
      wgmma_wait<1>();   // the next scores are done
      fence_acc<kN>(s);
      if (tid == 0 && it + 1 + kStages < n_tiles)
        load(&map_k, full_k, 0, it + 1 + kStages);
      softmax(it + 1, pn, alpha);
    }
    wgmma_wait<0>();     // P V is done
    fence_acc<D / 2>(o);
    attn::fence_u32<kSteps>(pa);
    if (tid == 0 && it + kStages < n_tiles)
      load(&map_v, full_v, S::KV, it + kStages);
    if (more) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[k][r] = pn[k][r];
    }
  }

  // every product is done: the Q boxes take O, rows past sq unwritten
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(attn::kFullMask, l[hh], 1);
    l[hh] += __shfl_xor_sync(attn::kFullMask, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
    inv[hh] = (kDrop ? drop.scale : 1.f) / l[hh];
  }
  attn::store_rows<D>(o, inv, qs, tid);
  pfx::fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < D / 64; ++c)
      pfx::tma_store_4d(&map_o, qs + c * attn::kBox, 64 * c, hi, q0, bi);
    pfx::bulk_commit();
  }
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (row_r[hh] < sq)
        lse[(long long)bh * sq + row_r[hh]] =
            m[hh] * attn::kLn2 + logf(l[hh]);
  }
  if (tid == 0) pfx::bulk_wait();
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

template <int D, int BN, bool kDrop, bool kBias>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const float* bias, void* o, float* lse, int b, int h,
                 int sq, int skv, long long bias_sb, long long bias_sh,
                 long long bias_sq, float sm_scale, int causal,
                 pfx::Dropout drop, cudaStream_t stream) {
  constexpr int bytes = WgShape<D, BN>::BYTES;
  CUtensorMap mq, mk, mv, mo;
  if (!attn::map_bshd(&mq, q, b, sq, h, D) ||
      !attn::map_bshd(&mk, k, b, skv, h, D, BN) ||
      !attn::map_bshd(&mv, v, b, skv, h, D, BN) ||
      !attn::map_bshd(&mo, o, b, sq, h, D))
    return static_cast<int>(cudaErrorNotSupported);
  // BLOCKS blocks an SM need the largest shared-memory carveout (three
  // 74 KB blocks at d 64 with 128-key tiles)
  cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, BN, kDrop, kBias>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(
        flash_fwd_wgmma<D, BN, kDrop, kBias>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * h, (sq + attn::kTile - 1) / attn::kTile);
  flash_fwd_wgmma<D, BN, kDrop, kBias>
      <<<grid, attn::kThreads, bytes, stream>>>(
      mq, mk, mv, mo, lse, bias, h, sq, skv, bias_sb, bias_sh, bias_sq,
      sm_scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel of head_dim d and key tile block_n (64, or 128 at d
// 64); cudaErrorInvalidValue for any other pair.
template <bool kDrop, bool kBias>
int wgmma_tile(const void* q, const void* k, const void* v,
               const float* bias, void* o, float* lse, int b, int h, int sq,
               int skv, int d, long long sb, long long sh, long long sqs,
               float sm_scale, int causal, int block_n, pfx::Dropout drop,
               cudaStream_t st) {
  if (d == 64 && block_n == 64)
    return launch_wgmma<64, 64, kDrop, kBias>(q, k, v, bias, o, lse, b, h,
                                              sq, skv, sb, sh, sqs, sm_scale,
                                              causal, drop, st);
  if (d == 64 && block_n == 128)
    return launch_wgmma<64, 128, kDrop, kBias>(q, k, v, bias, o, lse, b, h,
                                               sq, skv, sb, sh, sqs,
                                               sm_scale, causal, drop, st);
  if (d == 128 && block_n == 64)
    return launch_wgmma<128, 64, kDrop, kBias>(q, k, v, bias, o, lse, b, h,
                                               sq, skv, sb, sh, sqs,
                                               sm_scale, causal, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Route codes of the C entry point (the wrapper's _ROUTE_CODE): 0 is
// the mma.sync kernel for bf16 and the CUDA-core kernel for fp32, 1 the
// wgmma kernel (bf16 only).
constexpr int kRouteMma = 0;
constexpr int kRouteWgmma = 1;

template <bool kDrop>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int b, int h, int sq, int skv, int d,
           long long sb, long long sh, long long sqs, float sm_scale,
           int causal, int is_bf16, int route, int block_n,
           pfx::Dropout drop, cudaStream_t st) {
  if (route == kRouteWgmma && is_bf16) {
    if (bias != nullptr)
      return wgmma_tile<kDrop, true>(q, k, v, bias, o, lse, b, h, sq, skv, d,
                                     sb, sh, sqs, sm_scale, causal, block_n,
                                     drop, st);
    return wgmma_tile<kDrop, false>(q, k, v, bias, o, lse, b, h, sq, skv, d,
                                    sb, sh, sqs, sm_scale, causal, block_n,
                                    drop, st);
  } else if (route == kRouteMma && is_bf16 && block_n == kMmaBlockN) {
    if (d == 64)
      return launch_mma<64, kDrop>(q, k, v, bias, o, lse, b, h, sq, skv, sb,
                                   sh, sqs, sm_scale, causal, drop, st);
    if (d == 128)
      return launch_mma<128, kDrop>(q, k, v, bias, o, lse, b, h, sq, skv, sb,
                                    sh, sqs, sm_scale, causal, drop, st);
  } else if (route == kRouteMma && !is_bf16 && block_n == kBlockN) {
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
// `route` (kRouteMma, kRouteWgmma) and its key tile `block_n` (mma 64,
// fp32 32, wgmma 64 or, at d 64, 128) pick the kernel; a route that does
// not take the call returns cudaErrorInvalidValue.
extern "C" int pfx_flash_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* o, float* lse, int b,
                             int h, int sq, int skv, int d, long long bias_sb,
                             long long bias_sh, long long bias_sq,
                             float sm_scale, int causal, int is_bf16,
                             int dropout, unsigned int keep_threshold,
                             float keep_scale, unsigned long long seed,
                             int route, int block_n, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfx::Dropout drop = pfx::make_dropout(seed, keep_threshold,
                                              keep_scale);
  if (dropout)
    return launch<true>(q, k, v, bias, o, lse, b, h, sq, skv, d, bias_sb,
                        bias_sh, bias_sq, sm_scale, causal, is_bf16, route,
                        block_n, drop, st);
  return launch<false>(q, k, v, bias, o, lse, b, h, sq, skv, d, bias_sb,
                       bias_sh, bias_sq, sm_scale, causal, is_bf16, route,
                       block_n, drop, st);
}
