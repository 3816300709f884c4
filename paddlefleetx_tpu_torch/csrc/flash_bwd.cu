// Flash-attention backward for Hopper (sm_90a): kernel 3
// `flash_bwd_dkv` (dK, dV) and kernel 4 `flash_bwd_dq` (dQ).
//
// Replaces: paddlefleetx_tpu/ops/pallas/flash_attention.py's backward
// family, all four functions that `_flash_backward` (:686) chooses
// among by shape: `_bwd_combined_kernel` (:485, num_q == 1, the 345M
// recipe's s = 1024), the split pair `_bwd_dkv_kernel` (:419) +
// `_bwd_dq_kernel` (:454) (bias or dropout at s > 1024), and
// `_bwd_fused_kernel` (:555, s > 1024 without either). The TPU split
// into four is a VMEM budget choice; here one pair of kernels covers
// every shape, bias and dropout included.
//
// Inputs: q, k, v and dO [b, s, h, d] (bf16 or fp32), lse and delta
// [b, h, sq] fp32 (delta = rowsum(dO * O) - g_lse, computed by the
// wrapper in fp32 as the JAX package does outside its kernels,
// :693-699), the optional fp32 bias broadcast from [b0, h0, q0, skv]
// (0 strides for broadcast dims; it gets no gradient) and the forward's
// dropout seed. Each kernel recomputes s = q k^T * scale, applies the
// causal mask and then the bias (the forward's order), p = exp(s - lse),
// regenerates the Philox keep mask on absolute coordinates
// (philox.cuh), and forms dP = dO v^T and dS = p * (dP * keep / (1 -
// rate) - delta). Kernel 3 accumulates dV += (p * keep / (1 - rate))^T
// dO and dK += dS^T q * scale; kernel 4 accumulates dQ += dS k and
// scales once at the end (:480-482). Outputs are in q's dtype;
// accumulation is fp32 in registers and each output is written once.
//
// What bounds it on this card: 5 b h d s^2 FLOPs for causal attention
// (the two recomputed products s and dP, and dV, dK, dQ) against
// reading q, k, v, dO, lse and delta once and writing dq, dk, dv once:
// at s = 1024 that is ~40x above the H100's ~295 FLOP/byte balance, so
// the pair is compute bound (bf16 on the tensor cores, 989 TFLOP/s;
// fp32 on the CUDA cores, 67 TFLOP/s, TF32 off for fp32 parity).
//
// What the design does about it: bf16 runs every product as mma.sync
// m16n8k16 with fp32 accumulators, the score fragments becoming the
// next product's A operand in registers (as kernel 1 does). Splitting
// into two kernels recomputes s and dP once more (7 instead of 5
// products per score element) but needs no atomics, so the gradients
// are deterministic; a single kernel with fp32 atomicAdd on dQ, wgmma
// and TMA are later work. Both walk only causally live tiles and mask
// the ragged sq / skv edges themselves, so any length works.
// - bf16, kernel 3 (flash_bwd_dkv_mma): one 128-thread block per (b*h,
//   64-key tile); warp w owns keys 16w..16w+15 and walks the 64-row
//   query tiles from the first causally live one. It computes the
//   transposed products S^T = K Q^T and dP^T = V dO^T, so that P^T and
//   dS^T sit in registers in the A layout of dV = P^T dO and
//   dK = dS^T Q. K, V, Q, dO and transposed copies of Q and dO live in
//   shared memory, rows padded by 16 bytes.
// - bf16, kernel 4 (flash_bwd_dq_mma): one 128-thread block per (b*h,
//   64-query tile) holding q and dO fragments in registers and walking
//   64-key tiles (K, V and K^T in shared memory) up to the causal limit.
// - fp32 (flash_bwd_dkv_f32 / flash_bwd_dq_f32): 256 threads, four per
//   key (kernel 3) or per query (kernel 4), each holding a quarter of
//   the row's d values and its accumulators; dot products are reduced
//   over the four threads by shuffles. The other side's rows are staged
//   32 at a time in shared memory.

#include "common.cuh"
#include "philox.cuh"

namespace {

// ---- bf16 on the tensor cores --------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;   // rows of every tile (keys and queries)
constexpr int kPad = 8;     // bf16 elements of row padding (16 B)

using pfx::ld_u32;
using pfx::mma_bf16;
using pfx::pack_bf16;

// The A fragment (rows row0 .. row0 + 15, k columns kk*16 ..) of a
// row-major [rows][ld] bf16 tile in shared memory.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int ld, int row0, int kk, int g,
                                       int t) {
  const __nv_bfloat16* p = s + (row0 + g) * ld + kk * 16 + t * 2;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// Stage rows r0 .. r0 + 63 of a [b, s, h, D] bf16 tensor (batch bi,
// head hi) into `rows` ([64][D + kPad]) and, when `cols` is given, its
// transpose ([D][64 + kPad]); rows at or past `n` are zero.
template <int D>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ x,
                                      __nv_bfloat16* rows,
                                      __nv_bfloat16* cols, int bi, int hi,
                                      int h, int n, int r0) {
  constexpr int kChunks = D / 8;
  const long long tok_stride = (long long)h * D;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int j = idx / kChunks;
    const int c8 = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + j < n)
      val = *reinterpret_cast<const uint4*>(
          x + ((long long)bi * n + r0 + j) * tok_stride + (long long)hi * D +
          c8);
    if (rows != nullptr)
      *reinterpret_cast<uint4*>(&rows[j * (D + kPad) + c8]) = val;
    if (cols != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) cols[(c8 + i) * (kTile + kPad) + j] = e[i];
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V, Q, dO row-major; Q^T, dO^T; lse, delta
  return (4 * kTile * (D + kPad) + 2 * D * (kTile + kPad)) * 2 +
         2 * kTile * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  // K, V row-major; K^T
  return (2 * kTile * (D + kPad) + D * (kTile + kPad)) * 2;
}

// Kernel 3, bf16: dK and dV of one 64-key tile.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int h, int sq, int skv,
                      long long bias_sb, long long bias_sh, long long bias_sq,
                      float sm_scale, int causal, pfx::Dropout drop) {
  constexpr int kK = D / 16;        // k16 steps over head_dim
  constexpr int kNb = kTile / 8;    // n8 blocks of queries per tile
  constexpr int kDb = D / 8;        // n8 blocks of the outputs
  constexpr int kLd = D + kPad;
  constexpr int kLdT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * kLd;
  __nv_bfloat16* qs = vs + kTile * kLd;
  __nv_bfloat16* dos = qs + kTile * kLd;
  __nv_bfloat16* qt = dos + kTile * kLd;
  __nv_bfloat16* dot = qt + D * kLdT;
  float* lse_s = reinterpret_cast<float*>(dot + D * kLdT);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kw = warp * 16;             // this warp's keys in the tile
  const int key_r[2] = {k0 + kw + g, k0 + kw + g + 8};
  const float* bias_bh =
      bias != nullptr ? bias + bi * bias_sb + hi * bias_sh : nullptr;

  stage<D>(k, ks, nullptr, bi, hi, h, skv, k0);
  stage<D>(v, vs, nullptr, bi, hi, h, skv, k0);

  float dk_acc[kDb][4], dv_acc[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // the first query tile with a row that sees a key of this tile
  const int q_first = causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_first; q0 < sq; q0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage<D>(q, qs, qt, bi, hi, h, sq, q0);
    stage<D>(dout, dos, dot, bi, hi, h, sq, q0);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < sq;
      lse_s[i] = ok ? lse[(long long)bh * sq + q0 + i] : 0.f;
      delta_s[i] = ok ? delta[(long long)bh * sq + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[kNb][4], dpt[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, kLd, kw, kk, g, t);
      load_a(va, vs, kLd, kw, kk, g, t);
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        const __nv_bfloat16* qr = &qs[(nb * 8 + g) * kLd + kk * 16 + t * 2];
        mma_bf16(st[nb], ka, ld_u32(qr), ld_u32(qr + 8));
        const __nv_bfloat16* dr = &dos[(nb * 8 + g) * kLd + kk * 16 + t * 2];
        mma_bf16(dpt[nb], va, ld_u32(dr), ld_u32(dr + 8));
      }
    }
    // element e of block nb: key key_r[e >> 1], query q0 + nb*8 + 2t +
    // (e & 1); st becomes P^T (dropped, for dV), dpt becomes dS^T
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_r[e >> 1];
        const int qc = nb * 8 + t * 2 + (e & 1);
        const int query = q0 + qc;
        const bool live = key < skv && query < sq && !(causal && key > query);
        float p = 0.f;
        if (live) {
          float sv = st[nb][e] * sm_scale;
          if (bias_bh != nullptr) sv += bias_bh[query * bias_sq + key];
          p = expf(sv - lse_s[qc]);
        }
        float dp = dpt[nb][e];
        float p_dv = p;
        if (kDrop) {
          const bool kp = drop.keep(bh, query, key);
          p_dv = kp ? p * drop.scale : 0.f;
          dp = kp ? dp * drop.scale : 0.f;
        }
        st[nb][e] = p_dv;
        dpt[nb][e] = p * (dp - delta_s[qc]);
      }
    // dV += P^T dO, dK += dS^T Q: k16 step kk is score blocks 2kk, 2kk+1
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(st[2 * kk][0], st[2 * kk][1]),
          pack_bf16(st[2 * kk][2], st[2 * kk][3]),
          pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {
          pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDb; ++j) {
        const __nv_bfloat16* dr = &dot[(j * 8 + g) * kLdT + kk * 16 + t * 2];
        mma_bf16(dv_acc[j], pa, ld_u32(dr), ld_u32(dr + 8));
        const __nv_bfloat16* qr = &qt[(j * 8 + g) * kLdT + kk * 16 + t * 2];
        mma_bf16(dk_acc[j], sa, ld_u32(qr), ld_u32(qr + 8));
      }
    }
  }

  const long long tok_stride = (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_r[i];
    if (key >= skv) continue;
    const long long off =
        ((long long)bi * skv + key) * tok_stride + (long long)hi * D;
#pragma unroll
    for (int j = 0; j < kDb; ++j) {
      *reinterpret_cast<uint32_t*>(&dk[off + j * 8 + t * 2]) =
          pack_bf16(dk_acc[j][2 * i] * sm_scale,
                    dk_acc[j][2 * i + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(&dv[off + j * 8 + t * 2]) =
          pack_bf16(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// Kernel 4, bf16: dQ of one 64-query tile.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ dq, int h, int sq, int skv,
                     long long bias_sb, long long bias_sh, long long bias_sq,
                     float sm_scale, int causal, pfx::Dropout drop) {
  constexpr int kK = D / 16;
  constexpr int kNb = kTile / 8;    // n8 blocks of keys per tile
  constexpr int kDb = D / 8;
  constexpr int kLd = D + kPad;
  constexpr int kLdT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * kLd;
  __nv_bfloat16* kt = vs + kTile * kLd;

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + warp * 16 + g;   // this thread's two rows
  const int r1 = r0 + 8;
  const long long tok_stride = (long long)h * D;

  // q and dO fragments: a0 (r0, c..c+1), a1 (r1, c..), a2 (r0, c+8..),
  // a3 (r1, c+8..)
  uint32_t qa[kK][4], da[kK][4];
  {
    const long long off0 =
        ((long long)bi * sq + r0) * tok_stride + (long long)hi * D;
    const long long off1 = off0 + 8 * tok_stride;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = r0 < sq ? ld_u32(q + off0 + c) : 0u;
      qa[kk][1] = r1 < sq ? ld_u32(q + off1 + c) : 0u;
      qa[kk][2] = r0 < sq ? ld_u32(q + off0 + c + 8) : 0u;
      qa[kk][3] = r1 < sq ? ld_u32(q + off1 + c + 8) : 0u;
      da[kk][0] = r0 < sq ? ld_u32(dout + off0 + c) : 0u;
      da[kk][1] = r1 < sq ? ld_u32(dout + off1 + c) : 0u;
      da[kk][2] = r0 < sq ? ld_u32(dout + off0 + c + 8) : 0u;
      da[kk][3] = r1 < sq ? ld_u32(dout + off1 + c + 8) : 0u;
    }
  }
  const int rows[2] = {r0, r1};
  float lse_r[2], delta_r[2];
  const float* b_r[2] = {nullptr, nullptr};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < sq;
    lse_r[i] = ok ? lse[(long long)bh * sq + rows[i]] : 0.f;
    delta_r[i] = ok ? delta[(long long)bh * sq + rows[i]] : 0.f;
    if (bias != nullptr)
      b_r[i] = bias + bi * bias_sb + hi * bias_sh +
               (long long)min(rows[i], sq - 1) * bias_sq;
  }

  float acc[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int warp_last_row = q0 + warp * 16 + 15;
  const int kv_end = causal ? min(skv, q0 + kTile) : skv;
  for (int n0 = 0; n0 < kv_end; n0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage<D>(k, ks, kt, bi, hi, h, skv, n0);
    stage<D>(v, vs, nullptr, bi, hi, h, skv, n0);
    __syncthreads();
    // every key of this tile lies past every row of this warp
    if (causal && n0 > warp_last_row) continue;

    float s[kNb][4], dp[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const __nv_bfloat16* kr = &ks[(nb * 8 + g) * kLd + kk * 16 + t * 2];
        mma_bf16(s[nb], qa[kk], ld_u32(kr), ld_u32(kr + 8));
        const __nv_bfloat16* vr = &vs[(nb * 8 + g) * kLd + kk * 16 + t * 2];
        mma_bf16(dp[nb], da[kk], ld_u32(vr), ld_u32(vr + 8));
      }
    }
    // element e: row rows[e >> 1], key n0 + nb*8 + 2t + (e & 1); s
    // becomes dS
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rows[i];
        const int col = n0 + nb * 8 + t * 2;
        bool kp[2] = {true, true};
        if (kDrop) drop.keep_pair(bh, row, col, kp);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * i + u;
          const int key = col + u;
          const bool live = key < skv && !(causal && key > row);
          float p = 0.f;
          if (live) {
            float sv = s[nb][e] * sm_scale;
            if (b_r[i] != nullptr) sv += b_r[i][key];
            p = expf(sv - lse_r[i]);
          }
          float d = dp[nb][e];
          if (kDrop) d = kp[u] ? d * drop.scale : 0.f;
          s[nb][e] = p * (d - delta_r[i]);
        }
      }
    // dQ += dS K: k16 step kk is score blocks 2kk, 2kk+1
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDb; ++j) {
        const __nv_bfloat16* kr = &kt[(j * 8 + g) * kLdT + kk * 16 + t * 2];
        mma_bf16(acc[j], sa, ld_u32(kr), ld_u32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sq) continue;
    __nv_bfloat16* op =
        dq + ((long long)bi * sq + rows[i]) * tok_stride + (long long)hi * D;
#pragma unroll
    for (int j = 0; j < kDb; ++j)
      *reinterpret_cast<uint32_t*>(&op[j * 8 + t * 2]) =
          pack_bf16(acc[j][2 * i] * sm_scale, acc[j][2 * i + 1] * sm_scale);
  }
}

// ---- fp32 on the CUDA cores ----------------------------------------

constexpr int kF32Rows = 64;                 // keys (3) / queries (4)
constexpr int kTpr = 4;                      // threads per row
constexpr int kF32Threads = kF32Rows * kTpr; // 256
constexpr int kStage = 32;                   // staged rows of the other side

// this thread's d values: g*16 + c*4 + e, e in [0, 4)
template <int D>
__device__ __forceinline__ void load_quarter(const float* p, int c,
                                             float* out) {
#pragma unroll
  for (int gi = 0; gi < D / 16; ++gi)
    pfx::load_vec(p + gi * 16 + c * 4, out + gi * 4);
}

template <int D>
__device__ __forceinline__ float dot_quarter(const float* a,
                                             const float* srow, int c) {
  float acc = 0.f;
#pragma unroll
  for (int gi = 0; gi < D / 16; ++gi) {
    const float4 x = *reinterpret_cast<const float4*>(srow + gi * 16 + c * 4);
    acc += a[gi * 4] * x.x + a[gi * 4 + 1] * x.y + a[gi * 4 + 2] * x.z +
           a[gi * 4 + 3] * x.w;
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy_quarter(float* acc, float a,
                                             const float* srow, int c) {
#pragma unroll
  for (int gi = 0; gi < D / 16; ++gi) {
    const float4 x = *reinterpret_cast<const float4*>(srow + gi * 16 + c * 4);
    acc[gi * 4] += a * x.x;
    acc[gi * 4 + 1] += a * x.y;
    acc[gi * 4 + 2] += a * x.z;
    acc[gi * 4 + 3] += a * x.w;
  }
}

// Stage rows r0 .. r0 + kStage - 1 of a [b, s, h, D] fp32 tensor into
// [kStage][D + 4]; rows at or past n are zero.
template <int D>
__device__ __forceinline__ void stage_f32(const float* __restrict__ x,
                                          float* rows, int bi, int hi, int h,
                                          int n, int r0) {
  const long long tok_stride = (long long)h * D;
  for (int idx = threadIdx.x; idx < kStage * D / 4; idx += kF32Threads) {
    const int j = idx / (D / 4);
    const int c4 = (idx % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + j < n)
      val = *reinterpret_cast<const float4*>(
          x + ((long long)bi * n + r0 + j) * tok_stride + (long long)hi * D +
          c4);
    *reinterpret_cast<float4*>(&rows[j * (D + 4) + c4]) = val;
  }
}

// Kernel 3, fp32: dK and dV of one 64-key tile, four threads per key.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias, float* __restrict__ dk,
                      float* __restrict__ dv, int h, int sq, int skv,
                      long long bias_sb, long long bias_sh, long long bias_sq,
                      float sm_scale, int causal, pfx::Dropout drop) {
  constexpr int kQ = D / 4;   // d values per thread
  __shared__ __align__(16) float qs[kStage][D + 4];
  __shared__ __align__(16) float dos[kStage][D + 4];
  __shared__ float lse_s[kStage], delta_s[kStage];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int k0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int c = tid % kTpr;
  const int key = k0 + tid / kTpr;
  const bool key_ok = key < skv;
  const long long tok_stride = (long long)h * D;

  float kr[kQ], vr[kQ], dk_acc[kQ], dv_acc[kQ];
  {
    const long long off = ((long long)bi * skv + (key_ok ? key : 0)) *
                              tok_stride + (long long)hi * D;
    load_quarter<D>(k + off, c, kr);
    load_quarter<D>(v + off, c, vr);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      if (!key_ok) kr[i] = vr[i] = 0.f;
      dk_acc[i] = dv_acc[i] = 0.f;
    }
  }
  const float* bias_bh =
      bias != nullptr ? bias + bi * bias_sb + hi * bias_sh : nullptr;

  const int q_first = causal ? (k0 / kStage) * kStage : 0;
  for (int q0 = q_first; q0 < sq; q0 += kStage) {
    __syncthreads();
    stage_f32<D>(q, &qs[0][0], bi, hi, h, sq, q0);
    stage_f32<D>(dout, &dos[0][0], bi, hi, h, sq, q0);
    for (int i = tid; i < kStage; i += kF32Threads) {
      const bool ok = q0 + i < sq;
      lse_s[i] = ok ? lse[(long long)bh * sq + q0 + i] : 0.f;
      delta_s[i] = ok ? delta[(long long)bh * sq + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int i4 = 0; i4 < kStage; i4 += kTpr) {
      // the four threads of a key draw the keep bits of four queries,
      // one each, and pass them round by shuffles
      bool my_keep = true;
      if (kDrop) my_keep = drop.keep(bh, q0 + i4 + c, key);
#pragma unroll
      for (int u = 0; u < kTpr; ++u) {
        const int i = i4 + u;
        const int query = q0 + i;
        const float s = dot_quarter<D>(kr, qs[i], c);
        float dp = dot_quarter<D>(vr, dos[i], c);
        const bool live =
            key_ok && query < sq && !(causal && key > query);
        float p = 0.f;
        if (live) {
          float sv = s * sm_scale;
          if (bias_bh != nullptr) sv += bias_bh[query * bias_sq + key];
          p = expf(sv - lse_s[i]);
        }
        float p_dv = p;
        if (kDrop) {
          const bool kp =
              __shfl_sync(0xffffffffu, my_keep ? 1 : 0, (lane & ~3) | u) != 0;
          p_dv = kp ? p * drop.scale : 0.f;
          dp = kp ? dp * drop.scale : 0.f;
        }
        const float ds = p * (dp - delta_s[i]);
        axpy_quarter<D>(dv_acc, p_dv, dos[i], c);
        axpy_quarter<D>(dk_acc, ds, qs[i], c);
      }
    }
  }

  if (key_ok) {
    const long long off =
        ((long long)bi * skv + key) * tok_stride + (long long)hi * D;
#pragma unroll
    for (int gi = 0; gi < D / 16; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[off + gi * 16 + c * 4 + e] = dk_acc[gi * 4 + e] * sm_scale;
        dv[off + gi * 16 + c * 4 + e] = dv_acc[gi * 4 + e];
      }
  }
}

// Kernel 4, fp32: dQ of one 64-query tile, four threads per query.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, float* __restrict__ dq,
                     int h, int sq, int skv, long long bias_sb,
                     long long bias_sh, long long bias_sq, float sm_scale,
                     int causal, pfx::Dropout drop) {
  constexpr int kQ = D / 4;
  __shared__ __align__(16) float ks[kStage][D + 4];
  __shared__ __align__(16) float vs[kStage][D + 4];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  const int c = tid % kTpr;
  const int row = q0 + tid / kTpr;
  const bool row_ok = row < sq;
  const long long tok_stride = (long long)h * D;

  float qr[kQ], dr[kQ], acc[kQ];
  {
    const long long off = ((long long)bi * sq + (row_ok ? row : 0)) *
                              tok_stride + (long long)hi * D;
    load_quarter<D>(q + off, c, qr);
    load_quarter<D>(dout + off, c, dr);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      if (!row_ok) qr[i] = dr[i] = 0.f;
      acc[i] = 0.f;
    }
  }
  const float lse_r = row_ok ? lse[(long long)bh * sq + row] : 0.f;
  const float delta_r = row_ok ? delta[(long long)bh * sq + row] : 0.f;
  const float* brow = nullptr;
  if (bias != nullptr)
    brow = bias + bi * bias_sb + hi * bias_sh +
           (long long)(row_ok ? row : 0) * bias_sq;

  const int kv_end = causal ? min(skv, q0 + kF32Rows) : skv;
  for (int n0 = 0; n0 < kv_end; n0 += kStage) {
    __syncthreads();
    stage_f32<D>(k, &ks[0][0], bi, hi, h, skv, n0);
    stage_f32<D>(v, &vs[0][0], bi, hi, h, skv, n0);
    __syncthreads();
    for (int j4 = 0; j4 < kStage; j4 += 4) {
      // keys n0 + j4 .. + 3 are one Philox group of this row
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (kDrop) w = drop.group(bh, row, n0 + j4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j4 + u;
        const int key = n0 + j;
        const float s = dot_quarter<D>(qr, ks[j], c);
        float dp = dot_quarter<D>(dr, vs[j], c);
        const bool live = row_ok && key < skv && !(causal && key > row);
        float p = 0.f;
        if (live) {
          float sv = s * sm_scale;
          if (brow != nullptr) sv += brow[key];
          p = expf(sv - lse_r);
        }
        if (kDrop) {
          const uint32_t bits = u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z
                                                                     : w.w;
          dp = drop.keep(bits) ? dp * drop.scale : 0.f;
        }
        axpy_quarter<D>(acc, p * (dp - delta_r), ks[j], c);
      }
    }
  }

  if (row_ok) {
    float* op = dq + ((long long)bi * sq + row) * tok_stride + (long long)hi * D;
#pragma unroll
    for (int gi = 0; gi < D / 16; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[gi * 16 + c * 4 + e] = acc[gi * 4 + e] * sm_scale;
  }
}

// ---- launchers -------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* bias;
  int b, h, sq, skv;
  long long sb, sh, sqs;
  float scale;
  int causal;
  pfx::Dropout drop;
};

template <int D, bool kDrop>
int dkv_bf16(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr int bytes = dkv_smem_bytes<D>();
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_mma<D, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.skv + kTile - 1) / kTile, a.b * a.h);
  flash_bwd_dkv_mma<D, kDrop><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, a.bias,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.h,
      a.sq, a.skv, a.sb, a.sh, a.sqs, a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDrop>
int dq_bf16(const Args& a, void* dq, cudaStream_t st) {
  constexpr int bytes = dq_smem_bytes<D>();
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_mma<D, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.sq + kTile - 1) / kTile, a.b * a.h);
  flash_bwd_dq_mma<D, kDrop><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, a.bias,
      static_cast<__nv_bfloat16*>(dq), a.h, a.sq, a.skv, a.sb, a.sh, a.sqs,
      a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDrop>
int dkv_f32(const Args& a, void* dk, void* dv, cudaStream_t st) {
  const dim3 grid((a.skv + kF32Rows - 1) / kF32Rows, a.b * a.h);
  flash_bwd_dkv_f32<D, kDrop><<<grid, kF32Threads, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.bias, static_cast<float*>(dk),
      static_cast<float*>(dv), a.h, a.sq, a.skv, a.sb, a.sh, a.sqs, a.scale,
      a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDrop>
int dq_f32(const Args& a, void* dq, cudaStream_t st) {
  const dim3 grid((a.sq + kF32Rows - 1) / kF32Rows, a.b * a.h);
  flash_bwd_dq_f32<D, kDrop><<<grid, kF32Threads, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.bias, static_cast<float*>(dq), a.h, a.sq, a.skv,
      a.sb, a.sh, a.sqs, a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

// One of the two kernels (which = 0: dK/dV into out0/out1; which = 1:
// dQ into out0) for head_dim d, type and dropout.
template <bool kDrop>
int dispatch(int which, const Args& a, int d, int is_bf16, void* out0,
             void* out1, cudaStream_t st) {
  if (is_bf16) {
    if (d == 64)
      return which == 0 ? dkv_bf16<64, kDrop>(a, out0, out1, st)
                        : dq_bf16<64, kDrop>(a, out0, st);
    if (d == 128)
      return which == 0 ? dkv_bf16<128, kDrop>(a, out0, out1, st)
                        : dq_bf16<128, kDrop>(a, out0, st);
  } else {
    if (d == 64)
      return which == 0 ? dkv_f32<64, kDrop>(a, out0, out1, st)
                        : dq_f32<64, kDrop>(a, out0, st);
    if (d == 128)
      return which == 0 ? dkv_f32<128, kDrop>(a, out0, out1, st)
                        : dq_f32<128, kDrop>(a, out0, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta,
        const float* bias, void* out0, void* out1, int b, int h, int sq,
        int skv, int d, long long bias_sb, long long bias_sh,
        long long bias_sq, float sm_scale, int causal, int is_bf16,
        int dropout, unsigned int keep_threshold, float keep_scale,
        unsigned long long seed, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,  k,  v,       dout,    lse,      delta,   bias,
         b,  h,  sq,      skv,     bias_sb,  bias_sh, bias_sq,
         sm_scale, causal,
         pfx::make_dropout(seed, keep_threshold, keep_scale)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch<true>(which, a, d, is_bf16, out0, out1, st)
                 : dispatch<false>(which, a, d, is_bf16, out0, out1, st);
}

}  // namespace

// Kernel 3: dK and dV. Returns a cudaError_t (0 on a successful
// launch); runs on `stream` without synchronising; the caller allocates
// dk and dv ([b, skv, h, d], q's dtype) and delta ([b, h, sq] fp32).
extern "C" int pfx_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias, void* dk,
    void* dv, int b, int h, int sq, int skv, int d, long long bias_sb,
    long long bias_sh, long long bias_sq, float sm_scale, int causal,
    int is_bf16, int dropout, unsigned int keep_threshold, float keep_scale,
    unsigned long long seed, void* stream) {
  return run(0, q, k, v, dout, lse, delta, bias, dk, dv, b, h, sq, skv, d,
             bias_sb, bias_sh, bias_sq, sm_scale, causal, is_bf16, dropout,
             keep_threshold, keep_scale, seed, stream);
}

// Kernel 4: dQ ([b, sq, h, d], q's dtype); otherwise as kernel 3.
extern "C" int pfx_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias, void* dq,
    int b, int h, int sq, int skv, int d, long long bias_sb,
    long long bias_sh, long long bias_sq, float sm_scale, int causal,
    int is_bf16, int dropout, unsigned int keep_threshold, float keep_scale,
    unsigned long long seed, void* stream) {
  return run(1, q, k, v, dout, lse, delta, bias, dq, nullptr, b, h, sq, skv,
             d, bias_sb, bias_sh, bias_sq, sm_scale, causal, is_bf16, dropout,
             keep_threshold, keep_scale, seed, stream);
}
