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
// What bounds it on this card: the recipe's call (b 8, h 16, s 1024,
// d 64, causal, bf16) does 5 b h d s^2 = 4.3e10 FLOPs of products (s and
// dP recomputed, dV, dK, dQ) against 134 MB read or written once (q, k,
// v, dO, O, lse, delta; dq, dk, dv): 320 FLOP/B, just above the H100's
// ~295 bf16 FLOP/B, so the pair's bound is the tensor cores' 0.0435 ms
// (989 TFLOP/s) with the bytes' 0.040 ms close behind (fp32 is bound by
// the CUDA cores, 67 TFLOP/s, TF32 off for fp32
// parity). Two kernels run 7 products instead of 5 (s and dP twice):
// the price of determinism. One kernel would have to sum dQ across the
// key tiles' blocks with atomics, whose order changes the bits from run
// to run; here every output is summed in an order fixed by the shape
// and written once, so a call is bit-identical from run to run.
//
// bf16 (flash_bwd_dkv_wgmma, flash_bwd_dq_wgmma), d 64 and 128, any sq
// and skv, causal or not, bias and dropout: wgmma fed by TMA.
// - A block is one warpgroup (128 threads) that owns 64 rows: 64 keys
//   in kernel 3, 64 queries in kernel 4. Three blocks share an SM (two
//   for kernel 3 at d 128), so while one waits on its products or loads
//   the others issue. Registers set that count: ptxas allows 168 a
//   thread at 12 warps an SM, and a warpgroup needs 128-168 at d 64. A
//   block of two consumer warpgroups and a producer warp would be held
//   to 168 as well (3 of its warps on one SM sub-partition; setmaxnreg
//   does not raise what ptxas allocates) and fill the SM alone, so its
//   loads and stores would run with nothing beside them. Overlapping a
//   warpgroup's accumulating products with its next tile needs more
//   than 168 registers, hence two blocks an SM; on the H100 that ran
//   slower than three blocks without it (PERF.md, section 6).
// - The block's own rows of two operands (K and V, or Q and dO) arrive
//   once by TMA; a ring of 64-row tiles of the other side's two operands
//   (3 stages at d 64, 2 at d 128) walks from the first causally live
//   tile, each stage with a `full` mbarrier that counts the TMA bytes.
//   Warp 0 refills a stage once the products that read it are done
//   (kernel 3's warp 0 also stores the tile's lse, delta and -lse
//   log2(e) there, fetched into registers a tile ahead). Tensor maps are
//   4-D over [b, s, h, d] ({d, h, s, b}, 64 x 64 boxes, 128-byte
//   swizzle), so TMA zero-fills rows past sq / skv, and the edge masks
//   set their scores to zero.
// - Kernel 3, per query tile: S^T = K Q^T and dP^T = V dO^T (wgmma
//   m64n64k16, both operands K-major from shared memory, one commit
//   group each); P^T = exp(S^T scale + bias - lse) and dS^T = P^T (dP^T
//   keep / (1 - rate) - delta) in registers (tiles wholly inside the
//   causal triangle and the edges, without a bias, skip the masks: one
//   FFMA and one ex2 a score); then dV += P^T dO and dK += dS^T Q
//   (m64nDk16 with A, the bf16 P^T / dS^T, from the accumulator
//   registers, and B, dO / Q, read MN-major through the descriptor's
//   transpose bit: no transposed copy is staged). dK is scaled once at
//   the end.
// - Kernel 4, per key tile: S = Q K^T, dP = dO V^T, dS, then dQ += dS K
//   (K MN-major); dQ is scaled once at the end.
// - Outputs leave as bf16 through the block's own boxes (no longer
//   read) and TMA stores; rows past skv / sq are not written.
// - Dropout: one Philox4x32-10 call per four scores. The call's four
//   words are the keep bits of four neighbouring keys of one query
//   (philox.cuh `group()`, unchanged), computed while S and dP run. In
//   kernel 3 those keys are the rows of the lanes 4 apart; each of them
//   draws 8 of the 32 (key quad, query) groups it shares with the other
//   three, packs their keep bits as nibbles of one word, and the four
//   words are exchanged with __shfl_sync. In kernel 4 the lanes t and
//   t ^ 1 share each quad; each draws 8 groups and one shuffle swaps the
//   words. The bits are those of kernel 1 and the plain version, on the
//   same absolute coordinates.
// - Grid (b h, 64-row tiles), the tiles of the longest causal walks
//   launched first.
// What bounds them as built, at the recipe's shape: without dropout the
// pair runs the 7 products at ~40 % of the tensor cores' rate, held back
// by each score's exp, masks and packing on 64 x 64 tiles and the wait
// for each product; with dropout, Philox's integer multiplies (4 a round,
// 40 a call, 2 calls for every 4 scores across the two kernels) take
// about as long again.
// ptxas (CUDA 12.8, -Xptxas -v), registers a thread, no spills:
// flash_bwd_dkv_wgmma d 64 162 (dropout 168), d 128 230 (248);
// flash_bwd_dq_wgmma d 64 128 (158), d 128 165 (168).
// fp32 (flash_bwd_dkv_f32 / flash_bwd_dq_f32, the parity route): 256
// threads, four per key (kernel 3) or per query (kernel 4), each holding
// a quarter of the row's d values and its accumulators; dot products are
// reduced over the four threads by shuffles. The other side's rows are
// staged 32 at a time in shared memory.

#include "flash_wgmma.cuh"

namespace {

// ---- bf16 on wgmma -------------------------------------------------------

using pfx::bulk_commit;
using pfx::bulk_wait;
using pfx::fence_acc;
using pfx::fence_async_smem;
using pfx::mbar_arrive;
using pfx::mbar_expect_tx;
using pfx::mbar_init;
using pfx::tma_load_4d;
using pfx::tma_store_4d;
using pfx::wgmma_commit;
using pfx::wgmma_fence;
using pfx::wgmma_wait;
using namespace pfx::attn;

// The shape of kernel 3 (kDkv) or kernel 4 at head_dim D. BLOCKS share
// an SM: 3 (ptxas then allows 168 registers a thread), but 2 for kernel
// 3 at d 128, whose 128 fp32 accumulators of dK and dV besides the
// scores take 230-248. Shared memory, from a 1024-byte aligned base: the
// block's own 64 rows of two operands (K and V, or Q and dO), a 64-row
// tile of one operand being D / 64 boxes; a ring of STAGES tiles of the
// other side's two operands; kernel 3's lse, delta and -lse log2(e) of
// each ring tile's queries; the barriers (own, full).
template <int D, bool kDkv>
struct Shape {
  static constexpr int BLOCKS = kDkv && D == 128 ? 2 : 3;
  static constexpr int OPERAND = (D / 64) * kBox;   // one operand, 64 rows
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int OWN = 2 * OPERAND;
  static constexpr int RING = STAGES * 2 * OPERAND;
  static constexpr int VECS = kDkv ? STAGES * 3 * kTile * 4 : 0;
  static constexpr int BYTES = 1024 + OWN + RING + VECS + (1 + STAGES) * 8;
};

// Kernel 3, bf16: dK and dV of the 64 keys k0 .. k0 + 63.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, Shape<D, true>::BLOCKS)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dk,
                        const __grid_constant__ CUtensorMap map_dv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias, int h, int sq,
                        int skv, long long bias_sb, long long bias_sh,
                        long long bias_sq, float sm_scale, int causal,
                        pfx::Dropout drop) {
  using S = Shape<D, true>;
  constexpr int kStages = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks =
      smem_raw + ((1024 - (pfx::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + S::OPERAND;
  unsigned char* ring = ks + S::OWN;
  float* vecs = reinterpret_cast<float*>(ring + S::RING);
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(vecs) + S::VECS);
  uint64_t* full = own_bar + 1;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int k0 = blockIdx.y * kTile;     // causal: the longest walks first
  const int q_first = causal ? k0 : 0;   // the first query tile that sees k0
  const int n_tiles = k0 < skv && q_first < sq
                          ? (sq - q_first + kTile - 1) / kTile : 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float* lse_bh = lse + (long long)bh * sq;
  const float* delta_bh = delta + (long long)bh * sq;

  if (tid == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 32);   // warp 0
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 feeds the ring: fetch() reads a query tile's lse and delta
  // into registers ahead of time, load() stores them (and -lse log2(e))
  // into the tile's stage, every lane arriving on its `full` barrier,
  // lane 0 with the TMA loads of its Q and dO
  float pre_l[2], pre_d[2];
  auto fetch = [&](int it) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_first + it * kTile + lane + 32 * r;
      pre_l[r] = row < sq ? lse_bh[row] : 0.f;
      pre_d[r] = row < sq ? delta_bh[row] : 0.f;
    }
  };
  auto load = [&](int it) {
    const int stage = it % kStages;
    float* v = vecs + stage * 3 * kTile;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v[lane + 32 * r] = pre_l[r];
      v[kTile + lane + 32 * r] = pre_d[r];
      v[2 * kTile + lane + 32 * r] = -pre_l[r] * kLog2e;
    }
    if (lane == 0) {
      const int q0 = q_first + it * kTile;
      unsigned char* tile = ring + stage * 2 * S::OPERAND;
      mbar_expect_tx(&full[stage], 2 * S::OPERAND);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(tile + c * kBox, &map_q, &full[stage], 64 * c, hi, q0,
                    bi);
        tma_load_4d(tile + S::OPERAND + c * kBox, &map_do, &full[stage],
                    64 * c, hi, q0, bi);
      }
    } else {
      mbar_arrive(&full[stage]);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_expect_tx(own_bar, S::OWN);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(ks + c * kBox, &map_k, own_bar, 64 * c, hi, k0, bi);
        tma_load_4d(vs + c * kBox, &map_v, own_bar, 64 * c, hi, k0, bi);
      }
    }
    for (int it = 0; it < kStages && it < n_tiles; ++it) {
      fetch(it);
      load(it);
    }
  }

  // accumulator element 4 j + 2 hh + u: key key_r[hh], query column
  // 8 j + 2 t + u of the tile
  const int key_r[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float* bias_bh =
      bias != nullptr ? bias + bi * bias_sb + hi * bias_sh : nullptr;
  const float scale_log2 = sm_scale * kLog2e;
  // dropout: this lane draws the 8 Philox groups (4 keys of one query)
  // of pairs 8 i4 .. 8 i4 + 7 of the 32 (key quad, query) pairs that it
  // shares with the lanes 4 apart (the same t and g / 4)
  const int i4 = g & 3;
  const int quad_key = k0 + 16 * warp + 4 * (g >> 2) + 8 * (i4 >> 1);

  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

  bar_wait(own_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const int q0 = q_first + it * kTile;
    // the tile that goes into this stage once this one is done
    const int next = it + kStages;
    const bool refill = warp == 0 && next < n_tiles;
    if (refill) fetch(next);
    bar_wait(&full[stage], (it / kStages) & 1);
    const unsigned char* qs = ring + stage * 2 * S::OPERAND;
    const unsigned char* dos = qs + S::OPERAND;
    const float* lse_s = vecs + stage * 3 * kTile;
    const float* delta_s = lse_s + kTile;
    const float* nl_s = lse_s + 2 * kTile;   // -lse log2(e)

    // S^T = K Q^T, dP^T = V dO^T (rows keys, columns queries); the first
    // k16 step overwrites the accumulators
    float st[32], dpt[32];
    wgmma_fence();
    product_rows<D>(st, ks, qs);
    wgmma_commit();
    product_rows<D>(dpt, vs, dos);
    wgmma_commit();
    // while they run: the keep bits (column c = 2 j + u of this lane is
    // query q0 + 8 j + 2 t + u)
    uint32_t m[4] = {0u, 0u, 0u, 0u};
    if constexpr (kDrop) {
      uint32_t mine = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = 4 * (i4 & 1) + (n >> 1);
        mine |= keep_nibble(drop, bh, q0 + 8 * j + 2 * t + (n & 1),
                            quad_key) << (4 * n);
      }
#pragma unroll
      for (int o = 0; o < 4; ++o)
        m[o] = __shfl_sync(kFullMask, mine, (lane & ~12) | (o << 2)) >> i4;
    }
    // a tile wholly inside the causal triangle and the edges, without a
    // bias, needs no mask
    const bool inner = bias_bh == nullptr && (!causal || q0 > k0) &&
                       q0 + kTile <= sq && k0 + kTile <= skv;
    wgmma_wait<1>();   // S^T is done
    fence_acc<32>(st);
    if (inner) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        st[e] = ex2(fmaf(st[e], scale_log2,
                         nl_s[8 * (e >> 2) + 2 * t + (e & 1)]));
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = key_r[(e >> 1) & 1];
        const int qc = 8 * (e >> 2) + 2 * t + (e & 1);
        const int query = q0 + qc;
        float sv = st[e] * sm_scale;
        if (bias_bh != nullptr && key < skv && query < sq)
          sv += bias_bh[query * bias_sq + key];
        const bool live = key < skv && query < sq && !(causal && key > query);
        st[e] = live ? ex2((sv - lse_s[qc]) * kLog2e) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_acc<32>(dpt);
    // st becomes P^T (dropped, for dV), dpt becomes dS^T; element e =
    // 4 j + 2 hh + u is (query column c = 2 j + u, key quad pair
    // 16 hh + c)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 2 * (e >> 2) + (e & 1);
      const float p = st[e];
      float dp = dpt[e];
      float p_dv = p;
      if constexpr (kDrop) {
        const int pair = 16 * ((e >> 1) & 1) + c;
        const bool kp = (m[pair >> 3] >> (4 * (pair & 7))) & 1u;
        p_dv = kp ? p * drop.scale : 0.f;
        dp = kp ? dp * drop.scale : 0.f;
      }
      st[e] = p_dv;
      dpt[e] = p * (dp - delta_s[8 * (e >> 2) + 2 * t + (e & 1)]);
    }
    // dV += P^T dO, dK += dS^T Q (dO, Q read MN-major); then the stage is
    // free
    uint32_t pa[4][4], sa[4][4];
    acc_to_a(st, pa);
    acc_to_a(dpt, sa);
    wgmma_fence();
    product_acc<D>(dv, pa, dos);
    product_acc<D>(dk, sa, qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<D / 2>(dv);
    fence_acc<D / 2>(dk);
    fence_u32(pa);
    fence_u32(sa);
    if (refill) load(next);
  }

  // every product is done: the K and V boxes take dK and dV
  if (k0 < skv) {
    const float dk_scale[2] = {sm_scale, sm_scale}, dv_scale[2] = {1.f, 1.f};
    store_rows<D>(dk, dk_scale, ks, tid);
    store_rows<D>(dv, dv_scale, vs, tid);
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < D / 64; ++c) {
        tma_store_4d(&map_dk, ks + c * kBox, 64 * c, hi, k0, bi);
        tma_store_4d(&map_dv, vs + c * kBox, 64 * c, hi, k0, bi);
      }
      bulk_commit();
      bulk_wait();
    }
  }
}

// Kernel 4, bf16: dQ of the 64 queries q0 .. q0 + 63.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, Shape<D, false>::BLOCKS)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_dq,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias, int h, int sq,
                       int skv, long long bias_sb, long long bias_sh,
                       long long bias_sq, float sm_scale, int causal,
                       pfx::Dropout drop) {
  using S = Shape<D, false>;
  constexpr int kStages = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (pfx::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + S::OPERAND;
  unsigned char* ring = qs + S::OWN;
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* full = own_bar + 1;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  // causal: the longest walks (the last query tiles) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int kv_end = causal ? min(skv, q0 + kTile) : skv;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (tid == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 feeds the ring: the K and V of key tile it into its stage
  auto load = [&](int it) {
    const int stage = it % kStages;
    unsigned char* tile = ring + stage * 2 * S::OPERAND;
    mbar_expect_tx(&full[stage], 2 * S::OPERAND);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(tile + c * kBox, &map_k, &full[stage], 64 * c, hi,
                  it * kTile, bi);
      tma_load_4d(tile + S::OPERAND + c * kBox, &map_v, &full[stage],
                  64 * c, hi, it * kTile, bi);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(own_bar, S::OWN);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(qs + c * kBox, &map_q, own_bar, 64 * c, hi, q0, bi);
      tma_load_4d(dos + c * kBox, &map_do, own_bar, 64 * c, hi, q0, bi);
    }
    for (int it = 0; it < kStages && it < n_tiles; ++it) load(it);
  }

  // accumulator element 4 j + 2 hh + u: query row_r[hh], key column
  // 8 j + 2 t + u of the tile
  const int row_r[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse_r[2], delta_r[2];
  const float* b_r[2] = {nullptr, nullptr};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool ok = row_r[hh] < sq;
    lse_r[hh] = ok ? lse[(long long)bh * sq + row_r[hh]] : 0.f;
    delta_r[hh] = ok ? delta[(long long)bh * sq + row_r[hh]] : 0.f;
    if (bias != nullptr)
      b_r[hh] = bias + bi * bias_sb + hi * bias_sh +
                (long long)min(row_r[hh], sq - 1) * bias_sq;
  }
  const float scale_log2 = sm_scale * kLog2e;
  const float nl_r[2] = {-lse_r[0] * kLog2e, -lse_r[1] * kLog2e};

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  bar_wait(own_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const int n0 = it * kTile;
    // the tile that goes into this stage once this one is done
    const int next = it + kStages;
    const bool refill = tid == 0 && next < n_tiles;
    bar_wait(&full[stage], (it / kStages) & 1);
    const unsigned char* ks = ring + stage * 2 * S::OPERAND;
    const unsigned char* vs = ks + S::OPERAND;

    // S = Q K^T, dP = dO V^T; the first k16 step overwrites them
    float s[32], dp[32];
    wgmma_fence();
    product_rows<D>(s, qs, ks);
    wgmma_commit();
    product_rows<D>(dp, dos, vs);
    wgmma_commit();
    // while they run: the keep bits
    uint32_t even = 0, odd = 0;
    if constexpr (kDrop) keep_words(drop, bh, row_r, n0, t, &even, &odd);
    // a tile wholly inside the causal triangle and the edges, without a
    // bias, needs no mask
    const bool inner = bias == nullptr && (!causal || n0 < q0) &&
                       n0 + kTile <= skv && q0 + kTile <= sq;
    wgmma_wait<1>();   // S is done
    fence_acc<32>(s);
    if (inner) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = ex2(fmaf(s[e], scale_log2, nl_r[(e >> 1) & 1]));
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1;
        const int row = row_r[hh];
        const int key = n0 + 8 * (e >> 2) + 2 * t + (e & 1);
        float sv = s[e] * sm_scale;
        if (b_r[hh] != nullptr && key < skv) sv += b_r[hh][key];
        const bool live = key < skv && row < sq && !(causal && key > row);
        s[e] = live ? ex2((sv - lse_r[hh]) * kLog2e) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_acc<32>(dp);
    // s becomes dS
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float d = dp[e];
      if constexpr (kDrop)
        d = keep_bit(even, odd, e) ? d * drop.scale : 0.f;
      s[e] = s[e] * (d - delta_r[(e >> 1) & 1]);
    }
    // dQ += dS K (K read MN-major); then the stage is free
    uint32_t sa[4][4];
    acc_to_a(s, sa);
    wgmma_fence();
    product_acc<D>(dq, sa, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<D / 2>(dq);
    fence_u32(sa);
    if (refill) load(next);
  }

  // every product is done: the Q boxes take dQ
  if (q0 < sq) {
    const float dq_scale[2] = {sm_scale, sm_scale};
    store_rows<D>(dq, dq_scale, qs, tid);
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(&map_dq, qs + c * kBox, 64 * c, hi, q0, bi);
      bulk_commit();
      bulk_wait();
    }
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
  using S = Shape<D, true>;
  constexpr int bytes = S::BYTES;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!map_bshd(&mq, a.q, a.b, a.sq, a.h, D) ||
      !map_bshd(&mk, a.k, a.b, a.skv, a.h, D) ||
      !map_bshd(&mv, a.v, a.b, a.skv, a.h, D) ||
      !map_bshd(&mdo, a.dout, a.b, a.sq, a.h, D) ||
      !map_bshd(&mdk, dk, a.b, a.skv, a.h, D) ||
      !map_bshd(&mdv, dv, a.b, a.skv, a.h, D))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.b * a.h, (a.skv + kTile - 1) / kTile);
  flash_bwd_dkv_wgmma<D, kDrop><<<grid, kThreads, bytes, st>>>(
      mq, mk, mv, mdo, mdk, mdv, a.lse, a.delta, a.bias, a.h, a.sq, a.skv,
      a.sb, a.sh, a.sqs, a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDrop>
int dq_bf16(const Args& a, void* dq, cudaStream_t st) {
  using S = Shape<D, false>;
  constexpr int bytes = S::BYTES;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!map_bshd(&mq, a.q, a.b, a.sq, a.h, D) ||
      !map_bshd(&mk, a.k, a.b, a.skv, a.h, D) ||
      !map_bshd(&mv, a.v, a.b, a.skv, a.h, D) ||
      !map_bshd(&mdo, a.dout, a.b, a.sq, a.h, D) ||
      !map_bshd(&mdq, dq, a.b, a.sq, a.h, D))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.b * a.h, (a.sq + kTile - 1) / kTile);
  flash_bwd_dq_wgmma<D, kDrop><<<grid, kThreads, bytes, st>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.delta, a.bias, a.h, a.sq, a.skv, a.sb,
      a.sh, a.sqs, a.scale, a.causal, a.drop);
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
