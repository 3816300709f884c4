// Decode attention against the KV cache for Hopper (sm_90a): the port's
// serving-tick kernels. Four instances of one family:
//
//   kernel 2, `flash_decode` (W = 1, contiguous cache) - replaces
//     paddlefleetx_tpu/ops/pallas/flash_attention.py `_decode_kernel`
//     (:1055; `flash_decode` with one shared cache index plus a per-key
//     additive bias, and `flash_decode_ragged` with per-row offsets);
//   kernel 5, `flash_decode_verify` (1 < W <= 32, contiguous) - replaces
//     `_verify_kernel` (:1140), the speculative window;
//   kernel 6a, `flash_decode_paged` (W = 1, page table) - replaces
//     `_paged_decode_kernel` (:1422, launched by `flash_decode_paged`);
//   kernel 6b, `flash_decode_paged_verify` (1 < W <= 32, page table) -
//     replaces `_paged_verify_kernel` (:1433);
//
// each also over an int8 cache (`kv_cache_dtype: int8`, the
// `quantized=True` branch of the same TPU kernels, :1088-1117 and
// :1536-1559): K and V int8 with one fp32 scale per (row, head,
// position). Query j of row i sits at cache position offset[i] + j and
// attends to positions 0..offset[i] + j (W = 1 is plain decode); the
// bias (kernel 2's shared-offset entry only) is added to the score.
//
// Layout: q and O are [b, W, h, d]; the contiguous cache is [b, h, S, d]
// (a key's d values contiguous); the paged pool is [P, h, page, d] and
// row i's logical key `key` lives at
//   pool + ((pt[i * max_pages + key / page] * h + head) * page
//           + key % page) * d,
// so a key row never straddles two pages. The int8 cache's scales are
// the cache minus its d axis: [b, h, S] contiguous, [P, h, page] paged.
// Bias is [b, S] fp32.
//
// What bounds them on this card: bytes. Each live key costs 2 d itemsize
// bytes (its K and V rows; 2 (d + 4) under int8), read once for all W
// queries, against 4 d W FLOPs: the least time is the live cache bytes
// over 3.35 TB/s at every W the kernels take (W = 32 in bf16 is 16
// FLOPs a byte, far under the tensor cores' 295).
//
// Two routes (`route`, chosen by ops/cuda/flash_attention.py plan_decode):
//
// mma (every bf16-query instance): the scores and P V on the tensor
// cores, the key length split over a thread-block cluster.
// - A cluster of `cluster` blocks (1..8, from the capacity S, d and the
//   cache type alone: the largest that leaves each block 8 chunks, 4
//   over an int8 cache, at most 4 blocks at d 128) takes one (row, head)
//   and 16 window queries (W > 16: two clusters). The capacity is cut into chunks of kChunk = 128 absolute
//   key positions; block r walks chunks r, r + cluster, ... in order,
//   and warp w of its 4 the 32-key tile w of each of its chunks. Tiles
//   wholly past the last live query are not loaded; a block with none
//   arrives at the cluster barrier and exits. (Timed on the H100 at the
//   serving ticks' shapes, PERF.md §6: larger clusters paid more to
//   launch than they saved, and 64-key tiles with 2 warps a block ran
//   slower than 32-key tiles with 4, which in the same shared memory
//   give an SM twice the warps and each warp half the serial work.)
// - A warp's tiles come through a ring of one or two stages (two when a
//   block walks several chunks) of cp.async copies into shared memory;
//   keys past the last live query are zero-filled, never read. Any page
//   size works: each key row is addressed through the page table (one
//   table load a tile when the page is a multiple of 32 keys).
// - S = Q K^T as mma.sync m16n8k16 (bf16 in, fp32 accumulate): the
//   window queries are the A rows, unused rows zero; the online softmax
//   runs row-wise in each quad, in base 2; P stays in registers as the A
//   operand of P V, whose V fragments come through ldmatrix.trans. An
//   int8 tile's K fragments are widened (exactly: |q8| <= 127) from the
//   int8 rows as loaded, head_dim taken in the same permuted order in q
//   and K so that a thread's fragments are one 16-byte read; its V tile
//   is widened to bf16 rows for ldmatrix.trans. The int8 scales fold
//   outside the products: score = (q . k8) ks[key] scale, the P V
//   operand is p vs[key] rounded to bf16, l sums the unscaled p - so
//   the int8 instances round otherwise than the simt body, within the
//   same tolerance of the plain version.
// - Each live warp's partial (m, l, acc) is pushed (mapa + st.async,
//   counted on the leader's mbarrier) into the leader block, which
//   merges them in (rank, warp) order and stores the rows.
// - Why not wgmma: its 64-row minimum would waste 59 of 64 rows at the
//   spec path's W = 5, and its transposed form (keys as M) needs P
//   through shared memory and a cross-warp softmax on every tile. At
//   W = 5 mma.sync does 16/5 of the needed products, which costs nothing
//   against the bytes.
//
// simt (the fp32 instances' only route, as TF32 misses fp32 parity; the
// bf16 and int8 comparison route): one 256-thread block per (row, head)
// walks that row's live keys on CUDA cores. A key row is read by
// d*itemsize/16 neighbouring lanes (an int8 row 8 bytes a lane, each
// element dequantized as one rounded product float(q8) * scale), and a
// group of such lanes is one online-softmax stream: key `key` goes to
// stream key % kStreams, in increasing order; the streams merge in a
// fixed order through shared memory. Queries go in groups of at most 8
// per pass over the keys.
//
// Exactness. Verify query j equals kernel 2 at offset + j bit for bit,
// and 6a / 6b equal 2 / 5 on the gathered cache - the property the TPU
// kernel states (:1152-1160) and speculative greedy decoding relies on -
// on each route:
// - The split, the chunk, the tile -> (block, warp) assignment and the
//   merge order depend only on the capacity, d and the dtypes, never on
//   W or the offsets; paged and contiguous instances split alike.
// - A key past query j's position scores true -INFINITY (the simt body
//   skips it), never pfx::kNegInf: a -1e30 score would add exp(0) = 1 to
//   l. A tile wholly masked for j is then an exact no-op for it: the
//   tile max is -inf, so alpha = exp(m - m) = 1, p = 0, P V adds exact
//   zeros (keys never loaded are zeros, not garbage); a warp or chunk
//   that saw no live key for j keeps exactly (kNegInf, 0, 0), with
//   alpha 1, never NaN, and adds exact zeros to the merge. The W = 1
//   launch walks a subset of the window's tiles and merges a subset of
//   its partials, and the others are such no-ops.
// - The softmax, the rescale and the merge use explicitly rounded
//   intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn, __fsub_rn): no
//   contraction left to the compiler, so instances do not differ by it.
// - An mma.sync output element depends on its own A row and the B
//   columns only, not on its row's position in the fragment nor on the
//   other rows (query j is row j of a window and row 0 of kernel 2):
//   checked on the card by chip_smoke.py's exact checks.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// widest verify window (the JAX package's MAX_VERIFY_WINDOW)
constexpr int kMaxWindow = 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;      // int8 cache: K scales ([b, h, S] / [P, h, page])
  const float* vs;      // and V scales; both null for a bf16 / fp32 cache
  const int* offsets;   // [b], or null: shared_offset for every row
  int shared_offset;
  const float* bias;    // [b, S] or null
  const int* pt;        // [b, max_pages] page table (paged instances)
  void* o;
  int h;
  int w;                // queries per row (the window)
  int S;                // logical capacity: S, or max_pages * page
  int page;
  int max_pages;
  float sm_scale;
};

// ---- route simt: CUDA cores, one block per (row, head) ---------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// T: the query and output type; C: the cache's (T, or int8_t)
template <typename T, typename C, int D, int G, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  using Raw = typename pfx::KvSlice<C>::Raw;
  constexpr int kVec = pfx::KvSlice<C>::N;   // elements per lane load
  constexpr int kLpk = D / kVec;             // lanes per key row
  static_assert(D % kVec == 0 && kLpk >= 1 && kLpk <= 32 &&
                    (32 % kLpk) == 0,
                "unsupported head_dim for this dtype");
  constexpr int kKpw = 32 / kLpk;            // key rows per warp load
  constexpr int kStreams = kWarps * kKpw;    // independent softmax states
  constexpr int kUnroll = G == 1 ? 4 : 2;    // keys per stream in flight

  __shared__ float sm_m[kStreams];
  __shared__ float sm_l[kStreams];
  __shared__ float sm_acc[kStreams][D];

  const int h = a.h;
  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / kLpk;   // key row within the warp's load
  const int gl = lane % kLpk;    // lane within the key row
  const int stream = warp * kKpw + grp;

  const int off = a.offsets != nullptr ? a.offsets[bi] : a.shared_offset;
  const T* q = static_cast<const T*>(a.q);
  const C* k = static_cast<const C*>(a.k);
  const C* v = static_cast<const C*>(a.v);
  T* o = static_cast<T*>(a.o);
  const long long row_head = (long long)bi * h + hi;
  // contiguous: this (row, head)'s cache rows (and scale rows); paged:
  // the row's table
  const long long row_off = kPaged ? 0 : row_head * (long long)a.S * D;
  const C* kb = k + row_off + gl * kVec;
  const C* vb = v + row_off + gl * kVec;
  const long long srow = kPaged ? 0 : row_head * (long long)a.S;
  const float* ksb = kInt8 ? a.ks + srow : nullptr;
  const float* vsb = kInt8 ? a.vs + srow : nullptr;
  const int* pt_row = kPaged ? a.pt + (long long)bi * a.max_pages : nullptr;
  const float* brow =
      a.bias != nullptr ? a.bias + (long long)bi * a.S : nullptr;
  const C* tag = nullptr;

  for (int g0 = 0; g0 < a.w; g0 += G) {
    const int nq = min(G, a.w - g0);   // queries of this pass
    int nk[G];                         // live keys of each query
    int nk_max = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      nk[j] = j < nq ? max(0, min(off + g0 + j + 1, a.S)) : 0;
      nk_max = max(nk_max, nk[j]);
    }
    float qv[G][kVec];
    float m[G], l[G], acc[G][kVec];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < nq) {
        pfx::load_vecs<kVec>(
            q + (((long long)bi * a.w + g0 + j) * h + hi) * D + gl * kVec,
            qv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qv[j][e] = 0.f;
      }
      m[j] = pfx::kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
    }
    int cur_lp = -1;            // logical page the pointers below are at
    const C* kp = nullptr;
    const C* vp = nullptr;
    const float* ksp = ksb;
    const float* vsp = vsb;

    // the loop bounds are uniform across the block, so every lane
    // reaches every shuffle; a key past a query's own position is
    // skipped lane-group by lane-group
    for (int base = 0; base < nk_max; base += kStreams * kUnroll) {
      Raw kr[kUnroll], vr[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];   // int8 only: the keys' scales
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = base + u * kStreams + stream;
        ksc[u] = vsc[u] = 0.f;
        if (key < nk_max) {
          int col;   // the key's position in its cache row or page
          if constexpr (kPaged) {
            const int lp = key / a.page;
            if (lp != cur_lp) {
              cur_lp = lp;
              const long long spg =
                  ((long long)pt_row[lp] * h + hi) * (long long)a.page;
              kp = k + spg * D + gl * kVec;
              vp = v + spg * D + gl * kVec;
              if constexpr (kInt8) {
                ksp = a.ks + spg;
                vsp = a.vs + spg;
              }
            }
            col = key - lp * a.page;
          } else {
            kp = kb;
            vp = vb;
            col = key;
          }
          kr[u] = pfx::load_raw<Raw>(kp + (long long)col * D);
          vr[u] = pfx::load_raw<Raw>(vp + (long long)col * D);
          if constexpr (kInt8) {
            ksc[u] = ksp[col];
            vsc[u] = vsp[col];
          }
        } else {
          kr[u] = Raw{};
          vr[u] = Raw{};
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = base + u * kStreams + stream;
        float kx[kVec], vx[kVec];
        if constexpr (kInt8) {
          pfx::widen_int8(kr[u], kx, ksc[u]);
          pfx::widen_int8(vr[u], vx, vsc[u]);
        } else {
          pfx::widen(kr[u], kx, tag);
          pfx::widen(vr[u], vx, tag);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < nq) {   // uniform across the block
            float part = __fmul_rn(qv[j][0], kx[0]);
#pragma unroll
            for (int e = 1; e < kVec; ++e)
              part = __fmaf_rn(qv[j][e], kx[e], part);
#pragma unroll
            for (int s = kLpk / 2; s > 0; s >>= 1)
              part = __fadd_rn(part,
                               __shfl_xor_sync(0xffffffffu, part, s, kLpk));
            if (key < nk[j]) {
              float sv = __fmul_rn(part, a.sm_scale);
              if (brow != nullptr) sv = __fadd_rn(sv, brow[key]);
              const float m_new = fmaxf(m[j], sv);
              const float alpha = expf(__fsub_rn(m[j], m_new));
              const float p = expf(__fsub_rn(sv, m_new));
              l[j] = __fmaf_rn(l[j], alpha, p);
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[j][e] = __fmaf_rn(p, vx[e], __fmul_rn(acc[j][e], alpha));
              m[j] = m_new;
            }
          }
        }
      }
    }

    // merge the streams of each query in a fixed order
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < nq) {   // uniform across the block
        if (gl == 0) {
          sm_m[stream] = m[j];
          sm_l[stream] = l[j];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) sm_acc[stream][gl * kVec + e] = acc[j][e];
        __syncthreads();
        for (int dd = threadIdx.x; dd < D; dd += kThreads) {
          float mx = pfx::kNegInf;
          for (int s = 0; s < kStreams; ++s) mx = fmaxf(mx, sm_m[s]);
          float lsum = 0.f, out = 0.f;
          for (int s = 0; s < kStreams; ++s) {
            const float wgt = expf(__fsub_rn(sm_m[s], mx));
            lsum = __fmaf_rn(sm_l[s], wgt, lsum);
            out = __fmaf_rn(sm_acc[s][dd], wgt, out);
          }
          pfx::store_f(&o[(((long long)bi * a.w + g0 + j) * h + hi) * D + dd],
                       __fdiv_rn(out, fmaxf(lsum, 1e-30f)));
        }
        __syncthreads();
      }
    }
  }
}

template <typename T, typename C, int D, int G, bool kPaged>
int launch(const Args& a, int b, cudaStream_t stream) {
  decode_kernel<T, C, D, G, kPaged><<<b * a.h, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the cache is int8 when scales are given, else of the query's type
template <typename T, int G, bool kPaged>
int dispatch_cache(const Args& a, int b, int d, cudaStream_t st) {
  if (a.ks != nullptr) {
    if (d == 64) return launch<T, int8_t, 64, G, kPaged>(a, b, st);
    if (d == 128) return launch<T, int8_t, 128, G, kPaged>(a, b, st);
  } else {
    if (d == 64) return launch<T, T, 64, G, kPaged>(a, b, st);
    if (d == 128) return launch<T, T, 128, G, kPaged>(a, b, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int G, bool kPaged>
int dispatch(const Args& a, int b, int d, int is_bf16, cudaStream_t st) {
  if ((a.ks == nullptr) != (a.vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return dispatch_cache<__nv_bfloat16, G, kPaged>(a, b, d, st);
  return dispatch_cache<float, G, kPaged>(a, b, d, st);
}

// a window of 2..32 queries: groups of 4 (W <= 4) or 8 per pass
template <bool kPaged>
int dispatch_window(const Args& a, int b, int d, int is_bf16,
                    cudaStream_t st) {
  if (a.w < 2 || a.w > kMaxWindow || a.offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.w <= 4) return dispatch<4, kPaged>(a, b, d, is_bf16, st);
  return dispatch<8, kPaged>(a, b, d, is_bf16, st);
}

// ---- route mma: tensor cores, the key length split over a cluster -----

constexpr int kRouteSimt = 0;
constexpr int kRouteMma = 1;
constexpr int kTile = 32;                    // keys of a warp's tile
constexpr int kChunk = 128;                  // keys of a block's chunk
constexpr int kMmaWarps = kChunk / kTile;    // one tile of a chunk each
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRows = 16;                    // window queries a cluster
constexpr int kMaxCluster = 8;               // the portable cluster limit
constexpr float kLog2e = 1.44269504088896341f;

// Shared memory of the mma route's instance over cache type C at head_dim
// D, from a 16-byte slot for the merge's mbarrier: each warp's region
// (`stages` stages, each K and V as loaded - int8, or bf16 in padded
// rows - and the per-key fp32 vectors the call reads: an int8 cache's K
// and V scales, the bias; an int8 instance adds the V tile widened to
// bf16), overlaid once the walk is done by the leader's slots: (m, l),
// the D output columns and the merge weight of each partial's live
// rows, and each row's sum.
template <typename C, int D>
struct MmaShape {
  static constexpr bool INT8 = std::is_same<C, int8_t>::value;
  static constexpr int ROW = D + 8;            // bf16 elements a tile row
  static constexpr int TILE = kTile * ROW * 2;
  static constexpr int RAW = kTile * D;
  static constexpr int VEC = kTile * 4;
  // per-key vectors of a stage: the int8 K and V scales, then the bias
  static constexpr int BIAS_VEC = INT8 ? 2 : 0;
  __host__ __device__ static constexpr int stage_bytes(bool bias) {
    return (INT8 ? 2 * RAW : 2 * TILE) + (BIAS_VEC + bias) * VEC;
  }
  __host__ __device__ static constexpr int warp_bytes(int stages,
                                                      bool bias) {
    return stages * stage_bytes(bias) + (INT8 ? TILE : 0);
  }
  // the leader's slots hold this many rows of each partial
  __host__ __device__ static constexpr int slot_rows(int w) {
    return w < kRows ? w : kRows;
  }
  __host__ __device__ static constexpr int slot_bytes(int cluster, int w) {
    return (cluster * kMmaWarps * slot_rows(w) * (3 + D) + kRows) * 4;
  }
  __host__ __device__ static constexpr int smem(int stages, int cluster,
                                                int w, bool bias) {
    const int tiles = kMmaWarps * warp_bytes(stages, bias);
    return 16 + (tiles > slot_bytes(cluster, w) ? tiles
                                                 : slot_bytes(cluster, w));
  }
};

// Queue the cp.async copies of the tile of keys key0 .. key0 + kTile - 1 into
// stage `st` and commit them as one group: K and V rows, and the per-key
// K / V scales (int8) and bias; keys from nk_max on are zero-filled.
template <typename C, int D, bool kPaged>
__device__ __forceinline__ void issue_tile(const Args& a, unsigned char* st,
                                           int key0, int nk_max,
                                           long long row_head,
                                           const int* pt_row, int bi, int hi,
                                           int lane) {
  using Sh = MmaShape<C, D>;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(C));
  constexpr int kCpr = kRowBytes / 16;   // 16-byte pieces of a key row
  const char* k = static_cast<const char*>(a.k);
  const char* v = static_cast<const char*>(a.v);
  // the cache (or pool) row of key0; the tile's rows follow it unless the
  // tile spans pages
  bool flat = true;
  long long row0;
  if constexpr (kPaged) {
    flat = a.page % kTile == 0;
    row0 = ((long long)pt_row[key0 / a.page] * a.h + hi) * a.page +
           key0 % a.page;
  } else {
    row0 = row_head * a.S + key0;
  }
  auto row_of = [&](int r) -> long long {
    if (!kPaged || flat) return row0 + r;
    const int key = key0 + r;
    return ((long long)pt_row[key / a.page] * a.h + hi) * a.page +
           key % a.page;
  };
  for (int idx = lane; idx < kTile * kCpr; idx += 32) {
    const int r = idx / kCpr, c = idx - r * kCpr;
    const bool live = key0 + r < nk_max;
    const long long row = live ? row_of(r) : row0;
    const int n = live ? 16 : 0;
    const int dst = Sh::INT8 ? r * D + c * 16 : r * Sh::ROW * 2 + c * 16;
    pfx::cp_async16(st + dst, k + row * kRowBytes + c * 16, n);
    pfx::cp_async16(st + (Sh::INT8 ? Sh::RAW : Sh::TILE) + dst,
                    v + row * kRowBytes + c * 16, n);
  }
  if (Sh::INT8 || a.bias != nullptr) {
    float* vec = reinterpret_cast<float*>(
        st + (Sh::INT8 ? 2 * Sh::RAW : 2 * Sh::TILE));
    for (int r = lane; r < kTile; r += 32) {
      const bool live = key0 + r < nk_max;
      const int n = live ? 4 : 0;
      if constexpr (Sh::INT8) {
        const long long row = live ? row_of(r) : row0;
        pfx::cp_async4(vec + r, a.ks + row, n);
        pfx::cp_async4(vec + kTile + r, a.vs + row, n);
      }
      if (a.bias != nullptr)
        pfx::cp_async4(vec + Sh::BIAS_VEC * kTile + r,
                       a.bias + (long long)bi * a.S + (live ? key0 + r : key0),
                       n);
    }
  }
  pfx::cp_async_commit();
}

// The int8 V tile of a stage widened (exactly) into the bf16 tile of
// padded rows at `conv`, for ldmatrix.trans (K is read as loaded).
template <int D>
__device__ __forceinline__ void widen_v(const unsigned char* st,
                                        unsigned char* conv, int lane) {
  using Sh = MmaShape<int8_t, D>;
  constexpr int kPieces = kTile * D / 16;   // 16-byte pieces of a tile
#pragma unroll 2
  for (int idx = lane; idx < kPieces; idx += 32) {
    const int r = idx / (D / 16), c = idx % (D / 16);
    const uint4 raw =
        *reinterpret_cast<const uint4*>(st + Sh::RAW + r * D + c * 16);
    uint32_t w[8];
    pfx::widen4(raw.x, w[0], w[1]);
    pfx::widen4(raw.y, w[2], w[3]);
    pfx::widen4(raw.z, w[4], w[5]);
    pfx::widen4(raw.w, w[6], w[7]);
    uint4* dst = reinterpret_cast<uint4*>(conv + r * Sh::ROW * 2 + c * 32);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Wait (cluster-scope acquire) for the first phase of the leader's merge
// barrier. A wait past any launch's length (2^31 cycles, about a second)
// traps, so that a lost push fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_partials(uint64_t* bar) {
  const long long t0 = clock64();
  while (!pfx::mbar_try_wait_cluster(bar, 0))
    if (clock64() - t0 > (1ll << 31)) __trap();
}

// One (row, head, 16 window queries) per cluster of `cluster` blocks;
// `stages`: the ring's depth (1 or 2).
template <typename C, int D, bool kPaged>
__global__ void __launch_bounds__(kMmaThreads)
    decode_kernel_mma(const Args a, const int cluster, const int stages) {
  using Sh = MmaShape<C, D>;
  constexpr int kK = D / 16;       // k16 steps of the scores over d
  constexpr int kNb = kTile / 8;   // n8 blocks of a tile's scores
  constexpr int kDb = D / 8;       // n8 blocks of the output
  constexpr int ROW = Sh::ROW;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* red = reinterpret_cast<uint64_t*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, thread
  const int stage_b = Sh::stage_bytes(a.bias != nullptr);
  unsigned char* wbase =
      smem + 16 + warp * Sh::warp_bytes(stages, a.bias != nullptr);
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int n_mt = (a.w + kRows - 1) / kRows;
  const int cid = blockIdx.x / cluster;
  const int bh = cid / n_mt;
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = (cid % n_mt) * kRows;
  const int wl = min(kRows, a.w - q0);   // live query rows
  const int off = a.offsets != nullptr ? a.offsets[bi] : a.shared_offset;
  // live keys of this thread's rows g and g + 8, and of the last query
  const int nk[2] = {g < wl ? max(0, min(off + q0 + g + 1, a.S)) : 0,
                     g + 8 < wl ? max(0, min(off + q0 + g + 9, a.S)) : 0};
  const int nk_max = max(0, min(off + q0 + wl, a.S));
  // partial p = (rank, warp) = rank * kMmaWarps + warp walks tiles p,
  // p + kMmaWarps * cluster, ...: it holds a live key iff p * kTile <
  // nk_max. The leader (rank 0) merges the live ones; a block with none
  // arrives at the cluster barrier and exits.
  const int live_parts =
      min(cluster * kMmaWarps, (nk_max + kTile - 1) / kTile);
  if (rank == 0 && threadIdx.x == 0) {
    pfx::mbar_init(red, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    pfx::mbar_expect_tx(red, live_parts * wl * (2 + D) * 4);
  }
  if (rank != 0 && static_cast<int>(rank) * kChunk >= nk_max) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    return;
  }

  // this warp's tiles: key0 = base + i * step while key0 < nk_max, tile
  // i in stage i % stages; the first stages - 1 are in flight while the
  // queries load (one commit group each, empty past the last tile)
  const int base = static_cast<int>(rank) * kChunk + warp * kTile;
  const int step = cluster * kChunk;
  const int n_live = nk_max > base ? (nk_max - base + step - 1) / step : 0;
  const long long row_head = (long long)bi * a.h + hi;
  const int* pt_row = kPaged ? a.pt + (long long)bi * a.max_pages : nullptr;
  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_live)
      issue_tile<C, D, kPaged>(a, wbase + i * stage_b, base + i * step,
                               nk_max, row_head, pt_row, bi, hi, lane);
    else
      pfx::cp_async_commit();
  }

  // the queries: a0 (row g, k c..c+1), a1 (g + 8, c..), a2 (g, c+8..),
  // a3 (g + 8, c+8..); rows past the window are zero. The int8
  // instances take head_dim in another order, the same in q and K: k
  // c = 16 kk + 2 t (and c + 8) of step kk is element D / 4 t + 4 kk
  // (+ 2), so that a thread's K fragments of every step are the D / 4
  // contiguous int8 values it reads at once
  const long long qstride = (long long)a.h * D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            (((long long)bi * a.w + q0) * a.h + hi) * D;
  uint32_t qa[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const int c = Sh::INT8 ? D / 4 * t + 4 * kk : kk * 16 + 2 * t;
    const int c8 = Sh::INT8 ? c + 2 : c + 8;
    qa[kk][0] = g < wl ? pfx::ld_u32(qb + g * qstride + c) : 0u;
    qa[kk][1] = g + 8 < wl ? pfx::ld_u32(qb + (g + 8) * qstride + c) : 0u;
    qa[kk][2] = g < wl ? pfx::ld_u32(qb + g * qstride + c8) : 0u;
    qa[kk][3] =
        g + 8 < wl ? pfx::ld_u32(qb + (g + 8) * qstride + c8) : 0u;
  }

  float acc[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {pfx::kNegInf, pfx::kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of each row's sum
  // the softmax in base 2: scores times sm_scale log2(e), exp2 (the
  // bias likewise); rows g + 8 hold no query when the window fits rows
  // 0..7, and then take no softmax work (a block-uniform branch)
  const float scale2 = __fmul_rn(a.sm_scale, kLog2e);
  const bool upper = wl > 8;
  for (int i = 0; i < n_live; ++i) {
    const int key0 = base + i * step;
    unsigned char* st = wbase + (i % stages) * stage_b;
    const int next = i + stages - 1;   // into the stage tile i - 1 left
    if (next < n_live)
      issue_tile<C, D, kPaged>(a, wbase + (next % stages) * stage_b,
                               base + next * step, nk_max, row_head, pt_row,
                               bi, hi, lane);
    else
      pfx::cp_async_commit();
    if (stages == 2)
      pfx::cp_async_wait<1>();
    else
      pfx::cp_async_wait<0>();
    __syncwarp();
    const float* vec = reinterpret_cast<const float*>(
        st + (Sh::INT8 ? 2 * Sh::RAW : 2 * Sh::TILE));
    const __nv_bfloat16* vt =
        reinterpret_cast<const __nv_bfloat16*>(st + Sh::TILE);
    if constexpr (Sh::INT8) {
      unsigned char* conv = wbase + stages * stage_b;
      widen_v<D>(st, conv, lane);
      __syncwarp();
      vt = reinterpret_cast<const __nv_bfloat16*>(conv);
    }

    // S = Q K^T; element e of block nb is row g + 8 (e >> 1), key
    // key0 + nb * 8 + 2 t + (e & 1). bf16: one ldmatrix gives the K
    // fragments of two k16 steps (lanes 8j .. 8j + 7 address matrix j:
    // columns + 8 j); int8: a thread widens its D / 4 values of key
    // nb * 8 + g, word kk giving steps kk's b0 and b1
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      if constexpr (Sh::INT8) {
        const uint4* kr = reinterpret_cast<const uint4*>(
            st + (nb * 8 + g) * D + D / 4 * t);
#pragma unroll
        for (int q4 = 0; q4 < kK / 4; ++q4) {
          const uint4 raw = kr[q4];
          const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t b0, b1;
            pfx::widen4(words[i], b0, b1);
            pfx::mma_bf16(s[nb], qa[4 * q4 + i], b0, b1);
          }
        }
      } else {
        const __nv_bfloat16* kr =
            reinterpret_cast<const __nv_bfloat16*>(st) +
            (nb * 8 + (lane & 7)) * ROW + (lane >> 3) * 8;
#pragma unroll
        for (int kk = 0; kk < kK; kk += 2) {
          uint32_t b[4];
          pfx::ldsm_x4(b, kr + kk * 16);
          pfx::mma_bf16(s[nb], qa[kk], b[0], b[1]);
          pfx::mma_bf16(s[nb], qa[kk + 1], b[2], b[3]);
        }
      }
    }
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nb * 8 + 2 * t + (e & 1);
        float sv = -INFINITY;   // masked: an exact no-op for the row
        if ((e < 2 || upper) && key0 + kl < nk[e >> 1]) {
          sv = Sh::INT8 ? __fmul_rn(__fmul_rn(s[nb][e], vec[kl]), scale2)
                        : __fmul_rn(s[nb][e], scale2);
          if (a.bias != nullptr)
            sv = __fadd_rn(sv,
                           __fmul_rn(vec[Sh::BIAS_VEC * kTile + kl], kLog2e));
        }
        s[nb][e] = sv;
        tm[e >> 1] = fmaxf(tm[e >> 1], sv);
      }
    float alpha[2] = {1.f, 1.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !upper) break;
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
      const float m_new = fmaxf(m[r], tm[r]);
      alpha[r] = exp2f(__fsub_rn(m[r], m_new));
      m[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = 0.f;
        if (e < 2 || upper) {
          p = exp2f(__fsub_rn(s[nb][e], m[e >> 1]));
          rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
        }
        s[nb][e] = Sh::INT8
                       ? __fmul_rn(p, vec[kTile + nb * 8 + 2 * t + (e & 1)])
                       : p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], rs[r]);
#pragma unroll
    for (int j = 0; j < kDb; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < 2 || upper) acc[j][e] = __fmul_rn(acc[j][e], alpha[e >> 1]);
    // O += P V: k16 step kk of P is score blocks 2 kk and 2 kk + 1; the V
    // fragments of output blocks 2 jp and 2 jp + 1 in one ldmatrix.trans
    // (lanes 8j .. 8j + 7 address matrix j: keys + 8 (j & 1), columns
    // + 8 (j >> 1))
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      const uint32_t pa[4] = {
          pfx::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pfx::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pfx::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pfx::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr =
          vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
          (lane >> 4) * 8;
#pragma unroll
      for (int jp = 0; jp < kDb / 2; ++jp) {
        uint32_t b[4];
        pfx::ldsm_x4_trans(b, vr + jp * 16);
        pfx::mma_bf16(acc[2 * jp], pa, b[0], b[1]);
        pfx::mma_bf16(acc[2 * jp + 1], pa, b[2], b[3]);
      }
    }
    __syncwarp();   // the stage is read before it is refilled
  }
  pfx::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }

  // every live block is done with its tiles, which the leader's slots
  // overlay, and the leader's barrier exists: push each live warp's
  // partial, (m, l) and the output columns of each live row, into the
  // leader's slots
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int rows = Sh::slot_rows(a.w);
  float* ml = reinterpret_cast<float*>(smem + 16);    // [part][rows][2]
  float* slot = ml + cluster * kMmaWarps * rows * 2;  // [part][rows][D]
  float* wgt = slot + cluster * kMmaWarps * rows * D; // [part][rows]
  float* lsum = wgt + cluster * kMmaWarps * rows;     // [rows]
  const int part = static_cast<int>(rank) * kMmaWarps + warp;
  if (part < live_parts) {
    const uint32_t red_a = pfx::mapa(pfx::smem_addr(red), 0);
    const uint32_t ml_a = pfx::mapa(pfx::smem_addr(ml), 0);
    const uint32_t slot_a = pfx::mapa(pfx::smem_addr(slot), 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= wl) continue;
      if (t == 0)
        pfx::st_async2(ml_a + 8 * (part * rows + row), m[r], l[r], red_a);
#pragma unroll
      for (int j = 0; j < kDb; ++j)
        pfx::st_async2(slot_a + 4 * ((part * rows + row) * D + j * 8 + 2 * t),
                       acc[j][2 * r], acc[j][2 * r + 1], red_a);
    }
  }
  if (rank != 0) return;
  wait_partials(red);

  // the leader: each row's weights and sum over the live partials, then
  // every output column, in partial order
  if (threadIdx.x < wl) {
    const int row = threadIdx.x;
    float mx = pfx::kNegInf;
    for (int p = 0; p < live_parts; ++p)
      mx = fmaxf(mx, ml[2 * (p * rows + row)]);
    float sum = 0.f;
    for (int p = 0; p < live_parts; ++p) {
      const float w = exp2f(__fsub_rn(ml[2 * (p * rows + row)], mx));
      wgt[p * rows + row] = w;
      sum = __fmaf_rn(ml[2 * (p * rows + row) + 1], w, sum);
    }
    lsum[row] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) +
                     (((long long)bi * a.w + q0) * a.h + hi) * D;
  for (int e = threadIdx.x; e < wl * D; e += kMmaThreads) {
    const int row = e / D, col = e - row * D;
    float out = 0.f;
    for (int p = 0; p < live_parts; ++p)
      out = __fmaf_rn(slot[(p * rows + row) * D + col], wgt[p * rows + row],
                      out);
    o[row * qstride + col] = __float2bfloat16(__fdiv_rn(out, lsum[row]));
  }
}

template <typename C, int D, bool kPaged>
int launch_mma(const Args& a, int b, int cluster, cudaStream_t st) {
  using Sh = MmaShape<C, D>;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      a.w < 1 || a.w > kMaxWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  // a ring of 2 stages where a block walks several chunks
  const int per_block = ((a.S + kChunk - 1) / kChunk + cluster - 1) / cluster;
  const int stages = per_block > 1 ? 2 : 1;
  const int smem = Sh::smem(stages, cluster, a.w, a.bias != nullptr);
  void (*kern)(const Args, int, int) = decode_kernel_mma<C, D, kPaged>;
  static int allowed[64] = {0};   // dynamic shared memory set, per device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (smem > 48 * 1024 && dev < 64 && allowed[dev] < smem) {
    rc = cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * a.h * ((a.w + kRows - 1) / kRows) * cluster);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kern, a, cluster, stages);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The instance of the route a call names: mma (bf16 queries; the cache
// int8 when scales are given, else bf16) or simt, whose window (G 0)
// goes in query groups of 4 or 8.
template <int G, bool kPaged>
int launch_route(const Args& a, int b, int d, int is_bf16, int route,
                 int cluster, cudaStream_t st) {
  if ((a.ks == nullptr) != (a.vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteMma) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    using BF = __nv_bfloat16;
    if (a.ks != nullptr) {
      if (d == 64) return launch_mma<int8_t, 64, kPaged>(a, b, cluster, st);
      if (d == 128) return launch_mma<int8_t, 128, kPaged>(a, b, cluster, st);
    } else {
      if (d == 64) return launch_mma<BF, 64, kPaged>(a, b, cluster, st);
      if (d == 128) return launch_mma<BF, 128, kPaged>(a, b, cluster, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (G == 1) return dispatch<1, kPaged>(a, b, d, is_bf16, st);
  return dispatch_window<kPaged>(a, b, d, is_bf16, st);
}

Args make_args(const void* q, const void* k, const void* v,
               const float* ks, const float* vs, const int* offsets,
               int shared_offset, const float* bias, const int* pt, void* o,
               int h, int w, int S, int page, int max_pages, float sm_scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = ks;
  a.vs = vs;
  a.offsets = offsets;
  a.shared_offset = shared_offset;
  a.bias = bias;
  a.pt = pt;
  a.o = o;
  a.h = h;
  a.w = w;
  a.S = S;
  a.page = page;
  a.max_pages = max_pages;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// Each entry point returns a cudaError_t: 0 on a successful launch. The
// kernels run on `stream` and do not synchronise; the caller allocates
// o ([b, W, h, d], q's shape). `ks` / `vs` are the int8 cache's fp32
// scales, or both null for a cache of q's type. `route` is 0 (simt) or
// 1 (mma, bf16 queries only, in clusters of `cluster` blocks: 1, 2, 4
// or 8); a route that cannot take the call is refused.

// Kernel 2: one query per row over the contiguous [b, h, S, d] cache.
// `offsets` is a [b] int32 device array, or null to use `shared_offset`
// (with the optional [b, S] bias) for every row.
extern "C" int pfx_flash_decode(const void* q, const void* k, const void* v,
                                const float* ks, const float* vs,
                                const int* offsets, int shared_offset,
                                const float* bias, void* o, int b, int h,
                                int S, int d, float sm_scale, int is_bf16,
                                int route, int cluster, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, shared_offset, bias,
                           nullptr, o, h, 1, S, 0, 0, sm_scale);
  return launch_route<1, false>(a, b, d, is_bf16, route, cluster,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 5: a window of w (2..32) queries per row at positions
// offsets[i] + j over the contiguous cache; no bias.
extern "C" int pfx_flash_decode_verify(const void* q, const void* k,
                                       const void* v, const float* ks,
                                       const float* vs, const int* offsets,
                                       void* o, int b, int w, int h, int S,
                                       int d, float sm_scale, int is_bf16,
                                       int route, int cluster,
                                       void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || w < 2 || w > kMaxWindow ||
      offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, 0, nullptr, nullptr, o,
                           h, w, S, 0, 0, sm_scale);
  return launch_route<0, false>(a, b, d, is_bf16, route, cluster,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 6a: one query per row through the [b, max_pages] int32 page
// table `pt` over the [P, h, page, d] pool; per-row offsets.
extern "C" int pfx_flash_decode_paged(const void* q, const void* k,
                                      const void* v, const float* ks,
                                      const float* vs, const int* offsets,
                                      const int* pt, void* o, int b, int h,
                                      int page, int max_pages, int d,
                                      float sm_scale, int is_bf16, int route,
                                      int cluster, void* stream) {
  if (b <= 0 || h <= 0 || page <= 0 || max_pages <= 0 || pt == nullptr ||
      offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, 0, nullptr, pt, o, h, 1,
                           page * max_pages, page, max_pages, sm_scale);
  return launch_route<1, true>(a, b, d, is_bf16, route, cluster,
                               static_cast<cudaStream_t>(stream));
}

// Kernel 6b: kernel 5's window through the page table.
extern "C" int pfx_flash_decode_paged_verify(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* offsets, const int* pt, void* o, int b,
    int w, int h, int page, int max_pages, int d, float sm_scale,
    int is_bf16, int route, int cluster, void* stream) {
  if (b <= 0 || h <= 0 || page <= 0 || max_pages <= 0 || pt == nullptr ||
      w < 2 || w > kMaxWindow || offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, 0, nullptr, pt, o, h, w,
                           page * max_pages, page, max_pages, sm_scale);
  return launch_route<0, true>(a, b, d, is_bf16, route, cluster,
                               static_cast<cudaStream_t>(stream));
}
