// Decode attention against the KV cache for Hopper (sm_90a): the port's
// serving-tick kernels. One templated body, four instances:
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
//     replaces `_paged_verify_kernel` (:1433).
//
// Query j of row i sits at cache position offset[i] + j and attends to
// positions 0..offset[i] + j (the within-window causal mask; W = 1 is
// plain decode). The bias (kernel 2's shared-offset entry only) is
// added to the score, as on the TPU.
//
// Each instance also reads an int8 cache (`kv_cache_dtype: int8`, the
// `quantized=True` branch of the same TPU kernels, :1088-1117 and
// :1536-1559): K and V are int8 with one fp32 scale per (row, head,
// position), and every element is dequantized as it is widened, with
// one explicitly rounded product float(q8) * scale - the TPU kernel's
// `k.astype(f32) * scale`. The cache type is a template parameter apart
// from the query / output type: an int8 key row is loaded 8 bytes (8
// elements) a lane, so it is read by as many lanes as a bf16 row and the
// key -> stream -> lane mapping, and with it the bit-exactness below,
// is the bf16 instance's. The lane group loads each key's K and V scale
// once. Folding the scale out of the dot product would save multiplies
// but change the rounding.
//
// Layout: q and O are [b, W, h, d]; the contiguous cache is [b, h, S, d]
// (a key's d values contiguous, the port's layout); the paged pool is
// [P, h, page, d] and row i's logical key `key` lives at
//   pool + ((pt[i * max_pages + key / page] * h + head) * page
//           + key % page) * d,
// so a key row never straddles two pages and its vector loads stay in
// one page. The int8 cache's scales are the cache minus its d axis:
// [b, h, S] contiguous, [P, h, page] paged. Bias is [b, S] fp32.
//
// What bounds them on this card: memory. Each live key costs 2 d
// itemsize bytes (its K and V rows; 2 (d + 4) under int8), read once
// for all W queries,
// against 4 d W FLOPs: W bf16 FLOPs per byte, so the least time is the
// live cache bytes over 3.35 TB/s until W is large. Compute takes over
// only near W = 32, where fp32 on CUDA cores reaches about 20 FLOP/B,
// the H100's fp32 balance point (67 TFLOP/s over 3.35 TB/s).
//
// What the design does about it: one 256-thread block per (row, head)
// walks only that row's live keys (the longest window query's), so a
// short slot never pays for a long one. A key row is read by
// d*itemsize/16 neighbouring lanes, 16 bytes each, and a group of such
// lanes is one online-softmax "stream": key `key` always goes to
// stream key % kStreams, and a stream takes its keys in increasing
// order; at the end the streams merge in a fixed order through shared
// memory. In a window every stream keeps one state per query (m, l and
// its slice of the accumulator, fp32 registers), each loaded key is
// scored against every query of the pass, and a key past query j's own
// position is SKIPPED for that query, never masked: a stream that has
// seen no live key has m = -1e30, where a masked score would add
// exp(0) = 1 to its sum. So query j of a verify launch goes through
// exactly the operations of a W = 1 launch at offset + j - the same
// keys in the same streams in the same order, every product and sum an
// explicitly rounded intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn, no
// contraction left to the compiler) - and equals it bit for bit, the
// property the TPU kernel states (:1152-1160) and speculative greedy
// decoding relies on. The paged read walks the same keys through the
// table (one table load per page per lane group), so it equals kernel
// 2 on the gathered cache bit for bit. W * kVec accumulators per lane
// would not fit in registers at W = 32: queries go in groups of at most
// 8 per pass over the keys (4 passes at W = 32, 1 at the spec path's
// W = 5; the later passes read the keys again, mostly from L2). Left
// for later work: split-KV across blocks, wgmma / TMA.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
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
// scales, or both null for a cache of q's type.

// Kernel 2: one query per row over the contiguous [b, h, S, d] cache.
// `offsets` is a [b] int32 device array, or null to use `shared_offset`
// (with the optional [b, S] bias) for every row.
extern "C" int pfx_flash_decode(const void* q, const void* k, const void* v,
                                const float* ks, const float* vs,
                                const int* offsets, int shared_offset,
                                const float* bias, void* o, int b, int h,
                                int S, int d, float sm_scale, int is_bf16,
                                void* stream) {
  if (b <= 0 || h <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, shared_offset, bias,
                           nullptr, o, h, 1, S, 0, 0, sm_scale);
  return dispatch<1, false>(a, b, d, is_bf16,
                            static_cast<cudaStream_t>(stream));
}

// Kernel 5: a window of w (2..32) queries per row at positions
// offsets[i] + j over the contiguous cache; no bias.
extern "C" int pfx_flash_decode_verify(const void* q, const void* k,
                                       const void* v, const float* ks,
                                       const float* vs, const int* offsets,
                                       void* o, int b, int w, int h, int S,
                                       int d, float sm_scale, int is_bf16,
                                       void* stream) {
  if (b <= 0 || h <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, 0, nullptr, nullptr, o,
                           h, w, S, 0, 0, sm_scale);
  return dispatch_window<false>(a, b, d, is_bf16,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 6a: one query per row through the [b, max_pages] int32 page
// table `pt` over the [P, h, page, d] pool; per-row offsets.
extern "C" int pfx_flash_decode_paged(const void* q, const void* k,
                                      const void* v, const float* ks,
                                      const float* vs, const int* offsets,
                                      const int* pt, void* o, int b, int h,
                                      int page, int max_pages, int d,
                                      float sm_scale, int is_bf16,
                                      void* stream) {
  if (b <= 0 || h <= 0 || page <= 0 || max_pages <= 0 || pt == nullptr ||
      offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, 0, nullptr, pt, o, h, 1,
                           page * max_pages, page, max_pages, sm_scale);
  return dispatch<1, true>(a, b, d, is_bf16,
                           static_cast<cudaStream_t>(stream));
}

// Kernel 6b: kernel 5's window through the page table.
extern "C" int pfx_flash_decode_paged_verify(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* offsets, const int* pt, void* o, int b,
    int w, int h, int page, int max_pages, int d, float sm_scale,
    int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || page <= 0 || max_pages <= 0 || pt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, ks, vs, offsets, 0, nullptr, pt, o, h, w,
                           page * max_pages, page, max_pages, sm_scale);
  return dispatch_window<true>(a, b, d, is_bf16,
                               static_cast<cudaStream_t>(stream));
}
