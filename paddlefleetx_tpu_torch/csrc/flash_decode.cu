// Single-token decode attention for Hopper (sm_90a), the port's
// serving-tick kernel.
//
// Replaces: paddlefleetx_tpu/ops/pallas/flash_attention.py
// `_decode_kernel` (launched by `_flash_decode_call`, pallas_call at
// :1346) for a bf16 / fp32 cache: `flash_decode` (one shared cache
// index plus a per-key additive bias) and `flash_decode_ragged`
// (per-row offsets, the continuous-batching server's slot lengths).
// Row i's query attends to cache positions 0..offset[i]; the bias is
// added to the score before the mask, as on the TPU.
//
// Layout: q and O are [b, 1, h, d]; the cache is [b, h, S, d] (the
// port's own layout: a key's d values are contiguous, where the TPU
// cache [b, h, d, S] was a TPU tiling choice); bias is [b, S] fp32.
//
// What bounds it on this card: memory. Each live key costs 2 d
// itemsize bytes (its K and V rows) against 4 d FLOPs, about one FLOP
// per byte in bf16 - two orders of magnitude below the H100's balance
// point - so the least time is the live cache bytes over 3.35 TB/s.
//
// What the design does about it: one 256-thread block per (row, head)
// walks only that row's live keys, so a short slot never pays for a
// long one (the TPU kernel's per-slot cost model). A key's d-row is
// read by d*itemsize/16 neighbouring lanes, 16 bytes each, so a warp
// reads several whole rows of contiguous memory per load; each lane
// group keeps its own online-softmax state (max, sum, its slice of
// the accumulator) in fp32 registers, four keys per group are loaded
// before any is used to keep loads in flight, and the groups' states
// are merged once at the end through shared memory. Parity with the
// TPU kernel (the verify window must reproduce decode bit for bit)
// keeps split-KV, which would need a second pass, for a later change.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // keys per lane group loaded ahead

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ offsets, int shared_offset,
                        const float* __restrict__ bias, T* __restrict__ o,
                        int h, int S, float sm_scale) {
  constexpr int kVec = pfx::Vec<T>::N;       // elements per 16-byte load
  constexpr int kLpk = D / kVec;             // lanes per key row
  static_assert(D % kVec == 0 && kLpk >= 1 && kLpk <= 32 &&
                    (32 % kLpk) == 0,
                "unsupported head_dim for this dtype");
  constexpr int kKpw = 32 / kLpk;            // key rows per warp load
  constexpr int kStreams = kWarps * kKpw;    // independent softmax states

  __shared__ float sm_m[kStreams];
  __shared__ float sm_l[kStreams];
  __shared__ float sm_acc[kStreams][D];

  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / kLpk;   // key row within the warp's load
  const int gl = lane % kLpk;    // lane within the key row
  const int stream = warp * kKpw + grp;

  const int off = offsets != nullptr ? offsets[bi] : shared_offset;
  const int n_keys = max(0, min(off + 1, S));

  const long long row_head = (long long)bi * h + hi;
  float qv[kVec];
  pfx::load_vec(q + row_head * D + gl * kVec, qv);
  const T* kb = k + row_head * (long long)S * D + gl * kVec;
  const T* vb = v + row_head * (long long)S * D + gl * kVec;
  const float* brow = bias != nullptr ? bias + (long long)bi * S : nullptr;

  float m = pfx::kNegInf;
  float l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  // the loop bounds are uniform across the warp, so every lane reaches
  // every shuffle; keys past n_keys are skipped lane-group by group
  for (int base = 0; base < n_keys; base += kStreams * kUnroll) {
    float kx[kUnroll][kVec], vx[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * kStreams + stream;
      if (key < n_keys) {
        pfx::load_vec(kb + (long long)key * D, kx[u]);
        pfx::load_vec(vb + (long long)key * D, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * kStreams + stream;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) part += qv[e] * kx[u][e];
#pragma unroll
      for (int w = kLpk / 2; w > 0; w >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, w, kLpk);
      if (key < n_keys) {
        float sv = part * sm_scale;
        if (brow != nullptr) sv += brow[key];
        const float m_new = fmaxf(m, sv);
        const float alpha = expf(m - m_new);
        const float p = expf(sv - m_new);
        l = l * alpha + p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = acc[e] * alpha + p * vx[u][e];
        m = m_new;
      }
    }
  }

  if (gl == 0) {
    sm_m[stream] = m;
    sm_l[stream] = l;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) sm_acc[stream][gl * kVec + e] = acc[e];
  __syncthreads();
  for (int dd = threadIdx.x; dd < D; dd += kThreads) {
    float mx = pfx::kNegInf;
    for (int s = 0; s < kStreams; ++s) mx = fmaxf(mx, sm_m[s]);
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < kStreams; ++s) {
      const float w = expf(sm_m[s] - mx);
      lsum += sm_l[s] * w;
      a += sm_acc[s][dd] * w;
    }
    pfx::store_f(&o[row_head * D + dd], a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* offsets,
           int shared_offset, const float* bias, void* o, int b, int h, int S,
           float sm_scale, cudaStream_t stream) {
  flash_decode_kernel<T, D><<<b * h, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), offsets, shared_offset, bias,
      static_cast<T*>(o), h, S, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 on a successful launch. `offsets` is a [b]
// int32 device array, or null to use `shared_offset` for every row.
// The kernel runs on `stream` and does not synchronise; the caller
// allocates o.
extern "C" int pfx_flash_decode(const void* q, const void* k, const void* v,
                                const int* offsets, int shared_offset,
                                const float* bias, void* o, int b, int h,
                                int S, int d, float sm_scale, int is_bf16,
                                void* stream) {
  if (b <= 0 || h <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, offsets, shared_offset, bias,
                                       o, b, h, S, sm_scale, st);
    if (d == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, offsets, shared_offset, bias,
                                        o, b, h, S, sm_scale, st);
  } else {
    if (d == 64)
      return launch<float, 64>(q, k, v, offsets, shared_offset, bias, o, b, h,
                               S, sm_scale, st);
    if (d == 128)
      return launch<float, 128>(q, k, v, offsets, shared_offset, bias, o, b,
                                h, S, sm_scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
