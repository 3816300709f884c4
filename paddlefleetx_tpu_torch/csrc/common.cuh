// Shared device helpers of the port's attention kernels: stores from
// the fp32 the kernels compute in to the storage types (bf16, fp32),
// and 16-byte vector loads that widen to fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pfx {

// Masked-score fill, the value the TPU kernels use
// (ops/pallas/flash_attention.py NEG_INF).
constexpr float kNegInf = -1e30f;

static __device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
static __device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// Load one 16-byte vector (16-byte aligned) and widen it to fp32.
static __device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}
static __device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                                float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One 16-byte vector kept as loaded (4 registers whatever T is), to be
// widened to fp32 where it is used: a kernel that holds several loads
// in flight spends half the registers on bf16 data this way.
static __device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
static __device__ __forceinline__ void widen(const uint4& r, float* out,
                                             const float*) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
static __device__ __forceinline__ void widen(const uint4& r, float* out,
                                             const __nv_bfloat16*) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

}  // namespace pfx
