// Shared device helpers of the port's kernels: stores from the fp32 the
// kernels compute in to the storage types (bf16, fp32), 16-byte vector
// loads that widen to fp32, the int8 cache's 8-byte loads that widen
// and dequantize, the exact int8 -> bf16 widening, cp.async copies
// (zero-filled past a tile's live keys), and the bf16 mma.sync product
// of the tensor-core kernels with its transposed fragment load.
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

// One vector kept as loaded (16 bytes: 4 registers whatever T is), to
// be widened to fp32 where it is used: a kernel that holds several loads
// in flight spends half the registers on bf16 data this way.
template <typename Raw = uint4>
static __device__ __forceinline__ Raw load_raw(const void* p) {
  return *reinterpret_cast<const Raw*>(p);
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

// Load n contiguous elements (n a multiple of one 16-byte vector) and
// widen them to fp32.
template <int n, typename T>
static __device__ __forceinline__ void load_vecs(const T* p, float* out) {
#pragma unroll
  for (int c = 0; c < n / Vec<T>::N; ++c)
    load_vec(p + c * Vec<T>::N, out + c * Vec<T>::N);
}

// How a decode kernel holds one lane's slice of a cached key row: N
// elements in one raw vector as loaded. bf16 and fp32 load 16 bytes;
// int8 loads 8 (8 elements), so an int8 row is read by as many lanes
// as a bf16 one.
template <typename C>
struct KvSlice {
  using Raw = uint4;
  static constexpr int N = 16 / sizeof(C);
};
template <>
struct KvSlice<int8_t> {
  using Raw = uint2;
  static constexpr int N = 8;
};

// Eight int8 values widened and dequantized: each one explicitly
// rounded product float(q8) * scale, the JAX kernel's
// `k.astype(f32) * scale`.
static __device__ __forceinline__ void widen_int8(const uint2& r, float* out,
                                                  float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = i < 4 ? r.x : r.y;
    const int8_t q8 = static_cast<int8_t>((w >> (8 * (i % 4))) & 0xffu);
    out[i] = __fmul_rn(static_cast<float>(q8), scale);
  }
}

// Four int8 (one word, byte 0 first) to four bf16, exactly: each byte,
// its sign bit flipped, becomes the low byte of the fp32 2^23 + u (u =
// b + 128), from which 2^23 + 128 is subtracted; the integer result is
// exact in bf16, so its upper half is its bf16. lo holds bytes 0 and 1
// (byte 0 in the low half), hi bytes 2 and 3. Two logic, six permutes and
// four adds for four values, where widen16 spends a shift, a mask and
// an integer-to-float conversion on each (kernel 7's stream and wgmma
// routes, the decode kernels' int8 tiles).
static __device__ __forceinline__ void widen4(uint32_t word, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                          0x7650)),
                             8388736.f);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                          0x7651)),
                             8388736.f);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                          0x7652)),
                             8388736.f);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                          0x7653)),
                             8388736.f);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

static __device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 (or 4) bytes from global to shared memory without registers; only
// `src_bytes` (0 or the full size) are read, the rest are zero-filled.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
static __device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `kPending` of this thread's groups are in flight.
template <int kPending>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8j .. 8j + 7 give
// the (16-byte aligned) row addresses of matrix j, r[j] is its fragment
// (row lane / 4, columns 2 (lane % 4) and + 1). The B operand of
// mma_bf16 from a tile staged [n][k] (the reduction axis contiguous)
// comes this way.
static __device__ __forceinline__ void ldsm_x4(uint32_t* r,
                                               const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8j ..
// 8j + 7 give the (16-byte aligned) row addresses of matrix j, r[j] is
// its fragment. The B operand of mma_bf16 from a tile staged [k][n]
// (the output axis contiguous) comes this way.
static __device__ __forceinline__ void ldsm_x4_trans(uint32_t* r,
                                                     const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a * b: one m16n8k16 product, bf16 operands, fp32 accumulator
static __device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace pfx
