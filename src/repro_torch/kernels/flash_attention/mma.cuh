// mma.cuh: the tensor-core building blocks that the flash_attention
// kernels share (flash_attention.cu's forward, flash_attention_bwd_tc.cu's
// backward): conversions between float32 and the input type, cp.async
// copies into shared memory, ldmatrix (plain and transposed), mma.sync
// m16n8k16 with float32 accumulators for bfloat16 and float16, operand
// packing (one rounding, or a hi/lo split), and tile copies between device
// and shared memory with the widest copy the row width and alignment allow.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one copy of N bytes into shared memory; the bytes past src_bytes are zeros
template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         int src_bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b for one m16n8k16 tile, float32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T2>
__device__ __forceinline__ uint32_t bits(T2 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) rounded to the input type, packed as one 32-bit operand register
template <typename T>
__device__ __forceinline__ uint32_t pack(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}
template <>
__device__ __forceinline__ uint32_t pack<__half>(float x, float y) {
  return bits(__floats2half2_rn(x, y));
}

// (x, y) = hi + lo with hi the rounding of (x, y) to the input type and lo
// the rounding of the remainder (x - hi is exact in float32)
template <typename T>
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo);
template <>
__device__ __forceinline__ void split<__nv_bfloat16>(float x, float y,
                                                     uint32_t& hi,
                                                     uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
template <>
__device__ __forceinline__ void split<__half>(float x, float y, uint32_t& hi,
                                              uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 hf = __half22float2(h);
  hi = bits(h);
  lo = bits(__floats2half2_rn(x - hf.x, y - hf.y));
}

// The largest copy, in bytes, that divides both a row of d elements and the
// alignment of p: 16, 8 or 4 (cp.async), else 2 (plain loads and stores).
inline int vec_bytes(const void* p, int d, int elem_bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  for (int v = 16; v >= 4; v /= 2)
    if ((d * elem_bytes) % v == 0 && a % v == 0) return v;
  return 2;
}

// rows [0, rows) of a (rows, d) tile at src into shared memory with row
// stride LD, zero-filled past `valid` rows and past column d up to DP
template <typename T, int DP, int LD, int VEC, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows,
                                          int valid, int d) {
  constexpr int kPer = VEC / (int)sizeof(T);  // elements per copy
  constexpr int kCpr = DP / kPer;              // copies per row
  for (int idx = threadIdx.x; idx < rows * kCpr; idx += NT) {
    const int r = idx / kCpr;
    const int c = (idx - r * kCpr) * kPer;
    const bool in = r < valid && c < d;
    if constexpr (VEC >= 4) {
      cp_async<VEC>(smem_u32(dst + r * LD + c),
                    in ? src + (size_t)r * d + c : src, in ? VEC : 0);
    } else {
      dst[r * LD + c] = in ? src[(size_t)r * d + c] : from_f<T>(0.f);
    }
  }
}

template <typename T, int DP, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int valid, int d, int vec) {
  switch (vec) {
    case 16: load_rows<T, DP, LD, 16, NT>(dst, src, rows, valid, d); break;
    case 8: load_rows<T, DP, LD, 8, NT>(dst, src, rows, valid, d); break;
    case 4: load_rows<T, DP, LD, 4, NT>(dst, src, rows, valid, d); break;
    default: load_rows<T, DP, LD, 2, NT>(dst, src, rows, valid, d); break;
  }
}

// rows [0, valid) of ROWS staged output rows to global memory, by NT
// threads (tid is the thread's index among them)
template <typename T, int DP, int LD, int VEC, int ROWS, int NT>
__device__ __forceinline__ void store_rows(T* dst, const T* src, int valid,
                                           int d, int tid) {
  constexpr int kPer = VEC / (int)sizeof(T);
  constexpr int kCpr = DP / kPer;
  for (int idx = tid; idx < ROWS * kCpr; idx += NT) {
    const int r = idx / kCpr;
    const int c = (idx - r * kCpr) * kPer;
    if (r >= valid || c >= d) continue;
    const T* s = src + r * LD + c;
    T* g = dst + (size_t)r * d + c;
    if constexpr (VEC == 16)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else if constexpr (VEC == 8)
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(s);
    else if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
    else
      *g = *s;
  }
}

// rows [0, valid) of a staged (ROWS, LD) tile to global memory, by NT
// threads, with the widest copy `vec` allows
template <typename T, int DP, int LD, int ROWS, int NT>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int valid,
                                           int d, int tid, int vec) {
  switch (vec) {
    case 16: store_rows<T, DP, LD, 16, ROWS, NT>(dst, src, valid, d, tid);
             break;
    case 8: store_rows<T, DP, LD, 8, ROWS, NT>(dst, src, valid, d, tid);
            break;
    case 4: store_rows<T, DP, LD, 4, ROWS, NT>(dst, src, valid, d, tid);
            break;
    default: store_rows<T, DP, LD, 2, ROWS, NT>(dst, src, valid, d, tid);
             break;
  }
}

}  // namespace
