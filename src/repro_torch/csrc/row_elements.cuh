// Row elements of the float kernels (K1, K2/K3, K6): float32, or bfloat16
// and float16 values read in place.  The reference's Pallas kernels cast
// any float operand to float32 before they compute; 16-bit values are
// exact in float32, so a kernel that converts them as it reads them does
// the float32 kernel's arithmetic on a float32 copy, bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace elem {

// Four consecutive values from shared memory as float32: one 16-byte
// read of float32, one 8-byte read of 16-bit values (8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A 16-bit zero (the fill of a plain load past the rows).
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ __nv_bfloat16 zero() {
  return __ushort_as_bfloat16(0);
}
template <> __device__ __forceinline__ __half zero() {
  return __ushort_as_half(0);
}

}  // namespace elem
