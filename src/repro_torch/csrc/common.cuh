// Device helpers shared by the kernels: fp32 / bf16 conversion and the
// widening of one 16-byte load to fp32.  All conversions round to nearest
// even; bf16 -> fp32 is exact.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// One 16-byte vector to fp32: 4 floats, or 8 bf16 (the low half of a word is
// the lower address).  The third argument selects the element type.
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
