// Helpers shared by the two attention kernels of the port
// (flash_attention.cu, decode_attention.cu): element types, 16-byte vector
// loads widened to f32, bf16 rounding, and the reference's NEG_INF.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

// jnp.finfo(jnp.float32).min: the reference's masked score and initial max
constexpr float kNegInf = -FLT_MAX;

// dtype codes of the C interface
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// x rounded to bf16 (round to nearest even, as astype(bfloat16)) and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One 16-byte load (4 f32 or 8 bf16) widened to f32. `p` is 16-byte
// aligned: the wrappers check the base pointers and every row stride is
// a multiple of 16 bytes.
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

}  // namespace attn
