// Helpers shared by the two attention kernels of the port
// (flash_attention.cu, decode_attention.cu): element types, 16-byte vector
// loads widened to f32, bf16 rounding, the reference's NEG_INF, and the
// Hopper copy machinery both use -- mbarriers, TMA tile loads and the tensor
// maps that describe them -- which the arena scan (arena_scan.cuh) uses
// too.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

// jnp.finfo(jnp.float32).min: the reference's masked score and initial max
constexpr float kNegInf = -FLT_MAX;

// dtype codes of the C interface
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// The head-dim rule of both kernels (`launch_width` and `row_pieces` in
// kernels/_attention.py). A row of `hd` elements -- a multiple of 8, so
// that a tensor map reads it in place (the wrappers copy any other head
// dim, zero-padded, to the next multiple) -- runs as column pieces of
// piece_cols(dtype, hd) columns: the whole row up to 256 (wgmma's N, and a
// TMA box's widest dimension), else the fewest pieces of at most
// piece_max(dtype) columns, balanced to multiples of 8 (the last one may
// be narrower). Every piece scores with the whole row and writes its own
// columns of the output. A piece runs at the first built width that holds
// it; the columns past hd come in as zeros from the tensor map's
// out-of-bounds fill. launch_width is -1 when hd is refused (under 1, or
// not a multiple of 8) or the dtype is unknown. Past 256 bf16 pieces are
// at most 128 columns (the wgmma body's accumulators spill at 256: 2.9x
// slower at hd 512, PERF.md), f32 ones at most 256 (its scalar body has
// no such cap, and fewer pieces recompute Q . K^T fewer times).
inline int piece_max(int dtype) { return dtype == kBF16 ? 128 : 256; }
inline int piece_cols(int dtype, int hd) {
  if (hd <= 256) return hd;
  const int pmax = piece_max(dtype);
  const int n = (hd + pmax - 1) / pmax;
  return ((hd + n - 1) / n + 7) / 8 * 8;
}
inline int launch_width(int dtype, int hd) {
  if (hd < 1 || hd % 8 != 0 || (dtype != kF32 && dtype != kBF16)) return -1;
  const int p = piece_cols(dtype, hd);
  return p <= 16 ? 16 : p <= 32 ? 32 : p <= 64 ? 64 : p <= 128 ? 128
       : p <= 192 ? 192 : 256;
}

// 1 / sqrt(hd) of the true head dim (a padded copy's width never sets it)
inline float head_scale(int hd_true) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd_true)));
}

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

// ---- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// the producer's arrival, announcing the bytes its TMA loads will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts kWaitCycles (about 8 s) traps: a lost arrival becomes a launch
// error rather than a hung card.
constexpr long long kWaitCycles = 1LL << 34;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `rank` dims of `dtype` (innermost first; `strides` in
// bytes of dims 1..rank-1) with tiles of `box`, zero fill out of bounds.
inline int make_map(CUtensorMap* map, CUtensorMapDataType dtype,
                    const void* ptr, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box,
                    CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, dtype, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}


}  // namespace attn
