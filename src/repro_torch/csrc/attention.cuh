// Helpers shared by the two attention kernels of the port
// (flash_attention.cu, decode_attention.cu): element types, 16-byte vector
// loads widened to f32, bf16 rounding, the reference's NEG_INF, the Hopper
// copy machinery both use -- mbarriers, TMA tile loads and the tensor maps
// that describe them, which the arena scan (arena_scan.cuh) uses too --
// and the wgmma products of their bf16 tensor-core bodies.
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
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

// ---- wgmma: bf16 operands, f32 accumulators -------------------------------
// The tensor-core pieces of the bf16 flash body (flash_attention.cu) and of
// the decode kernel's tensor-core body (decode_attention.cu). A tile of
// rows of width HD lies in shared memory as HD / (line / 2) boxes of
// [rows][line bytes], each line swizzled by TMA: widths 64 to 256 in
// 128-byte lines, 32 and 16 in one 64- or 32-byte line (`line_bytes`), so
// a line never holds parts of two rows.

__host__ __device__ constexpr int line_bytes(int HD) {
  return HD * 2 < 128 ? HD * 2 : 128;
}

// A wgmma shared-memory descriptor of an operand swizzled in LINE-byte
// lines: start address, leading and stride byte offsets (16-byte units),
// layout type in bits 62-63: B128 1, B64 2, B32 3.
template <int LINE>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  constexpr uint64_t kType = LINE == 128 ? 1 : LINE == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | kType << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit, denormal results flushed to zero: a
// masked score (NEG_INF - m) gives exactly 0, as exp2f does
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64): both bf16 in shared
// memory, K-major; ``accumulate`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) (+)= A (64 x 16) . B (16 x 32): both bf16 in shared
// memory, K-major; ``accumulate`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16, f32) += A (64 x 16, bf16 in registers) . B (16 x 16, bf16
// in shared memory, MN-major: the descriptor's transpose of B)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, bf16 in registers) . B (16 x 32, bf16
// in shared memory, MN-major: the descriptor's transpose of B)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16
// in shared memory, MN-major: the descriptor's transpose of B)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16
// in shared memory, MN-major: the descriptor's transpose of B)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// S = A . K^T of one key tile, issued (not waited for): A's 64 rows from
// a_rows (a tile of QROWS rows a box) and the tile's KN (64 or 32) keys,
// wgmma N = KN, HD / 16 k-steps of 16 columns, i.e. 32 bytes into a
// swizzled line (4 steps a 128-byte line, 2 a 64-byte one, 1 a 32-byte
// one), the second 64 columns of hd 128 in the second box of each; 8-row
// groups line * 8 bytes apart (the stride byte offset).
template <int HD, int KN, int QROWS>
__device__ __forceinline__ void issue_scores(float (&sc)[KN / 2],
                                             uint32_t a_rows, uint32_t kt) {
  constexpr int kLine = line_bytes(HD);
  constexpr int kSteps = kLine / 32;  // k-steps a line
  static_assert(KN == 64 || KN == 32,
                "S = Q . K^T is issued as wgmma m64n64k16 or m64n32k16");
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t col = (ks % kSteps) * 32;
    const uint64_t da = desc_sw<kLine>(
        a_rows + (ks / kSteps) * QROWS * kLine + col, 16, 8 * kLine);
    const uint64_t db = desc_sw<kLine>(kt + (ks / kSteps) * KN * kLine + col,
                                       16, 8 * kLine);
    if constexpr (KN == 64)
      wgmma_ss_n64(sc, da, db, ks > 0);
    else
      wgmma_ss_n32(sc, da, db, ks > 0);
  }
  wgmma_commit();
}

// O += P . V of one key tile, issued but not committed: V [keys][hd] is B
// in MN-major form (wgmma N = HD up to 128), a k-step being 16 key lines
// (16 line bytes), 8-key groups 8 lines apart, the 64-column boxes of a
// row one tile apart (the leading byte offset; a narrower row is one
// swizzle atom wide). Widths past 128 issue a product of N = 128 a pair of
// boxes (and N = 64 for the last box of 192): accumulator j of the whole
// row holds column 8 (j / 4) + 2 (lane % 4) + (j % 2), so the piece from
// column c0 is acc[c0 / 2 ..] in the same layout.
template <int HD, int KN>
__device__ __forceinline__ void pv_products(float (&acc)[HD / 2],
                                            const uint32_t (&pa)[KN / 16][4],
                                            uint32_t vt) {
  constexpr int kLine = line_bytes(HD);
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    if constexpr (HD <= 128) {
      wgmma_rs<HD>(acc, pa[kk], desc_sw<kLine>(vt + kk * 16 * kLine,
                                               KN * kLine, 8 * kLine));
    } else {
#pragma unroll
      for (int c0 = 0; c0 < HD; c0 += 128) {
        const uint64_t db = desc_sw<kLine>(
            vt + (c0 / 64) * KN * kLine + kk * 16 * kLine, KN * kLine,
            8 * kLine);
        if (HD - c0 >= 128)
          wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(acc + c0 / 2),
                        pa[kk], db);
        else
          wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(acc + c0 / 2),
                       pa[kk], db);
      }
    }
  }
}

// `pv_products`, committed as one group
template <int HD, int KN>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pa)[KN / 16][4],
                                         uint32_t vt) {
  pv_products<HD, KN>(acc, pa, vt);
  wgmma_commit();
}

// P rounded to bf16 (RNE) as wgmma's A fragments: the score accumulator's
// layout is the A operand's layout, 16 keys a k-step.
template <int KN>
__device__ __forceinline__ void pack_p(const float (&sc)[KN / 2],
                                       uint32_t (&pa)[KN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

}  // namespace attn
