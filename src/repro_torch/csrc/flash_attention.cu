// Flash-attention forward: the Hopper port of the Pallas kernel
// `flash_attention_pallas` (src/repro/kernels/flash_attention/
// flash_attention.py:79, pallas_call :90).
//
// What it computes. Causal (or full) grouped-query attention:
// q (B, S, KV, G, hd), k / v (B, S, KV, hd) -> o (B, S, KV, G, hd), f32 or
// bf16, with the reference kernel's numerics: scores (q . k) * scale in f32
// on the f32 values of the inputs, an online softmax in f32 (running max
// from NEG_INF = finfo(f32).min, masked scores NEG_INF), P and V rounded to
// bf16 (round to nearest even) for P . V with f32 accumulation, l summed
// from the unrounded p, and o = acc / max(l, 1e-30) rounded to the input
// type. S need not be a multiple of any block (the reference asserts it).
//
// Bound. Operations: 4 hd flops a (query head, visible key) pair, half the
// S^2 pairs when causal. At the prefill shape (B 8, S 2048, KV 8, G 4,
// hd 128, bf16, causal) that is 274.9 GFLOP, 0.278 ms at the card's
// 989 TFLOP/s bf16 peak, against 335.5 MB of q, k, v and o (0.100 ms at
// 3.35 TB/s): bound by operations.
//
// Design. The Pallas grid walks the kv blocks of a q block in sequence
// with its accumulators in VMEM. Here one block of 128 threads owns a tile
// of 64 rows, a row being a (query position, query head) pair of one
// (b, kv): 64 / G positions times all G heads of that KV head, so every K
// and V tile it loads serves the G heads at once. It loops over the 64-key
// tiles up to the diagonal (skipping those above it), masks only where a
// tile crosses the diagonal or the end of S, and keeps the row statistics
// and the 64 x hd output accumulator in registers. Blocks run the heaviest
// (last) causal q tiles first. Two bodies share that schedule:
//  * bf16 with hd 64 or 128 (the served models): both products on the
//    tensor cores as mma.sync m16n8k16 bf16 -> f32, one warp per 16 rows
//    (flash_fwd_mma_kernel below);
//  * f32 (hd 64 or 128): scalar f32 FMAs on the same rounded values, Q (and
//    K) transposed, V and P in shared memory as f32, each thread a 4 x 8
//    block of scores and a 4 x (hd / 8) block of the output, read in
//    16-byte vectors laid out so that a quarter warp hits distinct banks
//    (flash_fwd_kernel). Q . K^T of f32 inputs cannot take bf16 operands.
// Neither pipelines its loads (no cp.async / TMA ring) nor uses wgmma:
// the staging and the Hopper-only instructions are a later redesign.

#include <cmath>

#include "attention.cuh"

namespace {

using attn::kNegInf;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // rows (query position, head) a block
constexpr int kKeys = 64;  // keys a tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(HD) * kRows +  // Qt [HD][rows]
                          static_cast<size_t>(HD) * kKeys +  // Kt [HD][keys]
                          static_cast<size_t>(kKeys) * HD +  // V  [keys][HD]
                          static_cast<size_t>(kKeys) * kRows);  // Pt [keys][rows]
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int KV,
                 int G, int causal, float scale) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = HD / VEC;   // 16-byte chunks a row
  constexpr int DJ = HD / 32;    // float4 output columns a thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + HD * kRows;
  float* Vs = Kt + HD * kKeys;
  float* Pt = Vs + kKeys * HD;

  const int BQ = kRows / G;      // query positions a tile
  const int R = BQ * G;          // rows in use
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int kv = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;

  const size_t q_row = static_cast<size_t>(KV) * G * HD;  // one position
  const size_t k_row = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * S * q_row +
                static_cast<size_t>(kv) * G * HD;
  const T* kb = k + static_cast<size_t>(b) * S * k_row +
                static_cast<size_t>(kv) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * k_row +
                static_cast<size_t>(kv) * HD;

  // the Q tile, transposed: Qt[d][r], row r = (position r / G, head r % G)
  for (int idx = tid; idx < kRows * CH; idx += kThreads) {
    const int r = idx % kRows, ch = idx / kRows;
    const int p = r / G, g = r % G;
    float x[VEC];
    if (r < R && q0 + p < S) {
      attn::load_vec(qb + static_cast<size_t>(q0 + p) * q_row + g * HD +
                     ch * VEC, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qt[(ch * VEC + e) * kRows + r] = x[e];
  }

  int pos[4];  // query position of each of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = q0 + (tr * 4 + i) / G;
  float m_r[4], l_r[4], acc[4][DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  const int p_last = min(S, q0 + BQ) - 1;  // last live position of the tile
  const int n_tiles = causal ? p_last / kKeys + 1 : (S + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's Kt, V and Pt are consumed
    // K transposed (consecutive threads on consecutive keys: no bank
    // conflict on the transposed stores), V as is (coalesced), V and later
    // P rounded to bf16 as the reference's P . V takes them
    for (int idx = tid; idx < kKeys * CH; idx += kThreads) {
      const int c = idx % kKeys, ch = idx / kKeys;
      float x[VEC];
      if (k0 + c < S) {
        attn::load_vec(kb + static_cast<size_t>(k0 + c) * k_row + ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Kt[(ch * VEC + e) * kKeys + c] = x[e];
    }
    for (int idx = tid; idx < kKeys * CH; idx += kThreads) {
      const int ch = idx % CH, c = idx / CH;
      float x[VEC];
      if (k0 + c < S) {
        attn::load_vec(vb + static_cast<size_t>(k0 + c) * k_row + ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        Vs[c * HD + ch * VEC + e] = attn::round_bf16(x[e]);
    }
    __syncthreads();

    // scores: rows tr*4 + i, keys tc*4 + e and 32 + tc*4 + e
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kRows + tr * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Kt + d * kKeys + tc * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Kt + d * kKeys + 32 + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax; the 8 threads of a row group are 8 consecutive lanes
    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + (j < 4 ? tc * 4 + j : 32 + tc * 4 + j - 4);
        float x = s[i][j] * scale;
        if (edge && (c >= S || (causal && c > pos[i]))) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = attn::round_bf16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tc * 4 + j : 32 + tc * 4 + j - 4;
      *reinterpret_cast<float4*>(Pt + c * kRows + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // P . V: rows tr*4 + i, dims j*32 + tc*4 + e
    // keys past S, or past the tile's last position when causal, have p = 0
    const int c_end = min(kKeys, (causal ? p_last + 1 : S) - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + c * kRows + tr * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float4 w =
            *reinterpret_cast<const float4*>(Vs + c * HD + j * 32 + tc * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = fmaf(av[i], wv[e], acc[i][j][e]);
      }
    }
  }

  // o = acc / max(l, 1e-30), rows in use and positions inside S only
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int p = r / G, g = r % G;
    if (r >= R || q0 + p >= S) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + q0 + p) * q_row +
              static_cast<size_t>(kv) * G * HD + g * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        attn::from_float(acc[i][j][e] / den, orow + j * 32 + tc * 4 + e);
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the same tiles on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPad = 8;  // bf16 elements of padding a shared-memory row

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kRows) * (HD + kPad) +    // Qs [rows][HD]
          static_cast<size_t>(kKeys) * (HD + kPad) +    // Ks [keys][HD]
          static_cast<size_t>(HD) * (kKeys + kPad));    // Vt [HD][keys]
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// For bf16 inputs both products run as mma.sync m16n8k16 bf16 -> f32: the
// products of bf16 values are exact in f32, so Q . K^T keeps the
// reference's f32 scores, and P . V takes P rounded to bf16 (V is bf16
// already) with f32 accumulation, as the reference kernel. Each of the 4
// warps owns 16 of the block's 64 rows; Q's fragments stay in registers for
// the whole loop, the scores' accumulator layout is reused as P's operand
// layout (no shared-memory round trip for P), and V is stored transposed so
// that its operand fragments are 32-bit loads. Rows of shared memory are
// padded by 16 bytes so that a warp's fragment loads hit 32 distinct banks.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int KV, int G,
                     int causal, float scale) {
  constexpr int CH = HD / 8;       // 16-byte chunks a row
  constexpr int KS = HD / 16;      // k-steps of Q . K^T
  constexpr int NT = HD / 8;       // n-tiles of P . V
  constexpr int QLD = HD + kPad, VLD = kKeys + kPad;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + kRows * QLD;
  __nv_bfloat16* Vt = Ks + kKeys * QLD;

  const int BQ = kRows / G, R = BQ * G;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int kv = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  const size_t q_row = static_cast<size_t>(KV) * G * HD;
  const size_t k_row = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * S * q_row +
                            static_cast<size_t>(kv) * G * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * k_row +
                            static_cast<size_t>(kv) * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * k_row +
                            static_cast<size_t>(kv) * HD;

  for (int idx = tid; idx < kRows * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx % CH;
    const int p = r / G, g = r % G;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < R && q0 + p < S)
      x = __ldg(reinterpret_cast<const uint4*>(
          qb + static_cast<size_t>(q0 + p) * q_row + g * HD + ch * 8));
    *reinterpret_cast<uint4*>(Qs + r * QLD + ch * 8) = x;
  }
  __syncthreads();
  const int r0 = warp * 16 + gid, r1 = r0 + 8;  // this thread's two rows
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = ld32(Qs + r0 * QLD + c);
    qa[ks][1] = ld32(Qs + r1 * QLD + c);
    qa[ks][2] = ld32(Qs + r0 * QLD + c + 8);
    qa[ks][3] = ld32(Qs + r1 * QLD + c + 8);
  }
  const int pos0 = q0 + r0 / G, pos1 = q0 + r1 / G;

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int p_last = min(S, q0 + BQ) - 1;
  const int n_tiles = causal ? p_last / kKeys + 1 : (S + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's Ks and Vt are consumed
    for (int idx = tid; idx < kKeys * CH; idx += kThreads) {
      const int c = idx / CH, ch = idx % CH;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + c < S)
        x = __ldg(reinterpret_cast<const uint4*>(
            kb + static_cast<size_t>(k0 + c) * k_row + ch * 8));
      *reinterpret_cast<uint4*>(Ks + c * QLD + ch * 8) = x;
    }
    for (int idx = tid; idx < kKeys * CH; idx += kThreads) {
      const int c = idx % kKeys, ch = idx / kKeys;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + c < S)
        x = __ldg(reinterpret_cast<const uint4*>(
            vb + static_cast<size_t>(k0 + c) * k_row + ch * 8));
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(ch * 8 + e) * VLD + c] = xe[e];
    }
    __syncthreads();

    // scores: 8 n-tiles of 8 keys, rows r0 (s[j][0..1]) and r1 (s[j][2..3])
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + gid) * QLD + ks * 16 + tig * 2;
        mma_bf16(s[j], qa[ks], ld32(kr), ld32(kr + 8));
      }

    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + j * 8 + tig * 2 + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        float x = s[j][e] * scale;
        if (edge && (c >= S || (causal && c > pos))) x = kNegInf;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
    const float al0 = expf(m_r[0] - mn0), al1 = expf(m_r[1] - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p; else sum1 += p;
        s[j][e] = p;
      }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l_r[0] = l_r[0] * al0 + sum0;
    l_r[1] = l_r[1] * al1 + sum1;
    m_r[0] = mn0;
    m_r[1] = mn1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }

    // P . V: the scores' accumulators become P's operand fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* vr = Vt + (nt * 8 + gid) * VLD + kk * 16 + tig * 2;
        mma_bf16(acc[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // o = acc / max(l, 1e-30), rows in use and positions inside S only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    const int p = r / G, g = r % G;
    if (r >= R || q0 + p >= S) continue;
    const float den = fmaxf(l_r[h], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * S + q0 + p) * q_row +
                          static_cast<size_t>(kv) * G * HD + g * HD;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat162 y = __floats2bfloat162_rn(acc[nt][2 * h] / den,
                                                     acc[nt][2 * h + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + tig * 2) = y;
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int KV, int G, int causal, cudaStream_t stream) {
  const int BQ = kRows / G;
  const int n_qt = (S + BQ - 1) / BQ;
  constexpr size_t smem = mma_smem_bytes<HD>();
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kern<<<dim3(n_qt, KV, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      KV, G, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int KV, int G, int causal, cudaStream_t stream) {
  const int BQ = kRows / G;
  const int n_qt = (S + BQ - 1) / BQ;
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kern<<<dim3(n_qt, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, KV, G, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, S, KV, G, hd), k / v (B, S, KV, hd) -> o (B, S, KV, G, hd), all of
// `dtype` (0 f32: the scalar kernel, 1 bf16: the tensor-core kernel), hd in
// {64, 128}, 1 <= G <= 64. One launch on `stream`, no synchronisation.
// Returns the first CUDA error (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int KV, int G,
                           int hd, int causal, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bool bf = dtype == attn::kBF16;
  if ((!bf && dtype != attn::kF32) || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return bf ? launch_mma<64>(q, k, v, o, B, S, KV, G, causal, st)
              : launch<float, 64>(q, k, v, o, B, S, KV, G, causal, st);
  return bf ? launch_mma<128>(q, k, v, o, B, S, KV, G, causal, st)
            : launch<float, 128>(q, k, v, o, B, S, KV, G, causal, st);
}

}  // extern "C"
