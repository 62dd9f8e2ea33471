// Split-K flash-decode: the Hopper port of the Pallas kernel
// `decode_attention_pallas` (src/repro/kernels/decode_attention/
// decode_attention.py:77, pallas_call :111).
//
// What it computes. One query token per sequence against its KV cache:
// q (B, KV, G, hd), k_cache / v_cache (B, S, KV, hd), lengths (B,) int32.
// Position s of sequence b is live when s < lengths[b]; a masked score is
// NEG_INF = finfo(f32).min, and the running max starts at NEG_INF, exactly
// as the reference does. So a sequence with lengths[b] <= 0 gets every
// p = exp(0) = 1 and returns the mean of V over all S (the reference's
// behaviour, kept); lengths[b] > S means the whole cache. All math is f32:
// scores (q . k) * scale, p = exp(s - m), l = sum p, acc = sum p v. The
// outputs are UN-normalised: acc (B, KV, G, hd), m and l (B, KV, G); the
// caller divides acc by l. The Pallas kernel keeps m and l lane-uniform in
// (G, 128) tiles, a TPU artefact this port drops.
//
// Bound. Decode reads every live K and V row once and does 4 flops per
// element read: memory-bound. At the serving shape (B 8, KV 8, G 4, hd 128,
// bf16, ~2057 live rows) that is 32,768 B a live position, 67.4 MB, i.e.
// 20.1 us at 3.35 TB/s per layer and token.
//
// Design. The Pallas grid walks S in sequence per (b, kv): 64 programs at
// the serving shape, which would leave most of the 132 SMs idle. Here S is
// split in chunks of `split` positions (256 by default) and every
// (chunk, kv, b) is a block: 576 blocks at the serving shape. A block loads
// its K chunk once for all G query heads of its KV head (16-byte loads, a
// row spread over a group of lanes, the dot products reduced by shuffles),
// keeps the chunk's scores in shared memory, takes the chunk's max and sum,
// then streams its V chunk once, each row group accumulating G x hd partial
// sums in registers that shared memory reduces in a fixed order. It writes
// the chunk's (acc, m, l). A chunk that starts at or past lengths[b] > 0
// writes (0, NEG_INF, 0) without reading the cache. A second small kernel
// merges the chunks by the logsumexp rule of the reference's sharded
// combine (decode_attention/ops.py:43-46): m* = max m_i, w_i = exp(m_i -
// m*), l* = sum w_i l_i, acc* = sum w_i acc_i, in chunk order.

#include <cmath>

#include "attention.cuh"

namespace {

using attn::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGChunk = 8;  // query heads accumulated at once in P . V

template <typename T, int HD>
struct Tile {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int LPR = (HD / VEC) < 32 ? (HD / VEC) : 32;  // lanes a row
  static constexpr int EPL = HD / LPR;       // elements a lane holds
  static constexpr int RPW = 32 / LPR;       // rows a warp holds at once
  static constexpr int NRG = kWarps * RPW;   // row groups in a block
};

template <typename T, int HD>
size_t split_smem_bytes(int G, int split) {
  using Tl = Tile<T, HD>;
  return sizeof(float) * (static_cast<size_t>(G) * HD +
                          static_cast<size_t>(G) * split +
                          static_cast<size_t>(Tl::NRG) * kGChunk * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    int S, int KV, int G, int split, float scale,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l) {
  using Tl = Tile<T, HD>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [G][HD]
  float* p_s = q_s + G * HD;                     // [G][split]
  float* red = p_s + G * split;                  // [NRG][kGChunk][HD]

  const int sp = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int len = lengths[b];
  const bool none_live = len <= 0;  // every score masked: p = exp(0) = 1
  if (len > S) len = S;
  const int start = sp * split;
  const int n = min(split, S - start);
  const size_t part = (static_cast<size_t>(b) * KV + kv) * gridDim.x + sp;

  if (!none_live && start >= len) {  // nothing live in this chunk
    for (int i = tid; i < G * HD; i += kThreads)
      part_acc[part * G * HD + i] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      part_m[part * G + g] = kNegInf;
      part_l[part * G + g] = 0.f;
    }
    return;
  }
  const int live = none_live ? 0 : min(len - start, n);
  // rows whose p can be nonzero: all n when nothing is live (p = 1), else
  // the live ones (a masked row's p = exp(NEG_INF - m) is 0)
  const int n_pv = none_live ? n : live;

  const T* qb = q + (static_cast<size_t>(b) * KV + kv) * G * HD;
  for (int i = tid; i < G * HD; i += kThreads) q_s[i] = attn::to_float(qb[i]);
  __syncthreads();

  // scores of the chunk: one row a row group, the lanes of a group holding
  // EPL consecutive dims; every lane runs every iteration (the shuffles)
  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const size_t base = static_cast<size_t>(b) * S * row_stride +
                      static_cast<size_t>(kv) * HD;
  const T* kb = kc + base;
  const T* vb = vc + base;
  const int rg = warp * Tl::RPW + lane / Tl::LPR;
  const int d0 = (lane % Tl::LPR) * Tl::EPL;
  for (int r0 = 0; r0 < n; r0 += Tl::NRG) {
    const int r = r0 + rg;
    float kf[Tl::EPL];
    if (r < live) {  // a masked row's score is NEG_INF whatever k holds
      const T* row = kb + static_cast<size_t>(start + r) * row_stride + d0;
#pragma unroll
      for (int e = 0; e < Tl::EPL; e += Tl::VEC) attn::load_vec(row + e, kf + e);
    } else {
#pragma unroll
      for (int e = 0; e < Tl::EPL; ++e) kf[e] = 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * HD + d0;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < Tl::EPL; ++e) acc = fmaf(qg[e], kf[e], acc);
#pragma unroll
      for (int off = Tl::LPR / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (r < n && lane % Tl::LPR == 0)
        p_s[g * split + r] = r < live ? acc * scale : kNegInf;
    }
  }
  __syncthreads();

  // the chunk's softmax statistics, one warp a query head
  for (int g = warp; g < G; g += kWarps) {
    float* pg = p_s + g * split;
    float m = kNegInf;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, pg[r]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(pg[r] - m);
      pg[r] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      part_m[part * G + g] = m;
      part_l[part * G + g] = l;
    }
  }
  __syncthreads();

  // P . V: each row group accumulates its rows, shared memory sums the
  // groups in a fixed order
  for (int g0 = 0; g0 < G; g0 += kGChunk) {
    const int gn = min(kGChunk, G - g0);
    float acc[kGChunk][Tl::EPL];
#pragma unroll
    for (int g = 0; g < kGChunk; ++g)
#pragma unroll
      for (int e = 0; e < Tl::EPL; ++e) acc[g][e] = 0.f;
    for (int r = rg; r < n_pv; r += Tl::NRG) {
      float vf[Tl::EPL];
      const T* row = vb + static_cast<size_t>(start + r) * row_stride + d0;
#pragma unroll
      for (int e = 0; e < Tl::EPL; e += Tl::VEC) attn::load_vec(row + e, vf + e);
#pragma unroll
      for (int g = 0; g < kGChunk; ++g) {
        if (g < gn) {
          const float p = p_s[(g0 + g) * split + r];
#pragma unroll
          for (int e = 0; e < Tl::EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGChunk; ++g)
      if (g < gn)
#pragma unroll
        for (int e = 0; e < Tl::EPL; ++e)
          red[(rg * kGChunk + g) * HD + d0 + e] = acc[g][e];
    __syncthreads();
    for (int i = tid; i < gn * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float s = 0.f;
      for (int j = 0; j < Tl::NRG; ++j) s += red[(j * kGChunk + g) * HD + d];
      part_acc[(part * G + g0 + g) * HD + d] = s;
    }
    __syncthreads();
  }
}

// The logsumexp merge of the chunks: one block a (b, kv).
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      int G, int HD, int n_split,
                                      float* __restrict__ acc,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out) {
  const size_t bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, part_m[(bk * n_split + s) * G + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t ps = (bk * n_split + s) * G + g;
      const float w = expf(part_m[ps] - m);
      l = fmaf(part_l[ps], w, l);
      a = fmaf(part_acc[ps * HD + d], w, a);
    }
    acc[(bk * G + g) * HD + d] = a;
    if (d == 0) {
      m_out[bk * G + g] = m;
      l_out[bk * G + g] = l;
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           int B, int S, int KV, int G, int split, float* part_acc,
           float* part_m, float* part_l, float* acc, float* m, float* l,
           cudaStream_t stream) {
  const int n_split = (S + split - 1) / split;
  const size_t smem = split_smem_bytes<T, HD>(G, split);
  auto kern = decode_split_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kern<<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, S, KV, G, split, scale, part_acc,
      part_m, part_l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<B * KV, 256, 0, stream>>>(
      part_acc, part_m, part_l, G, HD, n_split, acc, m, l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* lengths, int B, int S, int KV, int G, int split,
              float* pa, float* pm, float* pl, float* acc, float* m, float* l,
              cudaStream_t st) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, lengths, B, S, KV, G, split, pa, pm, pl,
                         acc, m, l, st);
  if (hd == 128)
    return launch<T, 128>(q, k, v, lengths, B, S, KV, G, split, pa, pm, pl,
                          acc, m, l, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, KV, G, hd), k / v (B, S, KV, hd), all of `dtype` (0 f32, 1 bf16),
// hd in {64, 128}, 1 <= G <= 32;
// lengths (B,) int32 -> acc (B, KV, G, hd) f32, m and l (B, KV, G) f32.
// Scratch: part_acc (B, KV, n_split, G, hd) f32 and part_m / part_l
// (B, KV, n_split, G) f32 with n_split = ceil(S / split). Two launches on
// `stream`, no synchronisation. Returns the first CUDA error (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* lengths, int dtype, int B, int S,
                            int KV, int G, int hd, int split, float* part_acc,
                            float* part_m, float* part_l, float* acc,
                            float* m, float* l, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == attn::kBF16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, lengths, B, S, KV, G, split,
                                    part_acc, part_m, part_l, acc, m, l, st);
  if (dtype == attn::kF32)
    return launch_hd<float>(hd, q, k, v, lengths, B, S, KV, G, split,
                            part_acc, part_m, part_l, acc, m, l, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
