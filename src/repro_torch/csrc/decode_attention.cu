// Split-K flash-decode in one launch: the Hopper port of the Pallas kernel
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
// bf16, 2049 live rows) that is 32,768 B a live position, 67.3 MB, i.e.
// 20.1 us at 3.35 TB/s per layer and token. Streaming HBM at that rate
// needs megabytes in flight across the card, and the math has to hide
// under the copies.
//
// Design. The Pallas grid walks S in sequence per (b, kv): 64 programs at
// the serving shape, which would leave most of the 132 SMs idle. Here S is
// split in chunks of `split` positions (the wrapper sizes them so that the
// chunks of all (b, kv) fill the card's resident blocks once: 512 blocks
// of 288 rows, 4 an SM, at the serving shape it was designed at, which
// the tensor-core body below now serves) and every (chunk, kv, b) is
// a block of 4 warps, in ONE launch. Any head dim up to 256 runs at the
// first built width (16, 32, 64, 128, 192, 256) that holds it, the tensor
// maps filling the columns past hd with zeros (a wider row as column
// pieces on the grid, each scoring with the whole row: DEEP below), and
// any G: a block takes all G heads of its KV head unless their q and
// scores outgrow its shared memory, and then balanced head blocks on the
// grid (`block_heads` in the wrapper), each reading the chunk's rows
// again:
//  * Copies. Thread 0 streams the chunk's live K rows, then its V rows,
//    through a 4-stage ring of 8 KB sub-tiles in shared memory: one TMA
//    tile load (cp.async.bulk.tensor of a 4-D map {hd, KV, S, B}, rows past
//    S zero-filled; sequence b's rows start S_mem rows after b - 1's, so a
//    cache may be a slice of S positions of a longer one) a sub-tile, full and empty mbarriers, so 3-4 sub-tiles
//    are in flight a block (~16 MB over the card) and the V rows are on
//    their way while the chunk's softmax statistics are taken. The warps
//    wait on the full barriers, not on each other, except at the K -> V
//    boundary and for the final sums.
//  * Math, all f32 with expf. From one read of K a row group of lanes
//    scores all G query heads of its KV head: each lane holds 16 bytes of a
//    row, or 32 for f32 past width 128 (a row group is 2 to 32 lanes:
//    width 16 in bf16 to 128 and up in f32, so a sub-tile holds 8 to 256
//    rows and a warp 1 to 16 row groups; at width 192 a row group's last 8
//    lanes hold no column), its partial dot products of 4 rows x 4 heads are summed over the
//    row group by a butterfly reduce-scatter (a shuffle step halves the
//    values a lane holds), and the scores go to shared memory as
//    [row][head]. The chunk's max and sum, p = exp(s - m), then one read of
//    V: a row's p's for 4 heads come in one 16-byte load and accumulate
//    into G x hd partial sums in registers (heads in groups of 4 when
//    G <= 4, else 8; G > 8 streams V once a group), summed across the row
//    groups of a warp by shuffles and across warps in a fixed order.
//  * Merge. A block writes its chunk's (acc, m, l) to the wrapper's
//    workspace; a chunk that starts at or past lengths[b] > 0 writes
//    nothing and reads no cache. The last block of a (b, kv) to finish --
//    found by an atomic counter after a __threadfence, the counter then
//    reset for the next call -- merges the partials in chunk order by the
//    logsumexp rule of the reference's sharded combine
//    (decode_attention/ops.py:43-46): m* = max m_i, w_i = exp(m_i - m*),
//    l* = sum w_i l_i, acc* = sum w_i acc_i, the loads of 8 chunks at a
//    time (`merge_last`). Which block finishes last does not change the
//    result.
//
// The SIMT body above serves f32 and rows past 256 (bf16 only there: its
// DEEP instantiations at width 128). For bf16 rows up to 256 a second body
// (`decode_tc_kernel`, the wrapper's `uses_tc`) puts the math on the
// tensor cores, at every G: it ran faster than the SIMT body at each G
// measured, 1 included. Its bound is the bytes: at 8 and 71
// query heads a KV head the SIMT body's FMAs outgrow them (Falcon-7B's
// widths, B 8, 2049 live rows: 298 MFLOP, 4.45 us at the f32 rate,
// against 4.4 MB, 1.31 us at 3.35 TB/s), while on the tensor cores the
// same products, P . V taken three times, take under a microsecond. The
// block's query heads are the rows (M) of wgmma m64nNk16 products, 64 a
// warpgroup and one or two warpgroups a block (heads past G are zero q
// rows): S = Q . K^T with the keys of a 64- (32-, past width 128) key tile
// on N, and O += P . V with P from registers and V through the
// descriptor's transpose -- the flash kernel's operands and layouts
// (attention.cuh), with one query position. So a chunk's K and V rows are
// read once for all of a block's heads, a head's online softmax stays in a
// quad of lanes, and no score array bounds a chunk. The products stay
// exact: q, K and V are bf16, so Q . K^T products are exact in f32; P is
// split into three bf16 terms whose sum is P (`split3`) and P . V is three
// products into one f32 accumulator. Rows as heads waste the tensor cores
// (M = 64 at G 8) but not the bytes: 128 operations a byte at any G up to
// 64, under the card's 295. The chunks merge as the SIMT body's.

#include <cmath>

#include "attention.cuh"

namespace {

using attn::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGChunkMax = 8;    // query heads accumulated at once in P . V
constexpr int kGScore = 4;       // query heads scored at once from K
constexpr int kStages = 4;       // depth of the ring
constexpr int kSubBytes = 8192;  // bytes of a ring stage (a sub-tile)
constexpr int kMergeBatch = 8;   // chunks whose partials load at once

constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }
constexpr int pow2_floor(int x) { return x <= 1 ? 1 : 2 * pow2_floor(x / 2); }

constexpr int kMaxDevices = 64;  // device ordinals `allow_smem` keeps

// Let `kern` take `smem` bytes of dynamic shared memory on the current
// device. The allowance is an attribute of the function in each device's
// context, so `allowed` (the caller's static, one slot a device ordinal)
// keeps the largest size set on each card: a launch on another card sets
// its own. An allowance is only raised: one lowered behind a larger
// block's launch failed that launch with an invalid argument.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && kept) allowed[dev] = smem;
  return err;
}

// A row of width HD (`launch_width`: 16 to 256) over the lanes of a row
// group: LPR lanes (a power of two, at most 32) of EPL elements each --
// one 16-byte vector, or two (32 bytes) for f32 past width 128 -- so a row
// group covers LPR * EPL >= HD columns; at width 192 the last 8 lanes of
// each row group hold no column (kFull false) and load nothing. A
// sub-tile is TR rows: a power of two of rows a row group, as many as
// kSubBytes holds (6 KB at width 192, else 8 KB) -- `tile_rows` in
// kernels/decode_attention/decode_attention.py mirrors it.
template <typename T, int HD>
struct Tile {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int NVEC = HD / VEC;      // 16-byte vectors a row
  static constexpr int LPR = pow2_ceil(NVEC) < 32 ? pow2_ceil(NVEC) : 32;
  static constexpr int EPL = (NVEC + LPR - 1) / LPR * VEC;  // elements a lane
  static constexpr bool kFull = LPR * EPL == HD;
  static constexpr int RPW = 32 / LPR;       // rows a warp holds at once
  static constexpr int NRG = kWarps * RPW;   // row groups in a block
  static constexpr int ROWB = HD * static_cast<int>(sizeof(T));  // bytes a row
  static constexpr int RB = pow2_floor(kSubBytes / ROWB / NRG);  // rows a
                                             // row group a sub-tile
  static constexpr int TR = RB * NRG;          // rows a sub-tile
  static constexpr int kTileBytes = TR * ROWB;  // bytes a sub-tile's load
  static constexpr int NV = RB * kGScore;      // dot products a lane holds
  static_assert(LPR * EPL >= HD && (EPL == VEC || EPL == 2 * VEC),
                "lanes of a row");
  static_assert(kTileBytes <= kSubBytes && TR * ROWB == kTileBytes,
                "tile shape");
  // width 16 in bf16 is a 32-byte row: 256 rows a sub-tile, TMA's widest box
  static_assert(TR <= 256, "a TMA box dimension is at most 256");
};

// heads of a row of the chunk's scores: G rounded up to whole float4s
__host__ __device__ __forceinline__ int score_stride(int G) {
  return (G + 3) / 4 * 4;
}

// Query heads accumulated at once in P . V: 4 when G <= 4 (fewer
// registers), else 8; G > 8 streams V once a group.
inline int head_group(int G) { return G <= 4 ? 4 : kGChunkMax; }

// 128 bytes of alignment slack, the ring, the cross-warp reduction
// [kWarps][GC][HD], q [G][QW] and the chunk's scores
// [split][score_stride(G)] (f32), then the mbarriers full[kStages] and
// empty[kStages]. QW, q's row in shared memory, is HD, or past 256 the row
// rounded up to whole HD-wide column chunks (`q_width`).
template <int HD>
size_t smem_bytes(int G, int split, int QW = HD) {
  const size_t floats = static_cast<size_t>(kWarps) * head_group(G) * HD +
                        static_cast<size_t>(G) * QW +
                        static_cast<size_t>(score_stride(G)) * split;
  return 128 + static_cast<size_t>(kStages) * kSubBytes +
         (sizeof(float) * floats + 7) / 8 * 8 + 16 * kStages;
}

// One 16-byte vector of shared memory widened to f32.
__device__ __forceinline__ void widen(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// EPL elements of a row from shared memory (one or two 16-byte vectors),
// widened to f32
template <int EPL, typename T>
__device__ __forceinline__ void widen_lane(const T* p, float* out) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int u = 0; u < EPL / VEC; ++u) widen(p + u * VEC, out + u * VEC);
}

// q of heads gs .. gs + kGScore - 1 at this lane's dims d0.., zero past G
// and on a lane that holds no column (`on` false)
template <int EPL>
__device__ __forceinline__ void load_q(const float* q_s, int G, int gs,
                                       int d0, int hd, bool on,
                                       float (&qf)[kGScore][EPL]) {
#pragma unroll
  for (int gi = 0; gi < kGScore; ++gi) {
    if (on && gs + gi < G) {
      widen(q_s + (gs + gi) * hd + d0, qf[gi]);
      if constexpr (EPL == 8) widen(q_s + (gs + gi) * hd + d0 + 4, qf[gi] + 4);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[gi][e] = 0.f;
    }
  }
}

// One step of the butterfly reduce-scatter over the lanes of a row group:
// a lane holding C values keeps the half its partner at distance OFF
// sends it (the upper half when its OFF bit is set, which advances `idx`,
// the index of its first value), then recurses with OFF / 2; with one
// value left the steps are plain sums, so LPR / NV lanes end with copies.
template <int C, int OFF, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane,
                                               int& idx) {
  if constexpr (OFF > 0) {
    if constexpr (C > 1) {
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float send = up ? v[i] : v[i + C / 2];
        const float keep = up ? v[i + C / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) idx += C / 2;
      reduce_scatter<C / 2, OFF / 2>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, lane, idx);
    }
  }
}

// q's row in shared memory past 256: the row rounded up to whole column
// chunks of the width HD the block runs at
inline int q_width(int HD, int hd) { return (hd + HD - 1) / HD * HD; }

template <typename T>
constexpr int dtype_of() {
  return sizeof(T) == 2 ? attn::kBF16 : attn::kF32;
}

// The widths a piece of a row past 256 runs at (`attn::piece_cols`): 128
// in bf16, 192 or 256 in f32; only they get a DEEP instantiation
template <typename T>
constexpr bool deep_width(int HD) {
  return sizeof(T) == 2 ? HD == 128 : HD >= 192;
}

// Whether rows up to 256 of element type T take this body: f32 only. bf16
// rows up to 256 take the tensor-core body (`decode_tc_kernel`), so bf16
// gets only the DEEP instantiations of rows past 256.
template <typename T>
constexpr bool simt_rows() {
  return sizeof(T) == 4;
}

// Sub-tile j of a block's sequence -- the K sub-tiles of the `live` rows
// (past 256 each row's n_ck column chunks of HD, chunk fastest), then the
// V sub-tiles of the n_pv rows once for every group of GC heads (past 256
// the piece's HD columns from p0) -- into ring stage j % kStages: one TMA
// load of TR cache rows (rows past S and columns past hd come back zero;
// the rows of a last sub-tile past the live ones arrive and go unused).
__device__ __forceinline__ void issue_subtile(uint32_t ring, uint32_t full,
                                              const CUtensorMap* kmap,
                                              const CUtensorMap* vmap, int j,
                                              int n_k, int n_v, int tr,
                                              int bytes, int start, int kv,
                                              int b, int n_ck, int cw,
                                              int p0) {
  const int s = j % kStages;
  const bool is_k = j < n_k;
  const int r0 = (is_k ? j / n_ck : (j - n_k) % n_v) * tr;
  const int c0 = is_k ? j % n_ck * cw : p0;
  attn::mbar_expect_tx(full + 8 * s, bytes);
  attn::tma_load_4d(ring + s * kSubBytes, is_k ? kmap : vmap, full + 8 * s,
                    c0, kv, start + r0, b);
}

// The merge of a (b, kv, head block, piece), one call a block: the last
// block to finish -- found by an atomic counter after a __threadfence, the
// counter then reset for the next call -- merges the n_live chunks that
// wrote partials in chunk order by the logsumexp rule of the reference's
// sharded combine (decode_attention/ops.py:43-46): m* = max m_i, w_i =
// exp(m_i - m*), l* = sum w_i l_i, acc* = sum w_i acc_i. Each head's m*
// is taken once into `m_s` (Gb floats of shared memory the block is done
// with), then a thread merges 4 consecutive dims of one head, the loads of
// kMergeBatch chunks issued together; the piece's columns only. Which
// block finishes last does not change the result.
template <int THREADS>
__device__ __forceinline__ void merge_last(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, int* __restrict__ counters,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, size_t ck, size_t bk, int n_split, int n_live,
    int G, int g_lo, int Gb, int HD, int hd, int p0, int pw_live, int pc,
    int n_pc, float* m_s) {
  __shared__ int is_last;
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + ck, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t first = bk * n_split;
  for (int i = tid; i < Gb; i += THREADS) {
    const int g = g_lo + i;
    float m = kNegInf;
    for (int c0 = 0; c0 < n_live; c0 += kMergeBatch) {
      float mv[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        mv[u] = c0 + u < n_live
                    ? __ldcg(part_m + ((first + c0 + u) * n_pc + pc) * G + g)
                    : kNegInf;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) m = fmaxf(m, mv[u]);
    }
    m_s[i] = m;
  }
  __syncthreads();
  const int hd4 = pw_live / 4;
  for (int i = tid; i < Gb * hd4; i += THREADS) {
    const int g = g_lo + i / hd4, d = i % hd4 * 4;
    const float m = m_s[i / hd4];
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < n_live; c0 += kMergeBatch) {
      float mv[kMergeBatch], lv[kMergeBatch];
      float4 av[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (c0 + u < n_live) {
          const size_t pi = ((first + c0 + u) * n_pc + pc) * G + g;
          mv[u] = __ldcg(part_m + pi);
          lv[u] = __ldcg(part_l + pi);
          av[u] = __ldcg(
              reinterpret_cast<const float4*>(part_acc + pi * HD + d));
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (c0 + u < n_live) {
          const float w = expf(mv[u] - m);
          l = fmaf(lv[u], w, l);
          a.x = fmaf(av[u].x, w, a.x);
          a.y = fmaf(av[u].y, w, a.y);
          a.z = fmaf(av[u].z, w, a.z);
          a.w = fmaf(av[u].w, w, a.w);
        }
      }
    }
    *reinterpret_cast<float4*>(acc_out + (bk * G + g) * hd + p0 + d) = a;
    if (d == 0 && pc == 0) {
      m_out[bk * G + g] = m;
      l_out[bk * G + g] = l;
    }
  }
  if (tid == 0) counters[ck] = 0;  // ready for the next call
}

// A block: chunk blockIdx.x of S, query heads [g_lo, g_lo + Gb) of KV
// head kv (blockIdx.y = kv * n_hc + head chunk; n_hc is 1 unless G heads
// of width HD outgrow a block's shared memory, `block_heads`), sequence
// blockIdx.z; built at a width HD >= hd: q_s holds zeros past hd, the
// tensor maps fill the cache rows' columns past hd with zeros, the
// partials are HD wide and the merge writes hd columns. EXACT (hd == HD
// and one block of all G heads: every served shape but the wide ones)
// fixes hd and GB when compiling, so that code carries no column or
// head-block arithmetic. DEEP (a row past 256: `attn::piece_cols`) puts
// the row's n_pc column pieces on the grid (blockIdx.y = (kv * n_hc + head
// chunk) * n_pc + piece): a block scores with the whole row -- K read in
// n_ck column chunks of HD, the partial dot products summed in the scores
// -- and accumulates only its piece's pw columns of V (from p0 = piece *
// pw, at width HD >= pw); each piece keeps its own m and l, equal across
// the pieces by construction (the same scores in the same order), and
// piece 0 writes m_out and l_out.
template <typename T, int HD, int GC, bool EXACT, bool DEEP = false>
__global__ void __launch_bounds__(kThreads, 4)
decode_attention_kernel(const T* __restrict__ q,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const int* __restrict__ lengths, int S, int KV, int G,
                        int hd_arg, int gb_arg, int split, float scale,
                        int pw_arg, int n_pc_arg,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l, int* __restrict__ counters,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out) {
  using Tl = Tile<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = attn::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 127u) & ~127u) - raw);  // TMA: 128 B
  static_assert(!(EXACT && DEEP), "a piece is never the whole row");
  const int hd = EXACT ? HD : hd_arg, GB = EXACT ? G : gb_arg;
  const int n_hc = EXACT ? 1 : (G + GB - 1) / GB;
  const int n_pc = DEEP ? n_pc_arg : 1;
  const int n_ck = DEEP ? (hd + HD - 1) / HD : 1;  // K's column chunks
  const int QW = n_ck * HD;                         // q's row in q_s
  const int yb = DEEP ? blockIdx.y / n_pc : blockIdx.y;
  const int pc = DEEP ? blockIdx.y % n_pc : 0;
  const int kv = yb / n_hc, g_lo = yb % n_hc * GB;
  const int Gb = min(GB, G - g_lo);       // this block's query heads
  // this block's columns of the output: [p0, p0 + pw_live)
  const int p0 = DEEP ? pc * pw_arg : 0;
  const int pw_live = DEEP ? min(pw_arg, hd - p0) : hd;
  float* red = reinterpret_cast<float*>(ring + kStages * kSubBytes);
  float* q_s = red + kWarps * GC * HD;  // [Gb][QW]
  float* p_s = q_s + Gb * QW;                // [split][GP]
  const int GP = score_stride(Gb);
  const uint32_t ring_u32 = attn::smem_u32(ring);
  const uint32_t full =
      (attn::smem_u32(p_s + static_cast<size_t>(GP) * split) + 7u) & ~7u;
  const uint32_t empty = full + 8 * kStages;

  const int sp = blockIdx.x, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&vmap)) : "memory");
  }
  int len = lengths[b];
  const bool none_live = len <= 0;  // every score masked: p = exp(0) = 1
  if (len > S) len = S;
  const int start = sp * split;
  const int n = min(split, S - start);
  const size_t bk = static_cast<size_t>(b) * KV + kv;
  // partials of (b, kv, chunk sp, piece pc) and outputs of this block's
  // heads: head g_lo + g of (b, kv)
  const size_t part = (bk * n_split + sp) * n_pc + pc;
  float* pm = part_m + part * G + g_lo;
  float* pl = part_l + part * G + g_lo;
  float* pacc = part_acc + (part * G + g_lo) * HD;

  if (none_live || start < len) {
    const int live = none_live ? 0 : min(len - start, n);
    // rows whose p can be nonzero: all n when nothing is live (p = 1), else
    // the live ones (a masked row's p = exp(NEG_INF - m) is 0)
    const int n_pv = none_live ? n : live;
    const int n_k = (live + Tl::TR - 1) / Tl::TR * n_ck;
    const int n_v = (n_pv + Tl::TR - 1) / Tl::TR;
    const int total = n_k + (Gb + GC - 1) / GC * n_v;
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        attn::mbar_init(full + 8 * s, 1);
        attn::mbar_init(empty + 8 * s, kWarps);  // one arrival a warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    const T* qb = q + (bk * G + g_lo) * hd;
    for (int i = tid; i < Gb * QW; i += kThreads) {
      const int g = i / QW, d = i % QW;
      q_s[i] = d < hd ? attn::to_float(qb[g * hd + d]) : 0.f;
    }
    __syncthreads();  // the barriers are set up and q is in shared memory
    // the first loads after the barrier: the issue may wait for the copy
    // engine while the whole grid's first loads queue, and no other warp
    // should wait with it
    if (tid == 0)
      for (int j = 0; j < min(kStages, total); ++j)
        issue_subtile(ring_u32, full, &kmap, &vmap, j, n_k, n_v, Tl::TR,
                      Tl::kTileBytes, start, kv, b, n_ck, HD, p0);

    const int rg = warp * Tl::RPW + lane / Tl::LPR;  // this lane's row group
    const int d0 = (lane % Tl::LPR) * Tl::EPL;
    const bool on = Tl::kFull || d0 < HD;  // the lane holds columns
    float acc[GC][Tl::EPL];
    for (int j = 0; j < total; ++j) {
      const int s = j % kStages;
      attn::mbar_wait(full + 8 * s, (j / kStages) & 1);
      const T* tile = reinterpret_cast<const T*>(ring + s * kSubBytes);
      if (j < n_k) {
        // scores of the sub-tile's rows: row group rg holds rows
        // rg + i NRG (i < RB); a lane's partial dot products of RB rows x
        // kGScore heads are summed over the row group's LPR lanes by a
        // butterfly reduce-scatter, every lane on every step; past 256 the
        // sub-tile is column chunk ck of its rows, its sums added to the
        // earlier chunks' (the same lane writes a score every chunk)
        const int ck = j % n_ck;
        const int r0 = j / n_ck * Tl::TR, rows = min(Tl::TR, live - r0);
        float kf[Tl::RB][Tl::EPL];
#pragma unroll
        for (int i = 0; i < Tl::RB; ++i) {
          if (on && rg + i * Tl::NRG < rows) {
            widen_lane<Tl::EPL>(tile + (rg + i * Tl::NRG) * HD + d0, kf[i]);
          } else {
#pragma unroll
            for (int e = 0; e < Tl::EPL; ++e) kf[i][e] = 0.f;
          }
        }
        for (int gs = 0; gs < Gb; gs += kGScore) {
          float v[Tl::NV];
          float qf[kGScore][Tl::EPL];
          load_q<Tl::EPL>(q_s + ck * HD, Gb, gs, d0, QW, on, qf);
#pragma unroll
          for (int gi = 0; gi < kGScore; ++gi) {
#pragma unroll
            for (int i = 0; i < Tl::RB; ++i) {
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < Tl::EPL; ++e)
                dot = fmaf(qf[gi][e], kf[i][e], dot);
              v[i * kGScore + gi] = dot;
            }
          }
          int idx = 0;  // first of the values this lane ends up holding
          reduce_scatter<Tl::NV, Tl::LPR / 2>(v, lane, idx);
          constexpr int kHeld = Tl::NV >= Tl::LPR ? Tl::NV / Tl::LPR : 1;
          constexpr int kCopies = Tl::NV >= Tl::LPR ? 1 : Tl::LPR / Tl::NV;
          const bool writer = lane % kCopies == 0;  // one of equal copies
#pragma unroll
          for (int f = 0; f < kHeld; ++f) {
            const int r = rg + (idx + f) / kGScore * Tl::NRG;
            const int g = gs + (idx + f) % kGScore;
            if (writer && r < rows && g < Gb) {
              float* ps = p_s + (r0 + r) * GP + g;
              if constexpr (DEEP) {
                const float x = ck ? *ps + v[f] : v[f];
                *ps = ck == n_ck - 1 ? x * scale : x;
              } else {
                *ps = v[f] * scale;
              }
            }
          }
        }
      } else {
        const int jv = j - n_k, g0 = jv / n_v * GC, jr = jv % n_v;
        const int gn = min(GC, Gb - g0);
        if (jv == 0) {
          // the chunk's softmax statistics, one warp a query head
          __syncthreads();  // every score of the chunk is in p_s
          for (int g = warp; g < Gb; g += kWarps) {
            float* pg = p_s + g;  // row r at pg[r * GP]
            float m = kNegInf, l = 0.f;
            if (none_live) {
              for (int r = lane; r < n; r += 32) pg[r * GP] = 1.f;
              l = static_cast<float>(n);
            } else {
              for (int r = lane; r < live; r += 32) m = fmaxf(m, pg[r * GP]);
#pragma unroll
              for (int off = 16; off > 0; off /= 2)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
              for (int r = lane; r < live; r += 32) {
                const float p = expf(pg[r * GP] - m);
                pg[r * GP] = p;
                l += p;
              }
#pragma unroll
              for (int off = 16; off > 0; off /= 2)
                l += __shfl_xor_sync(0xffffffffu, l, off);
            }
            if (lane == 0) {
              pm[g] = m;
              pl[g] = l;
            }
          }
          __syncthreads();
        }
        if (jr == 0) {
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int e = 0; e < Tl::EPL; ++e) acc[g][e] = 0.f;
        }
        // P . V over the sub-tile's rows: a row group's RB rows (unrolled,
        // so loads can run ahead), p of 4 heads a float4
        const int r0 = jr * Tl::TR, rows = min(Tl::TR, n_pv - r0);
#pragma unroll
        for (int i = 0; i < Tl::RB; ++i) {
          const int r = rg + i * Tl::NRG;
          if (on && r < rows) {
            float vf[Tl::EPL];
            widen_lane<Tl::EPL>(tile + r * HD + d0, vf);
            const float4* pr =
                reinterpret_cast<const float4*>(p_s + (r0 + r) * GP + g0);
#pragma unroll
            for (int h = 0; h < GC / 4; ++h) {
              if (4 * h < gn) {
                const float4 p4 = pr[h];
                const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  if (4 * h + c < gn)
#pragma unroll
                    for (int e = 0; e < Tl::EPL; ++e)
                      acc[4 * h + c][e] = fmaf(p[c], vf[e], acc[4 * h + c][e]);
              }
            }
          }
        }
        if (jr == n_v - 1) {
          // this head group's sums: the row groups of a warp by shuffles,
          // the warps through shared memory, in a fixed order
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int e = 0; e < Tl::EPL; ++e)
#pragma unroll
              for (int off = Tl::LPR; off < 32; off *= 2)
                acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          if (lane < Tl::LPR && on) {
#pragma unroll
            for (int g = 0; g < GC; ++g)
              if (g < gn)
#pragma unroll
                for (int e = 0; e < Tl::EPL; ++e)
                  red[(warp * GC + g) * HD + d0 + e] = acc[g][e];
          }
          __syncthreads();
          for (int i = tid; i < gn * HD; i += kThreads) {
            const int g = i / HD, d = i % HD;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              sum += red[(w * GC + g) * HD + d];
            pacc[(g0 + g) * HD + d] = sum;
          }
          __syncthreads();
        }
      }
      // this warp is done with the stage; thread 0 refills it once all are
      __syncwarp();
      if (lane == 0) attn::mbar_arrive(empty + 8 * s);
      if (tid == 0 && j + kStages < total) {
        attn::mbar_wait(empty + 8 * s, (j / kStages) & 1);
        issue_subtile(ring_u32, full, &kmap, &vmap, j + kStages, n_k, n_v,
                      Tl::TR, Tl::kTileBytes, start, kv, b, n_ck, HD, p0);
      }
    }
  }

  // the last block of this (b, kv, head chunk, piece) merges the chunks
  // that wrote partials; the chunk's scores are done with, and hold the
  // heads' maxima
  merge_last<kThreads>(part_acc, part_m, part_l, counters, acc_out, m_out,
                       l_out, static_cast<size_t>(b) * gridDim.y + blockIdx.y,
                       bk, n_split,
                       none_live ? n_split : (len + split - 1) / split, G,
                       g_lo, Gb, HD, hd, p0, pw_live, pc, n_pc, p_s);
}

template <typename T, int HD, int GC, bool EXACT, bool DEEP>
int launch_kernel(const void* q, const CUtensorMap& km, const CUtensorMap& vm,
                  const int* lengths, int B, int S, int KV, int G, int hd,
                  int GB, int split, float scale, int pw, int n_pc,
                  float* part_acc, float* part_m, float* part_l,
                  int* counters, float* acc, float* m, float* l,
                  cudaStream_t stream) {
  const int n_split = (S + split - 1) / split;
  const int n_hc = (G + GB - 1) / GB;
  const size_t smem =
      smem_bytes<HD>(GB, split, DEEP ? q_width(HD, hd) : HD);
  auto kern = decode_attention_kernel<T, HD, GC, EXACT, DEEP>;
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(n_split, KV * n_hc * n_pc, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), km, vm, lengths, S, KV, G, hd, GB, split,
      scale, pw, n_pc, part_acc, part_m, part_l, counters, acc, m, l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           int B, int S, int S_mem, int KV, int G, int hd, int hd_scale,
           int split, int GB, float* part_acc, float* part_m, float* part_l,
           int* counters, float* acc, float* m, float* l,
           cudaStream_t stream) {
  using Tl = Tile<T, HD>;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t w = static_cast<cuuint64_t>(hd);
  const cuuint64_t dims[4] = {w, static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      w * e, dims[1] * w * e,
      static_cast<cuuint64_t>(S_mem) * dims[1] * w * e};
  const cuuint32_t box[4] = {HD, 1, Tl::TR, 1};
  const CUtensorMapDataType dt = sizeof(T) == 2
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap km, vm;
  int err = attn::make_map(&km, dt, k, 4, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = attn::make_map(&vm, dt, v, 4, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const float scale = attn::head_scale(hd_scale);
  const bool exact = hd == HD && GB == G;
  const int pw = attn::piece_cols(dtype_of<T>(), hd);
  const int n_pc = (hd + pw - 1) / pw;
#define DECODE_KERNEL(GCV, EX, DP)                                            \
  launch_kernel<T, HD, GCV, EX, DP>(q, km, vm, lengths, B, S, KV, G, hd, GB,  \
                                    split, scale, pw, n_pc, part_acc, part_m, \
                                    part_l, counters, acc, m, l, stream)
  if constexpr (deep_width<T>(HD)) {
    if (n_pc > 1)
      return head_group(GB) == 4 ? DECODE_KERNEL(4, false, true)
                                 : DECODE_KERNEL(kGChunkMax, false, true);
  }
  if constexpr (simt_rows<T>()) {
    if (head_group(GB) == 4)
      return exact ? DECODE_KERNEL(4, true, false)
                   : DECODE_KERNEL(4, false, false);
    return exact ? DECODE_KERNEL(kGChunkMax, true, false)
                 : DECODE_KERNEL(kGChunkMax, false, false);
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef DECODE_KERNEL
}

#define DECODE_WIDTHS(X) X(16) X(32) X(64) X(128) X(192) X(256)

template <typename T>
int launch_hd(int hd, int hd_scale, const void* q, const void* k,
              const void* v, const int* lengths, int B, int S, int S_mem,
              int KV, int G, int split, int GB, float* pa, float* pm,
              float* pl, int* counters, float* acc, float* m, float* l,
              cudaStream_t st) {
  switch (attn::launch_width(dtype_of<T>(), hd)) {
#define DECODE_CASE(W)                                                       \
  case W:                                                                    \
    return launch<T, W>(q, k, v, lengths, B, S, S_mem, KV, G, hd, hd_scale, \
                        split, GB, pa, pm, pl, counters, acc, m, l, st);
    DECODE_WIDTHS(DECODE_CASE)
#undef DECODE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks an SM of `kern` with `smem` bytes of dynamic shared
// memory, or minus a CUDA error. It raises the kernel's allowance only:
// `launch_kernel` keeps the largest it set, and an allowance lowered
// behind it failed the next launch of a larger block with an invalid
// argument.
template <typename Kern>
int blocks_of(Kern kern, size_t smem) {
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess &&
      smem > static_cast<size_t>(attr.maxDynamicSharedSizeBytes))
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <typename T, int HD>
int occupancy(int hd, int GB, int split) {
  const bool deep = attn::piece_cols(dtype_of<T>(), hd) < hd;
  const size_t smem =
      smem_bytes<HD>(GB, split, deep ? q_width(HD, hd) : HD);
  const bool four = head_group(GB) == 4;
  if constexpr (deep_width<T>(HD)) {
    if (deep)
      return four ? blocks_of(decode_attention_kernel<T, HD, 4, false, true>,
                              smem)
                  : blocks_of(decode_attention_kernel<T, HD, kGChunkMax,
                                                      false, true>,
                              smem);
  }
  if constexpr (simt_rows<T>()) {
    return four ? blocks_of(decode_attention_kernel<T, HD, 4, true>, smem)
                : blocks_of(decode_attention_kernel<T, HD, kGChunkMax, true>,
                            smem);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int occupancy_hd(int hd, int GB, int split) {
  switch (attn::launch_width(dtype_of<T>(), hd)) {
#define OCC_CASE(W) \
  case W:           \
    return occupancy<T, W>(hd, GB, split);
    DECODE_WIDTHS(OCC_CASE)
#undef OCC_CASE
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 rows up to 256: the tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using attn::mbar_arrive;
using attn::mbar_expect_tx;
using attn::mbar_init;
using attn::mbar_wait;
using attn::smem_u32;

constexpr int kWgHeads = 64;       // query heads a warpgroup: wgmma's M
constexpr int kMaxWgs = 2;         // warpgroups a block: heads a block <= 128
constexpr int kRingBytes = 65536;  // K and V in a block's ring, at most

// Keys a tile at width HD: 64, or 32 past 128, where a thread's HD / 2
// accumulators leave room for 16 scores and three P fragments of 8 (the
// flash body's rule, `key_tile` in flash_attention.cu).
constexpr int key_tile(int HD) { return HD > 128 ? 32 : 64; }

constexpr int clamp_stages(int s) { return s < 2 ? 2 : s > 8 ? 8 : s; }

// Shared memory of a block of NWG warpgroups at width HD, each region
// 1024-byte aligned (the 128-byte swizzle's period): Q [kBoxes][kQRows
// heads][kLine], the ring [kStages] of a K tile and [kStages] of a V tile
// ([kBoxes][KN rows][kLine] each, the flash body's tile layout), then the
// mbarriers full_q, full_k[kStages], full_v[kStages], empty[kStages].
// `tc_smem_bytes` in kernels/decode_attention/decode_attention.py mirrors
// it.
template <int HD, int NWG>
struct Layout {
  static constexpr int KN = key_tile(HD);
  static constexpr int kThreads = NWG * 128;
  static constexpr int kLine = attn::line_bytes(HD);
  static constexpr int kBox = kLine / 2;     // bf16 columns a box
  static constexpr int kBoxes = HD / kBox;   // boxes a row
  static constexpr int kQRows = NWG * kWgHeads;
  static constexpr int kTile = kBoxes * KN * kLine;  // a K or a V tile
  static constexpr int kStages = clamp_stages(kRingBytes / (2 * kTile));
  static constexpr int kK = kBoxes * kQRows * kLine;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kK % 1024 == 0 && kTile % 1024 == 0,
                "regions stay 1024-byte aligned");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// The online softmax of one key tile (keys k0.. of the chunk) over the
// rows r0 / r1 (query heads) a thread holds: keys at or past `live` masked
// to NEG_INF (every live one set to 0 when the sequence has none, so that
// p = 1 as in the reference), the rows' max over the quad of lanes that
// holds a row taken into the running max m (raw scores); sc replaced by p
// = 2^(s c - m c), c = scale * log2(e); l = l * alpha + (this thread's sum
// of p); returns the alphas 2^((m_old - m) c). A chunk's first tile holds
// a live key, so m is finite from it on.
template <int KN>
__device__ __forceinline__ void tile_softmax(float (&sc)[KN / 2], int k0,
                                             int live, bool none_live,
                                             int tig, float c, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  const bool edge = none_live || k0 + KN > live;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    if (edge) {
      const int key = k0 + (j / 4) * 8 + tig * 2 + (j & 1);
      sc[j] = key >= live ? kNegInf : none_live ? 0.f : sc[j];
    }
    if (j & 2) mx1 = fmaxf(mx1, sc[j]); else mx0 = fmaxf(mx0, sc[j]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = attn::fast_exp2((m0 - mn0) * c);
  al1 = attn::fast_exp2((m1 - mn1) * c);
  m0 = mn0;
  m1 = mn1;
  const float o0 = -mn0 * c, o1 = -mn1 * c;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    const float p = attn::fast_exp2(fmaf(sc[j], c, (j & 2) ? o1 : o0));
    if (j & 2) sum1 += p; else sum0 += p;
    sc[j] = p;
  }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
}

// Two p's (f32, in [0, 1]) as three bf16 pairs whose sum is each p: hi =
// bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), each rounded to
// nearest even. The residues are exact in f32 and 3 x 8 significand bits
// cover f32's 24, so hi + mid + lo == p for every p the softmax gives
// (ex2.approx.ftz: 0 or at least 2^-126), but for bits under bf16's
// smallest subnormal, 2^-133 (p < 2^-110: weights of 2^-110 beside the
// chunk's largest, 1); bf16 x bf16 products are exact in f32.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// P as three sets of wgmma A fragments (`split3`), in the layout of
// `attn::pack_p`
template <int KN>
__device__ __forceinline__ void split_p(const float (&sc)[KN / 2],
                                        uint32_t (&pa)[3][KN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], pa[0][kk][i],
             pa[1][kk][i], pa[2][kk][i]);
}

// O += P . V of one key tile as three products, hi then mid then lo, into
// the one f32 accumulator, committed as one group
template <int HD, int KN>
__device__ __forceinline__ void issue_pv3(float (&acc)[HD / 2],
                                          const uint32_t (&pa)[3][KN / 16][4],
                                          uint32_t vt) {
  attn::pv_products<HD, KN>(acc, pa[0], vt);
  attn::pv_products<HD, KN>(acc, pa[1], vt);
  attn::pv_products<HD, KN>(acc, pa[2], vt);
  attn::wgmma_commit();
}

template <int N>
__device__ __forceinline__ void fence_p(uint32_t (&pa)[3][N][4]) {
  attn::fence_regs(pa[0]);
  attn::fence_regs(pa[1]);
  attn::fence_regs(pa[2]);
}

// Key tile t of the block's chunk into ring stage t % kStages: K's and V's
// kBoxes boxes of KN rows from row `start + t KN` of sequence b, KV head
// kv (rows past S and columns past hd come back zero).
template <int HD, int NWG>
__device__ __forceinline__ void issue_tile(const CUtensorMap* kmap,
                                           const CUtensorMap* vmap,
                                           uint32_t sk, uint32_t sv,
                                           uint32_t full_k, uint32_t full_v,
                                           int t, int start, int kv, int b) {
  using Lt = Layout<HD, NWG>;
  const int s = t % Lt::kStages;
  const uint32_t kt = sk + s * Lt::kTile, vt = sv + s * Lt::kTile;
  mbar_expect_tx(full_k + 8 * s, Lt::kTile);
#pragma unroll
  for (int h = 0; h < Lt::kBoxes; ++h)
    attn::tma_load_4d(kt + h * Lt::KN * Lt::kLine, kmap, full_k + 8 * s,
                      h * Lt::kBox, kv, start + t * Lt::KN, b);
  mbar_expect_tx(full_v + 8 * s, Lt::kTile);
#pragma unroll
  for (int h = 0; h < Lt::kBoxes; ++h)
    attn::tma_load_4d(vt + h * Lt::KN * Lt::kLine, vmap, full_v + 8 * s,
                      h * Lt::kBox, kv, start + t * Lt::KN, b);
}

}  // namespace tc

// A block of the tensor-core body: chunk blockIdx.x of S, query heads
// [g_lo, g_lo + Gb) of KV head kv (blockIdx.y = kv * n_hc + head block,
// GB heads a block: all G up to 128), sequence blockIdx.z; NWG warpgroups
// of 64 heads each, built at a width HD >= hd (columns past hd are zeros
// from the tensor maps). Thread 0 loads the block's q rows once (heads
// past G zero-filled) and keeps the chunk's key tiles in flight through
// the ring; every warpgroup, with its 64 heads as wgmma's M, issues S =
// Q . K_t^T together with O += P_{t-1} . V_{t-1} (three bf16 products), takes
// the online softmax of S_t while the second runs, then releases tile
// t - 1's stage, which thread 0 refills, rescales O and splits P_t.
// Heads are rows, so a head's softmax stays within a quad of lanes and P
// stays in registers as the A operand.
template <int HD, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
decode_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const int* __restrict__ lengths, int S, int KV, int G,
                 int hd, int GB, int split, float scale, float scale_log2,
                 float* __restrict__ part_acc, float* __restrict__ part_m,
                 float* __restrict__ part_l, int* __restrict__ counters,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out) {
  using namespace tc;
  using Lt = Layout<HD, NWG>;
  constexpr int KN = Lt::KN, NS = Lt::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sq = (base + 1023u) & ~1023u;
  const uint32_t sk = sq + Lt::kK, sv = sq + Lt::kV;
  const uint32_t full_q = sq + Lt::kBars, full_k = full_q + 8;
  const uint32_t full_v = full_k + 8 * NS, empty = full_v + 8 * NS;
  const int tid = threadIdx.x;
  const int n_hc = (G + GB - 1) / GB;
  const int kv = blockIdx.y / n_hc, g_lo = blockIdx.y % n_hc * GB;
  const int Gb = min(GB, G - g_lo);
  const int sp = blockIdx.x, b = blockIdx.z, n_split = gridDim.x;
  int len = lengths[b];
  const bool none_live = len <= 0;  // every score masked: p = exp(0) = 1
  if (len > S) len = S;
  const int start = sp * split;
  const int n = min(split, S - start);
  const size_t bk = static_cast<size_t>(b) * KV + kv;

  if (none_live || start < len) {
    // keys whose p can be nonzero: all n when nothing is live, else the
    // live ones
    const int live = none_live ? n : min(len - start, n);
    const int n_t = (live + KN - 1) / KN;
    if (tid == 0) {
      mbar_init(full_q, 1);
      for (int s = 0; s < NS; ++s) {
        mbar_init(full_k + 8 * s, 1);
        mbar_init(full_v + 8 * s, 1);
        mbar_init(empty + 8 * s, NWG * 4);  // one arrival a warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(full_q, Lt::kBoxes * Lt::kQRows * Lt::kLine);
#pragma unroll
      for (int h = 0; h < Lt::kBoxes; ++h)
        attn::tma_load_3d(sq + h * Lt::kQRows * Lt::kLine, &qmap, full_q,
                          h * Lt::kBox, g_lo, static_cast<int>(bk));
      for (int t = 0; t < min(NS, n_t); ++t)
        issue_tile<HD, NWG>(&kmap, &vmap, sk, sv, full_k, full_v, t, start,
                            kv, b);
    }

    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int tig = lane % 4;
    const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;  // this thread's heads
    const uint32_t q_rows = sq + wg * kWgHeads * Lt::kLine;
    float acc[HD / 2], sc[KN / 2];
    uint32_t pa[3][KN / 16][4];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0, al1;

    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    attn::wgmma_fence();
    attn::issue_scores<HD, KN, Lt::kQRows>(sc, q_rows, sk);
    attn::wgmma_wait<0>();
    attn::fence_regs(sc);
    tile_softmax<KN>(sc, 0, live, none_live, tig, scale_log2, m0, m1, l0, l1,
                     al0, al1);
    split_p<KN>(sc, pa);
    for (int t = 1; t < n_t; ++t) {
      const int s = t % NS, sp1 = (t - 1) % NS;
      mbar_wait(full_k + 8 * s, (t / NS) & 1);
      mbar_wait(full_v + 8 * sp1, ((t - 1) / NS) & 1);
      attn::wgmma_fence();
      attn::issue_scores<HD, KN, Lt::kQRows>(sc, q_rows, sk + s * Lt::kTile);
      issue_pv3<HD, KN>(acc, pa, sv + sp1 * Lt::kTile);
      attn::wgmma_wait<1>();  // S_t is done, P_{t-1} . V_{t-1} may run on
      attn::fence_regs(sc);
      tile_softmax<KN>(sc, t * KN, live, none_live, tig, scale_log2, m0, m1,
                       l0, l1, al0, al1);
      attn::wgmma_wait<0>();
      attn::fence_regs(acc);
      fence_p(pa);
      // tile t - 1's stage is read; thread 0 refills it once every warp is
      // done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sp1);
      if (tid == 0 && t - 1 + NS < n_t) {
        mbar_wait(empty + 8 * sp1, ((t - 1) / NS) & 1);
        issue_tile<HD, NWG>(&kmap, &vmap, sk, sv, full_k, full_v,
                            t - 1 + NS, start, kv, b);
      }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
      split_p<KN>(sc, pa);
    }
    const int sl = (n_t - 1) % NS;
    mbar_wait(full_v + 8 * sl, ((n_t - 1) / NS) & 1);
    attn::fence_regs(acc);
    attn::wgmma_fence();
    issue_pv3<HD, KN>(acc, pa, sv + sl * Lt::kTile);
    attn::wgmma_wait<0>();
    attn::fence_regs(acc);
    fence_p(pa);

    // this chunk's partials of the block's heads below Gb: m (the raw max
    // times the scale; NEG_INF when nothing is live), l summed over the
    // quad, acc un-normalised, HD wide
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const size_t part = (bk * n_split + sp) * G + g_lo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = wg * kWgHeads + (h ? r1 : r0);
      if (gi >= Gb) continue;
      if (tig == 0) {
        part_m[part + gi] = none_live ? kNegInf : (h ? m1 : m0) * scale;
        part_l[part + gi] = h ? l1 : l0;
      }
      float* row = part_acc + (part + gi) * HD;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        *reinterpret_cast<float2*>(row + nb * 8 + tig * 2) =
            make_float2(acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]);
    }
  }
  // the ring is idle (every tile issued was waited for): its first bytes
  // hold the heads' maxima of the merge
  merge_last<Layout<HD, NWG>::kThreads>(
      part_acc, part_m, part_l, counters, acc_out, m_out, l_out,
      static_cast<size_t>(b) * gridDim.y + blockIdx.y, bk, n_split,
      none_live ? n_split : (len + split - 1) / split, G, g_lo, Gb, HD, hd, 0,
      hd, 0, 1, reinterpret_cast<float*>(smem_raw + (sq - base)));
}

template <int HD, int NWG>
int launch_tc(const void* q, const void* k, const void* v,
              const int* lengths, int B, int S, int S_mem, int KV, int G,
              int hd, int hd_scale, int split, int GB, float* part_acc,
              float* part_m, float* part_l, int* counters, float* acc,
              float* m, float* l, cudaStream_t stream) {
  using Lt = tc::Layout<HD, NWG>;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t w = static_cast<cuuint64_t>(hd);
  const cuuint64_t qdims[3] = {w, static_cast<cuuint64_t>(G),
                               static_cast<cuuint64_t>(B) * KV};
  const cuuint64_t qstrides[2] = {w * e, qdims[1] * w * e};
  const cuuint32_t qbox[3] = {Lt::kBox, Lt::kQRows, 1};
  const cuuint64_t kdims[4] = {w, static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kvstrides[3] = {
      w * e, kdims[1] * w * e,
      static_cast<cuuint64_t>(S_mem) * kdims[1] * w * e};
  const cuuint32_t kbox[4] = {Lt::kBox, 1, Lt::KN, 1};
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle kSw =
      Lt::kLine == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Lt::kLine == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qm, km, vm;
  int err = attn::make_map(&qm, kBf16, q, 3, qdims, qstrides, qbox, kSw);
  if (err == 0)
    err = attn::make_map(&km, kBf16, k, 4, kdims, kvstrides, kbox, kSw);
  if (err == 0)
    err = attn::make_map(&vm, kBf16, v, 4, kdims, kvstrides, kbox, kSw);
  if (err != 0) return err;
  auto kern = decode_tc_kernel<HD, NWG>;
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t cerr = allow_smem(kern, Lt::kSmem, allowed);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_split = (S + split - 1) / split;
  const int n_hc = (G + GB - 1) / GB;
  const double inv = 1.0 / sqrt(static_cast<double>(hd_scale));
  kern<<<dim3(n_split, KV * n_hc, B), Lt::kThreads, Lt::kSmem, stream>>>(
      qm, km, vm, lengths, S, KV, G, hd, GB, split, static_cast<float>(inv),
      static_cast<float>(1.4426950408889634 * inv), part_acc, part_m, part_l,
      counters, acc, m, l);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core body's (shared memory, resident blocks an SM) at width
// HD with NWG warpgroups, or minus a CUDA error as the second
template <int HD, int NWG>
void tc_info(int* out) {
  using Lt = tc::Layout<HD, NWG>;
  auto kern = decode_tc_kernel<HD, NWG>;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, Lt::kThreads, Lt::kSmem);
  out[0] = Lt::kSmem;
  out[1] = err == cudaSuccess ? blocks : -static_cast<int>(err);
  out[2] = Lt::KN;
  out[3] = Lt::kStages;
}

int launch_tc_hd(const void* q, const void* k, const void* v,
                 const int* lengths, int B, int S, int S_mem, int KV, int G,
                 int hd, int hd_scale, int split, int GB, float* pa,
                 float* pm, float* pl, int* counters, float* acc, float* m,
                 float* l, cudaStream_t st) {
  const bool two = GB > tc::kWgHeads;
  switch (attn::launch_width(attn::kBF16, hd)) {
#define TC_CASE(W)                                                           \
  case W:                                                                    \
    return two ? launch_tc<W, 2>(q, k, v, lengths, B, S, S_mem, KV, G, hd,  \
                                 hd_scale, split, GB, pa, pm, pl, counters, \
                                 acc, m, l, st)                             \
               : launch_tc<W, 1>(q, k, v, lengths, B, S, S_mem, KV, G, hd,  \
                                 hd_scale, split, GB, pa, pm, pl, counters, \
                                 acc, m, l, st);
    DECODE_WIDTHS(TC_CASE)
#undef TC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The SIMT body. q (B, KV, G, hd), k / v (B, S, KV, hd), all of `dtype`
// (0 f32, 1 bf16; bf16 only past 256, its rows up to 256 being the
// tensor-core body's), hd any multiple of 8 run at
// `attn::launch_width(dtype, hd)` (the rule of
// `launch_width` in kernels/_attention.py; past 256 n_pc column pieces of
// `attn::piece_cols(dtype, hd)` columns on the grid), the scale
// 1 / sqrt(hd_scale)
// (the true head dim: hd_scale < hd when the wrapper passed a zero-padded
// copy), any G >= 1 in blocks of GB heads (`block_heads`: GB = G unless a
// block's shared memory cannot stage G heads); k and v contiguous within a
// sequence, S_mem
// >= S rows from one sequence's start to the next's (S for a contiguous
// cache, the full length for a slice of S positions of a longer one);
// lengths (B,) int32 -> acc (B, KV, G, hd) f32, m and l (B, KV, G) f32.
// Workspace: part_acc (B, KV, n_split, n_pc * G, launch_width) f32,
// part_m / part_l (B, KV, n_split, n_pc * G) f32 with n_split =
// ceil(S / split) (n_pc = 1 up to 256), and counters (B, KV,
// ceil(G / GB), n_pc) int32, zero before the first call (each call leaves
// them zero).
// One launch on `stream`, no synchronisation. Returns the first CUDA error
// (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* lengths, int dtype, int B, int S,
                            int S_mem, int KV, int G, int hd, int hd_scale,
                            int split, int GB, float* part_acc, float* part_m,
                            float* part_l, int* counters, float* acc,
                            float* m, float* l, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (G < 1 || GB < 1 || GB > G || hd_scale < 1 || hd_scale > hd)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == attn::kBF16)
    return launch_hd<__nv_bfloat16>(hd, hd_scale, q, k, v, lengths, B, S,
                                    S_mem, KV, G, split, GB, part_acc,
                                    part_m, part_l, counters, acc, m, l, st);
  if (dtype == attn::kF32)
    return launch_hd<float>(hd, hd_scale, q, k, v, lengths, B, S, S_mem, KV,
                            G, split, GB, part_acc, part_m, part_l, counters,
                            acc, m, l, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks an SM of the decode kernel at (dtype, hd, GB heads a
// block, split), or minus a CUDA error.
int decode_attention_blocks_per_sm(int dtype, int hd, int GB, int split) {
  if (dtype == attn::kBF16) return occupancy_hd<__nv_bfloat16>(hd, GB, split);
  if (dtype == attn::kF32) return occupancy_hd<float>(hd, GB, split);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core body (bf16, hd a multiple of 8 up to 256): q (B, KV,
// G, hd), the caches and lengths as `decode_attention_launch`'s, GB <= 128
// query heads a block (a balanced head block; two warpgroups past 64), the
// workspace as there with n_pc = 1. One launch on `stream`, no
// synchronisation. Returns the first CUDA error (0 on success).
int decode_attention_tc_launch(const void* q, const void* k, const void* v,
                               const int* lengths, int B, int S, int S_mem,
                               int KV, int G, int hd, int hd_scale,
                               int split, int GB, float* part_acc,
                               float* part_m, float* part_l, int* counters,
                               float* acc, float* m, float* l,
                               void* stream_ptr) {
  if (G < 1 || GB < 1 || GB > G || GB > tc::kMaxWgs * tc::kWgHeads ||
      hd_scale < 1 || hd_scale > hd || split < 1 ||
      attn::piece_cols(attn::kBF16, hd) != hd)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc_hd(q, k, v, lengths, B, S, S_mem, KV, G, hd, hd_scale,
                      split, GB, part_acc, part_m, part_l, counters, acc, m,
                      l, static_cast<cudaStream_t>(stream_ptr));
}

// The tensor-core body at (hd, GB heads a block): out[0] its dynamic
// shared memory, out[1] its resident blocks an SM (or minus a CUDA error),
// out[2] its key tile, out[3] its ring stages. Returns 0, or an error for
// a shape it does not take.
int decode_attention_tc_info(int hd, int GB, int* out) {
  if (GB < 1 || GB > tc::kMaxWgs * tc::kWgHeads ||
      attn::piece_cols(attn::kBF16, hd) != hd)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = GB > tc::kWgHeads;
  switch (attn::launch_width(attn::kBF16, hd)) {
#define INFO_CASE(W)                        \
  case W:                                   \
    if (two) tc_info<W, 2>(out);            \
    else tc_info<W, 1>(out);                \
    return 0;
    DECODE_WIDTHS(INFO_CASE)
#undef INFO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
