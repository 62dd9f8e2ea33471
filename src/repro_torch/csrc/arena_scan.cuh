// The unified arena scan on Hopper: masked dense (and hybrid dense+BM25)
// top-k over a columnar arena, every predicate group of a batch in one pass.
// This header holds the kernels; each mode's C entry point is its own
// translation unit (arena_scan.cu: DENSE, arena_scan_fused.cu: FUSED,
// arena_scan_both.cu: BOTH, arena_scan_probe.cu: PROBE), so the four
// compile in parallel.
//
// Replaces the Pallas TPU kernel `arena_scan_pallas`, resident regime
// (src/repro/kernels/arena_scan/kernel.py:97,171), in four modes:
//   * DENSE  -- ScanSpec(score="dense"), which `filtered_topk_pallas`
//               (G = 1) and `grouped_topk_pallas` (G >= 1) wrap. For each
//               query row b the top-k of q_b . e_n over arena rows n that
//               are live (tenant >= 0) and pass the predicate of group
//               gids[b] (tenant, min_ts, category bitmask, ACL bitmask);
//   * FUSED  -- ScanSpec(score="fused"), the wsum mode of
//               `hybrid_score_pallas` (src/repro/kernels/hybrid_score/
//               hybrid_score.py:55): the top-k of q_b . e_n + bm25_b(n),
//               fusion weights folded into q and qidf by the caller;
//   * BOTH   -- ScanSpec(score="both"), its rrf mode: two lists, the dense
//               one and the bm25 one, each masked before any ranking;
//   * PROBE  -- ScanSpec("dense", slot_lane=True), which `ivf_probe_pallas`
//               (src/repro/kernels/ivf_probe/ivf_probe.py:32) runs: the
//               dense top-k over an IVF candidate set of P rows, one
//               predicate. The Pallas kernel scans a (P, D) copy of the
//               candidates' rows that `_assemble` gathers first; here the
//               gather is folded into the kernel's loads. The candidate
//               vector cand (P,) holds arena slots (the probed clusters'
//               member rows, then the overflow tail); thread r of a tile
//               reads slot = cand[base + r] and loads emb and meta row
//               `slot` in place of row base + r. A slot outside [0, N_arena)
//               is dead (masked), never clamped, and no (P, D) copy is ever
//               written. Selection and merges carry the CANDIDATE POSITION
//               base + r, so ties fall where the reference puts them (the
//               lower position first: clusters ascending, members in fill
//               order, the overflow tail last; a slot listed twice comes out
//               twice); finish maps position -> cand[position].
// Lists are ordered by score descending and then arena index (PROBE:
// candidate position) ascending; slot -1 wherever the score is NEG_INF,
// and (NEG_INF, -1) padding past the fill when k > N.
//
// BM25 over the postings lanes (terms (N, T) int32, -1 empty; lexnorm
// (N, T) f32) against the query terms (qterms (B, QT) int32, -1 padding;
// qidf (B, QT) f32, 0 on padding), in the plain version's fixed order:
// lanes outer, query terms inner, w += hit ? qidf : 0, then
// bm25 += w != 0 ? w * lexnorm : 0 -- every step an _rn intrinsic, so nvcc
// contracts nothing into an FMA and the signal is the plain version's IEEE
// value bit for bit. The fused score is __fadd_rn(dense, bm25).
//
// Schedule. The Pallas kernel walks N in sequence per 8-row B block with a
// running top-k in VMEM. Blocks on Hopper run in parallel and in no order,
// so this kernel uses the streaming scan's schedule instead
// (kernels/arena_scan/ref.py, arena_scan_scan_ref):
//   1. tile_scan: grid (N tiles of 256 rows, B blocks of up to 64 rows).
//      One block covers every query row of a serving batch (B <= 64), so
//      the arena streams from device memory once per batch. Each thread
//      owns one arena row of the tile and accumulates its dot product with
//      every query row of the block in fp32 FMAs (no TF32, no tensor
//      cores), staging D in chunks of 32 through shared memory (16-byte
//      loads when D % 4 == 0); a broadcast float4 of queries feeds 4 FMAs.
//      The lexical modes also stage the tile's T lanes (row-major, odd
//      stride: conflict-free) and the block's query terms in shared memory;
//      after each chunk's dense scores are staged, a loop that is not
//      unrolled (one copy of the BM25 code per chunk, not one per query
//      row) computes a row's BM25 for a query row only where the row passes
//      that row's predicate.
//      The predicate of each row's group is read by direct index from
//      shared memory; rows that fail it, and rows past N, score NEG_INF.
//      Eight query rows at a time go through shared memory, where the
//      tile's top k_loc = min(k, 256) by (score desc, index asc) is
//      selected -- by a warp-wide argmax per row for k_loc <= 32, by a
//      bitonic sort of the whole tile above that -- into a candidate
//      buffer that the wrapper allocates. BOTH selects the dense list and
//      then the bm25 list of the same eight rows; its candidates lie as
//      2B virtual rows (list l, row b at l * B + b). Every NEG_INF entry
//      carries the index INT_MAX, so it sorts after all real entries and
//      padding appended to a sorted list keeps it sorted.
//   2. merge: the sorted per-tile lists merge pairwise, round after round
//      (log2 of the tile count), each output element placed by its rank
//      (a binary search in the partner list), keeping min(k, 2L) per pair.
//      Rows are independent, so BOTH's 2B virtual rows merge unchanged.
//   3. finish: the single remaining list per row, padded to k, with slot -1
//      wherever the score is NEG_INF.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
//   DENSE: max(N * (4D + 16) B / 3.35 TB/s, 2 * B * N * D / 67 TFLOP/s).
//          At N = 2^23, D = 768, B = 32 that is max(7.7 ms, 6.1 ms).
//   lexical modes: the lanes add 8T bytes a row,
//          max(N * (4D + 16 + 8T) B / 3.35 TB/s, the same FLOP bound);
//          at T = 16 that is 26.98 GB, 8.05 ms. The BM25 compares
//          (B * N * T * QT, 1.7e10 at QT = 4) are integer work well under
//          it.
//   PROBE: the P candidates' rows plus their slots,
//          max(P * (4D + 16 + 4) B / 3.35 TB/s, 2 * B * P * D / 67 TFLOP/s).
// Memory-bound, with the fp32 FMA work close behind. PROBE's gathered rows
// are whole 4D-byte rows, so its loads coalesce as DENSE's do.
//
// What this simple design leaves on the table: each FMA group waits on a
// 16-byte broadcast load from shared memory (most likely the shared-memory
// pipe, not the FMA units, sets the pace; a register-tiled micro-tile of
// queries x rows would cut those loads), and each tile's staging waits for
// its loads (no cp.async/TMA pipelining), so it reaches neither rate.
// Tensor cores (wgmma; TF32 or bf16 with an fp32 rescore of the winners)
// and a cheaper selection than the full bitonic sort for k > 32 are later
// work too. The lexical modes compute BM25 serially over T x QT per kept
// (row, query) pair -- a warp runs the loop whenever any of its rows is
// kept, so the divergence costs more than the work -- and stage the lanes
// without overlap; they add 35-43 KB of shared memory a block at T = 16
// (an SM still holds as many blocks at B = 32 and 64). The merge rounds
// add one small launch each.
//
// The paged regime (paged_scan_kernel) replaces the Pallas kernel's
// `_paged_kernel` (src/repro/kernels/arena_scan/kernel.py:121), which keeps
// the arena in HBM and streams pages of `page_rows` rows through a
// double-buffered DMA loop with one running top-k. Here page p of P rows
// (P a runtime argument >= 1; the last page ragged) is one block per B
// block: grid (pages, B blocks). The block walks its page in 256-row
// sub-tiles, selects each sub-tile's top min(L, 256) with the resident
// kernel's selection (in its own shared-memory buffers), folds
// it into one running list of L = min(k, P) entries per query row by rank
// merge, and writes that list as the page's; merge and finish then run
// over the page lists. Scores and lists equal the resident kernel's bit
// for bit (same FMA chain, same BM25, exact total orders). Staging: emb
// and query chunks of 16 dims go through a ring of 2-4 shared-memory
// stages filled by cp.async (16-byte .cg copies when D % 4 == 0, 4-byte
// .ca otherwise, zero-filled past the page, B and D), issued stages - 1
// chunks ahead of the FMAs and across sub-tile boundaries, so a chunk's
// load latency hides behind the previous chunks' FMAs and the sub-tile's
// selection. The emb chunk is stored as float4 columns, so each thread
// reads its row without bank conflicts. Its bound is the resident
// regime's (the same bytes and FMAs: 7.7 ms DENSE, 8.05 ms FUSED / BOTH at
// the shapes above); the candidate buffers shrink from n_tiles to n_pages
// lists a row.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;      // threads per tile block
constexpr int TILE_N = THREADS;   // arena rows per block, one per thread
constexpr int DK = 32;            // D chunk staged through shared memory
constexpr int RS = THREADS / 32;  // query rows selected together, one a warp
constexpr int WARP_K = 32;        // largest k_loc the warp selection takes
constexpr float NEG_INF = -FLT_MAX;
// Index carried by every NEG_INF entry (masked rows, rows past N, merge
// padding): all of them tie and sort after every real entry, so each list
// stays sorted when padding is appended. `finish` turns them into slot -1.
constexpr int NO_ROW = INT_MAX;

// after the dot products the emb staging area holds the selection
// buffers: the dense list's scores and indices, and BOTH's bm25 list's
static_assert(4 * RS * TILE_N <= TILE_N * (DK + 1),
              "selection buffers exceed the emb staging area");

// score modes: ScanSpec(score=...) of the plain version
constexpr int DENSE = 0;   // one list on the dense score
constexpr int FUSED = 1;   // one list on dense + bm25 (wsum)
constexpr int BOTH = 2;    // two lists, dense and bm25 (rrf)
constexpr int PROBE = 3;   // one dense list over slot-indirect candidates

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sort RS rows of TILE_N (score, index) pairs into (score desc, index asc)
// order in place, then write each row's first k_loc entries.
__device__ __noinline__ void sort_and_emit(float* s_sort, int* i_sort,
                                           int k_loc, int b_first, int B,
                                           int tile, int n_tiles,
                                           float* cand_s, int* cand_i) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= TILE_N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < RS * (TILE_N / 2); p += blockDim.x) {
        const int row = p / (TILE_N / 2);
        const int h = p % (TILE_N / 2);
        const int x = 2 * stride * (h / stride) + (h % stride);
        const int y = x + stride;
        float* s = s_sort + row * TILE_N;
        int* ix = i_sort + row * TILE_N;
        const bool up = (x & size) == 0;
        const bool y_first = before(s[y], ix[y], s[x], ix[x]);
        if (y_first == up) {
          const float ts = s[x]; s[x] = s[y]; s[y] = ts;
          const int ti = ix[x]; ix[x] = ix[y]; ix[y] = ti;
        }
      }
      __syncthreads();
    }
  }
  for (int f = tid; f < RS * k_loc; f += blockDim.x) {
    const int j = f / k_loc;
    const int e = f % k_loc;
    const int b = b_first + j;
    if (b < B) {
      const size_t o = ((size_t)b * n_tiles + tile) * k_loc + e;
      cand_s[o] = s_sort[j * TILE_N + e];
      cand_i[o] = i_sort[j * TILE_N + e];
    }
  }
  __syncthreads();
}

// The same result for k_loc <= WARP_K at a fraction of the sort's cost:
// warp w takes row w, each lane holding 8 of its 256 entries in registers,
// and k_loc rounds of a warp-wide argmax in (score desc, index asc) order
// emit the row's best entries in order. Once the best remaining entry is
// NEG_INF every later one is (NEG_INF, NO_ROW) too, so the rest is filled
// without more rounds.
__device__ __noinline__ void select_and_emit(const float* s_sort,
                                             const int* i_sort, int k_loc,
                                             int b_first, int B, int tile,
                                             int n_tiles, float* cand_s,
                                             int* cand_i) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int PER_LANE = TILE_N / 32;
  const float TAKEN = __int_as_float(0xff800000);   // -inf, below NEG_INF
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = b_first + warp;
  if (b < B) {                       // warp-uniform
    float s[PER_LANE];
    int ix[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      s[j] = s_sort[warp * TILE_N + lane + 32 * j];
      ix[j] = i_sort[warp * TILE_N + lane + 32 * j];
    }
    const size_t o = ((size_t)b * n_tiles + tile) * k_loc;
    for (int r = 0; r < k_loc; ++r) {
      float bs = s[0];
      int bi = ix[0];
      int bj = 0;
#pragma unroll
      for (int j = 1; j < PER_LANE; ++j) {
        if (before(s[j], ix[j], bs, bi)) {
          bs = s[j];
          bi = ix[j];
          bj = j;
        }
      }
      float ws = bs;
      int wi = bi;
      int wl = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(FULL, ws, off);
        const int oi = __shfl_xor_sync(FULL, wi, off);
        const int ol = __shfl_xor_sync(FULL, wl, off);
        if (before(os, oi, ws, wi) || (os == ws && oi == wi && ol < wl)) {
          ws = os;
          wi = oi;
          wl = ol;
        }
      }
      if (ws == NEG_INF) {           // no real entry left in this row
        for (int e = r + lane; e < k_loc; e += 32) {
          cand_s[o + e] = NEG_INF;
          cand_i[o + e] = NO_ROW;
        }
        break;
      }
      if (lane == 0) {
        cand_s[o + r] = ws;
        cand_i[o + r] = wi;
      }
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (lane == wl && j == bj) s[j] = TAKEN;
      }
    }
  }
  __syncthreads();
}

// The tile's top k_loc of RS query rows staged in s_sort / i_sort, into
// the candidate buffer: warp selection for small k, the bitonic sort above.
__device__ __forceinline__ void emit(float* s_sort, int* i_sort, int k_loc,
                                     int b_first, int B, int tile,
                                     int n_tiles, float* cand_s,
                                     int* cand_i) {
  if (k_loc <= WARP_K) {
    select_and_emit(s_sort, i_sort, k_loc, b_first, B, tile, n_tiles,
                    cand_s, cand_i);
  } else {
    sort_and_emit(s_sort, i_sort, k_loc, b_first, B, tile, n_tiles, cand_s,
                  cand_i);
  }
}

// BM25 of one arena row (its T lanes: lt term ids, ll lexnorm weights) for
// one query row (QT terms qt with their idf qw), in the plain version's
// order and rounding: lanes outer, query terms inner, the lane product
// select-guarded, each step rounded on its own (no FMA contraction).
__device__ __forceinline__ float bm25_row(const int* lt, const float* ll,
                                          int T, const int* qt,
                                          const float* qw, int QT) {
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const int lane = lt[t];
    float w = 0.f;
    for (int j = 0; j < QT; ++j) w = __fadd_rn(w, lane == qt[j] ? qw[j] : 0.f);
    acc = __fadd_rn(acc, w != 0.f ? __fmul_rn(w, ll[t]) : 0.f);
  }
  return acc;
}

template <int BB, int MODE>
__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                 const int* __restrict__ meta, const int* __restrict__ gids,
                 const int* __restrict__ preds,
                 const int* __restrict__ terms,
                 const float* __restrict__ lexnorm,
                 const int* __restrict__ qterms,
                 const float* __restrict__ qidf,
                 const int* __restrict__ cand, int n_arena, int B, int N,
                 int D, int G, int T, int QT, int k_loc, int n_tiles,
                 float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* e_sh = reinterpret_cast<float*>(smem_raw);     // TILE_N x (DK+1)
  float* q_sh = e_sh + TILE_N * (DK + 1);                // DK x BB
  int* p_sh = reinterpret_cast<int*>(q_sh + DK * BB);    // G x 4
  int* g_sh = p_sh + 4 * G;                              // BB
  // the sort buffers reuse the emb staging area once the dots are done
  float* s_sort = e_sh;                                  // RS x TILE_N
  int* i_sort = reinterpret_cast<int*>(e_sh + RS * TILE_N);
  // BOTH: the bm25 list's buffers, behind the dense list's in the same area
  float* s_lex = e_sh + 2 * RS * TILE_N;                 // RS x TILE_N
  int* i_lex = reinterpret_cast<int*>(e_sh + 3 * RS * TILE_N);
  // lexical modes: the tile's lanes (row-major, odd stride LS so a thread
  // walking its own row hits a distinct bank) and the block's query terms
  const int LS = T | 1;
  int* lt_sh = g_sh + BB;                                // TILE_N x LS
  float* ll_sh = reinterpret_cast<float*>(lt_sh + TILE_N * LS);
  int* qt_sh = reinterpret_cast<int*>(ll_sh + TILE_N * LS);  // BB x QT
  float* qw_sh = reinterpret_cast<float*>(qt_sh + BB * QT);  // BB x QT
  // PROBE: the tile's arena slots (-1 for a dead or padding candidate)
  int* sl_sh = g_sh + BB;                                // TILE_N

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b0 = blockIdx.y * BB;
  const int base = tile * TILE_N;

  for (int i = tid; i < 4 * G; i += THREADS) p_sh[i] = preds[i];
  for (int i = tid; i < BB; i += THREADS) {
    int g;
    if constexpr (MODE == PROBE) {
      g = (b0 + i < B) ? 0 : -1;              // one predicate, no gids
    } else {
      g = (b0 + i < B) ? gids[b0 + i] : -1;
    }
    g_sh[i] = (g >= 0 && g < G) ? g : -1;   // out-of-range ids match nothing
  }
  if constexpr (MODE == PROBE) {
    for (int r = tid; r < TILE_N; r += THREADS) {
      const int slot = base + r < N ? cand[base + r] : -1;
      sl_sh[r] = (slot >= 0 && slot < n_arena) ? slot : -1;
    }
  }
  if constexpr (MODE == FUSED || MODE == BOTH) {
    for (int f = tid; f < TILE_N * T; f += THREADS) {
      const int r = f / T;
      const int t = f % T;
      const bool in = base + r < N;
      const size_t src = (size_t)(base + r) * T + t;
      lt_sh[r * LS + t] = in ? terms[src] : -1;
      ll_sh[r * LS + t] = in ? lexnorm[src] : 0.f;
    }
    for (int i = tid; i < BB * QT; i += THREADS) {
      const int b = b0 + i / QT;
      const size_t src = (size_t)b * QT + i % QT;
      qt_sh[i] = b < B ? qterms[src] : -1;
      qw_sh[i] = b < B ? qidf[src] : 0.f;
    }
  }

  float acc[BB];                   // arena row base + tid, every query row
#pragma unroll
  for (int j = 0; j < BB; ++j) acc[j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    __syncthreads();   // the previous chunk is consumed
    if ((D & 3) == 0) {              // 16-byte loads: rows stay aligned
      for (int f = tid; f < TILE_N * (DK / 4); f += THREADS) {
        const int r = f / (DK / 4);
        const int c = 4 * (f % (DK / 4));
        const int row = MODE == PROBE ? sl_sh[r] : base + r;
        const bool in = MODE == PROBE ? row >= 0 : row < N;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && d0 + c < D)
          v = *reinterpret_cast<const float4*>(emb + (size_t)row * D + d0 + c);
        float* dst = e_sh + r * (DK + 1) + c;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int f = tid; f < TILE_N * DK; f += THREADS) {
        const int r = f / DK;
        const int c = f % DK;
        const int row = MODE == PROBE ? sl_sh[r] : base + r;
        const bool in = MODE == PROBE ? row >= 0 : row < N;
        const int d = d0 + c;
        e_sh[r * (DK + 1) + c] =
            (in && d < D) ? emb[(size_t)row * D + d] : 0.f;
      }
    }
    for (int f = tid; f < BB * DK; f += THREADS) {
      const int bb = f / DK;
      const int c = f % DK;
      const int b = b0 + bb;
      const int d = d0 + c;
      q_sh[c * BB + bb] = (b < B && d < D) ? q[(size_t)b * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < DK; ++dd) {
      const float e = e_sh[tid * (DK + 1) + dd];
      const float4* qv = reinterpret_cast<const float4*>(q_sh + dd * BB);
#pragma unroll
      for (int j = 0; j < BB / 4; ++j) {
        const float4 v = qv[j];
        acc[4 * j + 0] = fmaf(v.x, e, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(v.y, e, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(v.z, e, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(v.w, e, acc[4 * j + 3]);
      }
    }
  }
  __syncthreads();   // every thread is done with e_sh before it is reused

  // 1 << 31 is the sign bit, as uint32 bitmasks require; categories
  // outside [0, 32) match no category set. `row` is what the lists carry:
  // the arena row, or in PROBE the candidate position, whose metadata is
  // arena row sl_sh[tid]
  const int row = base + tid;
  const int src = MODE == PROBE ? sl_sh[tid] : row;
  const bool live_src = MODE == PROBE ? src >= 0 : row < N;
  const int4 m = live_src ? reinterpret_cast<const int4*>(meta)[src]
                          : make_int4(-1, 0, 0, 0);   // dead: never live
  const unsigned cat_bit = ((unsigned)m.z < 32u) ? (1u << m.z) : 0u;

#pragma unroll
  for (int r0 = 0; r0 < BB; r0 += RS) {
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const int g = g_sh[r0 + j];
      int pt = -3, pts = 0;
      unsigned pc = 0u, pa = 0u;
      if (g >= 0) {
        pt = p_sh[4 * g + 0];
        pts = p_sh[4 * g + 1];
        pc = (unsigned)p_sh[4 * g + 2];
        pa = (unsigned)p_sh[4 * g + 3];
      }
      const bool keep = g >= 0 && m.x >= 0 && (pt == -2 || m.x == pt) &&
                        m.y >= pts && (cat_bit & pc) != 0u &&
                        ((unsigned)m.w & pa) != 0u;
      s_sort[j * TILE_N + tid] = keep ? acc[r0 + j] : NEG_INF;
      i_sort[j * TILE_N + tid] = keep ? row : NO_ROW;
    }
    if constexpr (MODE == FUSED || MODE == BOTH) {
      // the lexical stage, in a loop that is not unrolled (one copy of the
      // BM25 loop per chunk): each thread reads back its own column, and a
      // row that failed its predicate (index NO_ROW) skips the BM25
#pragma unroll 1
      for (int j = 0; j < RS; ++j) {
        const int o = j * TILE_N + tid;
        const bool keep = i_sort[o] != NO_ROW;
        const float b25 =
            keep ? bm25_row(lt_sh + tid * LS, ll_sh + tid * LS, T,
                            qt_sh + (r0 + j) * QT, qw_sh + (r0 + j) * QT, QT)
                 : 0.f;
        if constexpr (MODE == FUSED) {
          if (keep) s_sort[o] = __fadd_rn(s_sort[o], b25);
        } else {
          s_lex[o] = keep ? b25 : NEG_INF;
          i_lex[o] = i_sort[o];
        }
      }
    }
    __syncthreads();
    emit(s_sort, i_sort, k_loc, b0 + r0, B, tile, n_tiles, cand_s, cand_i);
    if constexpr (MODE == BOTH) {   // the same rows' bm25 list: list 1
      const size_t list = (size_t)B * n_tiles * k_loc;
      emit(s_lex, i_lex, k_loc, b0 + r0, B, tile, n_tiles, cand_s + list,
           cand_i + list);
    }
  }
}

// One merge round: lists 2p and 2p+1 of every row (each sorted, length L)
// become list p (length L2 = min(k, 2L)). Thread per input element: its
// output position is its rank in the union. Ties between the two lists
// place list 2p's element first, so ranks are unique.
__global__ void merge_kernel(const float* __restrict__ in_s,
                             const int* __restrict__ in_i,
                             float* __restrict__ out_s,
                             int* __restrict__ out_i, int B, int n_in, int L,
                             int n_out, int L2) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_pair = 2 * (size_t)L;
  if (t >= (size_t)B * n_out * per_pair) return;
  const int e = (int)(t % per_pair);
  const size_t rest = t / per_pair;
  const int p = (int)(rest % n_out);
  const int b = (int)(rest / n_out);
  const float* as = in_s + ((size_t)b * n_in + 2 * p) * L;
  const int* ai = in_i + ((size_t)b * n_in + 2 * p) * L;
  float* os = out_s + ((size_t)b * n_out + p) * L2;
  int* oi = out_i + ((size_t)b * n_out + p) * L2;
  if (2 * p + 1 >= n_in) {          // odd list out: copy, pad to L2
    if (e < L) {
      os[e] = as[e];
      oi[e] = ai[e];
    } else if (e < L2) {
      os[e] = NEG_INF;
      oi[e] = NO_ROW;
    }
    return;
  }
  const float* bs = as + L;
  const int* bi = ai + L;
  float s;
  int ix, rank;
  int lo = 0, hi = L;
  if (e < L) {                      // count list-B entries strictly before
    s = as[e];
    ix = ai[e];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(bs[mid], bi[mid], s, ix)) lo = mid + 1; else hi = mid;
    }
    rank = e + lo;
  } else {                          // count list-A entries not after
    const int j = e - L;
    s = bs[j];
    ix = bi[j];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!before(s, ix, as[mid], ai[mid])) lo = mid + 1; else hi = mid;
    }
    rank = j + lo;
  }
  if (rank < L2) {
    os[rank] = s;
    oi[rank] = ix;
  }
}

// The final lists, padded to k. With `cand` (PROBE) the lists carry
// candidate positions and each becomes its arena slot cand[position].
__global__ void finish_kernel(const float* __restrict__ in_s,
                              const int* __restrict__ in_i,
                              const int* __restrict__ cand, int B, int L,
                              int k, float* __restrict__ out_s,
                              int* __restrict__ out_i) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * k) return;
  const int b = (int)(t / k);
  const int j = (int)(t % k);
  float s = NEG_INF;
  int ix = -1;
  if (j < L) {
    s = in_s[(size_t)b * L + j];
    if (s > NEG_INF) {
      ix = in_i[(size_t)b * L + j];
      if (cand != nullptr) ix = cand[ix];
    }
  }
  out_s[t] = s;
  out_i[t] = ix;
}

// ---------------------------------------------------------------------------
// The paged regime: one block per (page, B block), one running list per
// query row, the arena staged through a cp.async ring.
// ---------------------------------------------------------------------------

constexpr int CH = 16;          // D chunk a ring stage holds (divides DK)
constexpr int MAX_STAGES = 4;   // deepest ring the launcher picks
// running lists go to shared memory when both copies fit in this budget
constexpr size_t RUN_SMEM_BUDGET = 24 * 1024;

// Shared-memory layout of paged_scan_kernel, computed alike on the host
// (to size the launch) and on the device (to carve the buffer). Every
// offset is a multiple of 16 bytes.
struct PagedLayout {
  size_t ring, stage, sel, sub, run, preds, gids, lanes, qlex, total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline PagedLayout paged_layout(int BB, int n_lists,
                                                    bool lexical, int G,
                                                    int T, int QT, int L,
                                                    int stages,
                                                    bool run_smem) {
  PagedLayout p;
  p.stage = sizeof(float) * (size_t)(TILE_N + BB) * CH;
  p.ring = 0;
  p.sel = p.ring + (size_t)stages * p.stage;
  p.sub = p.sel + (size_t)n_lists * RS * TILE_N * 8;
  p.run = p.sub + align16((size_t)n_lists * RS * (L < TILE_N ? L : TILE_N) * 8);
  p.preds = p.run + (run_smem ? align16((size_t)2 * n_lists * BB * L * 8) : 0);
  p.gids = p.preds + align16(sizeof(int) * 4 * (size_t)G);
  p.lanes = p.gids + align16(sizeof(int) * (size_t)BB);
  p.qlex = p.lanes + (lexical ? align16((size_t)8 * TILE_N * (T | 1)) : 0);
  p.total = p.qlex + (lexical ? align16((size_t)8 * BB * QT) : 0);
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Fold the first n_rows of RS sorted sub-tile lists (k_sub entries each,
// row stride k_sub) into the running lists `cur` (L entries a row, row
// stride rstride) as `nxt`: the top L of their union, each element placed
// by its rank (a binary search in the other list), the running list's
// element first on an exact tie -- merge_kernel's rule, so ranks are unique.
__device__ __forceinline__ void fold_lists(const float* sub_s,
                                           const int* sub_i, int k_sub,
                                           const float* cur_s,
                                           const int* cur_i, float* nxt_s,
                                           int* nxt_i, size_t rstride, int L,
                                           int n_rows) {
  const int per = L + k_sub;
  for (int f = threadIdx.x; f < RS * per; f += THREADS) {
    const int j = f / per;
    const int e = f % per;
    if (j >= n_rows) break;         // rows ascend with f
    const float* as = cur_s + j * rstride;
    const int* ai = cur_i + j * rstride;
    const float* bs = sub_s + j * k_sub;
    const int* bi = sub_i + j * k_sub;
    float s;
    int ix, rank, lo = 0, hi;
    if (e < L) {                    // count sub entries strictly before
      s = as[e];
      ix = ai[e];
      hi = k_sub;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(bs[mid], bi[mid], s, ix)) lo = mid + 1; else hi = mid;
      }
      rank = e + lo;
    } else {                        // count running entries not after
      const int jj = e - L;
      s = bs[jj];
      ix = bi[jj];
      hi = L;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!before(s, ix, as[mid], ai[mid])) lo = mid + 1; else hi = mid;
      }
      rank = jj + lo;
    }
    if (rank < L) {
      nxt_s[j * rstride + rank] = s;
      nxt_i[j * rstride + rank] = ix;
    }
  }
}

// One block scans rows [page * P, min((page + 1) * P, N)) for query rows
// [b0, b0 + BB) in sub-tiles of TILE_N rows, keeping one running list of
// L = min(k, P) entries per query row (per list in BOTH), and writes it as
// the page's list at (list * B * n_pages + b * n_pages + page) * L of s0.
// The arena's rows (emb chunks of CH dims) and the query chunks stream
// through a ring of `stages` buffers filled by cp.async, `stages - 1`
// chunks ahead of the FMAs, across sub-tile boundaries too; the selection
// and merge buffers have their own space, so the copies in flight never
// land on data in use. Scores are the resident kernel's bit for bit: the
// same fmaf chain with d ascending over D padded to a multiple of DK with
// zeros, the same BM25 and mask stages. Up to BB = 32 the registers are
// capped at 128 a thread so that two blocks share an SM (ptxas spills a
// few bytes); rolling the FMA loop's CH / 4 float4 columns in BOTH keeps
// the compiler from hoisting every query load of the chunk there.
template <int BB, int MODE>
__global__ void __launch_bounds__(THREADS, BB <= 32 ? 2 : 1)
paged_scan_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                  const int* __restrict__ meta, const int* __restrict__ gids,
                  const int* __restrict__ preds,
                  const int* __restrict__ terms,
                  const float* __restrict__ lexnorm,
                  const int* __restrict__ qterms,
                  const float* __restrict__ qidf,
                  const int* __restrict__ cand, int n_arena, int B, int N,
                  int D, int G, int T, int QT, int P, int n_pages, int L,
                  int stages, int run_smem, float* s0, int* i0, float* s1,
                  int* i1) {
  constexpr bool LEX = MODE == FUSED || MODE == BOTH;
  constexpr int NL = MODE == BOTH ? 2 : 1;
  // the FMA loop's float4 columns: unrolled, but rolled in BOTH, whose
  // second list's buffers leave the unrolled loop short of registers
  constexpr int C4_UNROLL = MODE == BOTH ? 1 : CH / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PagedLayout lay =
      paged_layout(BB, NL, LEX, G, T, QT, L, stages, run_smem != 0);
  float* s_sort = reinterpret_cast<float*>(smem_raw + lay.sel);
  int* i_sort = reinterpret_cast<int*>(s_sort + RS * TILE_N);
  float* s_lex = s_sort + 2 * RS * TILE_N;      // BOTH: the bm25 list's
  int* i_lex = reinterpret_cast<int*>(s_sort + 3 * RS * TILE_N);
  const int k_sub = min(L, TILE_N);
  // each sub-tile's selected lists: RS rows of k_sub, the bm25 list's after
  float* sub_s = reinterpret_cast<float*>(smem_raw + lay.sub);
  int* sub_i = reinterpret_cast<int*>(sub_s + NL * RS * k_sub);
  float* sub_ls = sub_s + RS * k_sub;
  int* sub_li = sub_i + RS * k_sub;
  int* p_sh = reinterpret_cast<int*>(smem_raw + lay.preds);
  int* g_sh = reinterpret_cast<int*>(smem_raw + lay.gids);
  const int LS = T | 1;
  int* lt_sh = reinterpret_cast<int*>(smem_raw + lay.lanes);   // TILE_N x LS
  float* ll_sh = reinterpret_cast<float*>(lt_sh + TILE_N * LS);
  int* qt_sh = reinterpret_cast<int*>(smem_raw + lay.qlex);    // BB x QT
  float* qw_sh = reinterpret_cast<float*>(qt_sh + BB * QT);

  const int tid = threadIdx.x;
  const int page = blockIdx.x;
  const int b0 = blockIdx.y * BB;
  const int nb = min(BB, B - b0);                 // real query rows here
  const int page_base = page * P;                 // P * n_pages < 2^31
  const int page_end = (int)min((long long)page_base + P, (long long)N);
  const int n_sub = (page_end - page_base + TILE_N - 1) / TILE_N;
  const int n_ch = ((D + DK - 1) / DK) * (DK / CH);
  const int total = n_sub * n_ch;

  for (int i = tid; i < 4 * G; i += THREADS) p_sh[i] = preds[i];
  for (int i = tid; i < BB; i += THREADS) {
    int g;
    if constexpr (MODE == PROBE) {
      g = (b0 + i < B) ? 0 : -1;
    } else {
      g = (b0 + i < B) ? gids[b0 + i] : -1;
    }
    g_sh[i] = (g >= 0 && g < G) ? g : -1;
  }
  if constexpr (LEX) {
    for (int i = tid; i < BB * QT; i += THREADS) {
      const int b = b0 + i / QT;
      const size_t src = (size_t)b * QT + i % QT;
      qt_sh[i] = b < B ? qterms[src] : -1;
      qw_sh[i] = b < B ? qidf[src] : 0.f;
    }
  }

  // The running lists: both copies in shared memory, or this page's slots
  // of s0 and s1 (the merge rounds' buffers, unused until this kernel
  // ends), started in the one that leaves the last fold's result in s0.
  const size_t g_list = (size_t)B * n_pages * L;  // list stride in s0 / s1
  const size_t g_row = (size_t)n_pages * L;       // row stride in s0 / s1
  const size_t g_off = (size_t)b0 * g_row + (size_t)page * L;
  float *cur_s, *nxt_s;
  int *cur_i, *nxt_i;
  size_t rstride, lstride;
  if (run_smem) {
    cur_s = reinterpret_cast<float*>(smem_raw + lay.run);
    cur_i = reinterpret_cast<int*>(cur_s + NL * BB * L);
    nxt_s = reinterpret_cast<float*>(cur_i + NL * BB * L);
    nxt_i = reinterpret_cast<int*>(nxt_s + NL * BB * L);
    rstride = L;
    lstride = (size_t)BB * L;
  } else {
    const bool odd = n_sub & 1;
    cur_s = (odd ? s1 : s0) + g_off;
    cur_i = (odd ? i1 : i0) + g_off;
    nxt_s = (odd ? s0 : s1) + g_off;
    nxt_i = (odd ? i0 : i1) + g_off;
    rstride = g_row;
    lstride = g_list;
  }
  for (int f = tid; f < NL * nb * L; f += THREADS) {
    const int l = f / (nb * L);
    const int j = (f / L) % nb;
    const size_t o = l * lstride + j * rstride + f % L;
    cur_s[o] = NEG_INF;
    cur_i[o] = NO_ROW;
  }

  // Copy chunk gi (sub-tile gi / n_ch, dims (gi % n_ch) * CH ...) into ring
  // stage gi % stages: emb as float4 column blocks ([c4][row], so thread r
  // reads its row conflict-free), q row-major ([bb][c]), zeros past the
  // page, past B and past D.
  auto issue = [&](int gi) {
    const int base = page_base + (gi / n_ch) * TILE_N;
    const int d0 = (gi % n_ch) * CH;
    float* e_st = reinterpret_cast<float*>(smem_raw + lay.ring +
                                           (size_t)(gi % stages) * lay.stage);
    float* q_st = e_st + TILE_N * CH;
    auto src_row = [&](int r) {     // the arena row of sub-tile row r, or -1
      const int pos = base + r;
      if (pos >= page_end) return -1;
      if constexpr (MODE == PROBE) {
        const int slot = __ldg(cand + pos);
        return (slot >= 0 && slot < n_arena) ? slot : -1;
      } else {
        return pos;
      }
    };
    if ((D & 3) == 0) {             // 16-byte copies: rows stay aligned
      for (int f = tid; f < TILE_N * (CH / 4); f += THREADS) {
        const int r = f / (CH / 4);
        const int c4 = f % (CH / 4);
        const int d = d0 + 4 * c4;
        const int row = src_row(r);
        const bool ok = row >= 0 && d < D;
        cp_async16(e_st + (c4 * TILE_N + r) * 4,
                   ok ? emb + (size_t)row * D + d : emb, ok);
      }
      for (int f = tid; f < BB * (CH / 4); f += THREADS) {
        const int bb = f / (CH / 4);
        const int d = d0 + 4 * (f % (CH / 4));
        const bool ok = b0 + bb < B && d < D;
        cp_async16(q_st + bb * CH + (d - d0),
                   ok ? q + (size_t)(b0 + bb) * D + d : q, ok);
      }
    } else {                        // 4-byte copies
      for (int f = tid; f < TILE_N * CH; f += THREADS) {
        const int r = f / CH;
        const int c = f % CH;
        const int d = d0 + c;
        const int row = src_row(r);
        const bool ok = row >= 0 && d < D;
        cp_async4(e_st + ((c / 4) * TILE_N + r) * 4 + (c & 3),
                  ok ? emb + (size_t)row * D + d : emb, ok);
      }
      for (int f = tid; f < BB * CH; f += THREADS) {
        const int bb = f / CH;
        const int d = d0 + f % CH;
        const bool ok = b0 + bb < B && d < D;
        cp_async4(q_st + bb * CH + (d - d0),
                  ok ? q + (size_t)(b0 + bb) * D + d : q, ok);
      }
    }
  };

  for (int s = 0; s < stages - 1; ++s) {   // prologue: stages - 1 chunks
    if (s < total) issue(s);
    cp_async_commit();                      // empty groups keep the count
  }

  float acc[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) acc[j] = 0.f;

  for (int gi = 0; gi < total; ++gi) {
    cp_async_wait(stages - 2);   // chunk gi has landed (this thread's part)
    __syncthreads();             // ... everyone's; stage gi - 1 is consumed
    if (gi + stages - 1 < total) issue(gi + stages - 1);
    cp_async_commit();
    const int st = gi / n_ch;
    const int c = gi % n_ch;
    const int base = page_base + st * TILE_N;
    if constexpr (LEX) {
      if (c == 0) {              // the sub-tile's lanes, read at its end
        for (int f = tid; f < TILE_N * T; f += THREADS) {
          const int r = f / T;
          const int t = f % T;
          const bool in = base + r < page_end;
          const size_t src = (size_t)(base + r) * T + t;
          lt_sh[r * LS + t] = in ? terms[src] : -1;
          ll_sh[r * LS + t] = in ? lexnorm[src] : 0.f;
        }
      }
    }
    const float4* e4 = reinterpret_cast<const float4*>(
        smem_raw + lay.ring + (size_t)(gi % stages) * lay.stage);
    const float4* q4 = e4 + TILE_N * (CH / 4);
#pragma unroll (C4_UNROLL)
    for (int c4 = 0; c4 < CH / 4; ++c4) {
      const float4 e = e4[c4 * TILE_N + tid];
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const float4 v = q4[j * (CH / 4) + c4];
        acc[j] = fmaf(v.x, e.x, acc[j]);
        acc[j] = fmaf(v.y, e.y, acc[j]);
        acc[j] = fmaf(v.z, e.z, acc[j]);
        acc[j] = fmaf(v.w, e.w, acc[j]);
      }
    }
    if (c != n_ch - 1) continue;   // block-uniform

    // End of a sub-tile: mask, select its top k_sub per query row in place
    // in the selection buffers, fold them into the running lists.
    if constexpr (LEX) __syncthreads();   // the lanes are staged
    const int row = base + tid;
    int src = row;
    bool live_src = row < page_end;
    if constexpr (MODE == PROBE) {
      const int slot = live_src ? __ldg(cand + row) : -1;
      live_src = slot >= 0 && slot < n_arena;
      src = slot;
    }
    const int4 m = live_src ? reinterpret_cast<const int4*>(meta)[src]
                            : make_int4(-1, 0, 0, 0);
    const unsigned cat_bit = ((unsigned)m.z < 32u) ? (1u << m.z) : 0u;
#pragma unroll
    for (int r0 = 0; r0 < BB; r0 += RS) {
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int g = g_sh[r0 + j];
        int pt = -3, pts = 0;
        unsigned pc = 0u, pa = 0u;
        if (g >= 0) {
          pt = p_sh[4 * g + 0];
          pts = p_sh[4 * g + 1];
          pc = (unsigned)p_sh[4 * g + 2];
          pa = (unsigned)p_sh[4 * g + 3];
        }
        const bool keep = g >= 0 && m.x >= 0 && (pt == -2 || m.x == pt) &&
                          m.y >= pts && (cat_bit & pc) != 0u &&
                          ((unsigned)m.w & pa) != 0u;
        s_sort[j * TILE_N + tid] = keep ? acc[r0 + j] : NEG_INF;
        i_sort[j * TILE_N + tid] = keep ? row : NO_ROW;
      }
      if constexpr (LEX) {
#pragma unroll 1
        for (int j = 0; j < RS; ++j) {
          const int o = j * TILE_N + tid;
          const bool keep = i_sort[o] != NO_ROW;
          const float b25 =
              keep ? bm25_row(lt_sh + tid * LS, ll_sh + tid * LS, T,
                              qt_sh + (r0 + j) * QT, qw_sh + (r0 + j) * QT,
                              QT)
                   : 0.f;
          if constexpr (MODE == FUSED) {
            if (keep) s_sort[o] = __fadd_rn(s_sort[o], b25);
          } else {
            s_lex[o] = keep ? b25 : NEG_INF;
            i_lex[o] = i_sort[o];
          }
        }
      }
      __syncthreads();
      // the resident kernel's selection, as a one-tile scan of the rows
      // still real here (<= 0 past them), into the sub-list buffers
      const int rows = nb - r0;
      emit(s_sort, i_sort, k_sub, 0, rows, 0, 1, sub_s, sub_i);
      if constexpr (MODE == BOTH) {
        emit(s_lex, i_lex, k_sub, 0, rows, 0, 1, sub_ls, sub_li);
      }
      const size_t o = (size_t)r0 * rstride;
      fold_lists(sub_s, sub_i, k_sub, cur_s + o, cur_i + o, nxt_s + o,
                 nxt_i + o, rstride, L, rows);
      if constexpr (MODE == BOTH) {
        fold_lists(sub_ls, sub_li, k_sub, cur_s + lstride + o,
                   cur_i + lstride + o, nxt_s + lstride + o,
                   nxt_i + lstride + o, rstride, L, rows);
      }
      __syncthreads();             // the selection buffers are free again
    }
    float* ts = cur_s; cur_s = nxt_s; nxt_s = ts;
    int* ti = cur_i; cur_i = nxt_i; nxt_i = ti;
#pragma unroll
    for (int j = 0; j < BB; ++j) acc[j] = 0.f;
  }
  cp_async_wait(0);                // no copy outlives the block

  if (run_smem) {                  // the page's lists, out to s0
    for (int f = tid; f < NL * nb * L; f += THREADS) {
      const int l = f / (nb * L);
      const int j = (f / L) % nb;
      const int e = f % L;
      const size_t o = g_off + l * g_list + j * g_row + e;
      s0[o] = cur_s[l * lstride + j * rstride + e];
      i0[o] = cur_i[l * lstride + j * rstride + e];
    }
  }
}

struct Lex {                 // the lexical modes' inputs (unused by DENSE)
  const int* terms;
  const float* lexnorm;
  const int* qterms;
  const float* qidf;
  int T, QT;
};

struct Cand {                // PROBE's candidate vector (unused otherwise)
  const int* slots;          // (N,) arena slots of the N candidate rows
  int n_arena;               // arena rows: slots outside [0, n_arena) are dead
};
constexpr Cand kNoCand{nullptr, 0};

template <int BB, int MODE>
cudaError_t launch_tiles(const float* q, const float* emb, const int* meta,
                         const int* gids, const int* preds, const Lex& lx,
                         const Cand& cd, int B, int N, int D, int G,
                         int k_loc, int n_tiles, float* cand_s, int* cand_i,
                         cudaStream_t stream) {
  size_t smem = sizeof(float) * (TILE_N * (DK + 1) + DK * BB) +
                sizeof(int) * (4 * (size_t)G + BB);
  if (MODE == FUSED || MODE == BOTH)
    smem += 8 * ((size_t)TILE_N * (lx.T | 1) + (size_t)BB * lx.QT);
  if (MODE == PROBE) smem += sizeof(int) * TILE_N;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_scan_kernel<BB, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_tiles, (B + BB - 1) / BB);
  tile_scan_kernel<BB, MODE><<<grid, THREADS, smem, stream>>>(
      q, emb, meta, gids, preds, lx.terms, lx.lexnorm, lx.qterms, lx.qidf,
      cd.slots, cd.n_arena, B, N, D, G, lx.T, lx.QT, k_loc, n_tiles, cand_s,
      cand_i);
  return cudaGetLastError();
}

inline int merge_and_finish(int rows, int n, int L, int k, const int* slots,
                            float* s0, int* i0, float* s1, int* i1,
                            float* out_s, int* out_i, cudaStream_t stream);

// tile_scan, the merge rounds and finish over n_lists * B virtual rows.
// N is the rows scanned: the arena's, or PROBE's candidates. Returns the
// first CUDA error (0 on success); does not synchronise.
template <int MODE>
int run_scan(const float* q, const float* emb, const int* meta,
             const int* gids, const int* preds, const Lex& lx,
             const Cand& cd, int B, int N, int D, int G, int k, float* s0,
             int* i0, float* s1, int* i1, float* out_s, int* out_i,
             cudaStream_t stream) {
  const int n_tiles = (N + TILE_N - 1) / TILE_N;
  const int k_loc = k < TILE_N ? k : TILE_N;
  cudaError_t err;
  if (B <= 8) {
    err = launch_tiles<8, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                G, k_loc, n_tiles, s0, i0, stream);
  } else if (B <= 16) {
    err = launch_tiles<16, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                 G, k_loc, n_tiles, s0, i0, stream);
  } else if (B <= 32) {
    err = launch_tiles<32, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                 G, k_loc, n_tiles, s0, i0, stream);
  } else {
    err = launch_tiles<64, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                 G, k_loc, n_tiles, s0, i0, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_and_finish((MODE == BOTH ? 2 : 1) * B, n_tiles, k_loc, k,
                          MODE == PROBE ? cd.slots : nullptr, s0, i0, s1, i1,
                          out_s, out_i, stream);
}

// The merge rounds over n sorted lists of L entries per row (in s0, s1 the
// other buffer) and finish, for `rows` virtual rows; with `slots` (PROBE)
// the lists carry candidate positions that finish maps to arena slots.
inline int merge_and_finish(int rows, int n, int L, int k, const int* slots,
                            float* s0, int* i0, float* s1, int* i1,
                            float* out_s, int* out_i, cudaStream_t stream) {
  cudaError_t err;
  float* cur_s = s0;
  int* cur_i = i0;
  float* nxt_s = s1;
  int* nxt_i = i1;
  while (n > 1) {
    const int n_out = (n + 1) / 2;
    const int L2 = (2 * L < k) ? 2 * L : k;
    const size_t total = (size_t)rows * n_out * 2 * L;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    merge_kernel<<<blocks, 256, 0, stream>>>(cur_s, cur_i, nxt_s, nxt_i, rows,
                                             n, L, n_out, L2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* ts = cur_s; cur_s = nxt_s; nxt_s = ts;
    int* ti = cur_i; cur_i = nxt_i; nxt_i = ti;
    n = n_out;
    L = L2;
  }
  const size_t total = (size_t)rows * k;
  finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      cur_s, cur_i, slots, rows, L, k, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

// Shape of one paged launch: ring depth, where the running lists live and
// the block's shared memory. The deepest ring (2..MAX_STAGES) that keeps
// two blocks on an SM (<= 113 KB each) -- with the running lists in shared
// memory when they fit RUN_SMEM_BUDGET, else (or if that is what it takes)
// in the wrapper's buffers -- and failing that the deepest that fits one.
struct PagedConfig {
  int stages;
  bool run_smem;
  size_t smem;
};

inline bool paged_config(int BB, int mode, int G, int T, int QT, int L,
                         PagedConfig* cfg) {
  const int nl = mode == BOTH ? 2 : 1;
  const bool lex = mode == FUSED || mode == BOTH;
  const bool run_fits = (size_t)2 * nl * BB * L * 8 <= RUN_SMEM_BUDGET;
  const size_t caps[2] = {(size_t)113 * 1024, (size_t)227 * 1024};
  for (const size_t cap : caps) {
    const bool where[2] = {run_fits, false};
    for (const bool run_smem : where) {
      for (int st = MAX_STAGES; st >= 2; --st) {
        const size_t smem =
            paged_layout(BB, nl, lex, G, T, QT, L, st, run_smem).total;
        if (smem <= cap) {
          cfg->stages = st;
          cfg->run_smem = run_smem;
          cfg->smem = smem;
          return true;
        }
      }
    }
  }
  return false;
}

template <int BB, int MODE>
cudaError_t launch_paged(const float* q, const float* emb, const int* meta,
                         const int* gids, const int* preds, const Lex& lx,
                         const Cand& cd, int B, int N, int D, int G, int k,
                         int P, int n_pages, int L, float* s0, int* i0,
                         float* s1, int* i1, cudaStream_t stream) {
  PagedConfig cfg;
  if (!paged_config(BB, MODE, G, lx.T, lx.QT, L, &cfg))
    return cudaErrorInvalidValue;
  if (cfg.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_scan_kernel<BB, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_pages, (B + BB - 1) / BB);
  paged_scan_kernel<BB, MODE><<<grid, THREADS, cfg.smem, stream>>>(
      q, emb, meta, gids, preds, lx.terms, lx.lexnorm, lx.qterms, lx.qidf,
      cd.slots, cd.n_arena, B, N, D, G, lx.T, lx.QT, P, n_pages, L,
      cfg.stages, cfg.run_smem ? 1 : 0, s0, i0, s1, i1);
  return cudaGetLastError();
}

// The paged regime: paged_scan (one list per page and query row), then the
// resident regime's merge rounds and finish over the n_pages page lists.
// Scratch: two buffers of n_lists * B * next_pow2(n_pages) * min(k, P)
// entries. Returns the first CUDA error (0 on success); does not
// synchronise.
template <int MODE>
int run_paged(const float* q, const float* emb, const int* meta,
              const int* gids, const int* preds, const Lex& lx,
              const Cand& cd, int B, int N, int D, int G, int k, int P,
              float* s0, int* i0, float* s1, int* i1, float* out_s,
              int* out_i, cudaStream_t stream) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_pages = (int)(((long long)N + P - 1) / P);
  const int L = k < P ? k : P;
  cudaError_t err;
  if (B <= 8) {
    err = launch_paged<8, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                G, k, P, n_pages, L, s0, i0, s1, i1, stream);
  } else if (B <= 16) {
    err = launch_paged<16, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                 G, k, P, n_pages, L, s0, i0, s1, i1, stream);
  } else if (B <= 32) {
    err = launch_paged<32, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                 G, k, P, n_pages, L, s0, i0, s1, i1, stream);
  } else {
    err = launch_paged<64, MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D,
                                 G, k, P, n_pages, L, s0, i0, s1, i1, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_and_finish((MODE == BOTH ? 2 : 1) * B, n_pages, L, k,
                          MODE == PROBE ? cd.slots : nullptr, s0, i0, s1, i1,
                          out_s, out_i, stream);
}

template <int BB, int MODE>
int paged_occupancy(const PagedConfig& cfg) {
  if (cfg.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_scan_kernel<BB, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
    if (err != cudaSuccess) return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, paged_scan_kernel<BB, MODE>, THREADS, cfg.smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// What a paged launch of these shapes would use: out = {shared memory
// bytes a block, ring stages, running lists in shared memory (0/1), blocks
// an SM holds, pages}. Returns 0, or a CUDA error.
template <int MODE>
int paged_info(int B, int N, int G, int T, int QT, int k, int P, int* out) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int BB = B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
  PagedConfig cfg;
  if (!paged_config(BB, MODE, G, T, QT, k < P ? k : P, &cfg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = BB == 8    ? paged_occupancy<8, MODE>(cfg)
                     : BB == 16 ? paged_occupancy<16, MODE>(cfg)
                     : BB == 32 ? paged_occupancy<32, MODE>(cfg)
                                : paged_occupancy<64, MODE>(cfg);
  if (blocks < 0) {
    const int err = static_cast<int>(cudaGetLastError());
    return err ? err : static_cast<int>(cudaErrorUnknown);
  }
  out[0] = (int)cfg.smem;
  out[1] = cfg.stages;
  out[2] = cfg.run_smem ? 1 : 0;
  out[3] = blocks;
  out[4] = (int)(((long long)N + P - 1) / P);
  return 0;
}

}  // namespace

