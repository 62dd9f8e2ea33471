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
//               member rows, then the overflow tail), as a rule compacted
//               to its live slots on the card first (arena_scan_probe.cu),
//               the count `n_live` left in device memory: the kernel walks
//               cand[0, n_live), its grid sized by P, and a block past
//               n_live writes empty lists and returns. Thread r of a tile
//               reads slot = cand[base + r] once a tile into shared memory,
//               whence the tile's copies take it, and emb and meta row
//               `slot` stand in for row base + r. A slot outside
//               [0, N_arena) is dead (masked, never copied), never clamped,
//               and no (P, D) copy is ever written. Selection and merges
//               carry the CANDIDATE POSITION base + r, so ties fall where
//               the reference puts them (the lower position first: clusters
//               ascending, members in fill order, the overflow tail last; a
//               slot listed twice comes out twice); finish maps position ->
//               cand[position]. The compaction keeps the live positions'
//               order, so the lists equal the padded vector's bit for bit.
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
// value bit for bit. The fused score is __fadd_rn(dense, bm25). Only the
// (row, query) pairs that pass the mask compute it (the epilogue below).
//
// Schedule. The Pallas kernel walks N in sequence per 8-row B block with a
// running top-k in VMEM. Blocks on Hopper run in parallel and in no order,
// so this kernel uses the streaming scan's schedule instead
// (kernels/arena_scan/ref.py, arena_scan_scan_ref):
//   1. tile_scan: grid (N tiles of 256 rows, B blocks of up to BB = 64
//      query rows). One B block covers every query row of a serving batch
//      (B <= 64), so the arena streams from device memory once per batch.
//      A block runs its tile through the score stage and the epilogue
//      below; the tile's top k_loc = min(k, 256) per query row goes to a
//      candidate buffer that the wrapper allocates.
//   2. merge: the sorted per-tile lists merge pairwise, round after round
//      (log2 of the tile count), each output element placed by its rank
//      (a binary search in the partner list), keeping min(k, 2L) per pair.
//      Rows are independent, so BOTH's 2B virtual rows merge unchanged.
//   3. finish: the single remaining list per row, padded to k, with slot -1
//      wherever the score is NEG_INF.
//
// The score stage (scan_block, shared by tile_scan_kernel and
// paged_scan_kernel): fp32 FMAs only -- no TF32, no tensor cores.
//   * Micro-tile. Thread t holds the scores of 4 arena rows x QN = BB / 4
//     query rows in registers: rows rg + 64 i (i < 4) and query rows
//     qg * QN + j (j < QN), rg = 32 ((t / 32) % 2) + t % 32, qg = t / 64.
//     So 64 row groups x 4 query groups make the 256 threads; a warp holds
//     32 row groups and one query group, so its query loads are
//     warp-uniform. Per 4 dims a thread reads 4 + QN float4s from shared
//     memory (12 at BB = 32) for 16 QN FMAs (128). (Larger micro-tiles
//     ran no faster on the card: the FMA loop's own rate is the ceiling,
//     PERF.md.)
//   * Ring. The chunks -- emb [256 rows][CH dims] and the queries [BB][CH]
//     -- stream through a ring of 2-4 shared-memory stages, CH = 32 dims in
//     every mode. One thread issues each chunk as two TMA tile loads
//     (cp.async.bulk.tensor, 2-D tensor maps of emb and q; zeros past N, B
//     and D) landing on the stage's mbarrier, stages - 1 chunks ahead of
//     the FMAs. The emb box uses the TMA's 128-byte swizzle, so eight
//     consecutive rows at one float4 column fall in distinct banks
//     (e_col). PROBE gathers its rows by slot with 16-byte cp.async from
//     every thread (sm_90's TMA has no row gather; one 1-D bulk copy a row
//     a chunk moved the same scattered 128-byte pieces at a lower rate,
//     PERF.md), the tile's slots staged once in shared memory, no dead
//     row copied; D % 4 != 0 takes 4-byte copies in every mode; both write
//     the same swizzled layout and zero-fill past the tile, B and D. (A
//     third ring stage, the selection buffers sharing the ring's memory,
//     and an L2 prefetch of the rows' next chunks bought nothing either.)
//   * Bit identity. Every (row, query) score is one fp32 chain: acc = 0,
//     then acc = fmaf(q[d], e[d], acc) for d ascending over D zero-padded
//     to a multiple of DK = 32. The micro-tile and the ring change which
//     thread holds an accumulator and how the operands arrive, not the
//     chain, so both kernels return the lists of the thread-per-row
//     design before them bit for bit, and the paged lists equal the
//     resident ones.
//
// The epilogue, eight query rows at a time: the micro-tiles holding them
// mask their scores in registers -- the predicate of each query row's
// group read by direct index from shared memory, each arena row's
// metadata from device memory; rows that fail it, and rows past N, score
// NEG_INF with the index INT_MAX -- and store scores and indices into the
// [8][256] selection buffers. The lexical modes then run the lexical
// stage (lexical_stage): the kept (query row, tile row) pairs of the eight
// rows are compacted into one list per row (a warp's ballot and popc per
// row, the block's offsets from the eight counts), and the block's threads
// take the pairs in turn, so BM25 runs for kept pairs only and at full
// width however few they are. A pair reads its row's 64 + 64 bytes of
// lanes straight from device memory in 16-byte read-only loads and its
// query's terms and idf from shared memory (held in registers for QT <=
// 4); FUSED adds the BM25 to the dense score in place, BOTH writes it to
// the bm25 list (whose masked entries the micro-tiles stored as NEG_INF).
// Then the tile's top k_loc by (score desc, index asc) is selected -- by a
// warp-wide argmax per row for k_loc <= 32, by a bitonic sort of the whole
// tile above that. BOTH selects the dense list and then the bm25 list of
// the same eight rows; its candidates lie as 2B virtual rows (list l, row
// b at l * B + b). Every NEG_INF entry carries the index INT_MAX, so it
// sorts after all real entries and padding appended to a sorted list
// keeps it sorted.
//
// Registers and shared memory. Up to BB = 32 both kernels are bounded to
// 128 registers a thread, so two blocks of 256 share an SM; the launcher
// takes the deepest ring (2..4 stages) whose block fits 113 KB (two an
// SM), else the deepest that fits 227 KB (scan_config; arena_scan_info
// reports the choice and the blocks an SM holds).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
//   DENSE: max(N * (4D + 16) B / 3.35 TB/s, 2 * B * N * D / 67 TFLOP/s).
//          At N = 2^23, D = 768, B = 32 that is max(7.7 ms, 6.1 ms): 16
//          FLOP a byte, just under fp32's ridge of 20, so the design has
//          to keep both the FMA pipe and the copies busy at once.
//   lexical modes: the lanes add at most 8T bytes a row,
//          max(N * (4D + 16 + 8T) B / 3.35 TB/s, the same FLOP bound);
//          at T = 16 that is 26.98 GB, 8.05 ms. This design reads a row's
//          lanes only where some query row keeps it, so at low keep rates
//          the bytes fall toward DENSE's (plus 8T for each kept row). The
//          BM25 steps (T * QT a kept pair, at most B * N * T * QT = 1.7e10
//          at QT = 4) are integer and fp32 work well under the bound.
//   PROBE: the P_live live candidates' rows and metadata plus the P
//          slots of the vector, max((P_live * (4D + 16) + 4P) B / 3.35
//          TB/s, 2 * B * P_live * D / 67 TFLOP/s); at the IVF prod shape
//          (P_live 264,707 of 393,216, B 32, D 768) 0.244 ms, by bytes.
//          The design before scored all P rows (padding included: 0.363
//          ms of bytes, 19.3 GFLOP) and reloaded each row's slot every
//          chunk. The gather's scattered 128-byte pieces are what bound
//          it: the copies alone take 0.38 ms of the 0.50 on the live rows,
//          about 2.1 TB/s (PERF.md).
//
// What is left on the table: (1) the FMA loop -- a SIMT fp32 loop reaches
// about two thirds of the datasheet rate on this card, so the FLOP bound
// is not reachable this way; tensor cores (a 3xTF32 split on wgmma, or
// TF32 / bf16 candidates widened and rescored in fp32) would lift that
// ceiling but change the scores' bits (and the paged-vs-resident identity
// with them) unless the rescore restores the fp32 chain; (2) the lexical
// stage's latency -- a pair's lane loads are issued when the block
// reaches it, so a block with few pairs waits on one round trip to device
// memory per eight query rows (the other block on the SM computes
// meanwhile); BOTH's second list costs a second selection; (3) selection
// -- for k > 32 the bitonic sort of the whole tile does far more work
// than k entries need, and the warp argmax takes a share of every tile.
// The merge rounds add one small launch each.
//
// The paged regime (paged_scan_kernel) replaces the Pallas kernel's
// `_paged_kernel` (src/repro/kernels/arena_scan/kernel.py:121), which keeps
// the arena in HBM and streams pages of `page_rows` rows through a
// double-buffered DMA loop with one running top-k. Here page p of P rows
// (P a runtime argument >= 1; the last page ragged) is one block per B
// block: grid (pages, B blocks). The block walks its page in 256-row
// sub-tiles through the same score stage and epilogue -- the ring running
// on across sub-tile boundaries -- selects each sub-tile's top
// min(L, 256) into buffers of its own, folds it into one running list of
// L = min(k, P) entries per query row by rank merge, and writes that list
// as the page's; merge and finish then run over the page lists. Its bound
// is the resident regime's (the same bytes and FMAs); the candidate
// buffers shrink from n_tiles to n_pages lists a row.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "attention.cuh"   // mbarriers, TMA loads, tensor maps

namespace {

constexpr int THREADS = 256;      // threads per block
constexpr int TILE_N = THREADS;   // arena rows a block scores at once
constexpr int DK = 32;            // D is zero-padded to a multiple of DK
constexpr int MR = 4;             // arena rows of a thread's micro-tile
constexpr int NQG = 4;            // query groups: QN = BB / NQG rows each
constexpr int NRG = TILE_N / MR;  // row groups
constexpr int RS = THREADS / 32;  // query rows selected together, one a warp
constexpr int WARP_K = 32;        // largest k_loc the warp selection takes
constexpr int MAX_STAGES = 4;     // deepest ring the launcher picks
// a paged block's running lists go to shared memory when both copies fit
constexpr size_t RUN_SMEM_BUDGET = 24 * 1024;
constexpr float NEG_INF = -FLT_MAX;
// Index carried by every NEG_INF entry (masked rows, rows past N, merge
// padding): all of them tie and sort after every real entry, so each list
// stays sorted when padding is appended. `finish` turns them into slot -1.
constexpr int NO_ROW = INT_MAX;

static_assert(NRG * NQG == THREADS, "the micro-tiles cover the block");
static_assert(NRG == 64 && NQG * 2 == THREADS / 32,
              "two warps a query group, 32 row groups a warp");

// score modes: ScanSpec(score=...) of the plain version
constexpr int DENSE = 0;   // one list on the dense score
constexpr int FUSED = 1;   // one list on dense + bm25 (wsum)
constexpr int BOTH = 2;    // two lists, dense and bm25 (rrf)
constexpr int PROBE = 3;   // one dense list over slot-indirect candidates

// Dims a ring stage holds in every mode: 128-byte rows, DK itself.
constexpr int CH = 32;

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

// The BM25 chain of the plain version, each step rounded on its own (no
// FMA contraction): per lane, w = 0 and then w += hit ? qidf : 0 over the
// query terms in order; per row, acc = 0 and then acc += w != 0 ? w * ln :
// 0 over the lanes in order. lane_w takes four query terms of a lane's w,
// lane_add one lane's product into acc.
__device__ __forceinline__ float lane_w(float w, int lane, int4 qt,
                                        float4 qw) {
  w = __fadd_rn(w, lane == qt.x ? qw.x : 0.f);
  w = __fadd_rn(w, lane == qt.y ? qw.y : 0.f);
  w = __fadd_rn(w, lane == qt.z ? qw.z : 0.f);
  return __fadd_rn(w, lane == qt.w ? qw.w : 0.f);
}

__device__ __forceinline__ float lane_add(float acc, float w, float ln) {
  return __fadd_rn(acc, w != 0.f ? __fmul_rn(w, ln) : 0.f);
}

// BM25 of one arena row for one query row, its lanes read straight from
// device memory in 16-byte pieces of four lanes (ld.global.nc.v4: lt4 / ll4
// the row's term ids and weights, n4 pieces), the query's terms and idf from
// shared memory in pieces of four (nq4 pieces, padded with (-1, 0)). The
// four lanes of a piece keep their own w, so each lane's chain runs over
// the query terms in order whichever loop is outer; a padding term adds
// +0 to w, which leaves it unchanged (w starts at +0 and, under round to
// nearest, is never -0). ONE_PIECE (QT <= 4): the query's terms are read
// once, into registers, for the whole row.
template <bool ONE_PIECE>
__device__ __forceinline__ float bm25_vec(const int4* __restrict__ lt4,
                                          const float4* __restrict__ ll4,
                                          int n4, const int4* qt4,
                                          const float4* qw4, int nq4) {
  int4 q1 = make_int4(0, 0, 0, 0);
  float4 f1 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ONE_PIECE) {
    q1 = qt4[0];
    f1 = qw4[0];
  }
  float acc = 0.f;
#pragma unroll 2
  for (int p = 0; p < n4; ++p) {
    const int4 lt = __ldg(lt4 + p);
    const float4 ll = __ldg(ll4 + p);
    float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f;
    for (int c = 0; c < (ONE_PIECE ? 1 : nq4); ++c) {
      const int4 qt = ONE_PIECE ? q1 : qt4[c];
      const float4 qw = ONE_PIECE ? f1 : qw4[c];
      w0 = lane_w(w0, lt.x, qt, qw);
      w1 = lane_w(w1, lt.y, qt, qw);
      w2 = lane_w(w2, lt.z, qt, qw);
      w3 = lane_w(w3, lt.w, qt, qw);
    }
    acc = lane_add(acc, w0, ll.x);
    acc = lane_add(acc, w1, ll.y);
    acc = lane_add(acc, w2, ll.z);
    acc = lane_add(acc, w3, ll.w);
  }
  return acc;
}

// The same chain one lane at a time (T % 4 != 0, or lanes not 16-byte
// aligned): lt / ll the row's T lanes in device memory, qt / qw the QT
// query terms in shared memory.
__device__ __forceinline__ float bm25_lanes(const int* __restrict__ lt,
                                            const float* __restrict__ ll,
                                            int T, const int* qt,
                                            const float* qw, int QT) {
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const int lane = __ldg(lt + t);
    float w = 0.f;
    for (int j = 0; j < QT; ++j) w = __fadd_rn(w, lane == qt[j] ? qw[j] : 0.f);
    acc = lane_add(acc, w, __ldg(ll + t));
  }
  return acc;
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
// cp.async and the paged regime's rank fold.
// ---------------------------------------------------------------------------

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
// Not inlined: the paged epilogue holds the micro-tile's accumulators, and
// an inlined fold pushed it past the 128 registers that let two blocks
// share an SM (ptxas spilled).
__device__ __noinline__ void fold_lists(const float* sub_s,
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

// ---------------------------------------------------------------------------
// The score stage and the epilogue, shared by the resident and the paged
// kernel.
// ---------------------------------------------------------------------------

// Shared-memory layout of a scan block, computed alike on the host (to
// size the launch) and on the device (to carve the buffer). Offsets count
// from the buffer's first 1024-byte boundary (the TMA swizzle's period;
// `total` includes the slack to reach it): the ring first, each stage the
// emb chunk [TILE_N rows][CH] (TMA-swizzled, e_col) then the query chunk
// [BB][CH], then the other regions at multiples of 16 bytes. `paged` adds
// the sub-tile lists and, with `run_smem`, both copies of the running
// lists; `lexical` the query terms and idf ([BB][QT rounded up to 4]) and
// the pair lists (RS counts, then RS x TILE_N one-byte tile rows); `probe`
// the sub-tile's TILE_N slots. BOTH's selection buffers hold three
// [RS][TILE_N] arrays where its lists share their indices
// (shares_indices: paged), else four.
struct ScanLayout {
  size_t stage, sel, sub, run, preds, gids, slots, qlex, pairs, bars, total;
};

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// A paged BOTH block's two lists share one index buffer when a list holds
// at most WARP_K entries (L; a sub-tile's lists hold min(L, TILE_N)): the
// warp argmax selects them and moves nothing, and both carry the same
// indices. The 8 KB it frees lets the running lists into shared memory at
// BB = 32 (measured: 0.8 ms a batch at 2^15-row pages, PERF.md).
__host__ __device__ constexpr bool shares_indices(int n_lists, bool paged,
                                                  int L) {
  return paged && n_lists == 2 && L <= WARP_K;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t align1024(size_t x) {
  return (x + 1023) & ~(size_t)1023;
}

__host__ __device__ inline ScanLayout scan_layout(int BB, int n_lists,
                                                  bool lexical, bool paged,
                                                  bool probe, int G, int QT,
                                                  int L, int stages,
                                                  bool run_smem) {
  ScanLayout p;
  p.stage = align1024(sizeof(float) * (size_t)(TILE_N + BB) * CH);
  p.sel = (size_t)stages * p.stage;
  p.sub = p.sel + (size_t)n_lists * RS * TILE_N * 8 -
          (shares_indices(n_lists, paged, L) ? (size_t)RS * TILE_N * 4 : 0);
  p.run = p.sub + (paged ? align16((size_t)n_lists * RS *
                                   (L < TILE_N ? L : TILE_N) * 8)
                         : 0);
  p.preds = p.run + (run_smem ? align16((size_t)2 * n_lists * BB * L * 8) : 0);
  p.gids = p.preds + align16(sizeof(int) * 4 * (size_t)G);
  p.slots = p.gids + align16(sizeof(int) * (size_t)BB);
  p.qlex = p.slots + (probe ? align16(sizeof(int) * (size_t)TILE_N) : 0);
  p.pairs = p.qlex + (lexical ? align16((size_t)8 * BB * pad4(QT)) : 0);
  p.bars = p.pairs + (lexical ? align16((size_t)RS * (4 + TILE_N)) : 0);
  p.total = p.bars + align16((size_t)8 * stages) + 1024;
  return p;
}

// One launch's inputs and outputs, passed to the kernels by value.
struct ScanArgs {
  const float* q;          // (B, D)
  const float* emb;        // (n_arena, D)
  const int* meta;         // (n_arena, 4)
  const int* gids;         // (B,); PROBE: unused (one predicate)
  const int* preds;        // (G, 4)
  const int* terms;        // lexical modes: (N, T)
  const float* lexnorm;    // (N, T)
  const int* qterms;       // (B, QT)
  const float* qidf;       // (B, QT)
  const int* cand;         // PROBE: (N,) arena slots of the N candidates
  const int* n_live;       // PROBE: live candidates, a prefix of cand (one
                           // int in device memory), or nullptr: all N
  int n_arena, B, N, D, G, T, QT;
  int L;         // entries a tile's (resident) or a page's (paged) list
  int n_lists;   // tiles (resident) or pages (paged): lists a query row
  int P;         // paged: rows a page
  int stages;    // ring stages
  int run_smem;  // paged: running lists in shared memory (0/1)
  float* s0;     // resident: the tile lists; paged: the page lists
  int* i0;
  float* s1;     // paged: the other merge buffer (running lists when
  int* i1;       //   they do not fit shared memory)
};

// The float4 column that holds dims 4 c4 .. 4 c4 + 3 of row r in a stage's
// emb chunk: the TMA's 128-byte swizzle -- the 16-byte unit c4 XOR bits 0-2
// of the row -- so that eight consecutive rows at one c4 fall in distinct
// banks.
__device__ __forceinline__ int e_col(int r, int c4) {
  return r * (CH / 4) + (c4 ^ (r & 7));
}

// The lexical stage of RS selection rows whose masked scores are staged in
// s_sort / i_sort (an index of NO_ROW marks a masked pair), for the tile
// rows at `base` (lanes: terms / lexnorm, T a row). The kept (selection
// row j, tile row r) pairs are compacted -- warp j ballots over row j's 256
// entries and writes the kept tile rows, ascending, to its list pair_r[j]
// [0, pair_n[j]) -- and then taken in turn: pair p of the lists in (j, r)
// order by thread p mod THREADS, so no warp runs BM25 for a masked pair
// and no lane waits on another's loop. A pair reads its row's lanes from
// device memory (`vec`: 16-byte pieces) and its query row's terms (qt /
// qw, QTP = QT rounded up to 4 a row) from shared memory. FUSED adds the
// BM25 to the dense score in place; BOTH writes it to the bm25 list's
// entry (s_lex, whose masked entries are NEG_INF already).
template <int MODE>
__device__ __forceinline__ void lexical_stage(
    const int* __restrict__ terms, const float* __restrict__ lexnorm, int T,
    int QT, int base, float* s_sort, const int* i_sort, float* s_lex,
    int* pair_n, unsigned char* pair_r, const int* qt, const float* qw,
    int QTP, bool vec) {
  constexpr unsigned FULL = 0xffffffffu;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int n = 0;
#pragma unroll
  for (int c = 0; c < TILE_N / 32; ++c) {
    const int r = 32 * c + lane;
    const bool kept = i_sort[warp * TILE_N + r] != NO_ROW;
    const unsigned bal = __ballot_sync(FULL, kept);
    if (kept)
      pair_r[warp * TILE_N + n + __popc(bal & ((1u << lane) - 1u))] =
          (unsigned char)r;
    n += __popc(bal);
  }
  if (lane == 0) pair_n[warp] = n;
  __syncthreads();               // every list and count is written
  int total = 0;
#pragma unroll
  for (int j = 0; j < RS; ++j) total += pair_n[j];
  int j = 0, start = 0;          // the list holding pair p, its first pair
  for (int p = tid; p < total; p += THREADS) {
    while (p - start >= pair_n[j]) start += pair_n[j++];
    const int r = pair_r[j * TILE_N + p - start];
    const size_t lanes = (size_t)(base + r) * T;
    const int* q_t = qt + j * QTP;
    const float* q_w = qw + j * QTP;
    float b25;
    if (!vec) {
      b25 = bm25_lanes(terms + lanes, lexnorm + lanes, T, q_t, q_w, QT);
    } else if (QTP == 4) {
      b25 = bm25_vec<true>(
          reinterpret_cast<const int4*>(terms + lanes),
          reinterpret_cast<const float4*>(lexnorm + lanes), T / 4,
          reinterpret_cast<const int4*>(q_t),
          reinterpret_cast<const float4*>(q_w), 1);
    } else {
      b25 = bm25_vec<false>(
          reinterpret_cast<const int4*>(terms + lanes),
          reinterpret_cast<const float4*>(lexnorm + lanes), T / 4,
          reinterpret_cast<const int4*>(q_t),
          reinterpret_cast<const float4*>(q_w), QTP / 4);
    }
    const int o = j * TILE_N + r;
    if constexpr (MODE == FUSED) {
      s_sort[o] = __fadd_rn(s_sort[o], b25);
    } else {
      s_lex[o] = b25;
    }
  }
  __syncthreads();               // the lexical scores are in place
}

// One block of either kernel: the score stage and the epilogue over the
// block's 256-row sub-tiles -- resident, its one tile; paged, the
// sub-tiles of page blockIdx.x -- for query rows [b0, b0 + BB). Resident,
// the tile's lists go to the candidate buffer at (list * B * n_tiles + b *
// n_tiles + tile) * k_loc of s0. Paged, one running list of L = min(k, P)
// entries per query row (per list in BOTH) absorbs each sub-tile's lists
// and is written as the page's at (list * B * n_pages + b * n_pages +
// page) * L of s0. The ring runs across sub-tile boundaries; the
// selection, sub-tile and running-list buffers have their own space, so
// copies in flight never land on data in use.
template <int BB, int MODE, bool PAGED>
__device__ __forceinline__ void scan_block(const ScanArgs a,
                                           const CUtensorMap* emb_map,
                                           const CUtensorMap* q_map) {
  constexpr bool LEX = MODE == FUSED || MODE == BOTH;
  constexpr int NL = MODE == BOTH ? 2 : 1;
  constexpr int QN = BB / NQG;          // query rows of a micro-tile
  static_assert(QN * NQG == BB, "BB splits into the query groups");
  // the micro-tile's mask, MR x QN bits
  using KeptBits = typename std::conditional<(MR * QN > 32),
                                             unsigned long long,
                                             unsigned>::type;
  extern __shared__ __align__(16) unsigned char smem_buf[];
  unsigned char* smem_raw =
      smem_buf + ((1024 - (attn::smem_u32(smem_buf) & 1023)) & 1023);
  const ScanLayout lay = scan_layout(BB, NL, LEX, PAGED, MODE == PROBE,
                                     a.G, a.QT, a.L, a.stages,
                                     a.run_smem != 0);
  // the chunks come by TMA (one thread, a 2-D box of each tensor, landing
  // on the stage's mbarrier), except for PROBE's gathered rows and D % 4
  // != 0, which come by cp.async (every thread, waited per thread)
  const bool use_tma = MODE != PROBE && (a.D & 3) == 0;
  const uint32_t bars = attn::smem_u32(smem_raw + lay.bars);
  float* s_sort = reinterpret_cast<float*>(smem_raw + lay.sel);  // RS x TILE_N
  int* i_sort = reinterpret_cast<int*>(s_sort + RS * TILE_N);
  // BOTH: the bm25 list's scores, and its indices (i_sort itself where the
  // lists share them; the micro-tiles then store each index twice, which a
  // branch around the second store would cost a spill in the paged kernel)
  float* s_lex = s_sort + 2 * RS * TILE_N;
  int* i_lex = shares_indices(NL, PAGED, a.L)
                   ? i_sort
                   : reinterpret_cast<int*>(s_sort + 3 * RS * TILE_N);
  const int k_sub = min(a.L, TILE_N);
  // paged: each sub-tile's selected lists, RS rows of k_sub, bm25's after
  float* sub_s = reinterpret_cast<float*>(smem_raw + lay.sub);
  int* sub_i = reinterpret_cast<int*>(sub_s + NL * RS * k_sub);
  float* sub_ls = sub_s + RS * k_sub;
  int* sub_li = sub_i + RS * k_sub;
  int* p_sh = reinterpret_cast<int*>(smem_raw + lay.preds);      // G x 4
  int* g_sh = reinterpret_cast<int*>(smem_raw + lay.gids);       // BB
  // PROBE: the arena slots of the sub-tile being issued (-1: dead)
  int* slot_sh = reinterpret_cast<int*>(smem_raw + lay.slots);   // TILE_N
  const int QTP = pad4(a.QT);
  int* qt_sh = reinterpret_cast<int*>(smem_raw + lay.qlex);      // BB x QTP
  float* qw_sh = reinterpret_cast<float*>(qt_sh + BB * QTP);
  int* pair_n = reinterpret_cast<int*>(smem_raw + lay.pairs);    // RS
  unsigned char* pair_r =                                        // RS x TILE_N
      reinterpret_cast<unsigned char*>(pair_n + RS);
  // the lanes come in 16-byte pieces when rows of T lanes keep them aligned
  // (the test is cheap; without it ptxas spilled in paged BOTH<32>)
  const bool vec_lanes =
      (a.T & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(a.terms) |
        reinterpret_cast<uintptr_t>(a.lexnorm)) & 15) == 0;

  const int tid = threadIdx.x;
  // rows rg + NRG * i, query rows qg * QN + j: a warp holds 32 row groups
  // and one query group
  const int rg = ((tid >> 5) & 1) * 32 + (tid & 31);
  const int qg = tid >> 6;
  const int b0 = blockIdx.y * BB;
  const int nb = min(BB, a.B - b0);           // real query rows here
  // PROBE walks the live prefix of its candidate vector, whose length the
  // compaction kernel left in device memory: the host's bound a.N sizes
  // the grid, and a block wholly past the live count writes empty lists
  int n_rows = a.N;
  if constexpr (MODE == PROBE) {
    if (a.n_live != nullptr) n_rows = min(a.N, max(0, __ldg(a.n_live)));
  }
  // the block's sub-tiles: sub-tile s covers rows [first + s * step, ...)
  // below row_end
  int first, step, row_end, n_sub;
  if constexpr (PAGED) {
    first = blockIdx.x * a.P;                 // P * n_pages < 2^31
    step = TILE_N;
    row_end = (int)min((long long)first + a.P, (long long)n_rows);
    n_sub = (row_end - first + TILE_N - 1) / TILE_N;
  } else {
    first = blockIdx.x * TILE_N;            // one tile a block
    step = TILE_N;
    row_end = n_rows;
    n_sub = 1;
  }
  if (MODE == PROBE && first >= row_end) {  // block-uniform: no live row
    for (int f = tid; f < nb * a.L; f += THREADS) {
      const size_t o = ((size_t)(b0 + f / a.L) * a.n_lists + blockIdx.x) *
                           a.L + f % a.L;
      a.s0[o] = NEG_INF;
      a.i0[o] = NO_ROW;
    }
    return;
  }
  const int n_ch = ((a.D + DK - 1) / DK) * (DK / CH);
  const int total = n_sub * n_ch;

  for (int i = tid; i < 4 * a.G; i += THREADS) p_sh[i] = a.preds[i];
  for (int i = tid; i < BB; i += THREADS) {
    int g;
    if constexpr (MODE == PROBE) {
      g = (b0 + i < a.B) ? 0 : -1;            // one predicate, no gids
    } else {
      g = (b0 + i < a.B) ? a.gids[b0 + i] : -1;
    }
    g_sh[i] = (g >= 0 && g < a.G) ? g : -1;   // out-of-range ids match nothing
  }
  if constexpr (LEX) {            // rows padded with (-1, 0) to QTP terms
    for (int i = tid; i < BB * QTP; i += THREADS) {
      const int b = b0 + i / QTP;
      const int j = i % QTP;
      const bool in = b < a.B && j < a.QT;
      const size_t src = (size_t)b * a.QT + j;
      qt_sh[i] = in ? a.qterms[src] : -1;
      qw_sh[i] = in ? a.qidf[src] : 0.f;
    }
  }

  if (use_tma && tid == 0) {
    for (int st = 0; st < a.stages; ++st) attn::mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are initialised before any wait

  // paged: the running lists, both copies in shared memory, or this page's
  // slots of s0 and s1 (the merge rounds' buffers, unused until this
  // kernel ends), started in the one that leaves the last fold's result in
  // s0
  float *cur_s = nullptr, *nxt_s = nullptr;
  int *cur_i = nullptr, *nxt_i = nullptr;
  size_t rstride = 0, lstride = 0;
  const size_t g_list = (size_t)a.B * a.n_lists * a.L;  // list stride in s0
  const size_t g_row = (size_t)a.n_lists * a.L;         // row stride in s0
  const size_t g_off = (size_t)b0 * g_row + (size_t)blockIdx.x * a.L;
  if constexpr (PAGED) {
    if (a.run_smem) {
      cur_s = reinterpret_cast<float*>(smem_raw + lay.run);
      cur_i = reinterpret_cast<int*>(cur_s + NL * BB * a.L);
      nxt_s = reinterpret_cast<float*>(cur_i + NL * BB * a.L);
      nxt_i = reinterpret_cast<int*>(nxt_s + NL * BB * a.L);
      rstride = a.L;
      lstride = (size_t)BB * a.L;
    } else {
      const bool odd = n_sub & 1;
      cur_s = (odd ? a.s1 : a.s0) + g_off;
      cur_i = (odd ? a.i1 : a.i0) + g_off;
      nxt_s = (odd ? a.s0 : a.s1) + g_off;
      nxt_i = (odd ? a.i0 : a.i1) + g_off;
      rstride = g_row;
      lstride = g_list;
    }
    for (int f = tid; f < NL * nb * a.L; f += THREADS) {
      const int l = f / (nb * a.L);
      const int j = (f / a.L) % nb;
      const size_t o = l * lstride + j * rstride + f % a.L;
      cur_s[o] = NEG_INF;
      cur_i[o] = NO_ROW;
    }
  }

  // The arena row of sub-tile row r at `base`, or -1 (past the sub-tile's
  // end; PROBE: a dead or padding candidate).
  auto src_row = [&](int base, int r) {
    const int pos = base + r;
    if (pos >= row_end) return -1;
    if constexpr (MODE == PROBE) {
      const int slot = __ldg(a.cand + pos);
      return (slot >= 0 && slot < a.n_arena) ? slot : -1;
    } else {
      return pos;
    }
  };
  // A thread's 16-byte copies of a chunk (PROBE's cp.async path): float4
  // column c4 = tid % C4 of tile rows tid / C4 + m * ROW_STEP (m < C4), and
  // of query rows (tid + m * THREADS) / C4 for m < Q_COPIES.
  constexpr int C4 = CH / 4;
  constexpr int ROW_STEP = THREADS / C4;
  constexpr int Q_COPIES = (BB * C4 + THREADS - 1) / THREADS;
  constexpr uint32_t STAGE_TX = sizeof(float) * (TILE_N + BB) * CH;
  const int my_c4 = tid % C4;
  const int my_r = tid / C4;
  // Copy the chunk at dims d0.. of the sub-tile at `base` into ring stage
  // `st`: emb as [row][CH] under the TMA's swizzle (e_col), the queries as
  // [query row][CH]; zeros past the tensors (TMA) or past the sub-tile, B
  // and D (cp.async). Rows past a page's end but inside the arena are
  // copied and masked in the epilogue; PROBE reads its rows' slots from
  // slot_sh, staged once a sub-tile, and copies no dead row.
  auto issue = [&](int base, int d0, int st) {
    float* e_st = reinterpret_cast<float*>(smem_raw +
                                           (size_t)st * lay.stage);
    float* q_st = e_st + TILE_N * CH;
    if (use_tma) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * st;
        attn::mbar_expect_tx(bar, STAGE_TX);
        attn::tma_load_2d(attn::smem_u32(e_st), emb_map, bar, d0, base);
        attn::tma_load_2d(attn::smem_u32(q_st), q_map, bar, d0, b0);
      }
    } else if ((a.D & 3) == 0) {    // PROBE: 16-byte copies of gathered rows
#pragma unroll
      for (int m = 0; m < C4; ++m) {
        const int r = my_r + m * ROW_STEP;
        const int row = slot_sh[r];
        const int d = d0 + 4 * my_c4;
        const bool ok = row >= 0 && d < a.D;
        cp_async16(e_st + 4 * e_col(r, my_c4),
                   ok ? a.emb + (size_t)row * a.D + d : a.emb, ok);
      }
#pragma unroll
      for (int m = 0; m < Q_COPIES; ++m) {
        const int f = tid + m * THREADS;
        const int bb = f / C4;
        const int dq = d0 + 4 * (f % C4);
        if (BB * C4 % THREADS == 0 || f < BB * C4) {
          const bool ok = b0 + bb < a.B && dq < a.D;
          cp_async16(q_st + bb * CH + 4 * (f % C4),
                     ok ? a.q + (size_t)(b0 + bb) * a.D + dq : a.q, ok);
        }
      }
    } else {                        // 4-byte copies
      for (int f = tid; f < TILE_N * CH; f += THREADS) {
        const int r = f / CH;
        const int c = f % CH;
        const int d = d0 + c;
        const int row = MODE == PROBE ? slot_sh[r] : src_row(base, r);
        const bool ok = row >= 0 && d < a.D;
        cp_async4(e_st + 4 * e_col(r, c / 4) + (c & 3),
                  ok ? a.emb + (size_t)row * a.D + d : a.emb, ok);
      }
      for (int f = tid; f < BB * CH; f += THREADS) {
        const int bb = f / CH;
        const int c = f % CH;
        const int d = d0 + c;
        const bool ok = b0 + bb < a.B && d < a.D;
        cp_async4(q_st + bb * CH + c,
                  ok ? a.q + (size_t)(b0 + bb) * a.D + d : a.q, ok);
      }
    }
  };
  // the next chunk to issue (stages - 1 ahead of the one consumed): its
  // sub-tile's first row, its chunk in the sub-tile and its ring stage
  int i_base = first, i_c = 0, i_st = 0, issued = 0;
  auto issue_next = [&]() {
    if (issued < total) {
      if constexpr (MODE == PROBE) {
        // a new sub-tile: its slots, read once (block-uniform; the
        // barriers keep the last sub-tile's copies off the new slots)
        if (i_c == 0) {
          const int slot = src_row(i_base, tid);
          __syncthreads();
          slot_sh[tid] = slot;
          __syncthreads();
        }
      }
      issue(i_base, i_c * CH, i_st);
    }
    if (!use_tma) cp_async_commit();  // empty groups keep the count
    ++issued;
    if (++i_c == n_ch) {
      i_c = 0;
      i_base += step;
    }
    if (++i_st == a.stages) i_st = 0;
  };

  for (int s = 0; s < a.stages - 1; ++s) issue_next();  // the prologue

  float acc[MR][QN];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = 0.f;
  }

  // the chunk consumed: its sub-tile's first row, chunk, ring stage and
  // the parity of the stage's barrier phase
  int base = first, c = 0, c_st = 0;
  uint32_t parity = 0;
  // the micro-tile's emb float4 columns in a stage (64 rows apart)
  int e_off[C4];
#pragma unroll
  for (int c4 = 0; c4 < C4; ++c4) e_off[c4] = e_col(rg, c4);
  for (int gi = 0; gi < total; ++gi) {
    if (use_tma) {                // chunk gi has landed
      attn::mbar_wait(bars + 8 * c_st, parity);
    } else {                      // (this thread's part)
      cp_async_wait(a.stages - 2);
    }
    __syncthreads();              // ... everyone's; stage gi - 1 is consumed
    issue_next();
    // the micro-tile: per float4 column, MR emb float4s and QN query
    // float4s feed 4 MR QN FMAs, each (row, query) chain in d order
    const float4* e4 = reinterpret_cast<const float4*>(
        smem_raw + (size_t)c_st * lay.stage);
    const float4* q4 = e4 + TILE_N * C4 + qg * QN * C4;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4) {
      float4 e[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) e[i] = e4[e_off[c4] + NRG * C4 * i];
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        const float4 v = q4[j * C4 + c4];   // warp-uniform
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          acc[i][j] = fmaf(v.x, e[i].x, acc[i][j]);
          acc[i][j] = fmaf(v.y, e[i].y, acc[i][j]);
          acc[i][j] = fmaf(v.z, e[i].z, acc[i][j]);
          acc[i][j] = fmaf(v.w, e[i].w, acc[i][j]);
        }
      }
    }
    if (++c_st == a.stages) {
      c_st = 0;
      parity ^= 1;
    }
    if (++c != n_ch) continue;     // block-uniform: the sub-tile goes on
    c = 0;

    // End of a sub-tile: eight query rows at a time, the micro-tiles that
    // hold them mask their scores in registers and store them, with the
    // indices the lists carry, into the selection buffer; then the top
    // k_loc (paged: k_sub) is selected and written out (paged: folded into
    // the running lists). The index is the arena row, or in PROBE the
    // candidate position, whose metadata is arena row src_row.
    int4 m[MR];
    unsigned cat_bit[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int src = src_row(base, rg + NRG * i);
      m[i] = src >= 0 ? reinterpret_cast<const int4*>(a.meta)[src]
                      : make_int4(-1, 0, 0, 0);   // dead: never live
      // 1 << 31 is the sign bit, as uint32 bitmasks require; categories
      // outside [0, 32) match no category set
      cat_bit[i] = ((unsigned)m[i].z < 32u) ? (1u << m[i].z) : 0u;
    }
    // The resident kernel takes the micro-tile's whole mask (bit MR j + i
    // for row i, query row j) before any store, so the metadata leaves the
    // registers early (3-4% faster, PERF.md); the paged kernel tests each
    // pair where it stores it (the early mask pushed it past 128 registers).
    KeptBits kept = 0;
    if constexpr (!PAGED) {
#pragma unroll 1
      for (int j = 0; j < QN; ++j) {
        const int g = g_sh[qg * QN + j];
        int pt = -3, pts = 0;
        unsigned pc = 0u, pa = 0u;
        if (g >= 0) {
          pt = p_sh[4 * g + 0];
          pts = p_sh[4 * g + 1];
          pc = (unsigned)p_sh[4 * g + 2];
          pa = (unsigned)p_sh[4 * g + 3];
        }
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const bool keep = g >= 0 && m[i].x >= 0 &&
                            (pt == -2 || m[i].x == pt) && m[i].y >= pts &&
                            (cat_bit[i] & pc) != 0u &&
                            ((unsigned)m[i].w & pa) != 0u;
          kept |= (KeptBits)keep << (MR * j + i);
        }
      }
    }
#pragma unroll 1
    for (int r0 = 0; r0 < nb; r0 += RS) {
      if constexpr (PAGED) {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int jj = qg * QN + j - r0;
          if (jj >= 0 && jj < RS) {
            const int g = g_sh[qg * QN + j];
            int pt = -3, pts = 0;
            unsigned pc = 0u, pa = 0u;
            if (g >= 0) {
              pt = p_sh[4 * g + 0];
              pts = p_sh[4 * g + 1];
              pc = (unsigned)p_sh[4 * g + 2];
              pa = (unsigned)p_sh[4 * g + 3];
            }
#pragma unroll
            for (int i = 0; i < MR; ++i) {
              const bool keep = g >= 0 && m[i].x >= 0 &&
                                (pt == -2 || m[i].x == pt) && m[i].y >= pts &&
                                (cat_bit[i] & pc) != 0u &&
                                ((unsigned)m[i].w & pa) != 0u;
              const int o = jj * TILE_N + rg + NRG * i;
              const int ix = keep ? base + rg + NRG * i : NO_ROW;
              s_sort[o] = keep ? acc[i][j] : NEG_INF;
              i_sort[o] = ix;
              if constexpr (MODE == BOTH) {   // the bm25 list, its BM25 later
                s_lex[o] = NEG_INF;
                i_lex[o] = ix;
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int jj = qg * QN + j - r0;
          if (jj >= 0 && jj < RS) {
#pragma unroll
            for (int i = 0; i < MR; ++i) {
              const bool keep = ((kept >> (MR * j + i)) & 1u) != 0u;
              const int o = jj * TILE_N + rg + NRG * i;
              const int ix = keep ? base + rg + NRG * i : NO_ROW;
              s_sort[o] = keep ? acc[i][j] : NEG_INF;
              i_sort[o] = ix;
              if constexpr (MODE == BOTH) {
                s_lex[o] = NEG_INF;
                i_lex[o] = ix;
              }
            }
          }
        }
      }
      __syncthreads();             // the eight rows' lists are staged
      if constexpr (LEX) {
        lexical_stage<MODE>(a.terms, a.lexnorm, a.T, a.QT, base, s_sort,
                            i_sort, s_lex, pair_n, pair_r, qt_sh + r0 * QTP,
                            qw_sh + r0 * QTP, QTP, vec_lanes);
      }
      if constexpr (PAGED) {
        // the resident kernel's selection, as a one-tile scan of the rows
        // still real here, into the sub-list buffers
        const int rows = nb - r0;
        emit(s_sort, i_sort, k_sub, 0, rows, 0, 1, sub_s, sub_i);
        if constexpr (MODE == BOTH) {
          emit(s_lex, i_lex, k_sub, 0, rows, 0, 1, sub_ls, sub_li);
        }
        const size_t o = (size_t)r0 * rstride;
        fold_lists(sub_s, sub_i, k_sub, cur_s + o, cur_i + o, nxt_s + o,
                   nxt_i + o, rstride, a.L, rows);
        if constexpr (MODE == BOTH) {
          fold_lists(sub_ls, sub_li, k_sub, cur_s + lstride + o,
                     cur_i + lstride + o, nxt_s + lstride + o,
                     nxt_i + lstride + o, rstride, a.L, rows);
        }
        __syncthreads();           // the selection buffers are free again
      } else {
        const int tile = base / TILE_N;
        emit(s_sort, i_sort, a.L, b0 + r0, a.B, tile, a.n_lists, a.s0,
             a.i0);
        if constexpr (MODE == BOTH) {   // the same rows' bm25 list: list 1
          const size_t list = (size_t)a.B * a.n_lists * a.L;
          emit(s_lex, i_lex, a.L, b0 + r0, a.B, tile, a.n_lists,
               a.s0 + list, a.i0 + list);
        }
      }
    }
    if constexpr (PAGED) {
      float* ts = cur_s; cur_s = nxt_s; nxt_s = ts;
      int* ti = cur_i; cur_i = nxt_i; nxt_i = ti;
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
#pragma unroll
      for (int j = 0; j < QN; ++j) acc[i][j] = 0.f;
    }
    base += step;
  }
  if (!use_tma) cp_async_wait(0);  // no copy outlives the block

  if constexpr (PAGED) {
    if (a.run_smem) {              // the page's lists, out to s0
      for (int f = tid; f < NL * nb * a.L; f += THREADS) {
        const int l = f / (nb * a.L);
        const int j = (f / a.L) % nb;
        const int e = f % a.L;
        const size_t o = g_off + l * g_list + j * g_row + e;
        a.s0[o] = cur_s[l * lstride + j * rstride + e];
        a.i0[o] = cur_i[l * lstride + j * rstride + e];
      }
    }
  }
}

// Both kernels are bounded to 128 registers a thread up to BB = 32, so two
// blocks share an SM.
// The tensor maps describe emb (D, rows) and q (D, B) in boxes of
// {CH, TILE_N} and {CH, BB}; PROBE and D % 4 != 0 launches pass them
// unused.
template <int BB, int MODE>
__global__ void __launch_bounds__(THREADS, BB <= 32 ? 2 : 1)
tile_scan_kernel(const ScanArgs a, const __grid_constant__ CUtensorMap emb_map,
                 const __grid_constant__ CUtensorMap q_map) {
  scan_block<BB, MODE, false>(a, &emb_map, &q_map);
}

template <int BB, int MODE>
__global__ void __launch_bounds__(THREADS, BB <= 32 ? 2 : 1)
paged_scan_kernel(const ScanArgs a,
                  const __grid_constant__ CUtensorMap emb_map,
                  const __grid_constant__ CUtensorMap q_map) {
  scan_block<BB, MODE, true>(a, &emb_map, &q_map);
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
  const int* n_live;         // device int: the live prefix of slots (the
                             // compaction's count), or nullptr: all N
};
constexpr Cand kNoCand{nullptr, 0, nullptr};

// Shape of one launch: ring depth, where a paged block's running lists
// live, and the block's shared memory. The deepest ring (2..MAX_STAGES)
// that keeps two blocks on an SM (<= 113 KB each) -- a paged block's
// running lists in shared memory when they fit RUN_SMEM_BUDGET, else (or
// if that is what it takes) in the wrapper's buffers -- and failing that
// the deepest that fits one (<= 227 KB).
struct ScanConfig {
  int stages;
  bool run_smem;
  size_t smem;
};

inline bool scan_config(int BB, int mode, bool paged, int G, int QT, int L,
                        ScanConfig* cfg) {
  const int nl = mode == BOTH ? 2 : 1;
  const bool lex = mode == FUSED || mode == BOTH;
  const bool run_fits =
      paged && (size_t)2 * nl * BB * L * 8 <= RUN_SMEM_BUDGET;
  const size_t caps[2] = {(size_t)113 * 1024, (size_t)227 * 1024};
  for (const size_t cap : caps) {
    const bool where[2] = {run_fits, false};
    for (const bool run_smem : where) {
      for (int st = MAX_STAGES; st >= 2; --st) {
        const size_t smem =
            scan_layout(BB, nl, lex, paged, mode == PROBE, G, QT, L, st,
                        run_smem).total;
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

using ScanKernel = void (*)(ScanArgs, CUtensorMap, CUtensorMap);

template <int BB, int MODE, bool PAGED>
inline ScanKernel scan_kernel() {
  if constexpr (PAGED) {
    return paged_scan_kernel<BB, MODE>;
  } else {
    return tile_scan_kernel<BB, MODE>;
  }
}

// Lets the kernel take `smem` bytes of dynamic shared memory.
template <int BB, int MODE, bool PAGED>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(scan_kernel<BB, MODE, PAGED>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The blocks an SM holds at `smem` bytes a block: > 0, or a CUDA error
// negated.
template <int BB, int MODE, bool PAGED>
int blocks_per_sm(size_t smem) {
  cudaError_t err = allow_smem<BB, MODE, PAGED>(smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, scan_kernel<BB, MODE, PAGED>(), THREADS, smem);
  if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <int BB, int MODE, bool PAGED>
cudaError_t launch_scan(ScanArgs a, cudaStream_t stream) {
  ScanConfig cfg;
  if (!scan_config(BB, MODE, PAGED, a.G, a.QT, a.L, &cfg))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<BB, MODE, PAGED>(cfg.smem);
  if (err != cudaSuccess) return err;
  a.stages = cfg.stages;
  a.run_smem = cfg.run_smem ? 1 : 0;
  CUtensorMap emb_map{}, q_map{};
  if (MODE != PROBE && (a.D & 3) == 0) {   // the chunks come by TMA
    const cuuint64_t e_dims[2] = {(cuuint64_t)a.D, (cuuint64_t)a.N};
    const cuuint64_t q_dims[2] = {(cuuint64_t)a.D, (cuuint64_t)a.B};
    const cuuint64_t stride[1] = {(cuuint64_t)a.D * sizeof(float)};
    const cuuint32_t e_box[2] = {CH, TILE_N};
    const cuuint32_t q_box[2] = {CH, BB};
    int map_err = attn::make_map(&emb_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                 a.emb, 2, e_dims, stride, e_box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (map_err == 0)
      map_err = attn::make_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.q,
                               2, q_dims, stride, q_box,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
    if (map_err != 0) return static_cast<cudaError_t>(map_err);
  }
  const int ny = (a.B + BB - 1) / BB;
  const dim3 grid(a.n_lists, ny);     // a block a tile, or a page
  const ScanKernel kern = scan_kernel<BB, MODE, PAGED>();
  kern<<<grid, THREADS, cfg.smem, stream>>>(a, emb_map, q_map);
  return cudaGetLastError();
}

inline int merge_and_finish(int rows, int n, int L, int k, const int* slots,
                            float* s0, int* i0, float* s1, int* i1,
                            float* out_s, int* out_i, cudaStream_t stream);

// The scan kernel, then the merge rounds and finish over n_lists * B
// virtual rows. P == 0: the resident regime (n_tiles lists of min(k, 256)
// a row); P >= 1: the paged regime (n_pages lists of min(k, P)). N is the
// rows scanned: the arena's, or PROBE's candidates. Scratch: two buffers
// of n_lists * B * next_pow2(lists) * L entries. Returns the first CUDA
// error (0 on success); does not synchronise.
template <int MODE>
int run_scan(const float* q, const float* emb, const int* meta,
             const int* gids, const int* preds, const Lex& lx,
             const Cand& cd, int B, int N, int D, int G, int k, int P,
             float* s0, int* i0, float* s1, int* i1, float* out_s,
             int* out_i, cudaStream_t stream) {
  if (P < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool paged = P > 0;
  const int tile = paged ? P : TILE_N;
  const int n_lists = (int)(((long long)N + tile - 1) / tile);
  const int L = k < tile ? k : tile;
  const ScanArgs a{q, emb, meta, gids, preds, lx.terms, lx.lexnorm,
                   lx.qterms, lx.qidf, cd.slots, cd.n_live, cd.n_arena, B,
                   N, D, G, lx.T, lx.QT, L, n_lists, P, 0, 0, s0, i0, s1,
                   i1};
  cudaError_t err;
  if (B <= 8) {
    err = paged ? launch_scan<8, MODE, true>(a, stream)
                : launch_scan<8, MODE, false>(a, stream);
  } else if (B <= 16) {
    err = paged ? launch_scan<16, MODE, true>(a, stream)
                : launch_scan<16, MODE, false>(a, stream);
  } else if (B <= 32) {
    err = paged ? launch_scan<32, MODE, true>(a, stream)
                : launch_scan<32, MODE, false>(a, stream);
  } else {
    err = paged ? launch_scan<64, MODE, true>(a, stream)
                : launch_scan<64, MODE, false>(a, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_and_finish((MODE == BOTH ? 2 : 1) * B, n_lists, L, k,
                          MODE == PROBE ? cd.slots : nullptr, s0, i0, s1, i1,
                          out_s, out_i, stream);
}

// The paged regime's entry: run_scan with page_rows >= 1.
template <int MODE>
int run_paged(const float* q, const float* emb, const int* meta,
              const int* gids, const int* preds, const Lex& lx,
              const Cand& cd, int B, int N, int D, int G, int k, int P,
              float* s0, int* i0, float* s1, int* i1, float* out_s,
              int* out_i, cudaStream_t stream) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run_scan<MODE>(q, emb, meta, gids, preds, lx, cd, B, N, D, G, k, P,
                        s0, i0, s1, i1, out_s, out_i, stream);
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

// What a launch of these shapes uses (P == 0: resident, P >= 1: paged):
// out[INFO_LEN] = {shared memory bytes a block, ring stages, running
// lists in shared memory (0/1), blocks an SM holds, blocks along x (the
// tiles or pages), rows a tile, the micro-tile's rows MR and query rows
// QN, dims a ring stage, query rows a block BB}. Returns 0, or a CUDA
// error.
constexpr int INFO_LEN = 10;

template <int BB, int MODE>
int info_for(int B, int N, int G, int QT, int k, int P, int* out) {
  const bool paged = P > 0;
  const int tile = paged ? P : TILE_N;
  const int n_lists = (int)(((long long)N + tile - 1) / tile);
  const int L = k < tile ? k : tile;
  ScanConfig cfg;
  if (!scan_config(BB, MODE, paged, G, QT, L, &cfg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = paged ? blocks_per_sm<BB, MODE, true>(cfg.smem)
                           : blocks_per_sm<BB, MODE, false>(cfg.smem);
  if (blocks < 0) return -blocks;
  const int vals[INFO_LEN] = {
      (int)cfg.smem, cfg.stages, cfg.run_smem ? 1 : 0, blocks,
      n_lists, TILE_N, MR,
      BB / NQG, CH, BB};
  for (int i = 0; i < INFO_LEN; ++i) out[i] = vals[i];
  return 0;
}

template <int MODE>
int scan_info(int B, int N, int G, int QT, int k, int P, int* out) {
  if (B < 1 || N < 1 || k < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return B <= 8    ? info_for<8, MODE>(B, N, G, QT, k, P, out)
         : B <= 16 ? info_for<16, MODE>(B, N, G, QT, k, P, out)
         : B <= 32 ? info_for<32, MODE>(B, N, G, QT, k, P, out)
                   : info_for<64, MODE>(B, N, G, QT, k, P, out);
}

}  // namespace
