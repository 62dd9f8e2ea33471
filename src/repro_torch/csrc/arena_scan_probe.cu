// C entry points of the arena scan's PROBE mode: ScanSpec("dense",
// slot_lane=True), which `ivf_probe_pallas` (src/repro/kernels/ivf_probe/
// ivf_probe.py:32) runs over an IVF candidate set, ported to Hopper with the
// candidate gather of `_assemble` (src/repro/kernels/ivf_probe/ops.py:34)
// folded into the kernel's loads. The scan kernels, their design and their
// bound are in arena_scan.cuh.
//
// The candidate vector the scan walks is compacted first, on the card and
// with no host round trip: `_assemble` gives U x cap + O candidates (the
// probed clusters' member-table rows, -1 padded; a padding cluster id -1;
// the overflow tail), of which only the slots inside [0, n_arena) are live
// -- at the IVF prod shape about two thirds. The compaction keeps the live
// slots in candidate order (clusters in list order, members in table
// order, then the tail), writes -1 after them and leaves their count in
// device memory, where the scan reads it: the scan's lists select on
// positions in the compacted vector, whose order is the padded vector's,
// so every (score, slot) list equals the padded scan's bit for bit. Two
// launches over tiles of CT_TILE positions: compact_count_kernel counts
// each tile's live slots, compact_scatter_kernel sums the counts before its
// tile, ranks its live slots by warp ballots in rounds of 256 positions and
// writes them; bound: the candidates' slots read twice and the vector
// written once, a few microseconds at the prod shape.

#include "arena_scan.cuh"

namespace {

constexpr int CT_ROUNDS = 8;                  // rounds of THREADS positions
constexpr int CT_TILE = CT_ROUNDS * THREADS;  // positions a block compacts

// The arena slot at candidate position p (< U * cap + O), or -1: member
// padding, a padding (or out-of-range) cluster id, a slot outside
// [0, n_arena).
__device__ __forceinline__ int cand_slot(const int* __restrict__ members,
                                         int C, int cap,
                                         const int* __restrict__ clusters,
                                         long long ucap,
                                         const int* __restrict__ overflow,
                                         int n_arena, long long p) {
  int s = -1;
  if (p < ucap) {                 // p < 2^31: 32-bit division
    const int u = (int)p / cap;
    const int c = __ldg(clusters + u);
    if (c >= 0 && c < C)
      s = __ldg(members + (size_t)c * cap + ((int)p - u * cap));
  } else {
    s = __ldg(overflow + (p - ucap));
  }
  return (s >= 0 && s < n_arena) ? s : -1;
}

struct CompactArgs {
  const int* members;    // (C, cap)
  const int* clusters;   // (U,)
  const int* overflow;   // (O,)
  int C, cap, n_arena;
  long long ucap, P;     // U * cap, U * cap + O
};

// counts[tile] = the live candidates among positions [tile * CT_TILE, ...)
__global__ void __launch_bounds__(THREADS)
compact_count_kernel(const CompactArgs a, int* __restrict__ counts) {
  const long long base = (long long)blockIdx.x * CT_TILE + threadIdx.x;
  bool live[CT_ROUNDS];           // all loads in flight before any count
#pragma unroll
  for (int j = 0; j < CT_ROUNDS; ++j) {
    const long long p = base + (long long)j * THREADS;
    live[j] = p < a.P && cand_slot(a.members, a.C, a.cap, a.clusters,
                                   a.ucap, a.overflow, a.n_arena, p) >= 0;
  }
  int n = 0;
#pragma unroll
  for (int j = 0; j < CT_ROUNDS; ++j) n += __syncthreads_count(live[j]);
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

// Sum of v over the block (every thread gets it); red: THREADS / 32 ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(~0u, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The tile's live slots to out[live before the tile + their rank], its
// dead positions to -1 after all live ones (a stable partition); block 0
// writes the live total to *n_live.
__global__ void __launch_bounds__(THREADS)
compact_scatter_kernel(const CompactArgs a, const int* __restrict__ counts,
                       int n_tiles, int* __restrict__ out,
                       int* __restrict__ n_live) {
  __shared__ int red[THREADS / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int before = 0, total = 0;
  for (int t = tid; t < n_tiles; t += THREADS) {
    const int c = counts[t];
    total += c;
    if (t < (int)blockIdx.x) before += c;
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  if (blockIdx.x == 0 && tid == 0) *n_live = total;
  const long long tile0 = (long long)blockIdx.x * CT_TILE;
  int slots[CT_ROUNDS];           // all loads in flight before any rank
#pragma unroll
  for (int j = 0; j < CT_ROUNDS; ++j) {
    const long long p = tile0 + (long long)j * THREADS + tid;
    slots[j] = p < a.P ? cand_slot(a.members, a.C, a.cap, a.clusters, a.ucap,
                                   a.overflow, a.n_arena, p)
                       : -1;
  }
  long long live_at = before;                        // next live output
  long long dead_at = total + (tile0 - before);      // next dead output
#pragma unroll
  for (int j = 0; j < CT_ROUNDS; ++j) {
    const long long p0 = tile0 + (long long)j * THREADS;
    if (p0 >= a.P) break;                            // block-uniform
    const long long p = p0 + tid;
    const int s = slots[j];
    const unsigned bal = __ballot_sync(~0u, s >= 0);
    if (lane == 0) red[warp] = __popc(bal);
    __syncthreads();
    int rank = __popc(bal & ((1u << lane) - 1u)), in_round = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) rank += red[w];
      in_round += red[w];
    }
    if (s >= 0) {
      out[live_at + rank] = s;
    } else if (p < a.P) {                  // positions before p are real
      out[dead_at + (tid - rank)] = -1;
    }
    const long long n_real = a.P - p0 < THREADS ? a.P - p0 : THREADS;
    live_at += in_round;
    dead_at += n_real - in_round;
    __syncthreads();                       // red is rewritten next round
  }
}

}  // namespace

extern "C" {

// q (B, D) f32; the ARENA's emb (N, D) f32 and meta (N, 4) i32; cand (P,)
// i32 arena slots of the candidate rows (slots outside [0, N) are dead);
// n_live: one device int, the live prefix of cand the scan walks (the
// compaction's count; clamped to [0, P]), or nullptr for all P; pred (4,)
// i32 -> out_s (B, k) f32, out_i (B, k) i32 arena slots. Scratch as
// arena_scan_launch takes it for P rows. Stream and error contract as
// arena_scan_launch.
int arena_scan_probe_launch(const float* q, const float* emb,
                            const int* meta, const int* cand,
                            const int* n_live, const int* pred, int B, int N,
                            int P, int D, int k, float* s0, int* i0,
                            float* s1, int* i1, float* out_s, int* out_i,
                            void* stream_ptr) {
  const Lex none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  return run_scan<PROBE>(q, emb, meta, nullptr, pred, none,
                         Cand{cand, N, n_live}, B, P, D, 1, k, 0, s0, i0, s1,
                         i1, out_s, out_i,
                         static_cast<cudaStream_t>(stream_ptr));
}

// The paged regime of the probe (`ivf_probe_pallas(page_rows=)`): pages
// of page_rows >= 1 candidate positions; the inputs of
// arena_scan_probe_launch plus page_rows, scratch as arena_scan_paged_launch
// takes it for P rows. Stream and error contract as arena_scan_launch.
int arena_scan_probe_paged_launch(const float* q, const float* emb,
                                  const int* meta, const int* cand,
                                  const int* n_live, const int* pred, int B,
                                  int N, int P, int D, int k, int page_rows,
                                  float* s0, int* i0, float* s1, int* i1,
                                  float* out_s, int* out_i,
                                  void* stream_ptr) {
  const Lex none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  return run_paged<PROBE>(q, emb, meta, nullptr, pred, none,
                          Cand{cand, N, n_live}, B, P, D, 1, k, page_rows,
                          s0, i0, s1, i1, out_s, out_i,
                          static_cast<cudaStream_t>(stream_ptr));
}

// arena_scan_info for the probe over N = P candidates (G = 1; QT unused).
int arena_scan_probe_info(int B, int N, int G, int QT, int k, int page_rows,
                          int* out) {
  return scan_info<PROBE>(B, N, G, QT, k, page_rows, out);
}

// The compaction's scratch: ints of the per-tile counts for P candidates.
int arena_scan_compact_blocks(int P) { return (P + CT_TILE - 1) / CT_TILE; }

// members (C, cap) i32 member table; clusters (U,) i32 probed cluster ids
// (-1 padding; an id outside [0, C) counts as padding); overflow (O,) i32
// -> out (P,) i32, P = U * cap + O: the live slots (inside [0, n_arena)) in
// candidate order, then -1; *n_live their count. counts: scratch of
// arena_scan_compact_blocks(P) ints. Two launches on `stream`, no
// synchronisation. Returns the first CUDA error (0 on success).
int arena_scan_compact_launch(const int* members, int C, int cap,
                              const int* clusters, int U, const int* overflow,
                              int O, int n_arena, int* counts, int* out,
                              int* n_live, void* stream_ptr) {
  const long long ucap = (long long)U * cap;
  const long long P = ucap + O;
  if (C < 0 || cap < 0 || U < 0 || O < 0 || P < 1 || P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const CompactArgs a{members, clusters, overflow, C, cap, n_arena, ucap, P};
  const int n_tiles = arena_scan_compact_blocks((int)P);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  compact_count_kernel<<<n_tiles, THREADS, 0, stream>>>(a, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter_kernel<<<n_tiles, THREADS, 0, stream>>>(a, counts, n_tiles,
                                                         out, n_live);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
