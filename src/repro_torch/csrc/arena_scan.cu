// The unified arena scan on Hopper: masked dense top-k over a columnar
// arena, every predicate group of a batch in one pass.
//
// Replaces the Pallas TPU kernel `arena_scan_pallas`, resident regime, with
// ScanSpec(score="dense") (src/repro/kernels/arena_scan/kernel.py:97,171),
// which `filtered_topk_pallas` (G = 1) and `grouped_topk_pallas` (G >= 1)
// wrap. For each query row b it returns the top-k of q_b . e_n over arena
// rows n that are live (tenant >= 0) and pass the predicate of group
// gids[b] (tenant, min_ts, category bitmask, ACL bitmask), ordered by score
// descending and then arena index ascending; slot -1 wherever the score is
// NEG_INF, and (NEG_INF, -1) padding past the fill when k > N.
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
//      The predicate of each row's group is read by direct index from
//      shared memory; rows that fail it, and rows past N, score NEG_INF.
//      Eight query rows at a time go through shared memory, where the
//      tile's top k_loc = min(k, 256) by (score desc, index asc) is
//      selected -- by a warp-wide argmax per row for k_loc <= 32, by a
//      bitonic sort of the whole tile above that -- into a candidate
//      buffer that the wrapper allocates. Every NEG_INF entry carries the
//      index INT_MAX, so it sorts after all real entries and padding
//      appended to a sorted list keeps it sorted.
//   2. merge: the sorted per-tile lists merge pairwise, round after round
//      (log2 of the tile count), each output element placed by its rank
//      (a binary search in the partner list), keeping min(k, 2L) per pair.
//   3. finish: the single remaining list per row, padded to k, with slot -1
//      wherever the score is NEG_INF.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
//   max(N * (4D + 16) B / 3.35 TB/s, 2 * B * N * D / 67 TFLOP/s).
// At N = 2^23, D = 768, B = 32 that is max(7.7 ms, 6.1 ms): memory-bound,
// with the fp32 FMA work close behind.
//
// What this simple design leaves on the table: each FMA group waits on a
// 16-byte broadcast load from shared memory (most likely the shared-memory
// pipe, not the FMA units, sets the pace; a register-tiled micro-tile of
// queries x rows would cut those loads), and each tile's staging waits for its loads (no
// cp.async/TMA pipelining), so it reaches neither rate. Tensor cores
// (wgmma; TF32 or bf16 with an fp32 rescore of the winners) and a cheaper
// selection than the full bitonic sort for k > 32 are later work too. The
// merge rounds add one small launch each.

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

template <int BB>
__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                 const int* __restrict__ meta, const int* __restrict__ gids,
                 const int* __restrict__ preds, int B, int N, int D, int G,
                 int k_loc, int n_tiles, float* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* e_sh = reinterpret_cast<float*>(smem_raw);     // TILE_N x (DK+1)
  float* q_sh = e_sh + TILE_N * (DK + 1);                // DK x BB
  int* p_sh = reinterpret_cast<int*>(q_sh + DK * BB);    // G x 4
  int* g_sh = p_sh + 4 * G;                              // BB
  // the sort buffers reuse the emb staging area once the dots are done
  float* s_sort = e_sh;                                  // RS x TILE_N
  int* i_sort = reinterpret_cast<int*>(e_sh + RS * TILE_N);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b0 = blockIdx.y * BB;
  const int base = tile * TILE_N;

  for (int i = tid; i < 4 * G; i += THREADS) p_sh[i] = preds[i];
  for (int i = tid; i < BB; i += THREADS) {
    const int g = (b0 + i < B) ? gids[b0 + i] : -1;
    g_sh[i] = (g >= 0 && g < G) ? g : -1;   // out-of-range ids match nothing
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
        const int row = base + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < N && d0 + c < D)
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
        const int row = base + r;
        const int d = d0 + c;
        e_sh[r * (DK + 1) + c] =
            (row < N && d < D) ? emb[(size_t)row * D + d] : 0.f;
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
  // outside [0, 32) match no category set
  const int row = base + tid;
  const int4 m = row < N ? reinterpret_cast<const int4*>(meta)[row]
                         : make_int4(-1, 0, 0, 0);   // past N: never live
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
    __syncthreads();
    if (k_loc <= WARP_K) {
      select_and_emit(s_sort, i_sort, k_loc, b0 + r0, B, tile, n_tiles,
                      cand_s, cand_i);
    } else {
      sort_and_emit(s_sort, i_sort, k_loc, b0 + r0, B, tile, n_tiles,
                    cand_s, cand_i);
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

__global__ void finish_kernel(const float* __restrict__ in_s,
                              const int* __restrict__ in_i, int B, int L,
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
    ix = s > NEG_INF ? in_i[(size_t)b * L + j] : -1;
  }
  out_s[t] = s;
  out_i[t] = ix;
}

template <int BB>
cudaError_t launch_tiles(const float* q, const float* emb, const int* meta,
                         const int* gids, const int* preds, int B, int N,
                         int D, int G, int k_loc, int n_tiles, float* cand_s,
                         int* cand_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (TILE_N * (DK + 1) + DK * BB) +
                      sizeof(int) * (4 * (size_t)G + BB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_scan_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_tiles, (B + BB - 1) / BB);
  tile_scan_kernel<BB><<<grid, THREADS, smem, stream>>>(
      q, emb, meta, gids, preds, B, N, D, G, k_loc, n_tiles, cand_s, cand_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int arena_scan_tile_rows() { return TILE_N; }

const char* arena_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, D) f32, emb (N, D) f32, meta (N, 4) i32, gids (B,) i32,
// preds (G, 4) i32 -> out_s (B, k) f32, out_i (B, k) i32. Scratch: two
// candidate buffers of B * next_pow2(n_tiles) * min(k, TILE_N) entries
// each (scores and indices). Launches on `stream`; does not synchronise.
// Returns the first CUDA error (0 on success).
int arena_scan_launch(const float* q, const float* emb, const int* meta,
                      const int* gids, const int* preds, int B, int N, int D,
                      int G, int k, float* s0, int* i0, float* s1, int* i1,
                      float* out_s, int* out_i, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (N + TILE_N - 1) / TILE_N;
  const int k_loc = k < TILE_N ? k : TILE_N;
  cudaError_t err;
  if (B <= 8) {
    err = launch_tiles<8>(q, emb, meta, gids, preds, B, N, D, G, k_loc,
                          n_tiles, s0, i0, stream);
  } else if (B <= 16) {
    err = launch_tiles<16>(q, emb, meta, gids, preds, B, N, D, G, k_loc,
                           n_tiles, s0, i0, stream);
  } else if (B <= 32) {
    err = launch_tiles<32>(q, emb, meta, gids, preds, B, N, D, G, k_loc,
                           n_tiles, s0, i0, stream);
  } else {
    err = launch_tiles<64>(q, emb, meta, gids, preds, B, N, D, G, k_loc,
                           n_tiles, s0, i0, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  float* cur_s = s0;
  int* cur_i = i0;
  float* nxt_s = s1;
  int* nxt_i = i1;
  int n = n_tiles;
  int L = k_loc;
  while (n > 1) {
    const int n_out = (n + 1) / 2;
    const int L2 = (2 * L < k) ? 2 * L : k;
    const size_t total = (size_t)B * n_out * 2 * L;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    merge_kernel<<<blocks, 256, 0, stream>>>(cur_s, cur_i, nxt_s, nxt_i, B,
                                             n, L, n_out, L2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* ts = cur_s; cur_s = nxt_s; nxt_s = ts;
    int* ti = cur_i; cur_i = nxt_i; nxt_i = ti;
    n = n_out;
    L = L2;
  }
  const size_t total = (size_t)B * k;
  finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      cur_s, cur_i, B, L, k, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
