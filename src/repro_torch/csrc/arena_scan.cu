// C entry points of the arena scan's DENSE mode (ScanSpec(score="dense"),
// the Hopper port of `arena_scan_pallas`'s resident regime,
// src/repro/kernels/arena_scan/kernel.py:97,171). The kernels, their
// design and their bound are in arena_scan.cuh.

#include "arena_scan.cuh"

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
  const Lex none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  return run_scan<DENSE>(q, emb, meta, gids, preds, none, kNoCand, B, N, D,
                         G, k, 0, s0, i0, s1, i1, out_s, out_i,
                         static_cast<cudaStream_t>(stream_ptr));
}

// The paged regime (`arena_scan_pallas(page_rows=)`'s `_paged_kernel`,
// src/repro/kernels/arena_scan/kernel.py:121): the inputs of
// arena_scan_launch plus page_rows >= 1. Scratch: two candidate buffers of
// B * next_pow2(ceil(N / page_rows)) * min(k, page_rows) entries each.
// Stream and error contract as arena_scan_launch.
int arena_scan_paged_launch(const float* q, const float* emb,
                            const int* meta, const int* gids,
                            const int* preds, int B, int N, int D, int G,
                            int k, int page_rows, float* s0, int* i0,
                            float* s1, int* i1, float* out_s, int* out_i,
                            void* stream_ptr) {
  const Lex none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  return run_paged<DENSE>(q, emb, meta, gids, preds, none, kNoCand, B, N,
                          D, G, k, page_rows, s0, i0, s1, i1, out_s, out_i,
                          static_cast<cudaStream_t>(stream_ptr));
}

// What a launch of these shapes uses, resident (page_rows 0) or paged
// (page_rows >= 1): out[INFO_LEN] as scan_info in arena_scan.cuh fills it
// (shared memory a block, ring stages, running lists in shared memory,
// blocks an SM holds, blocks along x, tile rows, micro-tile MR x QN, dims
// a stage, query rows a block). QT is unused in this mode. Returns 0 or a
// CUDA error.
int arena_scan_info(int B, int N, int G, int QT, int k, int page_rows,
                    int* out) {
  return scan_info<DENSE>(B, N, G, QT, k, page_rows, out);
}

}  // extern "C"
