// C entry point of the arena scan's PROBE mode: ScanSpec("dense",
// slot_lane=True), which `ivf_probe_pallas` (src/repro/kernels/ivf_probe/
// ivf_probe.py:32) runs over an IVF candidate set, ported to Hopper with the
// candidate gather of `_assemble` (src/repro/kernels/ivf_probe/ops.py:34)
// folded into the kernel's loads. The kernels, their design and their bound
// are in arena_scan.cuh.

#include "arena_scan.cuh"

extern "C" {

// q (B, D) f32; the ARENA's emb (N, D) f32 and meta (N, 4) i32; cand (P,)
// i32 arena slots of the candidate rows (slots outside [0, N) are dead);
// pred (4,) i32 -> out_s (B, k) f32, out_i (B, k) i32 arena slots. Scratch
// as arena_scan_launch takes it for P rows. Stream and error contract as
// arena_scan_launch.
int arena_scan_probe_launch(const float* q, const float* emb,
                            const int* meta, const int* cand,
                            const int* pred, int B, int N, int P, int D,
                            int k, float* s0, int* i0, float* s1, int* i1,
                            float* out_s, int* out_i, void* stream_ptr) {
  const Lex none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  return run_scan<PROBE>(q, emb, meta, nullptr, pred, none, Cand{cand, N}, B,
                         P, D, 1, k, 0, s0, i0, s1, i1, out_s, out_i,
                         static_cast<cudaStream_t>(stream_ptr));
}

// The paged regime of the probe (`ivf_probe_pallas(page_rows=)`): pages
// of page_rows >= 1 candidate positions; the inputs of
// arena_scan_probe_launch plus page_rows, scratch as arena_scan_paged_launch
// takes it for P rows. Stream and error contract as arena_scan_launch.
int arena_scan_probe_paged_launch(const float* q, const float* emb,
                                  const int* meta, const int* cand,
                                  const int* pred, int B, int N, int P,
                                  int D, int k, int page_rows, float* s0,
                                  int* i0, float* s1, int* i1, float* out_s,
                                  int* out_i, void* stream_ptr) {
  const Lex none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  return run_paged<PROBE>(q, emb, meta, nullptr, pred, none, Cand{cand, N},
                          B, P, D, 1, k, page_rows, s0, i0, s1, i1, out_s,
                          out_i, static_cast<cudaStream_t>(stream_ptr));
}

// arena_scan_info for the probe over N = P candidates (G = 1; QT unused).
int arena_scan_probe_info(int B, int N, int G, int QT, int k, int page_rows,
                          int* out) {
  return scan_info<PROBE>(B, N, G, QT, k, page_rows, out);
}

}  // extern "C"
