// C entry point of the arena scan's BOTH mode: ScanSpec(score="both"), the
// rrf mode of `hybrid_score_pallas` (src/repro/kernels/hybrid_score/
// hybrid_score.py:55), ported to Hopper. The kernels, their design and
// their bound are in arena_scan.cuh.

#include "arena_scan.cuh"

extern "C" {

// The inputs of arena_scan_fused_launch. out_s / out_i (2B, k): the dense
// list's B rows, then the bm25 list's; each scratch buffer twice the size
// arena_scan_launch takes. Stream and error contract as arena_scan_launch.
int arena_scan_both_launch(const float* q, const float* emb,
                           const int* meta, const int* gids,
                           const int* preds, const int* terms,
                           const float* lexnorm, const int* qterms,
                           const float* qidf, int B, int N, int D, int G,
                           int T, int QT, int k, float* s0, int* i0,
                           float* s1, int* i1, float* out_s, int* out_i,
                           void* stream_ptr) {
  const Lex lx{terms, lexnorm, qterms, qidf, T, QT};
  return run_scan<BOTH>(q, emb, meta, gids, preds, lx, kNoCand, B, N, D,
                        G, k, 0, s0, i0, s1, i1, out_s, out_i,
                        static_cast<cudaStream_t>(stream_ptr));
}

// The paged regime of this mode: the inputs of arena_scan_both_launch plus
// page_rows >= 1; scratch twice what arena_scan_paged_launch takes (the
// two lists). Stream and error contract as arena_scan_launch.
int arena_scan_both_paged_launch(
    const float* q, const float* emb, const int* meta, const int* gids,
    const int* preds, const int* terms, const float* lexnorm,
    const int* qterms, const float* qidf, int B, int N, int D, int G, int T,
    int QT, int k, int page_rows, float* s0, int* i0, float* s1, int* i1,
    float* out_s, int* out_i, void* stream_ptr) {
  const Lex lx{terms, lexnorm, qterms, qidf, T, QT};
  return run_paged<BOTH>(q, emb, meta, gids, preds, lx, kNoCand, B, N, D,
                         G, k, page_rows, s0, i0, s1, i1, out_s, out_i,
                         static_cast<cudaStream_t>(stream_ptr));
}

// arena_scan_info for this mode and QT query terms (the lanes a row do not
// change the launch: they never pass through shared memory).
int arena_scan_both_info(int B, int N, int G, int QT, int k,
                         int page_rows, int* out) {
  return scan_info<BOTH>(B, N, G, QT, k, page_rows, out);
}

}  // extern "C"
