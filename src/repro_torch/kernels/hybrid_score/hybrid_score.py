"""The fused hybrid dense+BM25 grouped top-k on the card (port of
``hybrid_score_pallas``, ``src/repro/kernels/hybrid_score/hybrid_score.py:55``).

One arena pass computes both retrieval signals, applies the lowered
predicate mask to both before any ranking, and keeps the running top-k:
the arena-scan kernel (``csrc/arena_scan.cu``) in its lexical score modes.
Fusion weights are folded into the inputs here (``w_dense`` into q,
``w_lex`` into qidf), so the kernel's wsum combine is a bare add.
"""
from __future__ import annotations

from repro_torch.kernels.arena_scan.kernel import arena_scan_cuda
from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.hybrid_score.ref import _fold, _spec

#: hybrid kernel launches through `hybrid_score_cuda` (the main-path audit)
LAUNCHES = 0


def hybrid_score_cuda(q, emb, meta, terms, lexnorm, gids, preds, qterms,
                      qidf, k: int, *, mode: str = "wsum",
                      w_dense: float = 1.0, w_lex: float = 1.0,
                      page_rows: int | None = None):
    """Launch the hybrid scan on the current stream (no sync), the paged
    kernel with ``page_rows`` (an int >= 1). q: (B, D)
    f32; emb: (N, D) f32; meta: (N, 4) int32; terms / lexnorm: (N, T)
    int32 / f32; gids: (B,) int32; preds: (G, 4) int32; qterms: (B, QT)
    int32 (-1 padding); qidf: (B, QT) f32 (0 on padding); all on one CUDA
    device. Returns ``wsum``: (fused scores (B, k) f32, slots (B, k)
    int32); ``rrf``: the two per-signal lists (d_s, d_i, l_s, l_i) -- rank
    fusion happens after the kernel."""
    global LAUNCHES
    q, qidf = _fold(q, qidf, mode, w_dense, w_lex)
    out = arena_scan_cuda(q, emb, meta, gids, preds, k, spec=_spec(mode),
                          lex=(terms, lexnorm, qterms, qidf),
                          page_rows=page_rows)
    LAUNCHES += 1
    return out


def hybrid_score_plain(q, emb, meta, terms, lexnorm, gids, preds, qterms,
                       qidf, k: int, *, mode: str = "wsum",
                       w_dense: float = 1.0, w_lex: float = 1.0,
                       page_rows: int | None = None):
    """The kernel's plain PyTorch version, same contract as
    `hybrid_score_cuda`: the same weight folding, then the dense oracle
    under the same `ScanSpec` -- or, with ``page_rows``, the paged kernel's
    plain version, the streaming scan tiled at the page. On the card,
    callers keep TF32 off."""
    q, qidf = _fold(q, qidf, mode, w_dense, w_lex)
    lex = (terms, lexnorm, qterms, qidf)
    if page_rows is not None:
        return arena_scan_scan_ref(q, emb, meta, gids, preds, k, page_rows,
                                   spec=_spec(mode), lex=lex)
    return arena_scan_ref(q, emb, meta, gids, preds, k, spec=_spec(mode),
                          lex=lex)
