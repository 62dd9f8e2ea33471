"""Public wrapper for the hybrid_score kernel (port of
``repro.kernels.hybrid_score.ops``): metadata packing, query-side idf
gathering, engine dispatch and the RRF rank fusion of the per-signal lists.

CUDA tensors go to the kernel (`hybrid_score_cuda`), CPU tensors to the
streaming scan (`hybrid_score_scan_ref`); nothing else is taken. The
kernel masks the ragged edge of N itself and takes any B and D, so none of
the reference's dead-row, 128-lane or 8-row padding is needed. The caller
may pad ``preds`` with blocker rows (tenant = -3) to bucket G, and
``qterms`` columns with -1 to bucket QT: a -1 query term gathers idf 0, so
padded term lanes contribute exactly 0.0 to every score.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ops import _packed_meta, default_blk_n
from repro_torch.kernels.hybrid_score.hybrid_score import hybrid_score_cuda
from repro_torch.kernels.hybrid_score.ref import (NEG_INF,
                                                  hybrid_score_scan_ref,
                                                  qidf_of, rrf_fuse)


def hybrid_score(q, emb, tenant, updated_at, category, acl, terms, lexnorm,
                 idf, gids, preds, qterms, k: int, *, mode: str = "wsum",
                 w_dense: float = 1.0, w_lex: float = 1.0,
                 rrf_c: float = 60.0, lists: bool = False,
                 blk_n: int | None = None, page_rows: int | None = None):
    """Fused hybrid dense+BM25 grouped top-k over ONE arena scan.

    q: (B, D) stacked query rows for every predicate group in the batch;
    emb/tenant/updated_at/category/acl: the vector-arena columns;
    terms/lexnorm: the postings lanes ((N, T) ids + per-lane BM25 weight,
    `LexicalArena.snapshot()`); idf: (V,) f32 table; gids: (B,) int32 group
    id per row; preds: (G, 4) int32 stacked `Predicate.as_array()` rows;
    qterms: (B, QT) int32 per-row query term ids (-1 padding); k: LIMIT.

    ``mode="wsum"`` ranks on w_dense*dense + w_lex*bm25 (weights folded
    into the inputs); ``mode="rrf"`` retrieves both per-signal k-lists in
    the same pass and rank-fuses them (1/(rrf_c + rank), deduplicated
    union). ``lists=True`` (rrf only) skips the fusion and returns (d_s,
    d_i, l_s, l_i). ``blk_n`` is the CPU streaming scan's tile.
    ``page_rows`` selects the paged regime: the kernel streams pages of
    that many rows, the CPU scan tiles at the page; the lists are
    unchanged.

    Returns (scores (B, k) f32, slots (B, k) int32, -1 past the fill)."""
    if lists and mode != "rrf":
        raise ValueError("lists=True is only meaningful for mode='rrf'")
    if mode not in ("wsum", "rrf"):
        raise ValueError(f"unknown fusion mode {mode!r}")
    n = emb.shape[0]
    if k > n:   # LIMIT larger than the arena: SQL semantics, padded to k
        out = hybrid_score(q, emb, tenant, updated_at, category, acl, terms,
                           lexnorm, idf, gids, preds, qterms, n, mode=mode,
                           w_dense=w_dense, w_lex=w_lex, rrf_c=rrf_c,
                           lists=lists, blk_n=blk_n, page_rows=page_rows)
        pad = k - n
        return tuple(torch.cat([a, a.new_full((a.shape[0], pad),
                                              NEG_INF if j % 2 == 0 else -1)],
                               dim=1)
                     for j, a in enumerate(out))
    dev = emb.device
    meta = _packed_meta(tenant, updated_at, category, acl)
    as_dev = lambda x, dt: torch.as_tensor(x, dtype=dt,
                                           device=dev).contiguous()
    q = as_dev(q, torch.float32)
    gids = as_dev(gids, torch.int32)
    preds = as_dev(preds, torch.int32)
    qterms = as_dev(qterms, torch.int32)
    terms = as_dev(terms, torch.int32)
    lexnorm = as_dev(lexnorm, torch.float32)
    qidf = qidf_of(as_dev(idf, torch.float32), qterms).contiguous()
    if dev.type == "cpu":
        return hybrid_score_scan_ref(q, emb, meta, terms, lexnorm, gids,
                                     preds, qterms, qidf, k,
                                     default_blk_n(n, page_rows or blk_n),
                                     mode=mode, w_dense=w_dense, w_lex=w_lex,
                                     rrf_c=rrf_c, lists=lists)
    if dev.type != "cuda":
        raise ValueError(f"no hybrid engine for device {dev}")
    out = hybrid_score_cuda(q, emb, meta, terms, lexnorm, gids, preds,
                            qterms, qidf, k, mode=mode, w_dense=w_dense,
                            w_lex=w_lex, page_rows=page_rows)
    if mode == "wsum" or lists:
        return out
    return rrf_fuse(*out, k, rrf_c)
