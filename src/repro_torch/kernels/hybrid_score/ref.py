"""Plain PyTorch reference for the hybrid_score kernel (port of
``repro.kernels.hybrid_score.ref``).

ONE pass over the arena computes BOTH retrieval signals for every query
row --

  dense  = (w_dense * q) . emb^T
  bm25   = sum over the row's T postings lanes of
           w_lex * idf(term) * tf*(k1+1)/(tf + k1*lennorm)   (masked gather)

-- applies the row's lowered predicate mask (grouped, as grouped_topk: a
row failing group g's predicate is NEG_INF in every g-row BEFORE any
ranking, so it never surfaces however high its BM25 score), and keeps:

  * ``wsum``: one list on ``dense + bm25``, the fusion weights FOLDED into
              the inputs (q and qidf), so the combine is a bare add;
  * ``rrf``:  two lists (dense, bm25), fused by reciprocal rank over the
              retrieved lists (`rrf_fuse`) after the scan. Weights unused.

Both engines are the arena-scan framework's plain engines
(`kernels.arena_scan.ref`) with identical weight folding; the CUDA kernel
(``csrc/arena_scan.cu``) is held to them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.arena_scan.stages import (NEG_INF, ScanSpec,
                                                   bm25_scores)


def qidf_of(idf: torch.Tensor, qterms: torch.Tensor) -> torch.Tensor:
    """Query-side idf gather: (B, QT) term ids against the snapshot's (V,)
    idf table. Padding terms (-1) gather weight 0 -- the invariant that
    makes padded term lanes inert in every scorer.

    >>> qidf_of(torch.tensor([0.5, 2.0]), torch.tensor([[1, -1]])).tolist()
    [[2.0, 0.0]]
    """
    qterms = qterms.to(device=idf.device, dtype=torch.int64)
    return torch.where(qterms >= 0,
                       idf[torch.clamp(qterms, 0, idf.shape[0] - 1)],
                       0.0).to(torch.float32)


def bm25_block(terms, lexnorm, qterms, qidf) -> torch.Tensor:
    """Masked-gather BM25 over one block of postings lanes -- the arena-scan
    framework's lexical score stage (`arena_scan.stages.bm25_scores`, whose
    fixed order and select-guarded lane product pin its bits). Returns
    (B, N) f32."""
    return bm25_scores(terms, lexnorm, qterms, qidf)


def rrf_fuse(ds, di, ls, li, k: int, c: float):
    """Reciprocal-rank fusion of two per-signal k-lists: candidate score =
    sum over lists containing it of 1/(c + rank). A candidate in both lists
    is represented by its dense-list copy (the lex copy is masked out), so
    the union is deduplicated exactly. Returns (scores (B, k) f32, slots
    (B, k) int32, -1 past the fill).

    RRF scores tie exactly all the time (rank r in dense only vs rank r in
    lex only): ties break toward the lower position of the [dense | lex]
    concatenation -- the dense list, then the better rank -- by a stable
    descending sort, the order `lax.top_k` gives in the reference.

    >>> d_s, d_i = torch.tensor([[0.9, 0.5]]), torch.tensor([[4, 7]])
    >>> rrf_fuse(d_s, d_i, torch.tensor([[3.0, 1.0]]),
    ...          torch.tensor([[9, 4]]), 3, 60)[1].tolist()   # 4 in both
    [[4, 9, 7]]
    >>> rrf_fuse(d_s, d_i, torch.tensor([[3.0, 1.0]]),
    ...          torch.tensor([[9, 5]]), 4, 60)[1].tolist()   # rank ties
    [[4, 9, 7, 5]]
    """
    kd, kl = di.shape[1], li.shape[1]
    dev = di.device
    rd = 1.0 / (c + torch.arange(1, kd + 1, dtype=torch.float32, device=dev))
    rl = 1.0 / (c + torch.arange(1, kl + 1, dtype=torch.float32, device=dev))
    d_valid = di >= 0
    l_valid = li >= 0
    cross = ((di[:, :, None] == li[:, None, :])
             & d_valid[:, :, None] & l_valid[:, None, :])        # (B, kd, kl)
    d_score = (torch.where(d_valid, rd[None, :], NEG_INF)
               + torch.where(cross, rl[None, None, :], 0.0).sum(dim=2))
    # a lex candidate also in the dense list already carries both ranks on
    # its dense copy -- mask the lex copy out so the union stays deduplicated
    in_dense = cross.any(dim=1)                                  # (B, kl)
    l_score = torch.where(l_valid & ~in_dense, rl[None, :], NEG_INF)
    all_s = torch.cat([d_score, l_score], dim=1)
    all_i = torch.cat([di, li], dim=1).to(torch.int32)
    k_eff = min(k, all_s.shape[1])
    top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k_eff], torch.gather(all_i, 1, pos[:, :k_eff])
    if k_eff < k:
        b = top_s.shape[0]
        top_s = torch.cat([top_s, top_s.new_full((b, k - k_eff), NEG_INF)], 1)
        top_i = torch.cat([top_i, top_i.new_full((b, k - k_eff), -1)], 1)
    return top_s, torch.where(top_s > NEG_INF, top_i, -1).to(torch.int32)


def _fold(q, qidf, mode, w_dense, w_lex):
    """Identical weight folding in every engine: wsum scales the inputs
    once, elementwise, in f32. RRF leaves inputs untouched (rank fusion is
    scale-free and its lists carry RAW signal scores)."""
    if mode == "wsum":
        f32 = lambda w, x: torch.tensor(w, dtype=torch.float32,
                                        device=x.device)
        return q * f32(w_dense, q), qidf * f32(w_lex, qidf)
    return q, qidf


def _spec(mode: str) -> ScanSpec:
    return ScanSpec(score="fused" if mode == "wsum" else "both")


def hybrid_score_ref(q, emb, meta, terms, lexnorm, gids, preds, qterms, qidf,
                     k: int, mode: str = "wsum", w_dense: float = 1.0,
                     w_lex: float = 1.0, rrf_c: float = 60.0):
    """Dense oracle. q: (B, D); emb: (N, D); meta: (N, 4) int32; terms /
    lexnorm: (N, T); gids: (B,) int32; preds: (G, 4) int32; qterms: (B, QT)
    int32; qidf: (B, QT) f32. Returns (scores (B, k) f32, slots (B, k)
    int32) for ``wsum`` and the fused RRF lists for ``rrf``."""
    q, qidf = _fold(q, qidf, mode, w_dense, w_lex)
    out = arena_scan_ref(q, emb, meta, gids, preds, k, spec=_spec(mode),
                         lex=(terms, lexnorm, qterms, qidf))
    if mode == "wsum":
        return out
    return rrf_fuse(*out, k, rrf_c)


def hybrid_score_scan_ref(q, emb, meta, terms, lexnorm, gids, preds, qterms,
                          qidf, k: int, blk_n: int, mode: str = "wsum",
                          w_dense: float = 1.0, w_lex: float = 1.0,
                          rrf_c: float = 60.0, lists: bool = False):
    """Streaming implementation -- the kernel's schedule without the card:
    (blk_n,)-row tiles, dense + masked-gather BM25 + predicate mask per
    tile, a LOCAL top-k per running list, one final merge. Never
    materialises (B, N); on the CPU this is the port's hybrid engine.
    ``lists=True`` (rrf only) returns the two per-signal k-lists unfused."""
    q, qidf = _fold(q, qidf, mode, w_dense, w_lex)
    out = arena_scan_scan_ref(q, emb, meta, gids, preds, k, blk_n,
                              spec=_spec(mode),
                              lex=(terms, lexnorm, qterms, qidf))
    if mode == "wsum" or lists:
        return out
    return rrf_fuse(*out, k, rrf_c)
