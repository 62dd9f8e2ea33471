"""The split-system hybrid baseline: two scans + host-side union rescore
(port of ``repro.index.lexical.twoscan``).

This is what hybrid retrieval looks like when the lexical engine is a
sidecar (the architecture the paper argues against): the dense engine and
the lexical engine each stream the corpus and return their own top-C list,
and APPLICATION code fuses them. Weighted-sum fusion needs both signals for
every candidate, but each engine only knows its own -- so the app issues
two more gather round trips (dense scores of the lexical candidates, BM25
of the dense candidates) before it can merge. Four device dispatches, a
host merge, and a result that is only exact when every winner landed in
one of the top-C lists.

The dense sidecar is the port's `unified_query`: on a store on the card it
is the arena-scan kernel, on the CPU the plain scan. The lexical sidecar is
plain PyTorch on the store's device (the reference's is XLA, not a kernel):
BM25 over the postings lanes, ``chunk_rows`` rows at a time with an exact
running top-k (running list first, ties to the lower row, as
``jax.lax.top_k`` orders them), so a full-width arena never materialises
(B, N) scores or BM25's per-lane temporaries.

Two fidelity levels, selected by ``pushdown``:

  * ``pushdown=True`` -- a GENEROUS baseline: both sidecars accept the
    lowered predicate and filter inside their scans. No real split stack
    can do this (similarity and lexical services don't carry the tenant /
    ACL / recency columns -- that is the paper's point), but it isolates
    the pure two-scans-plus-merge overhead with no filtering confound.
  * ``pushdown=False`` (default, the faithful Stack-A form) -- the
    sidecars return UNFILTERED top-C lists; the app fetches the
    candidates' metadata, post-filters, rescores the union, and RETRIES
    with a quadrupled fetch when the composed predicate under-fills the
    k-list -- the over-fetch / retry ladder of `SplitStackClient.query`,
    multiplied by two engines.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.query import NEG_INF, Predicate, unified_query
from repro_torch.core.splitstack import _chunked_topk
from repro_torch.core.store import Store
from repro_torch.kernels.arena_scan.stages import predicate_keep
from repro_torch.kernels.hybrid_score.ref import bm25_block, qidf_of, rrf_fuse

#: arena rows the lexical sidecar scores at once (an exact running top-k
#: carries across chunks)
CHUNK_ROWS = 1 << 20


def lexical_topk(store: Store, terms, lexnorm, idf, q_terms, pred, k: int,
                 *, chunk_rows: int | None = CHUNK_ROWS):
    """The standalone lexical engine: BM25 over the postings lanes with the
    predicate pushed down, top-k. One of the two scans of the split
    baseline (also the recall reference for "what would BM25 alone do").
    ``pred`` is `Predicate.as_array()`. Returns (scores (B, min(k, N))
    f32, slots int32, -1 where the score is NEG_INF); ties go to the lower
    row, chunked or not.

    >>> from repro_torch.core.store import StoreConfig, empty
    >>> st = empty(StoreConfig(capacity=4, dim=2), device="cpu")
    >>> st["tenant"][:3] = 0
    >>> st["acl"][:3] = 1
    >>> terms = torch.tensor([[5, -1], [7, 5], [5, -1], [5, -1]])
    >>> ln = torch.ones(4, 2)
    >>> s, i = lexical_topk(st, terms, ln, torch.ones(8), [[5]],
    ...                     Predicate().as_array(), 3, chunk_rows=2)
    >>> i.tolist(), s.tolist()     # row 3 is dead; rows 0-2 tie at 1.0
    ([[0, 1, 2]], [[1.0, 1.0, 1.0]])
    """
    dev = store["emb"].device
    qt = torch.as_tensor(np.asarray(q_terms), dtype=torch.int32, device=dev)
    qidf = qidf_of(torch.as_tensor(idf, device=dev), qt)
    pa = torch.as_tensor(pred, dtype=torch.int32, device=dev).reshape(1, 4)

    def signals(lo, hi):
        meta = torch.stack([store["tenant"][lo:hi], store["updated_at"][lo:hi],
                            store["category"][lo:hi], store["acl"][lo:hi]],
                           dim=1)
        keep = predicate_keep(meta, pa)[0]
        bm25 = bm25_block(terms[lo:hi], lexnorm[lo:hi], qt, qidf)
        return (torch.where(keep[None, :], bm25, NEG_INF),)

    ((top_s, top_i),) = _chunked_topk(store["emb"].shape[0], k, signals,
                                      chunk_rows)
    return top_s, torch.where(top_s > NEG_INF, top_i, -1)


def _gather_dense(emb, q, slots):
    """Rescore round trip 1: dense scores of arbitrary candidate slots."""
    valid = slots >= 0
    rows = emb[slots.clamp(min=0).long()]                 # (B, C, D)
    s = torch.einsum("bd,bcd->bc", q.float(), rows.float())
    return torch.where(valid, s, NEG_INF)


def _gather_bm25(terms, lexnorm, idf, q_terms, slots):
    """Rescore round trip 2: BM25 of arbitrary candidate slots."""
    valid = slots >= 0
    idx = slots.clamp(min=0).long()
    t = terms[idx]                                        # (B, C, T)
    ln = lexnorm[idx]
    qidf = qidf_of(idf, q_terms)
    acc = torch.zeros(slots.shape, dtype=torch.float32, device=slots.device)
    for lane in range(t.shape[2]):
        w = torch.zeros_like(acc)
        for j in range(q_terms.shape[1]):
            hit = t[:, :, lane] == q_terms[:, j][:, None]
            w = w + torch.where(hit, qidf[:, j][:, None], 0.0)
        acc = acc + w * ln[:, :, lane]
    return torch.where(valid, acc, 0.0)


def _passes_pred(store: Store, slots: np.ndarray, pred: Predicate):
    """App-layer post-filter (the fragile part of the split stack): the
    lowered predicate re-evaluated host-side over the candidates' fetched
    metadata."""
    idx = torch.from_numpy(np.ascontiguousarray(slots, np.int64)).to(
        store["emb"].device)
    tenant, ts, cat, acl = (store[c][idx].cpu().numpy()
                            for c in ("tenant", "updated_at", "category",
                                      "acl"))
    ok = (slots >= 0) & (tenant >= 0) & (ts >= pred.min_ts)
    if pred.tenant != -2:
        ok &= tenant == pred.tenant
    ok &= ((np.uint64(1) << (cat.astype(np.uint64) & np.uint64(31)))
           & np.uint64(pred.cat_mask)) != 0
    ok &= (acl.view(np.uint32) & np.uint32(pred.acl_bits)) != 0
    return ok


def _fuse_union(store, lex_snap, q, q_terms, d_s, d_i, l_s, l_i, k, mode,
                w_dense, w_lex, rrf_c, keep_mask=None):
    """Host-side union fusion over two candidate lists: (wsum) two gather
    rescores on the store's device fetch each candidate's missing signal,
    then dedupe + fuse + a stable descending sort; (rrf) rank fusion
    straight off the lists."""
    neg = np.float32(NEG_INF)
    if keep_mask is not None:
        d_mask, l_mask = keep_mask
        d_s = np.where(d_mask, d_s, neg)
        d_i = np.where(d_mask, d_i, -1)
        l_s = np.where(l_mask, l_s, neg)
        l_i = np.where(l_mask, l_i, -1)
    if mode == "rrf":
        s, i = rrf_fuse(*(torch.from_numpy(np.ascontiguousarray(a))
                          for a in (d_s, d_i, l_s, l_i)), k, rrf_c)
        return s.numpy(), i.numpy()
    # weighted sum needs BOTH signals on EVERY candidate: two more round
    # trips fetch what each engine couldn't know
    dev = store["emb"].device
    on_dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                           device=dev)
    d_of_l = _gather_dense(store["emb"], on_dev(q, torch.float32),
                           on_dev(l_i, torch.int64)).cpu().numpy()
    b_of_d = _gather_bm25(lex_snap["terms"], lex_snap["lexnorm"],
                          lex_snap["idf"], on_dev(q_terms, torch.int32),
                          on_dev(d_i, torch.int64)).cpu().numpy()
    c = d_i.shape[1]
    cand = np.concatenate([d_i, l_i], axis=1)
    dense_all = np.concatenate([d_s, d_of_l], axis=1)
    lex_all = np.concatenate([b_of_d, np.where(l_i >= 0, l_s, 0.0)], axis=1)
    fused = np.where(cand >= 0,
                     w_dense * dense_all + w_lex * lex_all, neg)
    dup = (l_i[:, None, :] == d_i[:, :, None]) & (l_i[:, None, :] >= 0)
    fused[:, c:][dup.any(axis=1)] = neg          # lex copy of a dense slot
    order = np.argsort(-fused, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(fused, order, axis=1)
    i = np.take_along_axis(cand, order, axis=1)
    return (np.where(s > neg, s, neg).astype(np.float32),
            np.where(s > neg, i, -1).astype(np.int32))


def two_scan_hybrid(store: Store, lex_snap: dict, q, q_terms,
                    pred: Predicate, k: int, *, mode: str = "wsum",
                    w_dense: float = 1.0, w_lex: float = 1.0,
                    rrf_c: float = 60.0, overfetch: int = 4,
                    max_retries: int = 4, pushdown: bool = False,
                    engine: str | None = None):
    """The whole split pipeline. ``lex_snap`` is `LexicalArena.snapshot()`;
    ``engine`` is the dense sidecar's engine, by default the store's exact
    one ("cuda" on the card, "ref" on the CPU). Returns (scores (B, k) f32,
    slots (B, k) int32) numpy.

    ``pushdown=True``: both sidecars filter in-scan (generous baseline --
    isolates the pure two-scan overhead). ``pushdown=False`` (faithful):
    unfiltered top-C from each sidecar, app-layer metadata post-filter,
    union rescore, and the over-fetch retry ladder when the composed
    predicate under-fills -- each retry re-streams BOTH engines at 4x the
    fetch, which is exactly how composed queries explode on a split
    stack."""
    dev = store["emb"].device
    if engine is None:
        engine = "cuda" if dev.type == "cuda" else "ref"
    n = store["emb"].shape[0]
    q = np.atleast_2d(np.asarray(q, np.float32))
    q_terms = np.asarray(q_terms, np.int32)
    q_dev = torch.from_numpy(q).to(dev)

    def sidecars(p: Predicate, fetch: int):
        d_s, d_i = unified_query(store, q_dev, p, fetch, engine=engine)
        l_s, l_i = lexical_topk(store, lex_snap["terms"],
                                lex_snap["lexnorm"], lex_snap["idf"],
                                q_terms, p.as_array(dev), fetch)
        return tuple(a.cpu().numpy() for a in (d_s, d_i, l_s, l_i))

    if pushdown:
        c = min(max(overfetch * k, k), n)
        return _fuse_union(store, lex_snap, q, q_terms, *sidecars(pred, c),
                           k, mode, w_dense, w_lex, rrf_c)
    # faithful split: similarity and lexical services know nothing about
    # tenants / ACLs / recency -- scan unfiltered, post-filter app-side,
    # retry with a quadrupled fetch on under-fill
    open_pred = Predicate()
    fetch = min(max(overfetch * k, k), n)
    while True:
        d_s, d_i, l_s, l_i = sidecars(open_pred, fetch)
        d_ok = _passes_pred(store, np.maximum(d_i, 0), pred) & (d_i >= 0)
        l_ok = _passes_pred(store, np.maximum(l_i, 0), pred) & (l_i >= 0)
        # under-filled when the union of qualifying candidates cannot fill
        # k for some row (conservative per-list check, like Stack A's)
        filled = ((d_ok.sum(axis=1) >= k) | (l_ok.sum(axis=1) >= k)
                  | (fetch >= n))
        if filled.all() or fetch >= n or max_retries == 0:
            return _fuse_union(store, lex_snap, q, q_terms, d_s, d_i,
                               l_s, l_i, k, mode, w_dense, w_lex, rrf_c,
                               keep_mask=(d_ok, l_ok))
        fetch = min(fetch * 4, n)
        max_retries -= 1
