"""The unified query -- the paper's Section 5.2 as one fused pass (port of
``repro.core.query``).

    SELECT content, embedding <=> :q AS distance
    FROM documents
    WHERE tenant_id = :tenant
      AND updated_at > :min_ts
      AND category = ANY(:cats)
      AND :principal = ANY(permitted_users)
    ORDER BY distance LIMIT :k;

becomes: predicate mask (evaluated over the metadata columns in the same
pass as similarity) -> masked scores -> top-k. No code path returns an
unmasked row.

Engines:
  * ``"ref"``  -- plain PyTorch: `unified_query_ref` for one group, the
    streaming scan for grouped batches (any device);
  * ``"cuda"`` -- the hand-written arena-scan kernel
    (``csrc/arena_scan.cuh``) through `filtered_topk` / `grouped_topk`;
  * ``"sharded"`` -- `make_sharded_query`: the arena scan per shard region
    and an exact (score, doc_id) merge (``kernels.arena_scan.sharded``).

Both front doors take ``page_rows``: the paged arena-scan regime (the
kernel streams pages of that many rows with one running list per page; the
ref engine tiles its streaming scan at the page). The results equal the
resident regime's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.store import Store
from repro_torch.kernels.arena_scan.stages import (predicate_keep,
                                                   tile_scores, topk_ordered)

NEG_INF = float(torch.finfo(torch.float32).min)


def _int32_bits(v: int) -> int:
    """A uint32 bit pattern as the int32 with the same bits."""
    return int(np.uint32(v & 0xFFFFFFFF).view(np.int32))


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Runtime predicate values. Disabled clauses use their pass-all value,
    so one kernel serves every clause combination.

    tenant   : int32, -2 means "any tenant" (-1 is the tombstone tenant)
    min_ts   : int32 inclusive lower bound on updated_at (0 = no recency bound)
    cat_mask : uint32 bitmask of allowed categories (all-ones = any category)
    acl_bits : uint32 principal group bits; rows must share a bit (all-ones = no ACL)
    """
    tenant: int = -2
    min_ts: int = 0
    cat_mask: int = 0xFFFFFFFF
    acl_bits: int = 0xFFFFFFFF

    def as_array(self, device="cpu") -> torch.Tensor:
        """[tenant, min_ts, cat_mask, acl_bits] as (4,) int32 on ``device``
        (the masks as their int32 bit patterns). Memoized per (predicate,
        device) with LRU eviction: predicates repeat across a serving
        session, and the host->device copy would otherwise dominate
        sub-ms queries."""
        dev = torch.device(device)
        key = (self, str(dev))
        cached = _PRED_CACHE.get(key)
        if cached is None:
            host = torch.tensor(
                [self.tenant, self.min_ts, _int32_bits(self.cat_mask),
                 _int32_bits(self.acl_bits)], dtype=torch.int32)
            # to the card by an asynchronous copy from pinned memory: a
            # predicate's first launch must not wait on the device either
            cached = (host.pin_memory().to(dev, non_blocking=True)
                      if dev.type == "cuda" else host.to(dev))
            while len(_PRED_CACHE) >= _PRED_CACHE_CAP:
                _PRED_CACHE.popitem(last=False)
            _PRED_CACHE[key] = cached
        else:
            _PRED_CACHE.move_to_end(key)
        return cached


_PRED_CACHE: OrderedDict[tuple, torch.Tensor] = OrderedDict()
_PRED_CACHE_CAP = 4096


def _meta(store: Store) -> torch.Tensor:
    return torch.stack([store["tenant"], store["updated_at"],
                        store["category"], store["acl"]], dim=1)


def predicate_mask(store: Store, pred: torch.Tensor) -> torch.Tensor:
    """Engine-level WHERE clause. pred = Predicate.as_array() (4,) int32.
    Returns (N,) bool -- True where the row is live AND satisfies every
    clause."""
    return predicate_keep(_meta(store), pred.reshape(1, 4))[0]


def unified_query_ref(store: Store, q: torch.Tensor, pred: torch.Tensor,
                      k: int):
    """q: (B, D) (normalized by the caller for cosine) -> (scores (B, k)
    f32, slots (B, k) int32). Masked-out rows never appear: their score is
    NEG_INF, and if fewer than k rows qualify the tail slots are -1. LIMIT
    k larger than the arena returns every qualifying row, padded to k."""
    n = store["emb"].shape[0]
    mask = predicate_mask(store, pred.to(store["emb"].device))
    q = q.to(store["emb"].device)
    scores = tile_scores(q, store["emb"], mask[None, :])
    idx = torch.arange(n, dtype=torch.int32,
                       device=q.device).expand(q.shape[0], n)
    top_s, top_i = topk_ordered(scores, idx, min(k, n))
    top_i = torch.where(top_s > NEG_INF, top_i, -1)
    pad = k - top_s.shape[1]
    if pad > 0:
        b = q.shape[0]
        top_s = torch.cat([top_s, top_s.new_full((b, pad), NEG_INF)], dim=1)
        top_i = torch.cat([top_i, top_i.new_full((b, pad), -1)], dim=1)
    return top_s, top_i.to(torch.int32)


def make_sharded_query(mesh, axes, n_rows: int, k: int,
                       placement_kind: str = "hash"):
    """Distributed unified query over a row-sharded corpus: the same masked
    scan per shard, each shard's local top-k, and one merge of the
    (shards x k) candidates, so the merge's payload is O(B x shards x k),
    independent of corpus size (the naive lowering would gather the full
    (B, N) score matrix).

    Thin wrapper over `repro_torch.kernels.arena_scan.sharded.
    make_sharded_arena_scan` (the engine entry point, which also returns
    the per-shard ``rows_scanned`` audit vector) keeping the 2-output
    contract ``query(store, q, pred) -> (scores, slots)``. Selection is
    exact lexicographic (score desc, global doc_id asc) -- placement-
    invariant by construction."""
    from repro_torch.kernels.arena_scan.sharded import make_sharded_arena_scan
    fn = make_sharded_arena_scan(mesh, axes, n_rows, k,
                                 placement_kind=placement_kind)

    def query(store, q, pred):
        scores, slots, _rows = fn(store, q, pred)
        return scores, slots

    return query


def _engine_error(engine: str) -> Exception:
    if engine == "pallas":
        return ValueError("engine 'pallas' is the TPU kernel; the port's "
                          "kernel engine is 'cuda'")
    return ValueError(f"unknown engine {engine!r}")


def unified_query(store: Store, q: torch.Tensor, pred: Predicate, k: int,
                  engine: str = "ref", page_rows: int | None = None):
    """Front door for one predicate group: ``engine="ref"`` runs
    `unified_query_ref`, ``"cuda"`` the arena-scan kernel (its plain
    version for a store on the CPU). ``page_rows`` selects the paged
    regime: the kernel's paged form, or for "ref" the streaming scan tiled
    at the page (through `unified_query_grouped`, as the reference does)."""
    dev = store["emb"].device
    pa = pred.as_array(dev)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    if engine == "ref":
        if page_rows is None:
            return unified_query_ref(store, q, pa, k)
        gids = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
        return unified_query_grouped(store, q, gids, pa[None, :], k,
                                     engine="ref", page_rows=page_rows)
    if engine == "cuda":
        from repro_torch.kernels.filtered_topk.ops import filtered_topk
        return filtered_topk(q, store["emb"], store["tenant"],
                             store["updated_at"], store["category"],
                             store["acl"], pa, k, page_rows=page_rows)
    raise _engine_error(engine)


#: Blocker predicate for padding a stacked (G, 4) predicate list to a pow2
#: group count: tenant -3 matches no live row (live rows have tenant >= 0
#: and -3 is not the "any tenant" sentinel -2), so a padding group masks
#: the whole arena and cannot perturb any real group's results.
BLOCK_ALL = Predicate(tenant=-3)


def stack_predicates(preds, device="cpu") -> torch.Tensor:
    """Stack lowered predicates into the (G, 4) int32 tensor the grouped
    scan consumes (each row is `Predicate.as_array()`, so the per-predicate
    device cache is reused).

    >>> tuple(stack_predicates([Predicate(), Predicate(tenant=3)]).shape)
    (2, 4)
    """
    return torch.stack([p.as_array(device) for p in preds])


def unified_query_grouped(store: Store, q, gids, preds, k: int,
                          engine: str = "ref", page_rows: int | None = None):
    """Grouped front door: ONE arena scan answers every predicate group.

    q: (B, D) stacked query rows across ALL groups; gids: (B,) int32 group
    id per row; preds: a list of G `Predicate`s (or a pre-stacked (G, 4)
    int32 tensor). Per query row the result is exactly
    ``unified_query(store, q[row], preds[gids[row]], k)``. ``engine="ref"``
    runs the streaming scan, ``"cuda"`` the kernel; ``page_rows`` selects
    the paged regime (same results). Returns (scores (B, k), slots (B,
    k))."""
    from repro_torch.kernels.grouped_topk.ops import grouped_topk
    dev = store["emb"].device
    pa = (stack_predicates(preds, dev) if isinstance(preds, (list, tuple))
          else torch.as_tensor(preds, dtype=torch.int32, device=dev))
    if engine not in ("ref", "cuda"):
        raise _engine_error(engine)
    return grouped_topk(q, store["emb"], store["tenant"],
                        store["updated_at"], store["category"], store["acl"],
                        gids, pa, k, use_kernel=(engine == "cuda"),
                        page_rows=page_rows)
