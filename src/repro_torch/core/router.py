"""Three-tier deployment router -- paper §7.3 (port of
``repro.core.router``).

  Tier 1 HOT   unified store (this paper): recent docs / hot tenants; full
               predicate model, transactional freshness. 10-30 % of corpus,
               80-90 % of traffic.
  Tier 2 WARM  similarity-only store (a "specialized vector DB",
               `SplitStackClient`): long-tail corpus where pure similarity
               dominates; probed with the predicate pushed down.
  Tier 3 COLD  host archive ("object storage"): explicit fetch by doc id,
               no vector index, no device residency.

The router preserves the paper's key claim at scale: multi-constraint
queries never leave the unified tier; only low-constraint long-tail
similarity spills to the warm tier.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.query import Predicate
from repro_torch.core.splitstack import SplitStackClient
from repro_torch.core.store import DocBatch, StoreConfig, controller, n_rows
from repro_torch.core.transactions import TransactionLog


@dataclasses.dataclass
class RouteStats:
    """Counters are per query ROW (a (B, D) call counts B), matching the
    front-door ExecStats so shim and session traffic aggregate coherently."""
    hot_queries: int = 0
    warm_queries: int = 0
    cold_fetches: int = 0


class TieredResult(tuple):
    """The (scores, slots, tiers) triple `TieredRouter.query` returns, with
    the planner's decisions attached: ``.engine`` is the engine that ran
    ("ref" | "cuda" | "ivf") and ``.route`` the tier route ("hot" |
    "hot+warm"). Callers that unpack three values keep working.

    >>> r = TieredResult(1, 2, 3, engine="ref", route="hot")
    >>> s, sl, tr = r; (r.engine, r.route, tr)
    ('ref', 'hot', 3)
    """

    def __new__(cls, scores, slots, tiers, *, engine: str, route: str):
        self = super().__new__(cls, (scores, slots, tiers))
        self.engine = engine
        self.route = route
        return self


def _take(batch: DocBatch, sel: np.ndarray) -> DocBatch:
    """The rows ``sel`` of a batch, gathered where each column lies."""
    def pick(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x[torch.from_numpy(sel).to(x.device)]
        return np.asarray(x)[sel]
    return DocBatch(*(pick(getattr(batch, f.name))
                      for f in dataclasses.fields(DocBatch)))


class TieredRouter:
    """Places documents by recency (``updated_at >= now_ts -
    hot_window_s`` goes hot) into a hot `TransactionLog` and a warm
    `SplitStackClient` on ``device`` (the card unless the caller asks for
    another), and keeps the cold archive on the host. ``hot_allocs``
    ((device, rows), ...) lays the hot arena out in one allocation a
    device, ``device`` the controller (`core.store.empty`)."""

    def __init__(self, hot_cfg: StoreConfig, warm_cfg: StoreConfig, *,
                 hot_window_s: int, now_ts: int, hot_placement=None,
                 hot_allocs=None, device=None):
        self.hot = TransactionLog(hot_cfg, placement=hot_placement,
                                  device=device, allocs=hot_allocs)
        self.warm = SplitStackClient(warm_cfg, device=self.hot.device)
        self.cold: dict[int, dict[str, Any]] = {}
        self.hot_window_s = hot_window_s
        self.now_ts = now_ts
        self.stats = RouteStats()

    # -- ingest: placement policy ---------------------------------------
    def ingest(self, batch: DocBatch) -> None:
        ts = torch.as_tensor(batch.updated_at).cpu().numpy()
        hot_sel = ts >= self.now_ts - self.hot_window_s
        idx_hot = np.nonzero(hot_sel)[0]
        idx_warm = np.nonzero(~hot_sel)[0]
        if len(idx_hot):
            self.hot.ingest(_take(batch, idx_hot))
        if len(idx_warm):
            self.warm.ingest(_take(batch, idx_warm))

    def archive(self, doc_id: int, payload: dict[str, Any]) -> None:
        self.cold[doc_id] = payload

    # -- query routing ---------------------------------------------------
    def query(self, q, pred: Predicate, k: int, *,
              engine: str | None = None) -> TieredResult:
        """Compatibility shim over the front-door planner / executor (the
        routing rule lives in `api.planner.choose_route`): multi-constraint
        queries within the hot window stay hot-only; long-tail similarity
        also probes the warm tier and merges. ``engine=None`` lets the
        planner choose; the result carries ``.engine`` / ``.route``."""
        # imported lazily: repro_torch.api imports this module
        from repro_torch.api.executor import query_tiered
        from repro_torch.api.plan import logical_from_predicate
        from repro_torch.api.planner import choose_engine, choose_route

        q = np.atleast_2d(np.asarray(torch.as_tensor(q).cpu(), np.float32))
        logical = logical_from_predicate(pred, k=k, engine=engine)
        snap = self.hot.snapshot()
        eng, _ = choose_engine(logical, n_rows=n_rows(snap),
                               device=controller(snap))
        route, _ = choose_route(logical, hot_window_s=self.hot_window_s,
                                now_ts=self.now_ts,
                                warm_rows=self.warm.n_docs)
        self.stats.hot_queries += q.shape[0]
        if route == "hot+warm":
            self.stats.warm_queries += q.shape[0]
        s, sl, tr = query_tiered(snap, self.warm, q, pred, k, engine=eng,
                                 probe_warm=(route == "hot+warm"))
        return TieredResult(s, sl, tr, engine=eng, route=route)

    def fetch_cold(self, doc_id: int):
        self.stats.cold_fetches += 1
        return self.cold.get(doc_id)
