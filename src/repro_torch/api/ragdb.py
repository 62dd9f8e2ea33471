"""`RagDB` -- one front door for the unified data layer (port of
``repro.api.ragdb``, single-tier):

    db = RagDB(StoreConfig(...))            # device="cuda" by default
    db.ingest(batch)
    sess = db.session(Principal(tenant_id=3, group_bits=0b0011))
    res = (sess.search(q_emb)
               .newer_than(ccfg.now_ts - 60 * DAY_S)
               .in_categories([1, 2])
               .limit(5)
               .run())
    print(res.plan.explain())

Isolation is structural: a `Session` exists only via `db.session(principal)`,
the builder exposes no method that could name a tenant or widen ACL bits,
and the lowered `LogicalPlan` stamps both clauses from the principal before
the planner sees the query. Batched callers lower one plan per request and
hand them to `db.execute`, which collapses plans sharing a predicate group
into one device call each, fuses exact-engine groups into ONE grouped arena
scan, and launches every call before the first sync.

This slice holds the hot arena's `TransactionLog` directly as ``db.log``.
The warm tier and router, the cold archive, IVF, the lexical arena and the
mesh arrive with later slices; their constructor arguments and builder
methods raise NotImplementedError naming their ROADMAP queue item.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.api.executor import (CompiledShapes, ExecStats,
                                      InFlightPlans, finish_plans,
                                      launch_plans)
from repro_torch.api.plan import ALL_BITS, ANY_TENANT, LogicalPlan, PhysicalPlan
from repro_torch.api.planner import (LATER_ENGINES, PlannerConfig,
                                     check_engine_hint, compile_plan,
                                     degrade_plan)
from repro_torch.core.store import DocBatch, StoreConfig
from repro_torch.core.tenancy import Principal, TenantRegistry, category_mask
from repro_torch.core.transactions import TransactionLog
from repro_torch.obs import CalibrationTable, Tracer
from repro_torch.obs.tracer import NULL_TRACE, TraceGroup
from repro_torch.serving.faults import HotLaunchError, WedgedBatchError

_FOREVER = (1 << 31) - 1     # hot window that never expires (single-tier mode)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it arrives with "
                               f"the {where}")


@dataclasses.dataclass(frozen=True, eq=False)
class QueryResult:
    """What `QueryBuilder.run()` returns: result arrays plus the compiled
    plan that produced them (`res.plan.explain()` for the audit trail)."""
    scores: np.ndarray           # (B, k) f32, NEG_INF beyond the fill
    slots: np.ndarray            # (B, k) i32 hot-tier slots, -1 padding
    tiers: np.ndarray            # (B, k) i32, 0 = hot, 1 = warm
    plan: PhysicalPlan
    cached: bool = False         # True when served from the result cache


class ResultCache:
    """Snapshot-exact session result cache (LRU).

    Keys are ``(plan group key, query digest, hot commit_count, ...)``. A
    write can only be observed through a NEW snapshot, every write bumps
    the commit counter, and the counter is part of the key -- so a stale
    hit is impossible by construction. Each entry also records its insert
    time and its *stale key* (the identity without the counters), for
    staleness-bounded serves (`get_stale`).

    >>> rc = ResultCache(cap=2)
    >>> rc.put(("k1", 0), "r1"); rc.get(("k1", 0))
    'r1'
    >>> rc.get(("k1", 1)) is None     # a bumped commit counter never hits
    True
    >>> rc.put(("k2", 0), "r2"); rc.put(("k3", 0), "r3")   # evicts ("k1", 0)
    >>> rc.get(("k1", 0)) is None
    True
    >>> (rc.hits, rc.misses)
    (1, 2)
    >>> rc2 = ResultCache(cap=4)
    >>> rc2.put(("g", "q", 7), "old", now=10.0, stale_key=("g", "q"))
    >>> value, age = rc2.get_stale(("g", "q"), now=10.4, max_age_s=0.5)
    >>> value, round(age, 6)
    ('old', 0.4)
    >>> rc2.get_stale(("g", "q"), now=11.0, max_age_s=0.5) is None
    True
    """

    def __init__(self, cap: int = 256):
        self.cap = cap
        # key -> (value, insert time, stale_key-or-None)
        self._lru: OrderedDict[tuple, tuple] = OrderedDict()
        self._latest: dict[tuple, tuple] = {}   # stale_key -> newest full key
        self.hits = 0
        self.misses = 0
        self.stale_hits = 0

    def __len__(self) -> int:
        return len(self._lru)

    def get(self, key: tuple):
        hit = self._lru.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._lru.move_to_end(key)
        return hit[0]

    def get_stale(self, stale_key: tuple, *, now: float, max_age_s: float):
        """The newest entry sharing this plan+query identity, if it is at
        most ``max_age_s`` seconds old: (value, age_s), or None."""
        full = self._latest.get(stale_key)
        ent = self._lru.get(full) if full is not None else None
        if ent is None:
            return None
        value, t, _ = ent
        age = now - t
        if age > max_age_s:
            return None
        self.stale_hits += 1
        self._lru.move_to_end(full)
        return value, age

    def newest(self, stale_key: tuple):
        """The newest full-key entry for this plan+query identity IGNORING
        the commit-epoch components (the raw read a poisoned cache layer
        would serve): (full_key, value) or None; counts nothing."""
        full = self._latest.get(stale_key)
        ent = self._lru.get(full) if full is not None else None
        if ent is None:
            return None
        return full, ent[0]

    def put(self, key: tuple, value, *, now: float = 0.0,
            stale_key: tuple | None = None) -> None:
        self._lru[key] = (value, now, stale_key)
        self._lru.move_to_end(key)     # re-put of a resident key is a use
        if stale_key is not None:
            self._latest[stale_key] = key
        while len(self._lru) > self.cap:
            old_key, (_, _, sk) = self._lru.popitem(last=False)
            if sk is not None and self._latest.get(sk) == old_key:
                del self._latest[sk]


@dataclasses.dataclass
class PendingExecution:
    """A `RagDB.launch`ed batch awaiting `RagDB.finish`. ``served`` records
    per-plan provenance: "cache", "stale" or "fresh"."""
    plans: list[PhysicalPlan]
    per_plan: list[tuple | None]      # cache-served chunks; misses are None
    rows: list[int]                   # query rows per plan (concat offsets)
    misses: list[tuple[int, tuple | None]]   # (plan index, cache key)
    inflight: InFlightPlans | None    # executor handle; None = all cached
    served: list[str]                 # "cache" | "stale" | "fresh" per plan
    stale_age_s: list[float | None]   # age of each stale serve, else None
    use_cache: bool
    traces: list | None = None        # per-plan obs.Trace handles
    owns_traces: bool = False         # launch() created the traces


class RagDB:
    """Owns the hot arena's `TransactionLog` (``db.log``) and the
    `TenantRegistry`, and is the only object that executes query plans.
    ``device`` is where the arena lives: the card unless the caller asks
    for another; with no card and no ``device="cpu"`` it raises.

    >>> import numpy as np, torch
    >>> from repro_torch.core.store import DocBatch, StoreConfig
    >>> from repro_torch.core.tenancy import Principal
    >>> db = RagDB(StoreConfig(capacity=8, dim=4), device="cpu")
    >>> db.ingest(DocBatch(
    ...     emb=torch.eye(3, 4), tenant=torch.tensor([0, 0, 1]),
    ...     category=torch.tensor([0, 1, 0]),
    ...     updated_at=torch.tensor([10, 20, 30]),
    ...     acl=torch.tensor([1, 1, 1]), doc_id=torch.arange(3)))
    >>> sess = db.session(Principal(tenant_id=0, group_bits=0x1))
    >>> q = np.array([1.0, 0, 0, 0], np.float32)
    >>> res = sess.search(q).limit(2).run()
    >>> res.slots[0].tolist()        # doc 2 is tenant 1: structurally invisible
    [0, 1]
    >>> res.cached
    False
    >>> sess.search(q).limit(2).run().cached   # same snapshot: exact cache hit
    True
    >>> db.delete([0])                         # a write bumps commit_count ...
    >>> sess.search(q).limit(2).run().cached   # ... so the hit is impossible
    False
    """

    def __init__(self, hot_cfg: StoreConfig, *, warm_cfg: StoreConfig | None = None,
                 hot_window_s: int | None = None, now_ts: int = 0,
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 mesh=None, lexical_cfg=None,
                 result_cache_size: int = 256, shape_cache_size: int = 32,
                 device=None):
        if warm_cfg is not None or hot_window_s is not None:
            raise _not_ported("the warm tier (warm_cfg / hot_window_s)",
                              "warm-tier slice (ROADMAP queue 1, 'Warm tier and router')")
        if mesh is not None:
            raise _not_ported("mesh=", LATER_ENGINES["sharded"])
        if lexical_cfg is not None:
            raise _not_ported("lexical_cfg=", LATER_ENGINES["hybrid"])
        self.log = TransactionLog(hot_cfg, device=device)
        self.hot_window_s = _FOREVER
        self.now_ts = now_ts
        self.tenants = TenantRegistry()
        self.planner_cfg = planner_cfg
        self.stats = ExecStats()
        # monotonic clock for cache-entry ages; tests override it
        self.clock = time.monotonic
        self.shapes = (CompiledShapes(shape_cache_size)
                       if shape_cache_size else None)
        self.result_cache = (ResultCache(result_cache_size)
                             if result_cache_size else None)
        # chaos wiring (serving.faults): attach_faults threads one FaultPlan
        # through the commit log and the launch/finish path
        self.faults = None
        # the tracer is OFF by default; the calibration audit is always on
        self.tracer = Tracer(enabled=False)
        self.calibration = CalibrationTable()

    def attach_faults(self, plan) -> None:
        """Thread one `serving.faults.FaultPlan` through the injection
        sites: hot.launch / hot.wedge / hot.finish_error / cache.stale
        here, and the txn.<op>.<point> crash points in the log."""
        self.faults = plan
        self.log.faults = plan
        if plan is not None:
            plan.obs = self.tracer

    def attach_tracer(self, tracer) -> None:
        """Install an `obs.Tracer` as this db's span-tree factory and
        active-sink stack."""
        self.tracer = tracer
        if self.faults is not None:
            self.faults.obs = tracer

    # -- storage facade --------------------------------------------------
    @property
    def hot_cfg(self) -> StoreConfig:
        return self.log.cfg

    @property
    def device(self) -> torch.device:
        return self.log.device

    def ingest(self, batch: DocBatch) -> None:
        """Registered tenants are quota-charged; quotas are validated for
        the WHOLE batch before any charge or write."""
        tenants, counts = np.unique(torch.as_tensor(batch.tenant).cpu().numpy(),
                                    return_counts=True)
        charges = [(tid, n) for tid, n in zip(tenants.tolist(), counts.tolist())
                   if tid in self.tenants.doc_quota]
        for tid, n in charges:
            self.tenants.precheck(tid, n)
        self.log.ingest(batch)
        for tid, n in charges:
            self.tenants.charge(tid, n)

    def update(self, doc_ids, new_emb, updated_at) -> None:
        """Re-embed documents; an unknown doc_id raises KeyError (before
        anything is written)."""
        ids = [int(d) for d in doc_ids]
        unknown = [d for d in ids if not self.log.has_doc(d)]
        if unknown:
            raise KeyError(f"unknown doc_ids {unknown}")
        ts = torch.as_tensor(updated_at).reshape(-1)
        self.log.update(ids, new_emb, ts)

    def delete(self, doc_ids) -> None:
        """Delete documents; refunds registered tenants' quota (slot
        recycling frees the arena rows, so the quota must free with them)."""
        uniq = list(dict.fromkeys(int(d) for d in doc_ids))
        unknown = [d for d in uniq if not self.log.has_doc(d)]
        if unknown:
            raise KeyError(f"unknown doc_ids {unknown}")
        snap = self.log.snapshot()
        freed = self.log.delete(uniq)
        owners = snap["tenant"][torch.as_tensor(freed, device=self.device)]
        for tid in owners.cpu().tolist():
            if tid in self.tenants.doc_count and self.tenants.doc_count[tid] > 0:
                self.tenants.doc_count[tid] -= 1

    def create_tenant(self, quota: int = 1 << 30) -> int:
        return self.tenants.create_tenant(quota)

    def build_index(self, cfg=None):
        raise _not_ported("build_index()", LATER_ENGINES["ivf"])

    # -- sessions (the only way to query) --------------------------------
    def session(self, principal: Principal) -> "Session":
        return Session(self, principal)

    def admin_session(self) -> "Session":
        """Trusted-operator session: no tenant clause, all ACL groups.
        For benchmarks and system maintenance, never request handling."""
        return Session(self, Principal(tenant_id=ANY_TENANT, group_bits=ALL_BITS))

    # -- planning + execution --------------------------------------------
    def compile(self, logical: LogicalPlan) -> PhysicalPlan:
        snap = self.log.snapshot()
        return compile_plan(
            logical, n_rows=snap["emb"].shape[0],
            hot_window_s=self.hot_window_s, now_ts=self.now_ts,
            warm_rows=0, cfg=self.planner_cfg, device=snap["emb"].device)

    def _result_key(self, plan: PhysicalPlan) -> tuple | None:
        """Snapshot-exact cache key for one plan, or None when the plan is
        uncacheable (no query rows). The warm commit counter, index epoch
        and lexical version keep their places in the key, pinned to -1
        until their slices exist."""
        lp = plan.logical
        if lp.q is None:
            return None
        q = np.ascontiguousarray(np.atleast_2d(lp.q), np.float32)
        digest = hashlib.blake2b(q.tobytes(), digest_size=16).digest()
        return (plan.group_key, q.shape, digest, self.log.commit_count,
                -1, -1, -1)

    def degrade(self, plan: PhysicalPlan) -> PhysicalPlan | None:
        """One rung down the degradation ladder for ``plan``, or None when
        the ladder is exhausted (see planner.degrade_plan)."""
        return degrade_plan(plan)

    def execute(self, plans: list[PhysicalPlan], *, use_cache: bool = True,
                stale_within_s: float | None = None):
        """Predicate-group batched, fusion-aware execution: cached plans are
        answered without device work, the rest run as one `launch_plans` /
        `finish_plans` pair. ``stale_within_s`` also allows serving the
        newest cached result of the SAME plan+query from an older snapshot
        that is at most that many seconds old."""
        return self.finish(self.launch(plans, use_cache=use_cache,
                                       stale_within_s=stale_within_s))

    def launch(self, plans: list[PhysicalPlan], *, use_cache: bool = True,
               stale_within_s: float | None = None,
               traces: list | None = None) -> "PendingExecution":
        """Cache lookups + launch of every missing plan, WITHOUT a device
        sync. ``traces`` (one obs.Trace per plan) carries caller-owned span
        trees; with the tracer enabled and none given, launch creates them
        and finish() finishes them."""
        owns_traces = False
        if traces is None and self.tracer.enabled:
            traces = [self.tracer.trace("request", engine=p.engine,
                                        route=p.route) for p in plans]
            owns_traces = True
        per_plan: list[tuple | None] = [None] * len(plans)
        rows = [1 if p.logical.q is None
                else int(np.atleast_2d(p.logical.q).shape[0]) for p in plans]
        served = ["fresh"] * len(plans)
        stale_age_s: list[float | None] = [None] * len(plans)
        misses: list[tuple[int, tuple | None]] = []
        cache = self.result_cache if use_cache else None
        now = self.clock()
        for i, p in enumerate(plans):
            t = (traces[i] if traces is not None and traces[i] is not None
                 else NULL_TRACE)
            if t.enabled and p.degraded:
                t.annotate("degraded", p.degraded)
                t.pin("degraded")
            sid = (t.begin("cache_lookup")
                   if t.enabled and cache is not None else None)
            key = self._result_key(p) if cache is not None else None
            hit = cache.get(key) if key is not None else None
            if hit is not None:
                per_plan[i] = hit
                served[i] = "cache"
                if sid is not None:
                    t.end(sid, outcome="hit")
                continue
            if self.faults is not None and key is not None:
                # chaos site cache.stale: a buggy cache layer serves the
                # newest entry ignoring commit epochs; the epoch guard
                # refuses it and the query computes fresh
                self.tracer.push(t)
                try:
                    fired = self.faults.fires("cache.stale")
                finally:
                    self.tracer.pop()
                if fired:
                    poisoned = cache.newest(key[:3])
                    if poisoned is not None and poisoned[0] != key:
                        self.stats.stale_epoch_rejected += 1
                        if t.enabled:
                            t.annotate_current("stale_epoch_rejected", True)
            if key is not None and stale_within_s is not None:
                stale = cache.get_stale(key[:3], now=now,
                                        max_age_s=stale_within_s)
                if stale is not None:
                    per_plan[i], stale_age_s[i] = stale
                    served[i] = "stale"
                    self.stats.stale_serves += 1
                    if sid is not None:
                        t.end(sid, outcome="stale", age_s=stale[1])
                    continue
            if sid is not None:
                t.end(sid, outcome="miss")
            misses.append((i, key))
        inflight = None
        if misses:
            run_plans = [plans[i] for i, _ in misses]
            run_traces = ([traces[i] for i, _ in misses]
                          if traces is not None else None)
            group = TraceGroup(run_traces) if run_traces is not None else None
            if group is not None:
                self.tracer.push(group)
            try:
                if self.faults is not None:
                    # chaos site hot.launch: dispatch fails before anything
                    # is issued
                    self.faults.raise_if("hot.launch", HotLaunchError)
                inflight = launch_plans(
                    self.log.snapshot(), run_plans, stats=self.stats,
                    shapes=self.shapes, planner_cfg=self.planner_cfg,
                    obs=run_traces, calib=self.calibration)
            finally:
                if group is not None:
                    self.tracer.pop()
        return PendingExecution(plans=list(plans), per_plan=per_plan,
                                rows=rows, misses=misses, inflight=inflight,
                                served=served, stale_age_s=stale_age_s,
                                use_cache=cache is not None,
                                traces=traces, owns_traces=owns_traces)

    def finish(self, pending: "PendingExecution"):
        """Sync a `launch`ed batch (the first copy to the host), fill the
        result cache, and concatenate per-plan chunks into (scores, slots,
        tiers) in plan order."""
        cache = self.result_cache if pending.use_cache else None
        traces = pending.traces
        if pending.inflight is not None:
            run_traces = ([traces[i] for i, _ in pending.misses]
                          if traces is not None else None)
            group = TraceGroup(run_traces) if run_traces is not None else None
            if group is not None:
                self.tracer.push(group)
            try:
                if self.faults is not None:
                    self.faults.stall("hot.wedge")
                    self.faults.raise_if("hot.finish_error",
                                         WedgedBatchError)
                s, sl, tr = finish_plans(pending.inflight)
            finally:
                if group is not None:
                    self.tracer.pop()
            now = self.clock()
            off = 0
            for i, key in pending.misses:
                n = pending.rows[i]
                chunk = (s[off:off + n], sl[off:off + n], tr[off:off + n])
                pending.per_plan[i] = chunk
                if cache is not None and key is not None:
                    cache.put(key, chunk, now=now, stale_key=key[:3])
                off += n
        if traces is not None:
            for i, t in enumerate(traces):
                if t is None or not t.enabled:
                    continue
                t.annotate("served", pending.served[i])
                if pending.stale_age_s[i] is not None:
                    t.annotate("stale_age_s", pending.stale_age_s[i])
                if pending.owns_traces:
                    t.finish()
        # concatenation copies, so cached arrays are never aliased to callers
        return tuple(np.concatenate([c[j] for c in pending.per_plan], axis=0)
                     for j in range(3))

    def explain(self) -> str:
        """Session-level counters (the per-query twin is
        `PhysicalPlan.explain()`), in the reference's line format."""
        snap = self.log.snapshot()
        cm = self.planner_cfg.cost_model
        planner = ("cost model loaded "
                   f"({len(cm.curves)} engine curve(s))" if cm is not None
                   else "static thresholds (no cost model loaded)")
        if self.shapes is not None:
            shapes = (f"{len(self.shapes)} resident, "
                      f"{self.shapes.hits} hits / {self.shapes.misses} misses")
        else:
            shapes = "disabled"
        if self.result_cache is not None:
            rc = self.result_cache
            results = (f"{len(rc)} entries, "
                       f"{rc.hits} hits / {rc.misses} misses")
        else:
            results = "disabled"
        st = self.stats
        lines = [
            f"RagDB  {snap['emb'].shape[0]} hot-tier rows "
            f"({int(snap['n_live'])} live), 0 warm docs, "
            f"commit_count={self.log.commit_count}",
            f"  planner:      {planner}",
            f"  shape cache:  {shapes}",
            f"  result cache: {results}",
            f"  exec stats:   {st.device_calls} device calls, "
            f"{st.queries} queries ({st.hot_queries} hot, "
            f"{st.warm_queries} warm), {st.padded_rows} padded rows, "
            f"{st.rows_scanned} rows scanned, "
            f"{st.terms_scanned} term lanes scanned",
            f"  grouped scan: fused {st.fused_groups} groups -> "
            f"{st.fused_scans} scans "
            f"({max(st.fused_groups - st.fused_scans, 0)} arena scans saved)",
            f"  serving:      {st.degraded_plans} degraded plans, "
            f"{st.stale_serves} stale serves (within declared bound), "
            f"{st.warm_failovers} warm failovers (hot-only), "
            f"{st.stale_epoch_rejected} stale-epoch cache reads rejected",
            "  ivf index:    none (exact scans only)",
            "  lexical:      none (match() unavailable)",
            f"  calibration:  {self.calibration.explain_line()}",
        ]
        if self.tracer.enabled:
            rec = self.tracer.recorder
            recorded = ("no flight recorder" if rec is None else
                        f"{rec.recorded} recorded "
                        f"({len(rec.pinned)} pinned, {rec.pin_drops} "
                        f"pin drops)")
            lines.append(f"  tracing:      on, "
                         f"{self.tracer.traces_started} traces started, "
                         f"{recorded}")
        if self.faults is not None:
            f = self.faults
            lines.append(
                f"  faults:       {f.total_fired()} injected across "
                f"{len(f.fired)} site(s) (seed {f.seed})")
        return "\n".join(lines)


class Session:
    """A principal-scoped handle. Tenant and ACL clauses are stamped here,
    from the authenticated principal -- the builder cannot express them."""

    def __init__(self, db: RagDB, principal: Principal):
        self._db = db
        self.principal = principal

    def search(self, q_emb, *, normalize: bool = True) -> "QueryBuilder":
        """Start a query from a (D,) or (B, D) embedding (numpy or tensor).
        `normalize=True` unit-normalizes rows (required for cosine scores;
        pass False if the caller already normalized)."""
        if isinstance(q_emb, torch.Tensor):
            q_emb = q_emb.detach().cpu().numpy()
        q = np.atleast_2d(np.asarray(q_emb, np.float32))
        if normalize and self._db.hot_cfg.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        logical = LogicalPlan(
            tenant=self.principal.tenant_id,
            acl_bits=self.principal.group_bits & ALL_BITS, q=q)
        return QueryBuilder(self._db, logical)


@dataclasses.dataclass(frozen=True, eq=False)
class QueryBuilder:
    """Immutable, composable chain; each step returns a new builder. Lowers
    to a LogicalPlan (`lower()`), compiles to a PhysicalPlan (`plan()`),
    executes (`run()`)."""
    _db: RagDB
    _logical: LogicalPlan

    def _with(self, **changes) -> "QueryBuilder":
        return QueryBuilder(self._db, dataclasses.replace(self._logical, **changes))

    def newer_than(self, min_ts: int) -> "QueryBuilder":
        """Recency clause: keep rows with ``updated_at >= min_ts``."""
        return self._with(min_ts=int(min_ts))

    def in_categories(self, categories) -> "QueryBuilder":
        """Category clause: keep rows whose category id is in the set
        (ids must be in [0, 32); validated here, where bad input enters)."""
        cats = tuple(sorted(set(int(c) for c in categories)))
        category_mask(cats)
        return self._with(categories=cats)

    def limit(self, k: int) -> "QueryBuilder":
        """LIMIT: return the top ``k`` qualifying rows per query."""
        return self._with(k=int(k))

    def match(self, text) -> "QueryBuilder":
        raise _not_ported("match()", LATER_ENGINES["hybrid"])

    def fuse(self, mode: str = "wsum", *, w_dense: float = 1.0,
             w_lex: float = 1.0) -> "QueryBuilder":
        raise _not_ported("fuse()", LATER_ENGINES["hybrid"])

    def using(self, engine: str) -> "QueryBuilder":
        """Force an execution engine: "ref" (plain PyTorch, on the store's
        device) or "cuda" (the arena-scan kernel). "pallas" and the engines
        of later slices are refused here."""
        check_engine_hint(engine)
        return self._with(engine=engine)

    def lower(self) -> LogicalPlan:
        """The declarative LogicalPlan this chain lowers to (tenant/ACL
        clauses already stamped from the session principal)."""
        return self._logical

    def plan(self) -> PhysicalPlan:
        """Compile through the planner: engine + route + group key."""
        return self._db.compile(self._logical)

    def explain(self) -> str:
        """The compiled plan rendered SQL-EXPLAIN style."""
        return self.plan().explain()

    def run(self) -> QueryResult:
        """Compile and execute; `QueryResult.cached` reports whether the
        result came from the snapshot-exact session cache."""
        phys = self.plan()
        rc = self._db.result_cache
        hits0 = rc.hits if rc is not None else 0
        scores, slots, tiers = self._db.execute([phys])
        cached = rc is not None and rc.hits > hits0
        return QueryResult(scores=scores, slots=slots, tiers=tiers, plan=phys,
                           cached=cached)
