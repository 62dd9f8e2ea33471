"""`RagDB` -- one front door for the unified data layer (port of
``repro.api.ragdb``):

    db = RagDB(StoreConfig(...), warm_cfg=..., hot_window_s=..., now_ts=...)
    db.ingest(batch)                        # tier placement by recency
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

The storage engine is a `TieredRouter` (``db.router``): the hot arena's
`TransactionLog` (``db.log``), the warm similarity tier (a
`SplitStackClient`, probed with the predicate pushed down by "hot+warm"
plans) and the cold archive (`archive` / `fetch_cold`). Without
``warm_cfg`` the db is single-tier: the warm client holds one row and the
hot window never expires, so every plan routes "hot". With
``lexical_cfg`` a `LexicalArena` sits beside the hot arena as ``db.lex``
(written through the log's ``lex`` hook), and a tiered db grows warm lanes
that share its `LexicalStats`; it admits `QueryBuilder.match()` and
`.fuse()`: the hybrid dense+BM25 scan. `RagDB.build_index()` attaches an
`IVFIndex` as ``db.index`` (written through the log's ``ivf`` hook), which
adds the pruned "ivf" engine. ``mesh=`` (a `launch.mesh.Mesh`) row-shards
the hot arena in contiguous, slot-aligned regions (`ShardPlacement`,
"hash" or tenant-affine "tenant" placement) and adds the "sharded" engine:
one controller scans every shard's region (on the card, one arena-scan
kernel launch a scanned shard) and merges their lists exactly in (score,
doc_id) order. The mesh's shards may share one device (S logical shards
on one card, or on the CPU: one allocation, the plain arena) or sit on
several (`launch.mesh.device_groups`): then the hot arena is one
allocation a device (``core.store``), each region is written and scanned
on its own device, and the lists merge on ``device``, the controller,
which must be one of the mesh's. Over several devices the rest of the
layer follows the regions: the lexical lanes are one pair a device beside
each allocation (the BM25 statistics one, corpus-global), a hybrid scan
runs on every allocation's card and its lists merge by position (rrf per
signal, then fused), `build_index` assigns each device's rows there and
keeps one member-table mirror a device (the centroids and the quantizer
on the controller, every probe on its region's card), and the warm tier
lives on the controller, where hot+warm plans merge the hot lists with
its probes.
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
from repro_torch.api.planner import (PlannerConfig, check_engine_hint,
                                     compile_plan, degrade_plan)
from repro_torch.core.ivf import IVFConfig, IVFIndex, build_ivf
from repro_torch.core.router import TieredRouter
from repro_torch.core.store import (ALLOCS, DocBatch, ShardPlacement,
                                    StoreConfig, controller, gather, n_rows,
                                    resolve_device)
from repro_torch.core.tenancy import Principal, TenantRegistry, category_mask
from repro_torch.core.transactions import TransactionLog
from repro_torch.index.lexical import LexicalArena, LexicalConfig
from repro_torch.launch.mesh import device_groups, normalize_device
from repro_torch.launch.mesh import n_shards as mesh_shards
from repro_torch.obs import CalibrationTable, Tracer
from repro_torch.obs.tracer import NULL_TRACE, TraceGroup
from repro_torch.serving.faults import (FaultPlan, HotLaunchError,
                                        WedgedBatchError)

_FOREVER = (1 << 31) - 1     # hot window that never expires (single-tier mode)


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
    before_hot: int = 0               # stats watermarks for the router
    before_warm: int = 0              # counter reconciliation in finish()
    traces: list | None = None        # per-plan obs.Trace handles
    owns_traces: bool = False         # launch() created the traces


class RagDB:
    """Owns the storage engine (hot `TransactionLog` inside a
    `TieredRouter`, warm similarity tier, cold archive) and the
    `TenantRegistry`, and is the only object that executes query plans.
    ``device`` is where both tiers live: the card unless the caller asks
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
                 mesh=None, shard_axes=None, placement: str = "hash",
                 lexical_cfg: LexicalConfig | None = None,
                 result_cache_size: int = 256, shape_cache_size: int = 32,
                 device=None):
        tiered = warm_cfg is not None
        if tiered and hot_window_s is None:
            raise ValueError("a tiered RagDB (warm_cfg given) needs "
                             "hot_window_s to place and route documents")
        if not tiered:
            # single-tier mode: the warm client exists for the router's
            # plumbing but is never routed to (the hot window covers
            # everything) -- a 1-row arena instead of a copy of the hot one
            warm_cfg = dataclasses.replace(hot_cfg, capacity=1)
        # mesh-built RagDB: the hot arena is row-sharded in contiguous
        # slot-aligned regions (ShardPlacement); ``placement`` picks the
        # routing key -- "hash" (doc_id % S) or "tenant" (tenant % S, which
        # lets the sharded engine skip non-owning shards structurally)
        self.mesh = mesh
        self.shard_axes = (shard_axes if shard_axes is not None
                           else (tuple(mesh.axis_names) if mesh is not None
                                 else None))
        self.placement = placement if mesh is not None else None
        self.n_shards = 0
        hot_placement = hot_allocs = None
        if mesh is not None:
            self.n_shards = mesh_shards(mesh, self.shard_axes)
            hot_placement = ShardPlacement(n_shards=self.n_shards,
                                           capacity=hot_cfg.capacity,
                                           kind=placement)
            hot_allocs = self._mesh_allocs(mesh, hot_placement, device)
        self.router = TieredRouter(
            hot_cfg, warm_cfg,
            hot_window_s=hot_window_s if tiered else _FOREVER,
            now_ts=now_ts, hot_placement=hot_placement,
            hot_allocs=hot_allocs, device=device)
        # (k, n_rows, placement) -> ShardedScan (its shard count and
        # collective bytes are what the stats audit reads)
        self._sharded_fns: dict[tuple, object] = {}
        # lexical scoring arena (lexical_cfg given): postings lanes beside
        # the vector arena, slot-aligned and written through the log's lex
        # hook, so they commit with the rows; a tiered RagDB grows warm
        # lanes too, sharing the corpus-global LexicalStats so idf / avgdl
        # compare across the tier merge. None means match() is
        # structurally unavailable.
        self.lex: LexicalArena | None = None
        if lexical_cfg is not None:
            self.lex = LexicalArena(hot_cfg.capacity, lexical_cfg,
                                    device=self.log.device,
                                    allocs=hot_allocs)
            self.log.lex = self.lex
            if tiered:
                self.router.warm.attach_lexical(lexical_cfg, self.lex.stats)
        # ANN tier: hot-arena IVF index (build_index creates it); None means
        # the planner only has exact engines
        self.index: IVFIndex | None = None
        self._index_auto = False      # was the last build auto-sized?
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
        # through the commit log, the warm client and the launch/finish
        # path; a `WarmGuard` installed here wraps every warm probe
        self.faults = None
        self.warm_guard = None
        # the tracer is OFF by default; the calibration audit is always on
        self.tracer = Tracer(enabled=False)
        self.calibration = CalibrationTable()

    def _mesh_allocs(self, mesh, placement: ShardPlacement, device):
        """The hot arena's allocations over the mesh's devices: ((device,
        rows), ...) in row order, one a device, or None when every shard
        is on one device (the plain arena). The lexical lanes are laid out
        the same way. Raises on a mesh of mixed device types and on a
        controller (``device``) that is not one of the mesh's devices."""
        ctrl = resolve_device(device)
        groups = device_groups(mesh, self.shard_axes)
        if any(d.type != ctrl.type for d, _ in groups):
            raise ValueError(
                f"every device of the mesh must be a {ctrl.type} device, "
                f"as the controller ({ctrl}) is, got {mesh.devices}: arena "
                "regions on their own cards take one device type")
        if normalize_device(ctrl) not in {d for d, _ in groups}:
            raise ValueError(
                f"the controller device {ctrl} must be one of the mesh's "
                f"devices {tuple(d for d, _ in groups)}: it uploads the "
                "queries and merges the regions' lists")
        if len(groups) == 1:
            return None
        rows = placement.rows_per_shard
        return tuple((d, len(shards) * rows) for d, shards in groups)

    def attach_faults(self, plan) -> None:
        """Thread one `serving.faults.FaultPlan` through the injection
        sites: hot.launch / hot.wedge / hot.finish_error / cache.stale
        here, warm.error / warm.stall in the warm client, and the
        txn.<op>.<point> crash points in the log."""
        self.faults = plan
        self.log.faults = plan
        if plan is not None:
            plan.obs = self.tracer
        # the warm client always holds a plan (the filter_bug shim needs
        # one) -- detaching restores a fresh no-rule plan there
        self.router.warm.faults = plan if plan is not None else FaultPlan()

    def attach_tracer(self, tracer) -> None:
        """Install an `obs.Tracer` as this db's span-tree factory and
        active-sink stack (re-pointing the fault plan's and the warm
        guard's annotation hooks)."""
        self.tracer = tracer
        if self.faults is not None:
            self.faults.obs = tracer
        if self.warm_guard is not None:
            self.warm_guard.tracer = tracer

    # -- storage facade --------------------------------------------------
    @property
    def log(self) -> TransactionLog:
        return self.router.hot

    @property
    def hot_cfg(self) -> StoreConfig:
        return self.log.cfg

    @property
    def device(self) -> torch.device:
        return self.log.device

    def ingest(self, batch: DocBatch) -> None:
        """Tier placement by recency; registered tenants are quota-charged.
        Quotas are validated for the WHOLE batch before any charge or
        write."""
        tenants, counts = np.unique(torch.as_tensor(batch.tenant).cpu().numpy(),
                                    return_counts=True)
        charges = [(tid, n) for tid, n in zip(tenants.tolist(), counts.tolist())
                   if tid in self.tenants.doc_quota]
        for tid, n in charges:
            self.tenants.precheck(tid, n)
        self.router.ingest(batch)
        for tid, n in charges:
            self.tenants.charge(tid, n)
        self._maybe_rebuild_index()

    def _unknown(self, ids) -> list[int]:
        warm = self.router.warm
        return [d for d in ids if not (self.log.has_doc(d) or warm.has_doc(d))]

    def update(self, doc_ids, new_emb, updated_at) -> None:
        """Re-embed documents wherever the router placed them (hot log or
        warm client); an unknown doc_id raises KeyError before either tier
        is written. A warm doc whose fresh timestamp falls inside the hot
        window MOVES to the hot tier: recency-constrained queries are
        answered hot-only, so leaving it warm would hide it."""
        ids = [int(d) for d in doc_ids]
        unknown = self._unknown(ids)
        if unknown:
            raise KeyError(f"unknown doc_ids {unknown}")
        emb = torch.as_tensor(new_emb)
        ts = torch.as_tensor(updated_at).reshape(-1).cpu()
        hot = [i for i, d in enumerate(ids) if self.log.has_doc(d)]
        hot_set = set(hot)
        warm = [i for i in range(len(ids)) if i not in hot_set]
        if hot:
            self.log.update([ids[i] for i in hot], emb[hot], ts[hot])
        if warm:
            hot_floor = self.router.now_ts - self.router.hot_window_s
            promote = {i for i in warm if int(ts[i]) >= hot_floor}
            stay = [i for i in warm if i not in promote]
            if stay:
                self.router.warm.update([ids[i] for i in stay], emb[stay],
                                        ts[stay])
            if promote:
                self._promote_to_hot(sorted(promote), ids, emb, ts)
        self._maybe_rebuild_index()

    def _promote_to_hot(self, idx: list[int], ids, emb, ts) -> None:
        """Move docs from the warm client to the hot log, carrying their
        metadata, their postings lanes and the fresh embedding / timestamp.
        Quota is untouched: the docs were charged at ingest and stay live."""
        warm = self.router.warm
        wslots = torch.as_tensor([warm.slot_of(ids[i]) for i in idx],
                                 dtype=torch.int64, device=warm.device)
        meta = {k: warm.meta[k][wslots] for k in ("tenant", "category", "acl")}
        terms = tfs = None
        if warm.lex is not None:     # postings move with the doc
            terms, tfs = warm.lex.rows(wslots)
        warm.delete([ids[i] for i in idx])
        self.log.ingest(DocBatch(
            emb=emb[idx], tenant=meta["tenant"], category=meta["category"],
            updated_at=ts[idx].to(torch.int32), acl=meta["acl"],
            doc_id=torch.as_tensor([ids[i] for i in idx], dtype=torch.int32),
            terms=terms, tfs=tfs))

    def delete(self, doc_ids) -> None:
        """Tier-aware delete; an unknown doc_id raises KeyError before
        either tier is written. Refunds registered tenants' quota (slot
        recycling frees the arena rows, so the quota must free with them)."""
        uniq = list(dict.fromkeys(int(d) for d in doc_ids))
        unknown = self._unknown(uniq)
        if unknown:
            raise KeyError(f"unknown doc_ids {unknown}")
        hot_ids = [d for d in uniq if self.log.has_doc(d)]
        warm_ids = [d for d in uniq if not self.log.has_doc(d)]
        owners: list[int] = []
        if hot_ids:
            snap = self.log.snapshot()
            freed = self.log.delete(hot_ids)
            owners += gather(snap, "tenant", freed)
        if warm_ids:
            warm = self.router.warm
            wslots = torch.as_tensor([warm.slot_of(d) for d in warm_ids],
                                     device=warm.device)
            owners += warm.meta["tenant"][wslots].cpu().tolist()
            warm.delete(warm_ids)
        for tid in owners:
            if tid in self.tenants.doc_count and self.tenants.doc_count[tid] > 0:
                self.tenants.doc_count[tid] -= 1
        self._maybe_rebuild_index()

    def archive(self, doc_id: int, payload) -> None:
        self.router.archive(doc_id, payload)

    def fetch_cold(self, doc_id: int):
        return self.router.fetch_cold(doc_id)

    def create_tenant(self, quota: int = 1 << 30) -> int:
        return self.tenants.create_tenant(quota)

    # -- ANN tier (IVF index over the hot arena) --------------------------
    def build_index(self, cfg: IVFConfig | None = None) -> IVFIndex:
        """(Re)build the hot-arena IVF index on the arena's devices and
        attach it for incremental write-through maintenance. Adds "ivf" to
        the planner's candidate engines. ``cfg=None`` auto-sizes n_clusters
        near 2*sqrt(live rows). Over allocations on several devices each
        device assigns its own rows and holds its member-table mirror; the
        centroids stay on the controller (`core.ivf.build_ivf`).

        Every (re)build bumps the index epoch -- ivf-plan result-cache
        entries key on it, so a rebuild (which changes which rows get
        scored without any arena commit) can never serve a stale hit."""
        snap = self.log.snapshot()
        self._index_auto = cfg is None
        if cfg is None:
            # ~2*sqrt(N) clusters (pow2): fine enough that nprobe clusters
            # stay well under a quarter of the arena, coarse enough that the
            # centroid product stays negligible next to the pruned scan
            n_live = max(int(snap["n_live"]), 1)
            c = 1 << max(int(2 * n_live ** 0.5), 1).bit_length()
            cfg = IVFConfig(n_clusters=max(8, min(c, n_live)))
        epoch = self.index.epoch + 1 if self.index is not None else 0
        self.index = build_ivf(snap, cfg, epoch=epoch)
        self.log.ivf = self.index     # commits write through from here on
        return self.index

    def _maybe_rebuild_index(self) -> None:
        """Drift rule: once incremental churn passes the configured fraction
        of the built size, the centroids no longer describe the data --
        rebuild (synchronously). An auto-sized index re-auto-sizes, so
        n_clusters tracks the grown corpus."""
        if self.index is not None and self.index.needs_rebuild():
            self.build_index(None if self._index_auto else self.index.cfg)

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
            logical, n_rows=n_rows(snap),
            hot_window_s=self.router.hot_window_s, now_ts=self.router.now_ts,
            warm_rows=self.router.warm.n_docs, cfg=self.planner_cfg,
            device=controller(snap), index=self.index, lex=self.lex,
            warm_lex=self.router.warm.lex is not None,
            has_mesh=self.mesh is not None, mesh_shards=self.n_shards,
            placement=self.placement)

    def _sharded_fn(self, k: int):
        """The sharded scan (`kernels.arena_scan.sharded.ShardedScan`) for
        LIMIT ``k`` over the current arena shape, cached per (k, n_rows,
        placement)."""
        from repro_torch.kernels.arena_scan.sharded import \
            make_sharded_arena_scan
        rows = n_rows(self.log.snapshot())
        key = (k, rows, self.placement)
        fn = self._sharded_fns.get(key)
        if fn is None:
            fn = make_sharded_arena_scan(self.mesh, self.shard_axes, rows,
                                         k, placement_kind=self.placement)
            self._sharded_fns[key] = fn
        return fn

    def _result_key(self, plan: PhysicalPlan) -> tuple | None:
        """Snapshot-exact cache key for one plan, or None when the plan is
        uncacheable (no query rows). Hot-only plans pin the warm commit
        counter to -1: warm writes provably cannot change their results.
        Hybrid plans also key on their term ids (in the digest) and on the
        `LexicalStats` version, because a lexical write on EITHER tier
        moves idf/avgdl and therefore hybrid scores. ivf plans key on the
        index epoch: a rebuild changes which rows get SCORED without any
        arena commit."""
        lp = plan.logical
        if lp.q is None:
            return None
        q = np.ascontiguousarray(np.atleast_2d(lp.q), np.float32)
        h = hashlib.blake2b(q.tobytes(), digest_size=16)
        lex_version = -1
        if plan.engine == "hybrid" and self.lex is not None:
            h.update(repr(lp.match_terms).encode())
            lex_version = self.lex.stats.version
        warm_commits = (self.router.warm.commit_count
                        if plan.route == "hot+warm" else -1)
        index_epoch = (self.index.epoch
                       if plan.engine == "ivf" and self.index is not None
                       else -1)
        return (plan.group_key, q.shape, h.digest(), self.log.commit_count,
                warm_commits, index_epoch, lex_version)

    def degrade(self, plan: PhysicalPlan) -> PhysicalPlan | None:
        """One rung down the degradation ladder for ``plan`` in THIS db's
        compile context, or None when the ladder is exhausted (see
        planner.degrade_plan)."""
        snap = self.log.snapshot()
        return degrade_plan(
            plan, n_rows=n_rows(snap),
            hot_window_s=self.router.hot_window_s, now_ts=self.router.now_ts,
            warm_rows=self.router.warm.n_docs, cfg=self.planner_cfg,
            device=controller(snap), index=self.index, lex=self.lex,
            warm_lex=self.router.warm.lex is not None,
            has_mesh=self.mesh is not None, mesh_shards=self.n_shards,
            placement=self.placement)

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
        before_hot = before_warm = 0
        if misses:
            run_plans = [plans[i] for i, _ in misses]
            # only build the sharded scan when a mesh exists; otherwise
            # the executor raises its "requires a mesh-built RagDB" error
            needs_shard = (self.mesh is not None
                           and any(p.engine == "sharded" for p in run_plans))
            k = run_plans[0].logical.k
            before_hot = self.stats.hot_queries
            before_warm = self.stats.warm_queries
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
                    self.log.snapshot(), self.router.warm, run_plans,
                    sharded_fn=self._sharded_fn(k) if needs_shard else None,
                    stats=self.stats, shapes=self.shapes, index=self.index,
                    planner_cfg=self.planner_cfg, lex=self.lex,
                    warm_guard=self.warm_guard, obs=run_traces,
                    tracer=self.tracer, calib=self.calibration)
            finally:
                if group is not None:
                    self.tracer.pop()
        return PendingExecution(plans=list(plans), per_plan=per_plan,
                                rows=rows, misses=misses, inflight=inflight,
                                served=served, stale_age_s=stale_age_s,
                                use_cache=cache is not None,
                                before_hot=before_hot,
                                before_warm=before_warm,
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
            self.router.stats.hot_queries += (self.stats.hot_queries
                                              - pending.before_hot)
            self.router.stats.warm_queries += (self.stats.warm_queries
                                               - pending.before_warm)
            warm_failed = pending.inflight.warm_failed
            now = self.clock()
            off = 0
            for i, key in pending.misses:
                n = pending.rows[i]
                chunk = (s[off:off + n], sl[off:off + n], tr[off:off + n])
                pending.per_plan[i] = chunk
                p = pending.plans[i]
                if warm_failed and p.group_key in warm_failed:
                    # the guarded warm probe gave up: stamp the EXPLICIT
                    # degradation and keep the chunk OUT of the cache (the
                    # key does not encode degradation, so caching would
                    # later serve this hot-only answer as complete)
                    pending.plans[i] = dataclasses.replace(
                        p, degraded=p.degraded
                        + ("warm-unavailable: served hot-only",))
                    if (traces is not None and traces[i] is not None
                            and traces[i].enabled):
                        traces[i].annotate("degraded",
                                           pending.plans[i].degraded)
                        traces[i].pin("degraded")
                elif cache is not None and key is not None:
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
        if self.index is not None:
            ix = self.index
            index = (f"{ix.n_clusters} clusters (cap {ix.cluster_cap}, "
                     f"{len(ix.overflow)} overflow), epoch {ix.epoch}, "
                     f"churn {ix.churn}/{ix.n_at_build}")
        else:
            index = "none (exact scans only)"
        if self.lex is not None:
            lx = self.lex
            lexical = (f"{lx.stats.n_docs} docs with postings, vocab "
                       f"{lx.cfg.vocab_size}, {lx.cfg.doc_terms} lanes/doc, "
                       f"avgdl {lx.stats.avgdl:.1f}, "
                       f"stats v{lx.stats.version}")
        else:
            lexical = "none (match() unavailable)"
        st = self.stats
        lines = [
            f"RagDB  {n_rows(snap)} hot-tier rows "
            f"({int(snap['n_live'])} live), {self.router.warm.n_docs} warm docs, "
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
            f"  ivf index:    {index}",
            f"  lexical:      {lexical}",
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
        if self.mesh is not None:
            held = (f", held on {len(snap[ALLOCS])} devices"
                    if ALLOCS in snap else "")
            lines.append(
                f"  sharded:      {self.n_shards} shard(s) "
                f"({self.placement} placement{held}), "
                f"{st.collective_bytes} collective bytes moved, "
                f"per-shard rows scanned {st.shard_rows_scanned}")
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
        """Lexical clause: blend BM25 over the given terms into the
        ranking. ``text`` is a string (tokenized and hashed through the
        arena vocabulary) or an iterable of term ids; it lowers to unique
        term ids HERE, so the logical plan the planner sees is already
        vocabulary-resolved. Compiles to the "hybrid" engine (fused
        dense+BM25 one-pass scan); requires the RagDB to carry a lexical
        arena (``lexical_cfg``)."""
        lex = self._db.lex
        if lex is None:
            raise ValueError("match() requires a lexical arena — construct "
                             "the RagDB with lexical_cfg=LexicalConfig(...)")
        ids = lex.lower_terms(text)
        if not ids:
            raise ValueError(f"match() lowered to no valid terms: {text!r}")
        return self._with(match_terms=ids)

    def fuse(self, mode: str = "wsum", *, w_dense: float = 1.0,
             w_lex: float = 1.0) -> "QueryBuilder":
        """Score-mix knobs for a match() query: ``"wsum"`` ranks on
        w_dense*dense + w_lex*bm25 in one running top-k; ``"rrf"`` retrieves
        both per-signal k-lists in the same scan and fuses by reciprocal
        rank (weights unused). The mix is part of the plan's group key, so
        differently-fused queries never share a device program."""
        if mode not in ("wsum", "rrf"):
            raise ValueError(f"unknown fusion mode {mode!r} "
                             "(expected 'wsum' or 'rrf')")
        return self._with(fusion=mode, w_dense=float(w_dense),
                          w_lex=float(w_lex))

    def using(self, engine: str) -> "QueryBuilder":
        """Force an execution engine: "ref" (plain PyTorch, on the store's
        device), "cuda" (the arena-scan kernel), "sharded" (the scan per
        shard region of a mesh-built RagDB; without a mesh plan() raises)
        or "ivf" (the pruned probe,
        overriding the planner's selectivity guard: an under-filled probe
        is completed by the executor's exact rescan, so forcing "ivf"
        trades speed, never completeness; it requires
        `RagDB.build_index()` first, or plan() raises). match() queries
        always run on "hybrid", so a conflicting hint is refused at plan
        time, as is "hybrid" without a match() clause. "pallas", the TPU
        kernel's name, is refused here."""
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
