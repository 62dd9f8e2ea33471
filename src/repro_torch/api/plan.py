"""Logical and physical query plans — the middle of the front door (port of
``repro.api.plan``).

A builder chain (`session.search(q).newer_than(ts).limit(k)`) *lowers* to a
`LogicalPlan`: a declarative description of WHAT the query asks for —
similarity target, predicate clauses, LIMIT — with the tenant/ACL clauses
already stamped from the authenticated principal (they cannot be expressed by
the builder at all; see ragdb.Session).

The planner (planner.py) *compiles* a LogicalPlan into a `PhysicalPlan`: HOW
the engine will answer it — execution engine (ref / cuda / sharded), tier
route (hot-only vs hot+warm merge), and the predicate-group key under which
concurrent queries are batched into one device program.

`PhysicalPlan.explain()` renders the compiled plan the way a SQL EXPLAIN
would, so benchmark tables and tests can assert on planner decisions instead
of reverse-engineering them from timings.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.query import Predicate

#: Predicate pass-all sentinels (mirrors core.query.Predicate defaults).
ANY_TENANT = -2
ALL_BITS = 0xFFFFFFFF


def bucket_rows(n: int) -> int:
    """Smallest power of two >= ``n`` — the bucketed-batching shape policy.

    Predicate-group batches are padded up to these buckets so every batch
    size in [2^(b-1)+1, 2^b] reuses ONE compiled program shape instead of
    recompiling per distinct size (executor.CompiledShapes).

    >>> [bucket_rows(n) for n in (1, 2, 3, 4, 5, 9, 32, 33)]
    [1, 2, 4, 4, 8, 16, 32, 64]
    """
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    """What the caller asked for. Immutable; the query embedding travels
    alongside (`q`, shape (B, D)) but is excluded from equality/hash so plans
    that differ only in the vector share one predicate group."""
    tenant: int = ANY_TENANT          # stamped from the principal, never caller-set
    acl_bits: int = ALL_BITS          # stamped from the principal
    min_ts: int = 0                   # newer_than()
    categories: tuple[int, ...] | None = None   # in_categories()
    k: int = 10                       # limit()
    engine: str | None = None         # using(); None = planner's choice
    match_terms: tuple[int, ...] | None = None  # match(): lowered term ids
    fusion: str = "wsum"              # fuse(): "wsum" | "rrf" score mix
    w_dense: float = 1.0              # fuse(): weighted-sum dense weight
    w_lex: float = 1.0                # fuse(): weighted-sum BM25 weight
    q: np.ndarray | None = dataclasses.field(
        default=None, compare=False, hash=False, repr=False)

    def predicate(self) -> Predicate:
        """Lower the clause set to the kernel's runtime `Predicate`.

        >>> LogicalPlan(tenant=3, min_ts=5, categories=(1, 2)).predicate()
        Predicate(tenant=3, min_ts=5, cat_mask=6, acl_bits=4294967295)
        """
        from repro_torch.core.tenancy import category_mask
        cat_mask = (ALL_BITS if self.categories is None
                    else category_mask(self.categories))
        return Predicate(tenant=self.tenant, min_ts=self.min_ts,
                         cat_mask=cat_mask, acl_bits=self.acl_bits & ALL_BITS)

    @property
    def constrained(self) -> bool:
        """Any clause beyond pure similarity (drives tier routing).

        >>> LogicalPlan().constrained, LogicalPlan(tenant=1).constrained
        (False, True)
        """
        return (self.tenant != ANY_TENANT or self.min_ts > 0
                or self.categories is not None or self.acl_bits != ALL_BITS)


def logical_from_predicate(pred: Predicate, *, k: int,
                           engine: str | None = None,
                           q: np.ndarray | None = None) -> LogicalPlan:
    """Lift an already-lowered Predicate back to a LogicalPlan — the compat
    path for callers holding raw Predicates (TieredRouter shim, benchmarks)."""
    cats = None
    if pred.cat_mask != ALL_BITS:
        cats = tuple(c for c in range(32) if pred.cat_mask & (1 << c))
    return LogicalPlan(tenant=pred.tenant, acl_bits=pred.acl_bits,
                       min_ts=pred.min_ts, categories=cats, k=k,
                       engine=engine, q=q)


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    """How the engine will answer it. Produced only by planner.compile_plan."""
    logical: LogicalPlan
    pred: Predicate                   # lowered clause set (the kernel contract)
    engine: str                       # "ref" | "cuda" | "sharded" | "ivf"
                                      # | "hybrid"
    engine_reason: str
    route: str                        # "hot" | "hot+warm"
    route_reason: str
    n_rows: int                       # hot-tier arena rows the scan covers
    est_cost_ms: float | None = None  # cost-model estimate for the chosen
                                      # engine at n_rows (None = no model)
    cost_source: str = "static-thresholds"   # "measured" | "static-thresholds"
    nprobe: int | None = None         # ivf engine: clusters probed per query
    ivf_est: tuple | None = None      # ivf engine: (n_clusters, cluster_cap,
                                      # est candidate rows scanned per probe)
    lex: tuple | None = None          # hybrid engine: (fusion mode,
                                      # query-term-count bucket, w_dense,
                                      # w_lex) — the score-mix identity
    page_rows: int | None = None      # paged arena-scan regime: rows per
                                      # page tile streamed from HBM (None =
                                      # VMEM-resident tiling). Results are
                                      # bit-identical either way; only the
                                      # memory traffic schedule changes.
    degraded: tuple[str, ...] = ()    # applied degradation rungs, oldest
                                      # first (planner.degrade_plan) — an
                                      # audit annotation, never part of the
                                      # group key (the degraded engine/
                                      # nprobe already key differently)
    shards: int | None = None         # sharded engine: mesh shard count S
                                      # (None = single-device engines). The
                                      # merge program shape is S-dependent
                                      # (S·k gathered candidates), so S is
                                      # part of every compiled-shape key.
    placement: str | None = None      # sharded engine: "hash" | "tenant"
                                      # row placement (tenant-affine enables
                                      # the owning-shard-only scan gate)

    @property
    def group_key(self) -> tuple:
        """Queries sharing this key share ONE device program per batch —
        the predicate-group batching contract (executor.run_grouped). The
        route is part of the key: two plans can lower to the same predicate
        (e.g. in_categories(range(32)) == no category clause) yet route
        differently, and grouping them would apply one plan's tiers to the
        other's results. ``nprobe`` rides along so probe depths never mix
        inside one ivf group, and ``lex`` (fusion mode + query-term-count
        bucket + weights) so hybrid groups only ever stack rows whose
        compiled shape AND score semantics agree — the actual term ids are
        per-row data, exactly like the query embedding. ``page_rows`` is
        part of the key because paged and resident launches compile
        different programs (different grid + DMA schedule), even though
        they return the same bits. ``shards``/``placement`` likewise: the
        sharded merge gathers S·k candidates (an S-dependent shape) and
        the tenant-affine gate compiles a different local program."""
        return (self.pred, self.logical.k, self.engine, self.route,
                self.nprobe, self.lex, self.page_rows, self.shards,
                self.placement)

    @property
    def fusable(self) -> bool:
        """Whether this plan's scan can join a fused grouped scan. The
        exact full-arena engines qualify — including "hybrid", whose kernel
        takes the same (G, 4) stacked predicates + per-row group ids as
        grouped_topk — because they stream the same rows under different
        predicates, so G of them collapse into one program. ivf scans
        per-group candidate sets and sharded owns its own collective —
        both stay on their engines."""
        return self.engine in ("ref", "cuda", "hybrid")

    @property
    def fuse_key(self) -> tuple:
        """Distinct predicate groups sharing this key are candidates for ONE
        fused grouped scan (planner.fuse_batch): same LIMIT k, same engine,
        same tier route, same score mix (``lex`` — None for dense engines,
        so dense and hybrid groups never fuse together), same paged/
        resident regime, same mesh shape — the predicates themselves are
        what the grouped kernel keeps apart."""
        return (self.logical.k, self.engine, self.route, self.lex,
                self.page_rows, self.shards, self.placement)

    def explain(self) -> str:
        lp = self.logical
        clauses = ["live (tenant >= 0)"]
        if lp.tenant != ANY_TENANT:
            clauses.append(f"tenant = {lp.tenant}")
        if lp.min_ts > 0:
            clauses.append(f"updated_at >= {lp.min_ts}")
        if lp.categories is not None:
            clauses.append(f"category IN {set(lp.categories)}")
        if lp.acl_bits != ALL_BITS:
            clauses.append(f"acl & {lp.acl_bits:#x}")
        if lp.match_terms is not None:
            clauses.append(f"match({len(lp.match_terms)} terms)")
        rows = 1 if lp.q is None else int(np.atleast_2d(lp.q).shape[0])
        if self.est_cost_ms is not None:
            cost = f"~{self.est_cost_ms:.3f} ms/query est (measured curves)"
        else:
            cost = "static thresholds (no cost model loaded)"
        lines = [
            f"PhysicalPlan  top-{lp.k} over {self.n_rows} hot-tier rows",
            f"  predicate: {' AND '.join(clauses)}",
            f"  engine:    {self.engine:8s} ({self.engine_reason})",
        ]
        if self.engine == "ivf" and self.ivf_est is not None:
            n_clusters, cap, est = self.ivf_est
            pct = 100.0 * est / max(self.n_rows, 1)
            lines.append(
                f"  ivf:       nprobe={self.nprobe} of {n_clusters} clusters "
                f"(cap {cap}) -> <={est} candidate rows of {self.n_rows} "
                f"({pct:.1f}% of arena)")
        if self.page_rows is not None:
            n_pages = -(-self.n_rows // self.page_rows)
            lines.append(
                f"  paging:    paged arena scan, {self.page_rows} rows/page "
                f"-> {n_pages} page(s), DMA double-buffered (bit-identical "
                f"to resident)")
        if self.engine == "sharded" and self.shards is not None:
            rows_per = self.n_rows // max(self.shards, 1)
            owning = ("owning shard only (tenant-affine gate)"
                      if self.placement == "tenant" and lp.tenant != ANY_TENANT
                      else f"all {self.shards} shards")
            lines.append(
                f"  sharding:  {self.shards} shard(s) x {rows_per} rows "
                f"({self.placement or 'hash'} placement), scan {owning}; "
                f"merge gathers {self.shards}*{lp.k} candidates "
                f"(O(S*B*k) wire bytes)")
        lines += [
            f"  route:     {self.route:8s} ({self.route_reason})",
            f"  batching:  predicate-group key {self.group_key!r}",
        ]
        if self.engine == "hybrid" and self.lex is not None:
            mode, qt_bucket, w_d, w_l = self.lex
            mix = (f"wsum({w_d:g}*dense + {w_l:g}*bm25)" if mode == "wsum"
                   else "rrf(dense-rank, bm25-rank)")
            lines.append(
                f"  fusion:    score mix {mix} over "
                f"{len(lp.match_terms or ())} term(s) -> bucket {qt_bucket}; "
                f"groups sharing fuse key scan once")
        elif self.fusable:
            lines.append(
                f"  fusion:    eligible — groups sharing fuse key "
                f"{self.fuse_key!r} scan once")
        else:
            lines.append(
                f"  fusion:    not eligible ({self.engine} runs per group)")
        lines += [
            f"  bucket:    {rows} query rows -> {bucket_rows(rows)} (pow2 shape reuse)",
            f"  cost:      {cost}",
        ]
        if self.degraded:
            lines.append(
                f"  degraded:  {' -> '.join(self.degraded)} "
                f"(deadline pressure; results exact for THIS plan)")
        return "\n".join(lines)
