"""The planner: LogicalPlan -> PhysicalPlan (port of ``repro.api.planner``).

Compilation is deterministic and fully reported by ``explain()``.

Engine selection, first match wins:
  0. a match() clause compiles to "hybrid" -- the only engine that scores
     the lexical signal (the arena-scan kernel in its lexical modes for a
     store on the card, the plain streaming scan on the CPU);
  1. the builder's explicit `.using(engine)` hint;
  2. "ivf" if the RagDB carries an index and the arena is at least
     `ivf_min_rows` (the pruned scan: the probe kernel over the probed
     clusters' rows) -- unless the selectivity guard blocks it;
  3. "sharded" if the RagDB was built with a device mesh and the hot arena
     is at least `shard_min_rows` (the arena scan per shard region, an
     exact (score, doc_id) merge);
  4. "cuda" for every exact plan whose store lies on a CUDA device -- the
     hand-written arena-scan kernel;
  5. "ref" otherwise (plain PyTorch; the only exact engine for a store on
     the CPU).

Selectivity guard: a pruned scan scores at most nprobe clusters' rows, so
a tenant / category / ACL clause can under-fill the k-list even when
qualifying rows exist elsewhere in the arena. Those plans fall back to an
exact engine and the reason string says so (`ivf_blocked_reason`).

A `CostModel` holds measured per-engine curves when one is given; the port
ships none (the reference's ``results/bench_latency.json`` curves are CPU
curves of the JAX engines and are never loaded here), so plans carry no
cost estimate until the port has its own bench.

Paged regime: with ``PlannerConfig.paged_min_rows`` set, plans of the
full-arena engines ("ref", "cuda", "hybrid") over arenas of at least that
many rows carry ``page_rows`` and scan the arena in pages (the kernel's
paged form, one running list per page; bit-identical to resident). ivf
plans never take the knob.

Tier routing keeps the paper's §7.3 rule (`choose_route`): a constrained
plan inside the hot window stays "hot"; long-tail similarity routes
"hot+warm" and also probes the warm tier, unless that tier is empty or the
plan has a match() clause and the warm tier carries no lexical lanes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.api.plan import (ALL_BITS, ANY_TENANT, LogicalPlan,
                                  PhysicalPlan, bucket_rows)

def check_engine_hint(engine: str | None) -> None:
    """Refuse the `.using()` hint the port cannot honour: the TPU kernel's
    name."""
    if engine == "pallas":
        raise ValueError("engine 'pallas' is the TPU kernel; the port's "
                         "kernel engine is 'cuda'")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Measured per-engine latency curves: ``engine -> ((n_rows, p50_ms),
    ...)``, interpolated log-log (a single-point curve extrapolates
    linearly in ``n_rows``).

    >>> cm = CostModel(curves=(("ref", ((1000, 1.0), (4000, 4.0))),))
    >>> round(cm.estimate_ms("ref", 2000), 3)
    2.0
    >>> round(cm.estimate_ms("ref", 8000), 3)
    8.0
    >>> cm.estimate_ms("cuda", 2000) is None
    True
    """
    curves: tuple[tuple[str, tuple[tuple[int, float], ...]], ...] = ()
    warm_probe_ms: float | None = None

    def curve(self, engine: str) -> tuple[tuple[int, float], ...] | None:
        """The measured (n_rows, p50_ms) points for ``engine``, or None."""
        for name, pts in self.curves:
            if name == engine:
                return pts
        return None

    def estimate_ms(self, engine: str, n_rows: int) -> float | None:
        """Estimated p50 latency (ms) of one query on ``engine`` at
        ``n_rows`` arena rows; None when the engine has no curve."""
        pts = self.curve(engine)
        if not pts:
            return None
        pts = sorted(pts)
        n = max(int(n_rows), 1)
        if len(pts) == 1:
            n0, t0 = pts[0]
            return t0 * n / max(n0, 1)
        xs = [math.log(max(p[0], 1)) for p in pts]
        ys = [math.log(max(p[1], 1e-9)) for p in pts]
        x = math.log(n)
        j = 1
        while j < len(xs) - 1 and x > xs[j]:
            j += 1
        x0, x1, y0, y1 = xs[j - 1], xs[j], ys[j - 1], ys[j]
        slope = (y1 - y0) / (x1 - x0) if x1 != x0 else 0.0
        return math.exp(y0 + slope * (x - x0))

    def calibrated(self, table) -> "CostModel":
        """A copy whose curves are rescaled by the measured/predicted ratio
        a live `obs.CalibrationTable` observed per engine; engines the table
        never priced keep their curves, and a None/empty table is identity.

        >>> from repro_torch.obs import CalibrationTable
        >>> cm = CostModel(curves=(("ref", ((1000, 1.0), (4000, 4.0))),))
        >>> t = CalibrationTable()
        >>> t.record_unit(engine="ref", n_rows=1000, groups=1, k=8, rows=1,
        ...               predicted_ms=1.0, launch_ms=0.5, sync_ms=1.5,
        ...               rows_scanned=1000)
        >>> round(cm.calibrated(t).estimate_ms("ref", 2000), 3)  # x2 drift
        4.0
        >>> cm.calibrated(None) is cm
        True
        """
        if table is None or not getattr(table, "recorded", 0):
            return self
        per_engine = table.per_engine()
        curves = []
        for eng, pts in self.curves:
            ratio = (per_engine.get(eng) or {}).get("ratio")
            if ratio is None or ratio <= 0.0:
                curves.append((eng, pts))
            else:
                curves.append((eng, tuple((n, ms * ratio)
                                          for n, ms in pts)))
        return dataclasses.replace(self, curves=tuple(curves))


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Planner knobs.

    >>> PlannerConfig().cost_model is None
    True
    """
    shard_min_rows: int = 1 << 20     # below this a single device wins
    ivf_min_rows: int = 1 << 12       # below this the exact scan is trivial
    ivf_nprobe: int | None = None     # probe depth; None = the index default
    fuse_min_groups: int = 2          # grouped-scan fusion floor: batches with
                                      # at least this many exact-engine groups
                                      # sharing a fuse key scan once (a huge
                                      # value disables fusion)
    paged_min_rows: int | None = None  # paged-regime threshold: arenas at or
                                       # above this row count scan in pages
                                       # (the arena-scan kernel's paged form:
                                       # one running list per page, rows
                                       # staged through a cp.async ring).
                                       # None (the default) keeps every scan
                                       # resident. Bit-identical either way.
    page_rows: int = 1 << 15          # rows per page in the paged regime
    cost_model: CostModel | None = None
    degrade_min_nprobe: int = 1       # nprobe floor for the ivf rung


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """One hot-tier dispatch unit after batch-level fusion: either several
    predicate groups answered by ONE fused grouped scan (``fused=True``) or
    a single group on its own engine. ``plans`` holds one representative
    `PhysicalPlan` per member predicate group, in batch order; ``reason`` is
    the auditable fusion decision."""
    plans: tuple
    fused: bool
    reason: str


def fuse_batch(plans, *, cfg: PlannerConfig = PlannerConfig()) -> list[FusedGroup]:
    """Batch-level fusion rule: collapse exact-engine predicate groups that
    share a `fuse_key` (same k, engine, tier route) into one grouped scan,
    once at least ``cfg.fuse_min_groups`` of them do -- the arena then
    streams once for all of them (`rows_scanned` G*N -> N).

    >>> from repro_torch.api.plan import LogicalPlan, PhysicalPlan, bucket_rows
    >>> mk = lambda t: PhysicalPlan(
    ...     logical=LogicalPlan(tenant=t, k=5),
    ...     pred=LogicalPlan(tenant=t, k=5).predicate(), engine="ref",
    ...     engine_reason="", route="hot", route_reason="", n_rows=1024)
    >>> units = fuse_batch([mk(0), mk(1), mk(2)])
    >>> len(units), units[0].fused, len(units[0].plans)
    (1, True, 3)
    >>> [u.fused for u in fuse_batch([mk(0)])]
    [False]
    """
    order: list[tuple] = []                    # first-occurrence unit order
    buckets: dict[tuple, list] = {}
    for p in plans:
        key = ("fuse", p.fuse_key) if p.fusable else ("solo", id(p))
        if key not in buckets:
            buckets[key] = []
            order.append(key)
        buckets[key].append(p)
    units: list[FusedGroup] = []
    for key in order:
        group = buckets[key]
        gsz = len(group)
        if key[0] == "solo":
            (p,) = group
            units.append(FusedGroup((p,), False,
                                    f"{p.engine} engine runs per group"))
            continue
        if gsz < cfg.fuse_min_groups:
            for p in group:
                units.append(FusedGroup(
                    (p,), False,
                    f"{gsz} group(s) share fuse key {p.fuse_key!r} "
                    f"< fuse_min_groups={cfg.fuse_min_groups}"))
            continue
        k, engine, route, _lex, _page, _shards, _placement = group[0].fuse_key
        n_rows = group[0].n_rows
        est = (cfg.cost_model.estimate_ms(engine, n_rows)
               if cfg.cost_model is not None else None)
        if est is not None:
            reason = (f"cost model: one fused scan ~{est:.2f}ms replaces "
                      f"{gsz} looped scans ~{gsz * est:.2f}ms at {n_rows} rows")
        else:
            reason = (f"{gsz} exact groups share (k={k}, engine={engine!r}, "
                      f"route={route!r}): one scan replaces {gsz}")
        units.append(FusedGroup(tuple(group), True, reason))
    return units


def exact_engine(device) -> str:
    """The exact engine for a store on ``device``: the arena-scan kernel on
    the card, plain PyTorch elsewhere (also the ivf rescan's engine)."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def _candidate_engines(device="cpu", has_index: bool = False,
                       has_mesh: bool = False) -> list[str]:
    """Engines the store can actually run: its exact engine always,
    sharded when the RagDB was built with a mesh, ivf when it carries a
    built index.

    >>> _candidate_engines("cpu", has_index=True, has_mesh=True)
    ['ref', 'sharded', 'ivf']
    """
    cands = [exact_engine(device)]
    if has_mesh:
        cands.append("sharded")
    if has_index:
        cands.append("ivf")
    return cands


def ivf_blocked_reason(logical: LogicalPlan) -> str | None:
    """Why the planner must not route this plan through the pruned scan, or
    None when ivf is admissible. The pruned scan only scores nprobe
    clusters' rows, so a selective predicate can under-fill the k-list even
    though qualifying rows exist outside the probed clusters -- exactness
    requires the exact engines there. The check runs on the LOWERED
    predicate, so a no-op clause (e.g. in_categories(range(32)), which
    lowers to the pass-all mask) doesn't forfeit the pruned scan. Recency
    alone is admissible: the hot arena covers the bound by tier placement,
    and a tight bound that still under-fills is completed by the executor's
    exact-rescan net."""
    pred = logical.predicate()
    if pred.tenant != ANY_TENANT:
        return "selective predicate (tenant clause) could under-fill the pruned scan"
    if pred.cat_mask != ALL_BITS:
        return "selective predicate (category clause) could under-fill the pruned scan"
    if pred.acl_bits != ALL_BITS:
        return "selective predicate (ACL clause) could under-fill the pruned scan"
    return None


def choose_engine(logical: LogicalPlan, *, n_rows: int,
                  cfg: PlannerConfig = PlannerConfig(),
                  device="cpu", has_index: bool = False,
                  has_lex: bool = False,
                  has_mesh: bool = False) -> tuple[str, str]:
    """Pick the execution engine and an auditable reason string.
    ``device`` is the device the store lies on; ``has_index`` whether the
    RagDB carries a built IVF index; ``has_lex`` whether it carries a
    lexical arena (which admits match() clauses); ``has_mesh`` whether it
    was built with a device mesh (which admits "sharded"). The selectivity
    guard removes "ivf" from the candidates for constrained plans (see
    `ivf_blocked_reason`) -- the reason string records the skip.

    >>> choose_engine(LogicalPlan(k=5), n_rows=512)
    ('ref', 'cpu backend, 512 rows')
    >>> choose_engine(LogicalPlan(k=5), n_rows=512, device="cuda")[0]
    'cuda'
    >>> choose_engine(LogicalPlan(k=5, engine="ref"), n_rows=512,
    ...               device="cuda")[0]
    'ref'
    >>> choose_engine(LogicalPlan(k=5), n_rows=1 << 16, has_index=True)[0]
    'ivf'
    >>> choose_engine(LogicalPlan(k=5), n_rows=1 << 20, has_mesh=True)
    ('sharded', 'mesh present and 1048576 rows >= 1048576')
    >>> eng, why = choose_engine(LogicalPlan(tenant=3, k=5), n_rows=1 << 16,
    ...                          has_index=True)
    >>> eng, "ivf skipped" in why
    ('ref', True)
    >>> choose_engine(LogicalPlan(match_terms=(3, 7), k=5), n_rows=512,
    ...               has_lex=True)[0]
    'hybrid'
    """
    # a match() clause is a CORRECTNESS requirement, not a speed choice:
    # only the hybrid engine scores the lexical signal, so every other
    # engine would silently drop the clause -- the planner refuses instead
    if logical.match_terms is not None:
        if not has_lex:
            raise ValueError("match() requires a lexical arena — construct "
                             "the RagDB with lexical_cfg")
        if logical.engine not in (None, "hybrid"):
            raise ValueError(
                f"a match() query must run on the hybrid engine, "
                f"not .using({logical.engine!r}) — drop the hint or the "
                f"match() clause")
        reason = "match() clause — fused dense+BM25 one-pass scan"
        cm = cfg.cost_model
        est = cm.estimate_ms("hybrid", n_rows) if cm is not None else None
        if est is not None:
            reason += f" (cost model: ~{est:.2f}ms)"
        return "hybrid", reason
    if logical.engine == "hybrid":
        raise ValueError("engine='hybrid' requires a match() clause — "
                         "there is no lexical signal to fuse")
    check_engine_hint(logical.engine)
    if (logical.fusion, logical.w_dense, logical.w_lex) != ("wsum", 1.0, 1.0):
        raise ValueError("fuse() requires a match() clause — without one "
                         "there is no lexical signal to mix, and silently "
                         "ignoring the knobs would misreport the ranking")
    if logical.engine is not None:
        return logical.engine, "caller hint (.using())"
    cands = _candidate_engines(device, has_index, has_mesh)
    note = ""
    if "ivf" in cands:
        blocked = ivf_blocked_reason(logical)
        if blocked is not None:
            cands.remove("ivf")
            note = f"; ivf skipped: {blocked}"
    cm = cfg.cost_model
    if cm is not None:
        ests = {e: cm.estimate_ms(e, n_rows) for e in cands}
        if all(v is not None for v in ests.values()):
            best = min(ests, key=lambda e: ests[e])
            detail = ", ".join(f"{e} ~{ests[e]:.2f}ms" for e in cands)
            return best, f"cost model: {detail}{note}"
    if "ivf" in cands and n_rows >= cfg.ivf_min_rows:
        return "ivf", f"index present and {n_rows} rows >= {cfg.ivf_min_rows}"
    if has_mesh and n_rows >= cfg.shard_min_rows:
        return "sharded", (f"mesh present and {n_rows} rows >= "
                           f"{cfg.shard_min_rows}{note}")
    dev = torch.device(device)
    if cands[0] == "cuda":
        return "cuda", f"store on {dev}: arena-scan kernel, {n_rows} rows{note}"
    return "ref", f"{dev.type} backend, {n_rows} rows{note}"


def choose_route(logical: LogicalPlan, *, hot_window_s: int, now_ts: int,
                 warm_rows: int,
                 cost_model: CostModel | None = None,
                 warm_lex: bool = False) -> tuple[str, str]:
    """Tier routing (paper §7.3): the warm probe runs exactly when it could
    contribute rows; the cost model only annotates the reason. A match()
    query spills warm only when the warm tier carries lexical lanes
    (``warm_lex``): a lanes-less warm store would score its rows dense-only
    and change the clause's meaning mid-merge.

    >>> choose_route(LogicalPlan(tenant=1, min_ts=950, k=3),
    ...              hot_window_s=100, now_ts=1000, warm_rows=10)[0]
    'hot'
    >>> choose_route(LogicalPlan(k=3), hot_window_s=100, now_ts=1000,
    ...              warm_rows=10)[0]
    'hot+warm'
    >>> choose_route(LogicalPlan(k=3), hot_window_s=100, now_ts=1000,
    ...              warm_rows=0)
    ('hot', 'warm tier empty')
    >>> choose_route(LogicalPlan(k=3, match_terms=(5,)), hot_window_s=100,
    ...              now_ts=1000, warm_rows=10)
    ('hot', 'warm tier has no lexical lanes — hybrid stays hot')
    """
    if warm_rows == 0:
        return "hot", "warm tier empty"
    if logical.match_terms is not None and not warm_lex:
        return "hot", "warm tier has no lexical lanes — hybrid stays hot"
    recent_only = logical.min_ts >= now_ts - hot_window_s
    if logical.constrained and recent_only:
        return "hot", "constrained query within the hot window"
    reason = "long-tail similarity spills to the warm tier"
    if cost_model is not None and cost_model.warm_probe_ms is not None:
        reason += f" (+~{cost_model.warm_probe_ms:.2f}ms measured warm probe)"
    return "hot+warm", reason


def compile_plan(logical: LogicalPlan, *, n_rows: int, hot_window_s: int,
                 now_ts: int, warm_rows: int,
                 cfg: PlannerConfig = PlannerConfig(),
                 device="cpu", index=None, lex=None,
                 warm_lex: bool = False, has_mesh: bool = False,
                 mesh_shards: int = 0,
                 placement: str | None = None) -> PhysicalPlan:
    """Compile WHAT (LogicalPlan) into HOW (PhysicalPlan): engine + route +
    the predicate-group batching key, with any cost estimate attached so
    ``explain()`` can render it. ``device`` is the store's device; ``index``
    the RagDB's `IVFIndex` (or None): its presence adds "ivf" to the
    candidate engines, and ivf plans carry nprobe + the candidate-row
    estimate for explain(). ``lex`` is the RagDB's `LexicalArena` (or
    None): its presence admits match() clauses, which compile to the
    "hybrid" engine with the score-mix identity (fusion mode,
    query-term-count bucket, weights) stamped into the group key;
    ``warm_lex`` says whether the warm tier carries lanes (hybrid plans
    only spill warm when it does). ``has_mesh`` / ``mesh_shards`` /
    ``placement`` describe the RagDB's mesh (present, shard count S, row
    placement kind): sharded plans carry S and the placement -- S shapes
    the merge (S*k gathered candidates) and a "tenant" placement lets
    explain() show which shards the scan touches. "sharded" without a
    mesh raises.

    >>> p = compile_plan(LogicalPlan(match_terms=(5, 9), k=5), n_rows=64,
    ...                  hot_window_s=10, now_ts=0, warm_rows=0,
    ...                  lex=object())
    >>> p.engine, p.lex
    ('hybrid', ('wsum', 2, 1.0, 1.0))
    >>> cfg = PlannerConfig(paged_min_rows=64, page_rows=16)
    >>> compile_plan(LogicalPlan(k=5), n_rows=64, hot_window_s=10,
    ...              now_ts=0, warm_rows=0, cfg=cfg).page_rows
    16
    >>> compile_plan(LogicalPlan(k=5, engine="ivf"), n_rows=64,
    ...              hot_window_s=10, now_ts=0, warm_rows=0)
    Traceback (most recent call last):
    ...
    ValueError: engine='ivf' requires a built index — call RagDB.build_index() first
    """
    engine, engine_reason = choose_engine(logical, n_rows=n_rows, cfg=cfg,
                                          device=device,
                                          has_index=index is not None,
                                          has_lex=lex is not None,
                                          has_mesh=has_mesh)
    route, route_reason = choose_route(logical, hot_window_s=hot_window_s,
                                       now_ts=now_ts, warm_rows=warm_rows,
                                       cost_model=cfg.cost_model,
                                       warm_lex=warm_lex)
    est = (cfg.cost_model.estimate_ms(engine, n_rows)
           if cfg.cost_model is not None else None)
    page_rows = None
    if (cfg.paged_min_rows is not None and n_rows >= cfg.paged_min_rows
            and engine in ("ref", "cuda", "hybrid")):
        # the full-arena engines scan in pages; ivf scans per-group
        # candidate sets and never takes the knob
        page_rows = cfg.page_rows
        engine_reason += (f"; paged regime (n_rows >= {cfg.paged_min_rows}, "
                          f"{page_rows} rows/page)")
    nprobe = ivf_est = lex_key = None
    if engine == "hybrid":
        qt_bucket = bucket_rows(len(logical.match_terms))
        # rrf ranks ignore the weights -- normalize them out of the identity
        # so rrf groups differing only in unused weights still fuse
        if logical.fusion == "wsum":
            lex_key = ("wsum", qt_bucket, float(logical.w_dense),
                       float(logical.w_lex))
        else:
            lex_key = ("rrf", qt_bucket, 1.0, 1.0)
    if engine == "ivf":
        if index is None:
            raise ValueError("engine='ivf' requires a built index — "
                             "call RagDB.build_index() first")
        nprobe = cfg.ivf_nprobe or index.cfg.nprobe
        q_rows = 1 if logical.q is None else len(np.atleast_2d(logical.q))
        ivf_est = (index.n_clusters, index.cluster_cap,
                   index.candidate_rows(nprobe, rows=q_rows))
    shards = plc = None
    if engine == "sharded":
        if not has_mesh or mesh_shards < 1:
            raise ValueError("engine='sharded' requires a mesh-built RagDB")
        shards = mesh_shards
        plc = placement or "hash"
    return PhysicalPlan(logical=logical, pred=logical.predicate(),
                        engine=engine, engine_reason=engine_reason,
                        route=route, route_reason=route_reason, n_rows=n_rows,
                        est_cost_ms=est,
                        cost_source=("measured" if est is not None
                                     else "static-thresholds"),
                        nprobe=nprobe, ivf_est=ivf_est, lex=lex_key,
                        page_rows=page_rows, shards=shards, placement=plc)


def degrade_plan(plan: PhysicalPlan, *, n_rows: int, hot_window_s: int,
                 now_ts: int, warm_rows: int,
                 cfg: PlannerConfig = PlannerConfig(), device="cpu",
                 index=None, lex=None, warm_lex: bool = False,
                 has_mesh: bool = False, mesh_shards: int = 0,
                 placement: str | None = None) -> PhysicalPlan | None:
    """One rung DOWN the degradation ladder, or None when it is exhausted.

    Every rung is a real, standalone-compilable plan: executing the
    degraded plan through the scheduler equals compiling and running it
    directly. What degrades is the query contract (probe depth, score
    signal), never the isolation clauses: tenant / ACL / recency
    predicates ride through every rung untouched. The rungs, in order of
    preference:

      1. ivf nprobe shrink -- halve the probe depth (floor
         ``cfg.degrade_min_nprobe``): recall narrows, the scan shrinks,
         predicate exactness is untouched. Degraded probes also WAIVE the
         executor's completeness rescan (an under-filled k-list is the
         degraded answer);
      2. hybrid -> dense -- drop the lexical signal and recompile as a pure
         dense plan on the engine the planner picks for it (the store's
         exact engine, or "ivf"); the one rung that changes what the query
         ranks on, so it is recorded in ``explain()`` and `ExecStats`;
      3. ivf -> exact -- at the nprobe floor, switch to the store's exact
         engine when the cost model prices it under the floored probe. The
         port ships no cost model, so without one this rung is None.

    Exhausted (None) leaves the scheduler one lever: a cache-stale serve
    within the declared staleness bound (``RagDB.execute(stale_within_s=)``).

    >>> from repro_torch.api.plan import LogicalPlan
    >>> kw = dict(n_rows=1 << 10, hot_window_s=10, now_ts=0, warm_rows=0)
    >>> p = compile_plan(LogicalPlan(k=5), **kw)
    >>> degrade_plan(p, **kw) is None          # ref plan: nothing to shed
    True
    """
    kw = dict(n_rows=n_rows, hot_window_s=hot_window_s, now_ts=now_ts,
              warm_rows=warm_rows, cfg=cfg, device=device, index=index,
              lex=lex, warm_lex=warm_lex, has_mesh=has_mesh,
              mesh_shards=mesh_shards, placement=placement)
    if plan.engine == "ivf" and plan.nprobe is not None:
        floor = max(int(cfg.degrade_min_nprobe), 1)
        if plan.nprobe > floor:
            new_nprobe = max(plan.nprobe // 2, floor)
            ivf_est, est = plan.ivf_est, plan.est_cost_ms
            if index is not None:
                q_rows = (1 if plan.logical.q is None
                          else len(np.atleast_2d(plan.logical.q)))
                cand = index.candidate_rows(new_nprobe, rows=q_rows)
                ivf_est = (index.n_clusters, index.cluster_cap, cand)
                if est is not None and plan.ivf_est and plan.ivf_est[2]:
                    # the measured curve prices the DEFAULT probe depth; a
                    # shallower probe scans proportionally fewer candidates
                    est = est * cand / plan.ivf_est[2]
            return dataclasses.replace(
                plan, nprobe=new_nprobe, ivf_est=ivf_est, est_cost_ms=est,
                degraded=plan.degraded + (
                    f"nprobe {plan.nprobe}->{new_nprobe}",))
        # at the floor: switch to the exact engine only when the cost model
        # actually prices it under the floored probe
        cm = cfg.cost_model
        if cm is not None:
            exact = exact_engine(device)
            ex_est = cm.estimate_ms(exact, n_rows)
            if ex_est is not None and plan.est_cost_ms is not None \
                    and ex_est < plan.est_cost_ms:
                fresh = compile_plan(dataclasses.replace(
                    plan.logical, engine=exact), **kw)
                return dataclasses.replace(
                    fresh, degraded=plan.degraded + (f"ivf->{exact}",))
        return None
    if plan.engine == "hybrid":
        dense = dataclasses.replace(plan.logical, match_terms=None,
                                    fusion="wsum", w_dense=1.0, w_lex=1.0,
                                    engine=None)
        fresh = compile_plan(dense, **kw)
        return dataclasses.replace(
            fresh, degraded=plan.degraded + ("hybrid->dense",))
    return None
