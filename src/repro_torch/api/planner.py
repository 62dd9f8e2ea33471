"""The planner: LogicalPlan -> PhysicalPlan (port of ``repro.api.planner``).

Compilation is deterministic and fully reported by ``explain()``.

Engine selection, first match wins:
  1. the builder's explicit `.using(engine)` hint;
  2. "cuda" for every exact plan whose store lies on a CUDA device -- the
     hand-written arena-scan kernel;
  3. "ref" otherwise (plain PyTorch; the only engine for a store on the CPU).

A `CostModel` holds measured per-engine curves when one is given; the port
ships none (the reference's ``results/bench_latency.json`` curves are CPU
curves of the JAX engines and are never loaded here), so plans carry no
cost estimate until the port has its own bench.

Tier routing keeps the paper's §7.3 rule. This slice has no warm tier, so
every plan routes "hot" with the reason "warm tier empty".

Engines of later slices -- "ivf", "sharded", "hybrid" (and the match()
clause) -- raise NotImplementedError naming their ROADMAP queue item.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.api.plan import LogicalPlan, PhysicalPlan

#: engines of later slices -> the ROADMAP queue-1 item that brings them
LATER_ENGINES = {
    "hybrid": "lexical/hybrid slice (ROADMAP queue 1, 'Lexical arena and hybrid search')",
    "ivf": "IVF slice (ROADMAP queue 1, 'IVF')",
    "sharded": "sharded-engine slice (ROADMAP queue 1, 'Sharded engine')",
}


def check_engine_hint(engine: str | None) -> None:
    """Refuse `.using()` hints this slice cannot honour: the TPU kernel's
    name, and the engines of later slices."""
    if engine == "pallas":
        raise ValueError("engine 'pallas' is the TPU kernel; the port's "
                         "kernel engine is 'cuda'")
    if engine in LATER_ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: it arrives with the "
            f"{LATER_ENGINES[engine]}")


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
    fuse_min_groups: int = 2          # grouped-scan fusion floor: batches with
                                      # at least this many exact-engine groups
                                      # sharing a fuse key scan once (a huge
                                      # value disables fusion)
    cost_model: CostModel | None = None


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

    >>> from repro_torch.api.plan import LogicalPlan, PhysicalPlan
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


def choose_engine(logical: LogicalPlan, *, n_rows: int,
                  cfg: PlannerConfig = PlannerConfig(),
                  device="cpu") -> tuple[str, str]:
    """Pick the execution engine and an auditable reason string.
    ``device`` is the device the store lies on.

    >>> choose_engine(LogicalPlan(k=5), n_rows=512)
    ('ref', 'cpu backend, 512 rows')
    >>> choose_engine(LogicalPlan(k=5), n_rows=512, device="cuda")[0]
    'cuda'
    >>> choose_engine(LogicalPlan(k=5, engine="ref"), n_rows=512,
    ...               device="cuda")[0]
    'ref'
    """
    if logical.match_terms is not None:
        raise NotImplementedError(
            "match() is not ported yet: it arrives with the "
            + LATER_ENGINES["hybrid"])
    check_engine_hint(logical.engine)
    if (logical.fusion, logical.w_dense, logical.w_lex) != ("wsum", 1.0, 1.0):
        raise ValueError("fuse() requires a match() clause — without one "
                         "there is no lexical signal to mix, and silently "
                         "ignoring the knobs would misreport the ranking")
    if logical.engine is not None:
        return logical.engine, "caller hint (.using())"
    dev = torch.device(device)
    engine = "cuda" if dev.type == "cuda" else "ref"
    cm = cfg.cost_model
    est = cm.estimate_ms(engine, n_rows) if cm is not None else None
    if est is not None:
        return engine, f"cost model: {engine} ~{est:.2f}ms"
    if engine == "cuda":
        return "cuda", f"store on {dev}: arena-scan kernel, {n_rows} rows"
    return "ref", f"{dev.type} backend, {n_rows} rows"


def choose_route(logical: LogicalPlan, *, hot_window_s: int, now_ts: int,
                 warm_rows: int,
                 cost_model: CostModel | None = None) -> tuple[str, str]:
    """Tier routing (paper §7.3): the warm probe runs exactly when it could
    contribute rows; the cost model only annotates the reason.

    >>> choose_route(LogicalPlan(tenant=1, min_ts=950, k=3),
    ...              hot_window_s=100, now_ts=1000, warm_rows=10)[0]
    'hot'
    >>> choose_route(LogicalPlan(k=3), hot_window_s=100, now_ts=1000,
    ...              warm_rows=10)[0]
    'hot+warm'
    >>> choose_route(LogicalPlan(k=3), hot_window_s=100, now_ts=1000,
    ...              warm_rows=0)
    ('hot', 'warm tier empty')
    """
    if warm_rows == 0:
        return "hot", "warm tier empty"
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
                 device="cpu") -> PhysicalPlan:
    """Compile WHAT (LogicalPlan) into HOW (PhysicalPlan): engine + route +
    the predicate-group batching key, with any cost estimate attached so
    ``explain()`` can render it. ``device`` is the store's device."""
    engine, engine_reason = choose_engine(logical, n_rows=n_rows, cfg=cfg,
                                          device=device)
    route, route_reason = choose_route(logical, hot_window_s=hot_window_s,
                                       now_ts=now_ts, warm_rows=warm_rows,
                                       cost_model=cfg.cost_model)
    est = (cfg.cost_model.estimate_ms(engine, n_rows)
           if cfg.cost_model is not None else None)
    return PhysicalPlan(logical=logical, pred=logical.predicate(),
                        engine=engine, engine_reason=engine_reason,
                        route=route, route_reason=route_reason, n_rows=n_rows,
                        est_cost_ms=est,
                        cost_source=("measured" if est is not None
                                     else "static-thresholds"))


def degrade_plan(plan: PhysicalPlan) -> PhysicalPlan | None:
    """One rung DOWN the degradation ladder, or None when it is exhausted.
    The rungs (ivf probe depth, hybrid -> dense, ivf -> exact) belong to
    engines of later slices; an exact plan has nothing to shed.

    >>> from repro_torch.api.plan import LogicalPlan
    >>> p = compile_plan(LogicalPlan(k=5), n_rows=1 << 10, hot_window_s=10,
    ...                  now_ts=0, warm_rows=0)
    >>> degrade_plan(p) is None          # ref plan: nothing to shed
    True
    """
    return None
