"""Physical-plan execution -- the ONLY module that issues retrieval device
calls for the front door (port of ``repro.api.executor``):

  * predicate-group batching: B concurrent queries are grouped by
    `PhysicalPlan.group_key`, and each group runs as ONE device call over
    its stacked query rows;
  * grouped-scan fusion: exact-engine groups sharing a `fuse_key` collapse
    into ONE `unified_query_grouped` call that streams the arena once for
    all of them (`ExecStats.fused_groups / fused_scans` audit);
  * async dispatch: every dispatch unit is launched before the first
    host copy of any result (``.cpu()`` in `finish_plans` is the sync);
  * bucketed batching: each unit's row count pads to a power-of-two bucket
    (`plan.bucket_rows`), tracked by the `CompiledShapes` LRU.

This slice is hot-tier only: the warm probe and tier merge arrive with the
warm-tier slice, and the ivf / hybrid / sharded dispatch with theirs.
Tests count calls by monkeypatching `executor.unified_query` (per-group
scans) and `executor.unified_query_grouped` (fused scans).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.api.plan import PhysicalPlan, bucket_rows
from repro_torch.core.query import (BLOCK_ALL, NEG_INF, Predicate,
                                    stack_predicates, unified_query,
                                    unified_query_grouped)
from repro_torch.core.store import Store
from repro_torch.obs.tracer import FanSpan

#: tier tag of every row in the returned `tiers` array (the warm tier's
#: tag, 1, arrives with the warm-tier slice)
TIER_HOT = 0


@dataclasses.dataclass
class ExecStats:
    """Per-RagDB execution counters (device work only -- result-cache hits
    never reach the executor and are counted by `ResultCache` itself)."""
    device_calls: int = 0         # retrieval programs launched on-device
    queries: int = 0              # logical queries answered
    hot_queries: int = 0
    warm_queries: int = 0
    padded_rows: int = 0          # bucket-padding rows added across calls
    rows_scanned: int = 0         # hot-tier arena rows scored across calls:
                                  # arena N per exact scan (ONCE per fused
                                  # grouped scan, not once per group)
    fused_groups: int = 0         # predicate groups answered by fused scans
    fused_scans: int = 0          # fused grouped-scan programs launched
    padded_groups: int = 0        # BLOCK_ALL blocker lanes launched for pow2
                                  # group padding (k=0 semantics: asserted
                                  # to allocate no result rows)
    terms_scanned: int = 0        # postings lanes streamed (hybrid slice)
    degraded_plans: int = 0       # plans executed with a degradation ladder
    stale_serves: int = 0         # cache results served PAST their snapshot
                                  # under a declared staleness bound
    warm_failovers: int = 0       # hot+warm plans served hot-only (warm
                                  # slice)
    stale_epoch_rejected: int = 0 # poisoned cache reads refused because the
                                  # entry's commit-epoch key no longer matches


class CompiledShapes:
    """Small LRU tracking the resident retrieval shapes ``(engine,
    bucket_rows, k, groups)`` -- the working set bucketed batching keeps
    small. `touch()` returns True on a hit and records the miss otherwise.

    >>> shapes = CompiledShapes(cap=2)
    >>> shapes.touch("ref", 8, 5)          # first sight: miss
    False
    >>> shapes.touch("ref", 8, 5)          # resident: hit
    True
    >>> shapes.touch("ref", 16, 5), shapes.touch("ref", 32, 5)  # evicts (8, 5)
    (False, False)
    >>> shapes.touch("ref", 8, 5)
    False
    >>> (shapes.hits, shapes.misses)
    (1, 4)
    """

    def __init__(self, cap: int = 32):
        self.cap = cap
        self._lru: OrderedDict[tuple, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._lru)

    def touch(self, engine: str, bucket: int, k: int,
              groups: int | None = None) -> bool:
        key = (engine, bucket, k, groups)
        if key in self._lru:
            self.hits += 1
            self._lru.move_to_end(key)
            return True
        self.misses += 1
        self._lru[key] = None
        while len(self._lru) > self.cap:
            self._lru.popitem(last=False)
        return False


def _pad_rows(q: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a (B, D) block with zero rows up to ``bucket`` rows (B <= bucket).
    Retrieval is row-parallel, so padding rows cannot perturb real rows."""
    if q.shape[0] == bucket:
        return q
    return np.concatenate(
        [q, np.zeros((bucket - q.shape[0], q.shape[1]), q.dtype)], axis=0)


@dataclasses.dataclass
class _Hot:
    """One in-flight hot-tier device call: launched, NOT yet synced.
    ``pad_check`` is the real row count of a fused grouped launch whose
    padding rows point at a BLOCK_ALL blocker lane: finish asserts those
    rows allocated no result rows (k=0 semantics)."""
    s: torch.Tensor
    sl: torch.Tensor
    rows: int                     # arena rows this call scored
    pad_check: int | None = None  # first padded (blocker-lane) row index
    launch_ms: float = 0.0        # host-side dispatch cost (perf_counter)
    sync_ms: float = 0.0          # finish-time copy-to-host wait


def _to_device(x: np.ndarray, store: Store) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(store["emb"].device)


def _launch_hot(store: Store, q: np.ndarray, pred: Predicate, k: int,
                engine: str) -> _Hot:
    """Launch one retrieval device call WITHOUT syncing on its result
    (the returned tensors are futures until finish copies them)."""
    s, sl = unified_query(store, _to_device(q, store), pred, k, engine=engine)
    return _Hot(s, sl, store["emb"].shape[0])


def _finish_hot(hot: _Hot) -> tuple[np.ndarray, np.ndarray]:
    """Sync one launched call: the copy to the host waits for the device."""
    s, sl = hot.s.cpu().numpy(), hot.sl.cpu().numpy()
    if hot.pad_check is not None and sl.shape[0] > hot.pad_check:
        # padded rows point at a BLOCK_ALL blocker lane: their k-lists must
        # be empty -- a hit here means a padding lane allocated result rows
        assert (sl[hot.pad_check:] == -1).all(), (
            "blocker-lane padding rows allocated result rows")
    return s, sl


def _pad_group_launch(q: np.ndarray, gids: np.ndarray,
                      preds: list[Predicate], k: int, engine: str, *,
                      stats: ExecStats | None,
                      shapes: CompiledShapes | None):
    """Shared bucket/blocker padding for fused grouped launches: the
    predicate stack pads to a pow2 group count with `BLOCK_ALL` rows and
    (when ``shapes`` tracks shape reuse) the query rows to their pow2
    bucket. Padding rows point at a BLOCKER lane -- never a real group --
    so they match no row (asserted at finish). When row padding is needed
    and every lane is real, one extra blocker bucket is opened.

    Returns (q, gids, preds, n_valid)."""
    n_valid = q.shape[0]
    g_real = len(preds)
    bucket = bucket_rows(n_valid) if shapes is not None else n_valid
    g_bucket = bucket_rows(g_real)
    if bucket > n_valid and g_bucket == g_real:
        g_bucket = bucket_rows(g_real + 1)   # open a lane for the blocker
    preds = list(preds) + [BLOCK_ALL] * (g_bucket - g_real)
    if stats is not None:
        stats.padded_groups += g_bucket - g_real
    if shapes is not None:
        shapes.touch(engine, bucket, k, groups=g_bucket)
        if stats is not None:
            stats.padded_rows += bucket - n_valid
        q = _pad_rows(q, bucket)
        gids = np.concatenate(
            [gids, np.full(bucket - n_valid, g_real, np.int32)])
    return q, gids, preds, n_valid


def _launch_grouped(store: Store, q: np.ndarray, gids: np.ndarray,
                    preds: list[Predicate], k: int, engine: str, *,
                    stats: ExecStats | None = None,
                    shapes: CompiledShapes | None = None) -> _Hot:
    """Launch ONE fused grouped scan answering every predicate group in
    ``preds`` (rows and groups padded as `_pad_group_launch` says)."""
    q, gids, preds, n_valid = _pad_group_launch(
        q, gids, preds, k, engine, stats=stats, shapes=shapes)
    dev = store["emb"].device
    s, sl = unified_query_grouped(store, _to_device(q, store),
                                  _to_device(gids, store),
                                  stack_predicates(preds, dev), k,
                                  engine=engine)
    return _Hot(s, sl, store["emb"].shape[0], pad_check=n_valid)


def run_grouped(store: Store, q: np.ndarray, preds: list[Predicate], k: int,
                engine: str = "ref", *, stats: ExecStats | None = None,
                shapes: CompiledShapes | None = None):
    """Predicate-group batched retrieval -- the per-group LOOP: one device
    call per unique predicate, each streaming the arena. q: (B, D) host
    array, preds: B predicates (one per row). Returns (scores (B, k) f32,
    slots (B, k) i32, n_device_calls). All calls launch before the first
    sync."""
    B = q.shape[0]
    groups: dict[Predicate, list[int]] = {}
    for i, p in enumerate(preds):
        groups.setdefault(p, []).append(i)
    launched = []
    for pred, idxs in groups.items():
        q_g = np.asarray(q[np.asarray(idxs)], np.float32)
        if shapes is not None:
            bucket = bucket_rows(q_g.shape[0])
            shapes.touch(engine, bucket, k)
            if stats is not None:
                stats.padded_rows += bucket - q_g.shape[0]
            q_g = _pad_rows(q_g, bucket)
        launched.append((idxs, _launch_hot(store, q_g, pred, k, engine)))
    scores = np.full((B, k), np.float32(NEG_INF), np.float32)
    slots = np.full((B, k), -1, np.int32)
    for idxs, hot in launched:
        s, sl = _finish_hot(hot)
        scores[idxs], slots[idxs] = s[:len(idxs)], sl[:len(idxs)]
        if stats is not None:
            stats.rows_scanned += hot.rows
    if stats is not None:
        stats.device_calls += len(groups)
        stats.queries += B
        stats.hot_queries += B
    return scores, slots, len(groups)


def run_grouped_fused(store: Store, q: np.ndarray, preds: list[Predicate],
                      k: int, engine: str = "ref", *,
                      stats: ExecStats | None = None,
                      shapes: CompiledShapes | None = None):
    """Scan-once counterpart of `run_grouped`: the G unique predicates
    stack into one (G, 4) block and ONE fused grouped call answers every
    row -- `rows_scanned` is the arena N, not G*N. Same contract and
    return shape as `run_grouped` (n_device_calls is always 1)."""
    B = q.shape[0]
    uniq: dict[Predicate, int] = {}
    for p in preds:
        if p not in uniq:
            uniq[p] = len(uniq)
    gids = np.asarray([uniq[p] for p in preds], np.int32)
    hot = _launch_grouped(store, np.asarray(q, np.float32), gids,
                          list(uniq), k, engine, stats=stats, shapes=shapes)
    s, sl = _finish_hot(hot)
    if stats is not None:
        stats.device_calls += 1
        stats.queries += B
        stats.hot_queries += B
        stats.rows_scanned += hot.rows
        stats.fused_groups += len(uniq)
        stats.fused_scans += 1
    return s[:B], sl[:B], 1


@dataclasses.dataclass
class InFlightPlans:
    """A launched-but-unsynced `launch_plans` batch: every device call is
    in flight and no result has been copied to the host. `finish_plans`
    consumes it."""
    inflight: list               # (FusedGroup, member row-index lists, _Hot)
    B: int                       # total query rows across plans
    k: int
    stats: "ExecStats | None"
    row_traces: list | None = None   # per query row: the owning request's
                                 # obs.Trace (tracer-enabled path only)
    calib: object = None         # obs.CalibrationTable (always-on audit)


def execute_plans(hot_store: Store, plans: list[PhysicalPlan], *,
                  stats: ExecStats | None = None,
                  shapes: CompiledShapes | None = None, planner_cfg=None):
    """Batched execution of compiled plans: `launch_plans` then
    `finish_plans`. Every plan must carry its query rows (`logical.q`,
    (B_i, D)) and all must share one k. Returns (scores (B, k), slots
    (B, k), tiers (B, k)) numpy arrays, B = total query rows, in plan
    order."""
    return finish_plans(launch_plans(hot_store, plans, stats=stats,
                                     shapes=shapes, planner_cfg=planner_cfg))


def launch_plans(hot_store: Store, plans: list[PhysicalPlan], *,
                 stats: ExecStats | None = None,
                 shapes: CompiledShapes | None = None, planner_cfg=None,
                 obs=None, calib=None) -> InFlightPlans:
    """LAUNCH phase: group plans by `group_key`, hand the distinct groups
    to `planner.fuse_batch`, and launch EVERY dispatch unit without
    syncing. ``obs`` (one obs.Trace per plan) records a ``launch`` span per
    unit into each member request's trace; ``calib`` is carried to
    `finish_plans`, which records the predicted-vs-measured audit."""
    from repro_torch.api.planner import PlannerConfig, fuse_batch

    ks = {p.logical.k for p in plans}
    if len(ks) != 1:
        raise ValueError(f"batched execution needs a single k, got {sorted(ks)}")
    k = ks.pop()
    if stats is not None:
        stats.degraded_plans += sum(1 for p in plans if p.degraded)

    row_plans: list[PhysicalPlan] = []
    qs: list[np.ndarray] = []
    for p in plans:
        if p.logical.q is None:
            raise ValueError("plan carries no query embedding")
        if p.route != "hot":
            raise NotImplementedError(
                f"route {p.route!r} needs the warm tier, which arrives with "
                "the warm-tier slice (ROADMAP queue 1, 'Warm tier and router')")
        q = np.atleast_2d(np.asarray(p.logical.q, np.float32))
        qs.append(q)
        row_plans.extend([p] * q.shape[0])
    q_all = np.concatenate(qs, axis=0)
    B = q_all.shape[0]

    row_traces = None
    if obs is not None:
        row_traces = []
        for tr, q in zip(obs, qs):
            row_traces.extend([tr] * q.shape[0])

    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(row_plans):
        groups.setdefault(p.group_key, []).append(i)
    reps = {key: row_plans[idxs[0]] for key, idxs in groups.items()}
    units = fuse_batch(list(reps.values()),
                       cfg=planner_cfg or PlannerConfig())

    inflight = []
    for unit in units:
        member_idxs = [groups[p.group_key] for p in unit.plans]
        rep = unit.plans[0]
        fan = None
        if row_traces is not None:
            fan = FanSpan([row_traces[i] for m in member_idxs for i in m],
                          "launch", engine=rep.engine, fused=unit.fused,
                          groups=len(unit.plans))
        t_launch0 = time.perf_counter()
        if unit.fused:
            idxs = [i for m in member_idxs for i in m]
            gids = np.concatenate(
                [np.full(len(m), g, np.int32)
                 for g, m in enumerate(member_idxs)])
            hot = _launch_grouped(hot_store, q_all[np.asarray(idxs)], gids,
                                  [p.pred for p in unit.plans], k,
                                  rep.engine, stats=stats, shapes=shapes)
            if stats is not None:
                stats.fused_groups += len(unit.plans)
                stats.fused_scans += 1
        else:
            (idxs,) = member_idxs
            q_g = q_all[np.asarray(idxs)]
            if shapes is not None:
                bucket = bucket_rows(q_g.shape[0])
                shapes.touch(rep.engine, bucket, k)
                if stats is not None:
                    stats.padded_rows += bucket - q_g.shape[0]
                q_g = _pad_rows(q_g, bucket)
            hot = _launch_hot(hot_store, q_g, rep.pred, k, rep.engine)
        hot.launch_ms = (time.perf_counter() - t_launch0) * 1e3
        if fan is not None:
            fan.end(rows=sum(len(m) for m in member_idxs))
        inflight.append((unit, member_idxs, hot))
        if stats is not None:
            n_rows_unit = sum(len(m) for m in member_idxs)
            stats.device_calls += 1
            stats.queries += n_rows_unit
            stats.hot_queries += n_rows_unit
    return InFlightPlans(inflight=inflight, B=B, k=k, stats=stats,
                         row_traces=row_traces, calib=calib)


def finish_plans(pending: InFlightPlans):
    """FINISH phase: the first copy to the host. Syncs every in-flight
    unit and scatters into row order. Each unit's sync is a
    ``device_sync`` span and its scatter a ``merge`` span in every member
    request's trace, and each unit lands one predicted-vs-measured row in
    `pending.calib`. Returns (scores, slots, tiers)."""
    B, k, stats = pending.B, pending.k, pending.stats
    row_traces, calib = pending.row_traces, pending.calib
    scores = np.full((B, k), np.float32(NEG_INF), np.float32)
    slots = np.full((B, k), -1, np.int32)
    tiers = np.full((B, k), TIER_HOT, np.int32)
    for unit, member_idxs, hot in pending.inflight:
        unit_traces = ([row_traces[i] for m in member_idxs for i in m]
                       if row_traces is not None else None)
        sync_fan = (FanSpan(unit_traces, "device_sync",
                            engine=unit.plans[0].engine)
                    if unit_traces is not None else None)
        t_sync0 = time.perf_counter()
        hs, hi = _finish_hot(hot)
        hot.sync_ms = (time.perf_counter() - t_sync0) * 1e3
        if sync_fan is not None:
            sync_fan.end(rows_scanned=hot.rows)
        if calib is not None:
            rep = unit.plans[0]
            calib.record_unit(
                engine=rep.engine, n_rows=rep.n_rows,
                groups=len(unit.plans), k=k,
                rows=sum(len(m) for m in member_idxs),
                predicted_ms=rep.est_cost_ms, launch_ms=hot.launch_ms,
                sync_ms=hot.sync_ms, rows_scanned=hot.rows)
        if stats is not None:
            stats.rows_scanned += hot.rows
        merge_fan = (FanSpan(unit_traces, "merge", groups=len(member_idxs))
                     if unit_traces is not None else None)
        off = 0
        for m in member_idxs:
            scores[m], slots[m] = hs[off:off + len(m)], hi[off:off + len(m)]
            off += len(m)
        if merge_fan is not None:
            merge_fan.end()
    return scores, slots, tiers
