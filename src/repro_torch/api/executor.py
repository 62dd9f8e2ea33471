"""Physical-plan execution -- the ONLY module that issues retrieval device
calls for the front door (port of ``repro.api.executor``):

  * predicate-group batching: B concurrent queries are grouped by
    `PhysicalPlan.group_key`, and each group runs as ONE device call over
    its stacked query rows;
  * grouped-scan fusion: exact-engine groups sharing a `fuse_key` collapse
    into ONE `unified_query_grouped` call that streams the arena once for
    all of them (`ExecStats.fused_groups / fused_scans` audit); hybrid
    groups sharing a score mix collapse into ONE fused dense+BM25 scan
    (`kernels.hybrid_score.ops.hybrid_score`);
  * async dispatch: every dispatch unit is launched before the first
    host copy of any result (``.cpu()`` in `finish_plans` is the sync);
  * bucketed batching: each unit's row count pads to a power-of-two bucket
    (`plan.bucket_rows`), tracked by the `CompiledShapes` LRU;
  * the ivf engine: each ivf group runs the coarse quantizer on the
    device (`IVFIndex.probe_device`), then ONE probe launch over its probed
    clusters' live candidate rows (`kernels.ivf_probe.ops.ivf_probe`: the
    compaction, then the scan), with no host sync in between; the finish
    phase completes an under-filled k-list with one exact rescan (the
    ``starved`` memo sends a predicate the whole arena cannot fill
    straight to the exact engine);
  * the paged regime: a unit whose representative plan carries
    ``page_rows`` launches the arena scan's paged form
    (`ExecStats.paged_scans` counts those launches);
  * tier merge: once every hot unit is launched, each "hot+warm" plan
    probes the warm tier (`SplitStackClient.query` with the predicate
    pushed down, or `query_hybrid` for a match() plan), and the finish
    phase merges the hot and warm k-lists on the host (`merge_tiers`; rrf
    merges per signal across the tiers, then rank-fuses). The warm probe
    returns host arrays, so it waits behind the hot scans already queued;
  * the sharded engine: a mesh-built RagDB hands its cached
    `ShardedScan` (``kernels.arena_scan.sharded``: the arena scan per
    shard region, an exact (score, doc_id) merge) to every "sharded"
    group; the launch queues it without a sync, the finish phase reads its
    tie checks, and `ExecStats` audits the shard count, the merge's
    collective bytes and the rows each shard scanned;
  * a store held in several allocations (one a device, ``core.store``):
    an exact, hybrid or ivf unit launches once per allocation, on its
    device, over its contiguous rows (a hybrid scan over the allocation's
    lanes, `LexicalArena.snapshot()`; an ivf probe over the allocation's
    member-table mirror, the probed clusters copied there from the
    controller's quantizer without a host sync), every launch queued
    before any copy, and the lists merge on the controller positionally
    (`filtered_topk.ops.merge_positional`): the single arena's (score
    desc, slot asc) order. A fused rrf unit merges its dense and its BM25
    lists apart and rank-fuses the merged lists (ranks are global). The
    starved path and the completeness rescan run the exact engine the same
    way. ``device_calls`` counts the unit once and ``terms_scanned`` N * T,
    as the reference does; the kernels' ``LAUNCHES`` count every launch.

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
from repro_torch.api.planner import PlannerConfig, exact_engine, fuse_batch
from repro_torch.core.query import (BLOCK_ALL, NEG_INF, Predicate,
                                    stack_predicates, unified_query,
                                    unified_query_grouped)
from repro_torch.core.ivf import probe_allocations
from repro_torch.core.store import (ALLOCS, Store, allocations, controller,
                                    n_rows, row_starts, upload)
from repro_torch.index.lexical.arena import allocations as lex_allocations
from repro_torch.kernels.filtered_topk.ops import merge_pieces
from repro_torch.obs.tracer import FanSpan

#: tier tags in the returned `tiers` array
TIER_HOT = 0
TIER_WARM = 1


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
                                  # grouped scan, not once per group),
                                  # padded candidate rows per ivf probe
                                  # (+ the arena on a completeness rescan)
    fused_groups: int = 0         # predicate groups answered by fused scans
    fused_scans: int = 0          # fused grouped-scan programs launched
    padded_groups: int = 0        # BLOCK_ALL blocker lanes launched for pow2
                                  # group padding (k=0 semantics: asserted
                                  # to allocate no result rows)
    terms_scanned: int = 0        # postings lanes streamed by hybrid scans
    paged_scans: int = 0          # hot-tier launches in the paged arena-scan
                                  # regime (plan.page_rows set): the same
                                  # rows and lists as resident, only the
                                  # staging schedule differs
    degraded_plans: int = 0       # plans executed with a degradation ladder
    stale_serves: int = 0         # cache results served PAST their snapshot
                                  # under a declared staleness bound
    warm_failovers: int = 0       # hot+warm plans served hot-only because
                                  # the guarded warm probe gave up
    stale_epoch_rejected: int = 0 # poisoned cache reads refused because the
                                  # entry's commit-epoch key no longer matches
    shards_used: int = 0          # mesh shard count S of the sharded engine's
                                  # launches (0 = never dispatched sharded)
    collective_bytes: int = 0     # the sharded merge's wire bytes, counted
                                  # as the reference's compiled program
                                  # gathers them: O(S*B*k), constant in N
    shard_rows_scanned: list = dataclasses.field(default_factory=list)
                                  # per-shard rows scored by sharded launches
                                  # (index = shard id); under tenant-affine
                                  # placement a tenant-scoped query credits
                                  # ONLY its owning shard


class CompiledShapes:
    """Small LRU tracking the resident retrieval shapes ``(engine,
    bucket_rows, k, groups, lex, page_rows)`` -- the working set bucketed
    batching keeps small (``lex`` is a hybrid scan's score-mix identity,
    ``page_rows`` the paged regime's page size: paged and resident launches
    run different kernels, so they key apart). `touch()` returns True on a
    hit and records the miss otherwise.

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
    >>> shapes.touch("ref", 8, 5, page_rows=256)   # paged: its own key
    False
    """

    def __init__(self, cap: int = 32):
        self.cap = cap
        self._lru: OrderedDict[tuple, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._lru)

    def touch(self, engine: str, bucket: int, k: int,
              groups: int | None = None, lex=None,
              page_rows: int | None = None,
              shards: int | None = None) -> bool:
        key = (engine, bucket, k, groups, lex, page_rows, shards)
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
    ``rescan`` carries the ivf completeness-net context so the under-fill
    check (which must read results) happens at finish time, after every
    other launch went out. ``pad_check`` is the real row count of a fused
    grouped launch whose padding rows point at a BLOCK_ALL blocker lane:
    finish asserts those rows allocated no result rows (k=0 semantics).
    ``extra`` carries the bm25 list of a hybrid rrf launch in lists mode
    (copied into ``extra_np`` at finish). ``sharded`` is a sharded launch
    in flight (its tie checks run at finish); it carries its scan and its
    per-shard rows-scanned vector (host ints)."""
    s: torch.Tensor
    sl: torch.Tensor
    rows: int                     # arena rows this call scored
    rescan: tuple | None = None   # (store, q, pred, k, exact_engine, nv, ivf)
    pad_check: int | None = None  # first padded (blocker-lane) row index
    extra: tuple | None = None    # (lex_s, lex_i) tensors (hybrid rrf lists)
    extra_np: tuple | None = None # their host copies
    sharded: object = None        # a `ShardedLaunch` (sharded engine only)
    launch_ms: float = 0.0        # host-side dispatch cost (perf_counter)
    sync_ms: float = 0.0          # finish-time copy-to-host wait
                                  # (+ rescans)
    terms: int = 0                # postings lanes this call streamed
                                  # (hybrid only) -- the calibration audit's
                                  # per-unit twin of stats.terms_scanned


def _to_device(x: np.ndarray, store: Store) -> torch.Tensor:
    """A host array on the store's controller device; to the card by an
    asynchronous copy from pinned memory, so that a launch never waits on
    the device."""
    return upload(x, controller(store))


def _scan_allocations(store: Store, scan, *rows: np.ndarray, lanes=None):
    """``scan(allocation, *rows on its device[, lanes]) -> outputs`` for
    host ``rows``, once an allocation, each on its allocation's device
    (the rows uploaded to each from the host, so that no card waits on
    another; ``lanes``, a `LexicalArena.snapshot()` laid out like the
    store, gives each scan its allocation's view). Nothing is copied:
    returns [(first row, outputs), ...] in row order."""
    views = (lex_allocations(lanes) if lanes is not None
             else (None,) * len(allocations(store)))
    out = []
    for lo, part, view in zip(row_starts(store), allocations(store), views):
        args = [upload(r, part["emb"].device) for r in rows]
        out.append((lo, scan(part, *args, *(() if view is None
                                            else (view,)))))
    return out


def _merge_allocations(store: Store, lists, k: int):
    """The per-allocation lists of `_scan_allocations`, each output a
    sequence of (scores, slots) pairs, copied to the controller without a
    host sync and merged there pair by pair by position (equal scores to
    the lower allocation, then the lower slot: the single arena's order).
    One allocation's outputs come back as they are (`merge_pieces`)."""
    ctrl = controller(store)
    merged = []
    for j in range(0, len(lists[0][1]), 2):
        merged += merge_pieces([(lo, out[j], out[j + 1])
                                for lo, out in lists], k, ctrl)
    return tuple(merged)


def _exact(store: Store, scan, k: int, *rows: np.ndarray):
    """``scan(allocation, *rows on its device) -> (scores (B, k), slots
    (B, k))`` for host ``rows``: one scan of a store of one allocation, or
    one a device of a store held in several, every scan queued before the
    lists are merged on the controller (`_merge_allocations`)."""
    return _merge_allocations(store, _scan_allocations(store, scan, *rows),
                              k)


def _launch_hot(store: Store, q: np.ndarray, pred: Predicate, k: int,
                engine: str, sharded_fn=None, ivf=None, nprobe=None,
                n_valid: int | None = None, skip_rescan: bool = False,
                page_rows: int | None = None) -> _Hot:
    """Launch one retrieval device call WITHOUT syncing on its result
    (the returned tensors are futures until finish copies them).

    `sharded_fn` is the RagDB's cached `ShardedScan` when engine ==
    'sharded';
    `ivf`/`nprobe` are the IVFIndex and probe depth when engine == 'ivf';
    `n_valid` is the real row count when q is bucket-padded (the probe
    union must come from real rows -- zero padding rows would drag
    arbitrary clusters into the union; a zero row ties on every row, so
    the sharded tie checks read only the real rows). ``skip_rescan`` waives the ivf
    completeness net: degraded plans set it, because their contract is
    already "recall narrows" -- an under-filled k-list IS the degraded
    answer. ``page_rows`` selects the paged regime of the exact scans."""
    n_arena = n_rows(store)
    if engine == "sharded":
        if sharded_fn is None:
            raise ValueError("engine='sharded' requires a mesh-built RagDB")
        launched = sharded_fn.launch(store, q, pred, n_valid)
        return _Hot(launched.scores, launched.slots, n_arena,
                    sharded=launched)
    if engine == "ivf":
        if ivf is None:
            raise ValueError("engine='ivf' requires a built index — "
                             "call RagDB.build_index() first")
        nv = q.shape[0] if n_valid is None else n_valid
        # the rescan's and the starved path's engine: the controller's
        # exact one, over every allocation
        exact = exact_engine(controller(store))
        if (pred, k) in ivf.starved:
            # learned: the WHOLE arena can't fill k for this predicate --
            # probing first would be pure waste (memo clears on any write)
            s, sl = _exact(store, lambda part, q_d: unified_query(
                part, q_d, pred, k, engine=exact, page_rows=page_rows), k, q)
            return _Hot(s, sl, n_arena)
        # the quantizer on the controller over the real rows (its union
        # goes to each allocation's device without a host sync), and
        # rows_scanned as the host probe counts it (a function of (nv,
        # nprobe) alone)
        nprobe = nprobe or ivf.cfg.nprobe
        q_d = _to_device(q, store)
        clusters = ivf.probe_device(q_d[:nv], nprobe)
        rows = ivf.candidate_rows(nprobe, nv)
        s, sl = probe_allocations(store, ivf,
                                  q_d if ALLOCS not in store else q,
                                  clusters, pred, k)
        rescan = None if skip_rescan else (store, q, pred, k, exact, nv, ivf)
        return _Hot(s, sl, rows, rescan=rescan)
    s, sl = _exact(store, lambda part, q_d: unified_query(
        part, q_d, pred, k, engine=engine, page_rows=page_rows), k, q)
    return _Hot(s, sl, n_arena)


def _finish_hot(hot: _Hot, trace_fan=None) -> tuple[np.ndarray, np.ndarray]:
    """Sync one launched call: the copy to the host waits for the device.
    The ivf completeness net runs HERE: a pruned scan can under-fill the
    k-list when qualifying rows sit outside the probed clusters (a tight
    recency bound, or a forced .using("ivf") on a selective predicate). An
    under-filled row falls back to ONE exact rescan -- completeness beats
    speed, and the extra arena scan shows up in `hot.rows`. ``trace_fan``
    (member request traces, tracer-enabled path only) nests a ``rescan``
    span under the caller's open ``device_sync`` span exactly when the net
    fires. A sharded launch finishes here: its tie checks are read and
    any shard whose tie run reached its list's end is relaunched wider;
    its rows are the per-shard vector's sum."""
    if hot.sharded is not None:
        hot.s, hot.sl = hot.sharded.finish()
        hot.rows = sum(hot.sharded.rows)
    s, sl = hot.s.cpu().numpy(), hot.sl.cpu().numpy()
    if hot.extra is not None:
        hot.extra_np = tuple(a.cpu().numpy() for a in hot.extra)
        if hot.pad_check is not None:
            assert (hot.extra_np[1][hot.pad_check:] == -1).all(), (
                "blocker-lane padding rows allocated result rows (lex list)")
    if hot.pad_check is not None and sl.shape[0] > hot.pad_check:
        # padded rows point at a BLOCK_ALL blocker lane: their k-lists must
        # be empty -- a hit here means a padding lane allocated result rows
        assert (sl[hot.pad_check:] == -1).all(), (
            "blocker-lane padding rows allocated result rows")
    if hot.rescan is not None:
        store, q, pred, k, exact, nv, ivf = hot.rescan
        if bool((sl[:nv] < 0).any()):
            fan = (FanSpan(trace_fan, "rescan", engine=exact)
                   if trace_fan is not None else None)
            s, sl = _exact(store, lambda part, q_d: unified_query(
                part, q_d, pred, k, engine=exact), k, q)
            s, sl = s.cpu().numpy(), sl.cpu().numpy()
            if bool((sl[:nv] < 0).any()):
                ivf.starved.add((pred, k))
            hot.rows += n_rows(store)
            if fan is not None:
                fan.end(rows=n_rows(store))
    return s, sl


def _note_sharded(stats: ExecStats | None, hot: _Hot) -> None:
    """Credit one finished sharded launch to the stats: shard count, the
    merge's collective bytes, and the per-shard rows-scanned vector
    (extended if a later mesh is wider)."""
    if stats is None or hot.sharded is None:
        return
    scan, rows = hot.sharded.scan, hot.sharded.rows
    stats.shards_used = max(stats.shards_used, scan.n_shards)
    stats.collective_bytes += scan.collective_bytes
    if len(stats.shard_rows_scanned) < len(rows):
        stats.shard_rows_scanned.extend(
            [0] * (len(rows) - len(stats.shard_rows_scanned)))
    for i, r in enumerate(rows):
        stats.shard_rows_scanned[i] += r


def _pad_group_launch(q: np.ndarray, gids: np.ndarray,
                      preds: list[Predicate], k: int, engine: str, *,
                      stats: ExecStats | None,
                      shapes: CompiledShapes | None, lex=None,
                      page_rows: int | None = None):
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
        shapes.touch(engine, bucket, k, groups=g_bucket, lex=lex,
                     page_rows=page_rows)
        if stats is not None:
            stats.padded_rows += bucket - n_valid
        q = _pad_rows(q, bucket)
        gids = np.concatenate(
            [gids, np.full(bucket - n_valid, g_real, np.int32)])
    return q, gids, preds, n_valid


def _launch_grouped(store: Store, q: np.ndarray, gids: np.ndarray,
                    preds: list[Predicate], k: int, engine: str, *,
                    stats: ExecStats | None = None,
                    shapes: CompiledShapes | None = None,
                    page_rows: int | None = None) -> _Hot:
    """Launch ONE fused grouped scan answering every predicate group in
    ``preds`` (rows and groups padded as `_pad_group_launch` says), paged
    with ``page_rows``."""
    q, gids, preds, n_valid = _pad_group_launch(
        q, gids, preds, k, engine, stats=stats, shapes=shapes,
        page_rows=page_rows)
    s, sl = _exact(store, lambda part, q_d, gids_d: unified_query_grouped(
        part, q_d, gids_d, stack_predicates(preds, part["emb"].device), k,
        engine=engine, page_rows=page_rows), k, q, gids)
    return _Hot(s, sl, n_rows(store), pad_check=n_valid)


def _launch_hybrid(store: Store, lex_snap: dict, q: np.ndarray,
                   gids: np.ndarray, preds: list[Predicate],
                   qterms: np.ndarray, k: int, *, mode: str,
                   w_dense: float, w_lex: float, rrf_c: float,
                   lists: bool = False,
                   stats: ExecStats | None = None,
                   shapes: CompiledShapes | None = None,
                   lex_key=None, page_rows: int | None = None) -> _Hot:
    """Launch ONE fused hybrid dense+BM25 scan answering every predicate
    group in ``preds`` -- the hybrid engine's only dispatch shape (a single
    group is G=1). ``lex_snap`` is `LexicalArena.snapshot()`; ``qterms``
    is (B, QT) int32 per-row query terms, already bucketed to the plan's
    query-term-count bucket. A store on the card runs the CUDA kernel
    (paged with ``page_rows``), a store on the CPU the plain streaming
    scan. ``lists=True`` (rrf + the tiered route) keeps the two per-signal
    lists unfused: dense rides `_Hot.s / .sl`, bm25 `_Hot.extra`, and the
    finish phase rank-fuses after the tier merges."""
    from repro_torch.kernels.hybrid_score.ops import hybrid_score
    from repro_torch.kernels.hybrid_score.ref import rrf_fuse
    q, gids, preds, n_valid = _pad_group_launch(
        q, gids, preds, k, "hybrid", stats=stats, shapes=shapes, lex=lex_key,
        page_rows=page_rows)
    if q.shape[0] != qterms.shape[0]:
        qterms = np.concatenate(
            [qterms, np.full((q.shape[0] - qterms.shape[0], qterms.shape[1]),
                             -1, np.int32)])
    # rank fusion needs global ranks: over several allocations each one
    # returns both per-signal lists, merged per signal before rrf_fuse
    several = ALLOCS in store
    each_lists = lists or (several and mode == "rrf")

    def scan(part, q_d, gids_d, qterms_d, view):
        return hybrid_score(q_d, part["emb"], part["tenant"],
                            part["updated_at"], part["category"],
                            part["acl"], view["terms"], view["lexnorm"],
                            view["idf"], gids_d,
                            stack_predicates(preds, q_d.device), qterms_d, k,
                            mode=mode, w_dense=w_dense, w_lex=w_lex,
                            rrf_c=rrf_c, lists=each_lists,
                            page_rows=page_rows)
    out = _merge_allocations(store, _scan_allocations(
        store, scan, q, gids, qterms, lanes=lex_snap), k)
    if several and mode == "rrf" and not lists:
        out = rrf_fuse(*out, k, rrf_c)
    n_arena = n_rows(store)
    terms = n_arena * int(lex_allocations(lex_snap)[0]["terms"].shape[1])
    if stats is not None:
        stats.terms_scanned += terms
    if lists:
        d_s, d_i, l_s, l_i = out
        return _Hot(d_s, d_i, n_arena, pad_check=n_valid,
                    extra=(l_s, l_i), terms=terms)
    s, sl = out
    return _Hot(s, sl, n_arena, pad_check=n_valid, terms=terms)


def run_grouped(store: Store, q: np.ndarray, preds: list[Predicate], k: int,
                engine: str = "ref", *, stats: ExecStats | None = None,
                shapes: CompiledShapes | None = None,
                page_rows: int | None = None):
    """Predicate-group batched retrieval -- the per-group LOOP: one device
    call per unique predicate, each streaming the arena. q: (B, D) host
    array, preds: B predicates (one per row). Returns (scores (B, k) f32,
    slots (B, k) i32, n_device_calls). All calls launch before the first
    sync; ``page_rows`` runs them in the paged regime."""
    B = q.shape[0]
    groups: dict[Predicate, list[int]] = {}
    for i, p in enumerate(preds):
        groups.setdefault(p, []).append(i)
    launched = []
    for pred, idxs in groups.items():
        q_g = np.asarray(q[np.asarray(idxs)], np.float32)
        if shapes is not None:
            bucket = bucket_rows(q_g.shape[0])
            shapes.touch(engine, bucket, k, page_rows=page_rows)
            if stats is not None:
                stats.padded_rows += bucket - q_g.shape[0]
            q_g = _pad_rows(q_g, bucket)
        launched.append((idxs, _launch_hot(store, q_g, pred, k, engine,
                                           page_rows=page_rows)))
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
                      shapes: CompiledShapes | None = None,
                      page_rows: int | None = None):
    """Scan-once counterpart of `run_grouped`: the G unique predicates
    stack into one (G, 4) block and ONE fused grouped call answers every
    row -- `rows_scanned` is the arena N, not G*N, paged or not. Same
    contract and return shape as `run_grouped` (n_device_calls is always
    1)."""
    B = q.shape[0]
    uniq: dict[Predicate, int] = {}
    for p in preds:
        if p not in uniq:
            uniq[p] = len(uniq)
    gids = np.asarray([uniq[p] for p in preds], np.int32)
    hot = _launch_grouped(store, np.asarray(q, np.float32), gids,
                          list(uniq), k, engine, stats=stats, shapes=shapes,
                          page_rows=page_rows)
    s, sl = _finish_hot(hot)
    if stats is not None:
        stats.device_calls += 1
        stats.queries += B
        stats.hot_queries += B
        stats.rows_scanned += hot.rows
        stats.fused_groups += len(uniq)
        stats.fused_scans += 1
    return s[:B], sl[:B], 1


def merge_tiers(hs, hi, ws, wi, k: int):
    """Merge hot and warm k-lists into the global top-k (host-side).

    On every hot+warm query's critical path, so the selection is
    argpartition (O(m)) + a small sort of the k winners, not a full
    argsort of the concatenated 2k-wide lists; ties break toward the
    lowest concatenated column (hot before warm), deterministically -- also
    AT the k boundary, where raw argpartition would split tied scores
    arbitrarily (the selection among columns tied at the k-th value is
    re-derived in column order).

    >>> hs = np.array([[3.0, 1.0]]); hi = np.array([[7, 5]])
    >>> ws = np.array([[2.0, 0.5]]); wi = np.array([[9, 4]])
    >>> s, i, t = merge_tiers(hs, hi, ws, wi, k=3)
    >>> i.tolist(), t.tolist()
    ([[7, 9, 5]], [[0, 1, 0]])
    """
    scores = np.concatenate([hs, ws], axis=1)
    slots = np.concatenate([hi, wi], axis=1)
    tiers = np.concatenate([np.full_like(hi, TIER_HOT),
                            np.full_like(wi, TIER_WARM)], axis=1)
    m = scores.shape[1]
    if k < m:
        # the partition only fixes the kth VALUE; select deterministically:
        # every column strictly above it, then lowest columns tied at it
        kth = np.take_along_axis(
            scores, np.argpartition(-scores, k - 1, axis=1)[:, k - 1:k],
            axis=1)                                        # (B, 1)
        gt = scores > kth
        eq = scores == kth
        n_eq = k - gt.sum(axis=1, keepdims=True)
        sel = gt | (eq & (np.cumsum(eq, axis=1) <= n_eq))
        cols = np.nonzero(sel)[1].reshape(scores.shape[0], k)  # ascending
        order = np.take_along_axis(
            cols, np.argsort(-np.take_along_axis(scores, cols, axis=1),
                             axis=1, kind="stable"), axis=1)
    else:
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    gather = lambda a: np.take_along_axis(a, order, axis=1)
    return gather(scores), gather(slots), gather(tiers)


def _rrf_merge_np(ds, di, dt, ls, li, lt, k: int, c: float):
    """Host-side reciprocal-rank fusion of two TIER-MERGED per-signal
    k-lists (numpy twin of `kernels.hybrid_score.ref.rrf_fuse`, with tier
    tags carried through): candidates are identified by (slot, tier) --
    the hot and warm tiers are separate arenas, so a bare slot number is
    ambiguous across the merge. A candidate in both lists is represented
    by its dense-list copy; ties break dense-first then rank order,
    deterministically (stable argsort over the [dense | lex] concat)."""
    neg = np.float32(np.finfo(np.float32).min)
    kd, kl = di.shape[1], li.shape[1]
    rd = (1.0 / (c + np.arange(1, kd + 1))).astype(np.float32)
    rl = (1.0 / (c + np.arange(1, kl + 1))).astype(np.float32)
    d_valid = di >= 0
    l_valid = li >= 0
    cross = ((di[:, :, None] == li[:, None, :])
             & (dt[:, :, None] == lt[:, None, :])
             & d_valid[:, :, None] & l_valid[:, None, :])
    d_score = (np.where(d_valid, rd[None, :], neg)
               + (cross * rl[None, None, :]).sum(axis=2, dtype=np.float32))
    in_dense = cross.any(axis=1)
    l_score = np.where(l_valid & ~in_dense, rl[None, :], neg)
    all_s = np.concatenate([d_score, l_score], axis=1)
    all_i = np.concatenate([di, li], axis=1)
    all_t = np.concatenate([dt, lt], axis=1)
    order = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
    gather = lambda a: np.take_along_axis(a, order, axis=1)
    s, sl, tr = gather(all_s), gather(all_i), gather(all_t)
    live = s > neg
    return (np.where(live, s, neg), np.where(live, sl, -1),
            np.where(live, tr, TIER_HOT))


def query_tiered(hot_store: Store, warm, q: np.ndarray, pred: Predicate,
                 k: int, *, engine: str = "ref", probe_warm: bool = False,
                 sharded_fn=None, ivf=None, nprobe=None,
                 stats: ExecStats | None = None,
                 n_valid: int | None = None, page_rows: int | None = None):
    """Single-predicate tiered retrieval (`TieredRouter.query`'s engine
    room). The hot call is LAUNCHED first and synced last: the warm probe
    (its own round trip, pushed down) is issued while the hot scan is in
    flight.

    ``n_valid`` is the count of real query rows when the caller padded q
    to a bucket -- the warm probe sees the UNPADDED rows. Returns (scores,
    slots, tiers) numpy arrays of q's full row count without a warm probe,
    and of ``n_valid`` rows with one; callers slice ``[:n_valid]``."""
    q = np.atleast_2d(np.asarray(q, np.float32))
    n_logical = q.shape[0] if n_valid is None else n_valid
    hot = _launch_hot(hot_store, q, pred, k, engine, sharded_fn, ivf, nprobe,
                      n_logical, page_rows=page_rows)
    ws = wi = None
    warm_calls = 0
    if probe_warm:
        # the warm client's round trips are device calls too -- count them,
        # or device_calls would under-report exactly when the expensive
        # route runs
        rt0 = warm.stats.round_trips
        ws, wi = warm.query(q[:n_logical], pred, k, pushdown=True)
        warm_calls = warm.stats.round_trips - rt0
    hs, hi = _finish_hot(hot)
    _note_sharded(stats, hot)
    if stats is not None:
        stats.device_calls += 1 + warm_calls
        stats.queries += n_logical
        stats.hot_queries += n_logical
        stats.rows_scanned += hot.rows
        if probe_warm:
            stats.warm_queries += n_logical
    if not probe_warm:
        return hs, hi, np.full_like(hi, TIER_HOT)
    return merge_tiers(hs[:n_logical], hi[:n_logical], ws, wi, k)


def _qterms_rows(row_plans, idxs, qt_bucket: int) -> np.ndarray:
    """Per-row query-term matrix for a hybrid dispatch: row i's plan
    supplies its lowered match() ids, padded with -1 to the unit's
    query-term-count bucket (part of the fuse key, so every member fits)."""
    qt = np.full((len(idxs), qt_bucket), -1, np.int32)
    for r, i in enumerate(idxs):
        t = row_plans[i].logical.match_terms or ()
        qt[r, :len(t)] = t
    return qt


@dataclasses.dataclass
class InFlightPlans:
    """A launched-but-unsynced `launch_plans` batch: every hot device call
    is in flight and every warm probe has been issued; no hot result has
    been copied to the host. `finish_plans` consumes it."""
    inflight: list               # (FusedGroup, member row-index lists, _Hot)
    warm_results: list           # per unit: list of probe tuples (an entry
                                 # is None when the guarded probe gave up),
                                 # or None for hot-route units
    B: int                       # total query rows across plans
    k: int
    stats: "ExecStats | None"
    lex: object = None           # hot-tier LexicalArena (rrf merge's rrf_c)
    warm_failed: set = dataclasses.field(default_factory=set)
                                 # group_keys whose warm probe failed over
                                 # to hot-only (RagDB.finish stamps the
                                 # explicit degradation, skips the cache)
    row_traces: list | None = None   # per query row: the owning request's
                                 # obs.Trace (tracer-enabled path only)
    calib: object = None         # obs.CalibrationTable (always-on audit)


def execute_plans(hot_store: Store, warm, plans: list[PhysicalPlan], *,
                  sharded_fn=None, stats: ExecStats | None = None,
                  shapes: CompiledShapes | None = None, index=None,
                  planner_cfg=None, lex=None):
    """Batched execution of compiled plans: `launch_plans` then
    `finish_plans`. ``warm`` is the warm tier's `SplitStackClient`, probed
    by "hot+warm" groups (None when no plan routes there). Every plan must
    carry its query rows (`logical.q`, (B_i, D)) and all must share one k.
    ``index`` is the RagDB's `IVFIndex`, consumed by engine-'ivf' groups;
    ``lex`` its hot-tier `LexicalArena`, consumed by engine-'hybrid'
    groups; ``sharded_fn`` its `ShardedScan`, consumed by
    engine-'sharded' groups. Returns (scores (B, k), slots (B, k), tiers (B, k)) numpy
    arrays, B = total query rows, in plan order."""
    return finish_plans(launch_plans(hot_store, warm, plans,
                                     sharded_fn=sharded_fn, stats=stats,
                                     shapes=shapes, index=index,
                                     planner_cfg=planner_cfg, lex=lex))


def launch_plans(hot_store: Store, warm, plans: list[PhysicalPlan], *,
                 sharded_fn=None, stats: ExecStats | None = None,
                 shapes: CompiledShapes | None = None, index=None,
                 planner_cfg=None, lex=None, warm_guard=None, obs=None,
                 tracer=None, calib=None) -> InFlightPlans:
    """LAUNCH phase, in two steps. (1) Group plans by `group_key`, hand the
    distinct groups to `planner.fuse_batch`, and launch EVERY hot dispatch
    unit without syncing. (2) Only then, issue one warm probe per member
    plan of each "hot+warm" unit (`warm`, the `SplitStackClient`; its
    result is a host array, so the probe waits behind the hot scans already
    queued). ``index`` (the RagDB's `IVFIndex`) serves engine-'ivf' groups,
    ``lex`` (its `LexicalArena`) engine-'hybrid' groups and ``sharded_fn``
    (its `ShardedScan`) engine-'sharded' groups.

    ``warm_guard`` (`serving.faults.WarmGuard`) wraps each warm probe with
    timeout / bounded retry / hedge / circuit breaker; when it gives up,
    that group fails over to hot-only (its probe entry is None and its
    group_key lands in `InFlightPlans.warm_failed`). ``obs`` (one obs.Trace
    per plan) records a ``launch`` span per unit and a ``warm_probe`` span
    per probe into each member request's trace; ``tracer`` is the
    active-sink stack warm faults and guard decisions annotate through;
    ``calib`` is carried to `finish_plans`, which records the
    predicted-vs-measured audit."""
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
        if rep.engine == "hybrid":
            # hybrid always dispatches through the grouped fused scan (a
            # single predicate group is simply G=1): ONE pass computes
            # dense + BM25 + predicate masks for every member group
            if lex is None:
                raise ValueError("engine='hybrid' requires a lexical arena "
                                 "— construct the RagDB with lexical_cfg")
            idxs = [i for m in member_idxs for i in m]
            gids = np.concatenate(
                [np.full(len(m), g, np.int32)
                 for g, m in enumerate(member_idxs)])
            mode, qt_bucket, w_d, w_l = rep.lex
            hot = _launch_hybrid(
                hot_store, lex.snapshot(), q_all[np.asarray(idxs)], gids,
                [p.pred for p in unit.plans],
                _qterms_rows(row_plans, idxs, qt_bucket), k, mode=mode,
                w_dense=w_d, w_lex=w_l, rrf_c=lex.cfg.rrf_c,
                lists=(mode == "rrf" and rep.route == "hot+warm"),
                stats=stats, shapes=shapes, lex_key=rep.lex,
                page_rows=rep.page_rows)
            if stats is not None and unit.fused:
                stats.fused_groups += len(unit.plans)
                stats.fused_scans += 1
        elif unit.fused:
            idxs = [i for m in member_idxs for i in m]
            gids = np.concatenate(
                [np.full(len(m), g, np.int32)
                 for g, m in enumerate(member_idxs)])
            hot = _launch_grouped(hot_store, q_all[np.asarray(idxs)], gids,
                                  [p.pred for p in unit.plans], k,
                                  rep.engine, stats=stats, shapes=shapes,
                                  page_rows=rep.page_rows)
            if stats is not None:
                stats.fused_groups += len(unit.plans)
                stats.fused_scans += 1
        else:
            (plan,) = unit.plans
            (idxs,) = member_idxs
            q_g = q_all[np.asarray(idxs)]
            n_valid = q_g.shape[0]
            if shapes is not None:
                bucket = bucket_rows(n_valid)
                shapes.touch(plan.engine, bucket, k,
                             page_rows=plan.page_rows, shards=plan.shards)
                if stats is not None:
                    stats.padded_rows += bucket - n_valid
                q_g = _pad_rows(q_g, bucket)
            hot = _launch_hot(hot_store, q_g, plan.pred, k, plan.engine,
                              sharded_fn, index, plan.nprobe, n_valid,
                              skip_rescan=bool(plan.degraded),
                              page_rows=plan.page_rows)
        hot.launch_ms = (time.perf_counter() - t_launch0) * 1e3
        if fan is not None:
            fan.end(rows=sum(len(m) for m in member_idxs),
                    page_rows=rep.page_rows)
        inflight.append((unit, member_idxs, hot))
        if stats is not None:
            n_rows_unit = sum(len(m) for m in member_idxs)
            stats.device_calls += 1
            stats.queries += n_rows_unit
            stats.hot_queries += n_rows_unit
            if rep.page_rows is not None:
                stats.paged_scans += 1

    # -- step 2: warm probes, issued after every hot unit is launched ----
    warm_results: list[list[tuple] | None] = []
    warm_failed: set = set()
    for unit, member_idxs, _ in inflight:
        if unit.plans[0].route != "hot+warm":
            warm_results.append(None)
            continue
        probes = []
        for plan, m in zip(unit.plans, member_idxs):
            rt0 = warm.stats.round_trips
            if plan.engine == "hybrid":
                # warm-tier LEXICAL pushdown: predicate AND query terms
                # travel into the warm scan, scored by the same formula
                # (global idf / avgdl), so the merge compares like with like
                mode, qt_bucket, w_d, w_l = plan.lex

                def probe(plan=plan, m=m, mode=mode, qt_bucket=qt_bucket,
                          w_d=w_d, w_l=w_l):
                    return warm.query_hybrid(
                        q_all[np.asarray(m)],
                        _qterms_rows(row_plans, m, qt_bucket), plan.pred, k,
                        mode=mode, w_dense=w_d, w_lex=w_l,
                        rrf_c=lex.cfg.rrf_c, lists=(mode == "rrf"))
            else:
                def probe(plan=plan, m=m):
                    return warm.query(q_all[np.asarray(m)], plan.pred, k,
                                      pushdown=True)

            wspan = None
            if row_traces is not None:
                wspan = FanSpan([row_traces[i] for i in m], "warm_probe",
                                engine=plan.engine)
                if tracer is not None:
                    # warm faults + WarmGuard decisions annotate this span
                    tracer.push(wspan)
            try:
                res = (warm_guard.call(probe) if warm_guard is not None
                       else probe())
            finally:
                if wspan is not None and tracer is not None:
                    tracer.pop()
            if wspan is not None:
                wspan.end(failover=res is None)
            if stats is not None:
                # real round trips issued, successful or not (retries count)
                stats.device_calls += warm.stats.round_trips - rt0
            if res is None:
                # the guard gave up: this group serves hot-only, explicitly
                warm_failed.add(plan.group_key)
                probes.append(None)
                if stats is not None:
                    stats.warm_failovers += 1
                continue
            probes.append(res)
            if stats is not None:
                stats.warm_queries += len(m)
                if plan.engine == "hybrid" and warm.lex is not None:
                    stats.terms_scanned += (warm.cfg.capacity
                                            * warm.lex.cfg.doc_terms)
        warm_results.append(probes)
    return InFlightPlans(inflight=inflight, warm_results=warm_results, B=B,
                         k=k, stats=stats, lex=lex, warm_failed=warm_failed,
                         row_traces=row_traces, calib=calib)


def finish_plans(pending: InFlightPlans):
    """FINISH phase: the first copy of a hot result to the host. Syncs
    every in-flight unit, runs ivf completeness rescans, merges the tiers
    (rrf hybrid merges per SIGNAL across the tiers, then rank-fuses) and
    scatters into row order. Each unit's sync is a ``device_sync`` span
    (rescans nest inside it) and its merge a ``merge`` span in every member
    request's trace, and each unit lands one predicted-vs-measured row in
    `pending.calib`. Returns (scores, slots, tiers)."""
    B, k, stats, lex = pending.B, pending.k, pending.stats, pending.lex
    row_traces, calib = pending.row_traces, pending.calib
    scores = np.full((B, k), np.float32(NEG_INF), np.float32)
    slots = np.full((B, k), -1, np.int32)
    tiers = np.full((B, k), TIER_HOT, np.int32)
    for (unit, member_idxs, hot), probes in zip(pending.inflight,
                                                pending.warm_results):
        unit_traces = ([row_traces[i] for m in member_idxs for i in m]
                       if row_traces is not None else None)
        sync_fan = (FanSpan(unit_traces, "device_sync",
                            engine=unit.plans[0].engine)
                    if unit_traces is not None else None)
        t_sync0 = time.perf_counter()
        hs, hi = _finish_hot(hot, trace_fan=unit_traces)
        hot.sync_ms = (time.perf_counter() - t_sync0) * 1e3
        _note_sharded(stats, hot)
        if sync_fan is not None:
            if hot.sharded is not None:
                scan = hot.sharded.scan
                sync_fan.annotate("shards", scan.n_shards)
                sync_fan.annotate("collective_bytes", scan.collective_bytes)
            sync_fan.end(rows_scanned=hot.rows)
        if calib is not None:
            rep = unit.plans[0]
            calib.record_unit(
                engine=rep.engine, n_rows=rep.n_rows,
                groups=len(unit.plans), k=k,
                rows=sum(len(m) for m in member_idxs),
                predicted_ms=rep.est_cost_ms, launch_ms=hot.launch_ms,
                sync_ms=hot.sync_ms, rows_scanned=hot.rows,
                terms_scanned=hot.terms)
        if stats is not None:
            stats.rows_scanned += hot.rows
        merge_fan = (FanSpan(unit_traces, "merge", groups=len(member_idxs))
                     if unit_traces is not None else None)
        off = 0
        for gi, m in enumerate(member_idxs):
            span = slice(off, off + len(m))
            if probes is None:
                s_m, sl_m = hs[span], hi[span]
                t_m = np.full_like(sl_m, TIER_HOT)
            elif probes[gi] is None and hot.extra_np is not None:
                # the guarded warm probe failed for an rrf hybrid group: the
                # hot scan ran in lists mode, so rank-fuse the two HOT lists
                h_ls, h_li = hot.extra_np
                s_m, sl_m, t_m = _rrf_merge_np(
                    hs[span], hi[span], np.full_like(hi[span], TIER_HOT),
                    h_ls[span], h_li[span],
                    np.full_like(h_li[span], TIER_HOT), k, lex.cfg.rrf_c)
            elif probes[gi] is None:
                # the guarded warm probe failed: this group serves hot-only
                s_m, sl_m = hs[span], hi[span]
                t_m = np.full_like(sl_m, TIER_HOT)
            elif hot.extra_np is not None:
                # rrf hybrid across tiers: merge per SIGNAL first, then
                # rank-fuse -- ranks only mean something over the complete
                # per-signal candidate list
                w_ds, w_di, w_ls, w_li = probes[gi]
                ds, di, dt = merge_tiers(hs[span], hi[span], w_ds, w_di, k)
                h_ls, h_li = hot.extra_np
                ls2, li2, lt2 = merge_tiers(h_ls[span], h_li[span],
                                            w_ls, w_li, k)
                s_m, sl_m, t_m = _rrf_merge_np(ds, di, dt, ls2, li2, lt2, k,
                                               lex.cfg.rrf_c)
            else:
                ws, wi = probes[gi]
                s_m, sl_m, t_m = merge_tiers(hs[span], hi[span], ws, wi, k)
            scores[m], slots[m], tiers[m] = s_m, sl_m, t_m
            off += len(m)
        if merge_fan is not None:
            merge_fan.end()
    return scores, slots, tiers
