"""Admission-controlled async scheduler in front of `RagDB` (port of
``repro.serving.scheduler``).

The serving loop between the load harness and the executor:

- **bounded queue + load shedding** — `offer()` admits a request or sheds it
  immediately when the queue is full. Shedding at admission keeps queue wait
  bounded (a request that would wait past its deadline anyway is refused
  while the refusal is still cheap), which is what holds p99 under overload.
- **continuous bucketed batching** — `step()` drains a same-k run of the
  queue (the executor's one-k-per-call contract), launches it through
  `RagDB.launch` (phase-1/2 of the executor's three-phase dispatch: every
  hot program is in flight before any sync), and only *then* finishes the
  PREVIOUS batch's `PendingExecution` — batch N+1's device work overlaps
  batch N's copy to the host. `RagDB.launch` issues no host sync for
  hot-only plans, so the overlap is real on the card.
- **deadline-aware degradation** — each drained request gets a remaining
  budget (`slo_ms` minus its measured queue wait). When the cost model says
  the plan busts the budget, or queue pressure crosses the configured
  fraction, the scheduler walks `RagDB.degrade` rungs (nprobe halving ->
  engine switch, each a real compiled plan, bit-identical to running that
  degraded plan directly). Past `stale_pressure` it also allows
  staleness-bounded cache serves (`RagDB.launch(stale_within_s=...)`).
  Degradations land in the plan's `explain()` and in `ExecStats`; tenant
  and ACL clauses ride through every rung untouched.

The scheduler is deliberately synchronous-single-threaded: requests arrive
on the harness's wall clock, and the overlap that matters (device compute
vs host-side planning + the copy to the host) comes from the launch/finish split, not
host threads. `clock` is injectable so tests drive it deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.api.plan import PhysicalPlan
from repro_torch.api.ragdb import PendingExecution, RagDB
from repro_torch.serving.faults import (FaultError, HotLaunchError,
                                        ResilienceConfig, WarmGuard)
from repro_torch.serving.metrics import MetricsRegistry


@dataclasses.dataclass
class SchedulerConfig:
    """Serving knobs (documented in docs/api.md).

    ``admission=False`` is the measurement baseline: an unbounded FIFO with
    no shedding, no degradation, and no stale serves — exactly the queue
    whose p99 blows up under overload in bench_serving.py."""
    slo_ms: float = 50.0            # per-request end-to-end deadline
    max_queue: int = 64             # admission bound; offer() sheds beyond it
    max_batch: int = 16             # max requests drained per step()
    admission: bool = True          # False = baseline FIFO (no shed/degrade)
    degrade_pressure: float = 0.5   # queue-fill fraction -> one ladder rung
    stale_pressure: float = 0.9     # queue-fill fraction -> allow stale serves
    stale_within_s: float | None = None   # staleness bound; None disables
    use_cache: bool = True          # snapshot-exact result cache on/off
    # -- resilience (serving.faults; all timings on the injected clock) ----
    warm_timeout_ms: float | None = None  # refuse warm probes slower than this
    hedge_ms: float | None = None   # hedge warm probes slower than this
    warm_retries: int = 2           # warm probe attempts = warm_retries + 1
    retry_base_ms: float = 1.0      # backoff = base * 2^attempt * jitter
    retry_jitter: float = 0.5       # seeded jitter factor in [1, 1 + jitter]
    breaker_failures: int = 3       # consecutive warm failures -> breaker opens
    breaker_reset_s: float = 1.0    # open -> half-open probe delay
    launch_retries: int = 2         # extra db.launch attempts on launch fault
    watchdog_ms: float | None = None      # fail/requeue batches wedged past
                                          # this service time; None disables
    requeue_limit: int = 1          # watchdog/finish-fault requeues before a
                                    # request is shed as "failed"
    seed: int = 0                   # backoff-jitter RNG seed


@dataclasses.dataclass
class ServeRequest:
    """One admitted retrieval request. ``plan`` was lowered through
    `db.session(principal)` by the caller, so tenant/ACL clauses are already
    stamped structurally — the scheduler never sees a principal and cannot
    widen visibility, under any degradation."""
    plan: PhysicalPlan
    arrival_t: float               # scheduler-clock seconds (queue-wait base)
    req_id: int = 0
    tenant: int = -2               # metrics label only (plan.pred is the law)
    retries: int = 0               # watchdog/fault requeues consumed so far
    trace: object = None           # obs.Trace — born at offer() when the
                                   # db's tracer is on, carried through every
                                   # requeue, finished with the result

    @property
    def rows(self) -> int:
        q = self.plan.logical.q
        return 1 if q is None else int(np.atleast_2d(q).shape[0])


@dataclasses.dataclass
class ServedResult:
    """Per-request outcome: result arrays + the full serving audit trail."""
    request: ServeRequest
    scores: np.ndarray
    slots: np.ndarray
    tiers: np.ndarray
    served: str                    # "fresh" | "cache" | "stale" | "failed"
                                   # ("failed" = explicitly shed after
                                   # retries/watchdog gave up: scores are
                                   # NEG_INF, slots are -1 — never a
                                   # silently-wrong answer)
    stale_age_s: float | None
    degraded: tuple[str, ...]      # ladder rungs applied (() = full plan)
    queue_wait_ms: float
    service_ms: float              # launch -> finish for this batch
    e2e_ms: float                  # arrival -> result available
    deadline_met: bool


class Scheduler:
    """See module docstring. One instance per RagDB; not thread-safe (the
    open-loop harness is single-threaded by design).

    >>> import numpy as np, torch
    >>> from repro_torch.api import RagDB
    >>> from repro_torch.core.store import DocBatch, StoreConfig
    >>> db = RagDB(StoreConfig(capacity=8, dim=4), device="cpu")
    >>> db.ingest(DocBatch(
    ...     emb=torch.eye(4), tenant=torch.zeros(4, dtype=torch.int32),
    ...     category=torch.zeros(4, dtype=torch.int32),
    ...     updated_at=torch.zeros(4, dtype=torch.int32),
    ...     acl=torch.ones(4, dtype=torch.int32), doc_id=torch.arange(4)))
    >>> sched = Scheduler(db, SchedulerConfig(max_queue=1),
    ...                   clock=lambda: 0.0)
    >>> plan = db.admin_session().search(np.eye(4)[1]).limit(2).plan()
    >>> [sched.offer(ServeRequest(plan=plan, arrival_t=0.0))
    ...  for _ in range(2)]                  # the second one is shed
    [True, False]
    >>> [(r.served, r.slots[0].tolist()) for r in sched.run_until_idle()]
    [('fresh', [1, 0])]
    """

    def __init__(self, db: RagDB, cfg: SchedulerConfig = SchedulerConfig(),
                 *, clock=None, metrics: MetricsRegistry | None = None,
                 sleep=None):
        self.db = db
        self.cfg = cfg
        # one clock for queue waits AND cache-entry ages — tests inject a
        # fake; the db's monotonic clock is the default
        self.clock = clock if clock is not None else db.clock
        if clock is not None:
            db.clock = clock
        # injectable backoff sleep — fake-clock tests pass clock.advance so
        # retry delays advance virtual time instead of blocking
        self._sleep = sleep if sleep is not None else time.sleep
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._rng = np.random.default_rng(cfg.seed)
        # guarded warm probes: timeout / bounded retry / hedge / breaker.
        # Installed on the db so the executor's phase-2 probes run through
        # it; breaker-open serves hot-only with an explicit annotation.
        self.guard = WarmGuard(
            ResilienceConfig(
                timeout_ms=cfg.warm_timeout_ms, hedge_ms=cfg.hedge_ms,
                max_retries=cfg.warm_retries,
                retry_base_ms=cfg.retry_base_ms,
                retry_jitter=cfg.retry_jitter,
                breaker_failures=cfg.breaker_failures,
                breaker_reset_s=cfg.breaker_reset_s),
            clock=self.clock, sleep=self._sleep, metrics=self.metrics,
            seed=cfg.seed)
        db.warm_guard = self.guard
        # retry/hedge/breaker decisions annotate the active warm_probe span
        # (attach_tracer re-points this if a tracer arrives later)
        self.guard.tracer = db.tracer
        self.queue: deque[ServeRequest] = deque()
        # at most one batch in flight beyond the one being launched: the
        # executor's host-copy pipeline depth
        self._pending: list[tuple[PendingExecution, list[ServeRequest],
                                  list[float], float]] = []
        self.shed_count = 0

    # -- admission ---------------------------------------------------------
    def offer(self, req: ServeRequest) -> bool:
        """Admit ``req`` or shed it (bounded queue). Returns admitted.

        With the db's tracer on, the request's trace is born HERE — queue
        wait is part of its life — with an open ``queue`` span that the
        drain closes; a shed request's trace finishes immediately, pinned
        ``failed`` so the flight recorder keeps it."""
        tracer = self.db.tracer
        if tracer.enabled and req.trace is None:
            req.trace = tracer.trace("request", req_id=req.req_id,
                                     tenant=req.tenant)
        if self.cfg.admission and len(self.queue) >= self.cfg.max_queue:
            self.shed_count += 1
            self.metrics.inc("shed", tenant=req.tenant)
            if req.trace is not None and req.trace.enabled:
                req.trace.annotate("served", "shed")
                req.trace.pin("failed")
                req.trace.finish()
            return False
        self.queue.append(req)
        if req.trace is not None and req.trace.enabled:
            req.trace.begin("queue")
        return True

    @property
    def busy(self) -> bool:
        return bool(self.queue) or bool(self._pending)

    # -- degradation policy ------------------------------------------------
    def _degrade_for(self, req: ServeRequest, budget_ms: float,
                     pressure: float) -> PhysicalPlan:
        """Walk ladder rungs until the plan fits its budget: every rung the
        cost model prices over budget comes off, and raw queue pressure
        past ``degrade_pressure`` costs rungs even without a model — one
        rung at the threshold, another per 0.2 of pressure above it, so a
        nearly-full queue walks ivf plans to the nprobe floor while a
        barely-pressured one sheds only probe depth."""
        plan = req.plan
        dp = self.cfg.degrade_pressure
        pressure_rungs = (0 if pressure < dp
                          else 1 + int((pressure - dp) / 0.2))
        while True:
            est = plan.est_cost_ms
            over_budget = est is not None and est > max(budget_ms, 0.0)
            pressured = len(plan.degraded) < pressure_rungs
            if not (over_budget or pressured):
                return plan
            nxt = self.db.degrade(plan)
            if nxt is None:
                return plan
            rung = nxt.degraded[len(plan.degraded)]
            self.metrics.inc("degradations", rung=rung.split(" ")[0])
            plan = nxt

    # -- the scheduling round ----------------------------------------------
    def step(self) -> list[ServedResult]:
        """One round: drain a same-k run of the queue, degrade under
        pressure, LAUNCH it, then FINISH the previous batch and return its
        results. Call `flush()` to drain the pipeline at end of trace."""
        out: list[ServedResult] = []
        batch: list[ServeRequest] = []
        while (self.queue and len(batch) < self.cfg.max_batch
               and self.queue[0].plan.logical.k
               == (batch[0].plan.logical.k if batch
                   else self.queue[0].plan.logical.k)):
            batch.append(self.queue.popleft())
        if batch:
            now = self.clock()
            # pressure = queue depth AT DRAIN TIME (batch included) over the
            # admission bound — post-drain depth would read near-zero right
            # after a burst filled the queue, exactly when degradation
            # should be kicking in
            depth = len(self.queue) + len(batch)
            pressure = (depth / max(self.cfg.max_queue, 1)
                        if self.cfg.admission else 0.0)
            plans, waits, allow_stale = [], [], False
            for r in batch:
                wait_ms = (now - r.arrival_t) * 1e3
                waits.append(wait_ms)
                self.metrics.hist("queue_wait_ms").observe(wait_ms)
                tr = r.trace
                traced = tr is not None and tr.enabled
                if traced:
                    # close the queue span offer()/requeue left open
                    tr.end_current(wait_ms=wait_ms)
                budget = self.cfg.slo_ms - wait_ms
                sid = tr.begin("plan", pressure=pressure,
                               budget_ms=budget) if traced else None
                plan = (self._degrade_for(r, budget, pressure)
                        if self.cfg.admission else r.plan)
                if sid is not None:
                    tr.end(sid, engine=plan.engine,
                           rungs=len(plan.degraded))
                if self.cfg.admission and self.cfg.stale_within_s is not None:
                    allow_stale |= (budget <= 0
                                    or pressure >= self.cfg.stale_pressure)
                plans.append(plan)
            if self.cfg.admission:
                # batch-homogeneous depth: every plan walks to the DEEPEST
                # rung count any request in the batch needed. A mixed-rung
                # batch cannot fuse — each distinct rung mix is a novel
                # group layout, i.e. a fresh compile in the serving path —
                # while a homogeneous batch stays one already-warm program.
                # (Each rung is still a real plan: bit-identity per rung
                # holds; homogenization only picks WHICH rung runs.)
                deepest = max(len(p.degraded) for p in plans)
                for i, p in enumerate(plans):
                    while (len(p.degraded) < deepest
                           and (nxt := self.db.degrade(p)) is not None):
                        rung = nxt.degraded[len(p.degraded)]
                        self.metrics.inc("degradations",
                                         rung=rung.split(" ")[0])
                        p = nxt
                    plans[i] = p
            for r, p in zip(batch, plans):
                self.metrics.inc("requests", engine=p.engine)
                self.metrics.inc("requests", tenant=r.tenant)
            # bounded launch retry: hot.launch faults fire BEFORE any device
            # dispatch, so re-entering db.launch is side-effect-clean
            traces = ([r.trace for r in batch]
                      if self.db.tracer.enabled else None)
            pending = None
            for attempt in range(self.cfg.launch_retries + 1):
                try:
                    pending = self.db.launch(
                        plans, use_cache=self.cfg.use_cache,
                        stale_within_s=(self.cfg.stale_within_s if allow_stale
                                        else None),
                        traces=traces)
                    break
                except HotLaunchError:
                    if attempt < self.cfg.launch_retries:
                        self.metrics.inc("launch_retries")
                        self._backoff(attempt)
            # overwrite queued plans with what actually ran, so results
            # carry the degraded explain()/audit tags
            for r, p in zip(batch, plans):
                r.plan = p
            if pending is None:
                # retries exhausted: shed the batch EXPLICITLY (served =
                # "failed", sentinel scores/slots) instead of wedging or
                # silently dropping it
                self.metrics.inc("launch_failures")
                out.extend(self._failed_results(batch, waits, now))
            else:
                self._pending.append((pending, batch, waits, now))
        if len(self._pending) > (1 if batch else 0):
            out.extend(self._finish_oldest())
        return out

    def _backoff(self, attempt: int) -> None:
        """Exponential backoff with seeded jitter between retry attempts."""
        base = self.cfg.retry_base_ms * (2.0 ** attempt)
        jitter = 1.0 + self.cfg.retry_jitter * float(self._rng.random())
        self._sleep(base * jitter / 1e3)

    def _failed_results(self, batch: list[ServeRequest], waits: list[float],
                        t_launch: float) -> list[ServedResult]:
        """Explicit failure results: NEG_INF scores, -1 slots, served =
        "failed" — the chaos contract's 'explicitly shed' class."""
        t_done = self.clock()
        out = []
        for r, wait_ms in zip(batch, waits):
            self.metrics.inc("failed", tenant=r.tenant)
            k, n = r.plan.logical.k, r.rows
            e2e_ms = (t_done - r.arrival_t) * 1e3
            if r.trace is not None and r.trace.enabled:
                r.trace.annotate("served", "failed")
                r.trace.pin("failed")
                r.trace.finish(e2e_ms=e2e_ms)
            out.append(ServedResult(
                request=r,
                scores=np.full((n, k), np.float32(np.finfo(np.float32).min),
                               np.float32),
                slots=np.full((n, k), -1, np.int32),
                tiers=np.zeros((n, k), np.int32),
                served="failed", stale_age_s=None,
                degraded=r.plan.degraded, queue_wait_ms=wait_ms,
                service_ms=(t_done - t_launch) * 1e3, e2e_ms=e2e_ms,
                deadline_met=False))
        return out

    def _fail_or_requeue(self, batch: list[ServeRequest],
                         waits: list[float],
                         t_launch: float) -> list[ServedResult]:
        """A batch's finish was wedged or faulted: requeue each request
        (front of queue, bounded by ``requeue_limit``) or shed it as
        "failed". The serving loop keeps moving either way."""
        retry: list[tuple[ServeRequest, float]] = []
        give_up: list[tuple[ServeRequest, float]] = []
        for r, w in zip(batch, waits):
            if r.retries < self.cfg.requeue_limit:
                r.retries += 1
                retry.append((r, w))
            else:
                give_up.append((r, w))
        for r, _ in reversed(retry):
            self.metrics.inc("requeued", tenant=r.tenant)
            if r.trace is not None and r.trace.enabled:
                # back in line: a fresh queue span (the drain closes it)
                r.trace.annotate("requeues", r.retries)
                r.trace.begin("queue")
            self.queue.appendleft(r)
        if not give_up:
            return []
        return self._failed_results([r for r, _ in give_up],
                                    [w for _, w in give_up], t_launch)

    def flush(self) -> list[ServedResult]:
        """Finish every in-flight batch (end-of-trace drain)."""
        out: list[ServedResult] = []
        while self._pending:
            out.extend(self._finish_oldest())
        return out

    def _finish_oldest(self) -> list[ServedResult]:
        pending, batch, waits, t_launch = self._pending.pop(0)
        try:
            scores, slots, tiers = self.db.finish(pending)
        except FaultError:
            # the in-flight batch died at finish: fail-and-requeue instead
            # of letting the exception wedge flush()/run_until_idle()
            self.metrics.inc("finish_faults")
            return self._fail_or_requeue(batch, waits, t_launch)
        t_done = self.clock()
        service_ms = (t_done - t_launch) * 1e3
        if (self.cfg.watchdog_ms is not None
                and service_ms > self.cfg.watchdog_ms):
            # deadline watchdog: the batch finished, but so late (wedged
            # device/tier stall) that its results are refused — requeued
            # requests re-run against the (now warm) cache, the rest are
            # shed explicitly. A single stuck launch can no longer hang
            # the serving loop forever.
            self.metrics.inc("watchdog_fired")
            return self._fail_or_requeue(batch, waits, t_launch)
        self.metrics.hist("service_ms").observe(service_ms)
        out, off = [], 0
        for i, r in enumerate(batch):
            n = r.rows
            e2e_ms = (t_done - r.arrival_t) * 1e3
            met = e2e_ms <= self.cfg.slo_ms
            self.metrics.hist("e2e_ms").observe(e2e_ms)
            # per-tenant tail: the head-vs-tail p99 breakdown the SLO-class
            # report reads (labeled series beside the global one)
            self.metrics.hist("e2e_ms", tenant=r.tenant).observe(e2e_ms)
            if not met:
                self.metrics.inc("deadline_miss", tenant=r.tenant)
            if pending.served[i] == "stale":
                self.metrics.inc("stale_serves")
                self.metrics.hist("stale_age_s").observe(
                    pending.stale_age_s[i])
            p = pending.plans[i]
            # calibration audit: the scheduler is the only layer that sees
            # arrival->result, so the e2e aggregate is fed from here
            self.db.calibration.observe_e2e(
                engine=p.engine, n_rows=p.n_rows, k=p.logical.k,
                e2e_ms=e2e_ms)
            if r.trace is not None and r.trace.enabled:
                if not met:
                    r.trace.pin("slo")
                r.trace.annotate("deadline_met", met)
                r.trace.finish(e2e_ms=e2e_ms, service_ms=service_ms)
            out.append(ServedResult(
                request=r, scores=scores[off:off + n],
                slots=slots[off:off + n], tiers=tiers[off:off + n],
                served=pending.served[i],
                stale_age_s=pending.stale_age_s[i],
                degraded=pending.plans[i].degraded,
                queue_wait_ms=waits[i], service_ms=service_ms,
                e2e_ms=e2e_ms, deadline_met=met))
            off += n
        return out

    def run_until_idle(self) -> list[ServedResult]:
        """Drain queue + pipeline to empty (closed-loop helper for tests)."""
        out: list[ServedResult] = []
        while self.busy:
            out.extend(self.step())
            if not self.queue:
                out.extend(self.flush())
        return out
