"""Open-loop load harness: Poisson arrivals, Zipfian mix, interleaved writes
(port of ``repro.serving.load``).

Closed-loop benchmarks (PRs 1-5) issue the next query when the previous one
finishes — under overload they silently slow the *offered* load down and
report a flattering latency. This harness is open-loop: a trace of events is
generated ahead of time with Poisson inter-arrival gaps on a wall clock, and
`run_scenario` admits each event when its arrival time comes due regardless
of how far behind the server is. Queueing delay is therefore *measured*
(arrival -> service start), not hidden.

The mix is Zipfian twice over — tenant popularity and per-tenant query
popularity — because skew is what makes result caching and per-tenant
fairness interesting. Write events (`TransactionLog` re-embeds through
`RagDB.update`) interleave on the same clock, so the staleness the scheduler
trades for tail latency is real: a stale serve is a pre-write snapshot, and
its age is measured against the declared bound. Each write is followed by a
mixed-state probe (embedding and timestamp must belong to the same version),
carrying bench_freshness.py's audit into the serving path.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.plan import ALL_BITS
from repro_torch.api.ragdb import RagDB
from repro_torch.core.tenancy import Principal
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           ServedResult, ServeRequest)


@dataclasses.dataclass
class WorkloadConfig:
    """One scenario's trace shape. ``rate_rps`` is the *offered* load —
    under overload it exceeds what the server can absorb, by design."""
    duration_s: float = 2.0
    rate_rps: float = 200.0         # Poisson query arrival rate
    write_rate_rps: float = 0.0     # Poisson write (re-embed) arrival rate
    write_batch: int = 8            # docs re-embedded per write event
    n_tenants: int = 4
    zipf_s: float = 1.1             # popularity exponent (tenants AND queries)
    query_pool: int = 32            # distinct query vectors per tenant
    # flash crowd: EXTRA query arrivals at (burst_x - 1) * rate_rps inside
    # the window [burst_start, burst_start + burst_len] * duration_s —
    # stationary Poisson is absorbed by continuous batching; the flash
    # crowd is what blows an unbounded queue's tail while leaving its
    # median untouched
    burst_x: float = 1.0            # 1.0 = no burst
    burst_start: float = 0.4        # window start, fraction of duration
    burst_len: float = 0.2          # window length, fraction of duration
    k: int = 8
    dim: int = 32
    engine: str | None = None       # pin an engine; None = planner's choice
    match_fraction: float = 0.0     # fraction of queries with a match() clause
    seed: int = 0


@dataclasses.dataclass
class Event:
    """One trace entry, due at ``t`` seconds after scenario start."""
    t: float
    kind: str                       # "query" | "write"
    tenant: int = 0
    q: np.ndarray | None = None
    terms: tuple | None = None      # lexical clause -> hybrid engine
    doc_idx: np.ndarray | None = None   # write: indices into the doc-id pool


def _zipf_probs(n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


def _poisson_times(rate: float, duration: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Arrival times of a Poisson process at ``rate``/s over ``duration``s.

    >>> t = _poisson_times(1000.0, 1.0, np.random.default_rng(0))
    >>> bool(700 < len(t) < 1300), bool((np.diff(t) >= 0).all())
    (True, True)
    """
    if rate <= 0 or duration <= 0:
        return np.empty(0)
    n = rng.poisson(rate * duration)
    return np.sort(rng.uniform(0.0, duration, n))


def make_trace(cfg: WorkloadConfig, *,
               term_pool: list[tuple] | None = None) -> list[Event]:
    """Generate the event trace: Poisson query arrivals with a Zipfian
    tenant/query mix, plus (``write_rate_rps > 0``) interleaved write
    events, merged in time order. Deterministic in ``cfg.seed``."""
    rng = np.random.default_rng(cfg.seed)
    tenant_p = _zipf_probs(cfg.n_tenants, cfg.zipf_s)
    pool_p = _zipf_probs(cfg.query_pool, cfg.zipf_s)
    # per-tenant query pools, unit-normalized once so every repeat of a
    # popular query is byte-identical (result-cache realism)
    pools = rng.standard_normal(
        (cfg.n_tenants, cfg.query_pool, cfg.dim)).astype(np.float32)
    pools /= np.maximum(np.linalg.norm(pools, axis=-1, keepdims=True), 1e-12)

    times = _poisson_times(cfg.rate_rps, cfg.duration_s, rng)
    if cfg.burst_x > 1.0:
        # flash crowd: extra arrivals inside the burst window, on top of
        # the base process (superposition of Poissons is Poisson)
        w0 = cfg.burst_start * cfg.duration_s
        wlen = cfg.burst_len * cfg.duration_s
        extra = w0 + _poisson_times((cfg.burst_x - 1.0) * cfg.rate_rps,
                                    wlen, rng)
        times = np.sort(np.concatenate([times, extra]))

    events: list[Event] = []
    for t in times:
        tenant = int(rng.choice(cfg.n_tenants, p=tenant_p))
        qi = int(rng.choice(cfg.query_pool, p=pool_p))
        terms = None
        if term_pool and rng.uniform() < cfg.match_fraction:
            terms = term_pool[int(rng.choice(len(term_pool), p=_zipf_probs(
                len(term_pool), cfg.zipf_s)))]
        events.append(Event(t=float(t), kind="query", tenant=tenant,
                            q=pools[tenant, qi], terms=terms))
    for t in _poisson_times(cfg.write_rate_rps, cfg.duration_s, rng):
        events.append(Event(t=float(t), kind="write",
                            doc_idx=rng.integers(0, 1 << 30, cfg.write_batch)))
    events.sort(key=lambda e: (e.t, e.kind))   # write after query at a tie
    return events


@dataclasses.dataclass
class ScenarioResult:
    """Everything one open-loop run produced (report() renders the summary
    that bench_serving.py dumps per scenario)."""
    results: list[ServedResult]
    metrics: MetricsRegistry
    wall_s: float
    offered: int                   # query events in the trace
    admitted: int
    shed: int
    writes: int
    mixed_state_observed: int      # freshness probes that saw mixed state

    def report(self) -> dict:
        snap = self.metrics.snapshot()
        ok = [r for r in self.results if r.deadline_met]
        stale_ages = [r.stale_age_s for r in self.results
                      if r.stale_age_s is not None]
        return {
            "offered_rps": self.offered / max(self.wall_s, 1e-9),
            "completed": len(self.results),
            "throughput_rps": len(self.results) / max(self.wall_s, 1e-9),
            "goodput_rps": len(ok) / max(self.wall_s, 1e-9),
            "shed": self.shed,
            "shed_rate": self.shed / max(self.offered, 1),
            "deadline_met_rate": len(ok) / max(len(self.results), 1),
            "degraded": sum(1 for r in self.results if r.degraded),
            "failed": sum(1 for r in self.results if r.served == "failed"),
            "stale_serves": len(stale_ages),
            "max_stale_age_s": max(stale_ages, default=0.0),
            "writes": self.writes,
            "mixed_state_observed": self.mixed_state_observed,
            "wall_s": self.wall_s,
            "histograms": snap["histograms"],
            "counters": snap["counters"],
        }


def lower_query(db: RagDB, ev: Event, cfg: WorkloadConfig,
                session_cache: dict):
    """Lower one query event through the session front door — tenant/ACL
    clauses come from the principal; the harness cannot widen them."""
    sess = session_cache.get(ev.tenant)
    if sess is None:
        sess = session_cache[ev.tenant] = db.session(
            Principal(tenant_id=ev.tenant, group_bits=ALL_BITS))
    b = sess.search(ev.q, normalize=False).limit(cfg.k)
    if ev.terms is not None:
        b = b.match(list(ev.terms))
    elif cfg.engine is not None:
        b = b.using(cfg.engine)
    return b.plan()


def run_scenario(db: RagDB, cfg: WorkloadConfig, sched_cfg: SchedulerConfig,
                 *, events: list[Event] | None = None,
                 write_doc_ids: np.ndarray | None = None,
                 now_ts: int = 0,
                 term_pool: list[tuple] | None = None) -> ScenarioResult:
    """Run one open-loop scenario against a live RagDB on the wall clock.

    Events are admitted when due (never gated on the server catching up);
    the scheduler sheds/degrades per ``sched_cfg``. Write events re-embed
    ``cfg.write_batch`` docs from ``write_doc_ids`` through `RagDB.update`
    and immediately run a mixed-state probe. Single-threaded: the
    launch/finish pipeline provides the overlap, and arrival timestamps
    come from the shared monotonic clock, so queue wait is exact."""
    if events is None:
        events = make_trace(cfg, term_pool=term_pool)
    metrics = MetricsRegistry()
    sched = Scheduler(db, sched_cfg, metrics=metrics)
    clock = sched.clock
    sessions: dict = {}
    rng = np.random.default_rng(cfg.seed + 1)
    results: list[ServedResult] = []
    offered = admitted = writes = mixed = 0
    write_seq = 0

    start = clock()
    i = 0
    while i < len(events) or sched.busy:
        now = clock() - start
        while i < len(events) and events[i].t <= now:
            ev = events[i]
            i += 1
            if ev.kind == "write":
                if write_doc_ids is None or len(write_doc_ids) == 0:
                    continue
                writes += 1
                write_seq += 1
                ids = write_doc_ids[np.asarray(ev.doc_idx)
                                    % len(write_doc_ids)]
                # dedupe to one row per doc id (scatter order for duplicate
                # indices is unspecified, which would make the mixed-state
                # probe ambiguous about WHICH embedding should have won)
                ids = np.unique(ids)
                emb = rng.standard_normal(
                    (len(ids), cfg.dim)).astype(np.float32)
                ts = np.full(len(ids), now_ts + write_seq)
                w0 = time.perf_counter()
                db.update(ids, torch.from_numpy(emb).to(db.device), ts)
                metrics.hist("write_ms").observe(
                    (time.perf_counter() - w0) * 1e3)
                # freshness probe (bench_freshness fold): the committed
                # embedding and timestamp, read back to the host from one
                # snapshot, must belong to the SAME version
                snap = db.log.snapshot()
                if db.log.has_doc(int(ids[0])):
                    slot = db.log.slot_of(int(ids[0]))
                    got_ts = int(snap["updated_at"][slot].cpu())
                    got = snap["emb"][slot].cpu().numpy()
                    want = emb[0] / max(np.linalg.norm(emb[0]), 1e-12)
                    if (got_ts == now_ts + write_seq
                            and not np.allclose(got, want, atol=1e-5)):
                        mixed += 1
            else:
                offered += 1
                p0 = time.perf_counter()
                plan = lower_query(db, ev, cfg, sessions)
                metrics.hist("plan_ms").observe(
                    (time.perf_counter() - p0) * 1e3)
                admitted += sched.offer(ServeRequest(
                    plan=plan, arrival_t=clock(), req_id=offered,
                    tenant=ev.tenant))
        if sched.busy:
            results.extend(sched.step())
        elif i < len(events):
            # idle: wait out the gap to the next due event (bounded so a
            # long gap still polls the clock)
            time.sleep(min(max(events[i].t - now, 0.0), 0.002))
    results.extend(sched.flush())
    # a wedged batch may have been requeued by the watchdog during the final
    # flush — drain until genuinely idle (bounded: requeues are limited)
    while sched.busy:
        results.extend(sched.step())
        if not sched.queue:
            results.extend(sched.flush())
    wall = clock() - start
    return ScenarioResult(results=results, metrics=metrics, wall_s=wall,
                          offered=offered, admitted=admitted,
                          shed=sched.shed_count, writes=writes,
                          mixed_state_observed=mixed)
