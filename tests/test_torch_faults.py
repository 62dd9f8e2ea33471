"""Parity of the port's scheduler under deterministic, seeded faults with
the reference's, on the CPU: the scheduler-driven tests of
``tests/test_faults.py`` (warm error and stall, hot launch retried and
exhausted, the stale-epoch cache read, the breaker, the chaos storm grid).
The crash grid lives in ``tests/test_torch_store.py``.

Both packages run each scenario over the same two-tier corpus (recent docs
hot, old docs warm), each with its own `FakeClock` advanced in step and
its own `FaultPlan` of the same seed and rules: `serving/faults.py` is a
verbatim copy, so a site's schedule is the same pure function of (seed,
site, call index) in both, and the port must reach the sites in the
reference's order. Every test keeps the reference test's assertions on
the port, and holds it to the reference: served classes, degradation
tags, the scheduler's counters, `ExecStats`, and (scores, slots, tiers)
under the North star's contract. Under ANY fault schedule a served
response equals the fault-free execution of the plan that ran (bit for
bit when it ran alone; see `_agrees_with_clean` for a batch), or is
explicitly degraded, or explicitly failed -- never cross-tenant.
"""
import numpy as np
import pytest
import torch

from repro.core import Principal as JPrincipal
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.faults import FaultRule as JFaultRule
from repro.serving.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serving.scheduler import ServeRequest as JServeRequest
from repro_torch.core.tenancy import Principal
from repro_torch.serving.faults import FaultPlan, FaultRule
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           ServeRequest)
from tests.test_torch_scheduler import FakeClock, counters
from tests.test_torch_tiered import _dbs, assert_tiered_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

ALL_BITS = 0xFFFFFFFF


class Pair:
    """The reference's and the port's two-tier RagDB over one corpus, a
    `FakeClock` each (faults stall and backoff sleeps advance it)."""

    def __init__(self, dbs=None):
        self.jdb, self.tdb, self.ccfg = dbs or _dbs(400, 16, 1024, 3,
                                                    n_categories=4)
        assert self.tdb.router.warm.n_docs == self.jdb.router.warm.n_docs > 0
        self.jclock, self.tclock = FakeClock(), FakeClock()

    def attach(self, seed, rules):
        self.jdb.attach_faults(JFaultPlan(
            seed, {s: JFaultRule(**r) for s, r in rules.items()},
            sleep=self.jclock.advance))
        self.tdb.attach_faults(FaultPlan(
            seed, {s: FaultRule(**r) for s, r in rules.items()},
            sleep=self.tclock.advance))
        return self.jdb.faults, self.tdb.faults

    def detach(self):
        for db in (self.jdb, self.tdb):
            db.attach_faults(None)
            db.warm_guard = None

    def advance(self, dt):
        self.jclock.advance(dt)
        self.tclock.advance(dt)

    def scheds(self, **over):
        """Hardened schedulers on the fake clocks; pressure degradation
        disabled so the only degradations are fault-driven."""
        base = dict(slo_ms=1e9, max_queue=64, max_batch=8,
                    degrade_pressure=2.0, stale_pressure=2.0)
        base.update(over)
        return (JScheduler(self.jdb, JSchedulerConfig(**base),
                           clock=self.jclock, metrics=JMetricsRegistry(),
                           sleep=self.jclock.advance),
                Scheduler(self.tdb, SchedulerConfig(**base),
                          clock=self.tclock, metrics=MetricsRegistry(),
                          sleep=self.tclock.advance))

    def admin_reqs(self, q, k=6, req_id=0):
        out = []
        for db, R, clock in ((self.jdb, JServeRequest, self.jclock),
                             (self.tdb, ServeRequest, self.tclock)):
            plan = db.admin_session().search(q, normalize=False).limit(
                k).plan()
            assert plan.route == "hot+warm"
            out.append(R(plan=plan, arrival_t=clock(), req_id=req_id))
        return out

    def serve(self, scheds, reqs):
        """Offer one request a package and drain both schedulers."""
        for s, r in zip(scheds, reqs):
            assert s.offer(r)
        return scheds[0].run_until_idle(), scheds[1].run_until_idle()


def _clean_ref(db, plan):
    """Fault-free execution of exactly the plan that ran (faults + guard
    detached, cache bypassed) -- the bit-identity reference."""
    saved, guard = db.faults, db.warm_guard
    db.attach_faults(None)
    db.warm_guard = None
    try:
        return db.execute([plan], use_cache=False)
    finally:
        db.attach_faults(saved)
        db.warm_guard = guard


def _bit_identical(db, res) -> bool:
    s, sl, tr = _clean_ref(db, res.request.plan)
    return (np.array_equal(res.scores, s) and np.array_equal(res.slots, sl)
            and np.array_equal(res.tiers, tr))


def _agrees_with_clean(db, res) -> bool:
    """A response of a batch against the fault-free execution of its plan
    alone: the same slots and tiers, scores within 1e-5. On the CPU the
    plain scans' matmul rounds differently at another batch shape, so a
    row scored in a batch of four may differ from the lone row in its last
    bit; the kernel's per-pair fp32 chain does not depend on the batch,
    and `chip_smoke.py` holds scheduled rows to direct execution bit for
    bit on the card."""
    s, sl, tr = _clean_ref(db, res.request.plan)
    return (np.array_equal(res.slots, sl) and np.array_equal(res.tiers, tr)
            and np.allclose(res.scores, s, rtol=1e-5, atol=1e-5))


def assert_served_agree(jres, tres):
    assert len(tres) == len(jres)
    for j, t in zip(jres, tres):
        assert t.request.req_id == j.request.req_id
        assert t.served == j.served
        assert t.degraded == j.degraded
        assert t.e2e_ms == j.e2e_ms
        assert_tiered_agree((t.scores, t.slots, t.tiers),
                            (j.scores, j.slots, j.tiers))


def assert_counts_agree(pair, scheds):
    assert counters(scheds[1]) == counters(scheds[0])
    for f in ("device_calls", "warm_queries", "warm_failovers",
              "stale_epoch_rejected", "degraded_plans"):
        assert getattr(pair.tdb.stats, f) == getattr(pair.jdb.stats, f), f


def _q(seed, dim):
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


# -- fault class 1: warm error (transient -> retried -> CORRECT) -----------

def test_warm_error_is_retried_to_a_bit_identical_response():
    pair = Pair()
    pair.attach(0, {"warm.error": dict(at=(0,))})
    scheds = pair.scheds(warm_retries=2)
    (jres,), (res,) = pair.serve(scheds, pair.admin_reqs(_q(3,
                                                            pair.ccfg.dim)))
    assert_served_agree([jres], [res])
    assert_counts_agree(pair, scheds)
    assert res.served == "fresh" and res.degraded == ()
    assert _bit_identical(pair.tdb, res), \
        "retried response must be bit-identical to fault-free"
    assert scheds[1].metrics.counter_total("warm_errors") == 1
    assert scheds[1].metrics.counter_total("warm_retries") == 1
    pair.detach()


# -- fault class 2: warm stall (timeout -> hot-only, EXPLICITLY DEGRADED) --

def test_warm_stall_times_out_to_explicit_hot_only_degradation():
    pair = Pair()
    pair.attach(0, {"warm.stall": dict(rate=1.0, stall_s=0.05)})
    q = _q(4, pair.ccfg.dim)
    scheds = pair.scheds(warm_timeout_ms=10.0, warm_retries=1,
                         breaker_failures=10)
    (jres,), (res,) = pair.serve(scheds, pair.admin_reqs(q))
    assert any("warm-unavailable" in d for d in res.degraded), \
        "a timed-out warm probe must surface as explicit degradation"
    assert scheds[1].metrics.counter_total("warm_timeouts") == 2
    assert scheds[1].metrics.counter_total("warm_failovers") == 1
    assert pair.tdb.stats.warm_failovers == 1
    assert (res.tiers[res.slots >= 0] == 0).all()
    assert_served_agree([jres], [res])
    assert_counts_agree(pair, scheds)
    # the degraded chunk was NOT cached: served fault-free, the same query
    # computes fresh and bit-identical to the clean reference
    pair.detach()
    scheds = pair.scheds()
    (jres2,), (res2,) = pair.serve(scheds, pair.admin_reqs(q, req_id=1))
    assert res2.served == "fresh" and res2.degraded == ()
    assert _bit_identical(pair.tdb, res2)
    assert_served_agree([jres2], [res2])


# -- fault class 3: hot-launch failure (retried; exhausted -> FAILED) ------

def test_hot_launch_fault_is_retried_then_bit_identical():
    pair = Pair()
    pair.attach(0, {"hot.launch": dict(at=(0,))})
    scheds = pair.scheds(launch_retries=2, use_cache=False)
    (jres,), (res,) = pair.serve(scheds, pair.admin_reqs(_q(5,
                                                            pair.ccfg.dim)))
    assert_served_agree([jres], [res])
    assert_counts_agree(pair, scheds)
    assert res.served == "fresh" and res.degraded == ()
    assert scheds[1].metrics.counter_total("launch_retries") == 1
    assert _bit_identical(pair.tdb, res)
    pair.detach()


def test_hot_launch_exhaustion_fails_explicitly_never_wedges():
    pair = Pair()
    pair.attach(0, {"hot.launch": dict(rate=1.0)})
    scheds = pair.scheds(launch_retries=2, use_cache=False)
    (jres,), (res,) = pair.serve(scheds, pair.admin_reqs(_q(6,
                                                            pair.ccfg.dim)))
    assert res.served == "failed"
    assert (res.slots == -1).all(), "failed responses carry sentinel slots"
    assert scheds[1].metrics.counter_total("launch_failures") == 1
    assert scheds[1].metrics.counter_total("failed") == 1
    assert_served_agree([jres], [res])
    assert_counts_agree(pair, scheds)
    pair.detach()


# -- fault class 4: stale cache epoch (poisoned read REJECTED) -------------

def test_stale_epoch_cache_read_is_rejected_and_recomputed():
    pair = Pair()
    q = _q(7, pair.ccfg.dim)
    # 1) fill the cache under the current epoch
    (jres0,), (res0,) = pair.serve(pair.scheds(), pair.admin_reqs(q))
    assert res0.served == "fresh"
    assert_served_agree([jres0], [res0])
    # 2) a write bumps the commit epoch, invalidating the entry's key
    hot_doc = next(iter(pair.tdb.log._slot_of_doc))
    assert hot_doc == next(iter(pair.jdb.log._slot_of_doc))
    for db in (pair.jdb, pair.tdb):
        db.update([hot_doc], np.ones((1, pair.ccfg.dim), np.float32),
                  [pair.ccfg.now_ts])
    # 3) a poisoned cache layer serves the newest entry ignoring epochs --
    #    the epoch guard must refuse it and fall through to fresh compute
    pair.attach(0, {"cache.stale": dict(rate=1.0)})
    scheds = pair.scheds()
    (jres1,), (res1,) = pair.serve(scheds, pair.admin_reqs(q, req_id=1))
    assert_served_agree([jres1], [res1])
    assert_counts_agree(pair, scheds)
    assert pair.tdb.stats.stale_epoch_rejected >= 1
    assert res1.served == "fresh" and res1.degraded == ()
    assert _bit_identical(pair.tdb, res1), \
        "a rejected poisoned read must yield the post-write answer"
    pair.detach()


# -- breaker: trips to hot-only, recovers after faults stop ----------------

def test_breaker_trips_to_hot_only_and_recovers_after_faults_stop():
    pair = Pair()
    jplan_f, plan_f = pair.attach(0, {"warm.error": dict(rate=1.0)})
    scheds = pair.scheds(warm_retries=0, breaker_failures=2,
                         breaker_reset_s=1.0, use_cache=False)
    rng = np.random.default_rng(8)
    jresults, results = [], []

    def serve(q, req_id):
        j, t = pair.serve(scheds, pair.admin_reqs(q, req_id=req_id))
        jresults.extend(j)
        results.extend(t)
        return t

    for i in range(4):
        serve(rng.standard_normal(pair.ccfg.dim).astype(np.float32), i)
    assert len(results) == 4
    assert all(any("warm-unavailable" in d for d in r.degraded)
               for r in results), "breaker-open serving must stay explicit"
    assert scheds[1].guard.state == scheds[0].guard.state == "open"
    assert scheds[1].metrics.counter_total("breaker_skips") >= 1
    # while open, the warm tier is not probed at all
    calls_while_open = plan_f.calls.get("warm.error", 0)
    serve(rng.standard_normal(pair.ccfg.dim).astype(np.float32), 10)
    assert plan_f.calls.get("warm.error", 0) == calls_while_open
    # faults stop; after reset_s the half-open probe succeeds -> closed,
    # and the very next response is clean (recovery within one step)
    jplan_f.clear()
    plan_f.clear()
    pair.advance(2.0)
    (rec,) = serve(rng.standard_normal(pair.ccfg.dim).astype(np.float32), 11)
    assert plan_f.counters() == jplan_f.counters()
    assert_served_agree(jresults, results)
    assert_counts_agree(pair, scheds)
    assert rec.degraded == () and rec.served == "fresh"
    assert scheds[1].guard.state == "closed"
    assert _bit_identical(pair.tdb, rec)
    assert scheds[1].metrics.counter_total("breaker_open") >= 1
    assert scheds[1].metrics.counter_total("breaker_closed") >= 1
    pair.detach()


# -- the storm: every query-path site at once, across a seed grid ----------

STORM_SEEDS = list(range(6))


@pytest.fixture(scope="module")
def storm_pair():
    return _dbs(400, 16, 1024, 3, n_categories=4)


def _storm_reqs(pair, seed):
    rng = np.random.default_rng(100 + seed)
    qs = rng.standard_normal((4, pair.ccfg.dim)).astype(np.float32)
    out = ([], [])
    for i in range(16):
        q = qs[i % 4]
        for side, (db, P, R, clock) in enumerate((
                (pair.jdb, JPrincipal, JServeRequest, pair.jclock),
                (pair.tdb, Principal, ServeRequest, pair.tclock))):
            if i % 5 == 4:
                plan = (db.session(P(tenant_id=i % 3, group_bits=ALL_BITS))
                        .search(q, normalize=False).limit(6).plan())
            else:
                plan = (db.admin_session().search(q, normalize=False)
                        .limit(6).plan())
            out[side].append(R(plan=plan, arrival_t=clock(), req_id=i,
                               tenant=i % 3))
    return out


@pytest.mark.parametrize("seed", STORM_SEEDS)
def test_chaos_storm_every_response_classified(storm_pair, seed):
    pair = Pair(storm_pair)
    jplan_f, plan_f = pair.attach(seed, {
        "warm.error": dict(rate=0.3),
        "warm.stall": dict(rate=0.2, stall_s=0.05),
        "hot.launch": dict(rate=0.15),
        "hot.wedge": dict(rate=0.1, stall_s=0.5),
        "hot.finish_error": dict(rate=0.1),
        "cache.stale": dict(rate=0.5),
    })
    try:
        scheds = pair.scheds(warm_timeout_ms=100.0, warm_retries=1,
                             breaker_failures=3, breaker_reset_s=0.2,
                             launch_retries=2, watchdog_ms=200.0,
                             requeue_limit=1, max_batch=4, seed=seed)
        jreqs, treqs = _storm_reqs(pair, seed)
        assert all(scheds[0].offer(r) for r in jreqs)
        assert all(scheds[1].offer(r) for r in treqs)
        jresults = scheds[0].run_until_idle()
        results = scheds[1].run_until_idle()
        assert len(results) == 16, "every request must resolve exactly once"
        assert plan_f.total_fired() > 0, "the storm must actually fire"
        hot_tenant = pair.tdb.log.snapshot()["tenant"].numpy()
        warm_tenant = pair.tdb.router.warm.meta["tenant"].numpy()
        n_correct = n_degraded = n_failed = 0
        for res in results:
            # isolation holds for EVERY class (vacuous for sentinel slots)
            t = res.request.plan.pred.tenant
            if t != -2:
                m = res.slots >= 0
                owner = np.where(res.tiers == 0,
                                 hot_tenant[res.slots], warm_tenant[res.slots])
                assert (owner[m] == t).all(), "cross-tenant row under faults"
            if res.served == "failed":
                n_failed += 1
                assert (res.slots == -1).all()
            elif res.degraded:
                n_degraded += 1
                assert any("warm-unavailable" in d for d in res.degraded)
            else:
                n_correct += 1
                assert _agrees_with_clean(pair.tdb, res), \
                    "undegraded response differs from fault-free under faults"
        assert n_correct + n_degraded + n_failed == 16
        # the same schedule fired at the same sites, with the same outcome
        assert plan_f.counters() == jplan_f.counters()
        assert_served_agree(jresults, results)
        assert counters(scheds[1]) == counters(scheds[0])
    finally:
        pair.detach()
