"""Parity of the port's admission-controlled scheduler with the reference's
on the CPU: the 11 tests of ``tests/test_scheduler.py``, each run through
both packages on the same numpy inputs.

Each package gets its own `FakeClock`, advanced in step, and its own
`RagDB` over the same 512 x 16 arena; the port's db carries the
reference's IVF index (k-means seeds cannot be reproduced across
frameworks, so parity runs on one index). Every test keeps the reference
test's own assertions on the port, and then holds the port to the
reference: admission and shed counts, the degradation rungs each response
took (engine names mapped: the reference's TPU kernel "pallas" is the
port's "cuda"), served classes, stale ages, queue waits, the metrics
counters, `ExecStats`, and the results under the North star's contract
(scores within 1e-5, slots equal but for ties at the k-th place).
Neither package loads a cost model, so degradation walks rungs by queue
pressure alone in both.
"""
import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.core import Principal as JPrincipal
from repro.core import StoreConfig as JStoreConfig
from repro.core.store import DocBatch as JDocBatch
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.faults import FaultRule as JFaultRule
from repro.serving.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serving.scheduler import ServeRequest as JServeRequest
from repro_torch.api import RagDB
from repro_torch.core.store import DocBatch, StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.serving.faults import FaultPlan, FaultRule
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           ServeRequest)
from tests.test_torch_arena_scan import assert_topk_agree
from tests.test_torch_ivf import _port_index

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

ALL_BITS = 0xFFFFFFFF
N_DOCS, DIM, N_TENANTS = 512, 16, 4


class FakeClock:
    """Injectable monotonic clock; tests advance it explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def engine_name(tag: str) -> str:
    """A reference engine name or rung tag in the port's names."""
    return tag.replace("pallas", "cuda")


class Twin:
    """The reference and the port side by side over one numpy arena: a
    `RagDB` and a `FakeClock` each, driven in step."""

    def __init__(self, with_index: bool = True):
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
        tenant = rng.integers(0, N_TENANTS, N_DOCS).astype(np.int32)
        category = rng.integers(0, 8, N_DOCS).astype(np.int32)
        cols = dict(emb=emb, tenant=tenant, category=category,
                    updated_at=np.zeros(N_DOCS, np.int32),
                    doc_id=np.arange(N_DOCS, dtype=np.int32))
        self.jdb = JRagDB(JStoreConfig(capacity=N_DOCS, dim=DIM,
                                       metric="dot"))
        self.jdb.ingest(JDocBatch(acl=np.full(N_DOCS, ALL_BITS, np.uint32),
                                  **cols))
        self.tdb = RagDB(StoreConfig(capacity=N_DOCS, dim=DIM, metric="dot"),
                         device="cpu")
        self.tdb.ingest(DocBatch(acl=np.full(N_DOCS, -1, np.int32), **cols))
        if with_index:
            self.jdb.build_index()
            self.tdb.index = _port_index(self.jdb.index)
            self.tdb.log.ivf = self.tdb.index
        self.jclock, self.tclock = FakeClock(), FakeClock()

    def advance(self, dt: float) -> None:
        self.jclock.advance(dt)
        self.tclock.advance(dt)

    def plans(self, tenant: int, q: np.ndarray, k: int = 4,
              engine: str | None = "ivf"):
        out = []
        for db, P in ((self.jdb, JPrincipal), (self.tdb, Principal)):
            b = (db.session(P(tenant_id=tenant, group_bits=ALL_BITS))
                 .search(q, normalize=False).limit(k))
            if engine is not None:
                b = b.using(engine)
            out.append(b.plan())
        return tuple(out)

    def requests(self, n, *, k=4, engine="ivf", seed=1):
        rng = np.random.default_rng(seed)
        jreqs, treqs = [], []
        for i in range(n):
            q = rng.standard_normal(DIM,).astype(np.float32)
            jp, tp = self.plans(i % N_TENANTS, q, k=k, engine=engine)
            jreqs.append(JServeRequest(plan=jp, arrival_t=self.jclock(),
                                       req_id=i, tenant=i % N_TENANTS))
            treqs.append(ServeRequest(plan=tp, arrival_t=self.tclock(),
                                      req_id=i, tenant=i % N_TENANTS))
        return jreqs, treqs

    def schedulers(self, faults: bool = False, **cfg):
        """One scheduler a package, each on its clock and metrics; with
        ``faults`` backoff advances the clock instead of sleeping."""
        kw = lambda c: dict(sleep=c.advance) if faults else {}
        return (JScheduler(self.jdb, JSchedulerConfig(**cfg),
                           clock=self.jclock, metrics=JMetricsRegistry(),
                           **kw(self.jclock)),
                Scheduler(self.tdb, SchedulerConfig(**cfg), clock=self.tclock,
                          metrics=MetricsRegistry(), **kw(self.tclock)))


def assert_results_agree(jres, tres):
    """Two lists of `ServedResult`, in serving order: the same requests,
    served the same way, under the same rungs and times; scores and slots
    under the North star's contract."""
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert t.request.req_id == j.request.req_id
        assert t.served == j.served
        assert t.degraded == tuple(engine_name(d) for d in j.degraded)
        assert t.request.plan.engine == engine_name(j.request.plan.engine)
        assert t.request.plan.nprobe == j.request.plan.nprobe
        assert t.stale_age_s == j.stale_age_s
        assert t.deadline_met == j.deadline_met
        assert t.queue_wait_ms == j.queue_wait_ms
        assert t.e2e_ms == j.e2e_ms
        assert_topk_agree(t.scores, t.slots, np.asarray(j.scores),
                          np.asarray(j.slots))


def counters(sched) -> dict:
    return {engine_name(key): v
            for key, v in sched.metrics.snapshot()["counters"].items()}


def assert_scheds_agree(jsched, tsched):
    assert counters(tsched) == counters(jsched)
    assert tsched.shed_count == jsched.shed_count
    assert len(tsched.queue) == len(jsched.queue)
    for f in ("degraded_plans", "stale_serves", "queries", "device_calls"):
        assert getattr(tsched.db.stats, f) == getattr(jsched.db.stats, f), f


def offer_all(scheds, reqs):
    (js, ts), (jr, tr) = scheds, reqs
    jok = [js.offer(r) for r in jr]
    tok = [ts.offer(r) for r in tr]
    assert tok == jok
    return tok


def assert_same_as_direct(db, results):
    """Each result equals, bit for bit, a direct `db.execute` of the plan
    that actually ran."""
    for res in results:
        s, sl, _ = db.execute([res.request.plan], use_cache=False)
        np.testing.assert_array_equal(res.slots, sl)
        np.testing.assert_array_equal(res.scores, s)


# -- 1. admission ----------------------------------------------------------

def test_admission_sheds_before_unbounded_queue_growth():
    tw = Twin()
    scheds = tw.schedulers(max_queue=8, max_batch=4)
    admitted = sum(offer_all(scheds, tw.requests(30)))
    sched = scheds[1]
    assert admitted == 8, "admission must stop exactly at max_queue"
    assert len(sched.queue) == 8
    assert sched.shed_count == 22
    assert sched.metrics.counter_total("shed") == 22
    assert_scheds_agree(*scheds)


def test_baseline_fifo_never_sheds():
    tw = Twin()
    scheds = tw.schedulers(max_queue=8, admission=False)
    assert all(offer_all(scheds, tw.requests(30)))
    sched = scheds[1]
    assert len(sched.queue) == 30 and sched.shed_count == 0
    assert_scheds_agree(*scheds)


# -- 2. degraded responses are bit-identical to the degraded plan ----------

def test_each_degradation_rung_bit_identical_to_direct_execution():
    tw = Twin()
    # tiny queue + zero thresholds: every batch is "pressured" and walks
    # rungs; no cache so every response is a real computation
    jsched, tsched = scheds = tw.schedulers(
        slo_ms=50.0, max_queue=4, max_batch=2, degrade_pressure=0.0,
        use_cache=False)
    offer_all(scheds, tw.requests(4))
    jres, tres = jsched.run_until_idle(), tsched.run_until_idle()
    assert len(tres) == 4
    assert any(res.degraded for res in tres), \
        "pressure thresholds at zero must engage the ladder"
    for res in tres:
        assert res.request.plan.degraded == res.degraded
    assert_results_agree(jres, tres)
    assert_scheds_agree(jsched, tsched)
    assert_same_as_direct(tw.tdb, tres)


def test_every_ladder_rung_bit_identical_standalone():
    """Walk the full ladder by hand: each rung, served through the
    scheduler as the ONLY admitted plan, equals direct execution; the
    port's ladder is the reference's, rung for rung."""
    tw = Twin()
    q = np.random.default_rng(3).standard_normal(DIM).astype(np.float32)
    ladders = []
    for db, plan in zip((tw.jdb, tw.tdb), tw.plans(1, q)):
        rungs = [plan]
        while (nxt := db.degrade(rungs[-1])) is not None:
            rungs.append(nxt)
        ladders.append(rungs)
    jrungs, trungs = ladders
    assert len(trungs) >= 2, "ivf plan must expose at least one rung"
    assert [r.degraded for r in trungs] == [
        tuple(engine_name(d) for d in r.degraded) for r in jrungs]
    assert [r.nprobe for r in trungs] == [r.nprobe for r in jrungs]
    for jrung, trung in zip(jrungs, trungs):
        jsched, tsched = tw.schedulers(use_cache=False)
        jsched.offer(JServeRequest(plan=jrung, arrival_t=tw.jclock()))
        tsched.offer(ServeRequest(plan=trung, arrival_t=tw.tclock()))
        (jres,), (res,) = jsched.run_until_idle(), tsched.run_until_idle()
        assert_same_as_direct(tw.tdb, [res])
        assert res.degraded == trung.degraded
        assert_results_agree([jres], [res])


# -- 3. degradations are audited -------------------------------------------

def test_degradations_surface_in_explain_stats_and_metrics():
    tw = Twin()
    before = tw.tdb.stats.degraded_plans
    jsched, tsched = scheds = tw.schedulers(
        max_queue=4, max_batch=2, degrade_pressure=0.0, use_cache=False)
    offer_all(scheds, tw.requests(4))
    jres, results = jsched.run_until_idle(), tsched.run_until_idle()
    degraded = [r for r in results if r.degraded]
    assert degraded, "zero thresholds must degrade"
    for res in degraded:
        text = res.request.plan.explain()
        assert "degraded:" in text
        for rung in res.degraded:
            assert rung in text, f"rung {rung!r} missing from explain()"
    assert tw.tdb.stats.degraded_plans - before == len(degraded)
    assert tsched.metrics.counter_total("degradations") >= len(degraded)
    assert "degraded plans" in tw.tdb.explain()
    assert_results_agree(jres, results)
    assert_scheds_agree(jsched, tsched)


# -- 4. staleness-bounded cache serves --------------------------------------

def _one_round(tw, scheds, q, *, tenant=0):
    jsched, tsched = scheds
    jp, tp = tw.plans(tenant, q)
    jsched.offer(JServeRequest(plan=jp, arrival_t=tw.jclock()))
    tsched.offer(ServeRequest(plan=tp, arrival_t=tw.tclock()))
    (jres,), (res,) = jsched.run_until_idle(), tsched.run_until_idle()
    assert_results_agree([jres], [res])
    return res


def _write(tw, rng):
    ids = np.arange(8, dtype=np.int64)
    emb = rng.standard_normal((8, DIM), dtype=np.float32)
    for db in (tw.jdb, tw.tdb):
        db.update(ids, emb, np.full(8, 1, np.int64))


def test_stale_serve_within_bound_and_fresh_beyond_it():
    tw = Twin()
    rng = np.random.default_rng(5)
    q = rng.standard_normal(DIM).astype(np.float32)
    bound = 10.0
    # stale_pressure=0 -> stale serves allowed whenever the queue is
    # non-empty; large slo so nothing sheds on deadline
    scheds = tw.schedulers(slo_ms=1e6, max_queue=4, degrade_pressure=0.0,
                           stale_pressure=0.0, stale_within_s=bound)
    first = _one_round(tw, scheds, q)
    assert first.served == "fresh"

    # a write invalidates the exact cache key (commit count moved) ...
    _write(tw, rng)
    tw.advance(bound / 2)
    # ... but within the bound the old snapshot may be served
    second = _one_round(tw, scheds, q)
    assert second.served == "stale"
    assert second.stale_age_s is not None and second.stale_age_s <= bound
    np.testing.assert_array_equal(second.slots, first.slots)
    assert scheds[1].metrics.counter_total("stale_serves") == 1
    assert tw.tdb.stats.stale_serves == 1

    # beyond the bound the entry is too old: recompute fresh
    tw.advance(bound)
    third = _one_round(tw, scheds, q)
    assert third.served == "fresh"
    assert_scheds_agree(*scheds)


def test_no_stale_serve_when_bound_not_declared():
    tw = Twin()
    rng = np.random.default_rng(6)
    q = rng.standard_normal(DIM).astype(np.float32)
    scheds = tw.schedulers(slo_ms=1e6, max_queue=4, degrade_pressure=0.0,
                           stale_pressure=0.0, stale_within_s=None)
    assert _one_round(tw, scheds, q).served == "fresh"
    _write(tw, rng)
    assert _one_round(tw, scheds, q).served == "fresh"
    assert_scheds_agree(*scheds)


# -- pipelining ------------------------------------------------------------

def test_step_pipelines_one_batch_deep():
    """step() launches batch N+1 before finishing batch N: the first step
    returns nothing (its batch is in flight), the second returns the
    first's results."""
    tw = Twin()
    jsched, sched = scheds = tw.schedulers(max_batch=2, use_cache=False)
    offer_all(scheds, tw.requests(4))
    first = sched.step()
    assert first == [] and len(sched._pending) == 1
    second = sched.step()
    assert len(second) == 2 and len(sched._pending) == 1
    third = sched.flush()
    assert len(third) == 2
    assert not sched.busy
    jsteps = [jsched.step(), jsched.step(), jsched.flush()]
    for j, t in zip(jsteps, (first, second, third)):
        assert_results_agree(j, t)
    assert_scheds_agree(*scheds)


# -- watchdog: wedged batches are refused, requeued, and re-served ---------

WATCHDOG = dict(slo_ms=1e9, max_queue=16, max_batch=4, degrade_pressure=2.0,
                stale_pressure=2.0, use_cache=False, watchdog_ms=100.0,
                requeue_limit=1)


def _attach(tw, rules):
    """The same fault rules on both dbs, each stalling its own clock."""
    tw.jdb.attach_faults(JFaultPlan(0, {s: JFaultRule(**r)
                                        for s, r in rules.items()},
                                    sleep=tw.jclock.advance))
    tw.tdb.attach_faults(FaultPlan(0, {s: FaultRule(**r)
                                       for s, r in rules.items()},
                                   sleep=tw.tclock.advance))


def _detach(tw):
    tw.jdb.attach_faults(None)
    tw.tdb.attach_faults(None)


def test_watchdog_refuses_wedged_batch_and_requeues_to_clean_result():
    """A batch that stalls 10s past a 100ms watchdog is refused; its
    requests requeue and the retry (fault exhausted) serves clean."""
    tw = Twin()
    _attach(tw, {"hot.wedge": dict(at=(0,), stall_s=10.0)})
    jsched, sched = scheds = tw.schedulers(faults=True, **WATCHDOG)
    assert all(offer_all(scheds, tw.requests(4)))
    jres, results = jsched.run_until_idle(), sched.run_until_idle()
    assert len(results) == 4, "refused batch must still resolve every request"
    assert sched.metrics.counter_total("watchdog_fired") == 1
    assert sched.metrics.counter_total("requeued") == 4
    assert all(r.served != "failed" for r in results)
    assert_results_agree(jres, results)
    assert_scheds_agree(*scheds)
    # the re-served answers equal direct execution of the same plans
    _detach(tw)
    assert_same_as_direct(tw.tdb, results)


def test_finish_fault_is_requeued_then_served():
    tw = Twin()
    _attach(tw, {"hot.finish_error": dict(at=(0,))})
    jsched, sched = scheds = tw.schedulers(faults=True, **WATCHDOG)
    assert all(offer_all(scheds, tw.requests(2, seed=2)))
    jres, results = jsched.run_until_idle(), sched.run_until_idle()
    assert len(results) == 2
    assert sched.metrics.counter_total("finish_faults") == 1
    assert all(r.served != "failed" for r in results)
    assert_results_agree(jres, results)
    assert_scheds_agree(*scheds)
    _detach(tw)


def test_watchdog_exhaustion_fails_explicitly():
    """A batch that wedges on EVERY attempt exhausts requeue_limit and is
    failed with sentinel results -- never silently wrong, never stuck."""
    tw = Twin()
    _attach(tw, {"hot.wedge": dict(rate=1.0, stall_s=10.0)})
    jsched, sched = scheds = tw.schedulers(faults=True, **WATCHDOG)
    assert all(offer_all(scheds, tw.requests(2, seed=3)))
    jres, results = jsched.run_until_idle(), sched.run_until_idle()
    assert len(results) == 2
    assert all(r.served == "failed" for r in results)
    assert all((r.slots == -1).all() for r in results)
    assert not any(r.deadline_met for r in results)
    assert sched.metrics.counter_total("watchdog_fired") == 2
    assert sched.metrics.counter_total("failed") == 2
    assert_results_agree(jres, results)
    assert_scheds_agree(*scheds)
    _detach(tw)
