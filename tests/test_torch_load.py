"""Parity of the port's open-loop load harness with the reference's, on the
CPU.

`make_trace` draws the same numpy values in the same order as the
reference's, so for one config the two traces are the same events: times,
kinds, tenants, term clauses, write targets, and the query vectors byte for
byte. A short `run_scenario` on the wall clock (0.3 s of Poisson traffic
with match() clauses and interleaved writes through `RagDB.update`, over a
CPU `RagDB` with a lexical arena) is held to the harness's accounting
invariants: every offered query is admitted or shed, every admitted one
has exactly one result, served fresh, from the cache or stale within the
bound, none failed, none of another tenant, and no freshness probe sees a
mixed state. Its report has the reference's keys.
"""
import numpy as np
import pytest
import torch

from repro.serving.load import ScenarioResult as JScenarioResult
from repro.serving.load import WorkloadConfig as JWorkloadConfig
from repro.serving.load import _poisson_times as j_poisson_times
from repro.serving.load import _zipf_probs as j_zipf_probs
from repro.serving.load import make_trace as j_make_trace
from repro.serving.metrics import MetricsRegistry as JMetricsRegistry
from repro_torch.api import RagDB
from repro_torch.core.store import StoreConfig
from repro_torch.data.corpus import CorpusConfig, make_corpus
from repro_torch.index.lexical import LexicalConfig
from repro_torch.serving.load import (WorkloadConfig, _poisson_times,
                                      _zipf_probs, make_trace, run_scenario)
from repro_torch.serving.scheduler import SchedulerConfig

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TERM_POOL = [(3, 17), (40, 41, 42), (7, 100, 9, 12), (5, 6)]

TRACES = {
    "steady": dict(duration_s=1.0, rate_rps=300.0),
    "burst_writes": dict(duration_s=2.0, rate_rps=150.0, write_rate_rps=20.0,
                         write_batch=8, burst_x=4.5, burst_start=0.45,
                         burst_len=0.1, n_tenants=20, dim=48, seed=3),
    "match": dict(duration_s=0.5, rate_rps=400.0, match_fraction=0.25,
                  query_pool=64, zipf_s=1.3, k=10, seed=7),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_make_trace_matches_reference(name):
    kw = TRACES[name]
    events = make_trace(WorkloadConfig(**kw), term_pool=TERM_POOL)
    jevents = j_make_trace(JWorkloadConfig(**kw), term_pool=TERM_POOL)
    assert len(events) == len(jevents) > 0
    for e, j in zip(events, jevents):
        assert (e.t, e.kind, e.tenant, e.terms) == (j.t, j.kind, j.tenant,
                                                    j.terms)
        if e.kind == "query":
            assert e.q.dtype == j.q.dtype == np.float32
            assert e.q.tobytes() == j.q.tobytes()
        else:
            np.testing.assert_array_equal(e.doc_idx, j.doc_idx)
    kinds = {e.kind for e in events}
    assert kinds == ({"query", "write"} if kw.get("write_rate_rps")
                     else {"query"})
    if kw.get("match_fraction"):
        assert any(e.terms is not None for e in events)


def test_zipf_and_poisson_match_reference():
    for n, s in ((4, 1.1), (20, 1.1), (64, 0.8)):
        np.testing.assert_array_equal(_zipf_probs(n, s), j_zipf_probs(n, s))
    for rate, dur in ((1000.0, 1.0), (3.0, 0.5), (0.0, 1.0)):
        np.testing.assert_array_equal(
            _poisson_times(rate, dur, np.random.default_rng(5)),
            j_poisson_times(rate, dur, np.random.default_rng(5)))


CC = dict(n_docs=1500, dim=32, n_tenants=4, n_categories=4, vocab_size=512,
          n_entity_terms=64, doc_terms=8)


def _db():
    ccfg = CorpusConfig(**CC)
    db = RagDB(StoreConfig(capacity=2048, dim=ccfg.dim),
               lexical_cfg=LexicalConfig(vocab_size=ccfg.vocab_size,
                                         doc_terms=ccfg.doc_terms),
               device="cpu")
    corpus = make_corpus(ccfg, device="cpu")
    db.ingest(corpus)
    # match() clauses drawn from the corpus's own lanes
    rng = np.random.default_rng(11)
    terms = corpus.terms.numpy()
    pool = []
    for row in rng.permutation(len(terms)):
        live = np.unique(terms[row][terms[row] >= 0])
        if len(live) >= 2:
            pool.append(tuple(int(t) for t in rng.choice(
                live, min(len(live), int(rng.integers(2, 5))),
                replace=False)))
        if len(pool) == 16:
            return db, ccfg, pool
    raise AssertionError("the corpus has too few rows with lanes")


def _leaks(db, results) -> int:
    tenant = db.log.snapshot()["tenant"].numpy()
    n = 0
    for res in results:
        t = res.request.plan.pred.tenant
        real = res.slots[res.slots >= 0]
        if t != -2:
            n += int((tenant[real] != t).sum())
    return n


@pytest.mark.parametrize("admission", [True, False])
def test_run_scenario_accounting(admission):
    db, ccfg, pool = _db()
    wcfg = WorkloadConfig(duration_s=0.3, rate_rps=400.0, write_rate_rps=20.0,
                          write_batch=4, n_tenants=ccfg.n_tenants, k=5,
                          dim=ccfg.dim, match_fraction=0.25, seed=2)
    scfg = SchedulerConfig(slo_ms=50.0, max_queue=8, max_batch=8,
                           admission=admission, degrade_pressure=0.3,
                           stale_within_s=0.2)
    before = db.log.commit_count
    out = run_scenario(db, wcfg, scfg, write_doc_ids=np.arange(ccfg.n_docs),
                       now_ts=ccfg.now_ts, term_pool=pool)
    rep = out.report()
    assert out.offered == out.admitted + out.shed > 0
    assert len(out.results) == out.admitted
    ids = [r.request.req_id for r in out.results]
    assert len(set(ids)) == len(ids), "a request was served twice"
    assert {r.served for r in out.results} <= {"fresh", "cache", "stale"}
    assert rep["failed"] == 0
    assert all(r.stale_age_s <= 0.2 for r in out.results
               if r.served == "stale")
    assert _leaks(db, out.results) == 0
    assert out.writes > 0 and db.log.commit_count == before + out.writes
    assert out.mixed_state_observed == 0
    if not admission:
        assert out.shed == 0
        assert not any(r.degraded for r in out.results)
    # the match() share ran hybrid, or took the hybrid -> dense rung
    assert any(r.request.plan.engine == "hybrid"
               or "hybrid->dense" in r.degraded for r in out.results)
    jrep = JScenarioResult(results=[], metrics=JMetricsRegistry(), wall_s=1.0,
                           offered=0, admitted=0, shed=0, writes=0,
                           mixed_state_observed=0).report()
    assert rep.keys() == jrep.keys()
    assert "plan_ms" in rep["histograms"] and "write_ms" in rep["histograms"]
