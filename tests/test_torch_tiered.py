"""Parity of the port's tiered deployment with the reference's.

`TieredRouter` and the tiered `RagDB` (hot unified arena, warm split-stack
tier probed with the predicate pushed down, cold archive) run beside the
JAX reference on one corpus at a small size: routes and their reasons,
the merged (scores, slots, tiers), `ExecStats`, `explain()`, writes that
reach warm docs (a fresh timestamp promotes a warm doc to hot, its lanes
with it), warm-write cache invalidation, the hybrid warm pushdown (wsum
and rrf, the rrf lists merged per signal across the tiers), a guarded
warm probe that retries to a bit-identical answer or fails over to an
explicitly degraded hot-only one, and the serving engine's tier
provenance. The reference's tiered tests mirrored here:
``test_api.py:210, 253, 274, 320, 326``, ``test_adaptive.py:169, 324``,
``test_grouped_topk.py:182``, ``test_hybrid.py:366``,
``test_faults.py:143, 163`` and ``test_serving.py:68``. One whole-slice
test runs a mixed batch (hot, tail dense, tail wsum, tail rrf, admin ivf)
through both `RagDB`s with lanes and the reference's IVF index injected.

Contract (ROADMAP North star): integers, plan keys and counters exact; f32
scores within rtol = atol = 1e-5; (slot, tier) pairs equal except inside a
run of tied scores at the k-th place.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.api import executor as j_executor
from repro.core import Predicate as JPredicate
from repro.core.router import TieredRouter as JTieredRouter
from repro.core.store import StoreConfig as JStoreConfig
from repro.core.tenancy import Principal as JPrincipal
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.data.corpus import make_keyword_queries as j_keyword_queries
from repro.index.lexical import LexicalConfig as JLexicalConfig
from repro.serving.metrics import MetricsRegistry
from repro_torch.api import PlannerConfig, RagDB
from repro_torch.api import executor as executor_mod
from repro_torch.core import TieredResult, TieredRouter
from repro_torch.core.query import Predicate
from repro_torch.core.store import StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.data.corpus import DAY_S, CorpusConfig, make_corpus
from repro_torch.index.lexical import LexicalConfig
from repro_torch.kernels.hybrid_score import ops as hyb_ops
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import RAGEngine, Request
from repro_torch.serving.faults import (FaultPlan, FaultRule,
                                        ResilienceConfig, WarmGuard)
from tests.test_torch_arena_scan import assert_topk_agree
from tests.test_torch_ivf import _port_index

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

ALL = 0xFFFFFFFF
WINDOW = 90 * DAY_S
STATS = ("device_calls", "queries", "hot_queries", "warm_queries",
         "rows_scanned", "terms_scanned", "warm_failovers", "fused_groups",
         "fused_scans", "padded_groups", "padded_rows")


def _dbs(n_docs, dim, cap, n_tenants, *, lexical=False, n_categories=8,
         **kw):
    """A tiered port RagDB and a tiered reference RagDB over one corpus
    (hot window 90 days, both tiers at ``cap`` rows)."""
    cc = dict(n_docs=n_docs, dim=dim, n_tenants=n_tenants,
              n_categories=n_categories, **kw)
    ccfg = CorpusConfig(**cc)
    jkw = tkw = {}
    if lexical:
        jkw = dict(lexical_cfg=JLexicalConfig(vocab_size=ccfg.vocab_size,
                                              doc_terms=ccfg.doc_terms))
        tkw = dict(lexical_cfg=LexicalConfig(vocab_size=ccfg.vocab_size,
                                             doc_terms=ccfg.doc_terms))
    jcfg = JStoreConfig(capacity=cap, dim=dim)
    jdb = JRagDB(jcfg, warm_cfg=jcfg, hot_window_s=WINDOW,
                 now_ts=ccfg.now_ts, **jkw)
    jdb.ingest(j_make_corpus(JCorpusConfig(**cc)))
    tcfg = StoreConfig(capacity=cap, dim=dim)
    tdb = RagDB(tcfg, warm_cfg=tcfg, hot_window_s=WINDOW, now_ts=ccfg.now_ts,
                device="cpu", **tkw)
    tdb.ingest(make_corpus(ccfg, device="cpu"))
    return jdb, tdb, ccfg


def assert_tiered_agree(t_out, j_out):
    """(scores, slots, tiers) of the port against the reference's: scores
    within 1e-5, (slot, tier) pairs equal except at k-th place ties."""
    ts, tsl, ttr = (np.asarray(a) for a in t_out)
    js, jsl, jtr = (np.asarray(a) for a in j_out)
    assert ttr.dtype == np.int32 and tsl.dtype == np.int32
    enc = lambda sl, tr: np.where(sl >= 0, tr * (1 << 24) + sl, -1).astype(
        np.int32)
    assert_topk_agree(ts, enc(tsl, ttr), js, enc(jsl, jtr))
    assert ((tsl < 0) | (ttr == 0) | (ttr == 1)).all()


def _stats(db):
    return {f: getattr(db.stats, f) for f in STATS}


# ---------------------------------------------------------------------------
# test_api.py
# ---------------------------------------------------------------------------

def test_tiered_db_merges_and_routes():
    jdb, tdb, ccfg = _dbs(900, 16, 2048, 4)
    assert 0 < int(tdb.log.snapshot()["n_live"]) < 900
    assert tdb.router.warm.n_docs == jdb.router.warm.n_docs > 0
    q = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    recent = ccfg.now_ts - 60 * DAY_S
    # constrained + recent: hot only
    res = (tdb.session(Principal(tenant_id=1, group_bits=ALL)).search(q)
           .newer_than(recent).limit(4).run())
    jres = (jdb.session(JPrincipal(tenant_id=1, group_bits=ALL)).search(q)
            .newer_than(recent).limit(4).run())
    assert res.plan.route == jres.plan.route == "hot"
    assert res.plan.route_reason == jres.plan.route_reason
    assert (res.tiers[res.slots >= 0] == 0).all()
    assert_tiered_agree((res.scores, res.slots, res.tiers),
                        (jres.scores, jres.slots, jres.tiers))
    # long-tail similarity from the admin surface: merges both tiers
    res2 = tdb.admin_session().search(q).limit(6).run()
    jres2 = jdb.admin_session().search(q).limit(6).run()
    assert res2.plan.route == "hot+warm"
    assert res2.plan.explain() == jres2.plan.explain()
    assert tdb.stats.warm_queries == 1
    assert_tiered_agree((res2.scores, res2.slots, res2.tiers),
                        (jres2.scores, jres2.slots, jres2.tiers))
    assert (res2.tiers == 1).any()
    assert _stats(tdb) == _stats(jdb)
    assert tdb.explain().splitlines()[0] == jdb.explain().splitlines()[0]


def test_tiered_requires_hot_window():
    scfg = StoreConfig(capacity=64, dim=8)
    with pytest.raises(ValueError, match="hot_window_s"):
        RagDB(scfg, warm_cfg=scfg, device="cpu")


def test_tiered_writes_reach_warm_docs():
    """The write facade is tier-aware on both sides alike: update / delete
    reach warm docs, a fresh timestamp promotes a warm doc (its lanes with
    it), an old one keeps it warm, and the two dbs answer alike after
    every step."""
    jdb, tdb, ccfg = _dbs(400, 16, 1024, 3, lexical=True)
    corpus = make_corpus(ccfg, device="cpu")
    ts = corpus.updated_at.numpy()
    order = np.argsort(ts, kind="stable")
    doc_ids = corpus.doc_id.numpy()
    warm_doc, warm_doc2 = int(doc_ids[order[0]]), int(doc_ids[order[1]])
    hot_doc = int(doc_ids[order[-1]])
    assert not tdb.log.has_doc(warm_doc) and tdb.log.has_doc(hot_doc)
    wslot = tdb.router.warm.slot_of(warm_doc)
    lanes = tdb.router.warm.lex.rows([wslot])
    emb = np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32)
    for db in (tdb, jdb):
        db.update([warm_doc, hot_doc], emb, [ccfg.now_ts, ccfg.now_ts])
    assert tdb.log.has_doc(warm_doc) and not tdb.router.warm.has_doc(warm_doc)
    assert tdb.log.slot_of(warm_doc) == jdb.log.slot_of(warm_doc)
    # the promoted doc's postings moved with it
    hot_lanes = tdb.lex.rows([tdb.log.slot_of(warm_doc)])
    np.testing.assert_array_equal(hot_lanes[0], lanes[0])
    np.testing.assert_array_equal(hot_lanes[1], lanes[1])
    # the promoted doc is visible to a recency-filtered session query
    tenant = int(corpus.tenant.numpy()[order[0]])
    snap_emb = tdb.log.snapshot()["emb"][tdb.log.slot_of(warm_doc)].numpy()
    out = []
    for db, P in ((tdb, Principal), (jdb, JPrincipal)):
        out.append(db.session(P(tenant_id=tenant, group_bits=ALL))
                   .search(snap_emb, normalize=False)
                   .newer_than(ccfg.now_ts - 10 * DAY_S).limit(4).run())
    assert tdb.log.slot_of(warm_doc) in out[0].slots[0].tolist()
    assert_tiered_agree((out[0].scores, out[0].slots, out[0].tiers),
                        (out[1].scores, out[1].slots, out[1].tiers))
    # an update keeping an old timestamp stays in the warm tier
    emb2 = np.random.default_rng(2).standard_normal((1, 16)).astype(np.float32)
    for db in (tdb, jdb):
        db.update([warm_doc2], emb2, [int(ts[order[1]])])
    assert tdb.router.warm.has_doc(warm_doc2)
    # delete a warm doc: no KeyError, the row invisible afterwards
    wslot2 = tdb.router.warm.slot_of(warm_doc2)
    for db in (tdb, jdb):
        db.delete([warm_doc2])
    assert not tdb.router.warm.has_doc(warm_doc2)
    assert not bool(tdb.router.warm.valid[wslot2])
    assert tdb.router.warm.commit_count == jdb.router.warm.commit_count
    assert tdb.lex.stats.version == jdb.lex.stats.version
    # an unknown doc refuses before either tier is written
    commits = (tdb.log.commit_count, tdb.router.warm.commit_count)
    with pytest.raises(KeyError):
        tdb.update([hot_doc, 10 ** 6], emb, [1, 1])
    with pytest.raises(KeyError):
        tdb.delete([warm_doc, 10 ** 6])
    assert (tdb.log.commit_count, tdb.router.warm.commit_count) == commits
    q = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    a = tdb.admin_session().search(q).limit(8).run()
    b = jdb.admin_session().search(q).limit(8).run()
    assert_tiered_agree((a.scores, a.slots, a.tiers),
                        (b.scores, b.slots, b.tiers))


def test_single_tier_db_warm_arena_is_tiny():
    db = RagDB(StoreConfig(capacity=1 << 12, dim=32), device="cpu")
    # single-tier mode must not duplicate the hot arena for the unused warm
    # client
    assert db.router.warm.emb.shape[0] == 1
    assert db.router.hot_window_s == (1 << 31) - 1
    assert db.log is db.router.hot


def _tiny_model(vocab=64):
    cfg = tt.TransformerConfig(name="gen", n_layers=1, d_model=16, n_heads=2,
                               n_kv_heads=2, d_ff=32, vocab_size=vocab,
                               dtype="float32")
    model = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    return cfg, model


def test_serve_reports_tiers_and_skips_warm_in_prompts():
    """Tiered serving: warm-tier slots index a different arena, so they
    feed provenance (doc_tiers) but never doc_token_fn; with a
    warm_doc_token_fn they feed the prompt through it."""
    jdb, tdb, ccfg = _dbs(600, 16, 1024, 3)
    cfg, model = _tiny_model()
    seen_hot, seen_warm = [], []
    engine = RAGEngine(tdb, cfg, model, k=3, max_prompt=16, max_len=24,
                       device="cpu")
    engine.doc_token_fn = lambda s: (seen_hot.append(s),
                                     np.asarray([s % 60], np.int32))[1]
    q = np.random.default_rng(0).standard_normal(ccfg.dim).astype(np.float32)
    # min_ts=0 -> route hot+warm: responses may carry warm slots
    reqs = [Request(principal=Principal(tenant_id=0, group_bits=ALL),
                    query_emb=q, prompt_tokens=np.asarray([1], np.int32),
                    max_new_tokens=2)]
    (resp,) = engine.serve(reqs)
    assert resp.doc_tiers is not None
    hot_slots = resp.doc_slots[(resp.doc_slots >= 0) & (resp.doc_tiers == 0)]
    assert sorted(seen_hot) == sorted(hot_slots.tolist())
    n_warm = int(((resp.doc_slots >= 0) & (resp.doc_tiers == 1)).sum())
    assert n_warm > 0 and engine.last_warm_docs_skipped == n_warm
    # the retrieval equals the reference's plan on the same corpus
    jres = (jdb.session(JPrincipal(tenant_id=0, group_bits=ALL))
            .search(q / np.linalg.norm(q), normalize=False).limit(3).run())
    assert_tiered_agree(
        (resp.doc_scores[None], resp.doc_slots[None], resp.doc_tiers[None]),
        (jres.scores, jres.slots, jres.tiers))
    engine.warm_doc_token_fn = lambda s: (seen_warm.append(s),
                                          np.asarray([s % 60], np.int32))[1]
    engine.serve(reqs)
    assert engine.last_warm_docs_skipped == 0 and len(seen_warm) == n_warm


# ---------------------------------------------------------------------------
# test_adaptive.py
# ---------------------------------------------------------------------------

def test_warm_writes_invalidate_only_warm_probing_plans():
    """hot+warm entries key on the warm commit counter; hot-only entries
    pin it to -1 and survive warm-tier writes."""
    jdb, tdb, ccfg = _dbs(400, 8, 1024, 3)
    q = np.random.default_rng(1).standard_normal(ccfg.dim).astype(np.float32)
    admin = tdb.admin_session()
    hot_only = lambda: (admin.search(q)
                        .newer_than(ccfg.now_ts - 30 * DAY_S).limit(3).run())
    merged = lambda: admin.search(q).limit(3).run()
    assert hot_only().plan.route == "hot" and merged().plan.route == "hot+warm"
    assert hot_only().cached and merged().cached
    key = tdb._result_key(merged().plan)
    jkey = jdb._result_key(jdb.admin_session().search(q).limit(3).plan())
    assert key[3:] == jkey[3:]                   # the commit counters
    ts = make_corpus(ccfg, device="cpu").updated_at.numpy()
    warm_doc = int(np.argsort(ts, kind="stable")[0])
    assert tdb.router.warm.has_doc(warm_doc)
    tdb.delete([warm_doc])
    assert merged().cached is False       # warm-probing plan recomputes
    assert hot_only().cached is True      # hot-only plan provably unaffected


def test_router_query_surfaces_engine_and_route():
    ccfg = CorpusConfig(n_docs=500, dim=8, n_tenants=3)
    scfg = StoreConfig(capacity=1024, dim=8)
    router = TieredRouter(scfg, scfg, hot_window_s=WINDOW, now_ts=ccfg.now_ts,
                          device="cpu")
    router.ingest(make_corpus(ccfg, device="cpu"))
    jcfg = JStoreConfig(capacity=1024, dim=8)
    jrouter = JTieredRouter(jcfg, jcfg, hot_window_s=WINDOW,
                            now_ts=ccfg.now_ts)
    jrouter.ingest(j_make_corpus(JCorpusConfig(n_docs=500, dim=8,
                                               n_tenants=3)))
    q = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    res = router.query(q, Predicate(), 4)
    assert isinstance(res, TieredResult)
    assert res.engine == "ref"            # the planner's choice on the CPU
    assert res.route == "hot+warm"
    scores, slots, tiers = res            # 3-tuple unpacking still works
    assert scores.shape == slots.shape == tiers.shape == (2, 4)
    assert_tiered_agree(res, jrouter.query(jnp.asarray(q), JPredicate(), 4))
    pred = Predicate(min_ts=ccfg.now_ts - 10 * DAY_S)
    res2 = router.query(q, pred, 4)
    assert res2.route == "hot"
    assert_tiered_agree(res2, jrouter.query(
        jnp.asarray(q), JPredicate(min_ts=pred.min_ts), 4))
    forced = router.query(q, Predicate(), 4, engine="ref")
    assert forced.engine == "ref"
    assert (router.stats.hot_queries, router.stats.warm_queries) == (6, 4)
    router.archive(7, {"text": "old"})
    assert router.fetch_cold(7) == {"text": "old"}
    assert router.fetch_cold(8) is None and router.stats.cold_fetches == 2


# ---------------------------------------------------------------------------
# test_grouped_topk.py
# ---------------------------------------------------------------------------

def _plans(db, P, dim, rng, G, B_total, k=5):
    return [db.session(P(tenant_id=i % G, group_bits=ALL))
            .search(rng.standard_normal(dim).astype(np.float32))
            .limit(k).plan() for i in range(B_total)]


def test_fused_execute_tiered_merge_bit_identical():
    """hot+warm groups fuse too: the hot scan fuses, the per-group warm
    probes and merges stay exact -- identical to the loop, and to the
    reference's counters and rows."""
    cc = dict(n_docs=1200, dim=16, n_tenants=16, n_categories=4)
    ccfg = CorpusConfig(**cc)
    tcfg, jcfg = StoreConfig(capacity=2048, dim=16), JStoreConfig(
        capacity=2048, dim=16)
    tdb = RagDB(tcfg, warm_cfg=tcfg, hot_window_s=WINDOW, now_ts=ccfg.now_ts,
                result_cache_size=0, device="cpu")
    tdb.ingest(make_corpus(ccfg, device="cpu"))
    jdb = JRagDB(jcfg, warm_cfg=jcfg, hot_window_s=WINDOW, now_ts=ccfg.now_ts,
                 result_cache_size=0)
    jdb.ingest(j_make_corpus(JCorpusConfig(**cc)))
    plans_f = _plans(tdb, Principal, 16, np.random.default_rng(5), 3, 8)
    assert all(p.route == "hot+warm" for p in plans_f)
    fs, fi, ft = tdb.execute(plans_f, use_cache=False)
    assert tdb.stats.warm_queries == 8            # every row probed warm
    assert tdb.stats.device_calls == 1 + 3        # one fused scan, 3 probes
    js, ji, jt = jdb.execute(_plans(jdb, JPrincipal, 16,
                                    np.random.default_rng(5), 3, 8),
                             use_cache=False)
    assert_tiered_agree((fs, fi, ft), (js, ji, jt))
    assert _stats(tdb) == _stats(jdb)
    tdb.planner_cfg = dataclasses.replace(tdb.planner_cfg,
                                          fuse_min_groups=1 << 30)
    ls, li, lt = tdb.execute(_plans(tdb, Principal, 16,
                                    np.random.default_rng(5), 3, 8),
                             use_cache=False)
    tdb.planner_cfg = PlannerConfig()
    assert (fs == ls).all() and (fi == li).all() and (ft == lt).all()
    assert (ft == 1).any(), "warm tier must contribute rows to the merge"


# ---------------------------------------------------------------------------
# test_hybrid.py
# ---------------------------------------------------------------------------

KW_CC = dict(seed=21, vocab_size=256, n_topics=8, n_entity_terms=32,
             entity_frac=0.06)


@pytest.mark.parametrize("mode", ["wsum", "rrf"])
def test_warm_tier_lexical_pushdown(mode):
    """A tiered RagDB answers hybrid queries across BOTH tiers: the warm
    probe pushes predicate AND query terms into one round trip (sharing
    the hot arena's LexicalStats), and warm rows surface in the merge when
    their fused score earns it -- as in the reference."""
    jdb, tdb, ccfg = _dbs(1500, 16, 2048, 4, lexical=True, **KW_CC)
    assert tdb.router.warm.lex is not None and tdb.router.warm.n_docs > 0
    assert tdb.router.warm.lex.stats is tdb.lex.stats
    jcorpus = j_make_corpus(JCorpusConfig(n_docs=1500, dim=16, n_tenants=4,
                                          n_categories=8, **KW_CC))
    q, terms_list, relevant = j_keyword_queries(
        JCorpusConfig(n_docs=1500, dim=16, n_tenants=4, n_categories=8,
                      **KW_CC), jcorpus, 6, seed=7)
    hot_ids = tdb.log.snapshot()["doc_id"].numpy()
    warm_ids = tdb.router.warm.meta["doc_id"].numpy()
    saw_warm, total = False, 0.0
    for i in range(len(q)):
        rt0 = tdb.router.warm.stats.round_trips
        res = (tdb.admin_session().search(q[i]).match(terms_list[i])
               .fuse(mode).limit(10).run())
        jres = (jdb.admin_session().search(q[i]).match(terms_list[i])
                .fuse(mode).limit(10).run())
        assert res.plan.route == jres.plan.route == "hot+warm"
        assert res.plan.explain() == jres.plan.explain()
        assert tdb.router.warm.stats.round_trips - rt0 == 1   # ONE pushdown
        assert_tiered_agree((res.scores, res.slots, res.tiers),
                            (jres.scores, jres.slots, jres.tiers))
        got = set()
        for s, t in zip(res.slots[0], res.tiers[0]):
            if s >= 0:
                got.add(int(hot_ids[s] if t == 0 else warm_ids[s]))
                saw_warm |= bool(t == 1)
        rel = set(relevant[i].tolist())
        total += len(got & rel) / min(10, len(rel))
    assert saw_warm, "warm tier never contributed — pushdown untested"
    assert total / len(q) >= 0.9
    assert _stats(tdb) == _stats(jdb)


def test_match_stays_hot_without_warm_lanes():
    """A lexical db whose warm tier has no lanes keeps match() plans hot
    (the reference's rule), and a lexical tiered db lets them spill."""
    cfg = StoreConfig(capacity=64, dim=8)
    ccfg = CorpusConfig(n_docs=40, dim=8)
    db = RagDB(cfg, warm_cfg=cfg, hot_window_s=WINDOW, now_ts=ccfg.now_ts,
               lexical_cfg=LexicalConfig(), device="cpu")
    db.ingest(make_corpus(ccfg, device="cpu"))
    assert db.router.warm.n_docs > 0
    q = np.ones(8, np.float32)
    assert db.admin_session().search(q).match([3]).plan().route == "hot+warm"
    db.router.warm.lex = None
    plan = db.admin_session().search(q).match([3]).plan()
    assert plan.route == "hot"
    assert plan.route_reason == ("warm tier has no lexical lanes — hybrid "
                                 "stays hot")


# ---------------------------------------------------------------------------
# test_faults.py
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _guarded(db, clock, metrics, **cfg):
    db.warm_guard = WarmGuard(ResilienceConfig(**cfg), clock=clock,
                              sleep=clock.advance, metrics=metrics)


def _clean_ref(db, plan):
    saved, guard = db.faults, db.warm_guard
    db.attach_faults(None)
    db.warm_guard = None
    try:
        return db.execute([plan], use_cache=False)
    finally:
        db.attach_faults(saved)
        db.warm_guard = guard


def test_warm_error_is_retried_to_a_bit_identical_response():
    jdb, db, ccfg = _dbs(400, 16, 1024, 3, n_categories=4)
    clock, metrics = FakeClock(), MetricsRegistry()
    db.attach_faults(FaultPlan(0, {"warm.error": FaultRule(at=(0,))},
                               sleep=clock.advance))
    _guarded(db, clock, metrics, max_retries=2)
    q = np.random.default_rng(3).standard_normal(ccfg.dim).astype(np.float32)
    plan = db.admin_session().search(q, normalize=False).limit(6).plan()
    assert plan.route == "hot+warm"
    pending = db.launch([plan])
    s, sl, tr = db.finish(pending)
    assert pending.served == ["fresh"] and pending.plans[0].degraded == ()
    cs, csl, ctr = _clean_ref(db, plan)
    assert (np.array_equal(s, cs) and np.array_equal(sl, csl)
            and np.array_equal(tr, ctr)), \
        "retried response must be bit-identical to fault-free"
    assert metrics.counter_total("warm_errors") == 1
    assert metrics.counter_total("warm_retries") == 1
    assert db.stats.device_calls == 2 + 2          # 1 hot + 2 round trips
    jres = jdb.execute([jdb.admin_session().search(q, normalize=False)
                        .limit(6).plan()], use_cache=False)
    assert_tiered_agree((s, sl, tr), jres)


def test_warm_stall_times_out_to_explicit_hot_only_degradation():
    jdb, db, ccfg = _dbs(400, 16, 1024, 3, n_categories=4)
    clock, metrics = FakeClock(), MetricsRegistry()
    db.attach_faults(FaultPlan(
        0, {"warm.stall": FaultRule(rate=1.0, stall_s=0.05)},
        sleep=clock.advance))
    _guarded(db, clock, metrics, timeout_ms=10.0, max_retries=1,
             breaker_failures=10)
    q = np.random.default_rng(4).standard_normal(ccfg.dim).astype(np.float32)
    plan = db.admin_session().search(q, normalize=False).limit(6).plan()
    pending = db.launch([plan])
    s, sl, tr = db.finish(pending)
    assert any("warm-unavailable" in d for d in pending.plans[0].degraded), \
        "a timed-out warm probe must surface as explicit degradation"
    assert metrics.counter_total("warm_timeouts") == 2    # 1 + 1 retry
    assert metrics.counter_total("warm_failovers") == 1
    assert db.stats.warm_failovers == 1
    assert (tr[sl >= 0] == 0).all()              # hot-only rows, really hot
    assert len(db.result_cache) == 0             # the degraded chunk: uncached
    # served fault-free, the same query computes fresh and bit-identical
    db.attach_faults(None)
    db.warm_guard = None
    res2 = db.admin_session().search(q, normalize=False).limit(6).run()
    assert not res2.cached and res2.plan.degraded == ()
    cs, csl, ctr = _clean_ref(db, plan)
    assert np.array_equal(res2.scores, cs) and np.array_equal(res2.slots, csl)
    jres = jdb.execute([jdb.admin_session().search(q, normalize=False)
                        .limit(6).plan()], use_cache=False)
    assert_tiered_agree((res2.scores, res2.slots, res2.tiers), jres)


def test_failover_of_an_rrf_plan_fuses_the_hot_lists():
    """When the guard gives up on an rrf hybrid plan's warm probe, the hot
    scan (run in lists mode) still answers: its two lists rank-fused, all
    hot, equal to the same plan on a db with an empty warm tier."""
    jdb, db, ccfg = _dbs(600, 16, 1024, 3, lexical=True, **KW_CC)
    clock, metrics = FakeClock(), MetricsRegistry()
    db.attach_faults(FaultPlan(0, {"warm.error": FaultRule(rate=1.0)},
                               sleep=clock.advance))
    _guarded(db, clock, metrics, max_retries=0)
    q = np.random.default_rng(5).standard_normal(ccfg.dim).astype(np.float32)
    plan = (db.admin_session().search(q).match([3, 40, 41]).fuse("rrf")
            .limit(8).plan())
    pending = db.launch([plan])
    s, sl, tr = db.finish(pending)
    assert db.stats.warm_failovers == 1 and (tr == 0).all()
    assert pending.plans[0].degraded == ("warm-unavailable: served hot-only",)
    hot_only = dataclasses.replace(plan, route="hot")
    db.attach_faults(None)
    db.warm_guard = None
    hs, hsl, _ = db.execute([hot_only], use_cache=False)
    np.testing.assert_array_equal(sl, hsl)
    np.testing.assert_array_equal(s, hs)


# ---------------------------------------------------------------------------
# test_serving.py
# ---------------------------------------------------------------------------

def test_router_places_and_merges():
    ccfg = CorpusConfig(n_docs=800, dim=16, n_tenants=4)
    scfg = StoreConfig(capacity=2048, dim=16)
    router = TieredRouter(scfg, scfg, hot_window_s=WINDOW, now_ts=ccfg.now_ts,
                          device="cpu")
    router.ingest(make_corpus(ccfg, device="cpu"))
    jcfg = JStoreConfig(capacity=2048, dim=16)
    jrouter = JTieredRouter(jcfg, jcfg, hot_window_s=WINDOW,
                            now_ts=ccfg.now_ts)
    jrouter.ingest(j_make_corpus(JCorpusConfig(n_docs=800, dim=16,
                                               n_tenants=4)))
    n_hot = int(router.hot.snapshot()["n_live"])
    assert 0 < n_hot < 800
    assert n_hot == int(jrouter.hot.snapshot()["n_live"])
    assert router.warm.n_docs == 800 - n_hot
    q = np.random.default_rng(0).standard_normal((1, 16)).astype(np.float32)
    pred = Predicate(tenant=1, min_ts=ccfg.now_ts - 60 * DAY_S)
    s, slots, tiers = router.query(q, pred, 4)
    assert router.stats.warm_queries == 0
    assert (tiers[slots >= 0] == 0).all()
    s2, slots2, tiers2 = router.query(q, Predicate(), 6)
    assert router.stats.warm_queries == 1
    assert_tiered_agree((s2, slots2, tiers2),
                        jrouter.query(jnp.asarray(q), JPredicate(), 6))


# ---------------------------------------------------------------------------
# the executor's contract and the whole slice
# ---------------------------------------------------------------------------

def test_executor_takes_the_warm_client_second():
    for name in ("execute_plans", "launch_plans"):
        t = list(inspect.signature(getattr(executor_mod, name)).parameters)
        j = list(inspect.signature(getattr(j_executor, name)).parameters)
        assert t[:3] == j[:3] == ["hot_store", "warm", "plans"]
    t = list(inspect.signature(executor_mod.query_tiered).parameters)
    assert t[:5] == ["hot_store", "warm", "q", "pred", "k"]


def test_no_warm_probe_before_every_hot_unit_is_launched(monkeypatch):
    """launch_plans issues the warm probes only after the last hot unit is
    launched: a batch of a fused dense unit, a wsum unit and an rrf unit
    (all hot+warm) records every hot launch before the first probe."""
    _, db, ccfg = _dbs(900, 16, 1024, 4, lexical=True, **KW_CC)
    events = []
    for mod, name in ((executor_mod, "unified_query_grouped"),
                      (hyb_ops, "hybrid_score")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw: (
            events.append(("hot", _n)), _r(*a, **kw))[1])
    warm = db.router.warm
    for name in ("query", "query_hybrid"):
        real = getattr(warm, name)
        monkeypatch.setattr(warm, name, lambda *a, _r=real, _n=name, **kw: (
            events.append(("warm", _n)), _r(*a, **kw))[1])
    rng = np.random.default_rng(0)
    plans = []
    for t in range(4):
        b = db.session(Principal(t, ALL)).search(
            rng.standard_normal(16).astype(np.float32)).limit(5)
        plans += [b.plan(), b.match([3, 7]).plan(),
                  b.match([3, 7]).fuse("rrf").plan()]
    assert all(p.route == "hot+warm" for p in plans)
    db.execute(plans, use_cache=False)
    kinds = [k for k, _ in events]
    assert kinds == ["hot"] * 3 + ["warm"] * 12, events
    assert db.stats.device_calls == 3 + 12


def _mixed_plans(db, P, qs, now, terms):
    """hot (constrained, in the window), tail dense, tail wsum, tail rrf and
    admin long-tail (ivf) plans, k = 8."""
    out = []
    for r, q in enumerate(qs):
        kind = r % 5
        sess = db.session(P(tenant_id=r % 4, group_bits=ALL))
        if kind == 0:
            b = sess.search(q).newer_than(now - 30 * DAY_S).in_categories(
                [0, 1, 2])
        elif kind == 1:
            b = sess.search(q)
        elif kind == 2:
            b = sess.search(q).match(terms[r % len(terms)]).fuse(
                "wsum", w_dense=0.8, w_lex=1.5)
        elif kind == 3:
            b = sess.search(q).match(terms[r % len(terms)]).fuse("rrf")
        else:
            b = db.admin_session().search(q)
        out.append(b.limit(8).plan())
    return out


def test_mixed_tiered_batch_matches_reference():
    """The whole slice: a tiered RagDB with lanes and a built index runs a
    mixed batch (hot, tail dense, tail wsum, tail rrf, admin ivf) as the
    reference's does: routes, engines and explain() lines, the merged rows
    and tiers, and ExecStats."""
    cc = dict(n_docs=3000, dim=32, n_tenants=4, n_categories=4, **KW_CC)
    ccfg = CorpusConfig(**cc)
    lexkw = dict(vocab_size=ccfg.vocab_size, doc_terms=ccfg.doc_terms)
    jcfg = JStoreConfig(capacity=4096, dim=32)
    jdb = JRagDB(jcfg, warm_cfg=jcfg, hot_window_s=100 * DAY_S,
                 now_ts=ccfg.now_ts, lexical_cfg=JLexicalConfig(**lexkw))
    jcorpus = j_make_corpus(JCorpusConfig(**cc))
    jdb.ingest(jcorpus)
    jdb.build_index()
    tcfg = StoreConfig(capacity=4096, dim=32)
    tdb = RagDB(tcfg, warm_cfg=tcfg, hot_window_s=100 * DAY_S,
                now_ts=ccfg.now_ts, lexical_cfg=LexicalConfig(**lexkw),
                device="cpu")
    tdb.ingest(make_corpus(ccfg, device="cpu"))
    tdb.index = _port_index(jdb.index)
    tdb.log.ivf = tdb.index
    q, terms, _ = j_keyword_queries(JCorpusConfig(**cc), jcorpus, 15, seed=3)
    q = np.asarray(q, np.float32)
    jplans = _mixed_plans(jdb, JPrincipal, q, ccfg.now_ts, terms)
    tplans = _mixed_plans(tdb, Principal, q, ccfg.now_ts, terms)
    routes = [p.route for p in tplans]
    assert routes == [p.route for p in jplans]
    assert {"hot", "hot+warm"} == set(routes)
    assert {p.engine for p in tplans} == {"ref", "hybrid", "ivf"}
    for tp, jp in zip(tplans, jplans):
        assert tp.engine == jp.engine and tp.group_key[1:] == jp.group_key[1:]
        tl = [ln for ln in tp.explain().splitlines() if "route" in ln]
        jl = [ln for ln in jp.explain().splitlines() if "route" in ln]
        assert tl == jl and tl
    out = tdb.execute(tplans, use_cache=False)
    jout = jdb.execute(jplans, use_cache=False)
    assert_tiered_agree(out, jout)
    assert (out[2] == 1).any() and (out[2] == 0).any()
    assert _stats(tdb) == _stats(jdb)
    assert tdb.stats.warm_queries == 12
    assert (dataclasses.asdict(tdb.router.stats)
            == dataclasses.asdict(jdb.router.stats))
