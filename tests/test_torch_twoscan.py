"""Parity of the port's split-stack two-scan baseline and of the
degradation ladder's ``hybrid -> dense`` rung with the reference's, on the
CPU.

* `two_scan_hybrid` (wsum and rrf, with and without predicate pushdown)
  against the reference's on the same corpus and queries, under the North
  star's contract; the reference's own test (``tests/test_hybrid.py:438``):
  on keyword-anchored queries with clear winners the two-scan set equals
  the fused scan's.
* `lexical_topk` against the reference's, and scored 2^k rows at a time
  against one pass: on exact ties the running top-k keeps the lower row,
  as ``jax.lax.top_k`` does, so the lists are equal bit for bit.
* The ``hybrid -> dense`` rung: the same tags and the same ladders as the
  reference's (engine names equal on the CPU: both plan "ref" or "ivf"),
  and the degraded plans' rows under the contract.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.api.planner import PlannerConfig as JPlannerConfig
from repro.core.query import Predicate as JPredicate
from repro.core.store import DocBatch as JDocBatch
from repro.core.store import StoreConfig as JStoreConfig
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.data.corpus import make_keyword_queries as j_keyword_queries
from repro.index.lexical import LexicalConfig as JLexicalConfig
from repro.index.lexical.twoscan import lexical_topk as j_lexical_topk
from repro.index.lexical.twoscan import two_scan_hybrid as j_two_scan
from repro_torch.api import RagDB
from repro_torch.api.planner import PlannerConfig
from repro_torch.core.query import Predicate
from repro_torch.core.store import DocBatch, StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.data.corpus import CorpusConfig, make_corpus
from repro_torch.data.corpus import make_keyword_queries
from repro_torch.index.lexical import LexicalConfig
from repro_torch.index.lexical.twoscan import lexical_topk, two_scan_hybrid
from tests.test_torch_arena_scan import assert_topk_agree
from tests.test_torch_ivf import _port_index
from tests.test_torch_scheduler import engine_name

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

ALL_BITS = 0xFFFFFFFF
KW_CCFG = dict(n_docs=800, dim=32, vocab_size=512, n_topics=16,
               n_entity_terms=64, entity_frac=0.06)


def _keyword_dbs(seed, planner=None):
    """The reference test's keyword corpus in both packages (4096-row
    arenas, 512-term vocabulary)."""
    ccfg = CorpusConfig(seed=seed, **KW_CCFG)
    jccfg = JCorpusConfig(seed=seed, **KW_CCFG)
    jdb = JRagDB(JStoreConfig(capacity=4096, dim=ccfg.dim),
                 lexical_cfg=JLexicalConfig(vocab_size=512,
                                            doc_terms=ccfg.doc_terms),
                 **({"planner_cfg": JPlannerConfig(**planner)}
                    if planner else {}))
    jcorpus = j_make_corpus(jccfg)
    jdb.ingest(jcorpus)
    tdb = RagDB(StoreConfig(capacity=4096, dim=ccfg.dim),
                lexical_cfg=LexicalConfig(vocab_size=512,
                                          doc_terms=ccfg.doc_terms),
                **({"planner_cfg": PlannerConfig(**planner)}
                   if planner else {}),
                device="cpu")
    corpus = make_corpus(ccfg, device="cpu")
    tdb.ingest(corpus)
    return jdb, tdb, ccfg, jccfg, corpus, jcorpus


def _queries(ccfg, jccfg, corpus, jcorpus, n, seed):
    q, terms, _ = make_keyword_queries(ccfg, corpus, n, seed=seed)
    jq, jterms, _ = j_keyword_queries(jccfg, jcorpus, n, seed=seed)
    q = q.numpy() if isinstance(q, torch.Tensor) else np.asarray(q)
    np.testing.assert_allclose(q, np.asarray(jq), rtol=1e-6, atol=1e-6)
    assert [list(t) for t in terms] == [list(t) for t in jterms]
    return q, terms


def _jpred(p: Predicate) -> JPredicate:
    return JPredicate(**dataclasses.asdict(p))


def test_two_scan_baseline_agrees_on_clear_winners():
    """The split baseline is approximate (union-of-top-C) but agrees with
    the fused scan on keyword-anchored queries whose winners are
    unambiguous; and with the reference's baseline row for row."""
    jdb, tdb, *rest = _keyword_dbs(14)
    q, terms_list = _queries(*rest, 4, seed=8)
    admin = tdb.admin_session()
    snap, lex_snap = tdb.log.snapshot(), tdb.lex.snapshot()
    jsnap, jlex_snap = jdb.log.snapshot(), jdb.lex.snapshot()
    for i in range(len(q)):
        res = admin.search(q[i]).match(terms_list[i]).limit(5).run()
        qt = np.asarray(terms_list[i], np.int32)[None, :]
        s2, i2 = two_scan_hybrid(snap, lex_snap, q[i][None, :], qt,
                                 Predicate(), 5)
        assert set(i2[0].tolist()) == set(res.slots[0].tolist())
        js2, ji2 = j_two_scan(jsnap, jlex_snap, q[i][None, :], qt,
                              JPredicate(), 5)
        assert_topk_agree(s2, i2, np.asarray(js2), np.asarray(ji2))


@pytest.mark.parametrize("pushdown", [True, False])
@pytest.mark.parametrize("mode", ["wsum", "rrf"])
def test_two_scan_matches_reference(mode, pushdown):
    """Tenant / recency / category predicates (the faithful form walks its
    over-fetch ladder under them) and a batch of four queries: the port's
    baseline against the reference's, and no returned row fails the
    predicate."""
    jdb, tdb, ccfg, *rest = _keyword_dbs(3)
    q, terms_list = _queries(ccfg, *rest, 4, seed=5)
    qt = np.full((4, max(len(t) for t in terms_list)), -1, np.int32)
    for r, t in enumerate(terms_list):
        qt[r, :len(t)] = t
    snap, lex_snap = tdb.log.snapshot(), tdb.lex.snapshot()
    tenant = snap["tenant"].numpy()
    ts = snap["updated_at"].numpy()
    cat = snap["category"].numpy()
    for pred in (Predicate(tenant=1), Predicate(tenant=2,
                                                min_ts=int(np.median(ts)),
                                                cat_mask=0b0110)):
        s, i = two_scan_hybrid(snap, lex_snap, q, qt, pred, 6, mode=mode,
                               w_dense=0.8, w_lex=1.7, pushdown=pushdown)
        js, ji = j_two_scan(jdb.log.snapshot(), jdb.lex.snapshot(), q, qt,
                            _jpred(pred), 6, mode=mode, w_dense=0.8,
                            w_lex=1.7, pushdown=pushdown)
        assert s.dtype == np.float32 and i.dtype == np.int32
        assert_topk_agree(s, i, np.asarray(js), np.asarray(ji))
        real = i[i >= 0]
        assert len(real) > 0
        assert (tenant[real] == pred.tenant).all()
        assert (ts[real] >= pred.min_ts).all()
        assert (((1 << cat[real].astype(np.int64)) & pred.cat_mask)
                != 0).all()


def test_lexical_topk_matches_reference():
    jdb, tdb, ccfg, *rest = _keyword_dbs(5)
    _, terms_list = _queries(ccfg, *rest, 3, seed=2)
    qt = np.full((3, 4), -1, np.int32)
    for r, t in enumerate(terms_list):
        qt[r, :len(t[:4])] = t[:4]
    lx, jlx = tdb.lex.snapshot(), jdb.lex.snapshot()
    for pred in (Predicate(), Predicate(tenant=2)):
        s, i = lexical_topk(tdb.log.snapshot(), lx["terms"], lx["lexnorm"],
                            lx["idf"], qt, pred.as_array(), 12)
        js, ji = j_lexical_topk(jdb.log.snapshot(), jlx["terms"],
                                jlx["lexnorm"], jlx["idf"], qt,
                                _jpred(pred).as_array(), 12)
        assert_topk_agree(s.numpy(), i.numpy(), np.asarray(js),
                          np.asarray(ji))


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_lexical_topk_chunked_equals_one_pass_on_exact_ties(chunk):
    """300 rows whose lanes come in five identical patterns: every score
    ties exactly with dozens of others, across chunk borders. The chunked
    running top-k returns the one-pass lists bit for bit, ties to the
    lower row, and the reference's lists too (k past the live rows
    included)."""
    n, d, t_lanes = 300, 8, 4
    rng = np.random.default_rng(0)
    patterns = np.asarray([[3, 5, -1, -1], [5, 9, 3, -1], [9, -1, -1, -1],
                           [3, 3, 5, 9], [-1, -1, -1, -1]], np.int32)
    terms = patterns[rng.integers(0, 5, n)]
    lexnorm = np.where(terms >= 0, 0.75, 0.0).astype(np.float32)
    idf = np.linspace(0.5, 2.0, 16).astype(np.float32)
    tenant = rng.integers(-1, 3, n).astype(np.int32)     # -1: dead rows
    cols = dict(emb=rng.standard_normal((n, d)).astype(np.float32),
                tenant=tenant, category=np.zeros(n, np.int32),
                updated_at=np.zeros(n, np.int32),
                doc_id=np.arange(n, dtype=np.int32))
    tdb = RagDB(StoreConfig(capacity=n, dim=d), device="cpu")
    tdb.ingest(DocBatch(acl=np.full(n, -1, np.int32), **cols))
    jdb = JRagDB(JStoreConfig(capacity=n, dim=d))
    jdb.ingest(JDocBatch(acl=np.full(n, ALL_BITS, np.uint32), **cols))
    qt = np.asarray([[3, 9], [5, -1], [9, 3]], np.int32)
    for pred in (Predicate(), Predicate(tenant=1)):
        for k in (5, 40, 400):
            args = (tdb.log.snapshot(), torch.from_numpy(terms),
                    torch.from_numpy(lexnorm), torch.from_numpy(idf), qt,
                    pred.as_array(), k)
            one = lexical_topk(*args, chunk_rows=None)
            got = lexical_topk(*args, chunk_rows=chunk)
            for a, b in zip(got, one):
                assert torch.equal(a, b)
            js, ji = j_lexical_topk(jdb.log.snapshot(), terms, lexnorm, idf,
                                    qt, _jpred(pred).as_array(), k)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
            np.testing.assert_allclose(got[0].numpy(), np.asarray(js),
                                       rtol=1e-6, atol=1e-6)


def _ladder(db, plan):
    rungs = [plan]
    while (nxt := db.degrade(rungs[-1])) is not None:
        rungs.append(nxt)
    return rungs


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("mode", ["wsum", "rrf"])
def test_hybrid_to_dense_rung_matches_reference(mode, index):
    """A match() plan degrades to a dense plan tagged "hybrid->dense", then
    (with an index the admin plan recompiles onto "ivf") down the nprobe
    rungs: the same tags, engines and probe depths as the reference's
    ladder, every rung's rows under the contract, tenant clauses kept."""
    planner = dict(ivf_min_rows=512) if index else None
    jdb, tdb, ccfg, *rest = _keyword_dbs(9, planner=planner)
    if index:
        jdb.build_index()
        tdb.index = _port_index(jdb.index)
        tdb.log.ivf = tdb.index
    q, terms_list = _queries(ccfg, *rest, 2, seed=4)
    for sess, jsess in ((tdb.admin_session(), jdb.admin_session()),
                        (tdb.session(Principal(2, ALL_BITS)),
                         jdb.session(_jprincipal(2)))):
        plan = (sess.search(q[0]).match(terms_list[0]).fuse(mode)
                .limit(6).plan())
        jplan = (jsess.search(q[0]).match(terms_list[0]).fuse(mode)
                 .limit(6).plan())
        rungs, jrungs = _ladder(tdb, plan), _ladder(jdb, jplan)
        assert rungs[1].degraded == ("hybrid->dense",)
        assert rungs[1].logical.match_terms is None
        assert rungs[1].pred == plan.pred
        assert "hybrid->dense" in rungs[1].explain()
        assert [r.degraded for r in rungs] == [
            tuple(engine_name(d) for d in r.degraded) for r in jrungs]
        assert [r.engine for r in rungs] == [engine_name(r.engine)
                                             for r in jrungs]
        assert [r.nprobe for r in rungs] == [r.nprobe for r in jrungs]
        assert rungs[1].engine == ("ivf" if index and plan.pred.tenant == -2
                                   else "ref")
        for rung, jrung in zip(rungs, jrungs):
            s, sl, _ = tdb.execute([rung], use_cache=False)
            js, jsl, _ = jdb.execute([jrung], use_cache=False)
            assert_topk_agree(s, sl, np.asarray(js), np.asarray(jsl))


def _jprincipal(tenant):
    from repro.core.tenancy import Principal as JPrincipal
    return JPrincipal(tenant_id=tenant, group_bits=ALL_BITS)
