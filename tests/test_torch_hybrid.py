"""Parity of the port's hybrid dense+BM25 engine with the JAX reference's.

The same numpy inputs go through the reference's dense oracle
(`hybrid_score_ref`, not interpret mode: ROADMAP's note on the failing
conformance cells) and through the port on the CPU -- its public
`hybrid_score` (which takes the streaming scan for CPU tensors), its dense
oracle and its streaming scan. The CUDA kernel itself runs only on the
card and is held to its plain version by chip_smoke.py.

Contract (ROADMAP North star): integers exact; f32 scores within
rtol = atol = 1e-5; slots may differ only inside a run of tied scores at
the k-th place; the leakage check exact. The front door (`RagDB` with a
lexical arena) is compared on REDUCED / REDUCED_CORPUS: plans, explain
text, `ExecStats` counters, the cache across lexical writes, and recovery
from a crash around the lexical write-ahead step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.core.query import Predicate as JPredicate
from repro.core.query import stack_predicates as j_stack
from repro.core.store import DocBatch as JDocBatch
from repro.core.store import StoreConfig as JStoreConfig
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.index.lexical import LexicalConfig as JLexicalConfig
from repro.kernels.hybrid_score.ref import hybrid_score_ref as j_hybrid_ref
from repro.kernels.hybrid_score.ref import rrf_fuse as j_rrf_fuse
from repro_torch.api import RagDB
from repro_torch.core.query import Predicate, stack_predicates
from repro_torch.core.store import DocBatch, StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.core.transactions import CRASH_POINTS
from repro_torch.data.corpus import CorpusConfig, make_corpus
from repro_torch.data.corpus import make_keyword_queries
from repro_torch.index.lexical import LexicalConfig
from repro_torch.kernels.hybrid_score import hybrid_score as hyb_mod
from repro_torch.kernels.hybrid_score.ops import hybrid_score
from repro_torch.kernels.hybrid_score.ref import (hybrid_score_ref,
                                                  hybrid_score_scan_ref,
                                                  qidf_of, rrf_fuse)
from repro_torch.serving.faults import CrashError, FaultPlan, FaultRule
from tests.test_torch_arena_scan import assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

T_MAX = 16          # LexicalConfig.max_query_terms default
W = dict(w_dense=0.8, w_lex=1.7)


def _arena(rng, n, d=16, v=64, t_lanes=6, n_tenants=5):
    """numpy arena columns + postings lanes (acl as uint32 with high bits,
    category up to 31)."""
    terms = rng.integers(-1, v, (n, t_lanes)).astype(np.int32)
    return {
        "emb": rng.standard_normal((n, d)).astype(np.float32),
        "tenant": rng.integers(-1, n_tenants, n).astype(np.int32),
        "updated_at": rng.integers(0, 1000, n).astype(np.int32),
        "category": rng.integers(0, 32, n).astype(np.int32),
        "acl": rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        "terms": terms,
        "lexnorm": np.where(terms >= 0, rng.random((n, t_lanes)) * 2,
                            0).astype(np.float32),
        "idf": (rng.random(v) * 5).astype(np.float32),
    }


def _meta(a):
    return np.stack([a["tenant"], a["updated_at"], a["category"],
                     a["acl"].view(np.int32)], axis=1).astype(np.int32)


def _qidf(a, qterms):
    return np.where(qterms >= 0, a["idf"][np.clip(qterms, 0, None)],
                    0).astype(np.float32)


def _ref(a, q, gids, preds, qterms, k, mode, **kw):
    """The reference's dense oracle on numpy inputs."""
    jp = j_stack([JPredicate(tenant=p.tenant, min_ts=p.min_ts,
                             cat_mask=p.cat_mask, acl_bits=p.acl_bits)
                  for p in preds])
    return j_hybrid_ref(jnp.asarray(q), jnp.asarray(a["emb"]),
                        jnp.asarray(_meta(a)), jnp.asarray(a["terms"]),
                        jnp.asarray(a["lexnorm"]), jnp.asarray(gids), jp,
                        jnp.asarray(qterms), jnp.asarray(_qidf(a, qterms)),
                        k, mode=mode, **kw)


def _port(a, q, gids, preds, qterms, k, mode, **kw):
    """The port's public hybrid_score on CPU tensors."""
    t = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                   else x.copy())
    return hybrid_score(t(q), t(a["emb"]), t(a["tenant"]),
                        t(a["updated_at"]), t(a["category"]), t(a["acl"]),
                        t(a["terms"]), t(a["lexnorm"]), t(a["idf"]),
                        t(gids), stack_predicates(preds), t(qterms), k,
                        mode=mode, **kw)


def _inputs(rng, B, N, D, qt, G=3):
    a = _arena(rng, N, D)
    q = rng.standard_normal((B, D)).astype(np.float32)
    qterms = rng.integers(-1, 64, (B, qt)).astype(np.int32)
    qterms[:, 0] = rng.integers(0, 64, B)          # at least one real term
    gids = rng.integers(0, G, B).astype(np.int32)
    preds = [Predicate(tenant=i % 3, min_ts=100,
                       cat_mask=int(rng.integers(1, 1 << 32)) | (1 << 31))
             for i in range(G)]
    return a, q, gids, preds, qterms


# ---------------------------------------------------------------------------
# the port's hybrid_score against the reference's dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["wsum", "rrf"])
@pytest.mark.parametrize("qt", [1, 4, T_MAX])
@pytest.mark.parametrize("B,N,D,k", [(5, 700, 48, 8), (8, 1024, 128, 10),
                                     (1, 64, 8, 4), (3, 40, 16, 57)])
def test_hybrid_score_matches_reference(mode, qt, B, N, D, k):
    """(B, N, D, k) are the reference's hybrid cells plus k > N."""
    rng = np.random.default_rng(B * 1000 + N + qt)
    a, q, gids, preds, qterms = _inputs(rng, B, N, D, qt)
    s_r, i_r = _ref(a, q, gids, preds, qterms, k, mode, **W)
    s_p, i_p = _port(a, q, gids, preds, qterms, k, mode, **W)
    assert_topk_agree(s_p.numpy(), i_p.numpy(), np.asarray(s_r),
                      np.asarray(i_r))


@pytest.mark.parametrize("qt", [1, 4, T_MAX])
def test_rrf_lists_match_reference_lists(qt):
    """lists=True returns the two per-signal lists unfused: the dense list
    against the reference's dense oracle, the bm25 list exactly."""
    rng = np.random.default_rng(qt)
    a, q, gids, preds, qterms = _inputs(rng, 6, 500, 32, qt)
    d_s, d_i, l_s, l_i = _port(a, q, gids, preds, qterms, 12, "rrf",
                               lists=True)
    from repro.kernels.arena_scan.ref import arena_scan_ref as j_scan_ref
    from repro.kernels.arena_scan.stages import ScanSpec as JScanSpec
    jp = j_stack([JPredicate(tenant=p.tenant, min_ts=p.min_ts,
                             cat_mask=p.cat_mask, acl_bits=p.acl_bits)
                  for p in preds])
    jd_s, jd_i, jl_s, jl_i = j_scan_ref(
        jnp.asarray(q), jnp.asarray(a["emb"]), jnp.asarray(_meta(a)),
        jnp.asarray(gids), jp, 12, spec=JScanSpec(score="both"),
        lex=(jnp.asarray(a["terms"]), jnp.asarray(a["lexnorm"]),
             jnp.asarray(qterms), jnp.asarray(_qidf(a, qterms))))
    assert_topk_agree(d_s.numpy(), d_i.numpy(), np.asarray(jd_s),
                      np.asarray(jd_i))
    np.testing.assert_array_equal(l_s.numpy(), np.asarray(jl_s))
    np.testing.assert_array_equal(l_i.numpy(), np.asarray(jl_i))
    with pytest.raises(ValueError, match="rrf"):
        _port(a, q, gids, preds, qterms, 12, "wsum", lists=True)
    with pytest.raises(ValueError, match="fusion mode"):
        _port(a, q, gids, preds, qterms, 12, "max")


@pytest.mark.parametrize("mode", ["wsum", "rrf"])
@pytest.mark.parametrize("blk_n", [64, 100, 256, 4096])
def test_streaming_scan_equals_dense_oracle(mode, blk_n):
    """The port's streaming scan (the kernel's schedule: tiles, local
    top-k, one merge; ragged last tile) equals its dense oracle exactly."""
    rng = np.random.default_rng(blk_n)
    a, q, gids, preds, qterms = _inputs(rng, 7, 777, 24, 4)
    t = torch.from_numpy
    args = (t(q), t(a["emb"]), t(_meta(a)), t(a["terms"]), t(a["lexnorm"]),
            t(gids), stack_predicates(preds), t(qterms),
            t(_qidf(a, qterms)), 20)
    s_o, i_o = hybrid_score_ref(*args, mode=mode, **W)
    s_s, i_s = hybrid_score_scan_ref(*args, blk_n, mode=mode, **W)
    assert torch.equal(s_o, s_s) and torch.equal(i_o, i_s)


@pytest.mark.parametrize("seed", range(6))
def test_rrf_fuse_on_tied_lists_matches_reference(seed):
    """Hand-made per-signal lists full of exact rank ties and shared slots,
    with -1 padding: the fused scores and slots equal the reference's bit
    for bit (ties to the dense list, then to the better rank)."""
    rng = np.random.default_rng(seed)
    B, kd, kl, k = 5, 7, 6, int(rng.integers(3, 15))
    pool = np.arange(12)
    di = np.stack([rng.permutation(pool)[:kd] for _ in range(B)])
    li = np.stack([rng.permutation(pool)[:kl] for _ in range(B)])
    di[:, kd - 2:] = -1                   # under-filled dense lists
    li[0, :] = -1                         # an empty lex list
    di, li = di.astype(np.int32), li.astype(np.int32)
    ds = np.sort(rng.random((B, kd)).astype(np.float32))[:, ::-1].copy()
    ls = np.sort(rng.random((B, kl)).astype(np.float32))[:, ::-1].copy()
    js, ji = j_rrf_fuse(jnp.asarray(ds), jnp.asarray(di), jnp.asarray(ls),
                        jnp.asarray(li), k, 60.0)
    ps, pi = rrf_fuse(torch.from_numpy(ds), torch.from_numpy(di),
                      torch.from_numpy(ls), torch.from_numpy(li), k, 60)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_qidf_of_matches_reference():
    from repro.kernels.hybrid_score.ref import qidf_of as j_qidf_of
    idf = np.linspace(0.1, 3.0, 10).astype(np.float32)
    qt = np.array([[0, 9, -1, 4], [-1, -1, 3, 10]], np.int32)
    np.testing.assert_array_equal(
        qidf_of(torch.from_numpy(idf), torch.from_numpy(qt)).numpy(),
        np.asarray(j_qidf_of(jnp.asarray(idf), jnp.asarray(qt))))


# ---------------------------------------------------------------------------
# lexical-path leakage impossibility (twin of test_hybrid.py's grid)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("mode", ["wsum", "rrf"])
def test_lexical_leakage_impossible(seed, mode):
    """Adversarial donors: rows in ANOTHER tenant carry EXACTLY the query's
    terms at maximal weight -- the highest BM25 score in the arena. They
    must never surface, and the k-list must not under-fill."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(80, 300))
    d, v, t_lanes, k = 8, 32, 4, 12
    q_terms_row = rng.integers(0, v, 3).astype(np.int32)
    a = _arena(rng, n, d, v, t_lanes)
    a["acl"] = rng.integers(1, 16, n).astype(np.uint32)
    donors = rng.random(n) < 0.5
    a["tenant"][donors] = 3
    a["terms"][donors, :3] = q_terms_row
    a["lexnorm"][donors, :3] = 10.0
    pred = Predicate(tenant=1, acl_bits=int(rng.integers(1, 16)))
    B = 4
    q = rng.standard_normal((B, d)).astype(np.float32)
    qterms = np.tile(q_terms_row, (B, 1)).astype(np.int32)
    gids = np.zeros(B, np.int32)
    s_p, slots = _port(a, q, gids, [pred], qterms, k, mode)
    slots = slots.numpy()
    ok = ((a["tenant"] == 1) & (a["acl"] & pred.acl_bits != 0)
          & (a["updated_at"] >= pred.min_ts))
    for b in range(B):
        got = slots[b][slots[b] >= 0]
        assert ok[got].all(), (f"LEAK: a row outside the predicate group "
                               f"surfaced on the lexical path (row {b})")
        assert len(got) == min(k, int(ok.sum()))     # and no under-fill
    s_r, i_r = _ref(a, q, gids, [pred], qterms, k, mode)
    assert_topk_agree(s_p.numpy(), slots, np.asarray(s_r), np.asarray(i_r))


def test_wrapper_takes_the_plain_scan_only_for_cpu_tensors(monkeypatch):
    """CPU tensors take the streaming scan and never the kernel wrapper;
    the kernel wrapper refuses CPU tensors; any other device raises."""
    from repro_torch.kernels.hybrid_score import ops as ops_mod
    calls = []
    monkeypatch.setattr(ops_mod, "hybrid_score_cuda",
                        lambda *a, **kw: calls.append(kw) or ("s", "i"))
    rng = np.random.default_rng(0)
    a, q, gids, preds, qterms = _inputs(rng, 2, 50, 8, 2)
    _port(a, q, gids, preds, qterms, 5, "wsum")
    assert calls == []                             # CPU: streaming scan
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        hyb_mod.hybrid_score_cuda(x, x, x, x, x, x, x, x, x, 2)
    meta_t = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="no hybrid engine"):
        hybrid_score(meta_t, meta_t, meta_t[:, 0], meta_t[:, 0],
                     meta_t[:, 0], meta_t[:, 0], meta_t, meta_t, meta_t[0],
                     meta_t[:, 0], meta_t, meta_t, 2)
    assert hyb_mod.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the front door: RagDB with a lexical arena, reference vs port
# ---------------------------------------------------------------------------

CAP, DIM = 4096, 64                                   # rag_unified.REDUCED
CCFG = dict(n_docs=2000, dim=64, n_tenants=4, n_categories=4)   # _CORPUS
COUNTERS = ("device_calls", "queries", "hot_queries", "rows_scanned",
            "fused_groups", "fused_scans", "padded_groups", "padded_rows",
            "terms_scanned")


def _dbs(seed=0):
    jdb = JRagDB(JStoreConfig(capacity=CAP, dim=DIM),
                 lexical_cfg=JLexicalConfig())
    jc = j_make_corpus(JCorpusConfig(seed=seed, **CCFG))
    jdb.ingest(jc)
    tdb = RagDB(StoreConfig(capacity=CAP, dim=DIM),
                lexical_cfg=LexicalConfig(), device="cpu")
    tc = make_corpus(CorpusConfig(seed=seed, **CCFG), device="cpu")
    tdb.ingest(tc)
    return jdb, tdb, tc


def _hybrid_chains(db, q, terms, mode, k=5):
    spec = [Principal(0, 0b11), Principal(1, 0xFF), Principal(2, 0b100),
            Principal(3, 0xFF)]
    out = []
    for r in range(len(q)):
        b = db.session(spec[r % 4]).search(q[r]).match(terms[r])
        if mode is not None:
            b = b.fuse(mode, **(W if mode == "wsum" else {}))
        out.append(b.limit(k))
    return out


def _key(key):
    pred, *rest = key
    return (dataclasses.astuple(pred), *rest)


@pytest.mark.parametrize("mode", [None, "wsum", "rrf"])
def test_front_door_hybrid_batch_matches_reference(mode):
    """8 match() requests in 4 predicate groups fuse into ONE scan on both
    sides: same plans, explain text, results and counters."""
    jdb, tdb, tc = _dbs()
    q, terms, _ = make_keyword_queries(CorpusConfig(**CCFG), tc, 8, seed=5)
    jplans = [b.plan() for b in _hybrid_chains(jdb, q, terms, mode)]
    tplans = [b.plan() for b in _hybrid_chains(tdb, q, terms, mode)]
    for jp, tp in zip(jplans, tplans):
        assert tp.engine == jp.engine == "hybrid"
        assert _key(tp.group_key) == _key(jp.group_key)
        assert tp.fuse_key == jp.fuse_key and tp.lex == jp.lex
        assert tp.explain() == jp.explain()
    js, jsl, jt = jdb.execute(jplans)
    ts, tsl, tt = tdb.execute(tplans)
    assert_topk_agree(ts, tsl, js, jsl)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    for c in COUNTERS:
        assert getattr(tdb.stats, c) == getattr(jdb.stats, c), c
    assert tdb.stats.fused_scans == 1 and tdb.stats.device_calls == 1
    assert tdb.stats.terms_scanned == CAP * 16
    tl, jl = tdb.explain().splitlines(), jdb.explain().splitlines()
    assert [ln for ln in tl if "lexical:" in ln] == \
        [ln for ln in jl if "lexical:" in ln]
    assert tl[4:6] == jl[4:6]                 # exec stats, grouped scan


def test_hybrid_never_fuses_with_dense_groups():
    jdb, tdb, tc = _dbs(1)
    q, terms, _ = make_keyword_queries(CorpusConfig(**CCFG), tc, 2, seed=6)
    for db in (jdb, tdb):
        admin = db.admin_session()
        hyb = admin.search(q[0]).match(terms[0]).limit(5).plan()
        dense = admin.search(q[1]).limit(5).plan()
        assert hyb.fuse_key != dense.fuse_key
        assert hyb.lex == ("wsum", 1, 1.0, 1.0) and dense.lex is None
        calls0 = db.stats.device_calls
        db.execute([hyb, dense], use_cache=False)
        assert db.stats.device_calls - calls0 == 2


@pytest.mark.parametrize("probe", ["match_using_ref", "match_using_cuda",
                                   "hybrid_without_match", "fuse_without_match",
                                   "fuse_bad_mode", "match_no_lex",
                                   "match_nothing"])
def test_planner_refusals_match_reference(probe):
    jdb, tdb, _ = _dbs(2)
    q = np.ones(DIM, np.float32)
    for db in (jdb, tdb):
        b = db.admin_session().search(q)
        if probe == "match_using_ref":
            with pytest.raises(ValueError, match="hybrid engine"):
                b.match([3]).using("ref").plan()
        elif probe == "match_using_cuda":
            if db is jdb:
                continue                    # the reference has no "cuda"
            with pytest.raises(ValueError, match="hybrid engine"):
                b.match([3]).using("cuda").plan()
        elif probe == "hybrid_without_match":
            with pytest.raises(ValueError, match="match\\(\\) clause"):
                b.using("hybrid").plan()
        elif probe == "fuse_without_match":
            with pytest.raises(ValueError, match="fuse\\(\\) requires"):
                b.fuse("rrf").plan()
        elif probe == "fuse_bad_mode":
            with pytest.raises(ValueError, match="fusion mode"):
                b.fuse("max")
        elif probe == "match_no_lex":
            plain = (JRagDB(JStoreConfig(capacity=64, dim=8)) if db is jdb
                     else RagDB(StoreConfig(capacity=64, dim=8), device="cpu"))
            with pytest.raises(ValueError, match="lexical arena"):
                plain.admin_session().search(np.zeros(8, np.float32)).match(
                    [1])
        else:
            with pytest.raises(ValueError, match="no valid terms"):
                b.match([-5, 1 << 20])


def _one_doc(doc_id, term, torch_side):
    rng = np.random.default_rng(doc_id)
    emb = rng.standard_normal((1, DIM)).astype(np.float32)
    cols = dict(tenant=np.zeros(1, np.int32), category=np.zeros(1, np.int32),
                updated_at=np.full(1, JCorpusConfig(**CCFG).now_ts, np.int32),
                doc_id=np.asarray([doc_id], np.int32),
                terms=np.asarray([[term]], np.int32),
                tfs=np.full((1, 1), 2, np.int32))
    if torch_side:
        return DocBatch(emb=torch.from_numpy(emb),
                        acl=torch.tensor([-1], dtype=torch.int32),
                        **{k: torch.from_numpy(v) for k, v in cols.items()})
    return JDocBatch(emb=jnp.asarray(emb),
                     acl=jnp.asarray([0xFFFFFFFF], jnp.uint32),
                     **{k: jnp.asarray(v) for k, v in cols.items()})


@pytest.mark.parametrize("mode", ["wsum", "rrf"])
def test_cache_misses_after_a_lexical_write(mode):
    """A lexical write makes the pre-write entry unreachable, and the
    written doc -- the only carrier of the matched term -- is the new
    top-1, on both sides; a stats-only change misses too."""
    jdb, tdb, tc = _dbs(3)
    q, _, _ = make_keyword_queries(CorpusConfig(**CCFG), tc, 1, seed=3)
    unused = np.nonzero(tdb.lex.stats.df == 0)[0]
    np.testing.assert_array_equal(tdb.lex.stats.df, jdb.lex.stats.df)
    u = int(unused[-1])
    out = []
    for db, torch_side in ((jdb, False), (tdb, True)):
        admin = db.admin_session()
        run = lambda: admin.search(q[0]).match([u]).fuse(mode).limit(5).run()
        r0 = run()
        assert not r0.cached and run().cached
        db.ingest(_one_doc(990_000, u, torch_side))
        r1 = run()
        assert not r1.cached, "stale hybrid hit across a lexical write"
        # wsum: the sole carrier is the top-1; rrf: it ties the dense
        # list's top-1 at rank 1 and sorts right after it
        top = 1 if mode == "wsum" else 2
        assert db.log.slot_of(990_000) in r1.slots[0][:top].tolist()
        db.lex.stats.add(np.asarray([[u]]), np.asarray([[3]]))
        r2 = run()
        assert not r2.cached, "stale hit across a stats-only change"
        out.append((r1, r2))
    for jr, tr in zip(*out):
        assert_topk_agree(tr.scores, tr.slots, jr.scores, jr.slots)


def _lex_fp(db) -> dict:
    st, lx = db.lex.stats, db.lex.snapshot()
    return {"df": np.asarray(st.df).copy(), "n_docs": st.n_docs,
            "total_len": st.total_len, "version": st.version,
            "commits": db.lex.commit_count,
            "terms": np.asarray(lx["terms"]).copy(),
            "tfs": np.asarray(lx["tfs"]).copy(),
            "commit_count": db.log.commit_count}


def _fp_equal(a, b):
    return all(np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
               else a[k] == b[k] for k in a)


def _crash_dbs():
    small = dict(n_docs=48, dim=8, n_tenants=2, n_categories=2,
                 vocab_size=64, doc_terms=4, n_entity_terms=8)
    jdb = JRagDB(JStoreConfig(capacity=96, dim=8),
                 lexical_cfg=JLexicalConfig(vocab_size=64, doc_terms=4))
    jdb.ingest(j_make_corpus(JCorpusConfig(**small)))
    jdb.delete([40, 41, 42])
    tdb = RagDB(StoreConfig(capacity=96, dim=8),
                lexical_cfg=LexicalConfig(vocab_size=64, doc_terms=4),
                device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**small), device="cpu"))
    tdb.delete([40, 41, 42])
    return jdb, tdb


def _write(db, op, torch_side):
    if op == "delete":
        db.log.delete([3, 4])
        return
    rng = np.random.default_rng(11)
    n = 4
    cols = dict(emb=rng.standard_normal((n, 8)).astype(np.float32),
                tenant=np.zeros(n, np.int32), category=np.zeros(n, np.int32),
                updated_at=np.full(n, 5, np.int32),
                doc_id=np.asarray([100, 101, 102, 103], np.int32),
                terms=rng.integers(0, 64, (n, 4)).astype(np.int32),
                tfs=rng.integers(1, 4, (n, 4)).astype(np.int32))
    if torch_side:
        db.log.ingest(DocBatch(acl=torch.full((n,), -1, dtype=torch.int32),
                               **{k: torch.from_numpy(v)
                                  for k, v in cols.items()}))
    else:
        db.log.ingest(JDocBatch(acl=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
                                **{k: jnp.asarray(v) for k, v in cols.items()}))


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("op", ["ingest", "delete"])
def test_crash_around_the_lex_step_then_recover(op, point):
    """A crash at every write step, the lex step included, then
    `recover()`: the lexical state is exactly the pre- or post-write state
    (never torn) and equals the reference's after the same crash."""
    from repro.serving.faults import CrashError as JCrashError
    from repro.serving.faults import FaultPlan as JFaultPlan
    from repro.serving.faults import FaultRule as JFaultRule
    jdb, tdb = _crash_dbs()
    pre = _lex_fp(tdb)
    twin = _crash_dbs()[1]
    _write(twin, op, True)
    post = _lex_fp(twin)
    outcomes = []
    for db, torch_side, plan, rule, crash in (
            (jdb, False, JFaultPlan, JFaultRule, JCrashError),
            (tdb, True, FaultPlan, FaultRule, CrashError)):
        db.log.faults = plan(0, {f"txn.{op}.{point}": rule(at=(0,))})
        with pytest.raises(crash):
            _write(db, op, torch_side)
        outcomes.append(db.log.recover())
        db.log.faults = None
    assert outcomes[0] == outcomes[1]
    rec = _lex_fp(tdb)
    assert _fp_equal(rec, pre) or _fp_equal(rec, post)
    if point in ("prepare", "intent"):
        assert _fp_equal(rec, pre)
    else:
        assert _fp_equal(rec, post) and outcomes[1] == "rolled-forward"
    assert _fp_equal(_lex_fp(jdb), rec)
