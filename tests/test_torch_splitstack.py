"""Parity of the port's split stack (the warm tier) with the reference's.

The six behaviours of ``tests/test_splitstack.py`` run on the port at the
REDUCED size (2,000 docs, 64 dims, 4 tenants), each also held to the
reference's `SplitStackClient` on the same corpus. Then the warm scans
themselves -- `vector_topk`, `vector_topk_filtered` and
`vector_topk_hybrid` (wsum, rrf fused, rrf lists) -- against the JAX
functions, on a tie-heavy draw whose integer-valued scores are exact in
both frameworks, so ties must break alike (toward the lower row) and the
lists must be equal exactly, chunked or not; the tier merges
(`merge_tiers`, `_rrf_merge_np`) bit for bit; the same `FaultPlan` seed
leaking the same rows under ``filter_bug_rate``; and the chunked warm scan
equal to the unchunked one.

Contract (ROADMAP North star): integers exact; f32 scores within
rtol = atol = 1e-5; slots equal except inside a run of tied scores at the
k-th place.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import executor as j_executor
from repro.core import Predicate as JPredicate
from repro.core import StoreConfig as JStoreConfig
from repro.core import splitstack as j_split
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.data.corpus import make_queries as j_make_queries
from repro.kernels.hybrid_score.ref import rrf_fuse as j_rrf_fuse
from repro_torch.api import executor as t_executor
from repro_torch.core import splitstack as t_split
from repro_torch.core.query import Predicate, unified_query
from repro_torch.core.store import StoreConfig
from repro_torch.core.transactions import TransactionLog
from repro_torch.data.corpus import CorpusConfig, make_corpus
from tests.test_torch_arena_scan import assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

N_DOCS, DIM, CAP = 2000, 64, 4096
CCFG = dict(n_docs=N_DOCS, dim=DIM, n_tenants=4, n_categories=4)


def _build(bug=0.0):
    """The port's unified log and split client, and the reference's split
    client, over one corpus."""
    ccfg = CorpusConfig(**CCFG)
    corpus = make_corpus(ccfg, device="cpu")
    log = TransactionLog(StoreConfig(capacity=CAP, dim=DIM), device="cpu")
    log.ingest(corpus)
    split = t_split.SplitStackClient(StoreConfig(capacity=CAP, dim=DIM),
                                     filter_bug_rate=bug, rng_seed=1,
                                     device="cpu")
    split.ingest(corpus)
    jsplit = j_split.SplitStackClient(JStoreConfig(capacity=CAP, dim=DIM),
                                      filter_bug_rate=bug, rng_seed=1)
    jsplit.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    return log, split, jsplit, corpus


def _queries(batch, seed):
    q = j_make_queries(JCorpusConfig(**CCFG), 1, batch=batch, seed=seed)[0]
    return np.asarray(q, np.float32)


def _jpred(p: Predicate) -> JPredicate:
    return JPredicate(tenant=p.tenant, min_ts=p.min_ts, cat_mask=p.cat_mask,
                      acl_bits=p.acl_bits)


def test_split_eventually_matches_unified():
    log, split, jsplit, _ = _build()
    q = _queries(2, 0)
    pred = Predicate(tenant=2, cat_mask=0b0011)
    s_b, i_b = unified_query(log.snapshot(), q, pred, k=5)
    s_a, i_a = split.query(q, pred, k=5)
    assert set(i_b.ravel().tolist()) == set(i_a.ravel().tolist())
    assert split.stats.round_trips >= 2       # the coordination cost
    js, ji = jsplit.query(jnp.asarray(q), _jpred(pred), k=5)
    assert_topk_agree(s_a, i_a, js, ji)
    assert split.stats.round_trips == jsplit.stats.round_trips
    assert split.stats.retries == jsplit.stats.retries


def test_split_window_positive_unified_zero():
    log, split, jsplit, _ = _build()
    rng = np.random.default_rng(0)
    split.write_gap_s = 0.002   # a 2 ms queue delay between the two commits
    ids = [0, 1, 2]
    emb = rng.standard_normal((3, DIM), dtype=np.float32)
    split.update(ids, emb, [999] * 3)
    log.update(ids, emb, [999] * 3)
    assert split.stats.inconsistency_windows_s[-1] >= 0.002
    assert log.inconsistency_window_s == 0.0
    # both commits landed: the rows read back as the reference's do
    jsplit.update(ids, emb, [999] * 3)
    np.testing.assert_array_equal(split.meta["updated_at"][:3].numpy(),
                                  np.asarray(jsplit.meta["updated_at"][:3]))
    np.testing.assert_allclose(split.emb[:3].numpy(),
                               np.asarray(jsplit.emb[:3]), rtol=1e-6,
                               atol=1e-6)
    assert split.commit_count == jsplit.commit_count == 2


def test_split_leaks_under_forced_bug():
    log, split, jsplit, corpus = _build(bug=1.0)   # the bug always fires
    tenant_of = corpus.tenant.numpy()
    q = _queries(1, 2)
    pred = Predicate(tenant=0)
    _, slots = split.query(q, pred, k=8)
    got = slots[0][slots[0] >= 0]
    assert (tenant_of[got] != 0).any(), "bugged split stack should leak"
    _, jslots = jsplit.query(jnp.asarray(q), _jpred(pred), k=8)
    np.testing.assert_array_equal(slots, jslots)    # the same rows leak
    # unified is immune to the same workload by construction
    _, slots_b = unified_query(log.snapshot(), q, pred, k=8)
    got_b = slots_b.numpy()[0]
    assert (tenant_of[got_b[got_b >= 0]] == 0).all()


def test_pushdown_matches_postfilter_without_retries():
    """Predicate pushdown (the warm-tier route) returns the same
    qualifying set as the retry-until-full post-filter path, in ONE round
    trip, and the reference's pushdown lists."""
    log, split, jsplit, _ = _build()
    q = _queries(2, 4)
    pred = Predicate(tenant=1, cat_mask=0b0110)
    s_post, i_post = split.query(q, pred, k=5)
    rt0, retry0 = split.stats.round_trips, split.stats.retries
    s_push, i_push = split.query(q, pred, k=5, pushdown=True)
    assert split.stats.round_trips == rt0 + 1
    assert split.stats.retries == retry0
    for b in range(2):
        assert set(i_push[b][i_push[b] >= 0].tolist()) == \
            set(i_post[b][i_post[b] >= 0].tolist())
    s_u, i_u = unified_query(log.snapshot(), q, pred, k=5)
    assert set(i_u.numpy().ravel().tolist()) == set(i_push.ravel().tolist())
    js, ji = jsplit.query(jnp.asarray(q), _jpred(pred), k=5, pushdown=True)
    assert s_push.dtype == np.float32 and i_push.dtype == np.int32
    assert_topk_agree(s_push, i_push, js, ji)


def test_pushdown_immune_to_app_layer_filter_bug():
    """The injected tenant-filter bug lives in the app-layer post-filter;
    pushdown evaluates the predicate inside the scan, out of its reach."""
    log, split, jsplit, corpus = _build(bug=1.0)
    tenant_of = corpus.tenant.numpy()
    q = _queries(1, 2)
    _, slots = split.query(q, Predicate(tenant=0), k=8, pushdown=True)
    got = slots[0][slots[0] >= 0]
    assert len(got) > 0 and (tenant_of[got] == 0).all()
    _, jslots = jsplit.query(jnp.asarray(q), JPredicate(tenant=0), k=8,
                             pushdown=True)
    np.testing.assert_array_equal(slots, jslots)


def test_cache_staleness_bounded_by_invalidation():
    log, split, jsplit, corpus = _build()
    rng = np.random.default_rng(3)
    q = _queries(1, 0)
    split.query(q, Predicate(), k=5)          # warm the cache
    assert len(split.cache._entries) > 0
    split.update([int(corpus.doc_id[0])],
                 rng.standard_normal((1, DIM), dtype=np.float32), [5])
    assert 0 not in split.cache._entries or split.cache.get(0) is None
    # and the TTL bounds what invalidation misses: on the injected clock
    # an entry expires once ttl_s has passed
    now = [0.0]
    split.cache = t_split.MetadataCache(ttl_s=1.0, clock=lambda: now[0])
    split.query(q, Predicate(), k=5)
    slot = next(iter(split.cache._entries))
    assert split.cache.get(slot) is not None
    now[0] = 1.0
    assert split.cache.get(slot) is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_filter_bug_leaks_the_same_rows_as_the_reference(seed):
    """filter_bug_rate installs a ``split.filter_bug`` rule on a FaultPlan
    seeded by rng_seed: the same seed fires on the same calls in both
    packages, so the same rows leak. The metadata caches never expire
    here: their TTL runs on the wall clock, and a slow test run would
    otherwise drop a row between its fetch and its filter in one package
    and not the other."""
    ccfg = CorpusConfig(**CCFG)
    split = t_split.SplitStackClient(StoreConfig(capacity=CAP, dim=DIM),
                                     filter_bug_rate=0.5, rng_seed=seed,
                                     cache_ttl_s=1e9, device="cpu")
    split.ingest(make_corpus(ccfg, device="cpu"))
    jsplit = j_split.SplitStackClient(JStoreConfig(capacity=CAP, dim=DIM),
                                      filter_bug_rate=0.5, rng_seed=seed,
                                      cache_ttl_s=1e9)
    jsplit.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    tenant_of = make_corpus(ccfg, device="cpu").tenant.numpy()
    leaks = 0
    for i in range(6):
        q = _queries(2, 10 * seed + i)
        pred = Predicate(tenant=i % 4)
        s, sl = split.query(q, pred, k=6)
        js, jsl = jsplit.query(jnp.asarray(q), _jpred(pred), k=6)
        np.testing.assert_array_equal(sl, jsl)
        np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-5)
        real = sl[sl >= 0]
        leaks += int((tenant_of[real] != i % 4).sum())
    assert split.faults.counters() == jsplit.faults.counters()
    assert leaks > 0


# ---------------------------------------------------------------------------
# the warm scans against the reference's, on a tie-heavy draw
# ---------------------------------------------------------------------------

def _tie_arena(seed, n=600, d=8, t=5, v=12):
    """Integer-valued embeddings (entries in {-1, 0, 1}, many rows repeated)
    and BM25 weights in quarters, so every score is exact in f32 in both
    frameworks and ties abound."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-1, 2, (n // 6, d)).astype(np.float32)
    emb = base[rng.integers(0, len(base), n)]
    terms = rng.integers(-1, v, (n, t)).astype(np.int32)
    lexnorm = np.where(terms >= 0, rng.integers(1, 5, (n, t)) / 4.0,
                       0.0).astype(np.float32)
    meta = {"tenant": rng.integers(-1, 3, n).astype(np.int32),
            "category": rng.integers(0, 4, n).astype(np.int32),
            "updated_at": rng.integers(0, 100, n).astype(np.int32),
            "acl": rng.integers(1, 16, n).astype(np.uint32),
            "doc_id": np.arange(n, dtype=np.int32)}
    valid = rng.random(n) < 0.9
    q = rng.integers(-1, 2, (4, d)).astype(np.float32)
    qterms = rng.integers(-1, v, (4, 3)).astype(np.int32)
    idf = rng.integers(0, 4, v).astype(np.float32)
    return emb, valid, meta, terms, lexnorm, idf, q, qterms


def _t_meta(meta):
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v) for k, v in meta.items()}


PREDS = [Predicate(), Predicate(tenant=1, min_ts=30),
         Predicate(tenant=2, cat_mask=0b0101, acl_bits=0b0011)]
CHUNKS = [None, 1, 64, 250]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_vector_topk_matches_reference_on_ties(chunk):
    emb, valid, *_, q, _ = _tie_arena(0)
    js, ji = j_split.vector_topk(jnp.asarray(emb), jnp.asarray(valid),
                                 jnp.asarray(q), 20)
    ts, ti = t_split.vector_topk(torch.from_numpy(emb),
                                 torch.from_numpy(valid), torch.from_numpy(q),
                                 20, chunk_rows=chunk)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("pi", range(len(PREDS)))
def test_vector_topk_filtered_matches_reference_on_ties(pi, chunk):
    emb, valid, meta, *_, q, _ = _tie_arena(1)
    pred = PREDS[pi]
    js, ji = j_split.vector_topk_filtered(
        jnp.asarray(emb), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(q),
        _jpred(pred).as_array(), 25)
    ts, ti = t_split.vector_topk_filtered(
        torch.from_numpy(emb), torch.from_numpy(valid), _t_meta(meta),
        torch.from_numpy(q), pred.as_array(), 25, chunk_rows=chunk)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() >= 0).any()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode,lists", [("wsum", False), ("rrf", False),
                                        ("rrf", True)])
def test_vector_topk_hybrid_matches_reference_on_ties(mode, lists, chunk):
    emb, valid, meta, terms, lexnorm, idf, q, qterms = _tie_arena(2)
    w_d, w_l = (0.5, 2.0) if mode == "wsum" else (1.0, 1.0)
    for pred in PREDS:
        # the reference's fused rrf is rrf_fuse over its own lists; it is
        # taken that way here because the jitted function's fused-rrf
        # program fails in JAX (an XLA buffer-count error) once a wsum
        # program of the same shapes has run in the process
        jout = j_split.vector_topk_hybrid(
            jnp.asarray(emb), jnp.asarray(valid),
            {k: jnp.asarray(v) for k, v in meta.items()},
            jnp.asarray(terms), jnp.asarray(lexnorm), jnp.asarray(idf),
            jnp.asarray(q), _jpred(pred).as_array(), jnp.asarray(qterms),
            15, mode, w_d, w_l, 60.0, lists or mode == "rrf")
        if mode == "rrf" and not lists:
            jout = j_rrf_fuse(*jout, 15, 60.0)
        tout = t_split.vector_topk_hybrid(
            torch.from_numpy(emb), torch.from_numpy(valid), _t_meta(meta),
            torch.from_numpy(terms), torch.from_numpy(lexnorm),
            torch.from_numpy(idf), torch.from_numpy(q), pred.as_array(),
            torch.from_numpy(qterms), 15, mode, w_d, w_l, 60.0, lists,
            chunk_rows=chunk)
        assert len(tout) == len(jout) == (4 if lists else 2)
        for t, j in zip(tout, jout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("chunk", [7, 64, 1000])
def test_chunked_warm_scan_equals_unchunked(chunk):
    """Unit-norm float data: chunking the warm scan changes neither the
    lists nor their scores (the running merge keeps the selection rule)."""
    rng = np.random.default_rng(chunk)
    n = 1500
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[700:760] = emb[100:160]                  # exact duplicates too
    meta = {"tenant": rng.integers(-1, 4, n).astype(np.int32),
            "category": rng.integers(0, 4, n).astype(np.int32),
            "updated_at": rng.integers(0, 100, n).astype(np.int32),
            "acl": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            "doc_id": np.arange(n, dtype=np.int32)}
    meta["tenant"][700:760] = meta["tenant"][100:160]
    terms = rng.integers(-1, 40, (n, 8)).astype(np.int32)
    lexnorm = rng.random((n, 8)).astype(np.float32)
    args = (torch.from_numpy(emb), torch.ones(n, dtype=torch.bool),
            _t_meta(meta))
    q = torch.from_numpy(np.concatenate([emb[100:103],
                                         rng.standard_normal((3, DIM))
                                         .astype(np.float32)]))
    qterms = torch.from_numpy(rng.integers(-1, 40, (6, 4)).astype(np.int32))
    idf = torch.rand(40)
    for pred in PREDS:
        pa = pred.as_array()
        a = t_split.vector_topk_filtered(*args, q, pa, 12, chunk_rows=None)
        b = t_split.vector_topk_filtered(*args, q, pa, 12, chunk_rows=chunk)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        for mode in ("wsum", "rrf"):
            lex = (torch.from_numpy(terms), torch.from_numpy(lexnorm), idf)
            a = t_split.vector_topk_hybrid(*args, *lex, q, pa, qterms, 12,
                                           mode, 0.7, 1.3, 60.0, True
                                           if mode == "rrf" else False,
                                           chunk_rows=None)
            b = t_split.vector_topk_hybrid(*args, *lex, q, pa, qterms, 12,
                                           mode, 0.7, 1.3, 60.0, True
                                           if mode == "rrf" else False,
                                           chunk_rows=chunk)
            for x, y in zip(a, b):
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the tier merges
# ---------------------------------------------------------------------------

def _lists(rng, b, k, ties):
    """(B, k) descending score lists with -1 / NEG_INF tails and, with
    ``ties``, scores drawn from a handful of values."""
    neg = np.float32(np.finfo(np.float32).min)
    vals = (rng.integers(0, 4, (b, k)) / 4.0 if ties
            else rng.random((b, k))).astype(np.float32)
    s = -np.sort(-vals, axis=1)
    i = rng.permutation(50)[:k][None, :].repeat(b, 0).astype(np.int32)
    fill = rng.integers(0, k + 1, b)
    for r in range(b):
        s[r, fill[r]:] = neg
        i[r, fill[r]:] = -1
    return s, i


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
def test_merge_tiers_bit_for_bit(seed, ties):
    rng = np.random.default_rng(seed)
    for k in (1, 5, 8):
        hs, hi = _lists(rng, 6, k, ties)
        ws, wi = _lists(rng, 6, k, ties)
        for kk in (k, max(k - 2, 1)):
            out_t = t_executor.merge_tiers(hs, hi, ws, wi, kk)
            out_j = j_executor.merge_tiers(hs, hi, ws, wi, kk)
            for a, b in zip(out_t, out_j):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


@pytest.mark.parametrize("seed", range(4))
def test_rrf_merge_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    k = 6
    d_s, d_i = _lists(rng, 5, k, True)
    l_s, l_i = _lists(rng, 5, k, True)
    dt = rng.integers(0, 2, d_i.shape).astype(np.int32)
    lt = rng.integers(0, 2, l_i.shape).astype(np.int32)
    l_i[:, :3] = d_i[:, :3]                       # shared candidates
    lt[:, :2] = dt[:, :2]
    for kk in (k, 3):
        out_t = t_executor._rrf_merge_np(d_s, d_i, dt, l_s, l_i, lt, kk, 60.0)
        out_j = j_executor._rrf_merge_np(d_s, d_i, dt, l_s, l_i, lt, kk, 60.0)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
