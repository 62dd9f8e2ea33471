"""The arena scan past its old wrapper caps: lanes and query terms past 64
(the lexical modes take any T and QT whose launch fits a block's shared
memory, `kernel.scan_geometry`; the kernel at T 128 / QT 128 is held to
its plain version on the card, ``chip_smoke.py``'s hybrid_kernel), and
batches of more than `MAX_GROUPS`
predicate groups (`kernel.split_by_groups`: rows ordered by group, one
launch a range of groups, gids rebased, lists scattered back), driven here
with a small cap around the plain scan and held to one unsplit plain scan;
past 64 lanes or query terms the port's hybrid scan against the
reference's oracle (``repro.kernels.hybrid_score.ref``) on the same numpy
inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.query import Predicate as JPredicate
from repro.core.query import stack_predicates as j_stack
from repro.kernels.hybrid_score.ref import hybrid_score_ref as j_hybrid_ref
from repro_torch.core.query import Predicate, stack_predicates
from repro_torch.kernels.arena_scan import kernel as K
from repro_torch.kernels.arena_scan.ref import arena_scan_ref
from repro_torch.kernels.arena_scan.stages import ScanSpec
from repro_torch.kernels.hybrid_score.ops import hybrid_score
from tests.test_torch_arena_scan import assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


def _scan_inputs(rng, B, N, D, G, T, QT):
    emb = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    meta = torch.from_numpy(np.stack([
        rng.integers(-1, 5, N), rng.integers(0, 1000, N),
        rng.integers(0, 32, N), rng.integers(-(1 << 31), 1 << 31, N)],
        axis=1).astype(np.int32))
    preds = torch.from_numpy(np.stack([
        rng.choice([-2, 0, 1, 2, 3, 4], G), rng.integers(0, 500, G),
        rng.integers(-(1 << 31), 1 << 31, G),
        rng.integers(-(1 << 31), 1 << 31, G)], axis=1).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    gids = torch.from_numpy(rng.integers(0, G, B).astype(np.int32))
    terms = rng.integers(-1, 64, (N, T)).astype(np.int32)
    lexnorm = np.where(terms >= 0, rng.random((N, T)) * 2, 0)
    qterms = rng.integers(-1, 64, (B, QT)).astype(np.int32)
    qidf = np.where(qterms >= 0, rng.random((B, QT)) * 5, 0)
    lex = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        terms, lexnorm.astype(np.float32), qterms, qidf.astype(np.float32)))
    return q, emb, meta, gids, preds, lex


@pytest.mark.parametrize("cap", [1, 5, 7])
@pytest.mark.parametrize("score", ["dense", "fused", "both"])
def test_split_by_groups_matches_one_plain_scan(score, cap):
    """23 groups in ranges of ``cap`` (some ranges without a row): each
    range's scan sees only its rows, rebased gids and its predicates, and
    the scattered lists equal one scan of the whole batch."""
    rng = np.random.default_rng(cap * 10 + len(score))
    spec = ScanSpec(score=score)
    B, N, D, G, k = 40, 300, 16, 23, 9
    q, emb, meta, gids, preds, lex = _scan_inputs(rng, B, N, D, G, 12, 7)
    gids[gids % 5 == 3] = 0                   # leave some groups empty
    lex = lex if spec.has_lex else None
    calls = []

    def scan(q_, g_, p_, lex_):
        assert int(g_.min()) >= 0 and int(g_.max()) < p_.shape[0] <= cap
        calls.append(q_.shape[0])
        return arena_scan_ref(q_, emb, meta, g_, p_, k, spec=spec, lex=lex_)

    got = K.split_by_groups(scan, q, gids, preds, lex, cap=cap)
    want = arena_scan_ref(q, emb, meta, gids, preds, k, spec=spec, lex=lex)
    assert sum(calls) == B and len(calls) <= -(-G // cap)
    assert len(got) == len(want) == 2 * spec.n_lists
    for s_g, i_g, s_w, i_w in zip(got[::2], got[1::2], want[::2],
                                  want[1::2]):
        assert s_g.shape == (B, k) and i_g.dtype == torch.int32
        np.testing.assert_allclose(s_g.numpy(), s_w.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert (i_g == i_w).all()


@pytest.mark.parametrize("score", ["fused", "both"])
def test_lexical_launch_takes_any_terms_that_fit(score):
    """T and QT past 64 launch when a block's shared memory holds the
    batch's query terms (QT 128 at 64 query rows a block); the wrapper's
    check raises, naming the fit, only when no launch does."""
    spec = ScanSpec(score=score)
    K._lexical_fits(spec, 64, 4, 10, None, 128)
    K._lexical_fits(spec, 8, 808, 300, 256, 1024)
    with pytest.raises(ValueError, match="fits a block's shared memory"):
        K._lexical_fits(spec, 8, 4, 10, None, 4096)


def _j_preds(preds):
    return j_stack([JPredicate(tenant=p.tenant, min_ts=p.min_ts,
                               cat_mask=p.cat_mask, acl_bits=p.acl_bits)
                    for p in preds])


@pytest.mark.parametrize("T,QT", [(72, 4), (4, 72)])
@pytest.mark.parametrize("mode", ["wsum", "rrf"])
def test_hybrid_past_64_lanes_or_terms_matches_reference(mode, T, QT):
    """The port's hybrid scan (its CPU path: the kernel's plain version)
    past 64 lanes, and past 64 query terms, against the reference's
    oracle (whose BM25 is a loop of T x QT array steps: T 128 with QT 128
    is held to the plain version on the card instead)."""
    rng = np.random.default_rng(T * 100 + QT)
    B, N, D, G, k = 6, 500, 32, 3, 10
    terms = rng.integers(-1, 64, (N, T)).astype(np.int32)
    cols = {
        "emb": rng.standard_normal((N, D)).astype(np.float32),
        "tenant": rng.integers(-1, 4, N).astype(np.int32),
        "updated_at": rng.integers(0, 1000, N).astype(np.int32),
        "category": rng.integers(0, 32, N).astype(np.int32),
        "acl": rng.integers(1, 1 << 32, N, dtype=np.uint64).astype(np.uint32),
        "terms": terms,
        "lexnorm": np.where(terms >= 0, rng.random((N, T)) * 2,
                            0).astype(np.float32),
        "idf": (rng.random(64) * 5).astype(np.float32)}
    q = rng.standard_normal((B, D)).astype(np.float32)
    qterms = rng.integers(-1, 64, (B, QT)).astype(np.int32)
    qidf = np.where(qterms >= 0, cols["idf"][np.clip(qterms, 0, None)],
                    0).astype(np.float32)
    gids = rng.integers(0, G, B).astype(np.int32)
    preds = [Predicate(tenant=i % 3, min_ts=100,
                       cat_mask=int(rng.integers(1, 1 << 32)) | (1 << 31))
             for i in range(G)]
    meta = np.stack([cols["tenant"], cols["updated_at"], cols["category"],
                     cols["acl"].view(np.int32)], axis=1).astype(np.int32)
    kw = dict(mode=mode, w_dense=0.8, w_lex=1.7)
    s_r, i_r = j_hybrid_ref(jnp.asarray(q), jnp.asarray(cols["emb"]),
                            jnp.asarray(meta), jnp.asarray(terms),
                            jnp.asarray(cols["lexnorm"]), jnp.asarray(gids),
                            _j_preds(preds), jnp.asarray(qterms),
                            jnp.asarray(qidf), k, **kw)
    t = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                   else x.copy())
    s_p, i_p = hybrid_score(
        t(q), t(cols["emb"]), t(cols["tenant"]), t(cols["updated_at"]),
        t(cols["category"]), t(cols["acl"]), t(terms), t(cols["lexnorm"]),
        t(cols["idf"]), t(gids), stack_predicates(preds), t(qterms), k, **kw)
    assert_topk_agree(s_p.numpy(), i_p.numpy(), np.asarray(s_r),
                      np.asarray(i_r))
