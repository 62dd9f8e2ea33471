"""The arena-scan kernel's lexical stage, emulated on the CPU, against the
port's `bm25_scores` and the JAX reference's on the same numpy inputs.

In its lexical specs (FUSED: wsum, BOTH: rrf) the kernel
(``csrc/arena_scan.cuh``, `lexical_stage`) computes BM25 only for the
(query row, arena row) pairs that pass the mask: it compacts them into one
list per query row, hands pair p of the lists to thread p mod 256, reads a
pair's lanes in 16-byte pieces of four and its query terms padded with
(-1, 0) to a multiple of four. `ref.lexical_pairs`, `ref.bm25_pairs` and
`ref.lexical_stage` emulate that. The lists must stay bit-identical to the
plain version's, so every kept pair's BM25 must be the plain chain's IEEE
value: these tests compare bits, with no tolerance. The kernel itself runs
only on the card, where chip_smoke.py holds it to its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.arena_scan.stages import bm25_scores as j_bm25_scores
from repro_torch.kernels.arena_scan.ref import (LEX_THREADS, NO_ROW,
                                                arena_scan_ref, bm25_pairs,
                                                lexical_pairs, lexical_stage)
from repro_torch.kernels.arena_scan.stages import (NEG_INF, ScanSpec,
                                                   bm25_scores, dense_scores,
                                                   tile_mask, topk_ordered)

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TILE = 256          # the kernel's tile rows
SEL = 8             # query rows a lexical stage covers


def _lex(rng, n, b, T, QT, v=24):
    """numpy lanes (n, T) with empty lanes (-1) and zero weights on them,
    query terms (b, QT) with -1 padding in the last quarter of the columns
    and idf 0 there; a small vocabulary, so rows hit several query terms."""
    terms = rng.integers(-1, v, (n, T)).astype(np.int32)
    lexnorm = np.where(terms >= 0, rng.random((n, T)) * 2,
                       0).astype(np.float32)
    qterms = rng.integers(0, v, (b, QT)).astype(np.int32)
    qidf = (rng.random((b, QT)) * 3).astype(np.float32)
    if QT >= 4:
        qterms[:, QT - QT // 4:] = -1
        qidf[:, QT - QT // 4:] = 0.0
    return terms, lexnorm, qterms, qidf


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _pairs_vs_plain(terms, lexnorm, qterms, qidf, keep):
    """The emulated lexical stage's BM25 on the kept pairs of ``keep`` (b,
    n) against the port's and the reference's full BM25 at those pairs,
    bit for bit. Returns the number of kept pairs."""
    t = [torch.from_numpy(a) for a in (terms, lexnorm, qterms, qidf)]
    j, r, _ = lexical_pairs(torch.from_numpy(keep))
    got = bm25_pairs(t[0][r], t[1][r], t[2][j], t[3][j])
    port = bm25_scores(*t)[j, r]
    ref = np.asarray(j_bm25_scores(*(jnp.asarray(a) for a in (
        terms, lexnorm, qterms, qidf))))[j.numpy(), r.numpy()]
    np.testing.assert_array_equal(_bits(got), _bits(port))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    return j.numel()


@pytest.mark.parametrize("QT", [1, 4, 16])
@pytest.mark.parametrize("T", [1, 16, 32])
def test_bm25_pairs_match_port_and_reference(T, QT):
    """Every kept pair's BM25, as the kernel computes it (T % 4 == 0: the
    16-byte lane pieces and the padded query terms; T = 1: one lane at a
    time), equals the plain chain's of the port and of the reference."""
    rng = np.random.default_rng(100 * T + QT)
    lex = _lex(rng, 300, 11, T, QT)
    keep = rng.random((11, 300)) < 0.4
    assert _pairs_vs_plain(*lex, keep) == keep.sum()


def _edge(case, rng):
    """(terms, lexnorm, qterms, qidf, keep) of one edge of the stage."""
    T, QT, n, b = 8, 4, 64, SEL
    terms, lexnorm, qterms, qidf = _lex(rng, n, b, T, QT, v=6)
    keep = rng.random((b, n)) < 0.5
    if case == "duplicate-query-terms":     # one term twice, two idfs
        qterms[:, 1] = qterms[:, 0]
    elif case == "term-in-two-lanes":       # a row holds a query term twice
        terms[:, 3] = terms[:, 0] = qterms[0, 0]
    elif case == "padding-vs-empty-lanes":  # -1 against -1, idf 0
        terms[::2, :4] = -1
        lexnorm[::2, :4] = 0.0
        qterms[:, 2:] = -1
        qidf[:, 2:] = 0.0
    elif case == "qidf-zero":
        qidf[:] = 0.0
    elif case == "all-masked":
        keep[:] = False
    elif case == "all-kept":
        keep[:] = True
    return terms, lexnorm, qterms, qidf, keep


EDGES = ["duplicate-query-terms", "term-in-two-lanes",
         "padding-vs-empty-lanes", "qidf-zero", "all-masked", "all-kept"]


@pytest.mark.parametrize("case", EDGES)
def test_bm25_pairs_edge_cases(case):
    rng = np.random.default_rng(EDGES.index(case))
    terms, lexnorm, qterms, qidf, keep = _edge(case, rng)
    n_pairs = _pairs_vs_plain(terms, lexnorm, qterms, qidf, keep)
    assert n_pairs == keep.sum()
    if case == "qidf-zero" and n_pairs:
        t = [torch.from_numpy(a) for a in (terms, lexnorm, qterms, qidf)]
        j, r, _ = lexical_pairs(torch.from_numpy(keep))
        got = bm25_pairs(t[0][r], t[1][r], t[2][j], t[3][j])
        assert (_bits(got) == 0).all()          # +0, never -0


@pytest.mark.parametrize("density", [0.0, 1 / 256, 0.03, 0.5, 1.0, "warp"])
def test_lexical_pairs_order_and_threads(density):
    """The pair lists hold each kept pair once and no masked one, selection
    row ascending and then tile row ascending (warp j's ballot order), and
    pair p runs on thread p mod 256 -- so threads take turns and none holds
    more than one pair more than another."""
    rng = np.random.default_rng(7)
    if density == "warp":                   # one kept pair a warp's rows
        keep = np.zeros((SEL, TILE), bool)
        for j in range(SEL):
            keep[j, np.arange(0, TILE, 32) + (j * 5) % 32] = True
    else:
        keep = rng.random((SEL, TILE)) < density
    j, r, thr = lexical_pairs(torch.from_numpy(keep))
    got = list(zip(j.tolist(), r.tolist()))
    assert got == sorted(zip(*np.nonzero(keep)))
    assert len(set(got)) == len(got) == keep.sum()
    assert thr.tolist() == [p % LEX_THREADS for p in range(len(got))]
    if got:
        per = np.bincount(thr.numpy(), minlength=LEX_THREADS)
        assert per.max() - per.min() <= 1


def _emulated_scan(spec, q, emb, meta, gids, preds, lex, k):
    """The resident kernel's lists for a lexical spec, on the CPU: per
    256-row tile and per eight query rows, the masked dense scores staged
    with NO_ROW on masked pairs, the lexical stage, the tile's top
    min(k, 256) by (score desc, index asc); then one merge and the finish
    (NEG_INF / -1 padding)."""
    terms, lexnorm, qterms, qidf = lex
    n, b = emb.shape[0], q.shape[0]
    mask = tile_mask(meta, preds, gids, spec)
    dense = dense_scores(q, emb)
    idx = torch.arange(n, dtype=torch.int32).expand(b, n)
    s_all = torch.where(mask, dense, torch.tensor(NEG_INF))
    ix_all = torch.where(mask, idx, torch.tensor(NO_ROW, dtype=torch.int32))
    cand = [([], []) for _ in range(spec.n_lists)]
    for base in range(0, n, TILE):
        stop = min(base + TILE, n)
        sigs = [[] for _ in range(spec.n_lists)]
        for r0 in range(0, b, SEL):
            s = s_all[r0:r0 + SEL, base:stop]
            ix = ix_all[r0:r0 + SEL, base:stop]
            out = lexical_stage(spec, s, ix, base, (
                terms, lexnorm, qterms[r0:r0 + SEL], qidf[r0:r0 + SEL]))
            sigs[0].append(out if spec.score == "fused" else s)
            if spec.score == "both":
                sigs[1].append(out)
        for (cs, ci), sig in zip(cand, sigs):
            ts, ti = topk_ordered(torch.cat(sig), idx[:, base:stop],
                                  min(k, TILE))
            cs.append(ts)
            ci.append(ti)
    res = []
    for cs, ci in cand:
        s, i = topk_ordered(torch.cat(cs, 1), torch.cat(ci, 1), k)
        pad = k - s.shape[1]
        s = torch.cat([s, s.new_full((b, pad), NEG_INF)], 1)
        i = torch.cat([i, i.new_full((b, pad), -1)], 1)
        res += [s, torch.where(s > NEG_INF, i, -1)]
    return res


@pytest.mark.parametrize("n,b,T,QT,k", [(700, 11, 16, 4, 10),
                                        (513, 8, 6, 3, 40),
                                        (300, 17, 32, 16, 320)])
@pytest.mark.parametrize("score", ["fused", "both"])
def test_lexical_stage_lists_match_oracle(score, n, b, T, QT, k):
    """The kernel's schedule with the compacted lexical stage returns the
    dense oracle's lists bit for bit (scores as int32, slots exact), for
    wsum's one list and rrf's two, over ragged tiles, a BLOCK_ALL group
    and k past n."""
    rng = np.random.default_rng(n + T)
    emb = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((b, 16)).astype(np.float32)
    meta = np.stack([rng.integers(-1, 3, n), rng.integers(0, 100, n),
                     rng.integers(0, 8, n), rng.integers(1, 8, n)],
                    1).astype(np.int32)
    preds = np.array([[-2, 0, -1, -1], [1, 30, 0b1011, 3], [-3, 0, -1, -1],
                      [0, 0, -1, 4]], np.int32)
    gids = rng.integers(0, 4, b).astype(np.int32)
    lex = _lex(rng, n, b, T, QT)
    args = [torch.from_numpy(a) for a in (q, emb, meta, gids, preds)]
    tlex = tuple(torch.from_numpy(a) for a in lex)
    spec = ScanSpec(score=score)
    got = _emulated_scan(spec, *args, tlex, k)
    want = arena_scan_ref(*args, k, spec=spec, lex=tlex)
    assert len(got) == len(want) == 2 * spec.n_lists
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.numpy().view(np.int32))


def test_reordered_chain_is_caught():
    """The bit comparison has teeth: a BM25 that takes the query terms
    outer and adds each hit's product straight into the sum (another
    order, the same real number) differs from the plain chain in bits on
    rows that hit several terms -- so a kernel that reordered the chain
    would fail the tests above."""
    rng = np.random.default_rng(3)
    terms, lexnorm, qterms, qidf = _lex(rng, 200, 4, 16, 16, v=5)
    lt, ll = torch.from_numpy(terms), torch.from_numpy(lexnorm)
    qt, qw = torch.from_numpy(qterms), torch.from_numpy(qidf)
    rows = torch.arange(200).repeat(4)
    qrows = torch.arange(4).repeat_interleave(200)
    good = bm25_pairs(lt[rows], ll[rows], qt[qrows], qw[qrows])
    bad = torch.zeros_like(good)
    for j in range(qt.shape[1]):
        for t in range(lt.shape[1]):
            hit = lt[rows, t] == qt[qrows, j]
            bad = bad + torch.where(hit, qw[qrows, j] * ll[rows, t], 0.0)
    assert torch.allclose(good, bad, rtol=1e-5, atol=1e-5)
    assert (_bits(good) != _bits(bad)).any()
