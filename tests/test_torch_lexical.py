"""Parity of the port's lexical arena with the JAX reference's.

The same numpy lanes go through `repro.index.lexical` and
`repro_torch.index.lexical` (on the CPU): `sanitize_lanes`, `LexicalStats`
and `LexicalArena` over a write / overwrite / clear / slot-reuse sequence.
Integers (df, n_docs, total_len, version, commit counts, lanes) must be
exactly equal; lexnorm and idf within rtol = atol = 1e-5 (the two
frameworks may round the BM25 length normalisation differently). The
port's `device_corpus` lanes are checked against `_doc_lexical`'s
distributions.
"""
import numpy as np
import pytest
import torch

from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.index.lexical import LexicalArena as JArena
from repro.index.lexical import LexicalConfig as JConfig
from repro.index.lexical.arena import LexicalStats as JStats
from repro.index.lexical.arena import sanitize_lanes as j_sanitize
from repro_torch.data.corpus import CorpusConfig, device_corpus
from repro_torch.index.lexical import (LexicalArena, LexicalConfig,
                                       LexicalStats, sanitize_lanes)

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-5


def _lanes(rng, m, t, v):
    """Raw caller lanes: out-of-vocab ids, negatives, duplicates in a row,
    zero and negative tfs."""
    terms = rng.integers(-3, v + 4, (m, t))
    terms[:, 1] = terms[:, 0]                      # a duplicate per row
    tfs = rng.integers(-1, 5, (m, t))
    return terms, tfs


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("t_in,doc_terms", [(6, 6), (9, 6), (3, 5)])
def test_sanitize_lanes_matches_reference(seed, t_in, doc_terms):
    rng = np.random.default_rng(seed)
    terms, tfs = _lanes(rng, 40, t_in, 32)
    jt, jf = j_sanitize(terms, tfs, doc_terms=doc_terms, vocab_size=32)
    tt, tf = sanitize_lanes(terms, tfs, doc_terms=doc_terms, vocab_size=32,
                            device="cpu")
    assert tt.dtype == torch.int32 and tf.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tf.numpy(), jf)


def _assert_stats_equal(ps: LexicalStats, js: JStats):
    np.testing.assert_array_equal(ps.df, js.df)
    assert (ps.n_docs, ps.total_len, ps.version) == (js.n_docs, js.total_len,
                                                     js.version)
    assert ps.avgdl == js.avgdl
    np.testing.assert_allclose(ps.idf("cpu").numpy(), np.asarray(js.idf()),
                               rtol=TOL, atol=TOL)


def _assert_arenas_equal(pa: LexicalArena, ja: JArena):
    _assert_stats_equal(pa.stats, ja.stats)
    assert pa.commit_count == ja.commit_count
    ps, js = pa.snapshot(), ja.snapshot()
    np.testing.assert_array_equal(ps["terms"].numpy(), np.asarray(js["terms"]))
    np.testing.assert_array_equal(ps["tfs"].numpy(), np.asarray(js["tfs"]))
    np.testing.assert_allclose(ps["lexnorm"].numpy(), np.asarray(js["lexnorm"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ps["idf"].numpy(), np.asarray(js["idf"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("doc_terms", [4, 16])
def test_arena_write_sequence_matches_reference(seed, doc_terms):
    """write -> overwrite (slot reuse returns the old lanes' stats) ->
    clear -> rewrite of cleared slots -> empty-lane write, step by step."""
    rng = np.random.default_rng(seed)
    cap, v = 64, 48
    jcfg = JConfig(vocab_size=v, doc_terms=doc_terms)
    pcfg = LexicalConfig(vocab_size=v, doc_terms=doc_terms)
    ja, pa = JArena(cap, jcfg), LexicalArena(cap, pcfg, device="cpu")
    _assert_arenas_equal(pa, ja)
    slots = rng.permutation(cap)[:40]
    steps = [
        ("write", slots[:30]),
        ("write", slots[20:40]),           # overwrite 10 live slots
        ("clear", slots[:12]),
        ("write", slots[:6]),              # recycled slots
        ("empty", slots[30:34]),           # terms=None writes empty lanes
    ]
    for op, idx in steps:
        if op == "write":
            terms, tfs = _lanes(rng, len(idx), doc_terms + 1, v)
            ja.write_rows(idx, terms, tfs)
            pa.write_rows(idx, terms, tfs)
        elif op == "clear":
            ja.clear_rows(idx)
            pa.clear_rows(idx)
        else:
            ja.write_rows(idx, None, None)
            pa.write_rows(idx, None, None)
        _assert_arenas_equal(pa, ja)
        jt, jf = ja.rows(idx)
        pt, pf = pa.rows(idx)
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pf, jf)


def test_snapshot_is_immutable_across_writes():
    """MVCC: a held snapshot keeps its lanes after later writes."""
    pa = LexicalArena(8, LexicalConfig(vocab_size=16, doc_terms=2),
                      device="cpu")
    pa.write_rows([1], [[3, 4]], [[1, 1]])
    snap = pa.snapshot()
    before = {k: v.clone() for k, v in snap.items()}
    pa.write_rows([1, 2], [[5, 6], [7, -1]], [[2, 2], [1, 0]])
    pa.clear_rows([1])
    for k, v in before.items():
        assert torch.equal(snap[k], v), k
    assert pa.snapshot()["terms"][2].tolist() == [7, -1]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_stats_add_remove_accept_tensors_and_arrays(device):
    """The stats take lanes as numpy or as tensors (the arena hands them
    device tensors), with the same result as the reference."""
    rng = np.random.default_rng(7)
    terms = rng.integers(-1, 20, (30, 5)).astype(np.int32)
    tfs = rng.integers(0, 4, (30, 5)).astype(np.int32)
    js, ps = JStats(20), LexicalStats(20, device="cpu")
    js.add(terms, tfs)
    if device is None:
        ps.add(terms, tfs)
    else:
        ps.add(torch.from_numpy(terms), torch.from_numpy(tfs))
    js.remove(terms[:10], tfs[:10])
    ps.remove(terms[:10], tfs[:10])
    _assert_stats_equal(ps, js)


@pytest.mark.parametrize("text", ["Error code 17: disk full", "the THE the",
                                  [7, 7, 3, 99, -1, 12], "", "a b c d e f g h "
                                  "i j k l m n o p q r s"])
def test_lower_terms_matches_reference(text):
    ja = JArena(1, JConfig(vocab_size=64))
    pa = LexicalArena(1, LexicalConfig(vocab_size=64), device="cpu")
    assert pa.lower_terms(text) == ja.lower_terms(text)
    assert pa.token_id("Kernel") == ja.token_id("Kernel")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LexicalArena(4, LexicalConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        LexicalStats(8).idf()


def test_device_corpus_lanes_follow_the_reference_distributions():
    """`device_corpus` draws `_doc_lexical`'s distributions with torch:
    the same per-lane ranges, topic-block lanes, Zipfian background, entity
    share and tf range as the numpy corpus (statistically, not bitwise)."""
    n = 6000
    jc = JCorpusConfig(n_docs=n, dim=8, seed=3)
    ref = j_make_corpus(jc)
    rt, rf = np.asarray(ref.terms), np.asarray(ref.tfs)
    tc = CorpusConfig(n_docs=n, dim=8, seed=3)
    b = device_corpus(tc, 0, n, torch.Generator().manual_seed(3))
    pt, pf = b.terms.numpy(), b.tfs.numpy()
    assert pt.shape == rt.shape and pt.dtype == np.int32
    assert pf.min() == rf.min() == 1 and pf.max() == rf.max() == 3
    v_common = tc.n_common_terms
    n_topic = tc.topic_term_lanes
    for a in (pt, rt):
        assert (a[:, :-1] >= 0).all() and (a[:, :-1] < v_common).all()
        assert (a >= 0).all() and (a < tc.vocab_size).all()
    # the entity tail: the last lane holds an entity id on ~entity_frac docs
    ent_p = (pt[:, -1] >= v_common).mean()
    ent_r = (rt[:, -1] >= v_common).mean()
    assert abs(ent_p - tc.entity_frac) < 0.015
    assert abs(ent_p - ent_r) < 0.015
    # Zipfian background: term 0 is the most frequent background lane in both
    bg_p = np.bincount(pt[:, n_topic:-1].ravel(), minlength=v_common)
    bg_r = np.bincount(rt[:, n_topic:-1].ravel(), minlength=v_common)
    assert bg_p.argmax() == bg_r.argmax() == 0
    share_p, share_r = bg_p[:10].sum() / bg_p.sum(), bg_r[:10].sum() / bg_r.sum()
    assert abs(share_p - share_r) < 0.02
    # topic lanes stay inside their topic's block: all n_topic lanes of a doc
    # fall in one block of v_common // n_topics ids (mod v_common)
    block = v_common // tc.n_topics
    blk = pt[:, :n_topic] // block
    assert (blk == blk[:, :1]).all()
