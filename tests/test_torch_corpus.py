"""The port's corpus generator gives byte-identical arrays to the
reference's at a small `CorpusConfig` (both draw from the same numpy
streams); `device_corpus` draws the same distributions with torch."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import corpus as jcorpus
from repro_torch.data import corpus as tcorpus

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

FIELDS = ("emb", "tenant", "category", "updated_at", "acl", "doc_id",
          "terms", "tfs")


def _cfgs(**kw):
    base = dict(n_docs=300, dim=16, n_tenants=4, n_categories=5,
                vocab_size=512, doc_terms=6, n_entity_terms=32,
                entity_frac=0.2, seed=3)
    base.update(kw)
    return jcorpus.CorpusConfig(**base), tcorpus.CorpusConfig(**base)


def assert_batch_bytes(tb, jb):
    for f in FIELDS:
        got = getattr(tb, f).numpy()
        want = np.asarray(getattr(jb, f))
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        assert got.dtype == want.dtype, f
        assert got.tobytes() == want.tobytes(), f


def test_config_fields_match_reference():
    jc, tc = _cfgs()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.now_ts, jc.n_common_terms) == (tc.now_ts, tc.n_common_terms)
    np.testing.assert_array_equal(jcorpus.topic_basis(jc),
                                  tcorpus.topic_basis(tc))


@pytest.mark.parametrize("seed", [0, 3])
def test_make_corpus_byte_identical(seed):
    jc, tc = _cfgs(seed=seed)
    assert_batch_bytes(tcorpus.make_corpus(tc, device="cpu"),
                       jcorpus.make_corpus(jc))


def test_stream_corpus_chunks_byte_identical():
    jc, tc = _cfgs()
    t_chunks = list(tcorpus.stream_corpus(tc, chunk_rows=128, device="cpu"))
    j_chunks = list(jcorpus.stream_corpus(jc, chunk_rows=128))
    assert len(t_chunks) == len(j_chunks) == 3
    for tb, jb in zip(t_chunks, j_chunks):
        assert_batch_bytes(tb, jb)


def test_queries_byte_identical():
    jc, tc = _cfgs()
    got = tcorpus.make_queries(tc, 4, batch=3, seed=9, device="cpu").numpy()
    want = np.asarray(jcorpus.make_queries(jc, 4, batch=3, seed=9))
    assert got.shape == (4, 3, 16) and got.tobytes() == want.tobytes()
    tq, tm, tr = tcorpus.make_keyword_queries(
        tc, tcorpus.make_corpus(tc, device="cpu"), 5)
    jq, jm, jr = jcorpus.make_keyword_queries(jc, jcorpus.make_corpus(jc), 5)
    assert tq.tobytes() == jq.tobytes() and tm == jm
    assert all(np.array_equal(a, b) for a, b in zip(tr, jr))


def test_device_corpus_draws_the_reference_distributions():
    _, tc = _cfgs(n_docs=4000, n_acl_groups=8)
    gen = torch.Generator(device="cpu").manual_seed(0)
    b = tcorpus.device_corpus(tc, 100, 4000, gen)
    assert b.emb.shape == (4000, 16) and b.emb.dtype == torch.float32
    torch.testing.assert_close(torch.linalg.vector_norm(b.emb, dim=1),
                               torch.ones(4000), rtol=1e-5, atol=1e-5)
    assert b.doc_id.tolist() == list(range(100, 4100))
    assert set(b.tenant.tolist()) == set(range(tc.n_tenants))
    assert set(b.category.tolist()) == set(range(tc.n_categories))
    assert 0 <= int(b.updated_at.min()) and int(b.updated_at.max()) < tc.now_ts
    acl = b.acl.numpy().view(np.uint32)
    bits = np.unpackbits(acl.view(np.uint8)).reshape(-1, 32).sum(1)
    assert (acl != 0).all() and bits.max() <= 4 and (acl >> 8 == 0).all()
    # each doc sits near its topic: the best topic cosine is high
    topics = torch.from_numpy(tcorpus.topic_basis(tc))
    assert float((b.emb @ topics.T).max(dim=1).values.mean()) > 0.6
