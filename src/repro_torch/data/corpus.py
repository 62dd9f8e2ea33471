"""Synthetic corpus + query workload matching the paper's benchmark setup
(port of ``repro.data.corpus``): 50,000 documents, 128-dim embeddings, 20
tenant namespaces, 5 content categories, timestamps uniform over the past
180 days (Section 6.1).

Embeddings are drawn from a topic mixture on the unit sphere: each document
is a unit topic direction plus isotropic noise, re-normalized; queries come
from the same process. The numpy draws are the reference's, call for call,
so `make_corpus`, `stream_corpus`, `make_queries` and
`make_keyword_queries` give byte-identical arrays for the same config; the
columns are returned as tensors on ``device`` (``acl`` as the int32 bit
pattern of its uint32 mask).

`device_corpus` draws the same distributions with a `torch.Generator` on
the card, for arenas too large to generate on the host (not byte-identical
to the numpy streams).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.store import DocBatch, resolve_device

DAY_S = 86_400


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 50_000
    dim: int = 128
    n_tenants: int = 20
    n_categories: int = 5
    n_acl_groups: int = 8
    days_span: int = 180
    seed: int = 0
    # topic mixture: unit topic direction + noise, re-normalized; the noise
    # VECTOR norm (~sigma * sqrt(dim)) is ~0.8 of the topic norm at dim=128
    n_topics: int = 64
    topic_sigma: float = 0.07
    # synthetic vocabulary for the lexical lanes (drawn from a derived rng
    # stream, so every other column is independent of it)
    vocab_size: int = 2048
    doc_terms: int = 16            # T lanes per doc
    topic_term_lanes: int = 4      # lanes drawn from the doc's topic block
    zipf_alpha: float = 1.1        # background term popularity decay
    n_entity_terms: int = 256      # rare-id tail of the vocab
    entity_frac: float = 0.05      # docs carrying one entity term

    @property
    def now_ts(self) -> int:
        return self.days_span * DAY_S

    @property
    def n_common_terms(self) -> int:
        return self.vocab_size - self.n_entity_terms


def topic_basis(cfg: CorpusConfig) -> np.ndarray:
    """The corpus's unit topic directions, (n_topics, dim). Derived from
    cfg.seed alone so make_corpus and make_queries share one mixture."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0x70B1C5]))
    t = rng.standard_normal((cfg.n_topics, cfg.dim)).astype(np.float32)
    return t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-12)


def _topic_points(cfg: CorpusConfig, rng: np.random.Generator, n: int,
                  with_topics: bool = False):
    topics = topic_basis(cfg)
    tid = rng.integers(0, cfg.n_topics, n)
    x = topics[tid] + cfg.topic_sigma * rng.standard_normal(
        (n, cfg.dim)).astype(np.float32)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return (x, tid) if with_topics else x


def _doc_lexical(cfg: CorpusConfig, tid: np.ndarray,
                 rng: np.random.Generator):
    """Per-doc (terms, tfs) lanes, (n, T) int32: topic-correlated lanes +
    Zipfian background + a rare entity term on `entity_frac` of docs."""
    n = len(tid)
    t_lanes = cfg.doc_terms
    v_common = cfg.n_common_terms
    block = max(v_common // cfg.n_topics, 1)
    n_topic = min(cfg.topic_term_lanes, t_lanes)
    base = (tid[:, None] * block) % v_common
    terms = np.empty((n, t_lanes), np.int64)
    terms[:, :n_topic] = (base + rng.integers(
        0, block, (n, n_topic))) % v_common
    ranks = np.arange(1, v_common + 1, dtype=np.float64)
    p = ranks ** -cfg.zipf_alpha
    p /= p.sum()
    terms[:, n_topic:] = rng.choice(v_common, size=(n, t_lanes - n_topic),
                                    p=p)
    if cfg.n_entity_terms and cfg.entity_frac > 0:
        has_ent = rng.random(n) < cfg.entity_frac
        e_block = max(cfg.n_entity_terms // cfg.n_topics, 1)
        ent = (v_common + (tid * e_block
                           + rng.integers(0, e_block, n))
               % cfg.n_entity_terms)
        terms[has_ent, t_lanes - 1] = ent[has_ent]
    tfs = rng.integers(1, 4, (n, t_lanes))
    return terms.astype(np.int32), tfs.astype(np.int32)


def _acl(rng: np.random.Generator, cfg: CorpusConfig, n: int) -> np.ndarray:
    """Each doc permits 1..3 random ACL groups (uint32 bitmask)."""
    acl = np.zeros(n, dtype=np.uint32)
    for _ in range(3):
        bit = rng.integers(0, cfg.n_acl_groups, n)
        on = rng.random(n) < 0.6
        acl |= (np.uint32(1) << bit.astype(np.uint32)) * on.astype(np.uint32)
    acl |= np.uint32(1) << rng.integers(0, cfg.n_acl_groups, n).astype(np.uint32)
    return acl


def _batch(dev, emb, tenant, category, updated_at, acl, doc_id, terms, tfs):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return DocBatch(emb=t(emb), tenant=t(tenant), category=t(category),
                    updated_at=t(updated_at), acl=t(acl.view(np.int32)),
                    doc_id=t(doc_id), terms=t(terms), tfs=t(tfs))


def make_corpus(cfg: CorpusConfig, device=None) -> DocBatch:
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    emb, tid = _topic_points(cfg, rng, cfg.n_docs, with_topics=True)
    tenant = rng.integers(0, cfg.n_tenants, cfg.n_docs, dtype=np.int32)
    category = rng.integers(0, cfg.n_categories, cfg.n_docs, dtype=np.int32)
    updated_at = rng.integers(0, cfg.days_span * DAY_S, cfg.n_docs,
                              dtype=np.int64).astype(np.int32)
    acl = _acl(rng, cfg, cfg.n_docs)
    doc_id = np.arange(cfg.n_docs, dtype=np.int32)
    rng_lex = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0x7E45]))
    terms, tfs = _doc_lexical(cfg, tid, rng_lex)
    return _batch(dev, emb, tenant, category, updated_at, acl, doc_id, terms,
                  tfs)


def stream_corpus(cfg: CorpusConfig, chunk_rows: int = 65_536, device=None):
    """Chunked corpus generator: `DocBatch` chunks of at most ``chunk_rows``
    docs with globally unique, increasing doc_ids; chunk c draws from its own
    SeedSequence([seed, salt, c]) stream, so it is reproducible alone.

    >>> cfg = CorpusConfig(n_docs=100, dim=8, vocab_size=512)
    >>> chunks = list(stream_corpus(cfg, chunk_rows=64, device="cpu"))
    >>> [int(c.emb.shape[0]) for c in chunks]
    [64, 36]
    >>> int(chunks[1].doc_id[0])      # ids continue across chunks
    64
    """
    dev = resolve_device(device)
    start, chunk = 0, 0
    while start < cfg.n_docs:
        n = min(chunk_rows, cfg.n_docs - start)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0x57E4A, chunk]))
        emb, tid = _topic_points(cfg, rng, n, with_topics=True)
        tenant = rng.integers(0, cfg.n_tenants, n, dtype=np.int32)
        category = rng.integers(0, cfg.n_categories, n, dtype=np.int32)
        updated_at = rng.integers(0, cfg.days_span * DAY_S, n,
                                  dtype=np.int64).astype(np.int32)
        acl = _acl(rng, cfg, n)
        doc_id = np.arange(start, start + n, dtype=np.int32)
        rng_lex = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0x7E45, chunk]))
        terms, tfs = _doc_lexical(cfg, tid, rng_lex)
        yield _batch(dev, emb, tenant, category, updated_at, acl, doc_id,
                     terms, tfs)
        start += n
        chunk += 1


def make_queries(cfg: CorpusConfig, n_queries: int, batch: int = 1,
                 seed: int = 1, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = _topic_points(cfg, rng, n_queries * batch)
    return torch.from_numpy(q.reshape(n_queries, batch, cfg.dim)).to(dev)


def make_keyword_queries(cfg: CorpusConfig, corpus: DocBatch,
                         n_queries: int, *, seed: int = 2,
                         query_sigma: float = 0.12,
                         max_df: int = 24):
    """Keyword-anchored query workload: each query targets the docs
    carrying one RARE entity term, with an embedding drawn near a relevant
    doc. Returns (q (n, dim) f32, match_terms list[tuple[int]], relevant
    list[np.ndarray of doc_ids]) as numpy, like the reference."""
    rng = np.random.default_rng(seed)
    terms = corpus.terms.cpu().numpy()
    doc_id = corpus.doc_id.cpu().numpy()
    emb = corpus.emb.cpu().numpy()
    ent_lo = cfg.n_common_terms
    is_ent = terms >= ent_lo
    df = np.bincount(terms[is_ent].ravel(), minlength=cfg.vocab_size)
    eligible = np.nonzero((df[ent_lo:] >= 1) & (df[ent_lo:] <= max_df))[0] + ent_lo
    if len(eligible) == 0:
        raise ValueError("corpus has no rare entity terms — raise "
                         "entity_frac or n_docs")
    qs, match_terms, relevant = [], [], []
    for _ in range(n_queries):
        e = int(eligible[rng.integers(0, len(eligible))])
        rel_rows = np.nonzero((terms == e).any(axis=1))[0]
        anchor = int(rel_rows[rng.integers(0, len(rel_rows))])
        v = (emb[anchor]
             + query_sigma * rng.standard_normal(cfg.dim).astype(np.float32))
        qs.append(v / max(np.linalg.norm(v), 1e-12))
        match_terms.append((e,))
        relevant.append(doc_id[rel_rows])
    return np.asarray(qs, np.float32), match_terms, relevant


def _device_lexical(cfg: CorpusConfig, tid: torch.Tensor,
                    gen: torch.Generator):
    """`_doc_lexical`'s distributions drawn on ``gen``'s device: topic-
    correlated lanes, a Zipfian background (inverse-CDF draws), a rare
    entity term on `entity_frac` of docs, tf in 1..3. (n, T) int32."""
    dev = gen.device
    n = tid.shape[0]
    t_lanes = cfg.doc_terms
    v_common = cfg.n_common_terms
    block = max(v_common // cfg.n_topics, 1)
    n_topic = min(cfg.topic_term_lanes, t_lanes)
    ri = lambda hi, size: torch.randint(0, hi, size, generator=gen,
                                        device=dev, dtype=torch.int64)
    base = (tid[:, None] * block) % v_common
    topical = (base + ri(block, (n, n_topic))) % v_common
    ranks = torch.arange(1, v_common + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks ** -cfg.zipf_alpha, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((n, t_lanes - n_topic), generator=gen, device=dev,
                   dtype=torch.float64)
    background = torch.clamp(torch.searchsorted(cdf, u), max=v_common - 1)
    terms = torch.cat([topical, background], dim=1)
    if cfg.n_entity_terms and cfg.entity_frac > 0:
        has_ent = torch.rand(n, generator=gen, device=dev) < cfg.entity_frac
        e_block = max(cfg.n_entity_terms // cfg.n_topics, 1)
        ent = v_common + (tid * e_block + ri(e_block, (n,))) % cfg.n_entity_terms
        terms[:, t_lanes - 1] = torch.where(has_ent, ent,
                                            terms[:, t_lanes - 1])
    tfs = torch.randint(1, 4, (n, t_lanes), generator=gen, device=dev,
                        dtype=torch.int32)
    return terms.to(torch.int32), tfs


def device_corpus(cfg: CorpusConfig, start: int, n: int,
                  gen: torch.Generator) -> DocBatch:
    """``n`` docs (doc ids ``start..start+n-1``) drawn on ``gen``'s device
    from the same distributions as `make_corpus`: topic mixture on the
    sphere (the cfg's `topic_basis`), uniform tenant / category /
    timestamp, 1..3 ACL groups of ``n_acl_groups``, and T lexical lanes
    from `_doc_lexical`'s distributions. For arenas too large to draw on
    the host; not byte-identical to numpy.

    >>> cfg = CorpusConfig(n_docs=64, dim=8, vocab_size=512)
    >>> b = device_corpus(cfg, 0, 64, torch.Generator().manual_seed(0))
    >>> tuple(b.terms.shape), int(b.terms.min()) >= 0, int(b.tfs.max()) <= 3
    ((64, 16), True, True)
    """
    dev = gen.device
    topics = torch.from_numpy(topic_basis(cfg)).to(dev)
    ri = lambda hi, size: torch.randint(0, hi, size, generator=gen,
                                        device=dev, dtype=torch.int64)
    tid = ri(cfg.n_topics, (n,))
    x = topics[tid] + cfg.topic_sigma * torch.randn(
        (n, cfg.dim), generator=gen, device=dev)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                        min=1e-12)
    acl = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(3):
        on = torch.rand(n, generator=gen, device=dev) < 0.6
        acl |= torch.where(on, 1 << ri(cfg.n_acl_groups, (n,)), 0)
    acl |= 1 << ri(cfg.n_acl_groups, (n,))
    i32 = lambda t: t.to(torch.int32)
    tenant = i32(ri(cfg.n_tenants, (n,)))
    category = i32(ri(cfg.n_categories, (n,)))
    updated_at = i32(ri(cfg.days_span * DAY_S, (n,)))
    terms, tfs = _device_lexical(cfg, tid, gen)
    return DocBatch(
        emb=x.float(), tenant=tenant, category=category,
        updated_at=updated_at, acl=i32(acl),
        doc_id=torch.arange(start, start + n, dtype=torch.int32, device=dev),
        terms=terms, tfs=tfs)
