"""Fixed-width postings arena -- the lexical columns of the unified layer
(port of ``repro.index.lexical.arena``).

The postings live as two more columns of the SAME arena:

  terms (N, T) int32   term ids, -1 = empty lane (T = LexicalConfig.doc_terms)
  tfs   (N, T) int32   term frequency per lane (0 on empty lanes)

Row i is slot i of the vector arena -- one slot allocator, one tombstone
convention, one commit counter. `TransactionLog` write hooks (ingest /
delete) call `write_rows` / `clear_rows`, so a query observes embedding,
metadata and postings from one consistent snapshot, never a mix.

Writes stay out of place (``index_copy`` into new tensors), so a held
`snapshot()` keeps its view: the store's MVCC contract. The lanes stay on
the arena's device: a write gathers the old lanes of the written slots
there and copies nothing else to the host but the (V,) df delta and two
counts. Corpus-level BM25 statistics (df / n_docs / total length) live in
`LexicalStats` on the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np
import torch

from repro_torch.core.store import resolve_device

_TOKEN_RE = re.compile(r"[a-z0-9_]+")


@dataclasses.dataclass(frozen=True)
class LexicalConfig:
    """Shape and scoring knobs of the postings arena.

    >>> LexicalConfig().doc_terms
    16
    """
    vocab_size: int = 2048        # term-id space (ids in [0, vocab_size))
    doc_terms: int = 16           # T: fixed-width term lanes per document
    max_query_terms: int = 16     # match() clause cap (QT pads to pow2 bucket)
    k1: float = 1.2               # BM25 tf saturation
    b: float = 0.75               # BM25 length normalization
    rrf_c: int = 60               # reciprocal-rank-fusion damping constant


def _lanes(x, device=None) -> torch.Tensor:
    """An (M, T) lane block (tensor, numpy array or nested list) as int64."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.int64))
    return x.to(device=device if device is not None else x.device,
                dtype=torch.int64)


class LexicalStats:
    """Corpus-level BM25 statistics: document frequency per term, live doc
    count, total token mass, on the host. ``version`` bumps on every
    mutation -- result-cache keys include it, because a lexical write
    changes idf and therefore hybrid scores. ``device`` is where `idf()`
    puts its table (the card unless the caller asks for another).

    >>> st = LexicalStats(8)
    >>> st.add(np.array([[0, 3, -1]]), np.array([[2, 1, 0]]))
    >>> st.n_docs, st.total_len, st.df[:4].tolist()
    (1, 3, [1, 0, 0, 1])
    >>> st.remove(np.array([[0, 3, -1]]), np.array([[2, 1, 0]]))
    >>> st.n_docs, int(st.df.sum()), st.version
    (0, 0, 2)
    """

    def __init__(self, vocab_size: int, device=None):
        self.vocab_size = vocab_size
        self.df = np.zeros(vocab_size, np.int64)
        self.n_docs = 0               # docs carrying at least one term
        self.total_len = 0            # sum of tf over all live lanes
        self.version = 0
        self.device = device
        self._idf_cache: tuple[tuple, torch.Tensor] | None = None

    def _delta(self, terms, tfs):
        """(df delta (V,), docs, tokens) of an (M, T) lane block, computed
        where the block lies; one small copy to the host."""
        terms = _lanes(terms)
        tfs = _lanes(tfs, terms.device)
        valid = terms >= 0
        v = self.vocab_size
        df = torch.bincount(torch.where(valid, terms, v).reshape(-1),
                            minlength=v + 1)[:v]
        counts = torch.stack([valid.any(dim=1).sum(),
                              torch.where(valid, tfs, 0).sum()])
        counts = counts.cpu().tolist()
        return df.cpu().numpy(), counts[0], counts[1]

    def add(self, terms, tfs) -> None:
        """Credit (M, T) rows of lanes. Lanes hold UNIQUE term ids per row
        (writers sanitize), so df is a straight bincount of valid lanes."""
        df, docs, tokens = self._delta(terms, tfs)
        self.df += df
        self.n_docs += docs
        self.total_len += tokens
        self.version += 1

    def remove(self, terms, tfs) -> None:
        df, docs, tokens = self._delta(terms, tfs)
        self.df -= df
        self.n_docs -= docs
        self.total_len -= tokens
        self.version += 1

    @property
    def avgdl(self) -> float:
        return self.total_len / max(self.n_docs, 1)

    def idf(self, device=None) -> torch.Tensor:
        """(V,) f32 tensor of BM25 idf values on ``device`` (default: this
        object's device), cached per version. The +1 inside the log keeps
        idf non-negative for common terms."""
        dev = resolve_device(device if device is not None else self.device)
        key = (self.version, dev)
        if self._idf_cache is None or self._idf_cache[0] != key:
            n = max(self.n_docs, 0)
            v = np.log1p((n - self.df + 0.5) / (self.df + 0.5))
            self._idf_cache = (key, torch.from_numpy(
                np.maximum(v, 0.0).astype(np.float32)).to(dev))
        return self._idf_cache[1]


def sanitize_lanes(terms, tfs, *, doc_terms: int, vocab_size: int,
                   device=None):
    """Normalize caller-supplied lanes to the arena contract: (M, T) int32
    tensors (on ``device``, default the input's), ids clipped to the vocab,
    duplicate ids within a row blanked (first lane wins -- df counts DOCS
    per term, so a duplicate would double-count), tf forced >= 1 on
    occupied lanes and 0 on empty ones.

    >>> t, f = sanitize_lanes([[3, 3, 9]], [[1, 2, 0]], doc_terms=4,
    ...                       vocab_size=8)
    >>> t.tolist(), f.tolist()
    ([[3, -1, -1, -1]], [[1, 0, 0, 0]])
    """
    terms = _lanes(terms, device)
    tfs = _lanes(tfs, terms.device)
    m, t_in = terms.shape
    t = min(t_in, doc_terms)
    out_t = torch.full((m, doc_terms), -1, dtype=torch.int32,
                       device=terms.device)
    out_f = torch.zeros((m, doc_terms), dtype=torch.int32,
                        device=terms.device)
    tt = terms[:, :t].clone()
    ff = tfs[:, :t]
    tt = torch.where((tt < 0) | (tt >= vocab_size), -1, tt)
    # blank duplicate ids within a row (keep the first occurrence)
    for j in range(1, t):
        dup = (tt[:, j:j + 1] == tt[:, :j]).any(dim=1) & (tt[:, j] >= 0)
        tt[:, j] = torch.where(dup, -1, tt[:, j])
    ff = torch.where(tt >= 0, torch.clamp(ff, min=1), 0)
    out_t[:, :t] = tt.to(torch.int32)
    out_f[:, :t] = ff.to(torch.int32)
    return out_t, out_f


def _lexnorm(tfs: torch.Tensor, avgdl: float, k1: float, b: float):
    """BM25 per-lane weight WITHOUT idf: tf*(k1+1)/(tf + k1*lennorm).
    Precomputed per snapshot so the scan only multiplies by the query-side
    idf. Empty lanes (tf=0) are exactly 0."""
    tf = tfs.to(torch.float32)
    dl = tfs.sum(dim=1, keepdim=True).to(torch.float32)
    avg = torch.clamp(torch.tensor(avgdl, dtype=torch.float32,
                                   device=tfs.device), min=1.0)
    denom = tf + k1 * (1.0 - b + b * dl / avg)
    return tf * (k1 + 1.0) / denom


class LexicalArena:
    """Per-tier postings lanes, slot-aligned with that tier's row arena, on
    ``device`` (the card unless the caller asks for another).

    Every write produces new lane tensors (``index_copy``), so a reader
    holding ``snapshot()`` keeps a consistent view across later commits.
    ``commit_count`` mirrors the device state host-side for snapshot-exact
    cache keys.

    >>> arena = LexicalArena(4, LexicalConfig(vocab_size=16, doc_terms=2),
    ...                      device="cpu")
    >>> arena.write_rows([0, 2], [[1, 5], [5, -1]], [[2, 1], [3, 0]])
    >>> snap = arena.snapshot()
    >>> snap["terms"][2].tolist(), arena.stats.df[5].item()
    ([5, -1], 2)
    >>> arena.clear_rows([2])
    >>> arena.stats.df[5].item(), arena.commit_count
    (1, 2)
    """

    def __init__(self, capacity: int, cfg: LexicalConfig,
                 stats: LexicalStats | None = None, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.stats = (stats if stats is not None
                      else LexicalStats(cfg.vocab_size, device=self.device))
        self._terms = torch.full((capacity, cfg.doc_terms), -1,
                                 dtype=torch.int32, device=self.device)
        self._tfs = torch.zeros((capacity, cfg.doc_terms), dtype=torch.int32,
                                device=self.device)
        self.commit_count = 0
        self._snap_cache: tuple[tuple, dict] | None = None

    @property
    def capacity(self) -> int:
        return self._terms.shape[0]

    def _slots(self, slots) -> torch.Tensor:
        if isinstance(slots, torch.Tensor):
            return slots.reshape(-1).to(device=self.device, dtype=torch.int64)
        return torch.from_numpy(np.asarray(slots, np.int64).reshape(-1)).to(
            self.device)

    # -- writes (TransactionLog hooks) -----------------------------------
    def write_rows(self, slots, terms, tfs) -> None:
        """(Over)write the lanes at ``slots``. Recycled slots first return
        their old lanes' df/length contributions, so corpus statistics stay
        exact under MVCC slot reuse. ``terms=None`` writes empty lanes. The
        old lanes are gathered on the device: only the written rows are
        read."""
        idx = self._slots(slots)
        if idx.numel() == 0:
            return
        old_t, old_f = self._terms[idx], self._tfs[idx]
        if bool((old_t >= 0).any()):
            self.stats.remove(old_t, old_f)
        if terms is None:
            new_t = torch.full((idx.numel(), self.cfg.doc_terms), -1,
                               dtype=torch.int32, device=self.device)
            new_f = torch.zeros_like(new_t)
        else:
            new_t, new_f = sanitize_lanes(
                terms, tfs, doc_terms=self.cfg.doc_terms,
                vocab_size=self.cfg.vocab_size, device=self.device)
        if bool((new_t >= 0).any()):
            self.stats.add(new_t, new_f)
        self._terms = self._terms.index_copy(0, idx, new_t)
        self._tfs = self._tfs.index_copy(0, idx, new_f)
        self.commit_count += 1

    def clear_rows(self, slots) -> None:
        self.write_rows(slots, None, None)

    def rows(self, slots) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of (terms, tfs) at ``slots`` (gathered on the
        device first, so only those rows are copied)."""
        idx = self._slots(slots)
        return (self._terms[idx].cpu().numpy(),
                self._tfs[idx].cpu().numpy())

    # -- reads -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Consistent device view for one scan: the lanes plus everything
        BM25 needs, cached per (commit, stats version) -- ``lexnorm`` is the
        per-lane tf/length weight (idf excluded) and ``idf`` the (V,) table
        the query side gathers from."""
        key = (self.commit_count, self.stats.version)
        if self._snap_cache is None or self._snap_cache[0] != key:
            self._snap_cache = (key, {
                "terms": self._terms,
                "tfs": self._tfs,
                "lexnorm": _lexnorm(self._tfs, self.stats.avgdl,
                                    self.cfg.k1, self.cfg.b),
                "idf": self.stats.idf(self.device),
            })
        return self._snap_cache[1]

    # -- query-side lowering ---------------------------------------------
    def token_id(self, token: str) -> int:
        """Stable string -> term-id hash (the synthetic corpus addresses
        term ids directly; real text lowers through this)."""
        h = hashlib.blake2b(token.lower().encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") % self.cfg.vocab_size

    def lower_terms(self, text) -> tuple[int, ...]:
        """Lower a match() argument to unique term ids: a string tokenizes
        and hashes; an iterable of ints passes through. Order-preserving
        dedupe, capped at ``max_query_terms``.

        >>> arena = LexicalArena(1, LexicalConfig(vocab_size=64),
        ...                      device="cpu")
        >>> arena.lower_terms([7, 7, 3])
        (7, 3)
        """
        if isinstance(text, str):
            ids = [self.token_id(t) for t in _TOKEN_RE.findall(text.lower())]
        else:
            ids = [int(t) for t in text]
        out: list[int] = []
        for t in ids:
            if 0 <= t < self.cfg.vocab_size and t not in out:
                out.append(t)
        return tuple(out[:self.cfg.max_query_terms])
