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

Beside a hot arena held in several allocations (one a device,
``core.store``) the lanes are held the same way: one (terms, tfs) pair a
device over the same row ranges, a write split by allocation on the host.
The statistics stay one, corpus-global; a snapshot gives each allocation
its lanes, its ``lexnorm`` computed on its device from the one global
avgdl, and the idf table copied from one host array to every device, so
that every card scores with the same bits as one arena would.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np
import torch

from repro_torch.core.store import ALLOCS, resolve_device, split_slots

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
        # (version, {device: idf table}): one host array a version, copied
        # to each device that asks
        self._idf_cache: tuple[int, dict] | None = None

    def _delta_on_device(self, terms, tfs):
        """(df delta (V,), [docs, tokens]) of an (M, T) lane block as
        tensors where the block lies, nothing copied yet."""
        terms = _lanes(terms)
        tfs = _lanes(tfs, terms.device)
        valid = terms >= 0
        v = self.vocab_size
        df = torch.bincount(torch.where(valid, terms, v).reshape(-1),
                            minlength=v + 1)[:v]
        counts = torch.stack([valid.any(dim=1).sum(),
                              torch.where(valid, tfs, 0).sum()])
        return df, counts

    def _delta(self, terms, tfs):
        """(df delta (V,), docs, tokens) of one or more (M, T) lane blocks
        (``terms`` / ``tfs`` a block or a list of blocks, each computed
        where it lies, all queued before the small copies to the host)."""
        blocks = ([(terms, tfs)] if not isinstance(terms, (list, tuple))
                  else list(zip(terms, tfs)))
        parts = [self._delta_on_device(t, f) for t, f in blocks]
        df = sum(d.cpu().numpy() for d, _ in parts)
        counts = sum(np.asarray(c.cpu().tolist()) for _, c in parts)
        return df, int(counts[0]), int(counts[1])

    def add(self, terms, tfs) -> None:
        """Credit (M, T) rows of lanes (or a list of such blocks, as one
        update). Lanes hold UNIQUE term ids per row (writers sanitize), so
        df is a straight bincount of valid lanes."""
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
        object's device), cached per version and device: every device gets
        a copy of the same host array. The +1 inside the log keeps idf
        non-negative for common terms."""
        dev = resolve_device(device if device is not None else self.device)
        if self._idf_cache is None or self._idf_cache[0] != self.version:
            self._idf_cache = (self.version, {})
        tables = self._idf_cache[1]
        if dev not in tables:
            n = max(self.n_docs, 0)
            v = np.log1p((n - self.df + 0.5) / (self.df + 0.5))
            tables[dev] = torch.from_numpy(
                np.maximum(v, 0.0).astype(np.float32)).to(dev)
        return tables[dev]


def allocations(snap: dict) -> tuple:
    """A lexical snapshot's views in row order, one an allocation: the
    snapshot itself when the lanes are one pair."""
    return snap[ALLOCS] if ALLOCS in snap else (snap,)


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
    ``device`` (the card unless the caller asks for another). ``allocs``,
    ((device, rows), ...) in row order as the hot arena's allocations
    (`core.store.empty`), holds the lanes one pair a device over the same
    row ranges, ``device`` then the controller; with one entry, or None,
    the lanes are one pair on ``device``.

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
    >>> two = LexicalArena(4, LexicalConfig(vocab_size=16, doc_terms=2),
    ...                    device="cpu", allocs=(("cpu", 2), ("cpu", 2)))
    >>> two.write_rows([3, 0], [[1, 5], [5, -1]], [[2, 1], [3, 0]])
    >>> [p["terms"].tolist() for p in two.snapshot()["allocs"]]
    [[[5, -1], [-1, -1]], [[-1, -1], [1, 5]]]
    >>> two.rows([3])[0].tolist(), two.stats.df[5].item()
    ([[1, 5]], 2)
    """

    def __init__(self, capacity: int, cfg: LexicalConfig,
                 stats: LexicalStats | None = None, *, device=None,
                 allocs=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.stats = (stats if stats is not None
                      else LexicalStats(cfg.vocab_size, device=self.device))
        if allocs is None or len(allocs) == 1:
            allocs = ((self.device, capacity),)
        elif sum(rows for _, rows in allocs) != capacity:
            raise ValueError(f"allocations of {[r for _, r in allocs]} rows "
                             f"do not make the capacity {capacity}")
        self._bounds, lo = [], 0
        for _, rows in allocs:
            self._bounds.append((lo, rows))
            lo += rows
        # one (terms, tfs) pair an allocation, in row order
        self._terms = [torch.full((rows, cfg.doc_terms), -1,
                                  dtype=torch.int32, device=resolve_device(d))
                       for d, rows in allocs]
        self._tfs = [torch.zeros_like(t) for t in self._terms]
        self.commit_count = 0
        self._snap_cache: tuple[tuple, dict] | None = None

    @property
    def capacity(self) -> int:
        return sum(rows for _, rows in self._bounds)

    def _slots(self, slots, device) -> torch.Tensor:
        if isinstance(slots, torch.Tensor):
            return slots.reshape(-1).to(device=device, dtype=torch.int64)
        return torch.from_numpy(np.asarray(slots, np.int64).reshape(-1)).to(
            device)

    def _split(self, slots):
        """[(allocation, positions in slots (host), local slots on its
        device)]: one entry with every slot when the lanes are one pair."""
        if len(self._terms) == 1:
            idx = self._slots(slots, self._terms[0].device)
            return [(0, None, idx)] if idx.numel() else []
        if isinstance(slots, torch.Tensor):
            slots = slots.cpu().numpy()
        return [(i, pos, self._slots(local, self._terms[i].device))
                for i, pos, local in split_slots(self._bounds, slots)]

    # -- writes (TransactionLog hooks) -----------------------------------
    def write_rows(self, slots, terms, tfs) -> None:
        """(Over)write the lanes at ``slots`` (global rows). Recycled slots
        first return their old lanes' df/length contributions, so corpus
        statistics stay exact under MVCC slot reuse. ``terms=None`` writes
        empty lanes. The old lanes are gathered on their devices: only the
        written rows are read. On several allocations the slots split by
        allocation on the host, each allocation's rows are written on its
        device, and the statistics take one update of each kind, as one
        arena's would."""
        parts = self._split(slots)
        if not parts:
            return
        old = [(self._terms[i][idx], self._tfs[i][idx])
               for i, _, idx in parts]
        if bool(sum(int((t >= 0).any()) for t, _ in old)):
            self.stats.remove([t for t, _ in old], [f for _, f in old])
        m = sum(idx.numel() for _, _, idx in parts)
        if terms is None:
            new_t = torch.full((m, self.cfg.doc_terms), -1,
                               dtype=torch.int32, device=self.device)
            new_f = torch.zeros_like(new_t)
        else:
            new_t, new_f = sanitize_lanes(
                terms, tfs, doc_terms=self.cfg.doc_terms,
                vocab_size=self.cfg.vocab_size,
                device=self.device if len(parts) == 1 and parts[0][1] is None
                else None)
        if bool((new_t >= 0).any()):
            self.stats.add(new_t, new_f)
        for i, pos, idx in parts:
            dev = self._terms[i].device
            t, f = new_t, new_f
            if pos is not None:
                take = torch.from_numpy(pos).to(new_t.device)
                t, f = new_t[take].to(dev), new_f[take].to(dev)
            self._terms[i] = self._terms[i].index_copy(0, idx, t)
            self._tfs[i] = self._tfs[i].index_copy(0, idx, f)
        self.commit_count += 1

    def clear_rows(self, slots) -> None:
        self.write_rows(slots, None, None)

    def rows(self, slots) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of (terms, tfs) at ``slots`` (gathered on their
        devices first, so only those rows are copied)."""
        parts = self._split(slots)
        if len(self._terms) == 1:
            idx = parts[0][2] if parts else self._slots([], self.device)
            return (self._terms[0][idx].cpu().numpy(),
                    self._tfs[0][idx].cpu().numpy())
        m = sum(len(pos) for _, pos, _ in parts)
        out_t = np.full((m, self.cfg.doc_terms), -1, np.int32)
        out_f = np.zeros((m, self.cfg.doc_terms), np.int32)
        for i, pos, idx in parts:
            out_t[pos] = self._terms[i][idx].cpu().numpy()
            out_f[pos] = self._tfs[i][idx].cpu().numpy()
        return out_t, out_f

    # -- reads -----------------------------------------------------------
    def _lanes_view(self, i: int) -> dict:
        terms, tfs = self._terms[i], self._tfs[i]
        return {"terms": terms, "tfs": tfs,
                "lexnorm": _lexnorm(tfs, self.stats.avgdl, self.cfg.k1,
                                    self.cfg.b),
                "idf": self.stats.idf(terms.device)}

    def snapshot(self) -> dict:
        """Consistent device view for one scan: the lanes plus everything
        BM25 needs, cached per (commit, stats version) -- ``lexnorm`` is the
        per-lane tf/length weight (idf excluded) and ``idf`` the (V,) table
        the query side gathers from. Lanes held in several allocations
        give ``{"allocs": (view, ...)}``, one such view an allocation on
        its device (`allocations`)."""
        key = (self.commit_count, self.stats.version)
        if self._snap_cache is None or self._snap_cache[0] != key:
            views = tuple(self._lanes_view(i)
                          for i in range(len(self._terms)))
            self._snap_cache = (key, views[0] if len(views) == 1
                                else {ALLOCS: views})
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
