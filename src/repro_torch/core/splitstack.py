"""Stack A -- the conventional three-tool RAG stack (port of
``repro.core.splitstack``), and the warm tier of the tiered deployment.

Three "services", three consistency domains:
  1. VectorStore    -- embeddings only; answers pure top-k. Knows nothing
                       about tenants, timestamps, or permissions.
  2. MetadataStore  -- relational columns, queried by row id (a separate
                       device call = a separate system round trip).
  3. MetadataCache  -- host-side TTL cache in front of the metadata store
                       (the paper's third tool), a second source of
                       staleness.

Everything here is the "synchronization code" the paper counts: over-fetch
heuristics, app-layer post-filtering, retry-on-underfill, two-phase writes,
cache invalidation. The injectable ``filter_bug_rate`` models the app-layer
tenant-filter bug behind the paper's measured 0.2 % leakage (Table 3).

The warm tier is this client queried with the predicate PUSHED DOWN
(`vector_topk_filtered`, `vector_topk_hybrid`): plain PyTorch on the
store's device -- a matmul over a chunk of warm rows, the predicate mask,
and an exact top-k merged chunk by chunk -- modelling a separate vector
database, never the hot tier's scan kernel. Every selection orders by
score descending, then by row ascending (`stages.topk_ordered` /
`merge_topk`), as ``jax.lax.top_k`` does in the reference, so chunking
changes no list. The warm columns are written in place (the split stack
has no snapshot isolation); ``acl`` holds the uint32 bit pattern as int32.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.query import NEG_INF, Predicate
from repro_torch.core.store import (DocBatch, StoreConfig, normalize,
                                    resolve_device)
from repro_torch.core.transactions import _col
from repro_torch.kernels.arena_scan.stages import (ScanSpec, merge_topk,
                                                   predicate_keep,
                                                   tile_signals, topk_ordered)
from repro_torch.serving.faults import FaultPlan, FaultRule, WarmTierError

#: warm rows scored at once: the scan keeps a running exact top-k across
#: chunks, so a full-width warm store never materialises (B, N) scores (or
#: BM25's per-lane temporaries over every row)
CHUNK_ROWS = 1 << 20

_META = ("tenant", "category", "updated_at", "acl", "doc_id")


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a commit's end, as the
    reference's ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chunked_topk(n: int, k: int, signals, chunk_rows: int | None):
    """Exact top-``k`` of each masked signal over ``n`` rows, scored
    ``chunk_rows`` at a time: ``signals(lo, hi)`` returns a tuple of (B,
    hi - lo) signals; each chunk's ordered top-k merges into the running
    list (running list first, so ties stay at the lower row). Returns one
    (scores, rows int32) pair per signal, min(k, n) wide."""
    step = n if chunk_rows is None else max(int(chunk_rows), 1)
    best = None
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        sig = signals(lo, hi)
        idx = torch.arange(lo, hi, dtype=torch.int32,
                           device=sig[0].device).expand(sig[0].shape[0], -1)
        top = [topk_ordered(s, idx, min(k, hi - lo)) for s in sig]
        best = top if best is None else [
            merge_topk(bs, bi, ts, ti, k)
            for (bs, bi), (ts, ti) in zip(best, top)]
    return best


def _warm_keep(valid: torch.Tensor, meta: dict[str, torch.Tensor],
               pred: torch.Tensor, lo: int = 0,
               hi: int | None = None) -> torch.Tensor:
    """The warm tier's pushed-down WHERE clause over rows [lo, hi): live &
    tenant & recency & category & ACL over the warm metadata columns. ONE
    definition shared by every warm scan that accepts a lowered predicate
    (dense and hybrid), and the same clause as the hot scan's
    (`stages.predicate_keep`). ``pred`` is `Predicate.as_array()`."""
    hi = valid.shape[0] if hi is None else hi
    m = torch.stack([meta["tenant"][lo:hi], meta["updated_at"][lo:hi],
                     meta["category"][lo:hi], meta["acl"][lo:hi]], dim=1)
    return valid[lo:hi] & predicate_keep(m, pred.reshape(1, 4))[0]


def vector_topk(emb: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                k: int, *, chunk_rows: int | None = CHUNK_ROWS):
    """Similarity only: the top ``k`` rows of q . emb over the valid rows
    (invalid rows score NEG_INF and may fill the tail, as ``lax.top_k``
    leaves them). Returns (scores (B, k) f32, rows (B, k) int32)."""
    q = q.to(device=emb.device, dtype=torch.float32)

    def signals(lo, hi):
        keep = valid[lo:hi][None, :].expand(q.shape[0], -1)
        return tile_signals(ScanSpec(), q, emb[lo:hi], keep)

    return tuple(_chunked_topk(emb.shape[0], k, signals, chunk_rows)[0])


def vector_topk_filtered(emb: torch.Tensor, valid: torch.Tensor,
                         meta: dict[str, torch.Tensor], q: torch.Tensor,
                         pred: torch.Tensor, k: int, *,
                         chunk_rows: int | None = CHUNK_ROWS):
    """Predicate PUSHDOWN: the vector service takes the lowered predicate
    and masks inside the scan. One call, no over-fetch, no under-fill
    retries, and no app code can skip the filter. Returns (scores (B, k)
    f32, rows (B, k) int32, -1 where the score is NEG_INF)."""
    q = q.to(device=emb.device, dtype=torch.float32)
    pred = pred.to(emb.device)

    def signals(lo, hi):
        keep = _warm_keep(valid, meta, pred, lo, hi)
        return tile_signals(ScanSpec(), q, emb[lo:hi],
                            keep[None, :].expand(q.shape[0], -1))

    ((top_s, top_i),) = _chunked_topk(emb.shape[0], k, signals, chunk_rows)
    return top_s, torch.where(top_s > NEG_INF, top_i, -1)


def vector_write(emb: torch.Tensor, valid: torch.Tensor, slots: torch.Tensor,
                 new_emb: torch.Tensor):
    """Commit 1 of a split-stack write: the vectors and their valid bits,
    in place. Returns (emb, valid)."""
    slots = slots.to(device=emb.device, dtype=torch.int64)
    emb.index_copy_(0, slots, new_emb.to(device=emb.device, dtype=emb.dtype))
    valid.index_fill_(0, slots, True)
    return emb, valid


def vector_topk_hybrid(emb: torch.Tensor, valid: torch.Tensor,
                       meta: dict[str, torch.Tensor], terms: torch.Tensor,
                       lexnorm: torch.Tensor, idf: torch.Tensor,
                       q: torch.Tensor, pred: torch.Tensor,
                       qterms: torch.Tensor, k: int, mode: str,
                       w_dense: float, w_lex: float, rrf_c: float,
                       lists: bool, *, chunk_rows: int | None = CHUNK_ROWS):
    """Hybrid dense+BM25 pushdown for the warm tier: the lowered predicate
    AND the lexical scoring run inside the one scan -- the warm analogue
    of `vector_topk_filtered`, extended with the second signal. idf / avgdl
    come from the CORPUS-GLOBAL `LexicalStats`, so warm BM25 scores compare
    with hot ones across the tier merge; wsum folds the weights into q and
    the query idf, as the hot engines do. Returns (scores, rows) for
    "wsum" and fused rrf, or the four per-signal lists (d_s, d_i, l_s, l_i)
    with ``lists=True``."""
    from repro_torch.kernels.hybrid_score.ref import _fold, qidf_of, rrf_fuse
    dev = emb.device
    q = q.to(device=dev, dtype=torch.float32)
    pred = pred.to(dev)
    qterms = qterms.to(device=dev, dtype=torch.int32)
    q, qidf = _fold(q, qidf_of(idf.to(dev), qterms), mode, w_dense, w_lex)
    spec = ScanSpec("fused" if mode == "wsum" else "both")

    def signals(lo, hi):
        keep = _warm_keep(valid, meta, pred, lo, hi)
        return tile_signals(spec, q, emb[lo:hi],
                            keep[None, :].expand(q.shape[0], -1),
                            lex=(terms[lo:hi], lexnorm[lo:hi], qterms, qidf))

    out = []
    for top_s, top_i in _chunked_topk(emb.shape[0], k, signals, chunk_rows):
        out += [top_s, torch.where(top_s > NEG_INF, top_i, -1)]
    if mode == "wsum" or lists:
        return tuple(out)
    return rrf_fuse(*out, k, rrf_c)


# ---------------------------------------------------------------------------
# tool 2: the relational metadata store (lookup by id)
# ---------------------------------------------------------------------------

def metadata_lookup(meta: dict[str, torch.Tensor], idx) -> dict:
    """The metadata rows at ``idx``, gathered where the columns lie."""
    dev = meta["tenant"].device
    idx = torch.as_tensor(np.asarray(idx, np.int64)).to(dev)
    return {k: v[idx] for k, v in meta.items()}


def metadata_write(meta: dict[str, torch.Tensor], slots: torch.Tensor,
                   tenant, category, updated_at, acl, doc_id) -> dict:
    """Commit 2 of a split-stack write: the metadata rows, in place.
    Returns ``meta``."""
    dev = meta["tenant"].device
    slots = slots.to(device=dev, dtype=torch.int64)
    for name, val in zip(_META, (tenant, category, updated_at, acl, doc_id)):
        meta[name].index_copy_(0, slots, _col(val, torch.int32, dev))
    return meta


# ---------------------------------------------------------------------------
# tool 3: host-side metadata cache (TTL)
# ---------------------------------------------------------------------------

class MetadataCache:
    """Host-side TTL cache of metadata rows by slot. ``clock`` (seconds,
    monotonic) is injectable so TTL expiry can be tested without sleeping.

    >>> now = [0.0]
    >>> cache = MetadataCache(ttl_s=1.0, clock=lambda: now[0])
    >>> cache.put(3, (0, 1, 2, 3, 4)); cache.get(3)
    (0, 1, 2, 3, 4)
    >>> now[0] = 1.5; cache.get(3) is None       # expired
    True
    >>> (cache.hits, cache.misses)
    (1, 1)
    """

    def __init__(self, ttl_s: float = 1.0, clock=time.perf_counter):
        self.ttl_s = ttl_s
        self.clock = clock
        self._entries: dict[int, tuple[float, tuple]] = {}
        self.hits = 0
        self.misses = 0

    def get(self, slot: int):
        ent = self._entries.get(slot)
        if ent is not None and self.clock() - ent[0] < self.ttl_s:
            self.hits += 1
            return ent[1]
        self.misses += 1
        return None

    def put(self, slot: int, row: tuple):
        self._entries[slot] = (self.clock(), row)

    def invalidate(self, slots):
        if not self._entries:        # nothing cached: no per-slot walk
            return
        for s in slots:
            self._entries.pop(int(s), None)


# ---------------------------------------------------------------------------
# the glue: Stack A client
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SplitStackStats:
    round_trips: int = 0
    retries: int = 0
    inconsistency_windows_s: list = dataclasses.field(default_factory=list)
    write_latencies_s: list = dataclasses.field(default_factory=list)


class SplitStackClient:
    """Application code stitching the three tools together. The columns
    live on ``device`` (the card unless the caller asks for another)."""

    OVERFETCH = 4          # initial over-fetch multiplier
    MAX_RETRIES = 4        # each retry quadruples the fetch size

    def __init__(self, cfg: StoreConfig, *, filter_bug_rate: float = 0.0,
                 cache_ttl_s: float = 1.0, rng_seed: int = 0, faults=None,
                 device=None):
        self.device = resolve_device(device)
        N, D = cfg.capacity, cfg.dim
        i32 = dict(dtype=torch.int32, device=self.device)
        self.cfg = cfg
        self.emb = torch.zeros((N, D), dtype=getattr(torch, cfg.dtype),
                               device=self.device)
        self.valid = torch.zeros((N,), dtype=torch.bool, device=self.device)
        self.meta = {
            "tenant": torch.full((N,), -1, **i32),
            "category": torch.zeros((N,), **i32),
            "updated_at": torch.zeros((N,), **i32),
            "acl": torch.zeros((N,), **i32),
            "doc_id": torch.full((N,), -1, **i32),
        }
        self.cache = MetadataCache(cache_ttl_s)
        self.stats = SplitStackStats()
        self.filter_bug_rate = filter_bug_rate
        # one seeded injection surface (serving.faults): filter_bug_rate
        # installs a ``split.filter_bug`` rule; a caller's plan may also
        # carry warm.error / warm.stall rules for the pushdown paths
        if faults is None:
            faults = FaultPlan(seed=rng_seed)
        if filter_bug_rate > 0.0 and "split.filter_bug" not in faults.rules:
            faults.rules["split.filter_bug"] = FaultRule(rate=filter_bug_rate)
        self.faults = faults
        self._cursor = 0
        self._slot_of_doc: dict[int, int] = {}
        # monotone write counter (one per ingest/update/delete): the front
        # door's result cache keys warm-probing entries on it
        self.commit_count = 0
        # host gap injected between the two write commits (queue / network
        # delay between the vector upsert and the metadata upsert)
        self.write_gap_s = 0.0
        # optional lexical lanes (attach_lexical), sharing the corpus-global
        # LexicalStats with the hot arena
        self.lex = None

    def attach_lexical(self, cfg, stats) -> None:
        """Grow slot-aligned postings lanes for hybrid pushdown queries.
        ``stats`` is the corpus-global `LexicalStats` shared with the hot
        arena, so idf / avgdl stay comparable across the tier merge."""
        from repro_torch.index.lexical import LexicalArena
        self.lex = LexicalArena(self.cfg.capacity, cfg, stats,
                                device=self.device)

    @property
    def n_docs(self) -> int:
        """LIVE rows (the planner skips the warm probe at 0)."""
        return len(self._slot_of_doc)

    def has_doc(self, doc_id: int) -> bool:
        return int(doc_id) in self._slot_of_doc

    def slot_of(self, doc_id: int) -> int:
        return self._slot_of_doc[int(doc_id)]

    def _slots(self, slot_list) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slot_list, np.int64)).to(
            self.device)

    def _second_commit(self, t1: float, commit, slot_list) -> float:
        """The write gap, commit 2 (synced), the cache invalidation and the
        window record. Returns the commit's end time."""
        if self.write_gap_s:
            time.sleep(self.write_gap_s)
        commit()
        _sync(self.device)
        t2 = time.perf_counter()
        self.cache.invalidate(slot_list)
        self.stats.inconsistency_windows_s.append(t2 - t1)
        return t2

    def delete(self, doc_ids) -> list[int]:
        """Tombstone rows -- TWO commits like every split-stack write
        (vector invalidate, then metadata), the window recorded. Returns
        the freed slots (one per unique doc_id, in dedup order)."""
        slot_list = [self._slot_of_doc[d]
                     for d in dict.fromkeys(int(d) for d in doc_ids)]
        slots = self._slots(slot_list)
        t0 = time.perf_counter()
        self.valid.index_fill_(0, slots, False)
        _sync(self.device)
        t1 = time.perf_counter()

        def commit():
            self.meta["tenant"].index_fill_(0, slots, -1)
            self.meta["doc_id"].index_fill_(0, slots, -1)

        t2 = self._second_commit(t1, commit, slot_list)
        self.stats.write_latencies_s.append(t2 - t0)
        for d in doc_ids:
            self._slot_of_doc.pop(int(d), None)
        if self.lex is not None:     # postings leave with the row
            self.lex.clear_rows(slot_list)
        self.commit_count += 1
        return slot_list

    # -- writes: TWO separate commits -----------------------------------
    def ingest(self, batch: DocBatch) -> None:
        m = batch.size
        if self._cursor + m > self.cfg.capacity:
            raise RuntimeError("warm arena full — grow capacity")
        slots = torch.arange(self._cursor, self._cursor + m,
                             dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        # commit 1: vector store
        emb = torch.as_tensor(batch.emb).to(device=self.device,
                                            dtype=self.emb.dtype)
        vector_write(self.emb, self.valid, slots, normalize(self.cfg, emb))
        _sync(self.device)
        t1 = time.perf_counter()
        # commit 2: metadata store (a reader between t1 and t2 sees the new
        # vector with the OLD metadata -- the inconsistency window)
        t2 = self._second_commit(t1, lambda: metadata_write(
            self.meta, slots, batch.tenant, batch.category, batch.updated_at,
            batch.acl, batch.doc_id), range(self._cursor, self._cursor + m))
        self.stats.write_latencies_s.append(t2 - t0)
        doc_ids = torch.as_tensor(batch.doc_id).cpu().tolist()
        self._slot_of_doc.update(
            zip(doc_ids, range(self._cursor, self._cursor + m)))
        self._cursor += m
        if self.lex is not None:     # postings ride the metadata commit
            self.lex.write_rows(slots, batch.terms, batch.tfs)
        self.commit_count += 1

    def update(self, doc_ids, new_emb, updated_at) -> None:
        slot_list = [self._slot_of_doc[int(d)] for d in doc_ids]
        slots = self._slots(slot_list)
        t0 = time.perf_counter()
        emb = torch.as_tensor(new_emb).to(device=self.device,
                                          dtype=self.emb.dtype)
        vector_write(self.emb, self.valid, slots, normalize(self.cfg, emb))
        _sync(self.device)
        t1 = time.perf_counter()
        ts = _col(updated_at, torch.int32, self.device).reshape(-1)
        t2 = self._second_commit(
            t1, lambda: self.meta["updated_at"].index_copy_(0, slots, ts),
            slot_list)
        self.stats.write_latencies_s.append(t2 - t0)
        self.commit_count += 1

    # -- reads: vector search -> metadata fetch -> app-layer filter ------
    def _passes_filters(self, row: tuple, pred: Predicate,
                        bug_active: bool) -> bool:
        tenant, category, updated_at, acl, doc_id = row
        if doc_id < 0:
            return False
        # THE BUG: under bug_active the tenant clause is skipped -- the class
        # of app-layer filter defect the paper measured at 0.2 %
        if not bug_active and pred.tenant != -2 and tenant != pred.tenant:
            return False
        if updated_at < pred.min_ts:
            return False
        if not ((1 << int(category)) & pred.cat_mask):
            return False
        if not (int(acl) & pred.acl_bits):
            return False
        return True

    def _pad(self, out: tuple, k: int) -> tuple:
        """Host copies of (scores, rows, ...) padded from the store's
        capacity up to ``k`` columns (NEG_INF / -1)."""
        out = tuple(a.cpu().numpy() for a in out)
        k_eff = out[0].shape[1]
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            out = tuple(np.pad(a, pad, constant_values=(
                np.float32(NEG_INF) if j % 2 == 0 else -1))
                for j, a in enumerate(out))
        return out

    def _q(self, q) -> torch.Tensor:
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.ascontiguousarray(q, np.float32))
        return q.to(device=self.device, dtype=torch.float32)

    def query(self, q, pred: Predicate, k: int, *, pushdown: bool = False):
        """Returns (scores (B, k) np.float32, slots (B, k) np.int32).

        ``pushdown=False`` (Stack A as the paper measured it): vector scan,
        metadata fetch, app-layer post-filter, retry-on-underfill -- every
        round trip counted, the injectable filter bug reachable.

        ``pushdown=True`` (the warm-tier route): the lowered predicate
        travels INTO the vector scan (`vector_topk_filtered`) -- one round
        trip, exact fill, the app-layer filter (and its bug) out of the
        loop. The front-door executor always probes the warm tier this way.
        """
        q = self._q(q)
        if pushdown:
            # warm-tier fault sites: a stall (slow replica) and a hard
            # error, both scheduled by the attached FaultPlan
            self.faults.stall("warm.stall")
            self.faults.raise_if("warm.error", WarmTierError)
            k_eff = min(k, self.cfg.capacity)
            out = vector_topk_filtered(self.emb, self.valid, self.meta, q,
                                       pred.as_array(self.device), k_eff)
            self.stats.round_trips += 1
            return self._pad(out, k)
        B = q.shape[0]
        bug_active = self.faults.fires("split.filter_bug")
        fetch = k * self.OVERFETCH
        out_scores = np.full((B, k), np.float32(NEG_INF), np.float32)
        out_slots = np.full((B, k), -1, np.int32)
        for attempt in range(self.MAX_RETRIES + 1):
            # round trip 1..n: vector service
            scores, idx = vector_topk(self.emb, self.valid, q,
                                      min(fetch, self.cfg.capacity))
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
            self.stats.round_trips += 1
            # metadata fetch: cache first, then the metadata service
            uniq = np.unique(idx)
            missing = [s for s in uniq if self.cache.get(int(s)) is None]
            if missing:
                rows = {c: v.cpu().numpy() for c, v in
                        metadata_lookup(self.meta, missing).items()}
                self.stats.round_trips += 1
                for j, s in enumerate(missing):
                    self.cache.put(int(s), (
                        int(rows["tenant"][j]), int(rows["category"][j]),
                        int(rows["updated_at"][j]),
                        int(rows["acl"][j]) & 0xFFFFFFFF,
                        int(rows["doc_id"][j])))
            # app-layer post-filter + merge (the fragile part)
            done = True
            for b in range(B):
                kept = 0
                for j in range(idx.shape[1]):
                    s = int(idx[b, j])
                    row = self.cache.get(s)
                    if row is None:
                        continue
                    if self._passes_filters(row, pred, bug_active):
                        out_scores[b, kept] = scores[b, j]
                        out_slots[b, kept] = s
                        kept += 1
                        if kept == k:
                            break
                if kept < k and fetch < self.cfg.capacity:
                    done = False
            if done or fetch >= self.cfg.capacity:
                break
            fetch *= 4
            self.stats.retries += 1
        return out_scores, out_slots

    def query_hybrid(self, q, qterms, pred: Predicate, k: int, *,
                     mode: str = "wsum", w_dense: float = 1.0,
                     w_lex: float = 1.0, rrf_c: float = 60.0,
                     lists: bool = False):
        """Warm-tier hybrid probe with LEXICAL pushdown: predicate mask,
        dense scoring and BM25 all run inside one scan (one round trip, no
        retries, no app-layer filter) -- the hybrid twin of
        ``query(..., pushdown=True)``. ``qterms`` is (B, QT) int32 with -1
        padding. Returns (scores, slots) (B, k) numpy for "wsum" / fused
        rrf, or the four per-signal lists with ``lists=True`` (the tiered
        executor merges per signal before rank fusion)."""
        if self.lex is None:
            raise ValueError("warm tier has no lexical lanes — "
                             "attach_lexical() first")
        self.faults.stall("warm.stall")
        self.faults.raise_if("warm.error", WarmTierError)
        snap = self.lex.snapshot()
        k_eff = min(k, self.cfg.capacity)
        out = vector_topk_hybrid(self.emb, self.valid, self.meta,
                                 snap["terms"], snap["lexnorm"], snap["idf"],
                                 self._q(q), pred.as_array(self.device),
                                 _col(qterms, torch.int32, self.device),
                                 k_eff, mode, float(w_dense), float(w_lex),
                                 float(rrf_c), lists)
        self.stats.round_trips += 1
        return self._pad(out, k)
