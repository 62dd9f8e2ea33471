"""Transactional writes for the unified store (port of
``repro.core.transactions``).

A write is ONE atomic commit: a function store -> store' that builds every
changed column out of place (``index_copy``, never ``index_copy_``), and the
caller swaps the returned dict under `TransactionLog.commit`. A reader
holding a snapshot keeps an unchanging view -- MVCC by immutability -- at
the price of the arena living in memory twice while a commit is built.

Writes do not synchronise with the device: the commit is enqueued on the
current stream, and readers that need values sync when they read them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.store import (DocBatch, ShardPlacement, Store,
                                    StoreConfig, empty, normalize)


def _col(x, dtype, device) -> torch.Tensor:
    """A batch column as a tensor on ``device`` (uint32 numpy masks keep
    their bit pattern as int32)."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.as_tensor(x, device=device).to(dtype)


# ---------------------------------------------------------------------------
# atomic write functions (each builds the next snapshot = one commit)
# ---------------------------------------------------------------------------

def ingest(store: Store, cfg: StoreConfig, slots: torch.Tensor, batch_emb,
           tenant, category, updated_at, acl, doc_id) -> Store:
    """Insert M documents at the given slots. Embedding AND metadata
    columns are built together: atomic by construction."""
    dev = store["emb"].device
    slots = slots.to(device=dev, dtype=torch.int64)
    emb = normalize(cfg, _col(batch_emb, store["emb"].dtype, dev))
    was_free = store["tenant"][slots] < 0
    new = dict(store)
    new["emb"] = store["emb"].index_copy(0, slots, emb)
    for name, val in (("tenant", tenant), ("category", category),
                      ("updated_at", updated_at), ("acl", acl),
                      ("doc_id", doc_id)):
        new[name] = store[name].index_copy(0, slots,
                                           _col(val, torch.int32, dev))
    new["version"] = store["version"].index_add(
        0, slots, torch.ones_like(slots, dtype=torch.int32))
    new["commit_ts"] = store["commit_ts"] + 1
    new["n_live"] = store["n_live"] + was_free.sum(dtype=torch.int32)
    return new


def update(store: Store, cfg: StoreConfig, slots: torch.Tensor, new_emb,
           updated_at) -> Store:
    """Re-embed existing documents: the fresh embedding and the fresh
    timestamp commit together."""
    dev = store["emb"].device
    slots = slots.to(device=dev, dtype=torch.int64)
    emb = normalize(cfg, _col(new_emb, store["emb"].dtype, dev))
    new = dict(store)
    new["emb"] = store["emb"].index_copy(0, slots, emb)
    new["updated_at"] = store["updated_at"].index_copy(
        0, slots, _col(updated_at, torch.int32, dev))
    new["version"] = store["version"].index_add(
        0, slots, torch.ones_like(slots, dtype=torch.int32))
    new["commit_ts"] = store["commit_ts"] + 1
    return new


def delete(store: Store, slots: torch.Tensor) -> Store:
    """Tombstone rows (tenant = -1 makes them invisible to every predicate)."""
    slots = slots.to(device=store["emb"].device, dtype=torch.int64)
    was_live = store["tenant"][slots] >= 0
    new = dict(store)
    new["tenant"] = store["tenant"].index_fill(0, slots, -1)
    new["doc_id"] = store["doc_id"].index_fill(0, slots, -1)
    new["version"] = store["version"].index_add(
        0, slots, torch.ones_like(slots, dtype=torch.int32))
    new["commit_ts"] = store["commit_ts"] + 1
    new["n_live"] = store["n_live"] - was_live.sum(dtype=torch.int32)
    return new


# ---------------------------------------------------------------------------
# write-ahead intent journal (crash consistency for the host-side publish)
# ---------------------------------------------------------------------------

#: publish steps in order; "commit" is the atomic flip, the rest are
#: host-side write-through that the journal makes redo-safe.
WRITE_STEPS = ("commit", "alloc", "ivf", "lex")

#: crash points the fault injector may fire between write steps, in order.
#: "prepare" = before the write ran; "intent" = after the journal record
#: exists but before anything published; the rest = after that step.
CRASH_POINTS = ("prepare", "intent") + WRITE_STEPS


@dataclasses.dataclass
class IntentRecord:
    """One write's journal entry: everything needed to redo its host-side
    publish steps, plus a done-set so redo after a crash replays each step
    exactly once."""
    op: str                                   # "ingest" | "update" | "delete"
    epoch: int                                # commit_count after this write
    store: Store                              # post-write snapshot
    state: str = "intent"                     # intent -> committed -> done
    done: set = dataclasses.field(default_factory=set)
    slot_updates: tuple = ()                  # (doc_id, slot) pairs (ingest)
    slot_removals: tuple = ()                 # doc_ids leaving the map (delete)
    free_take: int = 0                        # recycled slots consumed (ingest)
    free_add: tuple = ()                      # slots returned (delete)
    cursor_after: int | None = None           # fresh-frontier cursor (ingest)
    # sharded-arena allocator fields (ShardPlacement logs only)
    shard_free_take: tuple = ()               # per-shard recycled counts
    shard_free_add: tuple = ()                # (shard, slot) pairs (delete)
    shard_cursors_after: tuple | None = None  # per-shard fresh frontiers
    ivf_op: tuple | None = None               # ("add", slots, emb) | ("remove", slots)
    lex_op: tuple | None = None               # (slots, terms, tfs)


# ---------------------------------------------------------------------------
# host-side commit log (slot allocation + snapshot swap + instrumentation)
# ---------------------------------------------------------------------------

class TransactionLog:
    """Owns the current store snapshot and allocates slots.

    Readers call `snapshot()` and get a dict no later write changes.
    Writers go through ingest/update/delete. ``store=None`` starts from an
    empty arena on ``device`` (the card unless the caller asks for another).
    The ``ivf`` and ``lex`` write-through hooks stay None in this slice:
    the IVF and lexical arenas arrive with their slices, and only then do
    writes carry their (host-copied) payloads.
    """

    def __init__(self, cfg: StoreConfig, store: Store | None = None,
                 placement: ShardPlacement | None = None, *, device=None):
        self.cfg = cfg
        self._store = empty(cfg, device) if store is None else store
        self.device = self._store["emb"].device
        self._cursor = 0
        self._slot_of_doc: dict[int, int] = {}
        self._free_slots: list[int] = []      # tombstoned slots, LIFO recycled
        self.placement = placement
        if placement is not None:
            if placement.capacity != cfg.capacity:
                raise ValueError("placement capacity != store capacity")
            self._shard_cursor = [placement.region(s)[0]
                                  for s in range(placement.n_shards)]
            self._shard_free: list[list[int]] = [
                [] for _ in range(placement.n_shards)]
        # host-side seconds each write took to issue its commit
        self.write_latencies_s: list[float] = []
        # host mirror of the commit_ts watermark: every commit bumps both,
        # so (snapshot identity) == (commit_count value) without a device
        # sync -- the result cache keys on this.
        self.commit_count = 0
        self.ivf = None
        self.lex = None
        # optional FaultPlan (serving.faults): when attached, every write
        # checks the txn.<op>.<point> crash sites between publish steps.
        self.faults = None
        self._wal: IntentRecord | None = None
        self.journal: list[str] = []

    # -- reads ---------------------------------------------------------
    def snapshot(self) -> Store:
        return self._store

    def slot_of(self, doc_id: int) -> int:
        return self._slot_of_doc[doc_id]

    def has_doc(self, doc_id: int) -> bool:
        return int(doc_id) in self._slot_of_doc

    # -- crash consistency ---------------------------------------------
    def _crash(self, op: str, point: str) -> None:
        """Injected crash point BETWEEN write steps (serving.faults site
        txn.<op>.<point>)."""
        if self.faults is not None:
            self.faults.crashes(op, point)

    def _publish(self, rec: IntentRecord, *, inject: bool) -> None:
        """Run the host-side publish steps of a journaled write. The first
        step is THE commit: journal state, snapshot reference and the host
        commit counter flip together with no crash point inside; every
        later step is guarded by the record's done-set, so redo after a
        crash replays it exactly once."""
        crash = self._crash if inject else (lambda op, pt: None)
        if "commit" not in rec.done:
            rec.state = "committed"
            self._store = rec.store
            self.commit_count = rec.epoch
            rec.done.add("commit")
        crash(rec.op, "commit")
        if "alloc" not in rec.done:
            if rec.free_take:
                del self._free_slots[len(self._free_slots) - rec.free_take:]
            for sh, take in enumerate(rec.shard_free_take):
                if take:
                    free = self._shard_free[sh]
                    del free[len(free) - take:]
            self._slot_of_doc.update(rec.slot_updates)
            for d in rec.slot_removals:
                self._slot_of_doc.pop(d, None)
            if rec.free_add:
                self._free_slots.extend(rec.free_add)
            for sh, slot in rec.shard_free_add:
                self._shard_free[sh].append(slot)
            if rec.cursor_after is not None:
                self._cursor = rec.cursor_after
            if rec.shard_cursors_after is not None:
                self._shard_cursor = list(rec.shard_cursors_after)
            rec.done.add("alloc")
        crash(rec.op, "alloc")
        if "ivf" not in rec.done:
            if self.ivf is not None and rec.ivf_op is not None:
                if rec.ivf_op[0] == "add":
                    self.ivf.add_rows(rec.ivf_op[1], rec.ivf_op[2])
                else:
                    self.ivf.remove_slots(rec.ivf_op[1])
            rec.done.add("ivf")
        crash(rec.op, "ivf")
        if "lex" not in rec.done:
            if self.lex is not None and rec.lex_op is not None:
                self.lex.write_rows(*rec.lex_op)
            rec.done.add("lex")
        crash(rec.op, "lex")
        rec.state = "done"
        self._wal = None
        self._log_outcome(rec, "done")

    def _log_outcome(self, rec: IntentRecord, outcome: str) -> None:
        self.journal.append(f"{rec.op}@{rec.epoch} {outcome}")
        if len(self.journal) > 64:
            del self.journal[:-64]

    def recover(self) -> str:
        """Recover from a crash at any injected point: ``"noop"`` (no
        in-flight record), ``"rolled-back"`` (intent journaled, commit never
        happened) or ``"rolled-forward"`` (the commit flip happened; the
        remaining publish steps run with injection disabled)."""
        rec = self._wal
        if rec is None:
            return "noop"
        if rec.state == "intent":
            self._wal = None
            self._log_outcome(rec, "rolled-back")
            return "rolled-back"
        self._publish(rec, inject=False)
        self.journal[-1] = f"{rec.op}@{rec.epoch} rolled-forward"
        return "rolled-forward"

    # -- writes --------------------------------------------------------
    def _alloc_slots(self, batch: DocBatch, m: int):
        """Pick the m slots an ingest will write. Peek (don't pop) in both
        allocators: state only advances at the journaled alloc step, so a
        failed write leaks nothing. Returns (slot_list, the IntentRecord
        alloc fields that publish the allocation)."""
        if self.placement is None:
            n_fresh_avail = self.cfg.capacity - self._cursor
            if m > len(self._free_slots) + n_fresh_avail:
                raise RuntimeError("store arena full — grow capacity or compact")
            n_recycled = min(m, len(self._free_slots))
            recycled = self._free_slots[len(self._free_slots) - n_recycled:][::-1]
            n_fresh = m - n_recycled
            slot_list = recycled + list(range(self._cursor, self._cursor + n_fresh))
            return slot_list, dict(free_take=n_recycled,
                                   cursor_after=self._cursor + n_fresh)
        pl = self.placement
        tenants = torch.as_tensor(batch.tenant).cpu().tolist()
        doc_ids = torch.as_tensor(batch.doc_id).cpu().tolist()
        take = [0] * pl.n_shards
        cursors = list(self._shard_cursor)
        slot_list: list[int] = []
        for t, d in zip(tenants, doc_ids):
            sh = pl.shard_of_doc(int(t), int(d))
            free = self._shard_free[sh]
            if take[sh] < len(free):
                take[sh] += 1
                slot_list.append(free[len(free) - take[sh]])
            else:
                if cursors[sh] >= pl.region(sh)[1]:
                    raise RuntimeError(
                        f"shard {sh} region full — grow capacity or rebalance")
                slot_list.append(cursors[sh])
                cursors[sh] += 1
        return slot_list, dict(shard_free_take=tuple(take),
                               shard_cursors_after=tuple(cursors))

    def _slots(self, slot_list) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slot_list, np.int64),
                               device=self.device)

    def ingest(self, batch: DocBatch) -> None:
        m = batch.size
        slot_list, alloc_fields = self._alloc_slots(batch, m)
        slots = self._slots(slot_list)
        self._crash("ingest", "prepare")
        t0 = time.perf_counter()
        new = ingest(self._store, self.cfg, slots, batch.emb, batch.tenant,
                     batch.category, batch.updated_at, batch.acl, batch.doc_id)
        self.write_latencies_s.append(time.perf_counter() - t0)
        doc_ids = torch.as_tensor(batch.doc_id).cpu().tolist()
        rec = IntentRecord(
            op="ingest", epoch=self.commit_count + 1, store=new,
            slot_updates=tuple(zip(doc_ids, slot_list)),
            ivf_op=(("add", slot_list, torch.as_tensor(batch.emb).cpu().numpy())
                    if self.ivf is not None else None),
            lex_op=((slot_list, batch.terms, batch.tfs)
                    if self.lex is not None else None),
            **alloc_fields)
        self._wal = rec                     # write-ahead: journal the intent
        self._crash("ingest", "intent")
        self._publish(rec, inject=True)

    def update(self, doc_ids, new_emb, updated_at) -> None:
        slot_list = [self._slot_of_doc[int(d)] for d in doc_ids]
        slots = self._slots(slot_list)
        self._crash("update", "prepare")
        t0 = time.perf_counter()
        new = update(self._store, self.cfg, slots, new_emb, updated_at)
        self.write_latencies_s.append(time.perf_counter() - t0)
        rec = IntentRecord(
            op="update", epoch=self.commit_count + 1, store=new,
            ivf_op=(("add", slot_list, torch.as_tensor(new_emb).cpu().numpy())
                    if self.ivf is not None else None))
        self._wal = rec
        self._crash("update", "intent")
        self._publish(rec, inject=True)

    def delete(self, doc_ids) -> list[int]:
        """Tombstone the given docs. Returns the freed slots (one per unique
        doc_id, in dedup order)."""
        slot_list = [self._slot_of_doc[d]
                     for d in dict.fromkeys(int(d) for d in doc_ids)]
        self._crash("delete", "prepare")
        new = delete(self._store, self._slots(slot_list))
        rec = IntentRecord(
            op="delete", epoch=self.commit_count + 1, store=new,
            slot_removals=tuple(int(d) for d in doc_ids),
            free_add=() if self.placement is not None else tuple(slot_list),
            shard_free_add=(tuple((self.placement.shard_of_slot(s), s)
                                  for s in slot_list)
                            if self.placement is not None else ()),
            ivf_op=("remove", slot_list) if self.ivf is not None else None,
            lex_op=(slot_list, None, None) if self.lex is not None else None)
        self._wal = rec
        self._crash("delete", "intent")
        self._publish(rec, inject=True)
        return slot_list

    @property
    def inconsistency_window_s(self) -> float:
        """0 by construction: embedding + metadata commit in one snapshot
        swap; `snapshot()` returns either the pre- or post-commit dict."""
        return 0.0
