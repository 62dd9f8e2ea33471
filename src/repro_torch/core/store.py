"""Unified document store -- the paper's "one database" as a device-resident
columnar tensor arena (port of ``repro.core.store``).

Everything a production RAG query needs lives in ONE dict of tensors:
  emb        (N, D)  float32 embeddings (unit-normalized when metric == cosine)
  tenant     (N,)    int32 tenant id (-1 = free/tombstoned slot)
  category   (N,)    int32 category id (< 32 so predicate sets are bitmasks)
  updated_at (N,)    int32 seconds since store epoch
  acl        (N,)    int32 holding the uint32 bit pattern of the permitted
                     principal groups (torch has no full uint32 arithmetic;
                     the kernels read the bits with unsigned shifts)
  doc_id     (N,)    int32 external document id
  version    (N,)    int32 row version (bumped on every update)
  commit_ts  ()      int32 store-level commit watermark
  n_live     ()      int32 number of live rows

Writes never touch a published snapshot: every write builds the next
state out of place (see ``core.transactions``), so a reader holding an old
dict keeps an unchanging view (MVCC by immutability).

A hot arena row-sharded over a mesh of several devices (``RagDB(mesh=)``,
`launch.mesh.device_groups`) is held in one allocation a device: each
covers that device's regions back to back, in row order. Its snapshot is
``{"allocs": (store, ...), "commit_ts": ..., "n_live": ...}``: the
per-device stores of the seven row columns, and the shared scalars on the
controller device. Whole-arena readers (``store["emb"]``) hold only on a
store of one allocation, which is the plain dict above; `allocations`,
`n_rows`, `controller`, `gather` and `to_numpy` read either.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch.mesh import same_device

Store = dict[str, torch.Tensor]

#: store columns in the reference's order
COLUMNS = ("emb", "tenant", "category", "updated_at", "acl", "doc_id",
           "version", "commit_ts", "n_live")
#: the columns with one entry a row (an allocation holds these)
ROW_COLUMNS = COLUMNS[:7]
#: the key of a store held in several allocations
ALLOCS = "allocs"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Raises when CUDA is asked for (explicitly or by default)
    and no card is present -- the port never carries on on the CPU
    quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    capacity: int                 # arena rows (power of two preferred)
    dim: int                      # embedding dim
    metric: str = "cosine"        # "cosine" | "dot"
    dtype: str = "float32"
    n_categories: int = 32        # must stay <= 32 (bitmask predicates)
    n_acl_groups: int = 32


def _empty_rows(cfg: StoreConfig, n: int, dev) -> Store:
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "emb": torch.zeros((n, cfg.dim), dtype=getattr(torch, cfg.dtype),
                           device=dev),
        "tenant": torch.full((n,), -1, **i32),
        "category": torch.zeros((n,), **i32),
        "updated_at": torch.zeros((n,), **i32),
        "acl": torch.zeros((n,), **i32),
        "doc_id": torch.full((n,), -1, **i32),
        "version": torch.zeros((n,), **i32),
    }


def empty(cfg: StoreConfig, device=None, allocs=None) -> Store:
    """An empty arena of ``cfg.capacity`` rows on ``device``. ``allocs``,
    ((device, rows), ...) in row order with the rows summing to the
    capacity, lays it out in one allocation each, the scalars on
    ``device`` (the controller); with one entry, or None, the arena is one
    allocation on ``device``."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    scalars = {"commit_ts": torch.zeros((), **i32),
               "n_live": torch.zeros((), **i32)}
    if allocs is None or len(allocs) == 1:
        return {**_empty_rows(cfg, cfg.capacity, dev), **scalars}
    if sum(rows for _, rows in allocs) != cfg.capacity:
        raise ValueError(f"allocations of {[r for _, r in allocs]} rows do "
                         f"not make the capacity {cfg.capacity}")
    return {ALLOCS: tuple(_empty_rows(cfg, rows, resolve_device(d))
                          for d, rows in allocs), **scalars}


def upload(x, device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``; to a card by an
    asynchronous copy from pinned memory on that card's current stream,
    so that neither the host nor another card's stream waits for it (a
    copy from one card to another would tie the two cards' streams)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_device(x, device) -> torch.Tensor:
    """``x`` on ``device``: a host array by `upload`, a tensor on another
    card by an asynchronous copy between the cards (no host sync; the two
    cards' streams are tied for it), a tensor already there as it is."""
    if isinstance(x, np.ndarray) or x.device.type == "cpu":
        return upload(x, device)
    if same_device(x.device, device):
        return x
    return x.to(device, non_blocking=True)


def allocations(store: Store) -> tuple:
    """The store's allocations in row order, each a dict of the row
    columns: the store itself when it is one allocation."""
    return store[ALLOCS] if ALLOCS in store else (store,)


def row_starts(store: Store) -> list[int]:
    """The first row of each allocation."""
    starts, lo = [], 0
    for part in allocations(store):
        starts.append(lo)
        lo += part["emb"].shape[0]
    return starts


def layout(store: Store) -> tuple:
    """((device, first row, rows), ...): the allocations in row order, the
    layout that the lexical lanes and the IVF mirrors of a store held in
    several allocations copy."""
    return tuple((part["emb"].device, lo, part["emb"].shape[0])
                 for lo, part in zip(row_starts(store), allocations(store)))


def split_slots(bounds, slots) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """The global ``slots`` split by allocation, ``bounds`` ((first row,
    rows), ...) in row order: (allocation, positions in ``slots``, local
    slots) for each allocation a slot hits, in row order.

    >>> [(i, p.tolist(), s.tolist())
    ...  for i, p, s in split_slots([(0, 4), (4, 4)], [5, 1, 6])]
    [(0, [1], [1]), (1, [0, 2], [1, 2])]
    """
    slots = np.asarray(slots, np.int64).reshape(-1)
    out = []
    for i, (lo, rows) in enumerate(bounds):
        pos = np.flatnonzero((slots >= lo) & (slots < lo + rows))
        if len(pos):
            out.append((i, pos, slots[pos] - lo))
    return out


def n_rows(store: Store) -> int:
    """The arena's rows, all allocations together."""
    return sum(part["emb"].shape[0] for part in allocations(store))


def controller(store: Store) -> torch.device:
    """The device that uploads queries and merges lists: the scalars'
    device (the store's device when it is one allocation)."""
    return store["n_live" if ALLOCS in store else "emb"].device


def gather(store: Store, name: str, slots) -> list[int]:
    """Row column ``name`` at the global ``slots``, as host ints, each
    read on its allocation's device."""
    slots = np.asarray(slots, np.int64)
    out = np.zeros(len(slots), np.int64)
    parts = allocations(store)
    for i, pos, local in split_slots([(lo, rows) for _, lo, rows
                                      in layout(store)], slots):
        col = parts[i][name]
        out[pos] = col[torch.as_tensor(local, device=col.device)].cpu().numpy()
    return out.tolist()


def normalize(cfg: StoreConfig, emb: torch.Tensor) -> torch.Tensor:
    if cfg.metric == "cosine":
        norm = torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True)
        return (emb / torch.clamp(norm, min=1e-12)).to(emb.dtype)
    return emb


def from_numpy(snapshot: dict, device=None) -> Store:
    """A store from numpy columns (e.g. the reference's snapshot after
    ``jax.device_get``). ``acl`` may arrive as uint32; its bit pattern is
    kept as int32."""
    dev = resolve_device(device)
    out = {}
    for k in COLUMNS:
        a = np.asarray(snapshot[k])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)
    return out


def to_numpy(store: Store) -> dict[str, np.ndarray]:
    """The store's columns as numpy arrays, in the reference's dtypes
    (``acl`` as uint32); the allocations' rows concatenated in row order,
    as the reference's ``jax.device_get`` gives a sharded store."""
    parts = allocations(store)
    out = {k: np.concatenate([p[k].cpu().numpy() for p in parts])
           for k in ROW_COLUMNS}
    out.update({k: store[k].cpu().numpy() for k in COLUMNS[7:]})
    out["acl"] = out["acl"].view(np.uint32)
    return out


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    """Row placement over ``n_shards`` contiguous, equally sized slot
    regions: shard s owns [s * rows_per_shard, (s+1) * rows_per_shard).

    kind:
      * ``"hash"``   -- docs route by ``doc_id % n_shards``;
      * ``"tenant"`` -- docs route by ``tenant % n_shards`` (tenant-affine).
    """
    n_shards: int
    capacity: int
    kind: str = "hash"            # "hash" | "tenant"

    def __post_init__(self):
        if self.kind not in ("hash", "tenant"):
            raise ValueError(f"unknown placement kind {self.kind!r}")
        if self.capacity % self.n_shards:
            raise ValueError(
                f"capacity {self.capacity} not divisible by {self.n_shards} shards")

    @property
    def rows_per_shard(self) -> int:
        return self.capacity // self.n_shards

    def region(self, shard: int) -> tuple[int, int]:
        """Slot range [start, stop) owned by ``shard``."""
        return shard * self.rows_per_shard, (shard + 1) * self.rows_per_shard

    def shard_of_slot(self, slot: int) -> int:
        return slot // self.rows_per_shard

    def locate(self, slot: int) -> tuple[int, int]:
        """Global slot -> (shard, shard-local slot)."""
        return divmod(slot, self.rows_per_shard)

    def shards_of(self, tenant, doc_id) -> np.ndarray:
        """Write-path routing, array-valued: the shard whose region each new
        doc allocates in (int64, the shape of the keys)."""
        key = tenant if self.kind == "tenant" else doc_id
        return np.mod(np.asarray(key, np.int64), self.n_shards)

    def shard_of_doc(self, tenant: int, doc_id: int) -> int:
        """`shards_of` for one doc."""
        return int(self.shards_of(tenant, doc_id))


@dataclasses.dataclass(frozen=True)
class DocBatch:
    """A batch of documents headed into the store. Fields are tensors
    (numpy arrays are accepted and moved at ingest); ``acl`` holds the
    uint32 bit pattern as int32. ``terms``/``tfs`` are the optional lexical
    lanes, carried for the hybrid slice of the port."""
    emb: torch.Tensor          # (M, D)
    tenant: torch.Tensor       # (M,) int32
    category: torch.Tensor     # (M,) int32
    updated_at: torch.Tensor   # (M,) int32
    acl: torch.Tensor          # (M,) int32 (uint32 bits)
    doc_id: torch.Tensor       # (M,) int32
    terms: torch.Tensor | None = None   # (M, T) int32 term ids, -1 empty lane
    tfs: torch.Tensor | None = None     # (M, T) int32 term frequencies

    @property
    def size(self) -> int:
        return self.emb.shape[0]


def live_mask(store: Store) -> torch.Tensor:
    return store["tenant"] >= 0
