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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Store = dict[str, torch.Tensor]

#: store columns in the reference's order
COLUMNS = ("emb", "tenant", "category", "updated_at", "acl", "doc_id",
           "version", "commit_ts", "n_live")


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


def empty(cfg: StoreConfig, device=None) -> Store:
    dev = resolve_device(device)
    N, D = cfg.capacity, cfg.dim
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "emb": torch.zeros((N, D), dtype=getattr(torch, cfg.dtype),
                           device=dev),
        "tenant": torch.full((N,), -1, **i32),
        "category": torch.zeros((N,), **i32),
        "updated_at": torch.zeros((N,), **i32),
        "acl": torch.zeros((N,), **i32),
        "doc_id": torch.full((N,), -1, **i32),
        "version": torch.zeros((N,), **i32),
        "commit_ts": torch.zeros((), **i32),
        "n_live": torch.zeros((), **i32),
    }


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
    (``acl`` as uint32)."""
    out = {k: store[k].cpu().numpy() for k in COLUMNS}
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
