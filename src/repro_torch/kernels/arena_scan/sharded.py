"""The sharded engine's arena scan (port of
``repro.kernels.arena_scan.sharded``).

The hot arena is row-sharded in contiguous, slot-aligned regions
(`repro_torch.core.store.ShardPlacement`): shard s owns rows
[s * n_local, (s + 1) * n_local). One controller drives every shard (the
reference's single-controller ``shard_map``): each scanned shard runs the
dense arena scan on a VIEW of its region -- row slices of its
allocation's ``emb`` and packed metadata, so no arena byte is copied --
keeps its local list, and the lists merge into the global top-k. On the
card a shard's scan is the CUDA arena-scan kernel (`kernel.arena_scan_cuda`,
dense `ScanSpec`, one launch a scanned shard); on the CPU its plain
version.

The mesh's shards may sit on several devices (`launch.mesh.device_groups`;
the store then holds one allocation a device, ``core.store``). Each shard
scans on its allocation's device, which receives the query rows from the
host and the predicate once a launch; once every scan is queued, each
list, with its doc ids and global slots, is copied to the controller (the
store's scalars' device), where the merge runs. A copy between two cards
is made on the source's current stream after the destination's current
stream is caught up, and the destination's stream waits for it
(PyTorch's device-to-device copy), so the merge is ordered after every
copy without a host sync -- and the controller's stream waits for each
card, which is why nothing a card needs is copied from the controller.
A region is never scanned on another device, and a launch that fails
raises.

Determinism contract (placement invariance): the result is the exact
lexicographic top-k in (score desc, global doc_id asc). The kernel breaks
ties by (score desc, slot asc), so a shard's kernel list is the right set
only when no run of tied scores reaches past its end. Each shard is
therefore launched with k + 1 entries; where its (k+1)-th score equals its
k-th (above NEG_INF), the whole tie run may not be in the list, and the
shard is launched again with twice the entries, until the run ends inside
the list or the list holds the whole region. The merge of the lists is one
2-key order over their union (`lex_merge`): every entry of a list that is
not in its shard's lexicographic top-k has k entries of that shard ahead
of it, so it never reaches the global top-k. No tie is rescored: a torch
matmul rounds differently from the kernel's fp32 chain.

No host sync at launch: `ShardedScan.launch` queues the shard scans, the
merge and each shard's tie check on the device and returns. The merge is
speculative: `ShardedLaunch.finish` reads the tie flags (the first copy to
the host) and relaunches the shards that need it, then merges again. Only
the real query rows are checked: the zero rows that pad a group to its
bucket score 0 on every qualifying row, a tie that would widen every shard
for rows nobody reads.

Tenant-affine skip: under a ``"tenant"`` placement a tenant-scoped
predicate names its owning shard (tenant % S). The skip is decided from
the host predicate, never from a device read, so every other shard's scan
is never launched, and the per-shard ``rows_scanned`` vector (host ints)
audits it.

The reference gathers three (B_pad, k) lists a shard (B padded to 8 lanes)
and counts the bytes from its compiled HLO; `sharded_collective_bytes`
counts the same lists the same way, so `ExecStats.collective_bytes` equals
the reference's (not the bytes copied between cards).

>>> import torch
>>> s, d, p = lex_topk(torch.tensor([[1.0, 3.0, 3.0, 2.0]]),
...                    torch.tensor([9, 7, 4, 1]), 3)
>>> s.tolist(), d.tolist(), p.tolist()
([[3.0, 3.0, 2.0]], [[4, 7, 1]], [[2, 1, 3]])
>>> sharded_collective_bytes(4, 1, 10, 1 << 21)
3840
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.store import allocations, controller
from repro_torch.core.store import n_rows as store_rows
from repro_torch.core.store import upload
from repro_torch.distributed.collectives import (allgather_bytes,
                                                 lex_order)
from repro_torch.kernels.arena_scan.ops import _packed_meta
from repro_torch.kernels.arena_scan.stages import NEG_INF
from repro_torch.kernels.filtered_topk.filtered_topk import filtered_topk_cuda
from repro_torch.launch.mesh import device_groups, tensor_device
from repro_torch.launch.mesh import n_shards as mesh_shards

INT32_MAX = 2**31 - 1
#: shard scans launched again, wider, because a run of tied scores reached
#: the end of the shard's list (`ShardedLaunch.finish`)
TIE_WIDENS = 0


def lex_topk(scores: torch.Tensor, doc_ids: torch.Tensor, k: int):
    """Exact lexicographic (score desc, doc_id asc) top-k over columns.

    scores: (B, n) f32 (masked rows NEG_INF); doc_ids: (n,) int32, unique
    among rows with score > NEG_INF. Returns (scores (B, k), doc_ids (B, k)
    int32, positions (B, k) int32); past the n columns the entries are
    (NEG_INF, INT32_MAX, -1)."""
    b, n = scores.shape
    ids_b = doc_ids.to(torch.int32)[None, :].expand(b, n)
    order = lex_order(scores, ids_b)[:, :k]
    s, d = torch.gather(scores, 1, order), torch.gather(ids_b, 1, order)
    p = order.to(torch.int32)
    if n < k:
        pad = (0, k - n)
        s = torch.nn.functional.pad(s, pad, value=NEG_INF)
        d = torch.nn.functional.pad(d, pad, value=INT32_MAX)
        p = torch.nn.functional.pad(p, pad, value=-1)
    return s, d, p


def lex_merge(scores: torch.Tensor, doc_ids: torch.Tensor,
              slots: torch.Tensor, k: int):
    """Merge gathered per-shard lists (B, M) under the same (score desc,
    doc_id asc) order. Returns (scores (B, k), slots (B, k)); slots of
    non-qualifying entries come back -1."""
    order = lex_order(scores, doc_ids)[:, :k]
    top_s = torch.gather(scores, 1, order)
    return top_s, torch.where(top_s > NEG_INF,
                              torch.gather(slots, 1, order), -1)


def sharded_collective_bytes(n_shards: int, b: int, k: int,
                             n_local: int) -> int:
    """Wire bytes of the reference's merge for a (b, D) query block: three
    all-gathers (scores f32, doc ids i32, slots i32) of a (B_pad, k) list
    from each shard, B_pad = b rounded up to 8 lanes. XLA removes what its
    program does not need: with one candidate in all (S * k == 1) the merge
    is the identity, so the doc-id gather is dead, and with one row a shard
    too the slot is a constant, so only the scores are gathered."""
    shape = (-(-b // 8) * 8, k)
    n_lists = 3
    if n_shards * k == 1:
        n_lists = 1 if n_local == 1 else 2
    return n_lists * allgather_bytes(shape, torch.float32, n_shards)


def _host_tenant(pred) -> int:
    """The predicate's tenant clause, read on the host: a `Predicate`, or
    its (4,) array on the CPU. A tensor on the card would need a sync."""
    if hasattr(pred, "tenant"):
        return int(pred.tenant)
    if isinstance(pred, torch.Tensor) and pred.device.type != "cpu":
        raise ValueError("the sharded scan decides its shard skip on the "
                         "host: pass a Predicate or a host (4,) array")
    return int(torch.as_tensor(pred).reshape(-1)[0])


def _pred_array(pred, dev) -> torch.Tensor:
    if hasattr(pred, "as_array"):
        return pred.as_array(dev)
    return torch.as_tensor(pred, dtype=torch.int32).reshape(4).to(dev)


class _Alloc(NamedTuple):
    """What a launch's shards read on one allocation's device: the query
    rows and predicate uploaded there, the allocation's ``emb``, packed
    metadata and doc ids, and its first shard."""
    q: torch.Tensor
    pred: torch.Tensor
    emb: torch.Tensor
    meta: torch.Tensor
    doc: torch.Tensor
    first: int


class ShardedLaunch:
    """One sharded scan in flight: the shards' lists on their devices,
    their copies and the speculative merge on the controller, ``rows``
    (per-shard rows scanned) on the host. `finish` returns the exact
    lists."""

    def __init__(self, scan: "ShardedScan", ctrl, allocs: dict,
                 parts: list, rows: list[int], n_valid: int):
        self.scan, self.ctrl, self.allocs = scan, ctrl, allocs
        self.parts = parts                   # [(shard, scores, slots)]
        self.rows = rows
        self.n_valid = n_valid               # real rows (the rest pad)
        self.lists = [scan._lists(allocs[sh], sh, sc, sl, ctrl)
                      for sh, sc, sl in parts]
        self.scores, self.slots = scan._merge(self.lists)
        k, n_local = scan.k, scan.n_local
        self.checked = [j for j, (_, sc, _) in enumerate(parts)
                        if sc.shape[1] < n_local]
        self.flags = (torch.stack([
            _tie_reaches_end(parts[j][1][:n_valid], k).to(
                ctrl, non_blocking=True) for j in self.checked])
            if self.checked else None)

    def finish(self):
        """(scores (B, k), slots (B, k)) tensors: the speculative merge, or,
        where a shard's tie run reached its list's end, the merge after
        that shard's wider relaunches on its own device (this reads the
        flags: a sync)."""
        global TIE_WIDENS
        if self.flags is None:
            return self.scores, self.slots
        tied = self.flags.cpu().tolist()
        self.flags = None
        redo = [j for j, t in zip(self.checked, tied) if t]
        if not redo:
            return self.scores, self.slots
        scan = self.scan
        for j in redo:
            shard, sc, sl = self.parts[j]
            alloc = self.allocs[shard]
            kk = sc.shape[1]
            while kk < scan.n_local and bool(
                    _tie_reaches_end(sc[:self.n_valid], scan.k)):
                kk = min(2 * kk, scan.n_local)
                sc, sl = scan._scan_shard(alloc, shard, kk)
                TIE_WIDENS += 1
            self.parts[j] = (shard, sc, sl)
            self.lists[j] = scan._lists(alloc, shard, sc, sl, self.ctrl)
        self.scores, self.slots = scan._merge(self.lists)
        return self.scores, self.slots


def _tie_reaches_end(sc: torch.Tensor, k: int) -> torch.Tensor:
    """0-dim bool on sc's device: in some row the run of scores tied at the
    k-th place (above NEG_INF) reaches the list's last entry."""
    kth = sc[:, k - 1]
    return ((sc[:, -1] == kth) & (kth > NEG_INF)).any()


class ShardedScan:
    """The shard-mapped unified query over a row-sharded hot arena of
    ``n_rows`` rows, LIMIT ``k``. ``scan(store, q, pred) -> (scores (B, k)
    f32, slots (B, k) int32, rows_scanned (S,) int32 on the host)``; the
    lists are the exact (score, doc_id)-lexicographic top-k of the
    unsharded arena. `launch` / `ShardedLaunch.finish` split the call at
    the first host sync. ``pred`` is a `Predicate` (or its (4,) array on
    the CPU): its tenant clause decides the affine skip on the host. The
    store holds one allocation for each of the mesh's devices
    (`launch.mesh.device_groups`), in shard order."""

    def __init__(self, mesh, axes, n_rows: int, k: int, *,
                 placement_kind: str = "hash"):
        self.n_shards = mesh_shards(mesh, axes)
        if n_rows % self.n_shards:
            raise ValueError(f"n_rows {n_rows} not divisible by "
                             f"{self.n_shards} shards")
        self.n_local = n_rows // self.n_shards
        self.n_rows, self.k = n_rows, k
        self.affine = placement_kind == "tenant"
        self.groups = device_groups(mesh, axes)

    def active(self, tenant: int) -> list[int]:
        """The shards a predicate with this tenant clause scans: the owning
        shard alone for a tenant-scoped predicate under tenant placement,
        else all of them."""
        if self.affine and tenant >= 0:
            return [tenant % self.n_shards]
        return list(range(self.n_shards))

    def _scan_shard(self, alloc: _Alloc, shard: int, kk: int):
        """One shard's local top-kk (ties to the lower slot) on the views
        of its region, on its allocation's device; slots are
        region-local."""
        lo = (shard - alloc.first) * self.n_local
        hi = lo + self.n_local
        return filtered_topk_cuda(alloc.q, alloc.emb[lo:hi],
                                  alloc.meta[lo:hi], alloc.pred, kk)

    def _lists(self, alloc: _Alloc, shard: int, sc, sl, ctrl):
        """A shard's (scores, doc ids, global slots), read on its device
        and copied to the controller ``ctrl`` without a host sync."""
        lo = (shard - alloc.first) * self.n_local
        live = sl >= 0
        local = sl.clamp(min=0).long()
        d = torch.where(live, alloc.doc[lo:lo + self.n_local][local],
                        INT32_MAX)
        g = torch.where(live, sl + shard * self.n_local, -1)
        return tuple(t.to(ctrl, non_blocking=True) for t in (sc, d, g))

    def _merge(self, lists):
        """Global (score, doc_id) top-k over the shards' lists, on the
        controller."""
        return lex_merge(*(torch.cat(cols, 1) for cols in zip(*lists)),
                         self.k)

    @property
    def collective_bytes(self) -> int:
        """The merge's wire bytes for one launch, counted once at the B = 1
        query shape (the 8-lane padded gather every B <= 8 launch shares),
        as the reference measures them once from its compiled program."""
        return sharded_collective_bytes(self.n_shards, 1, self.k,
                                        self.n_local)

    def _check_store(self, store) -> tuple:
        """The store's allocations, one a group of the mesh on its
        device with its shards' rows; raises otherwise."""
        if store_rows(store) != self.n_rows:
            raise ValueError(f"store has {store_rows(store)} rows, the scan "
                             f"was built for {self.n_rows}")
        parts = allocations(store)
        have = tuple((p["emb"].device, p["emb"].shape[0]) for p in parts)
        want = tuple((tensor_device(d), len(sh) * self.n_local)
                     for d, sh in self.groups)
        if have != want:
            raise ValueError(
                f"the mesh's devices {tuple(d for d, _ in self.groups)} "
                f"are not the store's devices: its allocations (device, "
                f"rows) are {have}, the mesh's {want}")
        return parts

    def launch(self, store, q, pred, n_valid: int | None = None
               ) -> ShardedLaunch:
        """Queue every scanned shard's kernel on its allocation's device,
        the copies of the lists, the merge and the tie checks on the
        controller; no host sync. ``q`` is best given on the host: each
        device then receives it by its own copy, and no card's stream
        waits on the controller's. ``n_valid`` is the count of real rows
        when q is padded to a bucket: the tie checks read only those. The
        packed metadata is memoised per allocation and snapshot
        (`ops._packed_meta`), so only a snapshot's first launch packs
        it."""
        parts = self._check_store(store)
        ctrl = controller(store)
        on_card = isinstance(q, torch.Tensor) and q.device.type != "cpu"
        if not on_card:
            q = torch.as_tensor(q, dtype=torch.float32).contiguous()
        # only a tenant-affine scan skips shards: the others never read
        # the predicate's tenant on the host
        active = (self.active(_host_tenant(pred)) if self.affine
                  else list(range(self.n_shards)))
        allocs = {}
        for part, (_, shards) in zip(parts, self.groups):
            if not any(s in active for s in shards):
                continue
            dev = part["emb"].device
            alloc = _Alloc(
                q=(q.to(dev, non_blocking=True) if on_card else
                   upload(q, dev)),
                pred=_pred_array(pred, dev), emb=part["emb"],
                meta=_packed_meta(part["tenant"], part["updated_at"],
                                  part["category"], part["acl"]),
                doc=part["doc_id"], first=shards[0])
            allocs.update(dict.fromkeys(shards, alloc))
        kk = self.k + 1
        scanned = [(s, *self._scan_shard(allocs[s], s, kk)) for s in active]
        rows = [self.n_local if s in active else 0
                for s in range(self.n_shards)]
        return ShardedLaunch(self, ctrl, allocs, scanned, rows,
                             q.shape[0] if n_valid is None else n_valid)

    def __call__(self, store, q, pred):
        launched = self.launch(store, q, pred)
        s, sl = launched.finish()
        return s, sl, torch.tensor(launched.rows, dtype=torch.int32)


def make_sharded_arena_scan(mesh, axes, n_rows: int, k: int, *,
                            placement_kind: str = "hash") -> ShardedScan:
    """Build the shard-mapped unified query over a row-sharded hot arena
    (``mesh`` a `launch.mesh.Mesh`, ``axes`` the sharded axis or axes).
    Returns a `ShardedScan`: ``fn(store, q, pred) -> (scores (B, k), slots
    (B, k), rows_scanned (S,))``. ``placement_kind="tenant"`` enables the
    affine shard skip (the arena must be placed tenant-affine --
    `ShardPlacement(kind="tenant")` -- for it to be sound). The store
    holds one allocation a device of the mesh."""
    return ShardedScan(mesh, axes, n_rows, k, placement_kind=placement_kind)
