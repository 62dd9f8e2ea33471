"""IVF cluster index -- the pruned route of the unified scan (port of
``repro.core.ivf``).

A coarse quantizer (one small product with C centroids) selects nprobe
clusters, and the fused filtered scan runs only over those clusters' rows.
The executor runs the quantizer on the index's device (`probe_device`:
the product, each row's top nprobe and their union, with no host round
trip); `IVFIndex.probe` is the same union on the host, the reference's
contract, which the audits (`candidate_rows`) and the tests use.

Layout: a padded cluster-major MEMBER table (C, cap) of arena slot ids. The
probe takes the deduplicated union of the predicate group's probed clusters
and reads those members' embeddings + metadata from the ARENA once per
group (kernels/ivf_probe) -- slot-indirect, so the arena stays the single
source of truth and the index never carries a second copy of any column.

Rows that don't fit their cluster's cap land in an explicit ``overflow``
tail that every probe scans exactly -- overfull clusters cost a little
speed, never recall.

The predicate mask still runs INSIDE the probe scan, on arena metadata:
IVF changes which rows are scored, never which rows may be returned --
isolation is preserved even against a corrupted member table.

Maintenance is incremental and host-side (numpy, as in the reference):
writes assign new rows to their nearest centroid (recycling member-table
slots), `epoch` bumps on every (re)build so snapshot-keyed caches stay
exact, and accumulated churn past ``drift_rebuild_frac`` of the built size
marks the index for a rebuild. The device mirror is patched in place: a
write marks the touched member-table rows, and the next probe uploads only
those (see `IVFIndex.device_arrays`).

The build differs from the reference in two ways, neither in what the
index means. k-means seeds are the live rows with the largest uniform
random keys (``jax.random.choice`` cannot be reproduced in torch), so a
port-built index is held to recall, not to the reference's bits. And the
Lloyd steps and the final assignment run in row chunks with ``index_add_``
for the cluster sums: the reference's (N, C) similarity and one-hot blocks
would be 256 GB each at 2^23 rows and 8192 clusters.

Over a hot arena held in several allocations (one a device,
``core.store``) each device assigns its own rows in the Lloyd steps and
the controller adds their cluster sums; the member table stays one, in
global slots, on the host, and `device_arrays` keeps one mirror a device
in that device's slots. The quantizer runs on the controller; its
probed clusters go to every device without a host sync, and each device
compacts and scans its own candidates (`probe_allocations`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.store import (ALLOCS, Store, allocations, controller,
                                    layout, resolve_device, row_starts,
                                    to_device)

#: largest (rows, C) f32 similarity block the build materialises (2 GiB)
_BLOCK_BYTES = 1 << 31


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    n_clusters: int = 64
    nprobe: int = 8
    cluster_cap: int | None = None   # padded rows per cluster; None = auto
                                     # (largest built cluster, 128-rounded)
    kmeans_iters: int = 10
    seed: int = 0
    drift_rebuild_frac: float = 0.25  # churn fraction that flags a rebuild


def _chunk_rows(n_clusters: int) -> int:
    """Rows per chunk so that a (rows, C) f32 block stays under
    `_BLOCK_BYTES`."""
    return max(1, _BLOCK_BYTES // (4 * max(int(n_clusters), 1)))


def _assign(emb: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid (argmax of the dot product, first index on ties)
    of every row, in row chunks: (N,) int64."""
    step = _chunk_rows(cent.shape[0])
    return torch.cat([torch.argmax(emb[s:s + step].float() @ cent.T, dim=1)
                      for s in range(0, emb.shape[0], step)])


def _sums(emb: torch.Tensor, live: torch.Tensor, cent: torch.Tensor):
    """Per-cluster sums (C, D) and counts (C,) of one allocation's live
    rows against ``cent`` (on emb's device), in row chunks; dead rows add
    zeros, so nothing here waits on the device."""
    C = cent.shape[0]
    sums = torch.zeros_like(cent)
    counts = torch.zeros(C, dtype=torch.float32, device=emb.device)
    step = _chunk_rows(C)
    for s in range(0, emb.shape[0], step):
        e = emb[s:s + step].float()
        w = live[s:s + step].float()
        a = torch.argmax(e @ cent.T, dim=1)
        sums.index_add_(0, a, e * w[:, None])
        counts.index_add_(0, a, w)
    return sums, counts


def _kmeans_allocations(embs, lives, n_clusters: int, iters: int, seed: int,
                        device) -> torch.Tensor:
    """Spherical Lloyd iterations over the live rows of one or more
    allocations (``embs`` / ``lives`` in row order); centroids (C, D) f32
    on ``device``, the controller. Seeds are C distinct live rows of the
    whole arena, the C largest of uniform random keys drawn over its rows
    on a generator seeded with ``seed`` on the controller, so that they
    depend on the live rows alone, not on how the arena is split. Each
    allocation's device assigns its own rows and sums its clusters; the
    sums and counts are reduced on the controller, every device's work
    queued before the reduction waits."""
    dev = torch.device(device)
    C = n_clusters
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.cat([live.to(dev) for live in lives])
    if not bool(w.any()):       # no live row: draw the seeds uniformly
        w = torch.ones_like(w)
    keys = torch.rand(w.shape, generator=gen, device=dev)
    init = torch.topk(torch.where(w, keys, -1.0), C).indices
    # each allocation gathers the seeds among its rows, on its device
    cent = torch.zeros((C, embs[0].shape[1]), dtype=torch.float32,
                       device=dev)
    lo = 0
    for emb in embs:
        hit = (init >= lo) & (init < lo + emb.shape[0])
        local = torch.where(hit, init - lo, 0).to(emb.device)
        cent = torch.where(hit[:, None], emb[local].float().to(dev), cent)
        lo += emb.shape[0]
    for _ in range(iters):
        parts = [_sums(emb, live, cent.to(emb.device))
                 for emb, live in zip(embs, lives)]
        sums, counts = parts[0]
        if len(parts) > 1:
            sums, counts = sums.to(dev), counts.to(dev)
            for s_i, c_i in parts[1:]:
                sums = sums + s_i.to(dev)
                counts = counts + c_i.to(dev)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts, min=1)[:, None], cent)
        norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        cent = new / torch.clamp(norm, min=1e-12)
    return cent


def _pow2(n: int, floor: int = 1) -> int:
    return 1 << max(max(int(n), floor) - 1, 0).bit_length()


def probe_union(q: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                u_pad: int) -> torch.Tensor:
    """The coarse quantizer on ``q``'s device: sims = q @ centroids.T in
    full f32 (TF32 off for the product), each row's top ``nprobe``
    clusters, and their deduplicated union ascending, -1 padded to
    ``u_pad`` (>= the union's size). Nothing here reads a result on the
    host, so on the card the whole quantizer is queued without a sync. It
    equals `IVFIndex.probe`'s union except where a row's nprobe-th and
    (nprobe+1)-th sims tie within the two products' rounding. Returns
    (u_pad,) int32."""
    dev = q.device
    C = centroids.shape[0]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sims = torch.matmul(q.to(torch.float32), centroids.T)   # (B, C)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    top = torch.topk(sims, nprobe, dim=1, sorted=False).indices
    # (index_fill_ takes its value as a scalar: an assignment of True would
    # copy it to the card and wait)
    hit = torch.zeros(C, dtype=torch.bool, device=dev).index_fill_(
        0, top.reshape(-1), True)
    # cluster c goes to the union's position (hits before c); misses to a
    # dropped slot past u_pad
    at = torch.where(hit, torch.cumsum(hit, 0) - 1, u_pad)
    out = torch.full((u_pad + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, at, torch.arange(C, dtype=torch.int32, device=dev))
    return out[:u_pad]


class IVFIndex:
    """Host-managed coarse index over the hot arena.

    Mutable on the host (incremental upkeep rides every commit), consumed on
    ``device`` through a cached mirror (`device_arrays`) that is PATCHED in
    place: a write marks the member-table rows it touched and the next probe
    uploads only those rows, so upload bytes scale with the write, not with
    the (C, cap) table. `epoch` identifies the centroid generation -- result
    caches key ivf-engine entries on it because a rebuild changes which
    rows get *scored* without any arena commit.

    >>> idx = IVFIndex(IVFConfig(n_clusters=2, nprobe=1),
    ...                np.eye(2, 4, dtype=np.float32),
    ...                np.array([[0, 2], [1, -1]], np.int32),
    ...                np.array([2, 1]), [5], n_at_build=4, device="cpu")
    >>> clusters, n_probed, rows = idx.probe(np.array([[0, 1, 0, 0]]), 1)
    >>> clusters.tolist(), n_probed, rows
    ([1], 1, 10)
    >>> idx.remove_slots([0]); idx.members.tolist(), idx.churn
    ([[2, -1], [1, -1]], 1)
    """

    def __init__(self, cfg: IVFConfig, centroids: np.ndarray,
                 members: np.ndarray, fill: np.ndarray, overflow: list[int],
                 n_at_build: int, epoch: int = 0, *, device=None,
                 regions=None):
        self.cfg = cfg
        self.centroids = centroids          # (C, D) f32, unit rows
        self.members = members              # (C, cap) i32 arena slots, -1 pad
        self.fill = fill                    # (C,) live entries per cluster
        self.overflow = list(overflow)      # spilled slots -- scanned exactly
        self.n_at_build = n_at_build
        self.epoch = epoch
        self.device = resolve_device(device)   # the centroids' device
        # ((device, first row, rows), ...) of a hot arena held in several
        # allocations (`core.store.layout`): one member-table mirror a
        # device, in its local slots; None keeps one mirror on ``device``
        self.regions = (tuple(regions) if regions is not None
                        and len(regions) > 1 else None)
        self.churn = 0                      # incremental ops since (re)build
        # predicates the WHOLE arena cannot fill k for (learned by the
        # executor's exact-rescan net): probing them is pure waste, so the
        # dispatch goes straight to the exact engine. Any data change can
        # un-starve a predicate, so mutations clear the memo.
        self.starved: set = set()
        # slot -> (cluster, position); (-1, i) for overflow entry i. Built
        # in the reference's loop order (clusters ascending, positions in
        # fill order, then the tail), so a slot listed twice keeps its
        # last position, as there -- vectorised, for 2^23-entry tables.
        pos = np.arange(members.shape[1])[None, :]
        c_idx, p_idx = np.nonzero(pos < np.asarray(fill)[:, None])
        self._slot_pos: dict[int, tuple[int, int]] = dict(zip(
            members[c_idx, p_idx].tolist(),
            zip(c_idx.tolist(), p_idx.tolist())))
        for i, s in enumerate(self.overflow):
            self._slot_pos[int(s)] = (-1, i)
        self._dev: dict | None = None
        # incremental-mirror bookkeeping: writes mark the touched member-table
        # rows (cluster ids) dirty instead of dropping the whole mirror, and
        # device_arrays patches only those rows in place. The byte counter is
        # the auditable trail a write-heavy deployment watches.
        self._dirty_clusters: set[int] = set()
        self._overflow_dirty = False
        self.mirror_uploads = 0           # full mirror uploads
        self.mirror_patches = 0           # in-place row patches
        self.mirror_bytes_uploaded = 0    # cumulative host->device bytes

    # -- shape facts ------------------------------------------------------
    @property
    def n_clusters(self) -> int:
        return self.members.shape[0]

    @property
    def cluster_cap(self) -> int:
        return self.members.shape[1]

    @property
    def overflow_padded(self) -> int:
        """Device length of the overflow tail (pow2-bucketed for shape reuse)."""
        return _pow2(len(self.overflow), 8) if self.overflow else 0

    def candidate_rows(self, nprobe: int, rows: int = 1) -> int:
        """Upper bound on rows ONE probe scans for a ``rows``-row batch --
        execution dedups the union of all rows' probed clusters, and the
        union is pow2-bucketed, so the bound is _pow2(min(rows*nprobe, C))
        clusters (explain()'s estimate)."""
        u = min(max(int(rows), 1) * max(1, min(int(nprobe), self.n_clusters)),
                self.n_clusters)
        return _pow2(u) * self.cluster_cap + self.overflow_padded

    # -- device mirror ----------------------------------------------------
    def _overflow_host(self) -> np.ndarray:
        over = np.full(self.overflow_padded, -1, np.int32)
        over[:len(self.overflow)] = self.overflow
        return over

    def _upload(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.tensor(a, device=self.device if device is None
                            else device)                # always a copy

    def _mirrors(self):
        """(device, local(a) -> a in that mirror's slots) of each mirror:
        the index's device with global slots, or one a region with the
        slots of its rows made local and every other entry -1."""
        if self.regions is None:
            return [(self.device, lambda a: a)]
        return [(dev, lambda a, lo=lo, rows=rows: np.where(
                    (a >= lo) & (a < lo + rows), a - lo, -1).astype(np.int32))
                for dev, lo, rows in self.regions]

    def device_arrays(self) -> dict[str, torch.Tensor]:
        """Cached device view, maintained INCREMENTALLY: a write marks only
        the member-table rows (clusters) it touched, and the next probe
        patches those rows of the mirror in place (index assignment)
        instead of re-uploading the whole (C, cap) table. The overflow tail
        re-uploads whole when touched (it is pow2-padded and small).
        Centroids only change on rebuild, which constructs a fresh index
        (and mirror). Counters and byte counts are the reference's.

        With ``regions`` the centroids stay on ``device`` and ``"regions"``
        holds one mirror a region on its device, ``{"members": (C, cap),
        "overflow": (O,)}`` in the region's local slots (the table's shape,
        another region's entries -1); a write patches its dirty clusters
        on every device, and the counters count every device's uploads."""
        mirrors = self._mirrors()
        if self._dev is None:
            over = self._overflow_host()
            self._dev = {"centroids": self._upload(self.centroids)}
            self.mirror_bytes_uploaded += self.centroids.nbytes
            parts = []
            for dev, local in mirrors:
                parts.append({"members": self._upload(local(self.members),
                                                      dev),
                              "overflow": self._upload(local(over), dev)})
                self.mirror_bytes_uploaded += (self.members.nbytes
                                               + over.nbytes)
            if self.regions is None:
                self._dev.update(parts[0])
            else:
                self._dev["regions"] = tuple(parts)
            self.mirror_uploads += 1
        else:
            parts = ((self._dev,) if self.regions is None
                     else self._dev["regions"])
            if self._dirty_clusters:
                rows = np.asarray(sorted(self._dirty_clusters), np.int64)
                patch = self.members[rows]
                for (dev, local), part in zip(mirrors, parts):
                    part["members"][torch.from_numpy(rows).to(dev)] = \
                        self._upload(local(patch), dev)
                    self.mirror_bytes_uploaded += patch.nbytes
                self.mirror_patches += 1
            if self._overflow_dirty:
                over = self._overflow_host()
                for (dev, local), part in zip(mirrors, parts):
                    part["overflow"] = self._upload(local(over), dev)
                    self.mirror_bytes_uploaded += over.nbytes
        self._dirty_clusters.clear()
        self._overflow_dirty = False
        return self._dev

    # -- the coarse quantizer ----------------------------------------------
    def probe_device(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """`probe`'s clusters computed on the mirror's device from the
        mirror's centroids (`probe_union`): (U_pad,) int32, -1 padded, the
        same U_pad. q: (B, D) f32 query rows on that device, the batch's
        real rows only. No host sync: the probe scan reads the union where
        it lies. `probe` stays the host contract; `candidate_rows(nprobe,
        B)` is its rows_scanned."""
        nprobe = max(1, min(int(nprobe), self.n_clusters))
        u_pad = _pow2(min(q.shape[0] * nprobe, self.n_clusters))
        return probe_union(q, self.device_arrays()["centroids"], nprobe,
                           u_pad)

    def probe(self, q: np.ndarray, nprobe: int):
        """Deduplicated probed-cluster union for a batch of query rows.

        Returns (clusters (U_pad,) i32 -- -1 padded; n_probed -- real
        clusters in the union; rows_scanned -- padded candidate rows the
        device scan will score). U_pad is `candidate_rows`'s bound,
        _pow2(min(B*nprobe, C)) -- a function of (B, nprobe) alone, NOT of
        the actual union size, so the scan's shape space stays enumerable."""
        q = np.atleast_2d(np.asarray(q, np.float32))
        nprobe = max(1, min(int(nprobe), self.n_clusters))
        sims = q @ self.centroids.T                         # (B, C)
        if nprobe < self.n_clusters:
            top = np.argpartition(-sims, nprobe - 1, axis=1)[:, :nprobe]
        else:
            top = np.broadcast_to(np.arange(self.n_clusters), sims.shape)
        uniq = np.unique(top)
        u_pad = _pow2(min(q.shape[0] * nprobe, self.n_clusters))
        clusters = np.full(u_pad, -1, np.int32)
        clusters[:len(uniq)] = uniq
        rows = len(clusters) * self.cluster_cap + self.overflow_padded
        return clusters, len(uniq), rows

    # -- incremental maintenance (rides every commit) ----------------------
    def add_rows(self, slots, emb) -> None:
        """Assign fresh/re-embedded rows to their nearest centroid,
        recycling member-table slots; overfull clusters spill to the
        exact-scan overflow tail."""
        slots = [int(s) for s in slots]
        emb = np.asarray(emb, np.float32).reshape(len(slots), -1)
        assign = np.argmax(emb @ self.centroids.T, axis=1)
        for slot, c in zip(slots, assign):
            if slot in self._slot_pos:      # re-embed: move, don't duplicate
                self._remove(slot)
            c = int(c)
            if self.fill[c] < self.cluster_cap:
                pos = int(self.fill[c])
                self.members[c, pos] = slot
                self.fill[c] += 1
                self._slot_pos[slot] = (c, pos)
                self._dirty_clusters.add(c)
            else:
                self._slot_pos[slot] = (-1, len(self.overflow))
                self.overflow.append(slot)
                self._overflow_dirty = True
            self.churn += 1
        self.starved.clear()

    def remove_slots(self, slots) -> None:
        for s in slots:
            self._remove(int(s))
            self.churn += 1
        self.starved.clear()

    def _remove(self, slot: int) -> None:
        ent = self._slot_pos.pop(slot, None)
        if ent is None:
            return
        c, pos = ent
        if c < 0:                            # overflow tail: swap-with-last
            last = self.overflow.pop()
            if pos < len(self.overflow):
                self.overflow[pos] = last
                self._slot_pos[last] = (-1, pos)
            self._overflow_dirty = True
        else:                                # member table: swap-with-last
            last_pos = int(self.fill[c]) - 1
            last_slot = int(self.members[c, last_pos])
            self.members[c, last_pos] = -1
            self.fill[c] = last_pos
            if pos != last_pos:
                self.members[c, pos] = last_slot
                self._slot_pos[last_slot] = (c, pos)
            self._dirty_clusters.add(c)

    def needs_rebuild(self) -> bool:
        """Drift rule: incremental churn past ``drift_rebuild_frac`` of the
        built size means the centroids no longer describe the data."""
        return self.churn > self.cfg.drift_rebuild_frac * max(self.n_at_build, 1)


def build_ivf(store: Store, cfg: IVFConfig, *, epoch: int = 0) -> IVFIndex:
    """Cluster the live rows into a cluster-major member table, on the
    store's devices (k-means and the assignment; each allocation's device
    assigns its own rows, the controller reduces), then lay the table out
    on the host in global slots with one argsort + searchsorted scatter,
    as the reference does; rows beyond a cluster's cap spill into the
    overflow tail, which probes scan exactly, so capacity pressure
    degrades speed, never recall. A store held in several allocations
    gives the index its layout: one mirror a device (`device_arrays`)."""
    parts = allocations(store)
    ctrl = controller(store)
    lives = [part["tenant"] >= 0 for part in parts]
    n_live = int(sum(int(live.sum()) for live in lives))
    C = max(1, min(cfg.n_clusters, n_live))
    cent = _kmeans_allocations([part["emb"] for part in parts], lives, C,
                               cfg.kmeans_iters, cfg.seed, ctrl)
    # every device's assignment queued before the first copy to the host
    assigned = [torch.where(live, _assign(part["emb"],
                                          to_device(cent, part["emb"].device)),
                            -1)
                for part, live in zip(parts, lives)]
    assign = np.concatenate([a.cpu().numpy() for a in assigned])

    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    first_live = np.searchsorted(sorted_assign, 0)
    rows = order[first_live:].astype(np.int64)
    ca = sorted_assign[first_live:]
    counts = np.bincount(ca, minlength=C)
    if cfg.cluster_cap is not None:
        cap = cfg.cluster_cap
    else:
        cap = max(128, int(np.ceil(max(int(counts.max(initial=0)), 1) / 128)) * 128)
    start = np.searchsorted(ca, np.arange(C))
    pos = np.arange(len(rows)) - start[ca]
    members = np.full((C, cap), -1, np.int32)
    in_cap = pos < cap
    members[ca[in_cap], pos[in_cap]] = rows[in_cap]
    overflow = rows[~in_cap].astype(int).tolist()
    fill = np.minimum(counts, cap).astype(np.int64)
    return IVFIndex(cfg, cent.cpu().numpy(), members, fill, overflow,
                    n_at_build=len(rows), epoch=epoch, device=ctrl,
                    regions=layout(store) if ALLOCS in store else None)


def probe_allocations(store: Store, index: IVFIndex, q, clusters, pred,
                      k: int, *, use_kernel: bool | None = None):
    """The probe (`kernels.ivf_probe.ops.ivf_probe`: the compaction, then
    the scan) over the probed ``clusters`` ((U_pad,) int32 on the
    controller, `IVFIndex.probe_device`): one launch an allocation, on its
    device over its mirror (the clusters, ``q`` and ``pred`` copied to it
    without a host sync), every launch queued before the lists are merged
    on the controller (`merge_pieces`). ``q`` is a host array or a tensor;
    ``pred`` a `Predicate` or its packed (4,) int32 array. Returns (scores
    (B, k), ARENA slots (B, k)) on the controller."""
    from repro_torch.core.query import Predicate
    from repro_torch.kernels.filtered_topk.ops import merge_pieces
    from repro_torch.kernels.ivf_probe.ops import ivf_probe

    def pred_on(dev):
        if isinstance(pred, Predicate):
            return pred.as_array(dev)
        return to_device(torch.as_tensor(pred, dtype=torch.int32), dev)
    d = index.device_arrays()
    mirrors = (d,) if index.regions is None else d["regions"]
    if len(mirrors) != len(allocations(store)):
        raise ValueError("the index's mirrors are not laid out like the "
                         "store's allocations: rebuild it over this store")
    lists = []
    for lo, part, mirror in zip(row_starts(store), allocations(store),
                                mirrors):
        dev = part["emb"].device
        lists.append((lo, *ivf_probe(
            to_device(q, dev), part["emb"], part["tenant"],
            part["updated_at"], part["category"], part["acl"],
            mirror["members"], mirror["overflow"], to_device(clusters, dev),
            pred_on(dev), k, use_kernel=use_kernel)))
    return merge_pieces(lists, k, controller(store))


def ivf_query(store: Store, index: IVFIndex, q, pred, k: int,
              nprobe: int | None = None, *, use_kernel: bool | None = None):
    """Single-call convenience over probe + fused scan (the executor drives
    the two stages itself so it can count rows_scanned).

    ``pred`` is a Predicate or its packed (4,) int32 array. Returns
    (scores (B, k), ARENA slots (B, k)) on the store's controller."""
    ctrl = controller(store)
    q = torch.as_tensor(q, dtype=torch.float32, device=ctrl)
    clusters = index.probe_device(q, nprobe or index.cfg.nprobe)
    return probe_allocations(store, index, q, clusters, pred, k,
                             use_kernel=use_kernel)
