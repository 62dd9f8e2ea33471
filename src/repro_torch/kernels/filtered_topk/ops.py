"""Public wrapper for the filtered_topk kernel: metadata packing, then the
kernel on the card or its plain version on the CPU. The kernel masks the
ragged edge of N and pads k > N itself, so no row padding happens here.

The distributed (sharded-corpus) form, `filtered_topk_sharded`:

  corpus rows sharded over a mesh axis
    -> the kernel per shard (local top-k) on a view of its region
    -> the (k per shard) candidates gathered          [tiny: k << N/shard]
    -> final top-k

The gather is k rows a shard, so the merge is O(devices * k), independent
of corpus size: the paper's scaling story, a constant-size merge instead
of a second system. The corpus may be one tensor or pieces on the mesh's
devices, one a device group (`shard_pieces`): each shard launches where
its rows lie and the lists go to the query's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ops import _packed_meta
from repro_torch.kernels.arena_scan.stages import NEG_INF, topk_ordered
from repro_torch.kernels.filtered_topk.filtered_topk import filtered_topk_cuda
from repro_torch.launch.mesh import n_shards as mesh_shards


def filtered_topk(q, emb, tenant, updated_at, category, acl, pred, k: int,
                  *, page_rows: int | None = None):
    """Single-device entry point (contract of core.query.unified_query):
    (scores (B, k) f32, slots (B, k) int32), LIMIT larger than the arena
    padded with (NEG_INF, -1). ``page_rows`` selects the kernel's paged
    regime (on the CPU: the streaming scan tiled at the page); the lists
    are unchanged."""
    meta = _packed_meta(tenant, updated_at, category, acl)
    return filtered_topk_cuda(q.float().contiguous(), emb, meta, pred, k,
                              page_rows)


def shard_pieces(mesh, axis, x, what: str) -> list:
    """``x`` split into the shards of ``axis`` along its dim 0 (or, for a
    sequence of tensors, the shards of each piece): [(piece, first shard,
    shards in it), ...] in shard order. One tensor is one piece holding
    every shard, wherever it lies; a sequence holds one piece a device
    group of the mesh (`launch.mesh.device_groups`), in row order, each on
    its group's device with its shards' rows back to back -- the layout
    `core.store.allocations` gives. Raises when the pieces do not match
    the mesh's groups."""
    from repro_torch.launch.mesh import (device_groups, same_device,
                                         tensor_device)
    n = mesh_shards(mesh, axis)
    if isinstance(x, torch.Tensor):
        return [(x, 0, n)]
    groups = device_groups(mesh, axis)
    pieces = list(x)
    if len(pieces) != len(groups):
        raise ValueError(f"{len(pieces)} pieces of {what} for the mesh's "
                         f"{len(groups)} device groups")
    out = []
    for piece, (dev, shards) in zip(pieces, groups):
        if not same_device(piece.device, tensor_device(dev)):
            raise ValueError(f"a piece of {what} lies on {piece.device}, "
                             f"its shards {shards} on {dev}")
        out.append((piece, shards[0], len(shards)))
    return out


def filtered_topk_sharded(mesh, axis, q, emb, meta, pred, k: int):
    """Distributed unified query over a row-sharded corpus: emb (N, D) and
    meta (N, 4) int32 split into the mesh's shards along N, q (B, D) and
    pred (4,) shared. ``emb`` and ``meta`` are one tensor each (every
    shard on its device) or pieces, one a device group of the mesh in row
    order (`shard_pieces`): each shard runs `filtered_topk_cuda` (the
    kernel on the card, its plain version on the CPU) on a view of its
    rows on its piece's device, q and pred copied there without a host
    sync, every launch queued before the lists are copied to q's device.
    They merge there by the reference's POSITIONAL top-k over the gathered
    (B, S*k) columns: equal scores go to the lower column, i.e. the lower
    shard, then the lower slot -- the unsharded kernel's (score, slot)
    order, not the sharded engine's (score, doc_id) one. Returns (scores
    (B, k), GLOBAL slots (B, k), -1 past the fill) on q's device."""
    from repro_torch.core.store import to_device
    n = mesh_shards(mesh, axis)
    embs = shard_pieces(mesh, axis, emb, "emb")
    metas = shard_pieces(mesh, axis, meta, "meta")
    N = sum(piece.shape[0] for piece, _, _ in embs)
    if N % n:
        raise ValueError(f"{N} rows not divisible by {n} shards")
    n_local = N // n
    q = q.float().contiguous()
    parts = []
    for (e, first, count), (m, _, _) in zip(embs, metas):
        if e.shape[0] != count * n_local or m.shape[0] != e.shape[0]:
            raise ValueError(f"a piece of {e.shape[0]} rows for {count} "
                             f"shards of {n_local}")
        q_p, pred_p = to_device(q, e.device), to_device(pred, e.device)
        for j in range(count):
            lo = j * n_local
            parts.append(((first + j) * n_local, *filtered_topk_cuda(
                q_p, e[lo:lo + n_local], m[lo:lo + n_local], pred_p, k)))
    return merge_pieces(parts, k, q.device)


def merge_positional(scores, slots, k: int):
    """The reference's positional merge of per-shard lists: ``scores`` and
    GLOBAL ``slots``, (B, k_i) each, in shard order, concatenated and cut
    to the top k by score, equal scores to the lower column. Returns
    (scores (B, k), slots (B, k), -1 past the fill)."""
    top_s, top_i = topk_ordered(torch.cat(scores, 1), torch.cat(slots, 1), k)
    return top_s, torch.where(top_s > NEG_INF, top_i, -1)


def merge_pieces(lists, k: int, device):
    """Lists of row ranges scanned apart, [(first row, scores (B, k_i),
    local slots (B, k_i)), ...] in row order: each copied to ``device``
    without a host sync, its slots made global by its first row, then
    merged there by position (`merge_positional`). One list from row 0
    is only copied."""
    if len(lists) == 1 and lists[0][0] == 0:
        return tuple(x.to(device, non_blocking=True) for x in lists[0][1:])
    return merge_positional(
        [s.to(device, non_blocking=True) for _, s, _ in lists],
        [torch.where(sl >= 0, sl + lo, -1).to(device, non_blocking=True)
         for lo, _, sl in lists], k)
