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
of a second system.
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


def filtered_topk_sharded(mesh, axis, q, emb, meta, pred, k: int):
    """Distributed unified query over a row-sharded corpus: emb (N, D) and
    meta (N, 4) int32 split into the mesh's shards along N, q (B, D) and
    pred (4,) shared. Each shard runs `filtered_topk_cuda` (the kernel on
    the card, its plain version on the CPU) on its rows' views; the lists
    merge by the reference's POSITIONAL top-k over the gathered (B, S*k)
    columns: equal scores go to the lower column, i.e. the lower shard,
    then the lower slot -- the unsharded kernel's (score, slot) order, not
    the sharded engine's (score, doc_id) one. Returns (scores (B, k), GLOBAL
    slots (B, k), -1 past the fill). Every mesh device must be emb's."""
    n = mesh_shards(mesh, axis)
    N = emb.shape[0]
    if N % n:
        raise ValueError(f"{N} rows not divisible by {n} shards")
    n_local = N // n
    q = q.float().contiguous()
    ss, ii = [], []
    for s in range(n):
        lo = s * n_local
        sc, sl = filtered_topk_cuda(q, emb[lo:lo + n_local],
                                    meta[lo:lo + n_local], pred, k)
        ss.append(sc)
        ii.append(torch.where(sl >= 0, sl + lo, -1))
    return merge_positional(ss, ii, k)


def merge_positional(scores, slots, k: int):
    """The reference's positional merge of per-shard lists: ``scores`` and
    GLOBAL ``slots``, (B, k_i) each, in shard order, concatenated and cut
    to the top k by score, equal scores to the lower column. Returns
    (scores (B, k), slots (B, k), -1 past the fill)."""
    top_s, top_i = topk_ordered(torch.cat(scores, 1), torch.cat(slots, 1), k)
    return top_s, torch.where(top_s > NEG_INF, top_i, -1)
