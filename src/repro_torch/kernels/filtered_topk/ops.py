"""Public wrapper for the filtered_topk kernel: metadata packing, then the
kernel on the card or its plain version on the CPU. The kernel masks the
ragged edge of N and pads k > N itself, so no row padding happens here.
The sharded form (``filtered_topk_sharded``) arrives with the sharded
slice."""
from __future__ import annotations

from repro_torch.kernels.arena_scan.ops import _packed_meta
from repro_torch.kernels.filtered_topk.filtered_topk import filtered_topk_cuda


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
