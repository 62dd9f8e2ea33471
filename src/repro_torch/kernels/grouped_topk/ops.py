"""Public wrapper for the grouped_topk kernel: metadata packing and engine
dispatch -- the CUDA kernel for tensors on the card, the streaming scan
(``use_kernel=False``) on any device.

The caller may pad ``preds`` with blocker rows (tenant = -3, which no live
row matches) to bucket G; a blocker group masks everything, and no real
row carries its group id.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ops import (_packed_meta, default_blk_n,
                                                default_use_kernel)
from repro_torch.kernels.grouped_topk.grouped_topk import grouped_topk_cuda
from repro_torch.kernels.grouped_topk.ref import grouped_topk_scan_ref


def grouped_topk(q, emb, tenant, updated_at, category, acl, gids, preds,
                 k: int, *, use_kernel: bool | None = None,
                 blk_n: int | None = None, page_rows: int | None = None):
    """Fused multi-predicate grouped top-k over one arena scan.

    q: (B, D) stacked query rows for EVERY predicate group; the arena
    columns; gids: (B,) int32 group id per row (in [0, G)); preds: (G, 4)
    int32 stacked `Predicate.as_array()` rows; k: LIMIT. Returns (scores
    (B, k) f32, slots (B, k) int32, -1 past the fill).

    ``use_kernel=None`` picks the kernel for tensors on the card and the
    streaming scan elsewhere; ``use_kernel=True`` on CPU tensors runs the
    kernel's plain version. ``blk_n`` is the streaming scan's tile
    (default `BLK_SCAN` clamped to the arena). ``page_rows`` selects the
    paged regime: the kernel streams pages of that many rows, the
    streaming scan tiles at the page -- the lists are unchanged."""
    meta = _packed_meta(tenant, updated_at, category, acl)
    dev = emb.device
    q = torch.as_tensor(q, dtype=torch.float32, device=dev).contiguous()
    gids = torch.as_tensor(gids, dtype=torch.int32, device=dev).contiguous()
    preds = torch.as_tensor(preds, dtype=torch.int32,
                            device=dev).contiguous()
    if default_use_kernel(use_kernel, emb):
        return grouped_topk_cuda(q, emb, meta, gids, preds, k, page_rows)
    # the scan tile IS the page: blk_n = page_rows in the paged regime
    return grouped_topk_scan_ref(
        q, emb, meta, gids, preds, k,
        page_rows or blk_n or default_blk_n(emb.shape[0]))
