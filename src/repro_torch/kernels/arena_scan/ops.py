"""Shared wrapper plumbing for the arena-scan families (port of
``repro.kernels.arena_scan.ops``): metadata packing with its per-snapshot
memo, and the streaming scan's tile policy.

The CUDA kernel masks the ragged edge of N itself and takes any D and B,
so the port needs none of the reference's dead-row, 128-lane or 8-row
padding.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

#: streaming-scan tile: big enough that per-tile overhead amortizes, small
#: enough that a tile's (B, BLK_SCAN) scores stay cache-close.
BLK_SCAN = 32768


def _pack_meta(tenant, updated_at, category, acl) -> torch.Tensor:
    return torch.stack([tenant.to(torch.int32), updated_at.to(torch.int32),
                        category.to(torch.int32), acl.to(torch.int32)],
                       dim=1).contiguous()


#: Packed-metadata memo, keyed on the column objects' ids. Entries HOLD
#: the source columns, so a key can never alias a freed tensor; the tiny
#: LRU bounds that to a few snapshots' int32 columns. ``emb`` is never
#: held. Snapshot columns are never written in place (writes are out of
#: place), so a key's columns cannot change under it.
_META_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_META_CACHE_CAP = 4


def _packed_meta(tenant, updated_at, category, acl) -> torch.Tensor:
    key = (id(tenant), id(updated_at), id(category), id(acl))
    hit = _META_CACHE.get(key)
    if hit is not None:
        _META_CACHE.move_to_end(key)
        return hit[0]
    meta = _pack_meta(tenant, updated_at, category, acl)
    _META_CACHE[key] = (meta, tenant, updated_at, category, acl)
    while len(_META_CACHE) > _META_CACHE_CAP:
        _META_CACHE.popitem(last=False)
    return meta


def default_use_kernel(use_kernel: bool | None, x: torch.Tensor) -> bool:
    """The CUDA kernel for tensors on the card, the streaming scan
    elsewhere."""
    if use_kernel is None:
        return x.device.type == "cuda"
    return use_kernel


def default_blk_n(n: int) -> int:
    """Streaming-scan tile: `BLK_SCAN` clamped to the pow2 arena bucket,
    so small stores stay single-tile."""
    cap = 1 << max(int(n) - 1, 0).bit_length()
    return min(BLK_SCAN, max(cap, 1))
