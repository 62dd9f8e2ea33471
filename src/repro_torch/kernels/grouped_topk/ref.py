"""Plain engines for the grouped_topk family: the dense oracle and the
streaming scan (the kernel's tile schedule), both the arena-scan
framework's plain engines under this family's contract."""
from __future__ import annotations

from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.arena_scan.stages import predicate_keep


def group_masks(meta, preds):
    """All G WHERE clauses over one metadata block: (G, N) bool -- row n is
    live AND satisfies group g's clauses (alias of `predicate_keep`)."""
    return predicate_keep(meta, preds)


def grouped_topk_ref(q, emb, meta, gids, preds, k: int):
    """Dense oracle: (scores (B, k) f32, slots (B, k) int32)."""
    return arena_scan_ref(q, emb, meta, gids, preds, k)


def grouped_topk_scan_ref(q, emb, meta, gids, preds, k: int, blk_n: int):
    """Streaming scan: (blk_n,)-row tiles, local top-k per tile, one
    merge. Never materialises the (B, N) score matrix."""
    return arena_scan_scan_ref(q, emb, meta, gids, preds, k, blk_n)
