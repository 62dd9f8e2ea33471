"""Fused filtered similarity top-k on the card -- the unified query with a
single predicate group (port of ``filtered_topk_pallas``,
``src/repro/kernels/filtered_topk/filtered_topk.py:27``). Every query row
selects group 0 of the arena-scan kernel; a row that fails the predicate
can never reach the output."""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.kernel import arena_scan


def filtered_topk_cuda(q, emb, meta, pred, k: int):
    """q: (B, D) f32; emb: (N, D) f32; meta: (N, 4) int32 [tenant, ts, cat,
    acl]; pred: (4,) int32. Returns (scores (B, k) f32, slots (B, k)
    int32). CUDA tensors launch the kernel; CPU tensors take its plain
    version."""
    gids = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return arena_scan(q, emb, meta, gids,
                      pred.to(torch.int32).reshape(1, 4).contiguous(), k)
