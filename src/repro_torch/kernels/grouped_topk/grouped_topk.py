"""Fused multi-predicate grouped top-k on the card -- scan once, answer
every group (port of ``grouped_topk_pallas``,
``src/repro/kernels/grouped_topk/grouped_topk.py:31``). One arena pass
scores every query row of the batch; each row selects ITS group's
predicate by index, so a row failing group g's predicate is NEG_INF in
every g-row before the selection and can never leak across groups."""
from __future__ import annotations

from repro_torch.kernels.arena_scan.kernel import arena_scan


def grouped_topk_cuda(q, emb, meta, gids, preds, k: int):
    """q: (B, D) f32; emb: (N, D) f32; meta: (N, 4) int32; gids: (B,)
    int32 group id per row; preds: (G, 4) int32. Returns (scores (B, k)
    f32, slots (B, k) int32). CUDA tensors launch the kernel; CPU tensors
    take its plain version."""
    return arena_scan(q, emb, meta, gids, preds, k)
