"""Plain oracle for filtered_topk: the dense arena-scan oracle with a
single predicate group."""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ref import arena_scan_ref


def filtered_topk_ref(q, emb, meta, pred, k: int):
    """Same contract as `filtered_topk_cuda`; dense PyTorch implementation."""
    gids = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return arena_scan_ref(q, emb, meta, gids,
                          pred.to(torch.int32).reshape(1, 4), k)
