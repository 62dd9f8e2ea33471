"""Plain oracle for the flash-attention forward kernel (port of
``repro/kernels/flash_attention/ref.py``): full-precision softmax, no
blocks, no bf16 rounding."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, S, KV, G, hd); k, v: (B, S, KV, hd) -> (B, S, KV, G, hd) in
    q's dtype."""
    B, S, KV, G, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.to(q.dtype)
