"""Plain oracle for flash-decode GQA attention (port of
``repro/kernels/decode_attention/ref.py``)."""
from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, KV, G, hd); caches (B, S, KV, hd); lengths (B,) int32.
    Returns the normalised attention output (B, KV, G, hd) f32."""
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                  # (B, S)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
