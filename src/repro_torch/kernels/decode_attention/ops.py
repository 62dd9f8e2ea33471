"""The flash-decode dispatch the model calls (port of
``repro/kernels/decode_attention/ops.py``).

  decode_attention   single device: the CUDA kernel for tensors on the
                     card, its plain version for tensors on the CPU; acc / l
                     in the (B, H, hd) layout

``decode_attention_sharded`` (the sequence-parallel cache) waits for the
sharded slice (ROADMAP queue 1, "Sharded engine").
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention as _dec


def decode_attention(q, k_cache, v_cache, lengths, n_kv: int,
                     blk_s: int = 512):
    """q: (B, H, hd); caches (B, S, KV, hd); lengths (B,) int32 ->
    (B, H, hd) in q's dtype. ``blk_s`` is the Pallas kernel's S block,
    kept for the reference's signature: the CUDA kernel splits S by its own
    rule (`decode_attention.split_for`) and the plain version takes S
    whole. Any device but the card and the CPU raises."""
    B, H, hd = q.shape
    qg = q.reshape(B, n_kv, H // n_kv, hd)
    if q.device.type == "cuda":
        acc, m, l = _dec.decode_attention_cuda(qg.contiguous(), k_cache,
                                               v_cache, lengths)
    elif q.device.type == "cpu":
        acc, m, l = _dec.decode_attention_plain(qg, k_cache, v_cache, lengths)
    else:
        raise ValueError(f"no decode-attention engine for device {q.device}")
    out = acc / l
    return out.reshape(B, H, hd).to(q.dtype)
