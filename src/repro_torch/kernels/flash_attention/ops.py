"""The flash-attention dispatch the model calls (port of
``repro/kernels/flash_attention/ops.py``): the (B, S, H, hd) layout, the
CUDA kernel for tensors on the card, the plain chunked online softmax for
tensors on the CPU.

Forward-only, as the reference: under autograd ``models.layers.
attention_full`` takes the plain, differentiable ``gqa_chunked`` instead,
and the kernel's wrapper refuses inputs that require grad.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _fa


def flash_attention(q, k, v, n_kv: int, *, causal: bool = True,
                    blk_q: int = 512, blk_k: int = 512):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd). ``blk_q`` /
    ``blk_k`` are the plain version's blocks (the reference kernel's); the
    CUDA kernel tiles by its own. Any device but the card and the CPU
    raises."""
    B, S, H, hd = q.shape
    qg = q.reshape(B, S, n_kv, H // n_kv, hd)
    if q.device.type == "cuda":
        out = _fa.flash_attention_cuda(qg.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)
    elif q.device.type == "cpu":
        out = _fa.flash_attention_plain(qg, k, v, causal=causal,
                                        blk_q=min(blk_q, S),
                                        blk_k=min(blk_k, S))
    else:
        raise ValueError(f"no flash-attention engine for device {q.device}")
    return out.reshape(B, S, H, hd)
