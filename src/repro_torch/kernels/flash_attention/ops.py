"""The flash-attention dispatch the model calls (port of
``repro/kernels/flash_attention/ops.py``): the (B, S, H, hd) layout, the
CUDA kernel for tensors on the card, the plain chunked online softmax for
tensors on the CPU.

Forward-only, as the reference: under autograd ``models.layers.
attention_full`` takes the plain, differentiable ``gqa_chunked`` instead,
and the kernel's wrapper refuses inputs that require grad.

On the ``meta`` device (the launch tools' dry run) the dispatch returns an
empty output of the kernel's shape and dtype and launches nothing: shape
propagation, not a fallback. On ``meta`` and on the card it reports the
kernel's work to an active `launch._cost` counter (`flash_work`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.launch import _cost


def flash_work(q, k, causal: bool) -> tuple[int, int]:
    """(flops, bytes) of one kernel call on q (B, S, H, hd), k / v
    (B, S, KV, hd): 4 * hd * B * H * (S (S + 1) / 2 causal, S^2 not) --
    Q.K^T and P.V over the pairs the mask keeps -- and q, k, v read once,
    the output written once (the bound of ``PERF.md``'s kernel table)."""
    B, S, H, hd = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    esz = q.element_size()
    return 4 * hd * pairs * B * H, esz * (2 * q.numel() + 2 * k.numel())


def flash_attention(q, k, v, n_kv: int, *, causal: bool = True,
                    blk_q: int = 512, blk_k: int = 512):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd). ``blk_q`` /
    ``blk_k`` are the plain version's blocks (the reference kernel's); the
    CUDA kernel tiles by its own. ``meta`` propagates the shape; any
    other device but the card and the CPU raises."""
    B, S, H, hd = q.shape
    qg = q.reshape(B, S, n_kv, H // n_kv, hd)
    if q.device.type in ("cuda", "meta"):
        qc, kc, vc = qg.contiguous(), k.contiguous(), v.contiguous()
        out = (_fa.flash_attention_cuda(qc, kc, vc, causal=causal)
               if q.device.type == "cuda" else torch.empty_like(qc))
    elif q.device.type == "cpu":
        out = _fa.flash_attention_plain(qg, k, v, causal=causal,
                                        blk_q=min(blk_q, S),
                                        blk_k=min(blk_k, S))
    else:
        raise ValueError(f"no flash-attention engine for device {q.device}")
    if _cost.counting() and q.device.type != "cpu":
        flops, nbytes = flash_work(q, k, causal)
        _cost.report("flash_attention", flops=flops, nbytes=nbytes)
    return out.reshape(B, S, H, hd)
