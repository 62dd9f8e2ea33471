"""Flash-decode on the card: the CUDA kernel's wrapper and its plain
PyTorch version.

`decode_attention_cuda` launches ``csrc/decode_attention.cu``, the Hopper
port of the Pallas kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention/decode_attention.py:77``): a split-K
flash-decode, one block per (S chunk, kv head, sequence), whose partial
(acc, m, l) a second launch merges by the logsumexp rule. Decode is bound by
the bytes of the live K and V rows (the source states the bound and the
design). `decode_attention_plain` computes the same un-normalised triple in
plain PyTorch, all in f32; it is the CPU path and the kernel's on-card
reference. The Pallas kernel's (B, KV, G, 128) lane-uniform m and l are
(B, KV, G, 1) here: the lanes were a TPU artefact.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _attention, _nvcc
from repro_torch.kernels.decode_attention.ref import NEG_INF

#: positions a split block covers (576 blocks at B 8, KV 8, S 2064)
SPLIT = 256
#: kernel launches through `decode_attention_cuda` (the main-path audit)
LAUNCHES = 0


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """q (B, KV, G, hd); caches (B, S, KV, hd); lengths (B,) int32 ->
    UN-normalised (acc (B, KV, G, hd), m (B, KV, G, 1), l (B, KV, G, 1)),
    all f32: position s of sequence b is live when s < lengths[b]; a masked
    score is NEG_INF, so lengths[b] <= 0 gives p = 1 everywhere (the mean of
    V, as the reference) and lengths[b] > S the whole cache."""
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return acc, m, l


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the split-K kernel and its merge on the current stream (no
    sync). q (B, KV, G, hd), k_cache / v_cache (B, S, KV, hd), all f32 or
    all bf16, hd in {64, 128}, 1 <= G <= 32; lengths (B,) int32;
    all contiguous on one CUDA device. Returns the merged UN-normalised
    (acc (B, KV, G, hd), m (B, KV, G, 1), l (B, KV, G, 1)), f32. Raises on
    any input it cannot take."""
    global LAUNCHES
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("q must be (B, KV, G, hd) and the caches "
                         "(B, S, KV, hd)")
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    dt = q.dtype
    if dt not in _attention.DTYPES:
        raise ValueError(f"decode_attention_cuda takes float32 or bfloat16, "
                         f"got {dt}")
    _nvcc.check_tensor("q", q, dt, (B, KV, G, hd), dev)
    _nvcc.check_tensor("k_cache", k_cache, dt, (B, S, KV, hd), dev)
    _nvcc.check_tensor("v_cache", v_cache, dt, (B, S, KV, hd), dev)
    _nvcc.check_tensor("lengths", lengths, torch.int32, (B,), dev)
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not in (64, 128): the kernel is "
                         "built for the served models' head dims")
    if not 1 <= G <= 32 or min(B, S, KV) < 1:
        raise ValueError(f"decode_attention_cuda needs 1 <= G <= 32 and B, "
                         f"S, KV >= 1, got B={B} S={S} KV={KV} G={G}")
    if B * S * KV * hd >= 1 << 62 or KV > 65535 or B > 65535:
        raise ValueError("shapes past the kernel's grid or index range")
    lib = _attention.load()
    n_split = -(-S // SPLIT)
    f32 = dict(dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, KV, n_split, G, hd), **f32)
    part_m = torch.empty((B, KV, n_split, G), **f32)
    part_l = torch.empty((B, KV, n_split, G), **f32)
    acc = torch.empty((B, KV, G, hd), **f32)
    m = torch.empty((B, KV, G, 1), **f32)
    l = torch.empty((B, KV, G, 1), **f32)
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), _attention.DTYPES[dt], B, S, KV, G, hd, SPLIT,
        part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), _attention.stream_of(dev))
    _attention.check_rc(lib, rc, f"decode_attention (B={B} S={S} KV={KV} "
                                 f"G={G} hd={hd} {dt})")
    LAUNCHES += 1
    return acc, m, l
