"""The flash-decode dispatch the model calls (port of
``repro/kernels/decode_attention/ops.py``).

  decode_attention          single device: the CUDA kernel for tensors on
                            the card, its plain version for tensors on the
                            CPU; acc / l in the (B, H, hd) layout
  decode_attention_sharded  sequence-parallel KV cache: one kernel launch
                            per shard of S on its slice of the cache (read
                            in place, on the device of the piece that
                            holds it), partial (acc, m, l) merged on q's
                            device with the logsumexp combine
                            (`merge_sharded`) -- flash-decode's split-K
                            across a mesh axis

On the ``meta`` device (the launch tools' dry run) a call returns empty
partials of the kernel's shapes and dtypes and launches nothing: shape
propagation, not a fallback. On ``meta`` and on the card each call
reports the kernel's work to an active `launch._cost` counter
(`decode_work`), reckoned from ``live``, the host's count of live rows a
sequence (the cache's length when the caller gives none): the count never
reads ``lengths`` from the device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.launch import _cost
from repro_torch.launch.mesh import n_shards as mesh_shards


def decode_work(qg, k_cache, live: int) -> tuple[int, int]:
    """(flops, bytes) of one kernel call on qg (B, KV, G, hd), caches
    (B, S, KV, hd), ``live`` rows of each sequence: 4 * hd * H * B * live
    (Q.K^T and P.V over the live rows), and the live K and V rows read
    once, q read once, (acc, m, l) written once in f32 (the bound of
    ``PERF.md``'s kernel table)."""
    B, KV, G, hd = qg.shape
    rows = B * live
    nbytes = (2 * rows * KV * hd * k_cache.element_size()
              + qg.numel() * qg.element_size() + B * KV * G * (hd + 2) * 4)
    return 4 * hd * KV * G * rows, nbytes


def _partials(qg, k_cache, v_cache, lengths, live: int | None = None):
    """Un-normalised (acc, m, l) from the kernel on the card or its plain
    version on the CPU; on ``meta`` empty partials; any other device
    raises. ``live`` (host int) sizes the work reported to a counter."""
    dev = qg.device.type
    if dev == "cuda":
        out = _dec.decode_attention_cuda(qg.contiguous(), k_cache, v_cache,
                                         lengths)
    elif dev == "cpu":
        return _dec.decode_attention_plain(qg, k_cache, v_cache, lengths)
    elif dev == "meta":
        out = _dec.decode_attention_meta(qg.contiguous())
    else:
        raise ValueError(f"no decode-attention engine for device {qg.device}")
    if _cost.counting():
        S = k_cache.shape[1]
        flops, nbytes = decode_work(
            qg, k_cache, S if live is None else min(max(live, 0), S))
        _cost.report("decode_attention", flops=flops, nbytes=nbytes)
    return out


def decode_attention(q, k_cache, v_cache, lengths, n_kv: int,
                     blk_s: int = 512, *, live: int | None = None):
    """q: (B, H, hd); caches (B, S, KV, hd); lengths (B,) int32 ->
    (B, H, hd) in q's dtype. ``blk_s`` is the Pallas kernel's S block,
    kept for the reference's signature: the CUDA kernel splits S by its own
    rule (`decode_attention.split_for`) and the plain version takes S
    whole. ``live`` is the host's count of live rows of every sequence
    (lengths' value, when the caller knows it): it sizes only the work
    reported to a `launch._cost` counter. ``meta`` propagates the shapes;
    any other device but the card and the CPU raises."""
    B, H, hd = q.shape
    acc, m, l = _partials(q.reshape(B, n_kv, H // n_kv, hd), k_cache,
                          v_cache, lengths, live)
    out = acc / l
    return out.reshape(B, H, hd).to(q.dtype)


def merge_sharded(mesh, seq_axis, qg, k_cache, v_cache, lengths):
    """The sequence-parallel split of `decode_attention_sharded`, kept
    un-normalised: qg (B, KV, G, hd), caches (B, S, KV, hd) split along S
    into the shards of ``seq_axis``. The caches are one tensor each or
    pieces along S, one a device group of the mesh in sequence order
    (`filtered_topk.ops.shard_pieces` on dim 1). Each shard runs the
    kernel (its plain version on the CPU) on its piece's device over its
    slice of S_local positions -- a view of the caches, not a copy -- with
    its own live prefix clip(lengths - s * S_local, 0, S_local), qg and
    lengths copied there without a host sync; every launch is queued
    before the partials go to qg's device, where they merge by m* = max
    m_i, w_i = e^{m_i - m*} (0 where l_i = 0), l* = sum l_i w_i, acc* =
    sum acc_i w_i. A shard with no live row has m_i = NEG_INF, so its
    weight is 0 whenever another shard is live; a sequence with no live
    row at all takes every weight 1 (the mean of V, as the unsharded
    kernel). Returns (acc* (B, KV, G, hd), l* (B, KV, G, 1)), f32."""
    from repro_torch.core.store import to_device
    from repro_torch.kernels.filtered_topk.ops import shard_pieces
    n = mesh_shards(mesh, seq_axis)
    ks = shard_pieces(mesh, seq_axis, _seq_major(k_cache), "k_cache")
    vs = shard_pieces(mesh, seq_axis, _seq_major(v_cache), "v_cache")
    S = sum(piece.shape[0] for piece, _, _ in ks)
    if S % n:
        raise ValueError(f"cache length {S} not divisible by {n} shards")
    s_local = S // n
    lengths = lengths.to(torch.int32)
    parts = []
    for (kp, first, count), (vp, _, _) in zip(ks, vs):
        kp, vp = kp.transpose(0, 1), vp.transpose(0, 1)   # back to (B, S..)
        if kp.shape[1] != count * s_local or vp.shape != kp.shape:
            raise ValueError(f"a cache piece of {kp.shape[1]} positions "
                             f"for {count} shards of {s_local}")
        qg_p = to_device(qg, kp.device)
        len_p = to_device(lengths, kp.device)
        for j in range(count):
            lo = j * s_local
            local = (len_p - (first + j) * s_local).clamp(0, s_local)
            parts.append(_partials(qg_p, kp[:, lo:lo + s_local],
                                   vp[:, lo:lo + s_local], local))
    acc, m, l = (torch.stack([t.to(qg.device, non_blocking=True)
                              for t in ts])
                 for ts in zip(*parts))                    # (n, B, KV, G, .)
    w = torch.where(l > 0, torch.exp(m - m.amax(dim=0)), 0.0)
    return (acc * w).sum(dim=0), (l * w).sum(dim=0)


def _seq_major(cache):
    """A cache, or each of its pieces, viewed with S first (no copy), so
    that `shard_pieces` splits it along S."""
    if isinstance(cache, torch.Tensor):
        return cache.transpose(0, 1)
    return [c.transpose(0, 1) for c in cache]


def decode_attention_sharded(mesh, seq_axis, q, k_cache, v_cache, lengths,
                             n_kv: int, blk_s: int = 512):
    """KV cache sharded along S over ``seq_axis``; q (B, H, hd) and lengths
    shared: `merge_sharded`'s partials, then out = acc* / l*. The payload
    merged is O(B * H * hd) a shard, independent of S. The caches are one
    tensor each or pieces on the mesh's devices (`merge_sharded`).
    ``blk_s`` is kept for the reference's signature. Returns (B, H, hd) in
    q's dtype, on q's device."""
    B, H, hd = q.shape
    acc, l_sum = merge_sharded(mesh, seq_axis,
                               q.reshape(B, n_kv, H // n_kv, hd), k_cache,
                               v_cache, lengths)
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.reshape(B, H, hd).to(q.dtype)
