"""The unified arena scan's plain engines: the dense oracle and the
streaming scan (port of ``repro.kernels.arena_scan.ref``).

The oracle materialises the full (B, N) score block. The streaming scan is
the CUDA kernel's schedule without the card: tiles of ``blk_n`` rows scored
independently, a local top-k per tile, one merge over the candidates. It is
the port's "ref" engine for grouped scans, and on the CPU it emulates what
each block of ``csrc/arena_scan.cu`` keeps, so the kernel's algorithm is
tested where the kernel cannot run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.stages import (NEG_INF, ScanSpec,
                                                   tile_mask, tile_scores,
                                                   topk_ordered)


def _finish(top_s, top_i, k: int):
    """Pad the (B, k') lists to k with (NEG_INF, -1) and blank the slot of
    every NEG_INF score (a masked row never surfaces)."""
    pad = k - top_s.shape[1]
    if pad > 0:
        b = top_s.shape[0]
        top_s = torch.cat([top_s, top_s.new_full((b, pad), NEG_INF)], dim=1)
        top_i = torch.cat([top_i, top_i.new_full((b, pad), -1)], dim=1)
    return top_s, torch.where(top_s > NEG_INF, top_i, -1).to(torch.int32)


def _check(spec: ScanSpec, meta):
    if meta.shape[1] != spec.meta_width:
        raise ValueError(f"meta must be (N, {spec.meta_width}), got "
                         f"{tuple(meta.shape)}")


def arena_scan_ref(q, emb, meta, gids, preds, k: int, *,
                   spec: ScanSpec = ScanSpec()):
    """Dense oracle. q: (B, D); emb: (N, D); meta: (N, 4) int32; gids: (B,)
    int32 group id per row; preds: (G, 4) int32. Returns (scores (B, k)
    f32, slots (B, k) int32), NEG_INF / -1 past the fill."""
    _check(spec, meta)
    n = emb.shape[0]
    scores = tile_scores(q, emb, tile_mask(meta, preds, gids))
    idx = torch.arange(n, dtype=torch.int32,
                       device=q.device).expand(q.shape[0], n)
    return _finish(*topk_ordered(scores, idx, min(k, n)), k)


def arena_scan_scan_ref(q, emb, meta, gids, preds, k: int, blk_n: int, *,
                        spec: ScanSpec = ScanSpec()):
    """Streaming scan: (blk_n,)-row tiles, a LOCAL top-min(k, blk_n) per
    tile, one final merge over the candidates in tile order. Never holds
    more than one (B, blk_n) score tile. The last tile may be ragged."""
    _check(spec, meta)
    n = emb.shape[0]
    b = q.shape[0]
    k_loc = min(k, blk_n)
    cand_s, cand_i = [], []
    for base in range(0, n, blk_n):
        stop = min(base + blk_n, n)
        s = tile_scores(q, emb[base:stop], tile_mask(meta[base:stop], preds,
                                                     gids))
        idx = torch.arange(base, stop, dtype=torch.int32,
                           device=q.device).expand(b, stop - base)
        ts, ti = topk_ordered(s, idx, k_loc)
        cand_s.append(ts)
        cand_i.append(ti)
    all_s, all_i = torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1)
    return _finish(*topk_ordered(all_s, all_i, min(k, all_s.shape[1])), k)
