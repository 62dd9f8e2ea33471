"""The unified arena scan's plain engines: the dense oracle and the
streaming scan (port of ``repro.kernels.arena_scan.ref``).

The oracle materialises the full (B, N) score block. The streaming scan is
the CUDA kernel's schedule without the card: tiles of ``blk_n`` rows scored
independently, a local top-k per tile and running list, one merge over the
candidates. It is the port's "ref" engine for grouped scans, and on the CPU
it emulates what each block of ``csrc/arena_scan.cuh`` keeps, so the
kernel's algorithm is tested where the kernel cannot run. The scan's blk_n
IS the page size: ``arena_scan_scan_ref(..., blk_n=page_rows)`` is the
plain version of the paged kernel (one list per page of ``page_rows``
rows, one merge), as it is of the reference's paged Pallas kernel.

Both take a `ScanSpec` and, for the lexical specs, ``lex=(terms, lexnorm,
qterms, qidf)``, and return `spec.n_lists` (scores (B, k) f32, slots (B, k)
int32) pairs flattened. Under ``ScanSpec(slot_lane=True)`` the rows are an
IVF candidate set with meta (P, 5): both engines select on candidate
positions (ties to the lower position, tile order in the merge) and gather
each winner's arena slot from the 5th lane afterwards.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.stages import (NEG_INF, ScanSpec,
                                                   tile_mask, tile_signals,
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


def _slots(spec: ScanSpec, meta, pos):
    """Output indices for selected rows: the rows' positions, or under the
    slot lane the arena slots gathered from the 5th lane at them."""
    return meta[:, 4][pos.long()] if spec.slot_lane else pos


def _check(spec: ScanSpec, meta, lex):
    if meta.shape[1] != spec.meta_width:
        raise ValueError(f"meta must be (N, {spec.meta_width}), got "
                         f"{tuple(meta.shape)}")
    if spec.has_lex and lex is None:
        raise ValueError(f"ScanSpec(score={spec.score!r}) needs lex=(terms, "
                         "lexnorm, qterms, qidf)")


def arena_scan_ref(q, emb, meta, gids, preds, k: int, *,
                   spec: ScanSpec = ScanSpec(), lex: tuple | None = None):
    """Dense oracle. q: (B, D); emb: (N, D); meta: (N, 4) int32 ((N, 5) with
    the slot lane); gids: (B,) int32 group id per row; preds: (G, 4) int32;
    lex: (terms (N, T) int32, lexnorm (N, T) f32, qterms (B, QT) int32,
    qidf (B, QT) f32) for the lexical specs. Returns `spec.n_lists` (scores
    (B, k) f32, slots (B, k) int32) pairs flattened, NEG_INF / -1 past the
    fill."""
    _check(spec, meta, lex)
    n = emb.shape[0]
    signals = tile_signals(spec, q, emb, tile_mask(meta, preds, gids, spec),
                           lex)
    idx = torch.arange(n, dtype=torch.int32,
                       device=q.device).expand(q.shape[0], n)
    out = []
    for sig in signals:
        top_s, pos = topk_ordered(sig, idx, min(k, n))
        out.extend(_finish(top_s, _slots(spec, meta, pos), k))
    return tuple(out)


def arena_scan_scan_ref(q, emb, meta, gids, preds, k: int, blk_n: int, *,
                        spec: ScanSpec = ScanSpec(),
                        lex: tuple | None = None):
    """Streaming scan: (blk_n,)-row tiles, a LOCAL top-min(k, blk_n) per
    tile and running list, one final merge over the candidates in tile
    order. Never holds more than one (B, blk_n) score tile per list. The
    last tile may be ragged. Candidates carry row positions; the slot lane
    is gathered after the merge."""
    _check(spec, meta, lex)
    n = emb.shape[0]
    b = q.shape[0]
    k_loc = min(k, blk_n)
    cand = [([], []) for _ in range(spec.n_lists)]
    for base in range(0, n, blk_n):
        stop = min(base + blk_n, n)
        lex_tile = None
        if spec.has_lex:
            terms, lexnorm, qterms, qidf = lex
            lex_tile = (terms[base:stop], lexnorm[base:stop], qterms, qidf)
        signals = tile_signals(spec, q, emb[base:stop],
                               tile_mask(meta[base:stop], preds, gids, spec),
                               lex_tile)
        idx = torch.arange(base, stop, dtype=torch.int32,
                           device=q.device).expand(b, stop - base)
        for (cs, ci), sig in zip(cand, signals):
            ts, ti = topk_ordered(sig, idx, k_loc)
            cs.append(ts)
            ci.append(ti)
    out = []
    for cs, ci in cand:
        all_s, all_i = torch.cat(cs, dim=1), torch.cat(ci, dim=1)
        top_s, pos = topk_ordered(all_s, all_i, min(k, all_s.shape[1]))
        out.extend(_finish(top_s, _slots(spec, meta, pos), k))
    return tuple(out)
