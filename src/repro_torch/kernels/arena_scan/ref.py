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

`lexical_pairs`, `bm25_pairs` and `lexical_stage` emulate the kernel's
lexical stage (the lexical specs' epilogue in ``csrc/arena_scan.cuh``):
which (query row, arena row) pairs it computes BM25 for, in which order and
on which thread, and each pair's chain as the kernel rounds it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.stages import (NEG_INF, ScanSpec,
                                                   tile_mask, tile_signals,
                                                   topk_ordered)


#: threads of a scan block: pair p of the lexical stage's lists is thread
#: p mod LEX_THREADS's
LEX_THREADS = 256
#: the index the kernel stages for a masked (row, query) pair
NO_ROW = 2**31 - 1


def lexical_pairs(keep):
    """The kernel's pair lists for one sub-tile: ``keep`` (R, n) bool, the
    mask of R selection rows over the sub-tile's n rows. Returns the kept
    pairs as (selection rows j, tile rows r, threads), int64 tensors in the
    kernel's order -- selection row ascending, then tile row ascending (the
    list warp j's ballots write for row j) -- with pair p on thread p mod
    LEX_THREADS. A masked pair is in no list."""
    j, r = torch.nonzero(keep, as_tuple=True)
    return j, r, torch.arange(j.numel()) % LEX_THREADS


def bm25_pairs(lt, ll, qt, qw):
    """The kernel's BM25 chain for P pairs: lt / ll (P, T) each pair's row
    lanes (term ids, lexnorm), qt / qw (P, QT) its query row's terms and
    idf. With T % 4 == 0 the kernel reads the query terms padded with (-1,
    0) to a multiple of 4 (its shared rows), else as they are; per lane, w
    = 0 and w += hit ? idf : 0 over the (padded) terms in order; per pair,
    acc = 0 and acc += w != 0 ? w * ln : 0 over the lanes in order, every
    step one f32 operation. Returns (P,) f32."""
    T, QT = lt.shape[1], qt.shape[1]
    pad = -QT % 4 if T % 4 == 0 else 0
    qt = torch.cat([qt, qt.new_full((qt.shape[0], pad), -1)], dim=1)
    qw = torch.cat([qw.float(), qw.new_zeros((qw.shape[0], pad),
                                             dtype=torch.float32)], dim=1)
    acc = torch.zeros(lt.shape[0], dtype=torch.float32)
    for t in range(T):
        lane, ln = lt[:, t], ll[:, t].float()
        w = torch.zeros_like(acc)
        for j in range(qt.shape[1]):
            w = w + torch.where(lane == qt[:, j], qw[:, j], 0.0)
        acc = acc + torch.where(w != 0.0, w * ln, 0.0)
    return acc


def lexical_stage(spec: ScanSpec, s, ix, base: int, lex):
    """The kernel's lexical stage for R selection rows of one sub-tile: s /
    ix (R, n) the staged masked dense scores and indices (NO_ROW where the
    pair is masked), ``base`` the sub-tile's first arena row, lex = (terms,
    lexnorm, qterms, qidf) with the arena's lanes and the R query rows'
    terms. Returns FUSED: the list's scores, dense + bm25 on kept pairs;
    BOTH: the bm25 list's scores, NEG_INF on masked pairs."""
    terms, lexnorm, qterms, qidf = lex
    j, r, _ = lexical_pairs(ix != NO_ROW)
    rows = base + r
    b25 = bm25_pairs(terms[rows], lexnorm[rows], qterms[j], qidf[j])
    if spec.score == "fused":
        out = s.clone()
        out[j, r] = out[j, r] + b25
    else:
        out = torch.full_like(s, NEG_INF)
        out[j, r] = b25
    return out


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
