"""The fused IVF probe on the card (port of ``ivf_probe_pallas``,
``src/repro/kernels/ivf_probe/ivf_probe.py:32``): the pruned unified query.

The exact scan streams the WHOLE arena every batch; the probe scores only
the candidate rows a predicate group's probed clusters name. The Pallas
kernel scans a (P, D) copy of those rows that the wrapper gathers first;
here the arena-scan kernel's PROBE mode (``csrc/arena_scan.cuh``,
``arena_scan_probe.cu``) reads each candidate's embedding and metadata
through its arena slot, so the gather costs no copy. The predicate runs on
ARENA metadata: a corrupt member table can only change which rows are
scored, never let a row that fails the WHERE clause surface.

Before the scan, `compact_candidates_cuda` (the compaction kernel of
``arena_scan_probe.cu``) keeps the candidate vector's live slots in order
and leaves their count on the card, so the scan spends nothing on member
padding, padding clusters or poisoned slots and the host never waits.
"""
from __future__ import annotations

from repro_torch.kernels.arena_scan.kernel import (arena_scan_compact_cuda,
                                                   arena_scan_probe_cuda)
from repro_torch.kernels.ivf_probe.ref import (gather_candidates,
                                               ivf_probe_ref,
                                               ivf_probe_scan_ref,
                                               live_candidates)

#: probe kernel launches through `ivf_probe_cuda` (the main-path audit)
LAUNCHES = 0
#: compaction kernel launches through `compact_candidates_cuda`
COMPACT_LAUNCHES = 0


def ivf_probe_cuda(q, emb, meta, cand, pred, k: int, *, n_live=None,
                   page_rows: int | None = None):
    """Launch the probe on the current stream (no sync). q: (B, D) f32;
    emb: (N, D) f32 and meta: (N, 4) int32 -- the ARENA's columns; cand:
    (P,) int32 arena slots of the candidate rows (`candidate_slots`, or the
    compacted vector of `compact_candidates_cuda` with its ``n_live``, a
    (1,) int32 count the kernel reads on the card); pred: (4,) int32; all
    on one CUDA device. ``page_rows`` (an int >= 1, as
    ``ivf_probe_pallas(page_rows=)`` takes it) launches the paged kernel
    over pages of that many candidates. Returns (scores (B, k) f32, arena
    slots (B, k) int32, -1 past the fill); ties go to the lower candidate
    position."""
    global LAUNCHES
    out = arena_scan_probe_cuda(q, emb, meta, cand, pred, k, n_live=n_live,
                                page_rows=page_rows)
    LAUNCHES += 1
    return out


def compact_candidates_cuda(members, overflow, clusters, n_arena: int):
    """Launch the candidate compaction on the current stream (no sync):
    members (C, cap), overflow (O,) and the probed clusters (U,, -1
    padded), int32 on one CUDA device. Returns (cand (U cap + O,) int32:
    the live slots in candidate order, then -1; n_live (1,) int32 on the
    card)."""
    global COMPACT_LAUNCHES
    out = arena_scan_compact_cuda(members, overflow, clusters, n_arena)
    COMPACT_LAUNCHES += 1
    return out


#: The compaction's plain PyTorch version, same contract as
#: `compact_candidates_cuda` (boolean indexing: it syncs on the card).
compact_candidates_plain = live_candidates


def ivf_probe_plain(q, emb, meta, cand, pred, k: int, *,
                    page_rows: int | None = None):
    """The kernel's plain PyTorch version, same contract as
    `ivf_probe_cuda`: the candidates gathered by torch indexing (dead slots
    masked), then the slot-lane dense oracle -- or, with ``page_rows``, the
    slot-lane streaming scan tiled at the page. On the card, callers keep
    TF32 off."""
    cand_emb, cand_meta = gather_candidates(emb, meta, cand)
    if page_rows is not None:
        return ivf_probe_scan_ref(q, cand_emb, cand_meta, pred, k, page_rows)
    return ivf_probe_ref(q, cand_emb, cand_meta, pred, k)
