"""Plain engines of the ivf_probe family (port of
``repro.kernels.ivf_probe.ref``) and its candidate assembly.

Contract shared with the CUDA kernel (``ivf_probe.py``): score ONLY the
candidate rows a predicate group's probed clusters name, apply the
predicate in the same pass on ARENA metadata, and return ARENA slots --
the probe changes which rows are *scored*, never which rows may be
*returned*. Both engines are the arena-scan framework's slot-lane plain
engines (`repro_torch.kernels.arena_scan.ref`): they select on candidate
positions (ties to the lower position) and gather the slots afterwards.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.arena_scan.stages import NEG_INF, ScanSpec

__all__ = ["NEG_INF", "candidate_slots", "gather_candidates",
           "ivf_probe_ref", "ivf_probe_scan_ref", "live_candidates"]

_SPEC = ScanSpec(score="dense", slot_lane=True)


def candidate_slots(members, overflow, clusters) -> torch.Tensor:
    """The candidate vector of one predicate group: the probed clusters'
    member-table rows, cluster by cluster in ``clusters`` order, then the
    overflow tail. members: (C, cap) int32 arena slots (-1 padding);
    overflow: (O,) int32; clusters: (U,) cluster ids, -1 padded (a padding
    cluster contributes cap dead entries). Returns (P,) int32, P = U * cap
    + O, on members' device."""
    cl = torch.as_tensor(clusters, dtype=torch.int64, device=members.device)
    m = members[cl.clamp(min=0)]                              # (U, cap)
    m = torch.where((cl >= 0)[:, None], m, -1)                # cluster-list pad
    return torch.cat([m.reshape(-1), overflow.to(m.dtype)]).to(
        torch.int32).contiguous()


def live_candidates(members, overflow, clusters, n_arena: int):
    """The compaction kernel's plain version: `candidate_slots`' live
    entries -- arena slots inside [0, n_arena) -- in candidate order, then
    -1 to the same length P, and their count. A cluster id outside [-1, C)
    counts as padding, as in the kernel. Scanning the compacted vector
    gives the padded one's lists exactly: selection breaks ties by
    candidate position, and compaction keeps the live positions' order.
    Returns (cand (P,) int32, n_live (1,) int32) on members' device."""
    cl = torch.as_tensor(clusters, dtype=torch.int64, device=members.device)
    cl = torch.where(cl < members.shape[0], cl, -1)
    cand = candidate_slots(members, overflow, cl)
    live = (cand >= 0) & (cand < n_arena)
    kept = cand[live]
    out = torch.full_like(cand, -1)
    out[:kept.numel()] = kept
    return out, torch.tensor([kept.numel()], dtype=torch.int32,
                             device=cand.device)


def gather_candidates(emb, meta, cand):
    """Candidate rows with arena-side metadata (the gather half of the
    reference's `_assemble`). emb: (N, D) arena; meta: (N, 4) int32 packed
    arena metadata; cand: (P,) int32 arena slots. A slot outside [0, N)
    (poisoned or corrupt member table) is dead, not clamped: slot -1,
    tenant -1. Returns (cand_emb (P, D), cand_meta (P, 5) int32 [tenant,
    updated_at, category, acl, slot])."""
    n = emb.shape[0]
    cand = torch.where((cand >= 0) & (cand < n), cand, -1).to(torch.int32)
    safe = cand.clamp(min=0).long()
    m = meta[safe]
    tenant = torch.where(cand >= 0, m[:, 0], -1)
    cand_meta = torch.stack([tenant, m[:, 1], m[:, 2], m[:, 3], cand], dim=1)
    return emb[safe], cand_meta.to(torch.int32).contiguous()


def _gids(q):
    return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)


def ivf_probe_ref(q, cand_emb, cand_meta, pred, k: int):
    """q: (B, D); cand_emb: (P, D) -- the probed clusters' member rows,
    gathered ONCE for the whole predicate group; cand_meta: (P, 5) int32
    [tenant, updated_at, category, acl, arena_slot] (slot < 0 marks
    padding); pred: (4,) int32. Returns (scores (B, k) f32, arena slots
    (B, k) int32, -1 past the fill)."""
    return arena_scan_ref(q, cand_emb, cand_meta, _gids(q),
                          pred.to(torch.int32).reshape(1, 4), k, spec=_SPEC)


def ivf_probe_scan_ref(q, cand_emb, cand_meta, pred, k: int, blk_p: int):
    """Streaming probe: the kernel's tile schedule without the card (tiles
    of ``blk_p`` candidates, the last one ragged), equal to
    `ivf_probe_ref` by the arena-scan construction."""
    return arena_scan_scan_ref(q, cand_emb, cand_meta, _gids(q),
                               pred.to(torch.int32).reshape(1, 4), k, blk_p,
                               spec=_SPEC)
