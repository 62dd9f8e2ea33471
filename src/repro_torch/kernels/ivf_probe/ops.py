"""Public wrapper for the ivf_probe kernel (port of
``repro.kernels.ivf_probe.ops``): candidate assembly and engine dispatch.

  probed cluster ids (deduplicated union for ONE predicate group)
    -> member-table rows (U, cap) + the exact-scan overflow tail
    -> ONE candidate vector of arena slots for the whole group, compacted
       to its live slots (in candidate order; the count stays on the card)
    -> the probe: mask + score + top-k over arena slots

CUDA tensors go to the kernels (`compact_candidates_cuda`, then
`ivf_probe_cuda`, which reads each live candidate's rows through its slot;
no host sync between them); CPU tensors to the plain versions
(`compact_candidates_plain`, `ivf_probe_plain`, which gathers the rows as
`_assemble` does); nothing else is taken. Metadata comes from the ARENA
columns, never from an index-side copy, so a stale or poisoned member
table can only waste score work. Unlike the reference, nothing pads P to a
tile multiple and the scan walks only the live candidates: the lists are
the padded vector's, since selection breaks ties by candidate position
and the compaction keeps the live positions' order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_scan.ops import _pack_meta, _packed_meta
from repro_torch.kernels.ivf_probe.ivf_probe import (
    compact_candidates_cuda, compact_candidates_plain, ivf_probe_cuda,
    ivf_probe_plain)
from repro_torch.kernels.ivf_probe.ref import (NEG_INF, candidate_slots,
                                               gather_candidates)


def _assemble(emb, tenant, updated_at, category, acl, members, overflow,
              clusters):
    """Candidate rows for one predicate group: the probed clusters' member
    slots plus the overflow tail, with arena-side metadata. Returns
    (cand_emb (P, D), cand_meta (P, 5) int32)."""
    return gather_candidates(emb, _pack_meta(tenant, updated_at, category,
                                             acl),
                             candidate_slots(members, overflow, clusters))


def ivf_probe(q, emb, tenant, updated_at, category, acl, members, overflow,
              clusters, pred, k: int, *, use_kernel: bool | None = None):
    """Fused probe over one predicate group's candidate set.

    q: (B, D) stacked query rows; emb/tenant/updated_at/category/acl: the
    ARENA columns (source of truth); members: (C, cap) int32 member table;
    overflow: (O,) int32 exact-scan tail; clusters: (U,) probed cluster
    ids, -1-padded to a bucketed length (numpy, or a tensor on emb's
    device, as `IVFIndex.probe_device` leaves it: then nothing here waits
    on the device); pred: (4,) int32. Returns (scores (B, k) f32, ARENA
    slots (B, k) int32, -1 past the fill).

    ``use_kernel=None`` takes the kernel for tensors on the card and the
    plain version for tensors on the CPU; ``False`` takes the plain version
    on either. The reference's ``blk_b`` / ``blk_p`` / ``interpret`` are
    TPU tiling knobs and have no counterpart here."""
    dev = emb.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no ivf_probe engine for device {dev}")
    B = q.shape[0]
    n_cand = members.shape[1] * len(clusters) + overflow.shape[0]
    if n_cand == 0:             # empty candidate set: nothing qualifies
        return (torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.full((B, k), -1, dtype=torch.int32, device=dev))
    if k > n_cand:    # LIMIT larger than the candidate set: SQL semantics
        s, i = ivf_probe(q, emb, tenant, updated_at, category, acl, members,
                         overflow, clusters, pred, n_cand,
                         use_kernel=use_kernel)
        pad = k - n_cand
        return (torch.cat([s, s.new_full((B, pad), NEG_INF)], dim=1),
                torch.cat([i, i.new_full((B, pad), -1)], dim=1))
    meta = _packed_meta(tenant, updated_at, category, acl)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev).contiguous()
    pred = torch.as_tensor(pred, dtype=torch.int32, device=dev).contiguous()
    if dev.type == "cuda" and use_kernel is not False:
        cl = torch.as_tensor(clusters, dtype=torch.int32, device=dev)
        cand, n_live = compact_candidates_cuda(members, overflow,
                                               cl.contiguous(), emb.shape[0])
        return ivf_probe_cuda(q, emb, meta, cand, pred, k, n_live=n_live)
    cand, _ = compact_candidates_plain(members, overflow, clusters,
                                       emb.shape[0])
    return ivf_probe_plain(q, emb, meta, cand, pred, k)
