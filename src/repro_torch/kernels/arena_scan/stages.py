"""Per-tile stages of the unified arena scan, in plain PyTorch (port of
``repro.kernels.arena_scan.stages``).

The plain engines (`ref.arena_scan_ref`, the streaming
`ref.arena_scan_scan_ref`) call these on every tile; the CUDA kernel
(``csrc/arena_scan.cu``) computes the same stages by hand. One rule binds
them all: a selection orders by score descending, then by arena index
ascending, so ties go to the lower slot -- in a tile and in every merge.
`torch.topk` does not promise that order; a stable descending sort does.
"""
from __future__ import annotations

import dataclasses

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """What one arena-scan program computes. This slice of the port
    carries the dense spec only: one running k-list on the masked dot
    product."""
    score: str = "dense"
    slot_lane: bool = False

    def __post_init__(self):
        if self.score != "dense":
            raise NotImplementedError(
                f"ScanSpec(score={self.score!r}) is the hybrid dense+BM25 "
                "scan, which arrives with the lexical/hybrid slice "
                "(ROADMAP queue 1, 'Lexical arena and hybrid search')")
        if self.slot_lane:
            raise NotImplementedError(
                "ScanSpec(slot_lane=True) is the IVF candidate scan, which "
                "arrives with the IVF slice (ROADMAP queue 1, 'IVF')")

    @property
    def meta_width(self) -> int:
        return 4


def topk_ordered(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """The top ``k`` of each row of (B, M) ``scores`` by (score desc, then
    position asc), with their ``idx`` entries. ``idx`` must be ascending
    along each row wherever scores tie, which holds for arena positions and
    for candidate lists concatenated in tile order."""
    top_s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(idx, 1, pos[:, :k])


def merge_topk(best_s, best_i, scores, idx, k: int):
    """Merge (B, M) tile candidates into running (B, K) best lists (the
    reference's running-merge stage). Ties break toward the lower
    concatenation position -- running list first, then tile order."""
    return topk_ordered(torch.cat([best_s, scores], dim=1),
                        torch.cat([best_i, idx], dim=1), k)


def dense_scores(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Similarity stage: (B, D) x (n, D) -> (B, n) f32 dot products. On the
    card the caller keeps TF32 off (``allow_tf32 = False``), so this is a
    full-precision product."""
    return torch.matmul(q.float(), e.float().T)


def predicate_keep(meta: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Mask stage: all G WHERE clauses over one metadata tile. meta: (n, 4)
    int32 [tenant, updated_at, category, acl bits]; preds: (G, 4) int32
    stacked `Predicate.as_array()` rows. Returns (G, n) bool -- row is live
    AND satisfies group g's clauses. ``1 << 31`` is the sign bit of int32,
    so category 31 and high ACL bits test exactly as uint32 bitmasks."""
    tenant, ts, cat, acl = (meta[:, j][None, :] for j in range(4))
    p_tenant, p_ts, p_cat, p_acl = (preds[:, j][:, None] for j in range(4))
    keep = tenant >= 0                                     # live rows only
    keep = keep & ((p_tenant == -2) | (tenant == p_tenant))  # tenant isolation
    keep = keep & (ts >= p_ts)                             # freshness
    bit = torch.bitwise_left_shift(torch.ones_like(cat), cat)
    keep = keep & ((bit & p_cat) != 0)                     # category set
    keep = keep & ((acl & p_acl) != 0)                     # ACL groups
    return keep


def tile_mask(meta: torch.Tensor, preds: torch.Tensor,
              gids: torch.Tensor) -> torch.Tensor:
    """Per-row mask for one tile: each query row picks ITS group's
    predicate row by direct index. Returns (B, n) bool."""
    return predicate_keep(meta, preds)[gids.long()]


def tile_scores(q, e, row_keep) -> torch.Tensor:
    """Masked dense scores for one tile: NEG_INF where a row fails its
    group's predicate."""
    return torch.where(row_keep, dense_scores(q, e),
                       torch.tensor(NEG_INF, device=q.device))
