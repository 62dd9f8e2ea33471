"""Per-tile stages of the unified arena scan, in plain PyTorch (port of
``repro.kernels.arena_scan.stages``).

The plain engines (`ref.arena_scan_ref`, the streaming
`ref.arena_scan_scan_ref`) call these on every tile; the CUDA kernel
(``csrc/arena_scan.cu``) computes the same stages by hand. One rule binds
them all: a selection orders by score descending, then by arena index
ascending, so ties go to the lower slot -- in a tile and in every merge.
`torch.topk` does not promise that order; a stable descending sort does.

The slot-lane scan (``ScanSpec(slot_lane=True)``, the IVF candidate set)
scores gathered candidate rows whose 5th metadata lane holds each row's
arena slot. There ties go to the lower CANDIDATE POSITION, as in the
reference: selection runs on positions, and the slots are gathered after
it, never sorted on.
"""
from __future__ import annotations

import dataclasses

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """What one arena-scan program computes.

    score:
      * ``"dense"`` -- similarity only (filtered_topk / grouped_topk): ONE
        running k-list on the masked dot product;
      * ``"fused"`` -- hybrid wsum: ONE running k-list on ``dense + bm25``
        (fusion weights pre-folded into q / qidf by the caller);
      * ``"both"``  -- hybrid rrf: TWO running k-lists (dense, bm25); rank
        fusion happens after the scan.
    slot_lane: the metadata block carries a 5th lane with each row's ARENA
      slot (IVF candidate sets): the slot is the output index, rows with
      ``slot < 0`` (member-table padding, dead slots) are masked, and the
      selection orders by candidate position -- the slots are gathered
      after it (see `topk_ordered`).

    >>> ScanSpec("both").n_lists, ScanSpec("fused").has_lex
    (2, True)
    >>> ScanSpec(slot_lane=True).meta_width
    5
    """
    score: str = "dense"
    slot_lane: bool = False

    def __post_init__(self):
        if self.score not in ("dense", "fused", "both"):
            raise ValueError(f"unknown ScanSpec score {self.score!r}")

    @property
    def n_lists(self) -> int:
        return 2 if self.score == "both" else 1

    @property
    def has_lex(self) -> bool:
        return self.score in ("fused", "both")

    @property
    def meta_width(self) -> int:
        return 5 if self.slot_lane else 4


def topk_ordered(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """The top ``k`` of each row of (B, M) ``scores`` by (score desc, then
    position asc), with their ``idx`` entries. ``idx`` must be ascending
    along each row wherever scores tie, which holds for arena positions,
    for candidate positions of a slot-lane scan and for candidate lists
    concatenated in tile order. It does NOT hold for arena slots of a
    slot-lane scan (a candidate set lists them cluster by cluster): select
    on positions, then gather the slots."""
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


def bm25_scores(terms, lexnorm, qterms, qidf) -> torch.Tensor:
    """Lexical stage: masked-gather BM25 over one tile's postings lanes.
    terms: (n, T) int32 lane term ids (-1 empty); lexnorm: (n, T) f32
    per-lane tf/length weight; qterms: (B, QT) int32 (-1 padding); qidf:
    (B, QT) f32 per-term idf (0 on padding, fusion weight already folded
    in). Returns (B, n) f32.

    The accumulation order is FIXED -- lanes outer, query terms inner --
    and the lane product is select-guarded (``acc + where(w != 0, w * ln,
    0)``), each step its own IEEE operation; the CUDA kernel computes the
    same steps with ``__fadd_rn`` / ``__fmul_rn``, so the signal is the
    same value bit for bit. A padding query term (-1) can only "match" an
    empty doc lane (-1), and its idf is 0, so it contributes exactly 0."""
    qidf = qidf.float()
    bm25 = torch.zeros((qterms.shape[0], terms.shape[0]), dtype=torch.float32,
                       device=terms.device)
    for t in range(terms.shape[1]):
        lane = terms[:, t][None, :]
        ln = lexnorm[:, t].float()[None, :]
        w = torch.zeros_like(bm25)
        for j in range(qterms.shape[1]):
            hit = lane == qterms[:, j][:, None]
            w = w + torch.where(hit, qidf[:, j][:, None], 0.0)
        bm25 = bm25 + torch.where(w != 0.0, w * ln, 0.0)
    return bm25


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


def tile_mask(meta: torch.Tensor, preds: torch.Tensor, gids: torch.Tensor,
              spec: ScanSpec = ScanSpec()) -> torch.Tensor:
    """Per-row mask for one tile: each query row picks ITS group's
    predicate row by direct index (+ slot-lane membership for candidate-set
    scans: ``slot < 0`` rows are out). Returns (B, n) bool."""
    row_keep = predicate_keep(meta, preds)[gids.long()]
    if spec.slot_lane:
        row_keep = row_keep & (meta[:, 4] >= 0)[None, :]   # member padding out
    return row_keep


def tile_scores(q, e, row_keep) -> torch.Tensor:
    """Masked dense scores for one tile: NEG_INF where a row fails its
    group's predicate."""
    return tile_signals(ScanSpec(), q, e, row_keep)[0]


def tile_signals(spec: ScanSpec, q, e, row_keep, lex=None):
    """Score stage for one tile: the masked running-list signals, one per
    `spec.n_lists`. ``lex`` is (terms, lexnorm, qterms, qidf) for this
    tile's rows when `spec.has_lex`. The mask lands on every signal before
    any ranking, so a row outside its group's predicate never surfaces,
    however high its BM25 score."""
    neg = torch.tensor(NEG_INF, device=q.device)
    dense = dense_scores(q, e)
    if spec.score == "dense":
        return (torch.where(row_keep, dense, neg),)
    bm25 = bm25_scores(*lex)
    if spec.score == "fused":
        # weights are pre-folded into q / qidf: the combine is a bare add
        return (torch.where(row_keep, dense + bm25, neg),)
    return (torch.where(row_keep, dense, neg),
            torch.where(row_keep, bm25, neg))
