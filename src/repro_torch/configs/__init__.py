"""Architecture registry of the port (the reference's ``repro.configs``):
the 10 assigned archs -- the LM family (dense and MoE), the recsys family
(dlrm-rm2, fm, mind, bert4rec) and the GNN family (gcn-cora) -- and the
paper's own system (rag-unified), each with its FULL config (the assigned
spec), REDUCED config (tests) and shape set, copied field for field."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs import (bert4rec_arch, dlrm_rm2, fm_arch, gcn_cora,
                                 granite_moe_1b, grok_1_314b, mind_arch,
                                 qwen1_5_0_5b, qwen3_4b, rag_unified, yi_6b)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="gnn_full", **gcn_cora.SHAPE_DIMS["full_graph_sm"]),
    "minibatch_lg": dict(kind="gnn_sampled", **gcn_cora.SHAPE_DIMS["minibatch_lg"]),
    "ogb_products": dict(kind="gnn_full", **gcn_cora.SHAPE_DIMS["ogb_products"]),
    "molecule": dict(kind="gnn_batched", **gcn_cora.SHAPE_DIMS["molecule"]),
}

RAG_SHAPES = {
    "query_hot": dict(kind="rag_query", batch=64, k=16),
    "ingest": dict(kind="rag_ingest", batch=4096),
}


@dataclasses.dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str                  # "lm" | "gnn" | "recsys" | "rag"
    full: Any
    reduced: Any
    shapes: dict[str, dict]
    extra: Any = None


ARCHS: dict[str, Arch] = {
    "yi-6b": Arch("yi-6b", "lm", yi_6b.FULL, yi_6b.REDUCED, LM_SHAPES),
    "qwen3-4b": Arch("qwen3-4b", "lm", qwen3_4b.FULL, qwen3_4b.REDUCED, LM_SHAPES),
    "qwen1.5-0.5b": Arch("qwen1.5-0.5b", "lm", qwen1_5_0_5b.FULL,
                         qwen1_5_0_5b.REDUCED, LM_SHAPES),
    "granite-moe-1b-a400m": Arch("granite-moe-1b-a400m", "lm", granite_moe_1b.FULL,
                                 granite_moe_1b.REDUCED, LM_SHAPES),
    "grok-1-314b": Arch("grok-1-314b", "lm", grok_1_314b.FULL,
                        grok_1_314b.REDUCED, LM_SHAPES),
    "gcn-cora": Arch("gcn-cora", "gnn", gcn_cora.FULL, gcn_cora.REDUCED, GNN_SHAPES),
    "dlrm-rm2": Arch("dlrm-rm2", "recsys", dlrm_rm2.FULL, dlrm_rm2.REDUCED,
                     RECSYS_SHAPES),
    "mind": Arch("mind", "recsys", mind_arch.FULL, mind_arch.REDUCED, RECSYS_SHAPES),
    "fm": Arch("fm", "recsys", fm_arch.FULL, fm_arch.REDUCED, RECSYS_SHAPES),
    "bert4rec": Arch("bert4rec", "recsys", bert4rec_arch.FULL,
                     bert4rec_arch.REDUCED, RECSYS_SHAPES),
    # the paper's own system
    "rag-unified": Arch("rag-unified", "rag", rag_unified.PRODUCTION,
                        rag_unified.REDUCED, RAG_SHAPES, extra=rag_unified),
}


def get(arch_id: str) -> Arch:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def assigned_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch, shape) cells (excludes the rag-unified extras)."""
    out = []
    for aid, arch in ARCHS.items():
        if arch.family == "rag":
            continue
        out.extend((aid, s) for s in arch.shapes)
    return out
