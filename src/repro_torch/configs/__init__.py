"""Architecture registry of the port: the LM configs it can serve and
train (dense and MoE) and the paper's own system (rag-unified), each with
its FULL config (the assigned spec) and REDUCED config (tests), copied
from ``repro.configs``. The GNN and recsys entries of the reference's
registry arrive with their slice."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs import (granite_moe_1b, grok_1_314b, qwen1_5_0_5b,
                                 qwen3_4b, rag_unified, yi_6b)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

RAG_SHAPES = {
    "query_hot": dict(kind="rag_query", batch=64, k=16),
    "ingest": dict(kind="rag_ingest", batch=4096),
}


@dataclasses.dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str                  # "lm" | "rag"
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
    # the paper's own system
    "rag-unified": Arch("rag-unified", "rag", rag_unified.PRODUCTION,
                        rag_unified.REDUCED, RAG_SHAPES, extra=rag_unified),
}


def get(arch_id: str) -> Arch:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
