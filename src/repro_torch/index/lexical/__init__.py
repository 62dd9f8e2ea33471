"""The lexical scoring arena (port of ``repro.index.lexical``).

  arena.py    LexicalConfig / LexicalStats / LexicalArena: fixed-width
              per-doc (N, T) term-id + tf int32 lanes beside the vector
              arena, plus the corpus-level BM25 statistics (df / idf /
              avgdl).
  twoscan.py  the split-system baseline the fused hybrid scan replaces:
              dense scan + lexical scan + host-side union rescore + merge
              (`two_scan_hybrid`, `lexical_topk`).
"""
from repro_torch.index.lexical.arena import (LexicalArena,  # noqa: F401
                                             LexicalConfig, LexicalStats,
                                             sanitize_lanes)
from repro_torch.index.lexical.twoscan import (lexical_topk,  # noqa: F401
                                               two_scan_hybrid)
