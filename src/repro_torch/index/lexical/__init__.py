"""The lexical scoring arena (port of ``repro.index.lexical``).

  arena.py    LexicalConfig / LexicalStats / LexicalArena: fixed-width
              per-doc (N, T) term-id + tf int32 lanes beside the vector
              arena, plus the corpus-level BM25 statistics (df / idf /
              avgdl).

The split-system baseline (``twoscan.py`` in the reference) is off the main
path and is not ported yet (ROADMAP queue 1).
"""
from repro_torch.index.lexical.arena import (LexicalArena,  # noqa: F401
                                             LexicalConfig, LexicalStats,
                                             sanitize_lanes)
