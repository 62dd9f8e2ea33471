"""Secondary index structures living beside the vector arena (port of
``repro.index``).

  lexical/   fixed-width postings arena (term-id + tf lanes) + corpus-level
             BM25 statistics -- the lexical half of the hybrid dense+BM25
             engine, slot-aligned with the vector arena and written through
             the same `TransactionLog` commit hooks.
"""
from repro_torch.index.lexical import (LexicalArena, LexicalConfig,  # noqa: F401
                                       LexicalStats)
