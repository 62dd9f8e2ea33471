"""bert4rec — bidirectional sequential recommender [arXiv:1904.06690].

embed_dim=64 n_blocks=2 n_heads=2 seq_len=200. Encoder-only: "serve" shapes
are forward scoring (no autoregressive decode)."""
from repro_torch.models.recsys import BERT4RecConfig

FULL = BERT4RecConfig(name="bert4rec", vocab=50_000, embed_dim=64, n_blocks=2,
                      n_heads=2, seq_len=200)

REDUCED = BERT4RecConfig(name="bert4rec-reduced", vocab=500, embed_dim=32,
                         n_blocks=2, n_heads=2, seq_len=24)
