"""dlrm-rm2 — DLRM recommendation model [arXiv:1906.00091].

n_dense=13 n_sparse=26 embed_dim=64 bot=13-512-256-64 top=512-512-256-1,
dot interaction. Tables: 26 x 1M rows x 64 (1.7B embedding params)."""
from repro_torch.models.recsys import DLRMConfig

FULL = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, vocab=1_000_000,
                  embed_dim=64, bot_mlp=(13, 512, 256, 64),
                  top_mlp=(512, 512, 256, 1))

REDUCED = DLRMConfig(name="dlrm-reduced", n_dense=13, n_sparse=26, vocab=1_000,
                     embed_dim=16, bot_mlp=(13, 32, 16), top_mlp=(64, 32, 1))
