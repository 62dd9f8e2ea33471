"""mind — multi-interest retrieval [arXiv:1904.08030].

embed_dim=64 n_interests=4 capsule_iters=3, hist_len=50, 1M-item corpus."""
from repro_torch.models.recsys import MINDConfig

FULL = MINDConfig(name="mind", vocab=1_000_000, embed_dim=64, n_interests=4,
                  capsule_iters=3, hist_len=50)

REDUCED = MINDConfig(name="mind-reduced", vocab=1_000, embed_dim=16,
                     n_interests=4, capsule_iters=3, hist_len=12)
