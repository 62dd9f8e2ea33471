"""fm — factorization machine [Rendle, ICDM'10].

n_sparse=39 embed_dim=10, pairwise interactions via the O(nk) sum-square trick."""
from repro_torch.models.recsys import FMConfig

FULL = FMConfig(name="fm", n_sparse=39, vocab=1_000_000, embed_dim=10)

REDUCED = FMConfig(name="fm-reduced", n_sparse=39, vocab=1_000, embed_dim=10)
