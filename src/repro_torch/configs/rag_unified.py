"""rag-unified -- the paper's own system as a production config (port of
``repro.configs.rag_unified``).

Benchmark scale (Section 6.1): 50k docs x 128-dim, 20 tenants, 5 categories.
Production scale (Section 7.3 hot tier): 64Mi docs x 768-dim, sharded;
queries are the fused filtered_topk over the row-sharded corpus."""
from repro_torch.core.store import StoreConfig
from repro_torch.data.corpus import CorpusConfig

BENCH = StoreConfig(capacity=65_536, dim=128, metric="cosine")
BENCH_CORPUS = CorpusConfig(n_docs=50_000, dim=128, n_tenants=20, n_categories=5)

# hot-tier production store: 2^26 rows x 768 dims (fp32 = 192 GiB, sharded)
PRODUCTION = StoreConfig(capacity=1 << 26, dim=768, metric="cosine")

REDUCED = StoreConfig(capacity=4_096, dim=64, metric="cosine")
REDUCED_CORPUS = CorpusConfig(n_docs=2_000, dim=64, n_tenants=4, n_categories=4)
