"""granite-moe-1b-a400m — fine-grained MoE LM
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155,
32 experts top-8 (1B total, ~400M active).

The tiny per-expert d_ff (512) makes one-hot dispatch overhead the dominant
MoE cost — moe_group is set small (512) to bound it."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_ff=512, vocab_size=49155, n_experts=32, top_k=8,
    tie_embeddings=True, rope_theta=1e4, dtype="bfloat16", moe_group=512,
)

REDUCED = TransformerConfig(
    name="granite-moe-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=512, n_experts=8, top_k=2, tie_embeddings=True,
    dtype="float32", moe_group=64,
)
