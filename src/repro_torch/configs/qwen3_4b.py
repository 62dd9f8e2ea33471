"""qwen3-4b — dense GQA LM with qk-norm and decoupled head_dim
[hf:Qwen/Qwen3-4B family; assigned spec].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="qwen3-4b-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=32, qk_norm=True, rope_theta=1e6,
    dtype="float32",
)
