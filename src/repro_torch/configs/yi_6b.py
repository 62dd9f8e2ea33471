"""yi-6b — llama-arch dense GQA LM [arXiv:2403.04652; hf:01-ai/Yi-6B].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, head_dim=128,
RoPE theta 5e6 (Yi's long-base rope)."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128, rope_theta=5e6,
    dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="yi-6b-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=176, vocab_size=512, head_dim=16, rope_theta=5e6, dtype="float32",
)
