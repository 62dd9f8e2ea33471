"""qwen1.5-0.5b — dense LM with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=2816 vocab=151936, tied embeddings."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="qwen1.5-0.5b-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, dtype="float32",
)
