"""grok-1-314b — 314B-parameter MoE LM [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) per-expert d_ff=32768 vocab=131072,
8 experts top-2. head_dim=128.

Training this arch REQUIRES Adafactor: fp32 Adam moments alone are 2.5 TB,
and ``launch/train.py`` selects the optimizer by param count. FULL is
registered for its shapes and counts; it is never instantiated on one
card."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128, n_experts=8, top_k=2,
    rope_theta=1e4, dtype="bfloat16", moe_group=2048,
)

REDUCED = TransformerConfig(
    name="grok-1-reduced", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, n_experts=4, top_k=2,
    dtype="float32", moe_group=64,
)
