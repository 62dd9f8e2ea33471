"""PyTorch / CUDA port of the unified RAG data layer.

Mirrors the JAX package ``repro`` module by module (same public names,
argument order, shapes, dtypes and sentinels) and runs its dense main path
-- ``RagDB`` -> planner -> executor -> fused grouped arena scan -- on one
NVIDIA H100, where the arena scan is a hand-written CUDA kernel
(``csrc/arena_scan.cu``). Entry points default to ``device="cuda"`` and
raise when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions instead.
"""
