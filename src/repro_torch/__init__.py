"""PyTorch / CUDA port of the unified RAG data layer.

Mirrors the JAX package ``repro`` module by module (same public names,
argument order, shapes, dtypes and sentinels) and runs its dense main path
-- ``RagDB`` -> planner -> executor -> fused grouped arena scan --, the
hybrid dense+BM25 path, the IVF pruned path and the sharded engine
(``RagDB(mesh=...)``: the scan per shard region, an exact (score, doc_id)
merge) on one NVIDIA H100, where the arena scan is a hand-written CUDA
kernel (``csrc/arena_scan.cuh``) in its dense, lexical and slot-indirect
probe modes, and behind it an LM server and trainer (dense and MoE
decoders; the flash-attention and flash-decode kernels serve, training
runs plain PyTorch). Entry points default to
``device="cuda"`` and raise when no card is present; pass ``device="cpu"``
to run the plain PyTorch versions instead.
"""
