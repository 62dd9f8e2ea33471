"""Data pipelines: the synthetic RAG corpus and query workload."""
