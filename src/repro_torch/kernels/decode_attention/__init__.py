"""Flash-decode GQA attention: one query token over a KV cache (port of
``repro.kernels.decode_attention``). ``ref`` holds the plain oracle,
``decode_attention`` the CUDA kernel's wrapper and its plain version,
``ops`` the dispatch the model calls."""
