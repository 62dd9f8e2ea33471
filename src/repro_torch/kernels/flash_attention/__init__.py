"""Flash-attention forward, causal or full GQA (port of
``repro.kernels.flash_attention``). ``ref`` holds the plain oracle,
``flash_attention`` the CUDA kernel's wrapper and its plain version (the
chunked online softmax of ``models.layers.gqa_chunked``), ``ops`` the
dispatch the model calls."""
