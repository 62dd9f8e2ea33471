"""Model zoo of the port: the decoder-only transformer, dense and MoE
(``layers``, ``moe``, ``transformer``), for serving and training. GNN and
recsys models are a later slice."""
