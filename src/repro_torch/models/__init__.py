"""Model zoo of the port: the dense decoder-only transformer for serving
(``layers``, ``transformer``). MoE, GNN and recsys models, and training,
are later slices."""
