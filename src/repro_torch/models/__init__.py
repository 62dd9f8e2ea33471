"""Model zoo of the port: the decoder-only transformer, dense and MoE
(``layers``, ``moe``, ``transformer``), for serving and training; the
recsys family (``recsys``: DLRM, FM, MIND, BERT4Rec) and the GNN family
(``gnn``: GCN and its neighbor sampler)."""
