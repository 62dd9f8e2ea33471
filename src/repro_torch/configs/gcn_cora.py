"""gcn-cora — 2-layer GCN [arXiv:1609.02907].

n_layers=2 d_hidden=16 aggregator=mean norm=sym. The FEATURE/CLASS dims are
shape-dependent (Cora / Reddit / ogbn-products / molecules): each shape
sets its own d_feat/n_classes (SHAPE_DIMS) — the ARCH (layers/width/norm)
is fixed."""
from repro_torch.models.gnn import GCNConfig

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16,
                 aggregator="mean", norm="sym", d_feat=1433, n_classes=7)

REDUCED = GCNConfig(name="gcn-reduced", n_layers=2, d_hidden=8,
                    aggregator="mean", norm="sym", d_feat=24, n_classes=3)

# per-shape graph dimensions (public datasets)
SHAPE_DIMS = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433, n_classes=7),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                         n_classes=41, batch_nodes=1_024, fanouts=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_classes=47),
    "molecule": dict(batch=128, n_nodes=30, n_edges=64, d_feat=32, n_classes=2),
}
