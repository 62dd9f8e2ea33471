"""GCN (Kipf & Welling, arXiv:1609.02907) + neighbor sampling (port of
``repro/models/gnn.py``).

Message passing is the scatter formulation: gather source features by
edge index -> weight by the symmetric norm 1/sqrt(deg_u deg_v) ->
``index_add_`` into destinations (the reference's ``segment_sum``). That
edge-index scatter is the system's SpMM; on the card it adds by atomics,
so its last bits depend on order unless
``torch.use_deterministic_algorithms`` is on.

Four operating regimes (the assigned shape set):
  full_graph_sm   full-batch semi-supervised (Cora)
  minibatch_lg    2-hop fanout (15, 10) sampled training (Reddit-scale) --
                  `NeighborSampler` produces FIXED-shape padded subgraphs
  ogb_products    full-batch at 2.4M nodes / 62M edges
  molecule        dense-batched small graphs with mean readout

`NeighborSampler` is host numpy, copied from the reference as it is, so
its draws for a seed are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.store import resolve_device
from repro_torch.models.layers import ParamTree, dense_init_, fill_from_numpy
from repro_torch.training import tree as T

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    aggregator: str = "mean"     # used when norm == "none"
    norm: str = "sym"            # "sym" | "none"
    dtype: str = "float32"

    def param_count(self) -> int:
        dims = [self.d_feat] + [self.d_hidden] * (self.n_layers - 1) + [self.n_classes]
        return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(self.n_layers))


def _dims(cfg: GCNConfig) -> list[int]:
    return [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


class GCN(ParamTree):
    """{"layer<i>": {"w" (d_i, d_{i+1}), "b" zeros}}."""

    def __init__(self, cfg: GCNConfig, device=None):
        dev, dtype = resolve_device(device), getattr(torch, cfg.dtype)
        dims = _dims(cfg)
        super().__init__(cfg, {
            f"layer{i}": {"w": torch.empty((dims[i], dims[i + 1]),
                                           dtype=dtype, device=dev),
                          "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                           device=dev)}
            for i in range(cfg.n_layers)})


@torch.no_grad()
def gcn_init(generator: torch.Generator, cfg: GCNConfig, device=None) -> GCN:
    """Weights truncated normal / sqrt(d_in), biases zero, from
    ``generator`` (on ``device``)."""
    model = GCN(cfg, device)
    for lay in model.tree().values():
        dense_init_(lay["w"], generator)
    return model


def from_numpy(tree, cfg: GCNConfig, device=None) -> GCN:
    """The port's GCN from the reference's params as numpy arrays."""
    return fill_from_numpy(GCN(cfg, device), tree)


def _propagate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               n_nodes: int, edge_mask: torch.Tensor, norm: str,
               aggregator: str) -> torch.Tensor:
    """One message-passing step with self-loops. src/dst (E,) int; padded
    edges carry edge_mask=False and scatter zeros."""
    ones = edge_mask.float()
    deg = torch.zeros(n_nodes, dtype=torch.float32,
                      device=h.device).index_add(0, dst, ones) + 1.0
    if norm == "sym":
        inv_sqrt = torch.rsqrt(deg)
        coef = inv_sqrt[src] * inv_sqrt[dst] * ones                # (E,)
        msg = h[src] * coef[:, None]
        agg = torch.zeros((n_nodes, h.shape[1]), dtype=msg.dtype,
                          device=h.device).index_add(0, dst, msg)
        return agg + h * (inv_sqrt * inv_sqrt)[:, None]            # self-loop
    # unnormalised mean aggregator
    msg = h[src] * ones[:, None]
    agg = torch.zeros((n_nodes, h.shape[1]), dtype=msg.dtype,
                      device=h.device).index_add(0, dst, msg)
    if aggregator == "mean":
        agg = (agg + h) / deg[:, None]
    return agg


def gcn_forward(params, cfg: GCNConfig, feats: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """feats (N, d_feat); src/dst (E,) -> logits (N, n_classes). Each
    layer projects first and propagates in d_out: (A X) W == A (X W)."""
    p = T.expand(params)
    dev = p["layer0"]["w"].device
    feats, src, dst = feats.to(dev), src.to(dev), dst.to(dev)
    n_nodes = feats.shape[0]
    edge_mask = (torch.ones(src.shape, dtype=torch.bool, device=dev)
                 if edge_mask is None else edge_mask.to(dev))
    h = feats.to(getattr(torch, cfg.dtype))
    for i in range(cfg.n_layers):
        lay = p[f"layer{i}"]
        h = _propagate(h @ lay["w"], src, dst, n_nodes, edge_mask,
                       cfg.norm, cfg.aggregator) + lay["b"]
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    return logz - gold


def gcn_loss(params, cfg: GCNConfig, batch: dict) -> torch.Tensor:
    """batch: feats, src, dst, labels (N,), label_mask (N,), [edge_mask]."""
    logits = gcn_forward(params, cfg, batch["feats"], batch["src"],
                         batch["dst"], batch.get("edge_mask")).float()
    labels = torch.clamp_min(batch["labels"].to(logits.device), 0)
    m = batch["label_mask"].to(logits.device)
    return torch.sum(_xent(logits, labels) * m) / torch.clamp_min(m.sum(), 1)


# ---------------------------------------------------------------------------
# batched small graphs (molecule regime)
# ---------------------------------------------------------------------------

def gcn_forward_batched(params, cfg: GCNConfig, feats: torch.Tensor,
                        src: torch.Tensor, dst: torch.Tensor,
                        edge_mask: torch.Tensor,
                        node_mask: torch.Tensor) -> torch.Tensor:
    """feats (B, N, d); src/dst/edge_mask (B, E); node_mask (B, N).
    Graph-level logits via masked-mean readout: (B, n_classes). The B
    graphs run as one disjoint graph of B * N nodes (graph b's node i is
    b * N + i), which is the reference's vmap over graphs: no edge
    crosses graphs, so each node's degree and messages are its graph's."""
    B, N, _ = feats.shape
    dev = feats.device
    off = (torch.arange(B, device=dev) * N)[:, None]
    h = gcn_forward(params, cfg, feats.reshape(B * N, -1),
                    (src.to(dev) + off).reshape(-1),
                    (dst.to(dev) + off).reshape(-1),
                    edge_mask.to(dev).reshape(-1)).reshape(B, N, -1)
    w = node_mask.to(h.device).float()[..., None]
    return (h * w).sum(dim=1) / torch.clamp_min(w.sum(dim=1), 1.0)


def gcn_loss_batched(params, cfg: GCNConfig, batch: dict) -> torch.Tensor:
    logits = gcn_forward_batched(params, cfg, batch["feats"], batch["src"],
                                 batch["dst"], batch["edge_mask"],
                                 batch["node_mask"]).float()
    return torch.mean(_xent(logits, batch["labels"].to(logits.device)))


# ---------------------------------------------------------------------------
# neighbor sampler (GraphSAGE-style fanout) -- host-side, CSR-backed
# ---------------------------------------------------------------------------

class NeighborSampler:
    """CSR adjacency + uniform fanout sampling producing FIXED-shape padded
    subgraphs. Layout per batch:

      nodes:  [seeds (B)] + [hop1 (B*f1)] + [hop2 (B*f1*f2)]  (padded w/ -1)
      edges:  hop1 edges (B*f1) + hop2 edges (B*f1*f2), local indices,
              edge_mask marks real edges.
    """

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray, seed: int = 0):
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order].astype(np.int32)                # in-neighbors of dst
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """nodes (M,) -> (M, fanout) neighbor ids, -1 where unavailable."""
        out = np.full((len(nodes), fanout), -1, np.int32)
        for i, u in enumerate(nodes):
            if u < 0:
                continue
            lo, hi = self.offsets[u], self.offsets[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            idx = self.rng.integers(lo, hi, size=fanout)      # with replacement
            out[i] = self.nbr[idx]
        return out

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...]):
        """Returns dict of fixed-shape numpy arrays for the padded subgraph."""
        layers = [seeds.astype(np.int32)]
        for f in fanouts:
            layers.append(self._sample_neighbors(layers[-1], f).reshape(-1))
        nodes = np.concatenate(layers)                        # global ids, -1 pads
        n_sub = len(nodes)
        # local index mapping: position in `nodes` (duplicates allowed -- they
        # aggregate identically; production would dedup, correctness is equal)
        src_loc, dst_loc, mask = [], [], []
        base_dst, base_src = 0, len(layers[0])
        for li, f in enumerate(fanouts):
            n_dst = len(layers[li])
            for i in range(n_dst):
                for j in range(f):
                    s = base_src + i * f + j
                    src_loc.append(s)
                    dst_loc.append(base_dst + i)
                    mask.append(nodes[s] >= 0 and nodes[base_dst + i] >= 0)
            base_dst = base_src
            base_src += n_dst * f
        return {
            "nodes": nodes,
            "src": np.asarray(src_loc, np.int32),
            "dst": np.asarray(dst_loc, np.int32),
            "edge_mask": np.asarray(mask, bool),
            "n_sub": n_sub,
        }
