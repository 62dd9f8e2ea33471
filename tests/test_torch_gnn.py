"""Parity of the port's GNN family (``repro_torch.models.gnn``) with the
reference's on the CPU.

gcn-cora REDUCED (and the registry's per-shape widths) with the
reference's own ``gcn_init(PRNGKey(0))`` carried across by `from_numpy`:
`gcn_forward` (sym norm and the unnormalised mean aggregator, padded
edges, an isolated node), `gcn_loss` on a sampled subgraph and
`gcn_loss_batched` on padded molecule-shaped graphs, with every gradient
leaf: outputs and losses within rtol = atol = 1e-5, gradients within
1e-4. `NeighborSampler`'s arrays equal the reference's for the same seed.
One finite AdamW step for each of the full, sampled and batched forms
(the twin of ``tests/test_smoke_archs.py::test_gnn_smoke``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import gnn as jg
from repro_torch import configs as tconfigs
from repro_torch.models import gnn as tg
from repro_torch.training import tree as T
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import init_state, make_train_step

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


def _cfgs(**kw):
    cfg = dataclasses.replace(J_ARCHS["gcn-cora"].reduced, **kw)
    tcfg = dataclasses.replace(tconfigs.get("gcn-cora").reduced, **kw)
    return cfg, tcfg


def _models(cfg, tcfg):
    params = jg.gcn_init(jax.random.PRNGKey(0), cfg)
    return params, tg.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")


def _graph(rng, N=50, E=200, d=24, n_classes=3):
    src = rng.integers(0, N - 1, E).astype(np.int32)      # node N-1 isolated
    dst = rng.integers(0, N - 1, E).astype(np.int32)
    mask = rng.random(E) > 0.1
    return {"feats": rng.standard_normal((N, d)).astype(np.float32),
            "src": src, "dst": dst, "edge_mask": mask,
            "labels": rng.integers(0, n_classes, N).astype(np.int32),
            "label_mask": (rng.random(N) > 0.3).astype(np.float32)}


def _flat_j(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in flat}


def _check(jloss_fn, tloss_fn, params, model, batch):
    jloss, jgrads = jax.value_and_grad(jloss_fn)(
        params, jax.tree.map(jnp.asarray, batch))
    model.requires_grad_(True)
    loss = tloss_fn(model, {k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()})
    grads = torch.autograd.grad(loss, T.leaves(model))
    it = iter(grads)
    got = {"/".join(map(str, p)): g.numpy() for p, g in
           T.ref_items(T.tree_map(lambda _: next(it), model))}
    want = _flat_j(jgrads)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("norm", ["sym", "none"])
def test_full_graph_forward_loss_and_grads(norm):
    cfg, tcfg = _cfgs(norm=norm)
    params, model = _models(cfg, tcfg)
    b = _graph(np.random.default_rng(1))
    with torch.no_grad():
        got = tg.gcn_forward(model, tcfg, *(torch.from_numpy(b[k]) for k in
                                            ("feats", "src", "dst", "edge_mask")))
    want = jg.gcn_forward(params, cfg, *(jnp.asarray(b[k]) for k in
                                         ("feats", "src", "dst", "edge_mask")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():                                # edge_mask None
        got = tg.gcn_forward(model, tcfg, torch.from_numpy(b["feats"]),
                             torch.from_numpy(b["src"]),
                             torch.from_numpy(b["dst"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg.gcn_forward(
        params, cfg, jnp.asarray(b["feats"]), jnp.asarray(b["src"]),
        jnp.asarray(b["dst"]))), rtol=1e-5, atol=1e-5)
    _check(lambda p, bb: jg.gcn_loss(p, cfg, bb),
           lambda p, bb: tg.gcn_loss(p, tcfg, bb), params, model, b)


def _sampled(rng, cfg, N=80, E=400, seeds=8, fanouts=(4, 3)):
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    sub = jg.NeighborSampler(N, src, dst, seed=1).sample(np.arange(seeds),
                                                         fanouts)
    n_sub = sub["nodes"].shape[0]
    feats = rng.standard_normal((N, cfg.d_feat)).astype(np.float32)
    sub_feats = np.where(sub["nodes"][:, None] >= 0,
                         feats[np.maximum(sub["nodes"], 0)], 0.0)
    lmask = np.zeros(n_sub, np.float32)
    lmask[:seeds] = 1.0
    return {"feats": sub_feats.astype(np.float32), "src": sub["src"],
            "dst": sub["dst"], "edge_mask": sub["edge_mask"],
            "labels": rng.integers(0, cfg.n_classes, n_sub).astype(np.int32),
            "label_mask": lmask}


def test_sampled_subgraph_loss_and_grads():
    cfg, tcfg = _cfgs()
    params, model = _models(cfg, tcfg)
    b = _sampled(np.random.default_rng(2), cfg)
    _check(lambda p, bb: jg.gcn_loss(p, cfg, bb),
           lambda p, bb: tg.gcn_loss(p, tcfg, bb), params, model, b)


def _molecules(rng, B=4, Nn=10, Ne=24, d=8):
    node_mask = np.ones((B, Nn), bool)
    node_mask[1, 7:] = False
    edge_mask = np.ones((B, Ne), bool)
    edge_mask[2, 20:] = False
    return {"feats": rng.standard_normal((B, Nn, d)).astype(np.float32),
            "src": rng.integers(0, Nn, (B, Ne)).astype(np.int32),
            "dst": rng.integers(0, Nn, (B, Ne)).astype(np.int32),
            "edge_mask": edge_mask, "node_mask": node_mask,
            "labels": rng.integers(0, 2, B).astype(np.int32)}


def test_batched_molecules_forward_loss_and_grads():
    cfg, tcfg = _cfgs(d_feat=8, n_classes=2)
    params, model = _models(cfg, tcfg)
    b = _molecules(np.random.default_rng(3))
    keys = ("feats", "src", "dst", "edge_mask", "node_mask")
    with torch.no_grad():
        got = tg.gcn_forward_batched(model, tcfg,
                                     *(torch.from_numpy(b[k]) for k in keys))
    want = jg.gcn_forward_batched(params, cfg, *(jnp.asarray(b[k]) for k in keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _check(lambda p, bb: jg.gcn_loss_batched(p, cfg, bb),
           lambda p, bb: tg.gcn_loss_batched(p, tcfg, bb), params, model, b)


def test_neighbor_sampler_draws_the_references():
    rng = np.random.default_rng(4)
    N, E = 60, 300
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N - 3, E).astype(np.int32)     # nodes without edges
    want = jg.NeighborSampler(N, src, dst, seed=7)
    got = tg.NeighborSampler(N, src, dst, seed=7)
    assert np.array_equal(got.nbr, want.nbr)
    assert np.array_equal(got.offsets, want.offsets)
    for seeds in (np.arange(10), np.array([58, 59, 3, 57])):
        a, b = got.sample(seeds, (5, 3)), want.sample(seeds, (5, 3))
        assert set(a) == set(b)
        for key in a:
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key


def test_registry_widths_and_param_count():
    for shape, dims in tconfigs.gcn_cora.SHAPE_DIMS.items():
        cfg = dataclasses.replace(tconfigs.get("gcn-cora").full,
                                  d_feat=dims["d_feat"],
                                  n_classes=dims["n_classes"])
        model = tg.GCN(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
        assert tconfigs.get("gcn-cora").shapes[shape]["d_feat"] == dims["d_feat"]


@pytest.mark.parametrize("kind", ["full", "sampled", "batched"])
def test_one_adamw_step_is_finite(kind):
    """The twin of test_smoke_archs.test_gnn_smoke on the port's init."""
    rng = np.random.default_rng(0)
    if kind == "batched":
        _, tcfg = _cfgs(d_feat=8, n_classes=2)
        b, loss_fn = _molecules(rng), tg.gcn_loss_batched
    else:
        cfg, tcfg = _cfgs()
        b = _graph(rng) if kind == "full" else _sampled(rng, cfg)
        loss_fn = tg.gcn_loss
    model = tg.gcn_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    opt = adamw(1e-2, weight_decay=0.0)
    step = make_train_step(lambda p, bb: loss_fn(p, tcfg, bb), opt)
    state, m = step(init_state(model, opt),
                    {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert all(torch.isfinite(p).all() for p in T.leaves(state["params"]))
