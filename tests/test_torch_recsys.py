"""Parity of the port's recsys family (``repro_torch.models.recsys``,
``layers.mlp_*``, the registry's recsys configs) with the reference's on
the CPU.

Each REDUCED config (dlrm-rm2, fm, mind, bert4rec) gets the reference's
own ``<m>_init(PRNGKey(0))`` carried across by `from_numpy` and the same
numpy batch: the forward (logits, MIND's interests, BERT4Rec's hidden
states), each score function and the loss within rtol = atol = 1e-5 (f32),
every gradient leaf within rtol = atol = 1e-4. `embedding_bag` in all
three modes, with per-id weights and an empty bag, against the
reference's; MIND's fixed routing draw against ``jax.random.normal``; one
finite AdamW step per arch (the twin of ``tests/test_smoke_archs.py``);
BERT4Rec's ``blocks`` list keeps the reference's paths in a checkpoint.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import layers as JL
from repro.models import recsys as jrec
from repro.training import checkpoint as jckpt
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import recsys as trec
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import init_state, make_train_step

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

RECSYS = sorted(a for a, v in tconfigs.ARCHS.items() if v.family == "recsys")
FNS = {"dlrm-rm2": ("dlrm", jrec.dlrm_loss, trec.dlrm_loss),
       "fm": ("fm", jrec.fm_loss, trec.fm_loss),
       "mind": ("mind", jrec.mind_loss, trec.mind_loss),
       "bert4rec": ("bert4rec", jrec.bert4rec_loss, trec.bert4rec_loss)}


def _batch(arch_id, cfg, rng, B=16):
    """The numpy batch of test_smoke_archs, with padding and masks."""
    if arch_id == "dlrm-rm2":
        return {"dense": rng.standard_normal((B, cfg.n_dense)).astype(np.float32),
                "sparse_ids": rng.integers(0, cfg.vocab, (B, cfg.n_sparse, 2),
                                           dtype=np.int32),
                "label": rng.integers(0, 2, B, dtype=np.int32)}
    if arch_id == "fm":
        return {"sparse_ids": rng.integers(0, cfg.vocab, (B, cfg.n_sparse),
                                           dtype=np.int32),
                "label": rng.integers(0, 2, B, dtype=np.int32)}
    if arch_id == "mind":
        mask = np.ones((B, cfg.hist_len), bool)
        mask[1, 5:] = False
        mask[2, :] = False                              # no history at all
        return {"hist_ids": rng.integers(0, cfg.vocab, (B, cfg.hist_len),
                                         dtype=np.int32),
                "hist_mask": mask,
                "label_id": rng.integers(0, cfg.vocab, B, dtype=np.int32)}
    S, M = cfg.seq_len, 3
    ids = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pos = rng.integers(0, S - 4, (B, M)).astype(np.int32)
    tgt = np.take_along_axis(ids, pos, 1)
    np.put_along_axis(ids, pos, cfg.mask_id, 1)
    tgt[0, 2] = -1                                      # a padding entry
    pad = np.ones((B, S), bool)
    pad[3, S - 4:] = False                              # a padded sequence
    return {"ids": ids, "pad_mask": pad, "mask_positions": pos,
            "mask_targets": tgt}


def _setup(arch_id, dlrm_multi_hot=2):
    cfg = J_ARCHS[arch_id].reduced
    tcfg = tconfigs.get(arch_id).reduced
    if arch_id == "dlrm-rm2":
        cfg = dataclasses.replace(cfg, multi_hot=dlrm_multi_hot)
        tcfg = dataclasses.replace(tcfg, multi_hot=dlrm_multi_hot)
    name = FNS[arch_id][0]
    params = getattr(jrec, f"{name}_init")(jax.random.PRNGKey(0), cfg)
    model = trec.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return cfg, tcfg, params, model


def _flat_j(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v) for p, v in flat}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch_id", RECSYS)
def test_loss_and_grads_match_reference(arch_id):
    cfg, tcfg, params, model = _setup(arch_id)
    b = _batch(arch_id, cfg, np.random.default_rng(1))
    jloss, jgrads = jax.value_and_grad(FNS[arch_id][1])(
        params, cfg, jax.tree.map(jnp.asarray, b))
    model.requires_grad_(True)
    loss = FNS[arch_id][2](model, tcfg,
                           {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, T.leaves(model))
    it = iter(grads)
    got = {"/".join(map(str, p)): T.stacked(g)
           for p, g in T.ref_items(T.tree_map(lambda _: next(it), model))}
    want = _flat_j(jgrads)
    _close(loss, jloss, 1e-5)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], 1e-4)
    assert any(float(np.abs(w).max()) > 0 for w in want.values())


@pytest.mark.parametrize("arch_id", RECSYS)
def test_forward_and_score_match_reference(arch_id):
    cfg, tcfg, params, model = _setup(arch_id)
    rng = np.random.default_rng(2)
    b = _batch(arch_id, cfg, rng)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = jax.tree.map(jnp.asarray, b)
    with torch.no_grad():
        if arch_id == "dlrm-rm2":
            _close(trec.dlrm_forward(model, tcfg, tb["dense"], tb["sparse_ids"]),
                   jrec.dlrm_forward(params, cfg, jb["dense"], jb["sparse_ids"]),
                   1e-5)
        elif arch_id == "fm":
            _close(trec.fm_forward(model, tcfg, tb["sparse_ids"]),
                   jrec.fm_forward(params, cfg, jb["sparse_ids"]), 1e-5)
        elif arch_id == "mind":
            cand = rng.integers(0, cfg.vocab, (16, 9), dtype=np.int32)
            _close(trec.mind_interests(model, tcfg, tb["hist_ids"],
                                       tb["hist_mask"]),
                   jrec.mind_interests(params, cfg, jb["hist_ids"],
                                       jb["hist_mask"]), 1e-5)
            _close(trec.mind_score(model, tcfg, tb["hist_ids"], tb["hist_mask"],
                                   torch.from_numpy(cand)),
                   jrec.mind_score(params, cfg, jb["hist_ids"], jb["hist_mask"],
                                   jnp.asarray(cand)), 1e-5)
        else:
            cand = rng.integers(0, cfg.vocab + 1, (16, 9), dtype=np.int32)
            _close(trec.bert4rec_encode(model, tcfg, tb["ids"], tb["pad_mask"]),
                   jrec.bert4rec_encode(params, cfg, jb["ids"], jb["pad_mask"]),
                   1e-5)
            _close(trec.bert4rec_score(model, tcfg, tb["ids"], tb["pad_mask"],
                                       torch.from_numpy(cand)),
                   jrec.bert4rec_score(params, cfg, jb["ids"], jb["pad_mask"],
                                       jnp.asarray(cand)), 1e-5)


def test_mind_routing_draw_is_the_references():
    for K, L in ((4, 50), (4, 12), (3, 7)):
        want = np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(17), 0), (1, K, L),
            jnp.float32))
        got = trec._routing_init(K, L)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = np.asarray([1, 2, 3, 7, 7, 9, 11, 0], np.int32)
    seg = np.asarray([0, 0, 1, 1, 2, 2, 4, 4], np.int32)   # bag 3 is empty
    w = rng.random(8).astype(np.float32) if weighted else None
    want = np.asarray(jrec.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 6, mode,
        None if w is None else jnp.asarray(w)))
    got = trec.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(seg), 6, mode,
                             None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))


def test_fielded_lookup_bce_and_mlp_match_reference():
    rng = np.random.default_rng(6)
    tables = rng.standard_normal((3, 20, 4)).astype(np.float32)
    ids = rng.integers(0, 20, (5, 3, 2), dtype=np.int32)
    _close(trec.fielded_lookup(torch.from_numpy(tables), torch.from_numpy(ids)),
           jrec.fielded_lookup(jnp.asarray(tables), jnp.asarray(ids)), 1e-6)
    logits = rng.standard_normal(9).astype(np.float32) * 30
    labels = rng.integers(0, 2, 9).astype(np.float32)
    _close(trec.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
           jrec.bce_loss(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)
    p = jax.tree.map(np.asarray, JL.mlp_init(jax.random.PRNGKey(2), (6, 5, 3),
                                             jnp.float32))
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in p.items()}
    x = rng.standard_normal((4, 6)).astype(np.float32)
    for final in (False, True):
        _close(TL.mlp_apply(tp, torch.from_numpy(x), final_act=final),
               JL.mlp_apply(p, jnp.asarray(x), final_act=final), 1e-6)
    mlp = TL.mlp_init(torch.Generator().manual_seed(0), (6, 5, 3), torch.float32)
    assert {k: {n: tuple(a.shape) for n, a in v.items()} for k, v in mlp.items()} \
        == {k: {n: a.shape for n, a in v.items()} for k, v in p.items()}
    assert float(mlp["layer1"]["b"].abs().sum()) == 0


@pytest.mark.parametrize("arch_id", RECSYS)
def test_one_adamw_step_is_finite(arch_id):
    """The twin of test_smoke_archs.test_recsys_smoke, on the port's own
    init from a generator."""
    tcfg = tconfigs.get(arch_id).reduced
    init = getattr(trec, f"{FNS[arch_id][0]}_init")
    model = init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    b = _batch(arch_id, tcfg, np.random.default_rng(0))
    opt = adamw(1e-3, weight_decay=0.0)
    step = make_train_step(lambda p, bb: FNS[arch_id][2](p, tcfg, bb), opt)
    state, m = step(init_state(model, opt),
                    {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert all(torch.isfinite(p).all() for p in T.leaves(state["params"]))
    assert state["step"] == 1


def test_bert4rec_blocks_keep_reference_paths(tmp_path):
    cfg, tcfg, params, model = _setup("bert4rec")
    want = sorted(jckpt._flatten(params)[0])
    ckpt.save(str(tmp_path), 1, model)
    got = ckpt.restore(str(tmp_path), 1, trec.BERT4Rec(tcfg, device="cpu"))
    keys, _ = ckpt._flatten(model)
    assert sorted(keys) == want and "blocks$1$w2" in keys
    for a, b in zip(T.leaves(model), T.leaves(got)):
        assert torch.equal(a, b)
    assert isinstance(got, trec.BERT4Rec) and got.cfg == tcfg


def test_registry_covers_assigned_cells():
    """The twin of test_smoke_archs.test_registry_covers_assigned_cells, and
    the FULL / REDUCED configs field for field."""
    cells = tconfigs.assigned_cells()
    assert len(cells) == 40 and len({a for a, _ in cells}) == 10
    from repro.configs import assigned_cells
    assert cells == assigned_cells()
    for arch_id, arch in J_ARCHS.items():
        if arch.family in ("recsys", "gnn"):
            port = tconfigs.get(arch_id)
            assert port.family == arch.family and port.shapes == arch.shapes
            for which in ("full", "reduced"):
                assert dataclasses.asdict(getattr(port, which)) == \
                    dataclasses.asdict(getattr(arch, which))
            assert port.full.param_count() == arch.full.param_count()
