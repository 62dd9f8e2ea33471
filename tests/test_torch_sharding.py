"""Parity of the port's mesh training (``repro_torch.distributed.sharding``,
``models.transformer.make_vp_loss_fn``, the mesh MoE dispatch,
``checkpoint.restore(shardings=)`` / ``fault_tolerance.reshard_state``)
with the reference's on the CPU.

* `fit_spec` on the reference's cases (``tests/test_distributed.py``)
  against the reference's function;
* `param_pspecs`, `opt_pspecs` (AdamW and Adafactor) and `state_pspecs`
  equal the reference's exactly, leaf for leaf, for every registry arch's
  FULL config (the LMs built on the meta device against the reference's
  ``jax.eval_shape``; the recsys and GNN models) on the fake meshes
  (16, 16), (2, 16, 16) and (2, 4);
* the vocab-parallel loss against the reference's plain ``loss_fn`` on
  host meshes (2, 2), (1, 4) and (2, 1) and once with an MoE config, with
  a vocab (130) that tp does not divide and some labels at -1: the value
  within rel 1e-5, every gradient leaf within rtol 1e-4 / atol 1e-5 (the
  reference's own tolerances for its vp loss); a batch that the dp shards
  do not divide raises;
* one subprocess with 8 fake XLA devices gives the reference's
  ``NamedSharding.shard_shape``, its own ``make_vp_loss_fn`` (value and
  grads), its ``moe_apply_scatter_shmap`` under a mesh (y and aux) and an
  MoE model's loss and grads through it, each against the port's;
* placing a state, restoring onto shardings and `reshard_state`: over one
  device pieces are views of their shard_shape and the restored leaves
  equal the saved ones; over distinct CPU entries every piece is its own
  tensor; a mesh whose devices differ in type from the state's raises
  ValueError.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import gnn as jgnn
from repro.models import moe as jm
from repro.models import recsys as jrec
from repro.models import transformer as jt
from repro.training import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import gnn as tgnn
from repro_torch.models import moe as tm
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as tt
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T
from repro_torch.training.fault_tolerance import reshard_state
from repro_torch.training.optimizer import adafactor, adamw
from repro_torch.training.train_loop import init_state

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model"))]


class FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


def _port_mesh(shape, axes):
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


# ---------------------------------------------------------------------------
# fit_spec and the rule tables
# ---------------------------------------------------------------------------

FIT_CASES = [
    ((("pod", "data"), "model"), (64, 64)),
    (("model", ("pod", "data")), (49155, 1024)),
    (((("data", "model")),), (1_000_000,)),
    (("data",), (13,)),
    ((("pod", "data", "model"), None), (96, 3)),
    ((None, ("data", "model")), (7, 48)),
    (("model",), (16, 4, 4)),
    ((), (5, 5)),
]


@pytest.mark.parametrize("entries,shape", FIT_CASES)
def test_fit_spec_matches_reference(entries, shape):
    for mshape, axes in MESHES + [((1, 1), ("data", "model"))]:
        if any(a not in axes for e in entries if e is not None
               for a in (e if isinstance(e, tuple) else (e,))):
            continue
        want = jshd.fit_spec(FakeMesh(mshape, axes), JP(*entries), shape)
        got = shd.fit_spec(_port_mesh(mshape, axes), shd.P(*entries), shape)
        assert tuple(got) == tuple(want), (mshape, entries, shape)


def test_rule_tables_are_the_references():
    for mshape, axes in MESHES:
        jm_, tm_ = FakeMesh(mshape, axes), _port_mesh(mshape, axes)
        for name in ("lm_rules", "recsys_rules", "gnn_rules"):
            want = [(pat, tuple(spec)) for pat, spec in getattr(jshd, name)(jm_)]
            got = [(pat, tuple(spec)) for pat, spec in getattr(shd, name)(tm_)]
            assert got == want, name


# ---------------------------------------------------------------------------
# param / opt / state specs for every registry arch
# ---------------------------------------------------------------------------

def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            tuple(v) for p, v in flat}


def _tflat(tree, prefix=()) -> dict:
    if isinstance(tree, shd.P):
        return {"/".join(map(str, prefix)): tuple(tree)}
    return {k: v for key, sub in tree.items()
            for k, v in _tflat(sub, prefix + (key,)).items()}


_REF_INIT = {"recsys": {"dlrm-rm2": jrec.dlrm_init, "fm": jrec.fm_init,
                        "mind": jrec.mind_init, "bert4rec": jrec.bert4rec_init},
             "gnn": {"gcn-cora": jgnn.gcn_init}}
_PORT_MODEL = {"dlrm-rm2": trec.DLRM, "fm": trec.FM, "mind": trec.MIND,
               "bert4rec": trec.BERT4Rec, "gcn-cora": tgnn.GCN}


def _shapes(arch_id):
    """(reference params as ShapeDtypeStructs, the port's model on meta)."""
    arch, tarch = jconfigs.get(arch_id), tconfigs.get(arch_id)
    if arch.family == "lm":
        ref = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), arch.full))
        return ref, tt.Transformer(tarch.full, device="meta")
    init = _REF_INIT[arch.family][arch_id]
    ref = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), arch.full))
    return ref, _PORT_MODEL[arch_id](tarch.full, device="meta")


def _rules(family):
    return {"lm": "lm_rules", "recsys": "recsys_rules", "gnn": "gnn_rules"}[family]


SPEC_ARCHS = sorted(a for a, v in tconfigs.ARCHS.items() if v.family != "rag")


@pytest.mark.parametrize("arch_id", SPEC_ARCHS)
def test_state_pspecs_match_reference(arch_id):
    family = tconfigs.get(arch_id).family
    ref, model = _shapes(arch_id)
    for opt_name in ("adamw", "adafactor"):
        jo = getattr(jopt, opt_name)(1e-3)
        to = adamw(1e-3) if opt_name == "adamw" else adafactor(1e-3)
        jstate = {"params": ref, "opt": jax.eval_shape(jo.init, ref),
                  "step": jax.ShapeDtypeStruct((), jnp.int32)}
        tstate = {"params": model, "opt": to.init(model), "step": 0}
        for mshape, axes in MESHES:
            jmesh, tmesh = FakeMesh(mshape, axes), _port_mesh(mshape, axes)
            jrules = getattr(jshd, _rules(family))(jmesh)
            trules = getattr(shd, _rules(family))(tmesh)
            jpp = jshd.param_pspecs(ref, jrules, jmesh)
            tpp = shd.param_pspecs(model, trules, tmesh)
            assert _tflat(tpp) == _jflat(jpp), (arch_id, mshape)
            assert _tflat(shd.opt_pspecs(tstate["opt"], tpp, model)) == \
                _jflat(jshd.opt_pspecs(jstate["opt"], jpp, ref)), \
                (arch_id, opt_name, mshape)
            assert _tflat(shd.state_pspecs(tmesh, tstate, trules)) == \
                _jflat(jshd.state_pspecs(jmesh, jstate, jrules)), \
                (arch_id, opt_name, mshape)


def test_granite_specs_examples():
    """Spot values of granite FULL on (16, 16) and qwen3-4b's lm_head."""
    mesh = _port_mesh((16, 16), ("data", "model"))
    model = tt.Transformer(tconfigs.get("granite-moe-1b-a400m").full,
                           device="meta")
    specs = _tflat(shd.param_pspecs(model, shd.lm_rules(mesh), mesh))
    assert specs["embed"] == (None, "data")
    assert specs["layers/moe/w_gate"] == (None, None, "data", "model")
    assert specs["layers/moe/router"] == (None, "data", None)
    qwen = tt.Transformer(tconfigs.get("qwen3-4b").full, device="meta")
    assert _tflat(shd.param_pspecs(qwen, shd.lm_rules(mesh), mesh))[
        "lm_head"] == ("data", "model")


# ---------------------------------------------------------------------------
# vocab-parallel loss
# ---------------------------------------------------------------------------

VP_CFG = dict(name="vp", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=130, dtype="float32")
VP_MOE = dict(VP_CFG, name="vp-moe", n_experts=4, top_k=2, moe_group=16,
              moe_impl="scatter")


def _batch(vocab, B=4, S=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels[0, :5] = -1
    labels[-1, 10:] = -1
    return toks, labels


def _port_grads(model, loss) -> dict:
    grads = torch.autograd.grad(loss, T.leaves(model))
    it = iter(grads)
    return {"/".join(map(str, p)): T.stacked(g).detach().numpy()
            for p, g in T.ref_items(T.tree_map(lambda _: next(it), model))}


def _jax_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v) for p, v in flat}


def _check_loss(loss, grads, want_loss, want_grads):
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want_grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g, want_grads[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def _vp_case(cfg_kw, mesh_shape):
    cfg = jt.TransformerConfig(**cfg_kw)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = tt.TransformerConfig(**cfg_kw)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    model.requires_grad_(True)
    toks, labels = _batch(cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(
        params, cfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    vp = tt.make_vp_loss_fn(tcfg, make_host_mesh(*mesh_shape))
    loss = vp(model, {"tokens": torch.from_numpy(toks),
                      "labels": torch.from_numpy(labels)})
    _check_loss(loss.detach(), _port_grads(model, loss), float(jloss),
                _jax_flat(jgrads))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (2, 1)])
def test_vp_loss_matches_plain_reference(mesh_shape):
    _vp_case(VP_CFG, mesh_shape)


def test_vp_loss_moe_matches_plain_reference():
    _vp_case(VP_MOE, (2, 2))


def test_vp_loss_rejects_what_shard_map_rejects():
    tcfg = tt.TransformerConfig(**VP_CFG)
    model = tt.init(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    toks, labels = _batch(130, B=3)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with pytest.raises(ValueError, match="does not divide"):
        tt.make_vp_loss_fn(tcfg, make_host_mesh(2, 2))(model, batch)
    with pytest.raises(ValueError, match="'model' mesh axis"):
        tt.make_vp_loss_fn(tcfg, make_mesh((2,), ("data",), devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="more than one type"):
        tt.make_vp_loss_fn(tcfg, make_host_mesh(1, 2, device="meta"))(model, batch)


# ---------------------------------------------------------------------------
# the reference under a mesh (one subprocess, 8 fake XLA devices)
# ---------------------------------------------------------------------------

SHARD_CASES = [((2, 4), ("data", "model"), (None, "model"), (3, 8)),
               ((2, 4), ("data", "model"), ("data", "model"), (6, 12)),
               ((2, 4), ("data", "model"), (("data", "model"),), (16, 5)),
               ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"), (4, 2)),
               ((2, 2, 2), ("pod", "data", "model"), (None, None, "data", "model"), (3, 2, 8, 4)),
               ((2, 2, 2), ("pod", "data", "model"), (), (7,))]

MOE_SPEC = dict(d_model=32, d_ff=16, n_experts=8, top_k=2)


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshref") / "ref.npz"
    code = f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.launch.mesh import make_mesh
        from repro.models import moe as jm
        from repro.models import transformer as jt
        res = {{}}
        for i, (mshape, axes, spec, shape) in enumerate({SHARD_CASES!r}):
            mesh = make_mesh(mshape, axes)
            res[f"shard{{i}}"] = np.asarray(
                NamedSharding(mesh, P(*spec)).shard_shape(shape))
        mesh = make_mesh((2, 2), ("data", "model"))
        rng = np.random.default_rng(3)

        def grads(prefix, fn, params, batch):
            loss, g = jax.value_and_grad(fn)(params, batch)
            res[prefix + "loss"] = np.asarray(loss)
            flat, _ = jax.tree_util.tree_flatten_with_path(g)
            for p, v in flat:
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in p)
                res[prefix + "g/" + key] = np.asarray(v)

        toks = {_batch(130)[0].tolist()!r}
        labels = {_batch(130)[1].tolist()!r}
        batch = {{"tokens": jnp.asarray(toks, jnp.int32),
                  "labels": jnp.asarray(labels, jnp.int32)}}
        cfg = jt.TransformerConfig(**{VP_CFG!r})
        params = jt.init(jax.random.PRNGKey(0), cfg)
        grads("vp_", jt.make_vp_loss_fn(cfg, mesh), params, batch)

        spec = jm.MoESpec(**{MOE_SPEC!r})
        p = jm.moe_init(jax.random.PRNGKey(0), spec, jnp.float32)
        x = jnp.asarray(rng.standard_normal((4, 16, 32)).astype(np.float32))
        jm.set_moe_mesh(mesh, ("data",))
        y, aux = jm.moe_apply_scatter_shmap(p, spec, x)
        res["moe_x"], res["moe_y"], res["moe_aux"] = (
            np.asarray(x), np.asarray(y), np.asarray(aux))
        mcfg = jt.TransformerConfig(**dict({VP_MOE!r}, moe_impl="scatter_shmap"))
        mparams = jt.init(jax.random.PRNGKey(0), mcfg)
        grads("shmap_", lambda p, b: jt.loss_fn(p, mcfg, b), mparams, batch)
        np.savez({str(out)!r}, **res)
        print("MESH_REF_OK")
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0 and "MESH_REF_OK" in run.stdout, \
        run.stderr[-3000:]
    return dict(np.load(out))


def test_shard_shape_matches_reference(mesh_reference):
    for i, (mshape, axes, spec, shape) in enumerate(SHARD_CASES):
        sh = shd.NamedSharding(make_mesh(mshape, axes,
                                         devices=["cpu"] * int(np.prod(mshape))),
                               shd.P(*spec))
        assert sh.shard_shape(shape) == tuple(mesh_reference[f"shard{i}"])


def _ref_grads(ref, prefix):
    n = len(prefix + "g/")
    return float(ref[prefix + "loss"]), {k[n:]: v for k, v in ref.items()
                                         if k.startswith(prefix + "g/")}


def test_vp_loss_matches_reference_vp_loss(mesh_reference):
    cfg = jt.TransformerConfig(**VP_CFG)
    tcfg = tt.TransformerConfig(**VP_CFG)
    model = tt.from_numpy(jax.tree.map(
        np.asarray, jt.init(jax.random.PRNGKey(0), cfg)), tcfg, device="cpu")
    model.requires_grad_(True)
    toks, labels = _batch(130)
    loss = tt.make_vp_loss_fn(tcfg, make_host_mesh(2, 2))(
        model, {"tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)})
    _check_loss(loss.detach(), _port_grads(model, loss),
                *_ref_grads(mesh_reference, "vp_"))


def test_moe_shmap_layer_matches_reference_shmap(mesh_reference):
    p = jax.tree.map(np.asarray, jm.moe_init(
        jax.random.PRNGKey(0), jm.MoESpec(**MOE_SPEC), jnp.float32))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tm.set_moe_mesh(make_host_mesh(2, 2), ("data",))
    try:
        y, aux = tm.moe_apply_scatter_shmap(
            tp, tm.MoESpec(**MOE_SPEC), torch.from_numpy(mesh_reference["moe_x"]))
    finally:
        tm.set_moe_mesh(None, ())
    np.testing.assert_allclose(y.numpy(), mesh_reference["moe_y"],
                               rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(mesh_reference["moe_aux"])) <= 1e-6


def test_moe_shmap_model_matches_reference_shmap(mesh_reference):
    kw = dict(VP_MOE, moe_impl="scatter_shmap")
    cfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    model = tt.from_numpy(jax.tree.map(
        np.asarray, jt.init(jax.random.PRNGKey(0), cfg)), tcfg, device="cpu")
    model.requires_grad_(True)
    toks, labels = _batch(130)
    tm.set_moe_mesh(make_host_mesh(2, 2), ("data",))
    try:
        loss = tt.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
        grads = _port_grads(model, loss)
    finally:
        tm.set_moe_mesh(None, ())
    _check_loss(loss.detach(), grads, *_ref_grads(mesh_reference, "shmap_"))


# ---------------------------------------------------------------------------
# placement, restore onto shardings, reshard_state
# ---------------------------------------------------------------------------

def _small_state():
    cfg = tt.TransformerConfig(**dict(VP_MOE, vocab_size=128))
    model = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    return init_state(model, adamw(1e-3))


def test_place_gives_views_of_shard_shape():
    state = _small_state()
    mesh = make_host_mesh(2, 4)
    sh = shd.state_shardings(mesh, state, shd.lm_rules(mesh))
    assert shd.place(state, sh) is state
    emb = state["params"].embed
    s = sh["params"]["embed"]
    assert tuple(s.spec) == ("model", "data")
    for coord in s.coords():
        piece = s.piece(emb, coord)
        assert tuple(piece.shape) == s.shard_shape(tuple(emb.shape))
        assert piece.data_ptr() == emb[coord["model"] * 32:, coord["data"] * 16:
                                       ].data_ptr()
    wg = sh["params"]["layers"]["moe"]["w_gate"]
    stack = T.ref_items(state["params"])
    leaf = dict(("/".join(map(str, p)), v) for p, v in stack)["layers/moe/w_gate"]
    piece = wg.piece(leaf, {"data": 1, "model": 3})
    assert isinstance(piece, T.Group) and len(piece) == 2
    assert tuple(piece[0].shape) == wg.shard_shape(
        (2,) + tuple(leaf[0].shape))[1:]


def test_place_rejects_other_devices_and_misfit_specs():
    """Distinct devices of one type are placed (a piece a coordinate, each
    its own tensor, equal to the leaf's view there); a mesh whose devices
    differ in type from the state's, or among themselves, and misfit
    specs raise."""
    state = _small_state()
    cpus = make_mesh((2, 2), ("data", "model"),
                     devices=[torch.device("cpu", i) for i in range(4)])
    sh = shd.state_shardings(cpus, state, shd.lm_rules(cpus))
    placed = shd.place(state, sh)
    emb = placed["params"]["embed"]
    assert isinstance(emb, shd.Placed) and len(emb.parts()) == 4
    views = sh["params"]["embed"]
    for coord, piece in zip(views.coords(), emb.pieces):
        want = views.piece(state["params"].embed, coord)
        assert torch.equal(piece, want)
        assert piece.data_ptr() != want.data_ptr()
    assert placed["step"] == 0
    for mesh in (make_host_mesh(2, 2, device="meta"),
                 make_mesh((2, 1), ("data", "model"),
                           devices=["cpu", "meta"])):
        with pytest.raises(ValueError, match="more than one type"):
            shd.place(state, shd.state_shardings(mesh, state,
                                                 shd.lm_rules(mesh)))
    cpu = make_host_mesh(2, 2)
    sh = shd.state_shardings(cpu, state, shd.lm_rules(cpu))
    sh["params"]["final_norm"] = shd.NamedSharding(cpu, shd.P("data", "model"))
    with pytest.raises(ValueError, match="more entries"):
        shd.place(state, sh)
    sh["params"]["final_norm"] = shd.NamedSharding(
        make_host_mesh(3, 1), shd.P("data"))
    with pytest.raises(ValueError, match="does not fit"):
        shd.place(state, sh)


def test_reshard_state_round_trip(tmp_path):
    state = _small_state()
    ckpt.save(str(tmp_path), 3, state)
    mesh = make_host_mesh(2, 4)
    like = _small_state()
    sh = shd.state_shardings(mesh, like, shd.lm_rules(mesh))
    got = reshard_state(str(tmp_path), 3, like, sh)
    for a, b in zip(T.leaves(state), T.leaves(got)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    mixed = make_mesh((2, 1), ("data", "model"), devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="more than one type"):
        reshard_state(str(tmp_path), 3, like,
                      shd.state_shardings(mixed, like, shd.lm_rules(mixed)))
    with pytest.raises(ValueError, match="not both"):
        ckpt.restore(str(tmp_path), 3, like, device="cpu", shardings=sh)
