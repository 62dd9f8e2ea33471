"""Parity of the port's training stack (``repro_torch.training``,
``models.transformer.loss_fn``, ``data.lm_pipeline``) with the reference's
on the CPU, and twins of ``tests/test_training.py``.

* `loss_fn` and every gradient leaf against ``jax.value_and_grad`` for
  granite-moe, grok-1 and qwen3-4b (dense) REDUCED, remat on and off, on
  the reference's ``init(PRNGKey(0))`` carried across: the loss within
  rtol 1e-5, each leaf (the port's per-layer gradients stacked as the
  reference's) within rtol 1e-4 plus an atol of 1e-4 x the leaf's largest
  magnitude (dense: f32 sums in another order) or 1e-3 x (MoE: a gate's
  gradient passes the bf16 combine chain, as in the reference, where f32
  noise can flip one bf16 rounding, 2^-8 of that gate's gradient, which
  reaches the earlier positions through attention); the chunked attention
  that trains through ``gqa_chunked`` (bf16 P . V) within 1e-2 x;
* `sgd` (momentum), `adamw` and `adafactor` against the reference's for 3
  steps on a tree with a bf16 leaf, a vector leaf and a layer list (stacked
  in the reference): params within 1e-6 (f32) or one bf16 ulp, states
  within 1e-6 relative;
* `cosine_schedule` at every step, ``accum_steps=2`` against the
  reference's step, the synthetic batches token for token;
* the ef-compression test of ``test_training.py`` has its twin in
  ``test_torch_compression.py``.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_1b as j_granite
from repro.configs import grok_1_314b as j_grok
from repro.configs import qwen3_4b as j_qwen3
from repro.data import lm_pipeline as jpipe
from repro.models import transformer as jt
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.data.lm_pipeline import (Prefetcher, device_put_batch,
                                          synthetic_lm_batches)
from repro_torch.models import transformer as tt
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T
from repro_torch.training.fault_tolerance import (StragglerDetector,
                                                  make_elastic_mesh,
                                                  plan_mesh_shape,
                                                  resume_or_init)
from repro_torch.training.optimizer import (adafactor, adamw, apply_updates,
                                            cosine_schedule, sgd)
from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                             init_state, make_train_step)

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

J_CONFIGS = {"granite-moe-1b-a400m": j_granite, "grok-1-314b": j_grok,
             "qwen3-4b": j_qwen3}


def _port_cfg(cfg) -> tt.TransformerConfig:
    return tt.TransformerConfig(**dataclasses.asdict(cfg))


def _np(a) -> np.ndarray:
    """A reference or port leaf as a float64 numpy array (bf16 widened)."""
    if torch.is_tensor(a):
        return a.detach().double().numpy()
    a = np.asarray(a)
    return a.astype(np.float64)


def _ref_leaves(tree) -> dict:
    """{path: stacked tensor} of a port tree's reference view."""
    return {"$".join(map(str, p)): T.stacked(leaf).detach()
            for p, leaf in T.ref_items(tree)}


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"$".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _check_grads(cfg, leaf_atol):
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = _port_cfg(cfg)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    labels[0, :5] = -1                                   # masked labels
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(
        params, cfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss = tt.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, T.leaves(model))
    it = iter(grads)
    got = _ref_leaves(T.tree_map(lambda _: next(it), model))
    want = _jax_leaves(jgrads)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(got) == set(want)
    for key, g in got.items():
        w = np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(
            _np(g), w, rtol=1e-4,
            atol=leaf_atol * max(np.abs(w).max(), 1e-12), err_msg=key)
    if cfg.is_moe:
        assert float(np.abs(want["layers$moe$router"]).max()) > 0


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_loss_and_grads_match_reference(arch, remat):
    cfg = dataclasses.replace(J_CONFIGS[arch].REDUCED, remat=remat)
    _check_grads(cfg, 1e-3 if cfg.is_moe else 1e-4)


def test_chunked_attention_grads_match_reference():
    """qwen3-4b REDUCED with attn_impl "chunked": training's attention is
    the plain gqa_chunked on both sides (bf16 P . V)."""
    _check_grads(dataclasses.replace(j_qwen3.REDUCED, attn_impl="chunked"),
                 1e-2)


def test_moe_router_receives_gradient():
    """Twin of test_models.py::test_moe_grouped_loss_and_grads."""
    cfg = tt.TransformerConfig(name="m", n_layers=2, d_model=32, n_heads=4,
                               n_kv_heads=2, d_ff=32, vocab_size=64,
                               dtype="float32", n_experts=4, top_k=2,
                               moe_group=32)
    model = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    model.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 64), dtype=np.int32))
    loss = tt.loss_fn(model, cfg, {"tokens": toks, "labels": toks})
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert float(model.layers[0].moe["router"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_trees(rng):
    """The same parameters as a port tree (a layer list) and a reference
    tree (the layers stacked)."""
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bf = rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)
    vec = rng.standard_normal(7).astype(np.float32)
    lay = rng.standard_normal((2, 3, 5)).astype(np.float32)
    lnorm = rng.standard_normal((2, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(w), "bf": jnp.asarray(bf), "vec": jnp.asarray(vec),
             "layers": {"m": jnp.asarray(lay), "norm": jnp.asarray(lnorm)}}
    ttree = {"w": torch.from_numpy(w),
             "bf": torch.from_numpy(bf.view(np.uint16).view(np.int16)).view(
                 torch.bfloat16),
             "vec": torch.from_numpy(vec),
             "layers": [{"m": torch.from_numpy(lay[i].copy()),
                         "norm": torch.from_numpy(lnorm[i].copy())}
                        for i in range(2)]}
    return jtree, ttree


def _grad_trees(rng, jtree):
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                     jtree)
    g["bf"] = g["bf"].astype(ml_dtypes.bfloat16)
    jg = jax.tree.map(jnp.asarray, g)
    tg = {"w": torch.from_numpy(g["w"]),
          "bf": torch.from_numpy(g["bf"].view(np.uint16).view(np.int16)).view(
              torch.bfloat16),
          "vec": torch.from_numpy(g["vec"]),
          "layers": [{"m": torch.from_numpy(g["layers"]["m"][i].copy()),
                      "norm": torch.from_numpy(g["layers"]["norm"][i].copy())}
                     for i in range(2)]}
    return jg, tg


OPTS = {"sgd": (lambda m: m.sgd(0.1, momentum=0.9, grad_clip=1.0)),
        "adamw": (lambda m: m.adamw(m.cosine_schedule(1e-2, 2, 10),
                                    weight_decay=0.1)),
        "adafactor": (lambda m: m.adafactor(1e-2, weight_decay=0.01))}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizers_match_reference(name):
    import repro_torch.training.optimizer as topt
    rng = np.random.default_rng(4)
    jtree, ttree = _opt_trees(rng)
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    js, ts = jo.init(jtree), to.init(ttree)
    assert set(_jax_leaves(js)) == set(_ref_leaves(ts))
    for step in range(3):
        jg, tg = _grad_trees(rng, jtree)
        ju, js = jo.update(jg, js, jtree, jnp.int32(step))
        jtree = jopt.apply_updates(jtree, ju)
        tu, ts = to.update(tg, ts, ttree, step)
        ttree = apply_updates(ttree, tu)
    got, want = _ref_leaves(ttree), _jax_leaves(jtree)
    for key, w in want.items():
        if key == "bf":
            assert got[key].dtype == torch.bfloat16
            np.testing.assert_allclose(_np(got[key]), _np(w), rtol=2.0 ** -8,
                                       atol=0)
        else:
            np.testing.assert_allclose(_np(got[key]), _np(w), rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    got_s, want_s = _ref_leaves(ts), _jax_leaves(js)
    for key, w in want_s.items():
        assert got_s[key].dtype == torch.float32
        np.testing.assert_allclose(_np(got_s[key]), _np(w), rtol=1e-5,
                                   atol=1e-6 * max(np.abs(_np(w)).max(), 1e-30),
                                   err_msg=key)


def test_cosine_schedule_matches_reference():
    for args in ((1e-3, 10, 100), (3e-4, 100, 20), (1.0, 0, 7)):
        jf, tf = jopt.cosine_schedule(*args), cosine_schedule(*args)
        for step in range(args[2] + 5):
            assert tf(step) == pytest.approx(float(jf(jnp.int32(step))),
                                             rel=1e-6, abs=1e-12)


def _tiny():
    return jt.TransformerConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                                n_kv_heads=2, d_ff=64, vocab_size=64,
                                dtype="float32")


def test_accum_steps_matches_reference():
    cfg = _tiny()
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = _port_cfg(cfg)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, 64, (2, 3, 16), dtype=np.int32)
    jo, to = jopt.adamw(1e-2, weight_decay=0.01), adamw(1e-2, weight_decay=0.01)
    jstep = jloop.make_train_step(lambda p, b: jt.loss_fn(p, cfg, b), jo,
                                  accum_steps=2, donate=False)
    tstep = make_train_step(lambda p, b: tt.loss_fn(p, tcfg, b), to,
                            accum_steps=2)
    jst, jm = jstep(jloop.init_state(params, jo),
                    {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    tst, tm = tstep(init_state(model, to), {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(toks)})
    assert tst["step"] == int(jst["step"]) == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    # Adam's first step is lr g / (|g| + eps): a gradient near eps turns
    # f32 noise into up to 1e-3 of lr
    got, want = _ref_leaves(tst["params"]), _jax_leaves(jst["params"])
    for key, w in want.items():
        np.testing.assert_allclose(_np(got[key]), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_synthetic_batches_are_the_references():
    a = next(jpipe.synthetic_lm_batches(97, 3, 40, seed=2, start_step=7))
    b = next(synthetic_lm_batches(97, 3, 40, seed=2, start_step=7))
    for key in ("tokens", "labels"):
        assert b[key].dtype == torch.int32
        assert (b[key].numpy() == np.asarray(a[key])).all()
    wide = next(synthetic_lm_batches(97, 3, 40, seed=2, start_step=7,
                                     dtype=torch.int64))
    assert wide["tokens"].dtype == torch.int64
    assert (device_put_batch(b, "cpu")["labels"] == b["labels"]).all()


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------

def _quad(p):
    return torch.sum(p["w"] ** 2) + torch.sum(p["m"] ** 2)


def _run_opt(opt, steps=200):
    p = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones((4, 6)) * 2}
    s = opt.init(p)
    for t in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        g = dict(zip(leaves, torch.autograd.grad(_quad(leaves),
                                                 list(leaves.values()))))
        u, s = opt.update(g, s, p, t)
        p = apply_updates(p, u)
    return float(_quad(p))


def test_optimizers_descend():
    assert _run_opt(sgd(0.1)) < 1e-4
    assert _run_opt(adamw(0.05, weight_decay=0.0)) < 1e-4
    f = _run_opt(adafactor(lambda t: 0.5 / np.sqrt(t + 1)), 300)
    assert f < 109.0 / 100


def test_adafactor_memory_factored():
    opt = adafactor(1e-2)
    s = opt.init({"w": torch.zeros((64, 32))})
    assert sum(x.numel() for x in T.leaves(s)) == 64 + 32


def test_cosine_schedule_shape():
    sch = cosine_schedule(1e-3, warmup=10, total=100)
    assert sch(0) < 2e-4
    assert abs(sch(10) - 1e-3) < 1e-4
    assert sch(99) < 2.1e-4


def _tiny_lm():
    cfg = _port_cfg(_tiny())
    return cfg, tt.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")


def test_train_loop_and_restart_replay():
    cfg, model = _tiny_lm()
    opt = adamw(1e-2, weight_decay=0.01)
    step_fn = make_train_step(lambda p, b: tt.loss_fn(p, cfg, b), opt,
                              donate=False)

    def fresh():
        return init_state(_tiny_lm()[1], opt)

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(TrainerConfig(total_steps=12, ckpt_dir=d, ckpt_every=5,
                                   log_every=50),
                     step_fn, init_state(model, opt),
                     Prefetcher(synthetic_lm_batches(64, 4, 16)),
                     straggler_detector=StragglerDetector(), log_fn=lambda s: None)
        final = tr.run()
        assert tr.history[-1]["loss"] < tr.history[0]["loss"]
        # crash-restart from step 10 replays to identical params
        st, start = resume_or_init(d, fresh)
        assert start == 12 and st["step"] == 12
        st10 = ckpt.restore(d, 10, fresh())
        assert st10["step"] == 10
        data = synthetic_lm_batches(64, 4, 16, start_step=10)
        for _ in range(2):
            st10, _ = step_fn(st10, next(data))
        for a, b in zip(T.leaves(final["params"]), T.leaves(st10["params"])):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       atol=1e-6)


def test_checkpoint_atomic_and_keep_k():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
        for s in [1, 2, 3, 4]:
            ckpt.save(d, s, tree, keep=2)
        assert ckpt.all_steps(d) == [3, 4]
        back = ckpt.restore(d, 4, tree)
        np.testing.assert_array_equal(back["a"].numpy(), np.arange(5))


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as d:
        ac = ckpt.AsyncCheckpointer(d, keep=3)
        for s in [1, 2]:
            ac.save(s, {"x": torch.full((4,), float(s))})
        ac.close()
        assert ckpt.all_steps(d) == [1, 2]
        got = ckpt.restore(d, 2, {"x": torch.zeros((4,))})
        assert float(got["x"][0]) == 2


def test_straggler_detector_flags_outlier():
    det = StragglerDetector(warmup_steps=5, z_threshold=3.0)
    for i in range(30):
        det.record(i, 0.1 + 0.001 * (i % 3))
    assert not det.events
    assert det.record(30, 1.5)     # 15x slower step
    assert det.events[-1][0] == 30


def test_elastic_mesh_planning():
    assert plan_mesh_shape(512, model_parallel=16) == (32, 16)
    assert plan_mesh_shape(256, model_parallel=16) == (16, 16)
    # lose a host: 248 devices -> mp shrinks to a divisor, dp stays pow2
    dp, mp = plan_mesh_shape(248, model_parallel=16)
    assert dp * mp <= 248 and 248 % mp == 0
    mesh = make_elastic_mesh(6, model_parallel=2, devices=["cpu"] * 6)
    assert dict(mesh.shape) == {"data": 2, "model": 2}


def test_pipeline_determinism():
    a = next(synthetic_lm_batches(64, 2, 8, start_step=5))["tokens"].ravel()
    b = next(synthetic_lm_batches(64, 2, 8, start_step=5))["tokens"].ravel()
    assert a.tolist() == b.tolist()
