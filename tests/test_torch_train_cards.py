"""A train state laid on distinct devices (``distributed.sharding.place``
over a mesh of ``cpu:0..3``, each entry its own allocation) and trained
there, against the reference's GSPMD step over 4 fake XLA devices on the
same (data 2, model 2) mesh.

One subprocess runs the reference: REDUCED yi-6b (f32) and REDUCED
granite (MoE, ``scatter_shmap`` under the MoE mesh) with AdamW, each
state placed by its ``state_shardings`` and stepped three times by its
``make_train_step`` with the vocab-parallel loss; the vp loss's value and
grads over the placed params; its mesh MoE dispatch; `psum_int8` /
`psum_bf16` in a shard_map over 4 devices; and two Adafactor steps of
REDUCED yi-6b. Against it:

* every piece of the port's placed state equals the reference's
  ``addressable_shards`` data for its device bit for bit; after one and
  three steps each piece is within rtol 1e-4 / atol 1e-5 of the
  reference's array over the piece's box (params and both moments), the
  losses within rel 1e-5;
* the vp loss over a placed model and its gradient pieces, its forward's
  logits against the one-device model's; the mesh MoE
  dispatch (y and aux) over distinct devices; `psum_*` over pieces, one
  result a device; Adafactor's factored moments over pieces;
* save, ``restore(shardings=)`` and `reshard_state` from (2, 2) to (1, 2),
  bit for bit, and a step after each equal to one without the round
  trip; two runs of three steps bit for bit.

The AdamW's learning rate is 1e-4: its first update is lr g / (|g| +
eps), so f32 noise in a gradient near eps moves a parameter by up to a
few percent of lr (``tests/test_torch_training.py``), which at 1e-2
would exceed the parameter tolerance whichever side is right.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.distributed import compression as tc
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T
from repro_torch.training.fault_tolerance import make_elastic_mesh, \
    reshard_state
from repro_torch.training.optimizer import adafactor, adamw
from repro_torch.training.train_loop import (_grads, init_state,
                                             make_train_step)

torch.set_num_threads(2)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = {"yi": ("yi-6b", {}),
         "granite": ("granite-moe-1b-a400m", {"moe_impl": "scatter_shmap"})}
B, S, STEPS, LR = 4, 32, 3, 1e-4
MOE_SPEC = dict(d_model=32, d_ff=16, n_experts=8, top_k=2)


def _cards(n=4):
    return [torch.device("cpu", i) for i in range(n)]


def _mesh(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"),
                     devices=_cards(int(np.prod(shape))))


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 512, (B, S), dtype=np.int32)
        labels = rng.integers(0, 512, (B, S), dtype=np.int32)
        labels[0, :5] = -1
        out.append((toks, labels))
    return out


REF_CODE = """
import jax, jax.numpy as jnp, numpy as np, dataclasses
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.distributed import sharding as shd
from repro.distributed.compression import psum_bf16, psum_int8
from repro.launch.mesh import make_mesh
from repro.models import moe as jm, transformer as jt
from repro.training import optimizer as jopt, train_loop as jloop

CASES, BATCHES, LR = {cases!r}, {batches!r}, {lr!r}
mesh = make_mesh((2, 2), ("data", "model"))
coord = {{d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}}
res = {{}}

def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {{"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in p): v for p, v in leaves}}

def batch(k):
    toks, labels = BATCHES[k]
    return {{"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}}

def run(name, cfg, opt, steps, shards):
    params = jt.init(jax.random.PRNGKey(0), cfg)
    for key, v in flat(params).items():
        res[f"{{name}}/init/{{key}}"] = np.asarray(v)
    state = jloop.init_state(params, opt)
    state = jax.device_put(state, shd.state_shardings(mesh, state,
                                                      shd.lm_rules(mesh)))
    if shards:
        for key, v in flat({{"params": state["params"],
                             "opt": state["opt"]}}).items():
            for s in v.addressable_shards:
                i, j = coord[s.device.id]
                res[f"{{name}}/shard/{{key}}@{{i}}{{j}}"] = np.asarray(s.data)
    step = jloop.make_train_step(jt.make_vp_loss_fn(cfg, mesh), opt,
                                 donate=False)
    for k in range(steps):
        state, m = step(state, batch(k))
        res[f"{{name}}/loss{{k}}"] = np.asarray(m["loss"])
        res[f"{{name}}/gnorm{{k}}"] = np.asarray(m["grad_norm"])
        if k in (0, steps - 1):
            for key, v in flat({{"params": state["params"],
                                 "opt": state["opt"]}}).items():
                res[f"{{name}}/step{{k + 1}}/{{key}}"] = np.asarray(v)
    return params

for name, (arch, kw) in CASES.items():
    cfg = dataclasses.replace(configs.get(arch).reduced, **kw)
    if cfg.is_moe:
        jm.set_moe_mesh(mesh, ("data",))
    params = run(name, cfg, jopt.adamw(LR, weight_decay=0.1), len(BATCHES),
                 True)
    jm.set_moe_mesh(None, ())
    if name == "yi":
        placed = jax.device_put(params, shd.named(mesh, shd.param_pspecs(
            params, shd.lm_rules(mesh), mesh)))
        loss, g = jax.value_and_grad(jt.make_vp_loss_fn(cfg, mesh))(
            placed, batch(0))
        res["vp/loss"] = np.asarray(loss)
        for key, v in flat(g).items():
            res[f"vp/g/{{key}}"] = np.asarray(v)
        run("ada", cfg, jopt.adafactor(1e-2), 2, False)

spec = jm.MoESpec(**{moe!r})
p = jm.moe_init(jax.random.PRNGKey(0), spec, jnp.float32)
for key, v in p.items():
    res[f"moe/p/{{key}}"] = np.asarray(v)
x = jnp.asarray(np.random.default_rng(3).standard_normal((4, 16, 32)),
                jnp.float32)
jm.set_moe_mesh(mesh, ("data",))
y, aux = jm.moe_apply_scatter_shmap(p, spec, x)
jm.set_moe_mesh(None, ())
res["moe/x"], res["moe/y"], res["moe/aux"] = (np.asarray(x), np.asarray(y),
                                              np.asarray(aux))

flat_mesh = make_mesh((4,), ("d",))
xs = (np.random.default_rng(4).standard_normal((4, 256)) *
      np.array([[1.0], [3.0], [0.01], [1.0]])).astype(np.float32)
res["psum/x"] = xs
for name, fn in (("int8", psum_int8), ("bf16", psum_bf16)):
    f = shard_map(lambda v: fn(v, "d"), mesh=flat_mesh, in_specs=P("d"),
                  out_specs=P("d"), check_rep=False)
    res[f"psum/{{name}}"] = np.asarray(f(jnp.asarray(xs)))
np.savez({out!r}, **res)
print("TRAIN_CARDS_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("cards") / "ref.npz"
    batches = [(t.tolist(), l.tolist()) for t, l in _batches(7)]
    code = REF_CODE.format(cases=CASES, batches=batches, lr=LR, moe=MOE_SPEC,
                           out=str(out))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0 and "TRAIN_CARDS_REF_OK" in run.stdout, \
        run.stderr[-3000:]
    return dict(np.load(out))


def _tree(ref, prefix) -> dict:
    """The reference's arrays under ``prefix`` as a nested dict."""
    out: dict = {}
    for key, v in ref.items():
        if key.startswith(prefix + "/"):
            node = out
            *path, last = key[len(prefix) + 1:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = v
    return out


def _cfg(name):
    arch, kw = CASES[name]
    return dataclasses.replace(get(arch).reduced, **kw)


def _placed_state(ref, name, opt, mesh=None):
    cfg = _cfg(name)
    model = tt.from_numpy(_tree(ref, f"{name}/init"), cfg, device="cpu")
    state = init_state(model, opt)
    mesh = mesh or _mesh()
    return cfg, shd.place(state, shd.state_shardings(mesh, state,
                                                     shd.lm_rules(mesh)))


def _batch(k):
    toks, labels = _batches(7)[k]
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


def _moe_mesh(cfg, mesh):
    tm.set_moe_mesh(mesh if cfg.is_moe else None, ("data",) if cfg.is_moe
                    else ())


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): v for p, v in T.ref_items(tree)}


def _check_pieces(placed: dict, want: dict, exact: bool):
    """Every piece of every placed leaf against the reference's array over
    the piece's box (``want``: path -> global array)."""
    for key, leaf in placed.items():
        assert isinstance(leaf, shd.Placed), key
        for box, t, _ in leaf.parts():
            w = want[key][tuple(slice(s, e) for s, e in box)]
            if exact:
                assert np.array_equal(t.numpy(), w), key
            else:
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-4, atol=1e-5,
                                           err_msg=key)


def _run(ref, name, steps=STEPS):
    cfg, state = _placed_state(ref, name, adamw(LR, weight_decay=0.1))
    _moe_mesh(cfg, _mesh())
    try:
        step = make_train_step(tt.make_vp_loss_fn(cfg, _mesh()),
                               adamw(LR, weight_decay=0.1))
        metrics, after = [], {}
        for k in range(steps):
            state, m = step(state, _batch(k))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if k in (0, steps - 1):     # a copy: the step updates in place
                after[k + 1] = {key: leaf.map(torch.clone) for key, leaf in
                                _flat({"params": state["params"],
                                       "opt": state["opt"]}).items()}
    finally:
        tm.set_moe_mesh(None, ())
    return state, metrics, after


@pytest.mark.parametrize("name", sorted(CASES))
def test_placed_pieces_are_the_reference_shards(ref, name):
    _, state = _placed_state(ref, name, adamw(LR, weight_decay=0.1))
    placed = _flat({"params": state["params"], "opt": state["opt"]})
    coords = {(i, j): c for c, (i, j) in enumerate(
        [(i, j) for i in range(2) for j in range(2)])}
    n = 0
    for key, leaf in placed.items():
        for (i, j), c in coords.items():
            want = ref[f"{name}/shard/{key}@{i}{j}"]
            assert np.array_equal(leaf.pieces[c].numpy(), want), (key, i, j)
            n += 1
        # one allocation a device: no two coordinates share a tensor
        assert len({id(t) for t in leaf.pieces}) == 4
    assert n == 4 * len(placed)


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_reference_gspmd(ref, name):
    _, metrics, after = _run(ref, name)
    for k, (loss, gnorm) in enumerate(metrics):
        assert loss == pytest.approx(float(ref[f"{name}/loss{k}"]), rel=1e-5)
        assert gnorm == pytest.approx(float(ref[f"{name}/gnorm{k}"]),
                                      rel=1e-4)
    for k, got in after.items():
        _check_pieces(got, {key: ref[f"{name}/step{k}/{key}"] for key in got},
                      exact=False)


def test_vp_loss_and_grads_over_a_placed_model(ref):
    cfg, state = _placed_state(ref, "yi", adamw(LR))
    loss, grads = _grads(tt.make_vp_loss_fn(cfg, _mesh()), state["params"],
                         _batch(0))
    assert float(loss) == pytest.approx(float(ref["vp/loss"]), rel=1e-5)
    got = _flat(grads)
    assert set(got) == {k[len("vp/g/"):] for k in ref if k.startswith("vp/g/")}
    for key, leaf in got.items():
        assert leaf.boxes == _flat(state["params"])[key].boxes
    _check_pieces(got, {k: ref[f"vp/g/{k}"] for k in got}, exact=False)
    # the plain loss of a placed model is the same vocab-parallel loss
    plain = tt.loss_fn(state["params"], cfg, _batch(0))
    assert float(plain.detach()) == float(loss)
    # forward over the placed model: the logits on the mesh's first device
    model = tt.from_numpy(_tree(ref, "yi/init"), cfg, device="cpu")
    with torch.no_grad():
        want, _ = tt.forward(model, cfg, _batch(0)["tokens"])
        got, aux = tt.forward(state["params"], cfg, _batch(0)["tokens"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == 0.0


def test_moe_dispatch_over_distinct_devices(ref):
    p = {k: torch.from_numpy(ref[f"moe/p/{k}"].copy())
         for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(ref["moe/x"].copy())
    tm.set_moe_mesh(_mesh(), ("data",))
    try:
        y, aux = tm.moe_apply_scatter_shmap(p, tm.MoESpec(**MOE_SPEC), x)
        with pytest.raises(ValueError, match="do not divide"):
            tm.moe_apply_scatter_shmap(p, tm.MoESpec(**MOE_SPEC), x[:3])
    finally:
        tm.set_moe_mesh(None, ())
    np.testing.assert_allclose(y.numpy(), ref["moe/y"], rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(ref["moe/aux"])) <= 1e-6
    chunks = [tm.moe_apply_scatter(p, tm.MoESpec(**MOE_SPEC), c)
              for c in x.chunk(2)]
    assert float(aux) == float(torch.stack([a for _, a in chunks]).mean())


def test_psum_over_pieces(ref):
    xs = [torch.from_numpy(r.copy()) for r in ref["psum/x"]]
    got8 = tc.psum_int8(xs, devices=_cards())
    got16 = tc.psum_bf16(xs, devices=_cards())
    assert len(got8) == len(got16) == 4
    want = ref["psum/x"].sum(0)
    scale = np.abs(want).max()
    for d in range(4):
        assert np.array_equal(got8[d].numpy(), ref["psum/int8"][d])
        assert torch.equal(got16[d], got16[0])
        assert np.abs(got16[d].numpy() - ref["psum/bf16"][d]).max() / scale \
            < 2e-2
    assert np.abs(got8[0].numpy() - want).max() / scale < 4e-2
    # the one-device form returns the one tensor, the same bits
    assert torch.equal(tc.psum_int8(xs), got8[0])


def test_adafactor_over_pieces_matches_reference(ref):
    cfg, state = _placed_state(ref, "yi", adafactor(1e-2))
    step = make_train_step(tt.make_vp_loss_fn(cfg, _mesh()), adafactor(1e-2))
    for k in range(2):
        state, m = step(state, _batch(k))
        assert float(m["loss"]) == pytest.approx(float(ref[f"ada/loss{k}"]),
                                                 rel=1e-5)
    got = _flat({"params": state["params"], "opt": state["opt"]})
    assert any(key.endswith("/vr") for key in got)
    _check_pieces(got, {key: ref[f"ada/step2/{key}"] for key in got},
                  exact=False)


def test_accum_steps_over_pieces(ref):
    """Micro-batch accumulation over a placed state: the one-device
    step's, piece for piece."""
    opt = adamw(LR, weight_decay=0.1)
    cfg, state = _placed_state(ref, "yi", opt)
    model = tt.from_numpy(_tree(ref, "yi/init"), cfg, device="cpu")
    plain = init_state(model, opt)
    toks = torch.stack([_batch(k)["tokens"] for k in range(2)])
    labels = torch.stack([_batch(k)["labels"] for k in range(2)])
    batch = {"tokens": toks, "labels": labels}
    state, m = make_train_step(tt.make_vp_loss_fn(cfg, _mesh()), opt,
                               accum_steps=2)(state, batch)
    plain, pm = make_train_step(lambda p, b: tt.loss_fn(p, cfg, b), opt,
                                accum_steps=2)(plain, batch)
    assert float(m["loss"]) == pytest.approx(float(pm["loss"]), rel=1e-5)
    want = {k: T.stacked(v).detach().numpy()
            for k, v in _flat({"params": plain["params"],
                               "opt": plain["opt"]}).items()}
    _check_pieces(_flat({"params": state["params"], "opt": state["opt"]}),
                  want, exact=False)


def test_ef_compress_over_pieces():
    cfg = get("yi-6b").reduced
    model = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    mesh = _mesh()
    placed = shd.place(model, shd.named(mesh, shd.param_pspecs(
        model, shd.lm_rules(mesh), mesh)))
    grads = T.tree_map(lambda leaf: leaf.map(lambda t: t * 1e-2 + 1e-3),
                       placed)
    ef = tc.ef_init(placed)
    total = None
    for _ in range(50):
        q, ef = tc.ef_compress(grads, ef)
        total = q if total is None else T.tree_map(
            lambda a, b: a.map(torch.add, b), total, q)
    for key, leaf in _flat(total).items():
        want = _flat(grads)[key].assemble("cpu") * 50
        err = (leaf.assemble("cpu") - want).abs().max() / want.abs().max()
        assert err < 0.01, key


def _bits_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        torch.equal(x.assemble("cpu"), b[k].assemble("cpu"))
        if isinstance(x, shd.Placed) else x == b[k] for k, x in a.items())


def test_save_restore_and_reshard_round_trips(ref, tmp_path):
    cfg, state = _placed_state(ref, "yi", adamw(LR, weight_decay=0.1))
    step = make_train_step(tt.make_vp_loss_fn(cfg, _mesh()),
                           adamw(LR, weight_decay=0.1))
    state, _ = step(state, _batch(0))               # moments not all zero
    ckpt.save(str(tmp_path), 1, state)
    sh = shd.state_shardings(_mesh(), state, shd.lm_rules(_mesh()))
    back = ckpt.restore(str(tmp_path), 1, state, shardings=sh)
    assert back["step"] == 1
    assert _bits_equal(_flat(back), _flat(state))
    for key, leaf in _flat(back).items():
        if isinstance(leaf, shd.Placed):
            assert leaf.boxes == _flat(state)[key].boxes
    two = make_elastic_mesh(2, model_parallel=2, devices=_cards(2))
    assert dict(two.shape) == {"data": 1, "model": 2}
    sh2 = shd.state_shardings(two, state, shd.lm_rules(two))
    small = reshard_state(str(tmp_path), 1, state, sh2)
    assert _bits_equal(_flat(small), _flat(state))
    assert {len(leaf.parts()) for leaf in _flat(small["params"]).values()} \
        == {2}
    direct = shd.place(state, sh2)
    # the one-card state the checkpoint restores is the pieces' whole
    plain = ckpt.restore(str(tmp_path), 1, init_state(
        tt.Transformer(cfg, device="cpu"), adamw(LR)), device="cpu")
    for key, leaf in _flat(plain["params"]).items():
        assert torch.equal(T.stacked(leaf).detach(),
                           _flat(small["params"])[key].assemble("cpu"))
    # a step after each round trip (the steps update in place)
    step2 = make_train_step(tt.make_vp_loss_fn(cfg, two),
                            adamw(LR, weight_decay=0.1))
    c, _ = step2(small, _batch(1))
    d, _ = step2(direct, _batch(1))
    assert _bits_equal(_flat(c), _flat(d))
    a, _ = step(state, _batch(1))
    b, _ = step(back, _batch(1))
    assert _bits_equal(_flat(a), _flat(b))


def test_two_runs_are_bit_for_bit(ref):
    a, _, _ = _run(ref, "granite")
    b, _, _ = _run(ref, "granite")
    assert _bits_equal(_flat(a), _flat(b))


def test_launcher_mesh_over_cards_needs_the_cards(monkeypatch):
    """``--mesh`` without ``--device`` takes the first D x M cards and
    raises when there are fewer; with ``--device cpu`` it is a logical
    mesh of the CPU."""
    from repro_torch.launch import train as train_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="needs 4 CUDA devices; 2 available"):
        train_mod.main(["--arch", "yi-6b", "--reduced", "--mesh", "2x2",
                        "--steps", "1"])
