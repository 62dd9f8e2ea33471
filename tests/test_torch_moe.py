"""Parity of the port's MoE layer and MoE models (``repro_torch.models.moe``,
the MoE branch of ``models.transformer``) with the reference's on the CPU.

`moe_apply` (the GShard one-hot dispatch) and `moe_apply_scatter` get the
reference's own ``moe_init`` parameters and the same numpy tokens: in f32
the outputs within rtol = atol = 1e-5 and the aux loss within 1e-6; in
bf16 the outputs within two bf16 ulps of the largest output (2^-6 of
max |y|: the expert matmuls round to bf16 at different places in XLA and
torch) -- including a group that overflows its experts' capacity, so that
tokens drop, and a router whose probabilities all tie (top-k to the lower
expert, as ``jax.lax.top_k``). granite-moe and grok-1 REDUCED serve:
`prefill` and 4 greedy `decode_step`s at `test_torch_models.py`'s
tolerances with the greedy tokens equal, a prompt whose left padding
overflows a group, and `RAGEngine.serve` against the reference's engine.
`to_numpy(from_numpy(tree))` gives the reference's tree back bit for bit
with the router f32 in a bf16 model. The forward-only attention kernels'
wrappers refuse inputs that require grad, and training's attention never
reaches them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_1b as j_granite
from repro.configs import grok_1_314b as j_grok
from repro.models import moe as jm
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as TL
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-4
J_CONFIGS = {"granite-moe-1b-a400m": j_granite, "grok-1-314b": j_grok}
SPEC = dict(d_model=32, d_ff=16, n_experts=8, top_k=2)


def _port_cfg(cfg) -> tt.TransformerConfig:
    return tt.TransformerConfig(**dataclasses.asdict(cfg))


def _moe_params(dtype, router=None):
    p = jax.tree.map(np.asarray, jm.moe_init(jax.random.PRNGKey(0),
                                             jm.MoESpec(**SPEC),
                                             jnp.dtype(dtype)))
    if router is not None:
        p["router"] = router
    return p


def _both(p, x, dtype, impl):
    jy, jaux = jm.moe_apply(jax.tree.map(jnp.asarray, p),
                            jm.MoESpec(**SPEC, impl=impl),
                            jnp.asarray(x).astype(dtype))
    ty, taux = tm.moe_apply({k: tt._tensor_of(v) for k, v in p.items()},
                            tm.MoESpec(**SPEC, impl=impl),
                            torch.from_numpy(x).to(getattr(torch, dtype)))
    return (np.asarray(jy.astype(jnp.float32)), float(jaux),
            ty.float().numpy(), float(taux))


def _dropped(p, x):
    """Kept (t, k) assignments the port's routing drops, and the
    reference's fits mask beside the port's."""
    jf = jm._route(jax.tree.map(jnp.asarray, p), jm.MoESpec(**SPEC),
                   jnp.asarray(x))[3]
    tf = tm._route({k: tt._tensor_of(v) for k, v in p.items()},
                   tm.MoESpec(**SPEC), torch.from_numpy(x))[3]
    return int((~tf).sum()), np.asarray(jf), tf.numpy()


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "overflow"])
def test_moe_apply_matches_reference(case, dtype, impl):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, SPEC["d_model"])).astype(np.float32)
    router = None
    if case == "overflow":         # every token's first choice is expert 3
        router = (rng.standard_normal((SPEC["d_model"], 8)) * 0.05).astype(
            np.float32)
        x[..., 0] = 4.0
        router[0, 3] = 10.0
    p = _moe_params(dtype, router)
    n_drop, jfits, tfits = _dropped(p, x)
    assert (jfits == tfits).all()
    if case == "overflow":
        assert n_drop >= 3 * (40 - tm.capacity(40, tm.MoESpec(**SPEC)))
    jy, jaux, ty, taux = _both(p, x, dtype, impl)
    assert np.isfinite(ty).all()
    assert abs(jaux - taux) <= 1e-6 * max(1.0, abs(jaux))
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(ty - jy).max() <= 2.0 ** -6 * np.abs(jy).max()


def test_route_ties_go_to_the_lower_expert():
    """A zero router: every probability ties at 1/E, so each token takes
    experts 0 .. k-1 and the later tokens overflow them."""
    p = _moe_params("float32", np.zeros((SPEC["d_model"], 8), np.float32))
    x = np.random.default_rng(1).standard_normal((2, 40, SPEC["d_model"])
                                                 ).astype(np.float32)
    jr = jm._route(jax.tree.map(jnp.asarray, p), jm.MoESpec(**SPEC),
                   jnp.asarray(x))
    tr = tm._route({k: tt._tensor_of(v) for k, v in p.items()},
                   tm.MoESpec(**SPEC), torch.from_numpy(x))
    assert (tr[1].numpy() == np.asarray(jr[1])).all()
    assert (tr[1].numpy() == np.arange(2)).all()
    for a, b in zip(jr[2:4], tr[2:4]):          # pos, fits
        assert (b.numpy() == np.asarray(a)).all()
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=1e-6)
    jy, _, ty, _ = _both(p, x, "float32", "einsum")
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)


def test_capacity_is_the_references():
    for T in (1, 7, 24, 64, 512, 2048):
        for kw in (SPEC, dict(d_model=8, d_ff=8, n_experts=32, top_k=8)):
            assert tm.capacity(T, tm.MoESpec(**kw)) == \
                jm.capacity(T, jm.MoESpec(**kw))


# ---------------------------------------------------------------------------
# MoE models on the REDUCED configs
# ---------------------------------------------------------------------------

def _models(arch: str, impl: str = "auto", dtype: str | None = None):
    cfg = dataclasses.replace(J_CONFIGS[arch].REDUCED, attn_impl=impl)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = _port_cfg(cfg)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_moe_prefill_and_decode_match_reference(arch, impl):
    cfg, params, tcfg, model = _models(arch, impl)
    rtol, atol = (TOL, TOL) if impl == "naive" else (1e-2, 8e-3)
    B, S, L = 3, 24, 32
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jl, jc = jt.prefill(params, cfg, jnp.asarray(toks), L)
    tl, tc = tt.prefill(model, tcfg, torch.from_numpy(toks), L)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                               atol=atol)
    jcur = jnp.argmax(jl, -1).astype(jnp.int32)
    tcur = torch.argmax(tl, -1).to(torch.int32)
    for t in range(4):
        assert (tcur.numpy() == np.asarray(jcur)).all(), f"token {t} differs"
        jl, jc = jt.decode_step(params, cfg, jcur, jc, jnp.int32(S + t))
        tl, tc = tt.decode_step(model, tcfg, tcur, tc, S + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                                   atol=atol)
        jcur = jnp.argmax(jl, -1).astype(jnp.int32)
        tcur = torch.argmax(tl, -1).to(torch.int32)
    # layer 1's cache carries layer 0's attention output (bf16 P . V in
    # chunked), so it is held at the logits' tolerance
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               rtol=rtol, atol=atol)


def test_left_padding_overflows_a_group(monkeypatch):
    """The engine left-pads prompts with token 0; 20 pads of a 24-token
    group route alike and take the experts' slots before the real tokens,
    so real tokens drop -- in both packages, with the same logits."""
    cfg, params, tcfg, model = _models("granite-moe-1b-a400m")
    toks = np.zeros((2, 24), np.int32)
    toks[:, 20:] = np.random.default_rng(6).integers(1, cfg.vocab_size,
                                                     (2, 4))
    drops = []
    route = tm._route

    def spy(p, spec, x):
        out = route(p, spec, x)
        drops.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(tm, "_route", spy)
    jl, _ = jt.prefill(params, cfg, jnp.asarray(toks), 28)
    tl, _ = tt.prefill(model, tcfg, torch.from_numpy(toks), 28)
    assert sum(drops) > 0, "no token dropped: the group did not overflow"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_moe_numpy_round_trip_is_bit_exact(arch, dtype):
    cfg = dataclasses.replace(J_CONFIGS[arch].REDUCED, dtype=dtype)
    tree = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(1), cfg))
    model = tt.from_numpy(tree, _port_cfg(cfg), device="cpu")
    assert model.layers[0].moe["router"].dtype == torch.float32
    back = tt.to_numpy(model)
    leaves, treedef = jax.tree.flatten(tree)
    back_leaves, back_def = jax.tree.flatten(back)
    assert treedef == back_def
    for a, b in zip(leaves, back_leaves):
        if a.dtype == ml_dtypes.bfloat16:
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back["layers"]["moe"]["router"].dtype == np.float32


def test_moe_init_draws_the_reference_laws():
    tcfg = tconfigs.get("granite-moe-1b-a400m").reduced
    model = tt.init(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert sum(p.numel() for p in model.parameters()) == tcfg.param_count()
    moe = model.layers[1].moe
    assert moe["router"].dtype == torch.float32
    E, D, F = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert moe["w_gate"].shape == (E, D, F) and moe["w_down"].shape == (E, F, D)
    z = moe["w_down"] * np.sqrt(F)
    assert z.abs().max() <= 3.0 and 0.9 < float(z.std()) < 1.05


@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_moe_configs_are_the_references(arch):
    port = tconfigs.get(arch)
    for ours, theirs in ((port.full, J_CONFIGS[arch].FULL),
                         (port.reduced, J_CONFIGS[arch].REDUCED)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    if arch == "granite-moe-1b-a400m":
        assert port.full.param_count() == 1_334_628_352
        assert port.full.active_param_count() == 428_658_688


def test_moe_engine_serve_matches_reference(monkeypatch):
    """RAGEngine over granite-moe REDUCED, raw-store and front-door paths,
    against the reference's engine: slots, scores and greedy tokens."""
    import tests.test_torch_serving as ts
    monkeypatch.setattr(ts, "GEN", dataclasses.asdict(j_granite.REDUCED))
    for make in (ts._raw_engines, ts._front_door_engines):
        jeng, teng = make()
        jreqs, treqs = ts._requests(n_tokens=4)
        ts._assert_same(jeng.serve(jreqs), teng.serve(treqs), (0, 1))


# ---------------------------------------------------------------------------
# the forward-only kernels and autograd
# ---------------------------------------------------------------------------

def test_attention_kernels_refuse_grad():
    """The wrappers check grad before the device: a tensor that requires
    grad never reaches a launch (here on CPU tensors, where the device
    check would refuse next)."""
    q = torch.zeros((1, 4, 2, 2, 64), requires_grad=True)
    k = torch.zeros((1, 4, 2, 64))
    with pytest.raises(RuntimeError, match="forward-only"):
        fa_mod.flash_attention_cuda(q, k, k)
    with pytest.raises(RuntimeError, match="forward-only"):
        dec_mod.decode_attention_cuda(q[:, 0], k, k, torch.ones(1, dtype=torch.int32))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        fa_mod.flash_attention_cuda(q, k, k)


def test_training_attention_never_takes_the_kernel_entry(monkeypatch):
    """attention_full with impl "chunked": under autograd it runs the plain
    gqa_chunked (gradients flow to every projection), under no_grad the
    kernel's entry."""
    calls = []
    entry = TL.fa_ops.flash_attention
    monkeypatch.setattr(TL.fa_ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or entry(*a, **kw))
    spec = TL.AttentionSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=gen, requires_grad=True) for k, s in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
          ("wo", (32, 32)))}
    x = torch.randn((2, 16, 32), generator=gen)
    out = TL.attention_full(p, spec, x, impl="chunked")
    out.square().sum().backward()
    assert not calls
    assert all(float(t.grad.abs().sum()) > 0 for t in p.values())
    with torch.no_grad():
        again = TL.attention_full(p, spec, x, impl="chunked")
    assert calls == [1]
    torch.testing.assert_close(again, out.detach(), rtol=1e-5, atol=1e-5)


def test_moe_shmap_without_a_mesh_is_the_scatter_path():
    p = _moe_params("float32")
    x = np.random.default_rng(2).standard_normal((2, 16, SPEC["d_model"])
                                                 ).astype(np.float32)
    tp = {k: tt._tensor_of(v) for k, v in p.items()}
    a, _ = tm.moe_apply(tp, tm.MoESpec(**SPEC, impl="scatter_shmap"),
                        torch.from_numpy(x))
    b, _ = tm.moe_apply_scatter(tp, tm.MoESpec(**SPEC), torch.from_numpy(x))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dp", [2, 4])
def test_moe_shmap_under_a_mesh_matches_reference(dp):
    """Under a mesh the groups split over the data shards: y is the
    reference's scatter dispatch chunk by chunk and aux the mean of the
    chunks' aux (the reference's shard_map body and its pmean; the
    reference's shard_map itself is held in test_torch_sharding.py)."""
    p = _moe_params("float32")
    x = np.random.default_rng(2).standard_normal((4, 16, SPEC["d_model"])
                                                 ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    outs = [jm.moe_apply_scatter(jp, jm.MoESpec(**SPEC), jnp.asarray(c))
            for c in np.split(x, dp)]
    want_y = np.concatenate([np.asarray(y) for y, _ in outs])
    want_aux = float(np.mean([float(a) for _, a in outs]))
    tp = {k: tt._tensor_of(v) for k, v in p.items()}
    tm.set_moe_mesh(make_host_mesh(dp, 1), ("data",))
    try:
        y, aux = tm.moe_apply(tp, tm.MoESpec(**SPEC, impl="scatter_shmap"),
                              torch.from_numpy(x))
        with pytest.raises(ValueError, match="do not divide"):
            tm.moe_apply_scatter_shmap(tp, tm.MoESpec(**SPEC),
                                       torch.from_numpy(x[:3]))
    finally:
        tm.set_moe_mesh(None, ())
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - want_aux) <= 1e-6
    # the chunks' mean is not the aux of all groups at once
    _, whole = jm.moe_apply_scatter(jp, jm.MoESpec(**SPEC), jnp.asarray(x))
    assert abs(float(whole) - want_aux) > 1e-6


def test_moe_shmap_rejects_a_mesh_of_other_devices():
    p = {k: tt._tensor_of(v) for k, v in _moe_params("float32").items()}
    tm.set_moe_mesh(make_host_mesh(2, 1, device="meta"), ("data",))
    try:
        with pytest.raises(ValueError, match="more than one type"):
            tm.moe_apply_scatter_shmap(p, tm.MoESpec(**SPEC),
                                       torch.zeros((2, 8, SPEC["d_model"])))
    finally:
        tm.set_moe_mesh(None, ())
