"""Parity of the port's decoder (``repro_torch.models``) with the
reference's (``repro.models``) on the CPU.

The layers get the same numpy inputs; the three REDUCED dense configs
(qwen3-4b: qk-norm, GQA; yi-6b: GQA; qwen1.5-0.5b: QKV bias, tied
embeddings) get the reference's own ``init(PRNGKey(0))`` carried across by
`from_numpy`, then `prefill` and 4 greedy `decode_step`s run on both sides
with ``attn_impl`` "naive" and "chunked" (the flash kernel's plain
version): logits within rtol = atol = 1e-4 (naive) or 1e-2 / 8e-3 (bf16
P . V in chunked), the KV cache within 1e-4, the greedy tokens equal.
`to_numpy(from_numpy(tree))` must give the tree back bit for bit.

The bf16 path -- the one served on the card -- is held to the reference
too: the three REDUCED configs cast to bf16 with the reference's weights,
B 3, S 24, 16 decode steps each fed the reference's token, logits within
3% of the largest logit (the reference's own bf16-against-f32 noise on
these configs is 1.7-2.1%; the port's decode is all f32 where the
reference casts P to bf16). A decode past the cache's end is refused with
a ValueError (the reference clamps the write onto the last row).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import qwen1_5_0_5b as j_qwen15
from repro.configs import qwen3_4b as j_qwen3
from repro.configs import yi_6b as j_yi
from repro.models import layers as JL
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-4
J_CONFIGS = {"qwen3-4b": j_qwen3, "yi-6b": j_yi, "qwen1.5-0.5b": j_qwen15}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(cfg) -> tt.TransformerConfig:
    return tt.TransformerConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(_t(x), _t(scale), 1e-6).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=1e-5, atol=1e-5)
    pos = rng.integers(0, 3000, (2, 5), dtype=np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            TL.apply_rope(_t(x), _t(pos), theta).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            rtol=1e-4, atol=1e-4)
    bias = rng.standard_normal(32, dtype=np.float32)
    np.testing.assert_allclose(
        TL.layernorm(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qk_norm,qkv_bias", [(True, False), (False, True)])
def test_project_qkv_matches_reference(qk_norm, qkv_bias):
    spec_kw = dict(d_model=48, n_heads=4, n_kv_heads=2, head_dim=16,
                   qk_norm=qk_norm, qkv_bias=qkv_bias, rope_theta=1e6)
    jspec, tspec = JL.AttentionSpec(**spec_kw), TL.AttentionSpec(**spec_kw)
    p = jax.tree.map(np.asarray, JL.attention_init(jax.random.PRNGKey(3),
                                                   jspec, jnp.float32))
    rng = np.random.default_rng(1)
    if qkv_bias:     # nonzero biases, so that they are exercised
        for key in ("bq", "bk", "bv"):
            p[key] = rng.standard_normal(p[key].shape, dtype=np.float32)
    x = rng.standard_normal((2, 7, 48), dtype=np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jout = JL._project_qkv(jax.tree.map(jnp.asarray, p), jspec,
                           jnp.asarray(x), jnp.asarray(pos))
    tout = TL._project_qkv({k: _t(v) for k, v in p.items()}, tspec, _t(x),
                           _t(pos))
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_cores_match_reference(causal):
    B, S, KV, G, hd = 2, 64, 2, 4, 32
    H = KV * G
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    mask = (np.tril(np.ones((S, S), bool))[None, None, None] if causal
            else np.ones((1, 1, 1, S, S), bool))
    want = np.asarray(JL.gqa_scores_softmax_out(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        H, KV))
    got = TL.gqa_scores_softmax_out(_t(q), _t(k), _t(v), _t(mask), H, KV)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want_c = np.asarray(JL.gqa_chunked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), H, KV, causal=causal,
                                       blk_q=16, blk_k=16))
    got_c = TL.gqa_chunked(_t(q), _t(k), _t(v), H, KV, causal=causal,
                           blk_q=16, blk_k=16)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-2, atol=8e-3)
    np.testing.assert_allclose(got_c.numpy(), want, rtol=1e-2, atol=8e-3)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_full_matches_reference(impl):
    spec_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                   qk_norm=True)
    jspec, tspec = JL.AttentionSpec(**spec_kw), TL.AttentionSpec(**spec_kw)
    p = jax.tree.map(np.asarray, JL.attention_init(jax.random.PRNGKey(4),
                                                   jspec, jnp.float32))
    x = np.random.default_rng(3).standard_normal((2, 16, 32),
                                                  dtype=np.float32)
    want = JL.attention_full(jax.tree.map(jnp.asarray, p), jspec,
                             jnp.asarray(x), impl=impl)
    got = TL.attention_full({k: _t(v) for k, v in p.items()}, tspec, _t(x),
                            impl=impl)
    tol = (1e-5, 1e-5) if impl == "naive" else (1e-2, 8e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol[0],
                               atol=tol[1])
    # prefill without a cache to write into returns the reference's padded one
    jout, (jk, jv) = JL.attention_prefill(jax.tree.map(jnp.asarray, p), jspec,
                                          jnp.asarray(x), 20, impl=impl)
    tout, (tk, tv) = TL.attention_prefill({k: _t(v) for k, v in p.items()},
                                          tspec, _t(x), 20, impl=impl)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=tol[0],
                               atol=tol[1])
    for a, b in ((jk, tk), (jv, tv)):
        assert b.shape == (2, 20, 2, 8)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the model on the REDUCED configs
# ---------------------------------------------------------------------------

def _models(arch: str, impl: str):
    cfg = dataclasses.replace(J_CONFIGS[arch].REDUCED, attn_impl=impl)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = _port_cfg(cfg)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_prefill_and_decode_match_reference(arch, impl):
    cfg, params, tcfg, model = _models(arch, impl)
    rtol, atol = (TOL, TOL) if impl == "naive" else (1e-2, 8e-3)
    B, S, L = 3, 24, 32
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jl, jc = jt.prefill(params, cfg, jnp.asarray(toks), L)
    tl, tc = tt.prefill(model, tcfg, _t(toks), L)
    assert tl.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                               atol=atol)
    for key in ("k", "v"):
        assert tc[key].shape == (cfg.n_layers, B, L, cfg.n_kv_heads, cfg.hd)
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=TOL, atol=TOL)
    jcur = jnp.argmax(jl, -1).astype(jnp.int32)
    tcur = torch.argmax(tl, -1).to(torch.int32)
    for t in range(4):
        assert (tcur.numpy() == np.asarray(jcur)).all(), f"token {t} differs"
        jl, jc = jt.decode_step(params, cfg, jcur, jc, jnp.int32(S + t))
        tl, tc2 = tt.decode_step(model, tcfg, tcur, tc, S + t)
        assert tc2["k"] is tc["k"], "decode_step must update the cache in place"
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                                   atol=atol)
        jcur = jnp.argmax(jl, -1).astype(jnp.int32)
        tcur = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_numpy_round_trip_is_bit_exact(arch, dtype):
    cfg = dataclasses.replace(J_CONFIGS[arch].REDUCED, dtype=dtype)
    tree = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(1), cfg))
    back = tt.to_numpy(tt.from_numpy(tree, _port_cfg(cfg), device="cpu"))
    leaves, treedef = jax.tree.flatten(tree)
    back_leaves, back_def = jax.tree.flatten(back)
    assert treedef == back_def
    for a, b in zip(leaves, back_leaves):
        if a.dtype == ml_dtypes.bfloat16:
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_from_numpy_refuses_a_wrong_shape():
    cfg = j_qwen3.REDUCED
    tree = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(0), cfg))
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        tt.from_numpy(tree, _port_cfg(cfg), device="cpu")


def test_init_draws_the_reference_laws():
    cfg = tt.TransformerConfig(name="t", n_layers=2, d_model=256, n_heads=4,
                               n_kv_heads=2, d_ff=512, vocab_size=1024,
                               qk_norm=True, qkv_bias=True, dtype="float32")
    model = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    w = model.layers[0].ffn["w_gate"]
    assert w.shape == (256, 512)
    z = w * np.sqrt(256)
    assert z.abs().max() <= 3.0 and 0.97 < float(z.std()) < 1.0   # 0.9866 at +-3
    assert abs(float(model.embed.std()) - 0.02) < 1e-3
    assert (model.layers[1].attn["q_norm"] == 1).all()
    assert (model.layers[1].attn["bk"] == 0).all()
    assert (model.final_norm == 1).all()
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    again = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert torch.equal(again.lm_head, model.lm_head)


@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_configs_are_the_references(arch):
    port = tconfigs.get(arch)
    for ours, theirs in ((port.full, J_CONFIGS[arch].FULL),
                         (port.reduced, J_CONFIGS[arch].REDUCED)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.hd == theirs.hd
    if arch == "qwen3-4b":
        assert port.full.param_count() == 4_411_424_256


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(j_qwen3.REDUCED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.make_cache(cfg, 1, 8)


def test_moe_shmap_prefill_under_a_mesh_matches_reference():
    """An MoE model with moe_impl "scatter_shmap" under a (2, 1) mesh: its
    prefill splits the 4 groups over the 2 data shards and gives the
    reference's prefill logits (a group's dispatch does not depend on the
    other groups; aux, which does, is held in test_torch_moe.py); groups
    that the shards do not divide raise, as shard_map does."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as tm
    kw = dict(name="moe", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab_size=64, n_experts=4, top_k=2, dtype="float32",
              moe_group=4, moe_impl="scatter_shmap")
    cfg = jt.TransformerConfig(**kw)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = tt.TransformerConfig(**kw)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, 64, (2, 8), dtype=np.int32)
    want, _ = jt.prefill(params, cfg, jnp.asarray(toks), 12)
    tm.set_moe_mesh(make_host_mesh(2, 1), ("data",))
    try:
        got, _ = tt.prefill(model, tcfg, torch.from_numpy(toks), 12)
        with pytest.raises(ValueError, match="do not divide"):
            tt.prefill(model, tcfg, torch.from_numpy(toks[:1, :4]), 12)
    finally:
        tm.set_moe_mesh(None, ())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# the bf16 LM path against the reference: logits, not greedy tokens
BF16_LOGIT_REL = 0.03


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", sorted(J_CONFIGS))
def test_bf16_path_logits_match_reference(arch, impl):
    cfg = dataclasses.replace(J_CONFIGS[arch].REDUCED, dtype="bfloat16",
                              attn_impl=impl)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    tcfg = _port_cfg(cfg)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                          device="cpu")
    B, S, L = 3, 24, 40
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jl, jc = jt.prefill(params, cfg, jnp.asarray(toks), L)
    tl, tc = tt.prefill(model, tcfg, _t(toks), L)

    def close(j, t, what):
        want = np.asarray(j.astype(jnp.float32))
        got = t.float().numpy()
        assert np.isfinite(got).all(), what
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= BF16_LOGIT_REL, f"{what}: {rel:.4f} of the largest logit"

    close(jl, tl, "prefill")
    cur = jnp.argmax(jl, -1).astype(jnp.int32)
    for t in range(16):
        jl, jc = jt.decode_step(params, cfg, cur, jc, jnp.int32(S + t))
        tl, tc = tt.decode_step(model, tcfg, _t(cur), tc, S + t)
        close(jl, tl, f"decode step {t}")
        cur = jnp.argmax(jl, -1).astype(jnp.int32)   # the reference's token


def test_decode_past_the_cache_raises():
    """qwen3-4b REDUCED, max_len 8: decode_step at cur_index 8 would write
    past the cache; the port refuses, naming both (the reference clamps the
    write onto row 7 and returns logits from a corrupted cache)."""
    tcfg = tconfigs.get("qwen3-4b").reduced
    model = tt.init(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    logits, cache = tt.prefill(model, tcfg, toks, 8)
    cur = logits.argmax(-1).to(torch.int32)
    before = cache["k"].clone()
    with pytest.raises(ValueError, match="cur_index 8.*max_len 8"):
        tt.decode_step(model, tcfg, cur, cache, 8)
    assert torch.equal(cache["k"], before), "a refused step wrote the cache"
    logits, _ = tt.decode_step(model, tcfg, cur, cache, 7)   # the last row
    assert torch.isfinite(logits).all()
    spec = tcfg.attn_spec()
    x = torch.zeros((2, 1, tcfg.d_model))
    with pytest.raises(ValueError, match="max_len 8"):
        TL.attention_decode(model.layers[0].attn, spec, x, cache["k"][0],
                            cache["v"][0], 8)


def test_decode_lengths_built_once_a_step(monkeypatch):
    """decode_step hands every layer the same lengths tensor; a layer
    given none builds the same values."""
    tcfg = tconfigs.get("qwen3-4b").reduced
    model = tt.init(tcfg, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    toks = torch.zeros((2, 5), dtype=torch.int32)
    logits, cache = tt.prefill(model, tcfg, toks, 12)
    seen = []
    entry = TL.dec_ops.decode_attention

    def spy(q, k, v, lengths, n_kv, **kw):
        seen.append(lengths)
        return entry(q, k, v, lengths, n_kv, **kw)

    monkeypatch.setattr(TL.dec_ops, "decode_attention", spy)
    cur = logits.argmax(-1).to(torch.int32)
    want, _ = tt.decode_step(model, tcfg, cur, cache, 5)
    assert len(seen) == tcfg.n_layers
    assert all(t is seen[0] for t in seen)
    assert seen[0].dtype == torch.int32 and (seen[0] == 6).all()
    layer = model.layers[0]
    x = torch.randn((2, 1, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    a, _ = TL.attention_decode(layer.attn, tcfg.attn_spec(), x,
                               cache["k"][0], cache["v"][0], 6)
    b, _ = TL.attention_decode(layer.attn, tcfg.attn_spec(), x,
                               cache["k"][0], cache["v"][0], 6,
                               torch.full((2,), 7, dtype=torch.int32))
    assert torch.equal(a, b)
