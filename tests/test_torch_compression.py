"""Parity of the port's gradient compression
(``repro_torch.distributed.compression``) with the reference's on the CPU.

* `ef_init` / `ef_compress` bit for bit against the reference's over 5
  rounds on a tree with a layer list (stacked in the reference), an f32
  matrix, a bf16 matrix, a vector and an all-zero leaf; and on a REDUCED
  granite model's gradient tree (the layers stacked);
* the twin of ``tests/test_training.py::test_ef_compression_error_feedback``
  (50 rounds accumulate within 1% of 50 g);
* one subprocess with 4 fake XLA devices runs the reference's `psum_int8`
  and `psum_bf16` in a shard_map over 4 shards: the port's `psum_int8`
  over the same 4 tensors equals it bit for bit, `psum_bf16` within 2e-2
  of the largest sum (XLA's all-reduce order is its own), and both stay
  within the reference test's bounds of the exact sum.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import compression as jc
from repro.models import transformer as jt
from repro_torch.distributed import compression as tc
from repro_torch.models import transformer as tt
from repro_torch.training import tree as T

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _trees(rng):
    lay = rng.standard_normal((2, 3, 5)).astype(np.float32)
    j = {"w": rng.standard_normal((4, 6)).astype(np.float32) * 3,
         "bf": rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16),
         "vec": rng.standard_normal(7).astype(np.float32) * 1e-3,
         "zero": np.zeros((3, 3), np.float32),
         "layers": {"m": lay}}
    t = {"w": _t(j["w"]), "bf": _t(j["bf"]), "vec": _t(j["vec"]),
         "zero": _t(j["zero"]),
         "layers": [{"m": _t(lay[i])} for i in range(2)]}
    return j, t


def _flat_j(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in flat}


def _flat_t(tree) -> dict:
    return {"/".join(map(str, p)): _np(T.stacked(v))
            for p, v in T.ref_items(tree)}


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_ef_compress_bit_for_bit():
    rng = np.random.default_rng(0)
    jg, tg = _trees(rng)
    jef, tef = jc.ef_init(jax.tree.map(jnp.asarray, jg)), tc.ef_init(tg)
    assert {k: (v.shape, v.dtype) for k, v in _flat_j(jef).items()} == \
        {k: (v.shape, v.dtype) for k, v in _flat_t(tef).items()}
    for r in range(5):
        jg_r = jax.tree.map(lambda a: jnp.asarray(a) * (1 + r), jg)
        tg_r = T.tree_map(lambda a: a * (1 + r), tg)
        jq, jef = jc.ef_compress(jg_r, jef)
        tq, tef = tc.ef_compress(tg_r, tef)
        for want, got in ((_flat_j(jq), _flat_t(tq)),
                          (_flat_j(jef), _flat_t(tef))):
            assert set(want) == set(got)
            for key in want:
                assert _same(np.asarray(want[key]), got[key]), (r, key)


def test_ef_compress_over_a_model_gradient_tree():
    cfg_kw = dict(name="g", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  d_ff=16, vocab_size=64, n_experts=4, top_k=2,
                  tie_embeddings=True, dtype="float32")
    cfg = jt.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(1), cfg))
    model = tt.from_numpy(params, tt.TransformerConfig(**cfg_kw), device="cpu")
    jq, jef = jc.ef_compress(params, jc.ef_init(params))
    tq, tef = tc.ef_compress(model, tc.ef_init(model))
    want, got = _flat_j(jq), _flat_t(tq)
    assert set(want) == set(got) and "layers/moe/w_up" in got
    for key in want:
        assert _same(want[key], got[key]), key
    assert all(_same(_flat_j(jef)[k], v) for k, v in _flat_t(tef).items())


def test_ef_compression_error_feedback():
    """Twin of test_training.py: accumulated dequantised grads converge to
    the true sum (the EF property)."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))}
    ef = tc.ef_init(g)
    total = torch.zeros((64, 64))
    for _ in range(50):
        q, ef = tc.ef_compress(g, ef)
        total = total + q["w"]
    want = g["w"].numpy() * 50
    err = np.abs(total.numpy() - want).max() / np.abs(want).max()
    assert err < 0.01, f"EF residual not carried: {err}"


def test_psum_matches_reference_shard_map(tmp_path):
    x = (np.random.default_rng(0).standard_normal((4, 256)) *
         np.array([[1.0], [3.0], [0.01], [1.0]])).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    code = f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.distributed.compression import psum_bf16, psum_int8
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((4,), ("d",))
        x = jnp.asarray(np.load({str(tmp_path / "x.npy")!r}))
        out = {{}}
        for name, fn in (("int8", psum_int8), ("bf16", psum_bf16)):
            f = shard_map(lambda v: fn(v, "d"), mesh=mesh, in_specs=P("d"),
                          out_specs=P("d"), check_rep=False)
            out[name] = np.asarray(f(x))[0]
        np.savez({str(tmp_path / "ref.npz")!r}, **out)
        print("PSUM_REF_OK")
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0 and "PSUM_REF_OK" in run.stdout, \
        run.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    shards = [torch.from_numpy(r.copy()) for r in x]
    got8, got16 = tc.psum_int8(shards).numpy(), tc.psum_bf16(shards).numpy()
    assert _same(got8, ref["int8"])
    want = x.sum(0)
    scale = np.abs(want).max()
    assert np.abs(got16 - ref["bf16"]).max() / scale < 2e-2
    assert np.abs(got8 - want).max() / scale < 4e-2
    assert np.abs(got16 - want).max() / scale < 2e-2
    assert got8.dtype == got16.dtype == np.float32
