"""The port's checkpoints against the reference's (``repro_torch.training.
checkpoint`` vs ``repro.training.checkpoint``) on the CPU.

A train state of a tiny LM -- parameters in f32 or bf16, AdamW moments f32,
the step int32 -- saved by the reference restores in the port bit for bit
(the model's layers unstacked into its modules), and the port's save of the
same state writes the reference's ``$`` paths, shapes, dtypes and bytes
(bf16 as '|V2' with ``bfloat16`` in the manifest). An f32 state saved by
the port restores in the reference. A bf16 one does not: the reference's
``restore`` cannot read a bf16 leaf back, its own or the port's (it hands
the void array to ``jax.device_put``; ROADMAP queue 3's note on the
reference). The atomic rename and keep-k pruning are the reference's.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.models import transformer as tt
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import init_state

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TINY = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=32, vocab_size=64, n_experts=4, top_k=2, moe_group=16)


def _states(dtype: str):
    """The reference's train state after one AdamW step and the port's
    state of the same structure (fresh, as a restore's donor)."""
    cfg = jt.TransformerConfig(**TINY, dtype=dtype)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    jo = jopt.adamw(1e-2)
    step = jloop.make_train_step(lambda p, b: jt.loss_fn(p, cfg, b), jo,
                                 donate=False)
    toks = jnp.asarray(np.random.default_rng(0).integers(0, 64, (2, 16),
                                                         dtype=np.int32))
    jstate, _ = step(jloop.init_state(params, jo),
                     {"tokens": toks, "labels": toks})
    tcfg = tt.TransformerConfig(**TINY, dtype=dtype)
    model = tt.init(tcfg, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    return jstate, init_state(model, adamw(1e-2))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype in (ml_dtypes.bfloat16,
                                            np.dtype("V2")) else a


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:012d}", "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(dtype, tmp_path):
    jstate, donor = _states(dtype)
    jckpt.save(str(tmp_path), 1, jstate)
    got = ckpt.restore(str(tmp_path), 1, donor)
    assert got["step"] == 1 and isinstance(got["step"], int)
    assert isinstance(got["params"], tt.Transformer)
    assert got["params"] is not donor["params"]
    assert all(p.requires_grad for p in got["params"].parameters())
    want = {"$".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    have = {"$".join(map(str, p)): T.stacked(leaf)
            for p, leaf in T.ref_items(got)}
    assert set(have) == set(want)
    for key, w in want.items():
        h = have[key]
        if torch.is_tensor(h):
            assert str(h.dtype).split(".")[-1] == str(np.asarray(w).dtype)
            if h.dtype == torch.bfloat16:
                h = h.detach().view(torch.int16).numpy().view(np.uint16)
            else:
                h = h.detach().numpy()
        assert np.array_equal(_bits(h), _bits(w)), key
    router = got["params"].layers[0].moe["router"]
    assert router.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_is_the_references(dtype, tmp_path):
    """The port saves the restored state again: same manifest (paths in
    the same order, shapes, dtypes) and the same bytes a leaf."""
    jstate, donor = _states(dtype)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(jdir, 3, jstate)
    ckpt.save(tdir, 3, ckpt.restore(jdir, 3, donor))
    assert _manifest(jdir, 3) == _manifest(tdir, 3)
    ja = np.load(os.path.join(jdir, "step_000000000003", "arrays.npz"))
    ta = np.load(os.path.join(tdir, "step_000000000003", "arrays.npz"))
    assert sorted(ja.files) == sorted(ta.files)
    for key in ja.files:
        assert ja[key].dtype == ta[key].dtype, key
        assert ja[key].tobytes() == ta[key].tobytes(), key
    if dtype == "float32":
        back = jckpt.restore(tdir, 3, jstate)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jstate)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        # the reference cannot restore a bf16 leaf, from either package
        for d in (jdir, tdir):
            with pytest.raises(TypeError, match="V2"):
                jckpt.restore(d, 3, jstate)


def test_paths_are_the_references(tmp_path):
    tree = {"b": {"z": torch.zeros(2), "a": torch.ones(3)},
            "a": [torch.zeros(1), torch.ones(1)], "step": 7}
    jtree = {"b": {"z": jnp.zeros(2), "a": jnp.ones(3)},
             "a": [jnp.zeros(1), jnp.ones(1)], "step": jnp.int32(7)}
    ckpt.save(str(tmp_path / "p"), 1, tree)
    jckpt.save(str(tmp_path / "j"), 1, jtree)
    assert _manifest(str(tmp_path / "p"), 1) == _manifest(str(tmp_path / "j"), 1)
    assert _manifest(str(tmp_path / "p"), 1)["paths"] == \
        ["a$0", "a$1", "b$a", "b$z", "step"]
    back = ckpt.restore(str(tmp_path / "j"), 1, tree)
    assert back["step"] == 7 and torch.equal(back["b"]["a"], torch.ones(3))
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path / "p"), 1, {"a": torch.zeros(1)})


def test_atomic_rename_and_keep_k(tmp_path, monkeypatch):
    """A save that dies before its rename leaves only ``.tmp_<step>``,
    which no step listing sees; keep-k prunes the oldest."""
    root = str(tmp_path)
    tree = {"x": torch.arange(4.0)}
    for s in (1, 2, 3):
        ckpt.save(root, s, tree, keep=2)
    assert ckpt.all_steps(root) == [2, 3]
    monkeypatch.setattr(os, "rename", lambda *a: (_ for _ in ()).throw(
        OSError("crash before the rename")))
    with pytest.raises(OSError):
        ckpt.save(root, 4, {"x": torch.arange(4.0) + 1}, keep=2)
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(root, ".tmp_4"))
    assert ckpt.all_steps(root) == [2, 3] and ckpt.latest_step(root) == 3
    assert jckpt.all_steps(root) == [2, 3]
    ckpt.save(root, 4, {"x": torch.arange(4.0) + 1}, keep=2)
    assert ckpt.all_steps(root) == [3, 4] and not os.path.exists(
        os.path.join(root, ".tmp_4"))
    assert torch.equal(ckpt.restore(root, 4, tree)["x"], torch.arange(4.0) + 1)


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The writer thread serialises a host copy made when save() was
    called: a later in-place update of the parameters does not reach it."""
    x = torch.zeros(1024)
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=5)
    for s in range(1, 4):
        ac.save(s, {"x": x})
        x.add_(1.0)
    ac.close()
    for s in range(1, 4):
        got = ckpt.restore(str(tmp_path), s, {"x": x})["x"]
        assert float(got[0]) == s - 1 and float(got[-1]) == s - 1
