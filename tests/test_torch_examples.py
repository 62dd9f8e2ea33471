"""The port's three examples (``examples/torch_{quickstart,rag_serve,
train_lm}.py``) against the reference's on the CPU, each at a small size.

Each example's `main(["--device", "cpu", ...])` returns what it prints,
and the reference is driven through the same calls as its own example
(``examples/{quickstart,rag_serve,train_lm}.py``) on the same corpus,
config and seed: quickstart's unified top-5 equals the reference `RagDB`'s
(slots exact, scores within 1e-5) with nothing leaked and a zero
inconsistency window; rag_serve's retrieved doc ids and greedy tokens equal
the reference `RAGEngine`'s, the reference's gen-25m weights carried
across by `from_numpy`; train_lm's first 3 losses are within rtol 1e-4 /
atol 1e-5 of the reference `Trainer`'s from the same weights (the same
sums in another order), and a second run resumes from the checkpoint.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.core import Principal as JPrincipal
from repro.core import StoreConfig as JStoreConfig
from repro.data import lm_pipeline as jpipe
from repro.data.corpus import DAY_S
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.data.corpus import make_queries as j_make_queries
from repro.models import transformer as jt
from repro.serving.engine import RAGEngine as JRAGEngine
from repro.serving.engine import Request as JRequest
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cfg(cfg) -> jt.TransformerConfig:
    return jt.TransformerConfig(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size, dtype=cfg.dtype, attn_impl=cfg.attn_impl)


def test_quickstart_matches_reference(capsys):
    n_docs = 2000
    got = _example("torch_quickstart").main(["--device", "cpu", "--docs",
                                             str(n_docs)])
    assert "unified leaked 0" in capsys.readouterr().out
    ccfg = JCorpusConfig(n_docs=n_docs, dim=64, n_tenants=8, n_categories=5)
    db = JRagDB(JStoreConfig(capacity=1 << 15, dim=64))
    corpus = j_make_corpus(ccfg)
    db.ingest(corpus)
    q = j_make_queries(ccfg, 1, batch=1)[0]
    res = (db.session(JPrincipal(tenant_id=3, group_bits=0b0011))
           .search(np.asarray(q)[0], normalize=False)
           .newer_than(ccfg.now_ts - 60 * DAY_S)
           .in_categories([1, 2]).limit(5).run())
    want_slots = np.asarray(res.slots[0])
    assert got["unified"]["slots"] == want_slots.tolist()
    np.testing.assert_allclose(got["unified"]["scores"],
                               np.asarray(res.scores[0]), rtol=1e-5,
                               atol=1e-5)
    tenants = np.asarray(corpus.tenant)[want_slots[want_slots >= 0]]
    assert len(tenants) == 5 and (tenants == 3).all()
    assert got["unified"]["leaked"] == 0
    assert got["unified"]["window_ms"] == 0.0
    assert got["split"]["window_ms"] > 0.0
    assert 0 <= got["split"]["leaked"] <= got["split"]["returned"] <= 5
    assert got["split"]["round_trips"] >= 2


def test_rag_serve_matches_reference():
    """gen-25m at its own width (hd 32, G 2, f32): the same retrieved doc
    ids and greedy tokens for every request."""
    n_docs, n_req, n_tok = 1500, 4, 3
    mod = _example("torch_rag_serve")
    jcfg = _jax_cfg(mod.GEN_25M)
    params = jt.init(jax.random.PRNGKey(0), jcfg)
    got = mod.main(["--device", "cpu", "--docs", str(n_docs), "--requests",
                    str(n_req), "--tokens", str(n_tok)],
                   params=jax.tree.map(np.asarray, params))
    assert got["served"] == n_req and got["engine"] == "ref"
    assert mod.GEN_25M.hd == 32 and mod.GEN_25M.n_heads // \
        mod.GEN_25M.n_kv_heads == 2

    rng = np.random.default_rng(0)
    ccfg = JCorpusConfig(n_docs=n_docs, dim=48, n_tenants=6, n_categories=5)
    db = JRagDB(JStoreConfig(capacity=1 << 14, dim=48))
    db.ingest(j_make_corpus(ccfg))
    engine = JRAGEngine(db, jcfg, params, k=4, max_prompt=48,
                        max_len=48 + n_tok + 2)
    reqs = []
    for _ in range(n_req):
        t = int(rng.integers(0, ccfg.n_tenants))
        reqs.append(JRequest(
            principal=JPrincipal(tenant_id=t, group_bits=0xFFFFFFFF),
            query_emb=rng.standard_normal(ccfg.dim).astype(np.float32),
            prompt_tokens=rng.integers(1, 2048, 6).astype(np.int32),
            min_ts=ccfg.now_ts - 120 * DAY_S, max_new_tokens=n_tok))
    for want, r, mine in zip(engine.serve(reqs), reqs, got["responses"]):
        assert mine["tenant"] == r.principal.tenant_id
        assert mine["docs"] == np.asarray(want.doc_slots).tolist()
        assert mine["tokens"] == np.asarray(want.tokens).tolist()


def test_train_lm_matches_reference_and_resumes(tmp_path):
    batch, seq, steps = 2, 32, 3
    mod = _example("torch_train_lm")
    jcfg = _jax_cfg(mod.LM_10M)
    params = jt.init(jax.random.PRNGKey(0), jcfg)
    ckpt_dir = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--batch", str(batch), "--seq", str(seq),
            "--ckpt", ckpt_dir, "--log-every", "1"]
    got = mod.main([*argv, "--steps", str(steps)],
                   params=jax.tree.map(np.asarray, params))
    assert got["start"] == 0 and [s for s, _ in got["losses"]] == [0, 1, 2]

    opt = jopt.adamw(jopt.cosine_schedule(3e-3, warmup=20, total=steps),
                     weight_decay=0.01)
    step_fn = jloop.make_train_step(lambda p, b: jt.loss_fn(p, jcfg, b), opt,
                                    donate=False)
    trainer = jloop.Trainer(
        jloop.TrainerConfig(total_steps=steps, log_every=1), step_fn,
        jloop.init_state(params, opt),
        jpipe.synthetic_lm_batches(jcfg.vocab_size, batch, seq),
        log_fn=lambda s: None)
    trainer.run()
    want = [h["loss"] for h in trainer.history]
    np.testing.assert_allclose([loss for _, loss in got["losses"]], want,
                               rtol=1e-4, atol=1e-5)
    assert np.isfinite(want).all() and len(want) == steps

    again = mod.main([*argv, "--steps", str(steps + 2)])
    assert again["start"] == steps
    assert [s for s, _ in again["losses"]] == [steps, steps + 1]
    assert all(np.isfinite(loss) for _, loss in again["losses"])


def test_examples_import_only_torch_numpy_and_the_port():
    """No JAX and nothing of the reference package in the port's examples."""
    for name in ("torch_quickstart", "torch_rag_serve", "torch_train_lm"):
        with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
            lines = [ln.split() for ln in f if ln.startswith(("import ",
                                                              "from "))]
        roots = {ln[1].split(".")[0] for ln in lines}
        assert roots <= {"argparse", "os", "tempfile", "time", "numpy",
                         "torch", "repro_torch"}, (name, roots)
