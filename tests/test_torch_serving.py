"""Parity of the port's `RAGEngine` with the reference's on the CPU.

The scenario of ``tests/test_serving.py:24``: a 1,200-doc corpus in 4
tenants, a 2-layer generator, two requests of tenants 0 and 1. Both
engines run it through the raw-store path (a store snapshot and
``run_grouped``) and through the front door (a `RagDB`), with the
reference's parameters carried across by `from_numpy`: the retrieved slots
and the greedy tokens must be equal, scores within 1e-5, and no slot of
another tenant may surface. Sampled decoding draws from the reference's
numpy generator and must give the same tokens. The engine's refusals are
checked too: ``scheduler=`` on a raw store (the reference's ValueError),
a model on another device, no device with no card, and a
batch whose decode would run past the KV cache (refused before
retrieval). Through a `Scheduler` whose queue is too small for the batch,
both engines shed the same requests (served with no retrieved context) and
retrieve the same slots and greedy tokens for the rest.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.core import StoreConfig as JStoreConfig
from repro.core import TransactionLog as JTransactionLog
from repro.core import empty as j_empty
from repro.core.tenancy import Principal as JPrincipal
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.models.transformer import TransformerConfig as JTransformerConfig
from repro.models.transformer import init as j_init
from repro.serving.engine import RAGEngine as JRAGEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch import configs as tconfigs
from repro_torch.api import RagDB
from repro_torch.core.store import StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.core.transactions import TransactionLog
from repro_torch.data.corpus import CorpusConfig, make_corpus
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import RAGEngine, Request
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from tests.test_torch_scheduler import FakeClock

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

CCFG = dict(n_docs=1200, dim=24, n_tenants=4, n_categories=4)
CAP = 2048
GEN = dict(name="gen", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab_size=128, dtype="float32")
ENGINE_KW = dict(k=3, max_prompt=24, max_len=40)


def _models():
    jcfg = JTransformerConfig(**GEN)
    params = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.TransformerConfig(**GEN)
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                          device="cpu")
    return jcfg, params, tcfg, model


def _requests(n_tokens=4, tenants=(0, 1), min_ts=0, categories=None):
    rng = np.random.default_rng(0)
    embs = [rng.standard_normal(CCFG["dim"]).astype(np.float32)
            for _ in tenants]
    prompt = np.asarray([5, 6, 7], np.int32)
    kw = dict(prompt_tokens=prompt, max_new_tokens=n_tokens, min_ts=min_ts,
              categories=categories)
    jreqs = [JRequest(principal=JPrincipal(tenant_id=t, group_bits=0xFFFFFFFF),
                      query_emb=e, **kw) for t, e in zip(tenants, embs)]
    treqs = [Request(principal=Principal(tenant_id=t, group_bits=0xFFFFFFFF),
                     query_emb=e, **kw) for t, e in zip(tenants, embs)]
    return jreqs, treqs


def _raw_engines(**kw):
    jcfg, params, tcfg, model = _models()
    jscfg = JStoreConfig(capacity=CAP, dim=CCFG["dim"])
    jlog = JTransactionLog(jscfg, j_empty(jscfg))
    jlog.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    tlog = TransactionLog(StoreConfig(capacity=CAP, dim=CCFG["dim"]),
                          device="cpu")
    tlog.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
    return (JRAGEngine(jlog.snapshot(), jcfg, params, **ENGINE_KW, **kw),
            RAGEngine(tlog.snapshot(), tcfg, model, **ENGINE_KW, **kw,
                      device="cpu"))


def _front_door_engines(**kw):
    jcfg, params, tcfg, model = _models()
    jdb = JRagDB(JStoreConfig(capacity=CAP, dim=CCFG["dim"]))
    jdb.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    tdb = RagDB(StoreConfig(capacity=CAP, dim=CCFG["dim"]), device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
    return (JRAGEngine(jdb, jcfg, params, **ENGINE_KW, **kw),
            RAGEngine(tdb, tcfg, model, **ENGINE_KW, **kw, device="cpu"))


def _assert_same(jresps, tresps, tenants):
    tenant_of = make_corpus(CorpusConfig(**CCFG), device="cpu").tenant.numpy()
    assert len(jresps) == len(tresps)
    for t, j, r in zip(tenants, jresps, tresps):
        assert (r.doc_slots == np.asarray(j.doc_slots)).all()
        np.testing.assert_allclose(r.doc_scores, np.asarray(j.doc_scores),
                                   rtol=1e-5, atol=1e-5)
        assert (r.tokens == np.asarray(j.tokens)).all()
        assert (r.doc_tiers == 0).all()
        got = r.doc_slots[r.doc_slots >= 0]
        assert len(got) > 0, "retrieval returned nothing"
        assert (tenant_of[got] == t).all(), "provenance crossed tenants"
        assert r.prefill_ms >= 0 and r.decode_ms >= 0


@pytest.mark.parametrize("path", ["raw_store", "front_door"])
def test_engine_matches_reference(path):
    build = _raw_engines if path == "raw_store" else _front_door_engines
    jeng, teng = build()
    jreqs, treqs = _requests()
    _assert_same(jeng.serve(jreqs), teng.serve(treqs), (0, 1))
    assert (teng.last_retrieval_device_calls
            == jeng.last_retrieval_device_calls)
    again = teng.serve(treqs)          # greedy decoding is deterministic
    assert all((a.tokens == b.tokens).all()
               for a, b in zip(again, teng.serve(treqs)))


@pytest.mark.parametrize("path", ["raw_store", "front_door"])
def test_engine_predicates_match_reference(path):
    """Recency and category clauses, four tenants, longer generation."""
    build = _raw_engines if path == "raw_store" else _front_door_engines
    jeng, teng = build()
    now = JCorpusConfig(**CCFG).now_ts
    jreqs, treqs = _requests(n_tokens=6, tenants=(0, 1, 2, 3),
                             min_ts=now - 200 * 86_400, categories=[1, 2])
    _assert_same(jeng.serve(jreqs), teng.serve(treqs), (0, 1, 2, 3))


def test_scheduled_engine_matches_reference():
    """RAGEngine(scheduler=) on both packages, each scheduler on its own
    fake clock: a queue of 3 sheds the fourth request of the batch, which
    serves with no retrieved context (slots -1, scores -inf); the others
    retrieve what the unscheduled engine does, and the greedy tokens of
    all four are the reference's."""
    jcfg, params, tcfg, model = _models()
    jdb = JRagDB(JStoreConfig(capacity=CAP, dim=CCFG["dim"]))
    jdb.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    tdb = RagDB(StoreConfig(capacity=CAP, dim=CCFG["dim"]), device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
    kw = dict(max_queue=3, max_batch=2, use_cache=False, slo_ms=1e9)
    jeng = JRAGEngine(jdb, jcfg, params, **ENGINE_KW,
                      scheduler=JScheduler(jdb, JSchedulerConfig(**kw),
                                           clock=FakeClock()))
    teng = RAGEngine(tdb, tcfg, model, **ENGINE_KW, device="cpu",
                     scheduler=Scheduler(tdb, SchedulerConfig(**kw),
                                         clock=FakeClock()))
    jreqs, treqs = _requests(n_tokens=3, tenants=(0, 1, 2, 3))
    jresps, tresps = jeng.serve(jreqs), teng.serve(treqs)
    assert teng.last_shed_requests == jeng.last_shed_requests == 1
    shed = tresps[3]
    assert (shed.doc_slots == -1).all() and np.isneginf(shed.doc_scores).all()
    _assert_same(jresps[:3], tresps[:3], (0, 1, 2))
    assert (shed.tokens == np.asarray(jresps[3].tokens)).all()
    assert (np.asarray(jresps[3].doc_slots) == -1).all()
    assert (teng.last_retrieval_device_calls
            == jeng.last_retrieval_device_calls)
    # unscheduled, the same three requests retrieve the same slots
    plain = RAGEngine(tdb, tcfg, model, **ENGINE_KW, device="cpu")
    for a, b in zip(plain.serve(treqs[:3]), tresps[:3]):
        assert (a.doc_slots == b.doc_slots).all()


def test_sampled_decoding_matches_reference():
    jeng, teng = _raw_engines()
    jreqs, treqs = _requests(n_tokens=5)
    j = jeng.serve(jreqs, greedy=False, seed=7)
    t = teng.serve(treqs, greedy=False, seed=7)
    for a, b in zip(j, t):
        assert (b.tokens == np.asarray(a.tokens)).all()


def test_long_prompt_takes_the_flash_path(monkeypatch):
    """At a prompt of 2048 tokens "auto" prefill runs the flash kernel's
    entry (here, on CPU tensors, its plain version) once per layer; shorter
    prompts take the naive path."""
    calls = []
    plain = fa_mod.flash_attention_plain
    monkeypatch.setattr(fa_mod, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    _, _, tcfg, model = _models()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 128, (1, 2048), dtype=np.int32))
    logits, cache = tt.prefill(model, tcfg, toks, 2050)
    assert len(calls) == tcfg.n_layers
    assert torch.isfinite(logits).all() and cache["k"].shape[2] == 2050
    tt.prefill(model, tcfg, toks[:, :2047], 2050)
    assert len(calls) == tcfg.n_layers


def test_engine_refusals(monkeypatch):
    _, _, tcfg, model = _models()
    tlog = TransactionLog(StoreConfig(capacity=64, dim=CCFG["dim"]),
                          device="cpu")
    snap = tlog.snapshot()
    with pytest.raises(ValueError, match="front-door"):
        RAGEngine(snap, tcfg, model, scheduler=object(), device="cpu")
    moe = dataclasses.replace(tcfg, n_experts=4, top_k=2)     # served now
    moe_model = tt.init(moe, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert RAGEngine(snap, moe, moe_model, device="cpu").model is moe_model
    with pytest.raises(ValueError, match="engine"):
        RAGEngine(snap, tcfg, model, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="the model lives on"):
        RAGEngine(snap, tcfg, model, device="meta")
    eng = RAGEngine(snap, tcfg, model, device="cpu")
    _, treqs = _requests()
    treqs[0].match_terms = [3, 4]
    with pytest.raises(ValueError, match="front-door"):
        eng.serve(treqs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAGEngine(snap, tcfg, model)


def test_serve_refuses_a_batch_past_the_cache():
    """qwen3-4b REDUCED, max_len 8, max_prompt 6: 4 new tokens would
    decode at cur_index 8; serve raises before any retrieval runs (the
    reference clamps the cache writes and returns corrupted tokens)."""
    tcfg = tconfigs.get("qwen3-4b").reduced
    model = tt.init(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    tdb = RagDB(StoreConfig(capacity=CAP, dim=CCFG["dim"]), device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
    eng = RAGEngine(tdb, tcfg, model, k=2, max_prompt=6, max_len=8,
                    device="cpu")
    _, treqs = _requests(n_tokens=4)
    calls = tdb.stats.device_calls
    with pytest.raises(ValueError, match="max_len 8"):
        eng.serve(treqs)
    assert tdb.stats.device_calls == calls, "retrieval ran before refusing"
    _, treqs = _requests(n_tokens=2)          # 6 + 2 = 8 fits exactly
    resps = eng.serve(treqs)
    assert all(r.tokens.shape == (2,) for r in resps)
