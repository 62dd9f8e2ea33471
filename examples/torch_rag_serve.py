"""End-to-end RAG serving on the PyTorch / CUDA port (the paper's kind of
system is a serving stack, so this is the primary end-to-end example): a
small LM answers batched requests grounded in a multi-tenant corpus through
the unified data layer -- retrieval, prefill, decode, with per-request
provenance. The port's twin of ``examples/rag_serve.py``: the same corpus,
generator (gen-25m: 4 layers, d_model 256, 8 heads over 4 KV heads, so
head_dim 32 and G 2, f32) and flags. On the card retrieval runs the arena
scan kernel and every decode step the decode-attention kernel; the
prefill stays naive, as in the reference.

  PYTHONPATH=src python examples/torch_rag_serve.py [--requests 8] [--tokens 12]
  PYTHONPATH=src python examples/torch_rag_serve.py --device cpu

Weights are drawn from a seeded generator on the serving device; `main`
takes a numpy parameter tree of the reference's layout instead
(``params=``, carried across by `models.transformer.from_numpy`) and
returns what it prints as a dict.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import RagDB
from repro_torch.core import Principal, StoreConfig
from repro_torch.core.store import resolve_device
from repro_torch.data.corpus import DAY_S, CorpusConfig, make_corpus
from repro_torch.models.transformer import TransformerConfig, from_numpy, init
from repro_torch.serving.engine import RAGEngine, Request

#: the reference example's generator (``examples/rag_serve.py``)
GEN_25M = TransformerConfig(name="gen-25m", n_layers=4, d_model=256,
                            n_heads=8, n_kv_heads=4, d_ff=688,
                            vocab_size=2048, dtype="float32",
                            attn_impl="naive")


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--docs", type=int, default=10_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # retrieval: the scan kernel on the card, its plain engine on the CPU
    engine_kind = "cuda" if dev.type == "cuda" else "ref"

    rng = np.random.default_rng(0)
    ccfg = CorpusConfig(n_docs=args.docs, dim=48, n_tenants=6, n_categories=5)
    scfg = StoreConfig(capacity=1 << 14, dim=48)
    db = RagDB(scfg, device=dev)
    corpus = make_corpus(ccfg, device=dev)
    db.ingest(corpus)

    # a small generator (the paper's contribution is the data layer; the LM
    # just has to be a real decoder with a KV cache)
    cfg = GEN_25M
    if params is None:
        model = init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    else:
        model = from_numpy(params, cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"generator: {n_params/1e6:.1f}M params; corpus: {args.docs} docs, "
          f"{ccfg.n_tenants} tenants")

    # the engine holds the front door, not a raw snapshot: requests lower to
    # session plans and the batch runs predicate-group batched
    engine = RAGEngine(db, cfg, model, k=4, max_prompt=48,
                       max_len=48 + args.tokens + 2, engine=engine_kind,
                       device=dev)

    reqs = []
    for _ in range(args.requests):
        t = int(rng.integers(0, ccfg.n_tenants))
        reqs.append(Request(
            principal=Principal(tenant_id=t, group_bits=0xFFFFFFFF),
            query_emb=rng.standard_normal(ccfg.dim).astype(np.float32),
            prompt_tokens=rng.integers(1, 2048, 6).astype(np.int32),
            min_ts=ccfg.now_ts - 120 * DAY_S,
            max_new_tokens=args.tokens))

    t0 = time.perf_counter()
    resps = engine.serve(reqs)
    dt = time.perf_counter() - t0
    tenant_of = corpus.tenant.cpu().numpy()
    print(f"\nserved {len(reqs)} requests in {dt:.2f}s "
          f"({len(reqs)*args.tokens/dt:.1f} tok/s aggregate); retrieval used "
          f"{engine.last_retrieval_device_calls} device calls for "
          f"{len(reqs)} requests (predicate-group batching)")
    out = []
    for i, r in enumerate(resps):
        got = r.doc_slots[r.doc_slots >= 0]
        if i < 4:
            print(f"req{i} tenant={reqs[i].principal.tenant_id} "
                  f"docs={got.tolist()} (tenants {tenant_of[got].tolist()}) "
                  f"retrieval {r.retrieval_ms:.1f}ms prefill "
                  f"{r.prefill_ms:.0f}ms decode {r.decode_ms:.0f}ms -> "
                  f"tokens {r.tokens.tolist()}")
        assert (tenant_of[got] == reqs[i].principal.tenant_id).all()
        out.append({"tenant": reqs[i].principal.tenant_id,
                    "docs": r.doc_slots.tolist(), "tokens": r.tokens.tolist()})
    print("\nprovenance check: every retrieved doc belongs to its caller's "
          "tenant (engine-level RLS)")
    return {"device": str(dev), "engine": engine_kind, "params": n_params,
            "served": len(resps), "tokens": args.tokens, "seconds": dt,
            "tok_s": len(reqs) * args.tokens / dt,
            "device_calls": engine.last_retrieval_device_calls,
            "responses": out}


if __name__ == "__main__":
    main()
