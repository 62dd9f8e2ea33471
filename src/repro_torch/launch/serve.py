"""Serving launcher (port of ``repro/launch/serve.py``): unified data
layer + generator behind a batched request loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b
                                                       # REDUCED, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --docs 20000 --requests 16 --device cpu          # REDUCED, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --no-reduced --engine cuda   # FULL, card

``--reduced`` is on by default, as the reference's; ``--no-reduced`` serves
the FULL config (the reference's flag cannot be switched off). Either runs
on the card: the attention kernels take every head_dim of the registry,
the REDUCED configs' 16 and 32 included, and every decode step runs the
decode kernel (the short prompts' prefill is naive, as in the reference).
``--engine`` is the retrieval engine, "ref" (plain) or "cuda" (the scan
kernel). Weights are drawn from a seeded generator on the serving device
(the card unless ``--device`` names another).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4, help="requests per serving batch")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--engine", default="ref", choices=["ref", "cuda"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get
    from repro_torch.core import Principal, StoreConfig, TransactionLog
    from repro_torch.core.store import resolve_device
    from repro_torch.data.corpus import DAY_S, CorpusConfig, make_corpus
    from repro_torch.models.transformer import init
    from repro_torch.serving.engine import RAGEngine, Request

    arch = get(args.arch)
    cfg = arch.reduced if args.reduced else arch.full
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    ccfg = CorpusConfig(n_docs=args.docs, dim=args.dim, n_tenants=8)
    scfg = StoreConfig(capacity=1 << (int(np.ceil(np.log2(args.docs))) + 1),
                       dim=args.dim)
    log = TransactionLog(scfg, device=dev)
    log.ingest(make_corpus(ccfg, device=dev))
    model = init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)
    engine = RAGEngine(log.snapshot(), cfg, model, k=4, max_prompt=32,
                       max_len=32 + args.tokens + 2, engine=args.engine,
                       device=dev)

    lat = []
    served = 0
    while served < args.requests:
        n = min(args.batch, args.requests - served)
        reqs = [Request(
            principal=Principal(tenant_id=int(rng.integers(0, 8)),
                                group_bits=0xFFFFFFFF),
            query_emb=rng.standard_normal(args.dim).astype(np.float32),
            prompt_tokens=rng.integers(1, cfg.vocab_size, 5).astype(np.int32),
            min_ts=ccfg.now_ts - 120 * DAY_S, max_new_tokens=args.tokens)
            for _ in range(n)]
        t0 = time.perf_counter()
        engine.serve(reqs)
        lat.append((time.perf_counter() - t0) / n)
        served += n
    lat_ms = np.asarray(lat) * 1e3
    print(f"served {served} requests, per-request p50 {np.percentile(lat_ms, 50):.1f} ms "
          f"p95 {np.percentile(lat_ms, 95):.1f} ms "
          f"({served * args.tokens / sum(lat) / args.batch:.1f} tok/s/req)")
    return served


if __name__ == "__main__":
    main()
