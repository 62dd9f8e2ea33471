"""Quickstart on the PyTorch / CUDA port: the paper in 80 lines.

Builds a multi-tenant corpus, ingests it into BOTH stacks, then shows the
three failure modes of the split stack and their absence in the unified one:
latency under constraints, the inconsistency window, and tenant leakage.
The port's twin of ``examples/quickstart.py``: the same corpus, sizes and
query, through `repro_torch`'s `RagDB` front door (on the card, its scan
kernel) and its `SplitStackClient`.

  PYTHONPATH=src python examples/torch_quickstart.py                # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # CPU

``--docs`` shrinks the corpus (default 20,000, the reference's). `main`
returns what it prints as a dict.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import RagDB
from repro_torch.core import Principal, StoreConfig
from repro_torch.core.splitstack import SplitStackClient
from repro_torch.core.store import resolve_device
from repro_torch.data.corpus import DAY_S, CorpusConfig, make_corpus, make_queries


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ccfg = CorpusConfig(n_docs=args.docs, dim=64, n_tenants=8, n_categories=5)
    scfg = StoreConfig(capacity=1 << 15, dim=64)
    corpus = make_corpus(ccfg, device=dev)

    print("== ingest into both stacks ==")
    db = RagDB(scfg, device=dev)
    db.ingest(corpus)
    split = SplitStackClient(scfg, filter_bug_rate=1.0, device=dev)  # demo
    split.ingest(corpus)
    snap = db.log.snapshot()
    print(f"unified: {int(snap['n_live'])} docs, "
          f"commit_ts={int(snap['commit_ts'])}")

    print("\n== the unified query: similarity + freshness + category + RLS ==")
    q = make_queries(ccfg, 1, batch=1, device=dev)[0]
    session = db.session(Principal(tenant_id=3, group_bits=0b0011))
    builder = (session.search(q[0].cpu().numpy(), normalize=False)
               .newer_than(ccfg.now_ts - 60 * DAY_S)
               .in_categories([1, 2])
               .limit(5))
    explain = builder.explain()
    print(explain)
    _sync(dev)
    t0 = time.perf_counter()
    res = builder.run()
    _sync(dev)
    t_unified = time.perf_counter() - t0
    slots = res.slots[0]
    tenant_of = corpus.tenant.cpu().numpy()
    got_u = slots[slots >= 0]
    leaked_u = int((tenant_of[got_u] != session.principal.tenant_id).sum())
    print(f"top-5 slots {slots.tolist()}  tenants {tenant_of[got_u].tolist()} "
          f" ({t_unified*1e3:.1f} ms, one device program)")

    print("\n== the same query on the split stack ==")
    pred = builder.lower().predicate()      # identical clause set, old entrance
    t0 = time.perf_counter()
    _, slots_a = split.query(q, pred, k=5)
    t_split = time.perf_counter() - t0
    got = slots_a[0][slots_a[0] >= 0]
    leaked = int((tenant_of[got] != session.principal.tenant_id).sum())
    print(f"round trips: {split.stats.round_trips}, retries: "
          f"{split.stats.retries} ({t_split*1e3:.1f} ms)")
    print(f"LEAKED {leaked}/{len(got)} docs from other tenants "
          f"(app-layer tenant filter bug active)")
    print(f"unified leaked {leaked_u} by construction -- the predicate runs "
          "inside the kernel")

    print("\n== freshness: atomic vs two-phase writes ==")
    rng = np.random.default_rng(0)
    new_emb = rng.standard_normal((4, 64), dtype=np.float32)
    db.update([0, 1, 2, 3], torch.from_numpy(new_emb).to(dev),
              [ccfg.now_ts] * 4)
    split.write_gap_s = 0.003
    split.update([0, 1, 2, 3], new_emb, [ccfg.now_ts] * 4)
    window_u = db.log.inconsistency_window_s * 1e3
    window_s = split.stats.inconsistency_windows_s[-1] * 1e3
    print(f"unified inconsistency window: {window_u:.2f} ms "
          f"(embedding+metadata commit in ONE program)")
    print(f"split inconsistency window:   {window_s:.2f} ms "
          f"(reader sees new vector + stale metadata in the gap)")
    return {"device": str(dev), "explain": explain,
            "unified": {"slots": slots.tolist(),
                        "scores": res.scores[0].tolist(),
                        "ms": t_unified * 1e3, "leaked": leaked_u,
                        "window_ms": window_u},
            "split": {"slots": slots_a[0].tolist(), "ms": t_split * 1e3,
                      "round_trips": split.stats.round_trips,
                      "retries": split.stats.retries, "leaked": leaked,
                      "returned": len(got), "window_ms": window_s}}


if __name__ == "__main__":
    main()
