#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # one NVIDIA card; exits 0 only if all pass

Phases:
  0. build   -- compile ``csrc/arena_scan.cu`` with nvcc (ptxas report).
  1. kernel  -- the arena-scan kernel against its plain PyTorch version on
                the card over a grid of N, D, B, G and k (k > N included),
                plus category 31 / high ACL bits, a BLOCK_ALL group,
                duplicate embeddings and an all-dead arena. Scores agree
                within rtol = atol = 1e-5 (unit-norm data; the two reduce
                in different orders), slots agree except inside a run of
                tied scores at the k-th place, ties go to the lower slot,
                and no returned slot fails its group's predicate (checked
                against a numpy mask computed on the host).
  2. bench   -- the paper's benchmark deployment (StoreConfig 65,536 x 128,
                50,000 docs, 20 tenants, 5 categories; repro's
                configs/rag_unified.py BENCH / BENCH_CORPUS) through the
                front door: one batch of 32 requests in 4 predicate groups,
                every row held to `unified_query_ref` on the card; then an
                update and a delete, and the cache must miss.
  3. prod    -- production width on one card: StoreConfig(2^23 x 768) (the
                paper's 2^26-row production hot tier cut to what one 80 GB
                card holds twice during an out-of-place commit), data drawn
                on the card and ingested through RagDB in 2^20-row chunks,
                batches of 32 requests in 4 groups through run(): median
                batch latency, the kernel's own time (CUDA events) beside
                its bound, the plain version, and a matmul + where + topk
                yardstick.

Prints the card's name and power limit, one line per phase, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no card is present or the package is
missing.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

TOL = 1e-5                    # rtol = atol on unit-norm data
HBM_BPS = 3.35e12             # H100 SXM device memory rate
FP32_FLOPS = 67e12            # H100 SXM fp32 peak outside the tensor cores
SEED = 0
DEV = None                    # the card, set in main()
# phase 1 grid: odd and pow2-adjacent N, serving widths D, B up to a full
# serving batch (and past one kernel block), G with a BLOCK_ALL lane at 7
GRID_N = (1, 513, 1000, 65_553)
GRID_D = (64, 96, 128, 768)
GRID_B = (1, 3, 8, 32, 64)
GRID_G = (1, 2, 7, 16)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def sync():
    torch.cuda.synchronize()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def host_mask(meta, preds):
    """(G, N) bool -- the WHERE clause in numpy, on the host, independent
    of the port: live, tenant, recency, category bitmask, ACL bitmask."""
    tenant, ts, cat, acl = (meta[:, j].astype(np.int64) for j in range(4))
    out = []
    for pt, pts, pc, pa in preds.astype(np.int64):
        ok = tenant >= 0
        if pt != -2:
            ok &= tenant == pt
        ok &= ts >= pts
        catbit = np.where((cat >= 0) & (cat < 32),
                          np.left_shift(1, np.clip(cat, 0, 31)), 0)
        ok &= (catbit & (pc & 0xFFFFFFFF)) != 0
        ok &= ((acl & 0xFFFFFFFF) & (pa & 0xFFFFFFFF)) != 0
        out.append(ok)
    return np.stack(out)


def compare(name, s_k, i_k, s_p, i_p, mask_rows, scores_full=None,
            dup_pairs=()):
    """Hold a kernel result (s_k, i_k) to the plain one (s_p, i_p): both
    (B, k) numpy. ``mask_rows`` (B, N) bool is each row's host mask;
    ``scores_full`` (B, N) the plain scores (to check every returned
    slot's score). Returns the max abs score error."""
    neg = np.float32(np.finfo(np.float32).min)
    check(s_k.shape == s_p.shape and i_k.shape == i_p.shape,
          f"{name}: shape {s_k.shape} vs {s_p.shape}")
    check(np.isfinite(s_k).all(), f"{name}: non-finite kernel scores")
    check(np.allclose(s_k, s_p, rtol=TOL, atol=TOL),
          f"{name}: scores differ beyond {TOL}")
    check(((s_k == neg) == (i_k == -1)).all(), f"{name}: slot -1 iff NEG_INF")
    err = float(np.max(np.abs(s_k - s_p))) if s_k.size else 0.0
    for b in range(s_k.shape[0]):
        real = i_k[b][i_k[b] >= 0]
        check(len(set(real.tolist())) == len(real), f"{name}: dup slot row {b}")
        check(mask_rows[b][real].all(), f"{name}: row {b} leaked "
              f"{real[~mask_rows[b][real]]}")
        ref_real = i_p[b][i_p[b] >= 0]
        check(len(real) == len(ref_real), f"{name}: fill differs row {b}")
        if len(real) == 0:
            continue
        kth = s_p[b][len(ref_real) - 1]
        for slot in set(real.tolist()) ^ set(ref_real.tolist()):
            sc = scores_full[b][slot] if scores_full is not None else kth
            check(abs(sc - kth) <= TOL * (1 + abs(kth)),
                  f"{name}: row {b} slot {slot} differs away from a k-th "
                  f"place tie")
        if scores_full is not None:
            check(np.allclose(s_k[b][:len(real)], scores_full[b][real],
                              rtol=TOL, atol=TOL),
                  f"{name}: row {b} slot/score pairing off")
        # ties go to the lower slot: among exactly equal scores slots rise
        sk = s_k[b][:len(real)]
        eq = sk[1:] == sk[:-1]
        check((real[1:][eq] > real[:-1][eq]).all(),
              f"{name}: row {b} tie not broken toward the lower slot")
        got = set(real.tolist())
        for lo, hi in dup_pairs:
            check(hi not in got or lo in got,
                  f"{name}: row {b} returned duplicate {hi} without {lo}")
    return err


def make_arena(rng, N, D, *, dead=False, dups=0):
    """Unit-norm emb (N, D), meta (N, 4) int32 with category 31 and high
    ACL bits, and ``dups`` pairs of identical rows (lo, hi)."""
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    meta = np.stack([
        rng.integers(-1, 5, N), rng.integers(0, 1000, N),
        rng.integers(0, 32, N),
        rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64),
    ], axis=1).astype(np.int64)
    meta[:, 2][rng.random(N) < 0.2] = 31          # category 31 -> sign bit
    if dead:
        meta[:, 0] = -1
    pairs = []
    for j in range(min(dups, N // 2)):
        lo, hi = j, N - 1 - j
        emb[hi] = emb[lo]
        meta[hi] = meta[lo]
        pairs.append((lo, hi))
    return emb, meta.astype(np.int32), pairs


def make_batch(rng, emb, B, G, pairs=(), *, block_all=False):
    """Unit-norm queries (B, D) (the first aimed at duplicate rows), G
    predicates (group 0 pass-all, the last BLOCK_ALL when asked) with
    random tenant / min_ts / category and ACL masks, and group ids."""
    q = rng.standard_normal((B, emb.shape[1])).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    for j, (lo, _) in enumerate(pairs[:B]):
        q[j] = emb[lo]
    preds = np.stack([
        rng.choice([-2, 0, 1, 2, 3, 4], G), rng.integers(0, 500, G),
        rng.integers(-(1 << 31), 1 << 31, G, dtype=np.int64),
        rng.integers(-(1 << 31), 1 << 31, G, dtype=np.int64),
    ], axis=1)
    preds[0] = [-2, 0, -1, -1]                    # pass-all (masks all ones)
    if block_all and G > 1:
        preds[-1] = [-3, 0, -1, -1]               # BLOCK_ALL
    gids = rng.integers(0, G, B).astype(np.int32)
    return q, preds.astype(np.int32), gids


def run_case(name, arena, batch, k, errs):
    (emb_d, meta_d, meta, pairs), (q, preds, gids) = arena, batch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    args = (t(q), emb_d, meta_d, t(gids), t(preds))
    s_k, i_k = kernel_mod.arena_scan_cuda(*args, k)
    s_p, i_p = kernel_mod.arena_scan_plain(*args, k)
    sync()
    full = (args[0] @ emb_d.T).cpu().numpy()
    mask = host_mask(meta, preds)[gids]
    errs.append(compare(name, s_k.cpu().numpy(), i_k.cpu().numpy(),
                        s_p.cpu().numpy(), i_p.cpu().numpy(), mask, full,
                        pairs))


def upload(emb, meta, pairs):
    return (torch.from_numpy(emb).to(DEV), torch.from_numpy(meta).to(DEV),
            meta, pairs)


def phase_kernel():
    rng = np.random.default_rng(SEED)
    errs = []
    n_cases = 0
    t0 = time.perf_counter()
    for N in GRID_N:
        for D in GRID_D:
            arena = upload(*make_arena(rng, N, D))
            for B in GRID_B:
                for G in GRID_G:
                    batch = make_batch(rng, arena[0].cpu().numpy(), B, G,
                                       block_all=(G == 7))
                    for k in sorted({1, 10, 100, 1000, N + 7}):
                        run_case(f"N{N}-D{D}-B{B}-G{G}-k{k}", arena, batch,
                                 k, errs)
                        n_cases += 1
    extra = {
        "dups": (dict(N=700, D=64, dups=40), 8, 2, False),
        "all-dead": (dict(N=600, D=96, dead=True), 5, 3, False),
        "block-all": (dict(N=2000, D=128), 33, 16, True),
        "B100-two-blocks": (dict(N=3000, D=64), 100, 4, False),
    }
    for name, (akw, B, G, blk) in extra.items():
        emb, meta, pairs = make_arena(rng, **akw)
        arena = upload(emb, meta, pairs)
        batch = make_batch(rng, emb, B, G, pairs, block_all=blk)
        for k in (1, 10, 300, 3100):
            run_case(f"{name}-k{k}", arena, batch, k, errs)
            n_cases += 1
    emit("kernel", cases=n_cases, max_abs_err=max(errs),
         seconds=time.perf_counter() - t0, tol=TOL, leaked_slots=0)
    return max(errs)


def phase_bench(dev):
    from repro_torch.api import RagDB
    from repro_torch.core.query import unified_query_ref
    from repro_torch.core.store import StoreConfig
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, CorpusConfig, make_corpus

    ccfg = CorpusConfig(n_docs=50_000, dim=128, n_tenants=20, n_categories=5)
    db = RagDB(StoreConfig(capacity=65_536, dim=128, metric="cosine"),
               device=dev)
    db.ingest(make_corpus(ccfg, device=dev))
    rng = np.random.default_rng(SEED + 1)
    groups = [(Principal(t, 0xFF), ccfg.now_ts - d * DAY_S, c)
              for t, d, c in ((1, 60, [0, 1]), (4, 120, [2]),
                              (9, 30, [0, 3, 4]), (17, 150, [1, 2, 3]))]
    qs = rng.standard_normal((32, 128)).astype(np.float32)

    def plans():
        out = []
        for r in range(32):
            p, ts, cats = groups[r % 4]
            out.append(db.session(p).search(qs[r]).newer_than(ts)
                       .in_categories(cats).limit(10).plan())
        return out

    batch = plans()
    check(all(p.engine == "cuda" for p in batch), "plans must pick 'cuda'")
    before = dataclasses.replace(db.stats)
    kernel_mod.LAUNCHES = 0
    s, sl, _ = db.execute(batch)
    launches = kernel_mod.LAUNCHES
    st = db.stats
    check(st.fused_scans - before.fused_scans == 1, "batch did not fuse")
    check(st.device_calls - before.device_calls == 1,
          "device_calls != dispatch units (1)")
    check(st.rows_scanned - before.rows_scanned == 65_536,
          "rows_scanned != arena capacity")
    check(launches >= 1, "kernel LAUNCHES did not grow")
    snap = db.log.snapshot()
    meta = torch.stack([snap[c] for c in ("tenant", "updated_at",
                                          "category", "acl")], 1).cpu().numpy()
    errs = []
    for r, plan in enumerate(batch):
        pa = plan.pred.as_array(dev)
        rs, ri = unified_query_ref(snap, torch.from_numpy(plan.logical.q)
                                   .to(dev), pa, 10)
        mask = host_mask(meta, pa.cpu().numpy()[None, :])
        errs.append(compare(f"bench-row{r}", s[r:r + 1], sl[r:r + 1],
                            rs.cpu().numpy(), ri.cpu().numpy(), mask))
    check(max(int((sl[r] >= 0).sum()) for r in range(32)) == 10,
          "no row filled its k-list")

    def run_row1():
        p1, ts1, cats1 = groups[1]
        return (db.session(p1).search(qs[1]).newer_than(ts1)
                .in_categories(cats1).limit(10).run())

    check(run_row1().cached, "a repeat before any write must hit the cache")
    # writes: delete row 0's best doc; move a group-1 doc onto row 1's query
    doc_of = {v: d for d, v in db.log._slot_of_doc.items()}
    gone_slot = int(sl[0, 0])
    p1, ts1, cats1 = groups[1]
    cand = np.nonzero((meta[:, 0] == p1.tenant_id) & (meta[:, 1] >= ts1)
                      & np.isin(meta[:, 2], cats1)
                      & ((meta[:, 3] & 0xFF) != 0))[0]
    moved = doc_of[int(cand[-1])]
    q1 = qs[1] / np.linalg.norm(qs[1])
    db.delete([doc_of[gone_slot]])
    db.update([moved], q1[None, :], [ccfg.now_ts])
    res = run_row1()
    check(not res.cached, "the cache must miss after a write")
    check(int(res.slots[0, 0]) == db.log.slot_of(moved)
          and abs(float(res.scores[0, 0]) - 1.0) < 1e-4,
          "the updated doc is not its query's new top-1")
    s2, sl2, _ = db.execute(plans())
    check(gone_slot not in sl2[0::4].ravel().tolist(),
          "the deleted doc is still served")
    emit("bench", rows=32, groups=4, engine="cuda", launches=launches,
         fused_scans=1, device_calls=1, rows_scanned=65_536,
         max_abs_err=max(errs),
         writes="deleted doc gone, updated doc top-1, cache missed")
    return launches, max(errs)


def peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def profile_batch(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((ev.key[:60], ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / (wall_us / 1e3)),
            "kernels": [{"name": n, "calls": c, "ms": ms}
                        for n, c, ms in rows[:8]]}


def events_ms(fn, iters):
    fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    sync()
    return a.elapsed_time(b) / iters


def phase_prod(dev, n_rows=1 << 23, dim=768, chunk=1 << 20):
    from repro_torch.api import RagDB
    from repro_torch.core.store import StoreConfig
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, CorpusConfig, device_corpus
    from repro_torch.kernels.arena_scan.ops import _packed_meta

    ccfg = CorpusConfig(n_docs=n_rows, dim=dim, n_tenants=20, n_categories=5)
    db = RagDB(StoreConfig(capacity=n_rows, dim=dim), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    host_s = []
    t_ingest0 = time.perf_counter()
    for start in range(0, n_rows, chunk):
        batch = device_corpus(ccfg, start, chunk, gen)
        sync()
        t0 = time.perf_counter()
        db.ingest(batch)
        host_s.append(time.perf_counter() - t0)
        del batch
    sync()
    ingest_s = time.perf_counter() - t_ingest0
    check(int(db.log.snapshot()["n_live"]) == n_rows, "n_live after ingest")

    rng = np.random.default_rng(SEED + 2)
    qs = rng.standard_normal((32, dim)).astype(np.float32)
    groups = [(Principal(t, 0xFF), ccfg.now_ts - d * DAY_S, c)
              for t, d, c in ((2, 90, [0, 1]), (5, 150, [2, 3]),
                              (11, 45, [4]), (19, 170, [0, 2, 4]))]
    plans = []
    for r in range(32):
        p, ts, cats = groups[r % 4]
        plans.append(db.session(p).search(qs[r]).newer_than(ts)
                     .in_categories(cats).limit(10).plan())
    check(all(p.engine == "cuda" for p in plans), "plans must pick 'cuda'")

    kernel_mod.LAUNCHES = 0
    lat = []
    n_batches = 6
    for _ in range(n_batches):
        t0 = time.perf_counter()
        s, sl, _ = db.execute(plans, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_mod.LAUNCHES
    check(launches == n_batches, f"{launches} launches for {n_batches} "
          "fused batches")
    profile = profile_batch(lambda: db.execute(plans, use_cache=False))

    # the kernel's inputs exactly as the executor builds them
    snap = db.log.snapshot()
    meta = _packed_meta(snap["tenant"], snap["updated_at"],
                        snap["category"], snap["acl"])
    order = [r for g in range(4) for r in range(g, 32, 4)]
    q = torch.from_numpy(np.concatenate([plans[r].logical.q
                                         for r in order])).to(dev)
    gids = torch.tensor([g for g in range(4) for _ in range(8)],
                        dtype=torch.int32, device=dev)
    preds = torch.stack([plans[g].pred.as_array(dev) for g in range(4)])
    args = (q, snap["emb"], meta, gids, preds, 10)
    s_k, i_k = kernel_mod.arena_scan_cuda(*args)
    s_p, i_p = kernel_mod.arena_scan_plain(*args)
    sync()
    mask_host = host_mask(meta.cpu().numpy(), preds.cpu().numpy())
    err = compare("prod", s_k.cpu().numpy(), i_k.cpu().numpy(),
                  s_p.cpu().numpy(), i_p.cpu().numpy(),
                  mask_host[gids.cpu().numpy()])
    # the front door's rows equal the direct kernel call's rows
    inv = np.argsort(order)
    check((sl == i_k.cpu().numpy()[inv]).all(), "run() rows != kernel rows")

    ms = events_ms(lambda: kernel_mod.arena_scan_cuda(*args), 10)
    plain_ms = events_ms(lambda: kernel_mod.arena_scan_plain(*args), 3)
    keep = torch.ones((32, n_rows), dtype=torch.bool, device=dev)

    def yardstick():
        sc = torch.matmul(q, snap["emb"].T)
        return torch.topk(torch.where(keep, sc, -3.4e38), 10, dim=1)

    yard_ms = events_ms(yardstick, 3)
    B, D, N, G, k = 32, dim, n_rows, 4, 10
    nbytes = N * (4 * D + 16) + B * D * 4 + B * 4 + G * 16 + B * k * 8
    flops = 2 * B * N * D
    bound_ms = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
    emit("prod", rows=N, dim=D, batch=B, groups=G, k=k,
         batch_ms_median=statistics.median(lat), batch_ms=lat,
         launches=launches, kernel_ms=ms, bound_ms=bound_ms,
         bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS
         else "operations", plain_ms=plain_ms, yardstick_ms=yard_ms,
         ingest_s=ingest_s, ingest_host_s=sum(host_s),
         ingest_host_s_per_chunk=host_s,
         peak_mem_gb=peak_gb(), profile=profile,
         max_abs_err=err)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, max_abs_err=err,
                bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS
                else "operations")


def main() -> int:
    global np, torch, kernel_mod
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels.arena_scan import kernel as kernel_mod
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    global DEV
    dev = DEV = torch.device("cuda")

    t0 = time.perf_counter()
    kernel_mod.build()
    ptxas = [ln.strip() for ln in kernel_mod.BUILD_LOG.splitlines()
             if "registers" in ln or "Compiling" in ln]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    err1 = phase_kernel()
    _, err2 = phase_bench(dev)
    prod = phase_prod(dev)
    print(json.dumps({"kernels": [{
        "name": "arena_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/arena_scan.cu",
        "replaces": "src/repro/kernels/arena_scan/kernel.py:171",
        "launches": prod["launches"],
        "max_abs_err": max(err1, err2, prod["max_abs_err"]),
        "ms": prod["ms"], "plain_ms": prod["plain_ms"],
        "bound_ms": prod["bound_ms"], "bound_by": prod["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
