#!/usr/bin/env python3
"""Probe of the arena-scan kernels on one NVIDIA card: bit identity with an
earlier version of the kernels, where the time goes, and the FMA loop's
ceiling.

    git archive <commit> src/repro_torch/csrc | tar -x -C tmp/parent
    python3 tools/scan_probe.py --parent tmp/parent/src/repro_torch/csrc

Builds, one nvcc per source and all at once, into src/repro_torch/build/
probe/ (git-ignored): the checkout's arena-scan library, copies of it with
one part of the work taken out or switched (`VARIANTS`: the FMAs of the
score stage; the BM25 arithmetic; the lanes' loads; in the staged-lanes
design of 1b2c4c4 also the whole lane staging, at 16 and at 32 dims a
chunk; PROBE's slot loads replaced by a hash of the position), the
library of ``--parent`` (an
earlier design; PROBE's entry points before the compacted design take no
live count, and the tool calls each library by its own signature) and
tools/scan_probe_fma.cu. A variant whose text is not in the checkout's
header is left out and reported so, and one of modes not asked for is not
built. Then prints one JSON line each for:

* ``identity``: each mode of ``--modes`` (dense, fused, both, probe),
  resident and paged (pages of 128, 1000, 4096 rows), over chip_smoke.py's
  kernel draws at N in 1..65553, D in 1..768 (D 1 and 3 take the 4-byte
  copies), B in 1..100, k in 1..300: the lists of this checkout against
  ``--parent``'s, scores and slots compared bit for bit, and each paged
  list against the resident one; PROBE's poisoned candidate vectors also
  compacted on the card and scanned from the live count, against the
  parent's lists on the uncompacted vector;
* ``prod``: 2^23 x 768 f32 rows drawn on the card (seed 0), 32 queries in 4
  predicate groups, k 10, 16 lanes a row and 4 query terms for the
  lexical modes, under two predicate draws (`DRAWS`: ``prod``, three
  tenant-scoped groups and one of any tenant; ``keepall``, every live row
  kept by every group), each group's kept share of (row, query) pairs,
  then per mode and regime (resident; paged at 2^15 rows): bit identity
  with ``--parent``, and CUDA-event times taken in turns (parent, this,
  the variants, this, parent, the variants); the matmul + where + topk
  yardstick, and the SM clock and power while the dense kernel runs.
  PROBE (`probe_prod`, the ``prod`` draw) scans an IVF-shaped candidate
  vector -- 256 probed clusters of cap 1536, the last a padding cluster,
  about 265,000 of its 393,216 slots live -- padded, compacted on the
  host, and compacted on the card (the compaction timed too), every
  library in turns, and a persistent-grid stand-in (the paged kernel at
  pages of P_live / 2 SMs);
* ``fma``: tools/scan_probe_fma.cu at 2 blocks of 256 an SM, the score
  stage's FMA loop without copies or epilogue: TFLOP/s of the 4 x 8
  micro-tile and of 8 x 8 and 4 x 16.

``--phases`` picks some of the three (default all).
Exits 2 without a card or without ``--parent``'s sources.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
BUILD = os.path.join(ROOT, "src", "repro_torch", "build", "probe")
SOURCES = ("arena_scan.cu", "arena_scan_fused.cu", "arena_scan_both.cu",
           "arena_scan_probe.cu")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]
MODES = {"dense": 0, "fused": 1, "both": 2, "probe": 3}
#: the score stage's FMAs, taken out in the `nofma` copy
FMA_LINES = [f"acc[i][j] = fmaf(v.{c}, e[i].{c}, acc[i][j]);" for c in "xyzw"]
# the staged-lanes lexical stage of 1b2c4c4: its BM25 result, its lane
# loads, the staging block as a whole, the lexical modes' chunk width and
# the staging buffer
_OLD_BM25 = ("0.f);\n  }\n  return acc;\n}\n\n// One merge round",
             "0.f);\n  }\n  return 0.f;\n}\n\n// One merge round")
_OLD_LANES = [("lt_sh[r * LS + t] = in ? a.terms[src] : -1;",
               "lt_sh[r * LS + t] = -1;"),
              ("ll_sh[r * LS + t] = in ? a.lexnorm[src] : 0.f;",
               "ll_sh[r * LS + t] = 0.f;")]
_OLD_STAGING = ("if (c == 0) {               // the sub-tile's lanes",
                "if (false) {               // the sub-tile's lanes")
_OLD_RING32 = [("return (mode == FUSED || mode == BOTH) ? 16 : 32;",
                "return 32;"),
               ("p.qlex = p.lanes + (lexical ? align16((size_t)8 * TILE_N * "
                "(T | 1)) : 0);", "p.qlex = p.lanes;")]
# the compacted lexical stage: its two BM25 results (16-byte pieces, one
# lane at a time) and its lane loads
_NEW_BM25 = [(f"{last}\n  }}\n  return acc;", f"{last}\n  }}\n  return 0.f;")
             for last in ("    acc = lane_add(acc, w3, ll.w);",
                          "    acc = lane_add(acc, w, __ldg(ll + t));")]
_NEW_LANES = [("const int4 lt = __ldg(lt4 + p);",
               "const int4 lt = make_int4(-1, -1, -1, -1);"),
              ("const float4 ll = __ldg(ll4 + p);",
               "const float4 ll = make_float4(0.f, 0.f, 0.f, 0.f);"),
              ("const int lane = __ldg(lt + t);", "const int lane = -1;"),
              ("acc = lane_add(acc, w, __ldg(ll + t));",
               "acc = lane_add(acc, w, 0.f);")]
# PROBE's slot loads (the parent's: every chunk reloads a row's slot from
# the candidate vector): a hash of the candidate position (a multiply-high
# into [0, n_arena)) takes the loaded slot's place, so the rows stay
# scattered over the arena but no slot is read
_HASH = "(int)__umulhi((unsigned)pos * 2654435761u, (unsigned)a.n_arena)"
_OLD_SLOT = [("const int slot = __ldg(a.cand + pos);",
              f"const int slot = {_HASH};")]
#: variant -> alternative substitution lists for arena_scan.cuh (the first
#: whose every text is in the header applies): the work each takes out
VARIANTS = {
    "nofma": [[(line, "") for line in FMA_LINES]],
    "noslot": [_OLD_SLOT],
    "nolex": [[_OLD_BM25], _NEW_BM25],
    "nolanes": [_OLD_LANES, _NEW_LANES],
    "bare16": [[_OLD_BM25, _OLD_STAGING]],
    "bare32": [[_OLD_BM25, _OLD_STAGING, *_OLD_RING32]],
}
#: the lexical variants, timed in the lexical modes only
LEX_VARIANTS = ("nolex", "nolanes", "bare16", "bare32")
#: the PROBE-only variants
PROBE_VARIANTS = ("noslot",)
#: predicate draws of the prod batch, (tenant, min_ts, category mask, ACL
#: mask) for groups 0..3
DRAWS = {
    "prod": [[2, 100, 3, 255], [5, 300, 12, 255], [11, 50, 16, 255],
             [-2, 600, 21, 255]],
    "keepall": [[-2, 0, -1, -1]] * 4,
}


def emit(name, **fields):
    print(json.dumps({"probe": name, **fields}), flush=True)


def copy_sources(name, csrc, alternatives=((),)):
    """The scan's sources and headers of ``csrc`` in BUILD/name, with the
    first substitution list of ``alternatives`` whose every text is in
    arena_scan.cuh applied to it; None when none applies."""
    header = open(os.path.join(csrc, "arena_scan.cuh")).read()
    subs = next((alt for alt in alternatives
                 if all(old in header for old, _ in alt)), None)
    if subs is None:
        return None
    d = os.path.join(BUILD, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f in SOURCES or f.endswith(".cuh"):
            text = open(os.path.join(csrc, f)).read()
            for old, new in subs if f == "arena_scan.cuh" else ():
                text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
    return d


def build_all(nvcc, dirs, fma_src):
    """Every library at once: {name: CDLL}."""
    procs = {}
    for name, d in dirs.items():
        procs[name] = [subprocess.Popen(
            [nvcc, *FLAGS, "-c", "-o", os.path.join(d, s + ".o"),
             os.path.join(d, s)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for s in SOURCES]
    fma_so = os.path.join(BUILD, "fma.so")
    fma = subprocess.Popen([nvcc, *FLAGS, "-shared", "-o", fma_so, fma_src],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    libs = {}
    for name, d in dirs.items():
        for p in procs[name]:
            log = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        so = os.path.join(d, "lib.so")
        subprocess.run([nvcc, *FLAGS[:2], "-shared", "-o", so,
                        *[os.path.join(d, s + ".o") for s in SOURCES]],
                       check=True)
        libs[name] = bind(ctypes.CDLL(so))
    log = fma.communicate()[0]
    if fma.returncode:
        raise RuntimeError(f"nvcc failed for the FMA probe:\n{log[-4000:]}")
    libs["fma"] = ctypes.CDLL(fma_so)
    libs["fma"].scan_probe_fma.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    return libs


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arena_scan_launch.argtypes = [p] * 5 + [i] * 5 + [p] * 7
    lib.arena_scan_paged_launch.argtypes = [p] * 5 + [i] * 6 + [p] * 7
    for m in ("fused", "both"):
        getattr(lib, f"arena_scan_{m}_launch").argtypes = (
            [p] * 9 + [i] * 7 + [p] * 7)
        getattr(lib, f"arena_scan_{m}_paged_launch").argtypes = (
            [p] * 9 + [i] * 8 + [p] * 7)
    # PROBE's entry points: with the live count (and the compaction that
    # makes it) since the compacted design, without it before
    lib.probe_live = hasattr(lib, "arena_scan_compact_launch")
    n_in = 6 if lib.probe_live else 5
    lib.arena_scan_probe_launch.argtypes = [p] * n_in + [i] * 5 + [p] * 7
    lib.arena_scan_probe_paged_launch.argtypes = ([p] * n_in + [i] * 6
                                                  + [p] * 7)
    if lib.probe_live:
        lib.arena_scan_compact_launch.argtypes = ([p, i, i, p, i, p, i, i]
                                                  + [p] * 4)
        lib.arena_scan_compact_blocks.argtypes = [i]
    return lib


def compact(torch, lib, members, clusters, overflow, n_arena):
    """The compaction kernel of a library that has it: (the live slots of
    the probed clusters' members and the overflow tail, in candidate order
    and -1 after; the live count (1,) int32 on the card)."""
    C, cap = members.shape
    P = clusters.shape[0] * cap + overflow.shape[0]
    dev = members.device
    counts = torch.empty(lib.arena_scan_compact_blocks(P), dtype=torch.int32,
                         device=dev)
    out = torch.empty(P, dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    rc = lib.arena_scan_compact_launch(
        members.data_ptr(), C, cap, clusters.data_ptr(), clusters.shape[0],
        overflow.data_ptr(), overflow.shape[0], n_arena, counts.data_ptr(),
        out.data_ptr(), n_live.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"compaction launch failed: {rc}")
    return out, n_live


def launch(torch, lib, mode, args, k, page_rows=None):
    """One launch; (scores, slots). The candidate buffers are sized for the
    smallest tile any version of the kernels uses (256 rows)."""
    q, emb, meta, gids, preds, lex, cand = args
    # PROBE: cand walks all its P slots, or (cand, n_live) its live prefix
    cand, n_live = cand if isinstance(cand, tuple) else (cand, None)
    dev = q.device
    B, D = q.shape
    n = cand.shape[0] if mode == "probe" else emb.shape[0]
    lists = 2 if mode == "both" else 1
    tile = page_rows or 256
    n_tiles = -(-n // tile)
    size = lists * B * (1 << (n_tiles - 1).bit_length()) * min(k, tile)
    bufs = [torch.empty(size, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    out_s = torch.empty((lists * B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((lists * B, k), dtype=torch.int32, device=dev)
    tail = (*(b.data_ptr() for b in bufs), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    pg = () if page_rows is None else (page_rows,)
    sfx = "_paged" if page_rows else ""
    N, G = emb.shape[0], preds.shape[0]
    dense_in = (q.data_ptr(), emb.data_ptr(), meta.data_ptr())
    if mode == "dense":
        rc = getattr(lib, f"arena_scan{sfx}_launch")(
            *dense_in, gids.data_ptr(), preds.data_ptr(), B, N, D, G, k, *pg,
            *tail)
    elif mode in ("fused", "both"):
        terms, lexnorm, qterms, qidf = lex
        rc = getattr(lib, f"arena_scan_{mode}{sfx}_launch")(
            *dense_in, gids.data_ptr(), preds.data_ptr(), terms.data_ptr(),
            lexnorm.data_ptr(), qterms.data_ptr(), qidf.data_ptr(), B, N, D,
            G, terms.shape[1], qterms.shape[1], k, *pg, *tail)
    else:
        if lib.probe_live:
            live = (None if n_live is None else n_live.data_ptr(),)
        elif n_live is None:
            live = ()
        else:
            raise ValueError("this library's PROBE takes no live count")
        rc = getattr(lib, f"arena_scan_probe{sfx}_launch")(
            *dense_in, cand.data_ptr(), *live,
            preds[0].contiguous().data_ptr(), B, N, cand.shape[0], D, k,
            *pg, *tail)
    if rc:
        raise RuntimeError(f"{mode} launch failed: {rc}")
    return out_s, out_i, bufs


def same(torch, a, b):
    return bool((a[0].view(torch.int32) == b[0].view(torch.int32)).all()
                and (a[1] == b[1]).all())


def events_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def identity(np, torch, cs, libs, modes):
    """chip_smoke.py's kernel draws through both versions, each mode of
    ``modes``; PROBE's poisoned candidate vectors also compacted on the
    card (when this library has the compaction), its lists held to the
    parent's on the uncompacted vector."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases, bad = 0, []
    for N in (1, 255, 257, 513, 1000, 65553):
        for D in (1, 3, 4, 64, 96, 100, 768):
            for mode in modes:
                if mode != "dense" and D < 4 and N > 600:
                    continue
                for B in (1, 5, 17, 32, 33, 63, 64, 100):
                    if N == 65553 and B not in (5, 32, 64):
                        continue
                    emb, meta, pairs = cs.make_arena(rng, N, D, dups=4)
                    q, preds, gids = cs.make_batch(rng, emb, B,
                                                   1 if mode == "probe" else 4,
                                                   pairs, block_all=True)
                    lex = cand = None
                    if mode in ("fused", "both"):
                        lex = tuple(map(t, (
                            rng.integers(-1, 64, (N, 16)).astype(np.int32),
                            rng.random((N, 16)).astype(np.float32),
                            rng.integers(-1, 64, (B, 4)).astype(np.int32),
                            rng.random((B, 4)).astype(np.float32))))
                    forms = [None]
                    if mode == "probe":
                        cand = t(rng.integers(-3, N + 3, N).astype(np.int32))
                        if libs["this"].probe_live:
                            forms.append(compact(
                                torch, libs["this"], cand[None],
                                t(np.zeros(1, np.int32)),
                                t(np.zeros(0, np.int32)), N))
                    args = (t(q), t(emb), t(meta), t(gids), t(preds), lex,
                            cand)
                    for k in (1, 10, 33, 300):
                        old = launch(torch, libs["parent"], mode, args,
                                     k)[:2]
                        for form in forms:
                            a = args if form is None else (*args[:6], form)
                            tag = "compacted" if form else None
                            res = launch(torch, libs["this"], mode, a, k)[:2]
                            if not same(torch, res, old):
                                bad.append([mode, N, D, B, k, None, tag])
                            for P in (128, 1000, 4096):
                                pg = launch(torch, libs["this"], mode, a, k,
                                            P)[:2]
                                if not same(torch, pg, res):
                                    bad.append([mode, N, D, B, k, P, tag])
                            cases += 1
    emit("identity", cases=cases, mismatches=len(bad), first=bad[:20])
    return not bad


#: the probe's candidates in the prod batch, shaped as chip_smoke.py's
#: ivf_prod index gives them: 256 probed clusters (the last a padding
#: cluster, as a union of 255 is padded to 256) of cap 1536, each filled
#: to PROBE_FILL..cap members drawn over the arena (about 265,000 live of
#: the vector's 393,216), no overflow tail
PROBE_CLUSTERS, PROBE_CAP, PROBE_FILL = 256, 1536, (540,)


def prod_arena(torch):
    """The prod shape drawn on the card: (q, emb, meta, gids, lex, the
    probe's member table of the probed clusters)."""
    dev = torch.device("cuda")
    N, D, B, T, QT = 1 << 23, 768, 32, 16, 4
    gen = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((N, D), generator=gen, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    meta = torch.stack([
        torch.randint(-1, 20, (N,), generator=gen, device=dev),
        torch.randint(0, 1000, (N,), generator=gen, device=dev),
        torch.randint(0, 5, (N,), generator=gen, device=dev),
        torch.randint(0, 256, (N,), generator=gen, device=dev)], 1).int()
    q = torch.randn((B, D), generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    gids = torch.arange(B, device=dev, dtype=torch.int32) // 8
    lex = (torch.randint(-1, 4096, (N, T), generator=gen, device=dev).int(),
           torch.rand((N, T), generator=gen, device=dev),
           torch.randint(0, 4096, (B, QT), generator=gen, device=dev).int(),
           torch.rand((B, QT), generator=gen, device=dev))
    fill = torch.randint(PROBE_FILL[0], PROBE_CAP + 1, (PROBE_CLUSTERS,),
                         generator=gen, device=dev)
    fill[-1] = 0                                  # the padding cluster
    slots = torch.randint(0, N, (PROBE_CLUSTERS, PROBE_CAP), generator=gen,
                          device=dev)
    pos = torch.arange(PROBE_CAP, device=dev)
    members = torch.where(pos[None] < fill[:, None], slots, -1).int()
    return q, emb, meta, gids, lex, members


def kept_share(torch, meta, preds):
    """Each group's share of arena rows it keeps (the kernels' mask)."""
    t, ts, cat, acl = (meta[:, j] for j in range(4))
    out = []
    for pt, pts, pc, pa in preds.tolist():
        keep = (t >= 0) & ((t == pt) | (pt == -2)) & (ts >= pts)
        keep &= ((torch.bitwise_left_shift(torch.ones_like(cat), cat) & pc)
                 != 0) & ((acl & pa) != 0)
        out.append(float(keep.float().mean()))
    return out


def probe_prod(torch, libs, args):
    """PROBE on the prod batch's IVF-shaped candidates, every library in
    turns over the vectors it takes: ``padded`` (the probed clusters'
    member rows as the parent walked them, padding included), ``live``
    (the live slots compacted on the host: the dead rows skipped) and, in a
    library with the compaction kernel, ``device`` (compacted on the card,
    the scan reading the live count there) and ``device-persistent`` (the
    same through the paged kernel at pages of P_live / (2 SMs), rounded up
    to 256: one block an SM slot walking its tiles). Bit identity of every
    vector against the parent's padded lists, resident and paged."""
    dev = torch.device("cuda")
    q, emb, meta, gids, preds, lex, members = args
    k, N = 10, emb.shape[0]
    cand = members.reshape(-1).contiguous()
    clusters = torch.arange(members.shape[0], dtype=torch.int32, device=dev)
    no_over = torch.empty(0, dtype=torch.int32, device=dev)
    vectors = {"padded": cand, "live": cand[cand >= 0].contiguous()}
    p_live = vectors["live"].shape[0]
    new = libs["this"].probe_live
    if new:
        vectors["device"] = compact(torch, libs["this"], members, clusters,
                                    no_over, N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    persistent = -(-p_live // (2 * sms) // 256) * 256
    at = lambda v: (*args[:6], vectors[v])
    ok = True
    ident = {}
    want = launch(torch, libs["parent"], "probe", at("padded"), k)[:2]
    want_pg = launch(torch, libs["parent"], "probe", at("padded"), k,
                     1 << 15)[:2]
    for v in vectors:
        for P, ref in ((None, want), (1 << 15, want_pg)):
            for n in ("parent", "this"):
                if v == "device" and n == "parent":
                    continue
                got = launch(torch, libs[n], "probe", at(v), k, P)[:2]
                ident[f"{n}-{v}-{P or 'resident'}"] = same(torch, got, ref)
                if n == "this":
                    ok &= ident[f"{n}-{v}-{P or 'resident'}"]
    if new:
        got = launch(torch, libs["this"], "probe", at("device"), k,
                     persistent)[:2]
        ident["this-device-persistent"] = same(torch, got, want)
        ok &= ident["this-device-persistent"]
    names = [n for n in libs if n in VARIANTS and n not in LEX_VARIANTS]
    runs = {}
    for n in ("parent", "this", *names):
        for v in vectors:
            if v == "device" and not libs[n].probe_live:
                continue
            runs[f"{n}-{v}"] = (lambda n=n, v=v: launch(
                torch, libs[n], "probe", at(v), k))
            if v == "device" and n == "this":
                runs["this-device-persistent"] = (lambda: launch(
                    torch, libs["this"], "probe", at("device"), k,
                    persistent))
    compaction = None
    if new:
        run_c = lambda: compact(torch, libs["this"], members, clusters,
                                no_over, N)
        runs["compaction"] = run_c
        # CUDA events time a short launch pair at the host's pace: the
        # profiler gives the device's time
        import chip_smoke as cs
        compaction = cs.device_ms(run_c, 20)
    order = list(runs)
    ms = {r: [] for r in runs}
    for r in order + order[::-1]:
        ms[r].append(events_ms(torch, runs[r], 10))
    emit("probe", P=cand.shape[0], P_live=p_live, page_rows=1 << 15,
         persistent_page_rows=persistent, identical=ident, ms=ms,
         compaction_device_ms=compaction and compaction[0],
         compaction_kernels=compaction and compaction[1])
    return ok


def prod(torch, libs, arena, modes):
    dev = torch.device("cuda")
    q, emb, meta, gids, lex, cand = arena
    k = 10
    ok = True
    for draw, rows in DRAWS.items():
        preds = torch.tensor(rows, dtype=torch.int32, device=dev)
        args = (q, emb, meta, gids, preds, lex, cand)
        emit("prod_draw", draw=draw, preds=rows,
             kept_share=kept_share(torch, meta, preds))
        for mode in modes:
            if mode == "probe":
                if draw == "prod":
                    ok &= probe_prod(torch, libs, args)
                continue
            lexical = mode in ("fused", "both")
            variants = [n for n in libs if n in VARIANTS
                        and n not in PROBE_VARIANTS
                        and (lexical or n not in LEX_VARIANTS)]
            for P in (None, 1 << 15):
                run = {n: (lambda n=n: launch(torch, libs[n], mode, args, k,
                                              P))
                       for n in ("parent", "this", *variants)}
                res, old = run["this"]()[:2], run["parent"]()[:2]
                ident = same(torch, res, old)
                ok &= ident
                ms = {n: [] for n in run}
                for n in ("parent", "this", *variants, "this", "parent",
                          *variants):
                    ms[n].append(events_ms(torch, run[n], 10))
                emit("prod", draw=draw, mode=mode, page_rows=P,
                     identical=ident, ms=ms)
    if "dense" not in modes:
        return ok
    preds = torch.tensor(DRAWS["prod"], dtype=torch.int32, device=dev)
    args = (q, emb, meta, gids, preds, lex, cand)
    keep = torch.ones((q.shape[0], emb.shape[0]), dtype=torch.bool,
                      device=dev)

    def yardstick():
        sc = torch.matmul(q, emb.T)
        return torch.topk(torch.where(keep, sc, -3.4e38), k, dim=1)

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        dense_ms = events_ms(
            torch, lambda: launch(torch, libs["this"], "dense", args, k), 60)
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=30)[0]
    emit("prod", yardstick_ms=events_ms(torch, yardstick, 3),
         dense_ms_60_calls=dense_ms,
         clock_mhz_power_w=[[float(x) for x in ln.split(",")]
                            for ln in samples.splitlines()
                            if ln.count(",") == 1])
    return ok


def fma(torch, lib):
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(4096, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for shape, (mr, qn) in enumerate(((4, 8), (8, 8), (4, 16))):
        blocks, iters = 2 * sms, 2000

        def run():
            rc = lib.scan_probe_fma(shape, blocks, iters, out.data_ptr(),
                                    stream)
            if rc:
                raise RuntimeError(f"FMA probe failed: {rc}")

        ms = events_ms(torch, run, 5)
        flops = blocks * 256 * iters * 16 * mr * qn * 2
        rates[f"{mr}x{qn}"] = {"ms": ms, "tflops": flops / ms / 1e9}
    emit("fma", blocks_per_sm=2, dims_per_barrier=16, rates=rates)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="csrc directory of the version to compare with")
    ap.add_argument("--phases", default="identity,prod,fma",
                    help="comma-separated subset of identity, prod, fma")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated subset of the scan modes "
                    "(identity, prod)")
    opts = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(opts.parent, "arena_scan.cuh")):
        print(f"scan_probe: no arena_scan.cuh in {opts.parent}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    cs.np, cs.torch = np, torch
    torch.backends.cuda.matmul.allow_tf32 = False
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    phases = set(opts.phases.split(","))
    modes = [m for m in MODES if m in opts.modes.split(",")]
    dirs = {"this": copy_sources("this", CSRC),
            "parent": copy_sources("parent", opts.parent)}
    if "prod" in phases:
        for name, alts in VARIANTS.items():
            wanted = (("fused" in modes or "both" in modes)
                      if name in LEX_VARIANTS else "probe" in modes
                      if name in PROBE_VARIANTS else True)
            dirs[name] = copy_sources(name, CSRC, alts) if wanted else None
        emit("variants", built=[n for n in VARIANTS if dirs[n]],
             not_in_this_design=[n for n in VARIANTS if not dirs[n]])
    libs = build_all(nvcc, {n: d for n, d in dirs.items() if d},
                     os.path.join(ROOT, "tools", "scan_probe_fma.cu"))
    ok = True
    if "prod" in phases:
        ok &= prod(torch, libs, prod_arena(torch), modes)
        torch.cuda.empty_cache()
    if "identity" in phases:
        ok &= identity(np, torch, cs, libs, modes)
    if "fma" in phases:
        fma(torch, libs["fma"])
    print(json.dumps({"identical": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
