"""Time the port's kernel wrappers of two checkouts on one card, in turns.

    python3 tools/wrapper_ab.py --parent DIR [--order PCCP] [--identity]
                                [--sass] [--sweep]

DIR is the ``src`` directory of another checkout (an earlier commit
unpacked with ``git archive`` into a git-ignored directory such as
``_trees/parent``); this checkout's ``src`` is the change. Each letter of
``--order`` starts one child process (P the parent, C the change), which
builds that checkout's kernels, draws the inputs from one seed on the
card and times each wrapper by CUDA events over a run of launches:
``arena_scan_cuda`` at the prod cell's shape (2^23 x 768 rows, 32 query
rows in 4 groups, k = 10) resident and paged (pages of 2^15 rows),
``flash_attention_cuda`` at lm_serve's prefill (B 8, S 2048, KV 8, G 4,
hd 128, bf16) and moe_serve's (G 2, hd 64) and ``decode_attention_cuda``
at their decode steps (cache 2064, 2049 live), both at wide_serve's
three attention widths (Phi-3-mini: KV 32, G 1, hd 96; Gemma-2B: KV 1,
G 8, hd 256; Falcon-7B: KV 1, G 71, hd 64), ``decode_attention_cuda``
also at deep_serve's (KV 1, G 4, hd 512) and at the three ``long_500k``
cells' (B 1, S 524,288: qwen1.5-0.5b KV 16, G 1, hd 64; yi-6b KV 4, G
8, hd 128; granite-moe KV 8, G 2, hd 64) and over G (1, 2, 4, 8 at
lm_serve's and moe_serve's widths, KV 8, the cache of their steps), every
decode time also as
device time (torch.profiler: a decode call is paced by the host), with
the decode wrapper's host time a call at lm_serve's (200 calls queued,
no sync inside) and yi-6b's ``long_500k`` decode step (`build_cell`, 32
layers: a host-paced step) by CUDA events. Prints one JSON line a child,
then the median of each side. The children run one after the other, so
the two sides share the card, its clocks and its power limit.
``--identity`` also has each child hash each kernel's outputs, bit for
bit, on seeded inputs at every shape
above, at every width 8..256 and hd 6 / 100 (G 2, S 129), at G 71 / 8
(S 2064, hd 64 / 256) and at hd 512 (G 4, S 2064) in both dtypes, and
checks that both sides' hashes agree: every flash output, and every
decode output that the SIMT body gives on both sides (a checkout with a
tensor-core body gives the bf16 rows up to 256 through it: those are held
to the plain version by ``chip_smoke.py``). Each side's first child also
prints ptxas's registers and spills of every decode kernel it built.
``--sass`` compares the SASS (``cuobjdump -sass``) of every attention
kernel of the two libraries, by function name, and lists the kernels
whose code differs; with ``--order ''`` it runs no timing child.
``--sweep`` then starts one more child on the change, which times the
tensor-core body (device time) at every served bf16 decode shape up to
width 256 over the splits that its planner's two constants give
(TC_BLOCKS_PER_SM 1 / 2 / 4, TC_MERGE_ROWS 0 / 10 / 20 / 40 / 80).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: decode over G at lm_serve's (KV 8, hd 128) and moe_serve's (KV 8, hd 64)
#: widths, their steps' cache (B 8, S 2064, 2049 live) -- G 4 and G 2 are
#: their own steps, timed as such: (B, S, KV, G, hd)
G_SWEEP = {f"hd{hd}_G{G}": (8, 2064, 8, G, hd)
           for hd, gs in ((128, (1, 2, 8)), (64, (1, 4, 8))) for G in gs}


def child(src: str, identity: bool) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _attention
    from repro_torch.kernels.arena_scan import kernel
    from repro_torch.kernels.decode_attention import decode_attention as dec
    from repro_torch.kernels.flash_attention import flash_attention as fa
    kernel.build()
    lib_path = _attention.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    N, D, B, G, k = 1 << 23, 768, 32, 4, 10
    emb = torch.randn((N, D), generator=g, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    meta = torch.stack([torch.randint(0, 20, (N,), generator=g, device=dev),
                        torch.randint(0, 1000, (N,), generator=g, device=dev),
                        torch.randint(0, 5, (N,), generator=g, device=dev),
                        torch.full((N,), -1, device=dev, dtype=torch.int64)],
                       1).to(torch.int32).contiguous()
    q = torch.randn((B, D), generator=g, device=dev)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    gids = torch.arange(B, device=dev, dtype=torch.int32) % G
    preds = torch.tensor([[2, 100, -1, -1], [5, 300, 12, -1],
                          [11, 0, 16, -1], [19, 500, 21, -1]],
                         dtype=torch.int32, device=dev)
    bf = dict(generator=g, device=dev, dtype=torch.bfloat16)
    fq = torch.randn((8, 2048, 8, 4, 128), **bf)
    fk, fv = (torch.randn((8, 2048, 8, 128), **bf) for _ in range(2))
    dq = torch.randn((8, 8, 4, 128), **bf)
    dk, dv = (torch.randn((8, 2064, 8, 128), **bf) for _ in range(2))
    lengths = torch.full((8,), 2049, dtype=torch.int32, device=dev)
    mq = torch.randn((8, 2048, 8, 2, 64), **bf)
    mk, mv = (torch.randn((8, 2048, 8, 64), **bf) for _ in range(2))
    mdq = torch.randn((8, 8, 2, 64), **bf)
    mdk, mdv = (torch.randn((8, 2064, 8, 64), **bf) for _ in range(2))
    #: wide_serve's attention widths: (KV, G, hd)
    wide = {"phi3": (32, 1, 96), "gemma": (1, 8, 256), "falcon": (1, 71, 64)}
    #: decode only: deep_serve's step and the long_500k cells' (B, S, KV,
    #: G, hd)
    dec_only = {"deep": (8, 2064, 1, 4, 512), **G_SWEEP,
                "qwen15_long": (1, 524288, 16, 1, 64),
                "yi6b_long": (1, 524288, 4, 8, 128),
                "granite_long": (1, 524288, 8, 2, 64)}
    wide_in = {}
    for name, (KV, G, hd) in wide.items():
        wide_in[name] = (
            torch.randn((8, 2048, KV, G, hd), **bf),
            *(torch.randn((8, 2048, KV, hd), **bf) for _ in range(2)),
            torch.randn((8, KV, G, hd), **bf),
            *(torch.randn((8, 2064, KV, hd), **bf) for _ in range(2)))

    def events_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    out = {
        "dense_ms": events_ms(lambda: kernel.arena_scan_cuda(
            q, emb, meta, gids, preds, k), 10),
        "paged_ms": events_ms(lambda: kernel.arena_scan_cuda(
            q, emb, meta, gids, preds, k, page_rows=1 << 15), 10),
        "flash_ms": events_ms(lambda: fa.flash_attention_cuda(
            fq, fk, fv, causal=True), 20),
        "decode_ms": events_ms(lambda: dec.decode_attention_cuda(
            dq, dk, dv, lengths), 200),
        "flash_hd64_ms": events_ms(lambda: fa.flash_attention_cuda(
            mq, mk, mv, causal=True), 50),
        "decode_hd64_ms": events_ms(lambda: dec.decode_attention_cuda(
            mdq, mdk, mdv, lengths), 200),
    }
    out["decode_device_ms"] = device_ms(
        torch, lambda: dec.decode_attention_cuda(dq, dk, dv, lengths), 100)
    out["decode_hd64_device_ms"] = device_ms(
        torch, lambda: dec.decode_attention_cuda(mdq, mdk, mdv, lengths), 100)
    for name, (q, k, v, q1, kc, vc) in wide_in.items():
        out[f"flash_{name}_ms"] = events_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True), 10)
        out[f"decode_{name}_ms"] = events_ms(
            lambda: dec.decode_attention_cuda(q1, kc, vc, lengths), 200)
        out[f"decode_{name}_device_ms"] = device_ms(
            torch, lambda: dec.decode_attention_cuda(q1, kc, vc, lengths), 100)
    del wide_in
    for name, (B, S, KV, G, hd) in dec_only.items():
        q1 = torch.randn((B, KV, G, hd), **bf)
        kc, vc = (torch.randn((B, S, KV, hd), **bf) for _ in range(2))
        L = torch.full((B,), min(S, 2049) if S < 100_000 else S,
                       dtype=torch.int32, device=dev)
        n = 10 if S > 100_000 else 100
        out[f"decode_{name}_ms"] = events_ms(
            lambda: dec.decode_attention_cuda(q1, kc, vc, L), n)
        out[f"decode_{name}_device_ms"] = device_ms(
            torch, lambda: dec.decode_attention_cuda(q1, kc, vc, L), n)
        del q1, kc, vc
        torch.cuda.empty_cache()
    # a host-paced step: yi-6b's long_500k decode step (32 layers, one
    # decode launch each, S 524,288), as the launch tools build it
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    cell = build_cell("yi-6b", "long_500k",
                      make_mesh((1, 1), ("data", "model"), devices=[dev]),
                      device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    out["yi6b_long_step_ms"] = events_ms(lambda: cell.fn(*cell.args), 5)
    del cell
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dec.decode_attention_cuda(dq, dk, dv, lengths)
    out["decode_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    if identity:
        out["identity"] = output_hashes(torch, fa, dec, dev)
    out["lib"] = lib_path
    out["ptxas"] = decode_ptxas(_attention.BUILD_LOG)
    return out


def decode_ptxas(log: str) -> dict:
    """ptxas's registers and spills of every decode kernel in a build's
    log, by the entry function's mangled name."""
    rows, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1) if "decode_" in m.group(1) else None
        elif name and ("registers" in ln or "spill" in ln):
            rows.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return rows


def device_ms(torch, fn, iters, tries=3):
    """Device time of a call of ``fn`` (torch.profiler, the kernels' time
    summed over ``iters`` calls after one untimed). A trace that holds no
    device time (the profiler missed the kernels: seen once in a run of
    several hundred) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    ms = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", 0) or 0
            if (not ev.key.startswith("ProfilerStep") and dev_us > 0
                    and "CUDA" in str(getattr(ev, "device_type", ""))):
                ms += (dev_us / ev.count * max(1, round(ev.count / iters))
                       / 1e3)
        if ms > 0:
            break
    return ms


def sweep_child(src: str) -> dict:
    """The tensor-core body's device time at every served bf16 decode
    shape up to width 256 over the splits of its planner's constants: by
    shape, {split: [constants that give it, ms]}."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _attention
    from repro_torch.kernels.decode_attention import decode_attention as dec
    _attention.build()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(1)
    bf = dict(generator=g, device=dev, dtype=torch.bfloat16)
    shapes = {"lm_serve": (8, 2064, 8, 4, 128),
              "moe_serve": (8, 2064, 8, 2, 64),
              "phi3": (8, 2064, 32, 1, 96), "gemma": (8, 2064, 1, 8, 256),
              "falcon": (8, 2064, 1, 71, 64), **G_SWEEP,
              "qwen15_long": (1, 524288, 16, 1, 64),
              "yi6b_long": (1, 524288, 4, 8, 128),
              "granite_long": (1, 524288, 8, 2, 64)}
    saved = (dec.TC_BLOCKS_PER_SM, dec.TC_MERGE_ROWS)
    out = {"planner": {"TC_BLOCKS_PER_SM": saved[0],
                       "TC_MERGE_ROWS": saved[1]}}
    for name, (B, S, KV, G, hd) in shapes.items():
        q = torch.randn((B, KV, G, hd), **bf)
        kc, vc = (torch.randn((B, S, KV, hd), **bf) for _ in range(2))
        L = torch.full((B,), min(S, 2049) if S < 100_000 else S,
                       dtype=torch.int32, device=dev)
        row = {"planned": dec.tc_plan(B, KV, G, S, n_sm, hd)[0]}
        for blocks in (1, 2, 4):
            for rows in (0, 10, 20, 40, 80):
                dec.TC_BLOCKS_PER_SM, dec.TC_MERGE_ROWS = blocks, rows
                dec._PLANS.clear()
                split = dec.tc_plan(B, KV, G, S, n_sm, hd)[0]
                if split not in row:
                    row[split] = [f"{blocks}x{rows}", device_ms(
                        torch, lambda: dec.decode_attention_cuda(q, kc, vc,
                                                                 L),
                        10 if S > 100_000 else 100)]
        dec.TC_BLOCKS_PER_SM, dec.TC_MERGE_ROWS = saved
        dec._PLANS.clear()
        out[name] = row
        del q, kc, vc
        torch.cuda.empty_cache()
    return out


def output_hashes(torch, fa, dec, dev) -> dict:
    """sha256 of both kernels' outputs a shape, on inputs drawn from one
    seed: the served shapes (flash at 8 x 2048, decode at a 2064-row cache
    with lengths 0, 1, 1000 and past S), every width 8..256 and hd 6 /
    100 at G 2, S 129, and hd 64 / 256 at G 71 and G 8, S 2064; f32 and
    bf16."""
    shapes = [(8, 2048, 8, 4, 128), (8, 2048, 8, 2, 64),
              (8, 2048, 32, 1, 96), (8, 2048, 1, 8, 256),
              (8, 2048, 1, 71, 64)]
    shapes += [(2, 129, 2, 2, hd) for hd in (*range(8, 257, 8), 6, 100)]
    shapes += [(2, 2064, 1, G, hd) for G in (71, 8) for hd in (64, 256)]
    shapes += [(2, 2064, 1, 4, 512)]
    uses_tc = getattr(dec, "uses_tc", None)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for B, S, KV, G, hd in shapes:
            g = torch.Generator(device=dev).manual_seed(B * S + G * hd)
            kw = dict(generator=g, device=dev)
            q = torch.randn((B, S, KV, G, hd), **kw).to(dt)
            k, v = (torch.randn((B, S, KV, hd), **kw).to(dt)
                    for _ in range(2))
            qd = torch.randn((B, KV, G, hd), **kw).to(dt)
            lengths = torch.tensor(([0, 1, 1000, S + 3] * B)[:B],
                                   dtype=torch.int32, device=dev)
            key = f"{str(dt)[6:]}_{B}x{S}x{KV}x{G}x{hd}"
            body = "tc" if uses_tc and uses_tc(dt, hd) else "simt"
            for part, outs in (
                    ("flash", (fa.flash_attention_cuda(q, k, v, causal=True),
                               fa.flash_attention_cuda(q, k, v,
                                                       causal=False))),
                    (f"decode_{body}",
                     dec.decode_attention_cuda(qd, k, v, lengths))):
                h = hashlib.sha256()
                for t in outs:
                    h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                             .tobytes())
                out[f"{key}_{part}"] = h.hexdigest()[:16]
    return out


def built_library(src: str) -> str:
    """The attention library of the checkout whose ``src`` this is, built
    in a child process (one nvcc per source)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _attention; "
            "print('LIB' + _attention.build())")
    out = subprocess.run([sys.executable, "-c", code, src],
                         capture_output=True, text=True, check=True,
                         timeout=900).stdout
    return out.rsplit("LIB", 1)[1].strip()


def sass_of(lib: str) -> dict:
    """The SASS of every attention kernel (flash and decode) in a built
    library, by mangled function name with the anonymous namespace's
    per-file tag taken out (it changes with the file's contents),
    ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                          "ANON", m.group(1))
            funcs[name] = []
        elif name and ("flash_fwd" in name or "decode_" in name):
            funcs[name].append(ln.strip())
    return {k: "\n".join(v) for k, v in funcs.items()
            if "flash_fwd" in k or "decode_" in k}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="src directory of the other checkout")
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--identity", action="store_true",
                    help="also hash both kernels' outputs and compare sides")
    ap.add_argument("--sass", action="store_true",
                    help="also compare the attention kernels' SASS")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the change's tensor-core decode body "
                         "over its planner's constants")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = (sweep_child(args.child) if args.sweep
               else child(args.child, args.identity))
        print("RESULT" + json.dumps(res), flush=True)
        return 0
    srcs = {"P": os.path.abspath(args.parent),
            "C": os.path.join(ROOT, "src")}
    runs = {"P": [], "C": []}
    ids = {"P": [], "C": []}
    libs = {}
    for side in args.order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", srcs[side]]
                              + ["--identity"] * args.identity,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.split("RESULT", 1)[1])
        hashes = res.pop("identity", None)
        libs[side] = res.pop("lib")
        ptxas = res.pop("ptxas")
        if not runs[side]:
            print(json.dumps({"side": side, "decode_ptxas": ptxas}),
                  flush=True)
        runs[side].append(res)
        print(json.dumps({"side": side, **res}), flush=True)
        if hashes is not None:
            ids[side].append(hashes)
    if args.order:
        print(json.dumps({side: {key: statistics.median(r[key] for r in rs)
                                 for key in rs[0]}
                          for side, rs in runs.items() if rs}), flush=True)
    rc = 0
    if args.identity and ids["P"] + ids["C"]:
        # the keys both sides hashed: every flash output, and the decode
        # outputs both sides gave through the SIMT body
        every = ids["P"] + ids["C"]
        common = sorted(set.intersection(*(set(h) for h in every)))
        differ = [key for key in common
                  if any(h[key] != every[0][key] for h in every)]
        print(json.dumps({"identity_outputs": len(common),
                          "tc_outputs_not_compared": sorted(
                              {k for h in ids["C"] for k in h
                               if k.endswith("decode_tc")}),
                          "differing": differ}), flush=True)
        rc = 1 if differ else 0
    if args.sass:
        sp, sc = (sass_of(libs.get(side) or built_library(srcs[side]))
                  for side in "PC")
        print(json.dumps({
            "sass_kernels": {"P": len(sp), "C": len(sc)},
            "sass_same": sorted(k for k in sp if sc.get(k) == sp[k]),
            "sass_differ": sorted(k for k in sp if k in sc
                                  and sc[k] != sp[k]),
            "sass_only_P": sorted(set(sp) - set(sc)),
            "sass_only_C": sorted(set(sc) - set(sp))}), flush=True)
    if args.sweep:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", srcs["C"], "--sweep"],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(json.dumps({"sweep": json.loads(
            proc.stdout.split("RESULT", 1)[1])}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
