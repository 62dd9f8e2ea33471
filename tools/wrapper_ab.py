"""Time the port's kernel wrappers of two checkouts on one card, in turns.

    python3 tools/wrapper_ab.py --parent DIR [--order PCCP] [--identity]

DIR is the ``src`` directory of another checkout (an earlier commit
unpacked with ``git archive`` into a git-ignored directory such as
``tmp/parent``); this checkout's ``src`` is the change. Each letter of
``--order`` starts one child process (P the parent, C the change), which
builds that checkout's kernels, draws the inputs from one seed on the
card and times each wrapper by CUDA events over a run of launches:
``arena_scan_cuda`` at the prod cell's shape (2^23 x 768 rows, 32 query
rows in 4 groups, k = 10) resident and paged (pages of 2^15 rows),
``flash_attention_cuda`` at lm_serve's prefill (B 8, S 2048, KV 8, G 4,
hd 128, bf16) and moe_serve's (G 2, hd 64) and ``decode_attention_cuda``
at their decode steps (cache 2064, 2049 live), both at wide_serve's
three attention widths (Phi-3-mini: KV 32, G 1, hd 96; Gemma-2B: KV 1,
G 8, hd 256; Falcon-7B: KV 1, G 71, hd 64), with the decode wrapper's
host time a call at lm_serve's (200 calls queued, no sync inside). Prints
one JSON line a child, then the median of each side. The children run
one after the other, so the two sides share the card, its clocks and its
power limit. ``--identity`` also has each child hash both kernels'
outputs, bit for bit, on seeded inputs at every shape above, at every
width 8..256 and hd 6 / 100 (G 2, S 129) and at G 71 / 8 (S 2064, hd 64
/ 256) in both dtypes, and checks that both sides' hashes agree.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(src: str, identity: bool) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _attention
    from repro_torch.kernels.arena_scan import kernel
    from repro_torch.kernels.decode_attention import decode_attention as dec
    from repro_torch.kernels.flash_attention import flash_attention as fa
    kernel.build()
    _attention.build()
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
    for name, (q, k, v, q1, kc, vc) in wide_in.items():
        out[f"flash_{name}_ms"] = events_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True), 10)
        out[f"decode_{name}_ms"] = events_ms(
            lambda: dec.decode_attention_cuda(q1, kc, vc, lengths), 200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dec.decode_attention_cuda(dq, dk, dv, lengths)
    out["decode_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    if identity:
        out["identity"] = output_hashes(torch, fa, dec, dev)
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
            h = hashlib.sha256()
            for t in (fa.flash_attention_cuda(q, k, v, causal=True),
                      fa.flash_attention_cuda(q, k, v, causal=False),
                      *dec.decode_attention_cuda(qd, k, v, lengths)):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            out[f"{str(dt)[6:]}_{B}x{S}x{KV}x{G}x{hd}"] = h.hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="src directory of the other checkout")
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--identity", action="store_true",
                    help="also hash both kernels' outputs and compare sides")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT" + json.dumps(child(args.child, args.identity)),
              flush=True)
        return 0
    srcs = {"P": os.path.abspath(args.parent),
            "C": os.path.join(ROOT, "src")}
    runs = {"P": [], "C": []}
    ids = {"P": [], "C": []}
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
        runs[side].append(res)
        print(json.dumps({"side": side, **res}), flush=True)
        if hashes is not None:
            ids[side].append(hashes)
    print(json.dumps({side: {key: statistics.median(r[key] for r in rs)
                             for key in rs[0]}
                      for side, rs in runs.items() if rs}), flush=True)
    if args.identity:
        first = (ids["P"] + ids["C"])[0]
        differ = sorted({key for h in ids["P"] + ids["C"] for key in first
                         if h[key] != first[key]})
        print(json.dumps({"identity_shapes": len(first),
                          "differing": differ}), flush=True)
        return 1 if differ else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
