#!/usr/bin/env python3
"""Build variants of both attention kernels' handling of rows past 256
columns and time them on one card, in turns.

    python3 tools/deep_width_probe.py [--variants checkout,pieces256,...]
                                      [--flash 320,512,...] [--decode ...]

Past 256 a row runs as column pieces (`_attention.row_pieces`), each a
block that scores with the whole row and writes its own columns. Each
variant is a copy of ``src/repro_torch/csrc``'s attention sources with
one decision changed, built by `_nvcc.build` into
``src/repro_torch/build/`` beside the checkout's library:

  checkout   the checkout's rule: bf16 pieces of at most 128 columns
             (width 128, 64-key tiles), f32 of at most 256
  pieces192  bf16 pieces of at most 192 (widths 128 or 192)
  pieces256  bf16 pieces of at most 256 (widths 192 or 256, 32-key tiles)
  streamed   the bf16 flash body never keeps Q resident: Q and K stream
             through the score ring in 64-column chunks at every hd

While a variant runs, the Python rule's bf16 cap (`_attention.PIECE_MAX`)
is set to the variant's, so the decode wrapper sizes its split and
workspace for the same pieces. It prints ptxas's registers, stack and
spills of every instantiation built for rows past 256, then for each
flash shape (B 8, S 2048, KV 1, bf16 and at hd 512 f32 too) and each
decode shape (B 8, a 2064-row cache, 2049 live, bf16) the CUDA-event ms a
call of each variant, measured in the order v1 .. vn vn .. v1 (after 3
warm-ups each time), each output held to its plain version within the
tolerance of ``chip_smoke.py`` (flash rtol 1e-2 / atol 8e-3, decode
2e-5), and the card's name and power limit. Exits 2 without a card, 1
when a variant is off its plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

_CAP = "inline int piece_max(int dtype) { return dtype == kBF16 ? 128 : 256; }"
_DEEP_WIDTH = "  return sizeof(T) == 2 ? HD == 128 : HD >= 192;"
_BF16_LAUNCH = "  constexpr int HD = 128, KN = 64;\n"


def _bf16_widths(widths):
    """The bf16 flash launch of a row past 256 at each of ``widths``."""
    cases = "".join(
        f"    case {w}: return deep_bf16_at<{w}>(q, k, v, o, B, S, KV, G, "
        f"hd, hd_scale, causal, st);\n" for w in widths)
    return (
        "int launch_deep_bf16(const void* q, const void* k, const void* v, "
        "void* o,\n",
        "template <int HD>\nint deep_bf16_at(const void* q, const void* k, "
        "const void* v, void* o,\n"), (
        _BF16_LAUNCH, "  constexpr int KN = HD > 128 ? 32 : 64;\n"), (
        "// `deep_resident` picks QRES wherever it fits.\n",
        "// `deep_resident` picks QRES wherever it fits.\n"
        "template <int HD>\nint deep_bf16_at(const void*, const void*, "
        "const void*, void*, int, int, int, int, int, int, int, "
        "cudaStream_t);\n"
        "int launch_deep_bf16(const void* q, const void* k, const void* v, "
        "void* o, int B, int S, int KV, int G, int hd, int hd_scale, "
        "int causal, cudaStream_t st) {\n"
        "  switch (attn::launch_width(attn::kBF16, hd)) {\n" + cases +
        "    default: return static_cast<int>(cudaErrorInvalidValue);\n"
        "  }\n}\n")


#: variant -> {source: ((old, new), ...)}; bf16 caps by variant
VARIANTS = {
    "checkout": {},
    "pieces192": {
        "attention.cuh": ((_CAP, _CAP.replace("? 128", "? 192")),),
        "flash_attention.cu": _bf16_widths((128, 192)),
        "decode_attention.cu": ((_DEEP_WIDTH, _DEEP_WIDTH.replace(
            "HD == 128", "HD == 128 || HD == 192")),)},
    "pieces256": {
        "attention.cuh": ((_CAP, _CAP.replace("? 128", "? 256")),),
        "flash_attention.cu": _bf16_widths((192, 256)),
        "decode_attention.cu": ((_DEEP_WIDTH, _DEEP_WIDTH.replace(
            "HD == 128", "HD >= 192")),)},
    "streamed": {
        "flash_attention.cu": ((
            "  return DeepLayout<HD, KN, true>::smem((hd + 63) / 64) <=",
            "  return false && DeepLayout<HD, KN, true>::smem((hd + 63) / 64)"
            " <="),)},
}
BF16_CAP = {"checkout": 128, "pieces192": 192, "pieces256": 256,
            "streamed": 128}
#: flash (G, hd) at B 8, S 2048, KV 1; decode (G, hd) at B 8, 2064 rows
FLASH = {320: 4, 512: 4, 640: 4, 1024: 2, 2048: 1}
DECODE = {320: 4, 512: 4, 640: 4, 1024: 2, 2048: 1}
FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3
DEC_TOL = 2e-5
SOURCES = ("attention.cuh", "flash_attention.cu", "decode_attention.cu")


def build(variant: str) -> tuple[str, str]:
    """The variant's library (path, nvcc log), its sources patched copies
    of the checkout's."""
    from repro_torch.kernels import _nvcc
    d = os.path.join(_nvcc.BUILD_DIR, f"deep-probe-{variant}")
    os.makedirs(d, exist_ok=True)
    for name in SOURCES:
        with open(os.path.join(_nvcc.CSRC, name)) as f:
            text = f.read()
        for old, new in VARIANTS[variant].get(name, ()):
            if text.count(old) != 1:
                raise SystemExit(f"{variant}: {old!r} not found once")
            text = text.replace(old, new)
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    paths = [os.path.join(d, name) for name in SOURCES]
    return _nvcc.build(f"attention-deep-{variant}", paths[:1], paths[1:])


def ptxas_rows(log: str) -> list[dict]:
    """Registers, stack and spills of each instantiation for rows past 256
    (the bf16 flash body of pieces, the f32 body's and decode's DEEP)."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            cur = None
            if "flash_fwd_deep_kernel" in name or re.search(
                    r"(flash_fwd_kernel|decode_attention_kernel)I.*Lb0ELb1E",
                    name):
                cur = {"kernel": re.search(r"\d+(\w+?_kernel)I", name)
                       .group(1), "template": re.findall(r"L[ib](\d+)E",
                                                         name)}
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--flash", default=",".join(map(str, FLASH)))
    p.add_argument("--decode", default=",".join(map(str, DECODE)))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("deep_width_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _attention
    from repro_torch.kernels.decode_attention import decode_attention as dec
    from repro_torch.kernels.flash_attention import flash_attention as fa
    variants = args.variants.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(card[0], flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(build, variants)))
    for v in variants:
        print(json.dumps({"variant": v, "ptxas": ptxas_rows(built[v][1])}),
              flush=True)
    libs = {}
    for v in variants:
        _attention._lib = None
        _attention.build = lambda path=built[v][0]: path
        libs[v] = _attention.load()

    def use(v):
        _attention._lib = libs[v]
        _attention.PIECE_MAX[torch.bfloat16] = BF16_CAP[v]
        dec._PLANS.clear()

    def timed(fn, iters):
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    cases = [("flash", torch.bfloat16, int(hd)) for hd in
             args.flash.split(",") if hd]
    cases += [("flash", torch.float32, 512)] if "512" in args.flash else []
    cases += [("decode", torch.bfloat16, int(hd)) for hd in
              args.decode.split(",") if hd]
    for kind, dt, hd in cases:
        G = (FLASH if kind == "flash" else DECODE)[hd]
        kw = dict(generator=gen, device=dev)
        if kind == "flash":
            q = torch.randn(8, 2048, 1, G, hd, **kw).to(dt)
            k, v = (torch.randn(8, 2048, 1, hd, **kw).to(dt)
                    for _ in range(2))
            want = fa.flash_attention_plain(q, k, v, causal=True, blk_q=512,
                                            blk_k=512).float()
            call = lambda: fa.flash_attention_cuda(q, k, v)  # noqa: E731
            tol = (FLASH_RTOL, FLASH_ATOL)
        else:
            q = torch.randn(8, 1, G, hd, **kw).to(dt)
            k, v = (torch.randn(8, 2064, 1, hd, **kw).to(dt)
                    for _ in range(2))
            lengths = torch.full((8,), 2049, dtype=torch.int32, device=dev)
            a, _, l = dec.decode_attention_plain(q, k, v, lengths)
            want = a / l
            call = lambda: (lambda o: o[0] / o[2])(  # noqa: E731
                dec.decode_attention_cuda(q, k, v, lengths))
            tol = (DEC_TOL, DEC_TOL)
        ms = {v_: [] for v_ in variants}
        ratio = {}
        for v_ in variants + variants[::-1]:
            use(v_)
            got = call().float()
            err = (got - want).abs() / (tol[1] + tol[0] * want.abs())
            ratio[v_] = max(ratio.get(v_, 0.0), float(err.max()))
            ms[v_].append(timed(call, 10 if kind == "flash" else 100))
        worst = max(worst, *ratio.values())
        print(json.dumps({"kernel": kind, "dtype": str(dt)[6:],
                          "B_S_KV_G_hd": [8, 2048 if kind == "flash" else
                                          2064, 1, G, hd],
                          "ms_in_turns": ms, "x_tolerance": ratio,
                          "card": card[0]}), flush=True)
    use("checkout")
    if worst > 1:
        print("deep_width_probe: a variant is off its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
