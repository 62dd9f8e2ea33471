#!/usr/bin/env python3
"""Build variants of the bf16 flash kernel and time them at wide head dims
on one card, in turns.

    python3 tools/flash_width_probe.py [--variants checkout,kn64+general]
                                       [--shapes gemma-2b,gpt-j,...]

Each variant is a copy of ``src/repro_torch/csrc``'s attention sources
with switches changed (``VARIANTS``; ``a+b`` applies both), built by
`_nvcc.build` into ``src/repro_torch/build/`` beside the checkout's
library:

  checkout  the checkout's kernel
  kn64      64-key tiles at every width (the checkout takes 32 past 128:
            a consumer then holds 16 score and 8 P registers instead of 32
            and 16 beside its HD / 2 accumulators)
  general   no EXACT instantiation: hd, the head chunk and the chunk count
            are runtime arguments at every shape
  regs40    40 registers for the producer warpgroup and 232 for the
            consumers (setmaxnreg) instead of 24 and 240

It prints ptxas's registers, stack and spills of every bf16 flash
instantiation of each variant, then for each shape (B, S, KV, G, hd) the
kernel's CUDA-event ms a call of each variant, measured in the order
v1 .. vn vn .. v1 (20 calls after 3 warm-ups each time), the variants'
outputs checked against the plain version (`flash_attention_plain`) within
the flash tolerance, and the card's name and power limit. Exits 2 without
a card.
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

VARIANTS = {
    "checkout": (),
    "kn64": (("constexpr int key_tile(int HD) { return HD > 128 ? 32 : 64; }",
              "constexpr int key_tile(int HD) { return 64; }"),),
    "general": (("  return hd == HD && n_gc == 1;\n",
                 "  return false;\n"),),
    "regs40": (("kProducerRegs = 24, kConsumerRegs = 240",
                "kProducerRegs = 40, kConsumerRegs = 232"),),
}
#: (B, S, KV, G, hd) of a prefill layer at published attention widths
SHAPES = {
    "gemma-2b": (8, 2048, 1, 8, 256),
    "gpt-j": (8, 2048, 16, 1, 256),
    "width-192": (8, 2048, 8, 1, 192),
    "phi-3-mini": (8, 2048, 32, 1, 96),
    "qwen3-4b": (8, 2048, 8, 4, 128),
    "granite-moe": (8, 2048, 8, 2, 64),
}
FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3
SOURCES = ("attention.cuh", "flash_attention.cu", "decode_attention.cu")


def build(variant: str) -> tuple[str, str]:
    """The variant's library (path, nvcc log), its sources patched copies
    of the checkout's."""
    from repro_torch.kernels import _nvcc
    d = os.path.join(_nvcc.BUILD_DIR, f"probe-{variant.replace('+', '-')}")
    os.makedirs(d, exist_ok=True)
    for name in SOURCES:
        with open(os.path.join(_nvcc.CSRC, name)) as f:
            text = f.read()
        if name == "flash_attention.cu":
            for old, new in (pair for part in variant.split("+")
                             for pair in VARIANTS[part]):
                if text.count(old) != 1:
                    raise SystemExit(f"{variant}: {old!r} not found once")
                text = text.replace(old, new)
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    paths = [os.path.join(d, name) for name in SOURCES]
    return _nvcc.build(f"attention-{variant.replace('+', '-')}", paths[:1],
                       paths[1:])


def ptxas_rows(log: str) -> list[dict]:
    """Registers, stack and spills of each bf16 flash instantiation."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)E", ln)
        if m and "Compiling entry" in ln:
            cur = {"width": int(m.group(1)), "key_tile": int(m.group(2))}
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
    return sorted(rows, key=lambda r: r["width"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default="checkout,kn64,general")
    p.add_argument("--shapes", default=",".join(SHAPES))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_width_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _attention
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

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in args.shapes.split(","):
        B, S, KV, G, hd = SHAPES[name]
        q = torch.randn(B, S, KV, G, hd, generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn(B, S, KV, hd, generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        want = fa.flash_attention_plain(q, k, v, causal=True, blk_q=512,
                                        blk_k=512).float()
        ms = {v_: [] for v_ in variants}
        ratio = {}
        for v_ in variants + variants[::-1]:
            _attention._lib = libs[v_]
            got = fa.flash_attention_cuda(q, k, v).float()
            err = (got - want).abs() / (FLASH_ATOL + FLASH_RTOL * want.abs())
            ratio[v_] = max(ratio.get(v_, 0.0), float(err.max()))
            for _ in range(3):
                fa.flash_attention_cuda(q, k, v)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(20):
                fa.flash_attention_cuda(q, k, v)
            end.record()
            torch.cuda.synchronize()
            ms[v_].append(start.elapsed_time(end) / 20)
        print(json.dumps({"shape": name, "B_S_KV_G_hd": [B, S, KV, G, hd],
                          "ms_in_turns": ms, "x_tolerance": ratio,
                          "card": card[0]}), flush=True)
        if max(ratio.values()) > 1:
            print(f"flash_width_probe: a variant is off the plain version "
                  f"at {name}: {ratio}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
