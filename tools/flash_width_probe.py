#!/usr/bin/env python3
"""Build variants of the bf16 flash kernel and time them at wide head dims
on one card, in turns.

    python3 tools/flash_width_probe.py [--variants checkout,kn64+general]
                                       [--shapes gemma-2b,falcon-7b,...]
                                       [--sass] [--parent DIR]

Each variant is a copy of ``src/repro_torch/csrc``'s attention sources
with switches changed (``VARIANTS``; ``a+b`` applies both), built by
`_nvcc.build` into ``src/repro_torch/build/`` beside the checkout's
library (with ``-lineinfo``, which adds line tables and leaves the code
as it is):

  checkout  the checkout's kernel
  kn32      32-key tiles past width 128 (the one-block-a-tile grid's)
  kn64      64-key tiles at every width (128 at widths 64 to 128)
  blocks    one block a unit (a one-block-a-tile grid) instead of one
            persistent block an SM
  ungrouped the units heaviest first over all (kv, b) pairs at once at
            every shape
  grouped   the units in groups of 8 MB of K and V at every shape
  pairs     groups of one (kv, b) pair (the one-block-a-tile grid's
            order; blocks+pairs is that grid's schedule)
  general   no EXACT instantiation: hd, the head chunk and the chunk count
            are runtime arguments at every shape
  regs24    24 registers for the producer warpgroup and 240 for the
            consumers (setmaxnreg) instead of 40 and 232

and ``parent``, the attention sources of the checkout whose ``src`` is
``--parent DIR`` as they are (an earlier commit unpacked with ``git
archive``), launched through this checkout's wrapper. Three variants only
time a part of the kernel. Their outputs are
wrong by design and are NOT checked (the tool prints ``"unchecked"`` for
them):

  noexp     the softmax's p = exp2(s c - m) is the FMA s c - m alone (no
            ex2 on the special-function unit; the alphas keep theirs)
  nopv      O += P . V is not issued (an empty wgmma group in its place)
  onetile   every unit walks one key tile: the time of the units' fixed
            cost (Q, the ring's first tile, the epilogue; one block a
            unit: the launch and the barriers too) at the real schedule

It prints ptxas's registers, stack and spills of every bf16 flash
instantiation of each variant; with ``--sass`` also, from the SASS
(``cuobjdump -xelf`` and ``nvdisasm -g``), each instantiation's highest
register index, its spill stores and loads (STL / LDL) with the source
line each comes from, and whether its code holds a ``USETMAXREG``. Then,
for each shape (B, S, KV, G, hd), a reckoning from the wrapper's own
rules (`_attention.launch_width`, `flash_attention.key_tile`,
`head_chunks`): blocks, rows in use a tile, key tiles walked, the bytes
wgmma reads from shared memory a key tile, the K and V bytes a block
loads through L2 a tile and in all, the exponentials and the products;
and the kernel's CUDA-event ms a call of each variant, measured in the
order v1 .. vn vn .. v1 (20 calls after 3 warm-ups each time), the
checked variants' outputs held to the plain version
(`flash_attention_plain`) within the flash tolerance, with the card's name
and power limit. Exits 2 without a card, 1 when a checked variant is off
the plain version.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: variant -> ((regex, replacement), ...) over flash_attention.cu; each
#: pattern must match at least once
VARIANTS = {
    "checkout": (),
    "kn32": ((r"constexpr int key_tile\(int HD\) \{ return [^;]*; \}",
              "constexpr int key_tile(int HD) "
              "{ return HD > 128 ? 32 : 64; }"),),
    "kn64": ((r"constexpr int key_tile\(int HD\) \{ return [^;]*; \}",
              "constexpr int key_tile(int HD) { return 64; }"),),
    "blocks": ((r"const int n_blocks = plan\.n_units < n_sm \? "
                r"plan\.n_units : n_sm;",
                "const int n_blocks = plan.n_units;"),),
    "ungrouped": ((r"constexpr long long kL2All = [^;]*;",
                   "constexpr long long kL2All = 1LL << 62;"),),
    "grouped": ((r"constexpr long long kL2All = [^;]*;",
                 "constexpr long long kL2All = 0;"),),
    "pairs": ((r"constexpr long long kL2All = [^;]*;",
               "constexpr long long kL2All = 0;"),
              (r"constexpr int kL2Group = [^;]*;",
               "constexpr int kL2Group = 1;")),
    "general": ((r"  return hd == HD && n_gc == 1;\n", "  return false;\n"),),
    "regs24": ((r"kUnitProducerRegs = 40, kUnitConsumerRegs = 232",
                "kUnitProducerRegs = 24, kUnitConsumerRegs = 240"),),
    "noexp": ((r"tma::fast_exp2\((fmaf\(sc\[j\], scale_log2,[^;]*\))\);",
               r"\1;"),),
    "nopv": ((r"issue_pv<HD, KN>\(acc, pa, [^;]*\);",
              "wgmma_commit();"),),
    "onetile": ((r"un\.n_tiles = lo;", "un.n_tiles = 1;"),),
}
#: variants whose outputs are wrong by design: timed, never checked
TIMING_ONLY = ("noexp", "nopv", "onetile")
#: (B, S, KV, G, hd) of a prefill layer at published attention widths
SHAPES = {
    "gemma-2b": (8, 2048, 1, 8, 256),
    "falcon-7b": (8, 2048, 1, 71, 64),
    "phi-3-mini": (8, 2048, 32, 1, 96),
    "qwen3-4b": (8, 2048, 8, 4, 128),
    "gpt-j": (8, 2048, 16, 1, 256),
    "width-192": (8, 2048, 8, 1, 192),
    "granite-moe": (8, 2048, 8, 2, 64),
}
FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3
SOURCES = ("attention.cuh", "flash_attention.cu", "decode_attention.cu")
KERNEL_RE = r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)E"


def build(variant: str, parent: str | None = None) -> tuple[str, str]:
    """The variant's library (path, nvcc log), its sources patched copies
    of the checkout's (``parent``: the other checkout's, as they are)."""
    from repro_torch.kernels import _nvcc
    d = os.path.join(_nvcc.BUILD_DIR, f"probe-{variant.replace('+', '-')}")
    os.makedirs(d, exist_ok=True)
    csrc = (os.path.join(parent, "repro_torch", "csrc")
            if variant == "parent" else _nvcc.CSRC)
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        if name == "flash_attention.cu" and variant != "parent":
            for old, new in (pair for part in variant.split("+")
                             for pair in VARIANTS[part]):
                text, n = re.subn(old, new, text)
                if n == 0:
                    raise SystemExit(f"{variant}: {old!r} not found")
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    paths = [os.path.join(d, name) for name in SOURCES]
    return _nvcc.build(f"attention-{variant.replace('+', '-')}", paths[:1],
                       paths[1:])


def ptxas_rows(log: str) -> list[dict]:
    """Registers, stack and spills of each bf16 flash instantiation."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(KERNEL_RE + r"(\w*)", ln)
        if m and "Compiling entry" in ln:
            cur = {"width": int(m.group(1)), "key_tile": int(m.group(2)),
                   "name": m.group(0)}
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
    return sorted(rows, key=lambda r: (r["width"], r["name"]))


def sass_report(lib: str) -> list[dict]:
    """From the SASS of each bf16 flash instantiation in ``lib``: the
    highest register index, STL / LDL with the source line of each
    (nvdisasm's line table), and whether it holds USETMAXREG."""
    cuda_bin = os.path.dirname(shutil.which("nvcc") or
                               "/usr/local/cuda/bin/nvcc")
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([os.path.join(cuda_bin, "cuobjdump"), "-xelf", "all",
                        lib], cwd=tmp, capture_output=True, check=True)
        for cubin in glob.glob(os.path.join(tmp, "*.cubin")):
            text = subprocess.run([os.path.join(cuda_bin, "nvdisasm"), "-g",
                                   "-c", cubin], capture_output=True,
                                  text=True, check=False).stdout
            name, line = None, None
            for ln in text.splitlines():
                m = re.match(r"\s*\.text\.(\S+):", ln)
                if m:
                    name = m.group(1) if re.search(KERNEL_RE, m.group(1)) \
                        else None
                    if name:
                        row = {"name": name, "max_register": -1,
                               "spills": {}, "setmaxreg": False}
                        out.append(row)
                    continue
                if name is None:
                    continue
                m = re.search(r'//## File "([^"]*)", line (\d+)', ln)
                if m:
                    line = f"{os.path.basename(m.group(1))}:{m.group(2)}"
                    continue
                for r in re.findall(r"\bR(\d+)\b", ln):
                    row["max_register"] = max(row["max_register"], int(r))
                if "USETMAXREG" in ln:
                    row["setmaxreg"] = True
                m = re.search(r"\b(STL|LDL)(\.\w+)*\b", ln)
                if m:
                    key = f"{m.group(1)} {line}"
                    row["spills"][key] = row["spills"].get(key, 0) + 1
    return sorted(out, key=lambda r: r["name"])


def reckon(B, S, KV, G, hd) -> dict:
    """The bf16 kernel's work at a shape, from the wrapper's own rules."""
    import torch
    from repro_torch.kernels import _attention
    from repro_torch.kernels.flash_attention import flash_attention as fa
    width, _ = _attention.launch_width(torch.bfloat16, hd)
    kn = fa.key_tile(width)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(fa, "work_units"):       # the persistent schedule
        units = fa.work_units(S, KV, G, hd, B)
        tiles = sum(u.n_tiles for u in units)
        blocks = min(len(units), n_sm)
        rows_used = fa.tile_rows(G)
    else:                               # a block a (q tile, chunk, kv, b)
        gc, n_gc = fa.head_chunks(G)
        bq = fa.TILE_ROWS // gc
        units = [(min(S, q0 + bq) - 1) // kn + 1
                 for q0 in range(0, S, bq)] * n_gc * KV * B
        tiles = sum(units)
        blocks = len(units)
        rows_used = bq * gc
    # wgmma's shared-memory reads a key tile: both consumers' Q (64 rows x
    # width each), K and V (kn x width) once each a consumer
    smem_tile = 2 * (64 * width * 2 + 2 * kn * width * 2)
    kv_tile = 2 * kn * hd * 2              # K and V of a tile through L2
    pairs = B * KV * G * S * (S + 1) // 2  # causal (query, key) pairs
    return {"blocks": blocks, "units": len(units),
            "units_per_block": len(units) / blocks,
            "rows_in_use_a_tile": rows_used,
            "width": width, "key_tile": kn, "key_tiles_walked": tiles,
            "key_tiles_a_unit": tiles / len(units),
            "smem_read_bytes_a_tile": smem_tile,
            "smem_read_bytes_a_key": smem_tile / kn,
            "l2_kv_bytes_a_tile": kv_tile, "l2_kv_gb": tiles * kv_tile / 1e9,
            "exponentials": pairs, "gflop": 4 * hd * pairs / 1e9,
            "gflop_at_width": 4 * width * pairs / 1e9,
            "row_slots_walked": tiles * fa.TILE_ROWS * kn}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default="checkout,kn64,general")
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--sass", action="store_true")
    p.add_argument("--parent", help="src directory of another checkout: "
                                    "variant 'parent' is its library, "
                                    "launched through this checkout's "
                                    "wrapper (the C interface is one)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_width_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _attention, _nvcc
    from repro_torch.kernels.flash_attention import flash_attention as fa
    _nvcc.NVCC_FLAGS = [*_nvcc.NVCC_FLAGS, "-lineinfo"]
    variants = args.variants.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(card[0], flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda v: build(v, args.parent), variants)))
    for v in variants:
        row = {"variant": v, "ptxas": ptxas_rows(built[v][1])}
        if args.sass and v in ("parent", "checkout", "kn64", "regs24"):
            row["sass"] = sass_report(built[v][0])
        print(json.dumps(row), flush=True)
    libs = {}
    for v in variants:
        _attention._lib = None
        _attention.build = lambda path=built[v][0]: path
        libs[v] = _attention.load()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = []
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
            if v_.split("+")[0] in TIMING_ONLY or any(
                    part in TIMING_ONLY for part in v_.split("+")):
                ratio[v_] = "unchecked"
            else:
                err = (got - want).abs() / (FLASH_ATOL
                                            + FLASH_RTOL * want.abs())
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
                          "reckoning": reckon(B, S, KV, G, hd),
                          "ms_in_turns": ms, "x_tolerance": ratio,
                          "card": card[0]}), flush=True)
        if any(r != "unchecked" and r > 1 for r in ratio.values()):
            bad.append(name)
        del q, k, v, want
        torch.cuda.empty_cache()
    if bad:
        print(f"flash_width_probe: a variant is off the plain version at "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
