"""Roofline analysis of the dry run's cells on the H100 (port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds:
  compute    = per_device_FLOPs / PEAK_FLOPS     (989 TFLOP/s dense bf16)
  memory     = per_device_bytes / HBM_BW         (3.35 TB/s)
  collective = per_device_collective_bytes / LINK_BW   (450 GB/s NVLink,
                                                        each way)

The constants are NVIDIA's H100 SXM data sheet values (one card). The
reference corrects XLA's cost analysis, which counts a while-loop body
once, by measuring 1- and 2-layer variants of every LM cell. The port's
count (``launch/dryrun.py``, `launch._cost`) runs the layers as an eager
Python loop, so every layer's ops are counted; `corrected_cell` measures
no variants and marks LM entries ``corrected: True`` with ``raw_flops`` =
``flops``. (The identity the correction rests on, c(L) = c(1) + (L - 1)
(c(2) - c(1)), holds exactly for the port's count: its tests check it.)

  PYTHONPATH=src python -m repro_torch.launch.roofline       # results/torch_roofline.json
  PYTHONPATH=src python -m repro_torch.launch.roofline --markdown
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import ARCHS, get
from repro_torch.launch.dryrun import (MESH_NAMES, RESULTS, measure,
                                       production_mesh)
from repro_torch.launch.steps import build_cell

# NVIDIA H100 SXM data sheet values (per card)
PEAK_FLOPS = 989e12        # dense bf16 tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4, each way
HBM_PER_CHIP = 80e9        # bytes

DEFAULT_OUT = "torch_roofline.json"


def _measure(arch_id, shape_name, mesh, cfg_override=None,
             trace_cache: dict | None = None):
    cell = build_cell(arch_id, shape_name, mesh, cfg_override=cfg_override)
    m = measure(cell, mesh, trace_cache)
    cost, n = m["cost"], m["n_dev"]
    return {
        "flops": cost.flops / n,
        "bytes": cost.bytes / n,
        "coll": float(sum(m["coll"].values())),
        "coll_by_kind": m["coll"],
        "temp_bytes": -(-cost.peak_bytes // n),
        "args_bytes": m["args_bytes"],
        "model_flops": cell.model_flops,
        "model_bytes": cell.model_bytes,
        "note": cell.note,
    }


def corrected_cell(arch_id, shape_name, mesh_name, mesh, cache,
                   base_cfg=None, trace_cache: dict | None = None):
    """Measure a cell; cache keyed for reuse. base_cfg overrides arch.full
    (perf-iteration variants). The port's count covers every layer (an
    eager loop: no body is counted once), so an LM entry needs no 1- and
    2-layer variants: it is marked ``corrected`` with ``raw_flops`` equal
    to ``flops``."""
    key = f"{arch_id}|{shape_name}|{mesh_name}"
    if key in cache:
        return cache[key]
    arch = get(arch_id)
    if base_cfg is not None:
        arch = dataclasses.replace(arch, full=base_cfg)
    out = _measure(arch_id, shape_name, mesh, cfg_override=base_cfg,
                   trace_cache=trace_cache)
    out["corrected"] = False
    if arch.family == "lm":
        out["corrected"] = True
        out["raw_flops"] = out["flops"]
    cache[key] = out
    return out


def analyze(entry, n_chips: int) -> dict:
    """The reference's arithmetic with the H100's constants. One bf16 peak
    serves every cell, as in the reference's contract: an f32 cell's
    compute term is then optimistic (f32 runs on the CUDA cores at a
    fraction of that rate)."""
    t_compute = entry["flops"] / PEAK_FLOPS
    t_memory = entry["bytes"] / HBM_BW
    t_coll = entry["coll"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = entry["model_flops"] / max(entry["flops"] * n_chips, 1.0)
    # roofline fraction: ideal step time (whichever physical limit binds the
    # USEFUL work -- tensor-core peak for compute-heavy cells, HBM stream of
    # the minimal working set for memory-bound cells) vs. the dominant-term
    # bound
    ideal_c = entry["model_flops"] / (n_chips * PEAK_FLOPS)
    ideal_m = entry.get("model_bytes", 0.0) / (n_chips * HBM_BW)
    ideal = max(ideal_c, ideal_m)
    frac = ideal / bound if bound > 0 else 0.0
    fits = entry["temp_bytes"] + entry["args_bytes"] <= HBM_PER_CHIP
    advice = {
        "compute": "reduce non-useful FLOPs (one-hot dispatch einsums, remat "
                   "recompute) or keep the tensor cores fed (bf16 wgmma "
                   "tiles, 64-aligned shapes)",
        "memory": "fuse HBM round trips: the eager port writes every "
                  "intermediate; bigger fused kernels, bf16 intermediates, "
                  "no materialised transposes",
        "collective": "reshard to cut gathers (2D->1D param sharding), "
                      "overlap NVLink collectives with compute, compress "
                      "cross-node traffic",
    }[dominant]
    return {"terms_s": terms, "dominant": dominant,
            "useful_flops_ratio": useful, "roofline_fraction": frac,
            "fits_hbm": fits, "advice": advice}


def line(key: str, a: dict) -> str:
    """The reference's one-line format of an analysed entry."""
    t = a["terms_s"]
    return (f"{key:52s} comp={t['compute'] * 1e3:9.3f}ms "
            f"mem={t['memory'] * 1e3:9.3f}ms "
            f"coll={t['collective'] * 1e3:9.3f}ms "
            f"dom={a['dominant']:10s} roofline={a['roofline_fraction']:.3f} "
            f"useful={a['useful_flops_ratio']:.2f} fits={a['fits_hbm']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_path = args.out or os.path.join(os.path.abspath(RESULTS), DEFAULT_OUT)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    cache: dict = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            cache = json.load(f)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append((MESH_NAMES[False], production_mesh(False), 256))
    if args.mesh in ("multi", "both"):
        meshes.append((MESH_NAMES[True], production_mesh(True), 512))

    cells = [(a, s) for a, arch in ARCHS.items() for s in arch.shapes
             if arch.family != "rag"]
    cells += [("rag-unified", s) for s in ARCHS["rag-unified"].shapes]
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]

    from repro_torch.models import moe
    saved = dict(moe._MOE_MESH)
    trace_cache: dict = {}
    rows = []
    try:
        for mesh_name, mesh, n_chips in meshes:
            for arch_id, shape_name in cells:
                key = f"{arch_id}|{shape_name}|{mesh_name}"
                try:
                    entry = corrected_cell(arch_id, shape_name, mesh_name,
                                           mesh, cache,
                                           trace_cache=trace_cache)
                except Exception as e:
                    print(f"{key}: FAIL {e}")
                    continue
                if "analysis" not in entry:
                    entry["analysis"] = analyze(entry, n_chips)
                rows.append((key, entry))
                print(line(key, entry["analysis"]), flush=True)
                with open(out_path, "w") as f:
                    json.dump(cache, f, indent=1)
    finally:
        moe._MOE_MESH.clear()
        moe._MOE_MESH.update(saved)

    if args.markdown:
        print("\n| cell | compute (ms) | memory (ms) | collective (ms) | "
              "dominant | roofline frac | useful ratio | fits HBM |")
        print("|---|---|---|---|---|---|---|---|")
        for key, entry in rows:
            a = entry["analysis"]
            t = a["terms_s"]
            print(f"| {key} | {t['compute'] * 1e3:.3f} | {t['memory'] * 1e3:.3f} | "
                  f"{t['collective'] * 1e3:.3f} | {a['dominant']} | "
                  f"{a['roofline_fraction']:.3f} | {a['useful_flops_ratio']:.2f} | "
                  f"{'yes' if a['fits_hbm'] else 'NO'} |")


if __name__ == "__main__":
    main()
