"""Perf hill-climbing: measure a named cell under the CURRENT code /
env toggles and append a tagged entry to
``results/torch_perf_iterations.json`` (port of ``repro.launch.hillclimb``).

  REPRO_LM_VP_LOSS=1 PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --cell "grok-1-314b|train_4k" --tag vp_loss

Each entry records the three roofline terms on the H100's constants
(``launch/roofline.py``), reckoned on the ``meta`` device, so a change can
be read as hypothesis -> change -> before -> after. ``--out`` writes
elsewhere.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.launch.dryrun import MESH_NAMES, production_mesh
from repro_torch.launch.roofline import RESULTS, analyze, corrected_cell

DEFAULT_OUT = "torch_perf_iterations.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch|shape")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--cfg", default=None,
                    help='JSON dataclasses.replace overrides, e.g. {"moe_impl": "scatter"}')
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    arch_id, shape = args.cell.split("|")
    multi = args.mesh == "multi"
    mesh = production_mesh(multi)
    mesh_name = MESH_NAMES[multi]
    n_chips = 512 if multi else 256

    base_cfg = None
    if args.cfg:
        from repro_torch.configs import get
        base_cfg = dataclasses.replace(get(arch_id).full, **json.loads(args.cfg))

    from repro_torch.models import moe
    saved = dict(moe._MOE_MESH)
    try:
        entry = corrected_cell(arch_id, shape, mesh_name, mesh, cache={},
                               base_cfg=base_cfg)
    finally:
        moe._MOE_MESH.clear()
        moe._MOE_MESH.update(saved)
    entry["analysis"] = analyze(entry, n_chips)
    a = entry["analysis"]
    t = a["terms_s"]
    print(f"[{args.tag}] {args.cell} ({mesh_name})")
    print(f"  compute={t['compute']*1e3:.2f}ms memory={t['memory']*1e3:.2f}ms "
          f"collective={t['collective']*1e3:.2f}ms dominant={a['dominant']}")
    print(f"  roofline={a['roofline_fraction']:.4f} useful={a['useful_flops_ratio']:.3f} "
          f"temp={entry['temp_bytes']/2**30:.1f}GiB fits={a['fits_hbm']}")
    print("  coll: " + ", ".join(f"{k}={v:.2e}" for k, v in
                                 entry["coll_by_kind"].items() if v))

    out_path = args.out or os.path.join(os.path.abspath(RESULTS), DEFAULT_OUT)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    log = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            log = json.load(f)
    entry.update(cell=args.cell, tag=args.tag, mesh=mesh_name,
                 env={k: v for k, v in os.environ.items() if k.startswith("REPRO_")})
    log.append(entry)
    with open(out_path, "w") as f:
        json.dump(log, f, indent=1)
    return entry


if __name__ == "__main__":
    main()
