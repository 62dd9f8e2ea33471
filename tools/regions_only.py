"""Run `chip_smoke.py`'s build and its ``regions`` phase alone.

    python3 tools/regions_only.py [--rows-per-card N]

The phase places a `RagDB`'s arena regions on every card present (it
needs two or more): hash and tenant placement with lexical lanes, the
sharded, exact, hybrid (wsum, rrf, paged) and, under hash, IVF engines
over the regions, a write batch's commit, `filtered_topk_sharded` and
`decode_attention_sharded` over pieces on the cards, then the tiered
deployment with its hot arena in the regions. ``--rows-per-card`` cuts
the rows on the fullest card (default: the prod cut, 2^23). Prints each
card's name and power limit, the phase's JSON lines, then one
``{"regions": {...}}`` line of the launches a kernel that the phase's
main-path runs made. Exits non-zero when a gate fails or no card is
present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows-per-card", type=int, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = cs.setup()
    if dev is None:
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    cs.CARD = smi[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(cs.kernel_mod.build),
                    pool.submit(cs.attn_lib.build)]:
            fut.result()
    cs.emit("build", seconds=time.perf_counter() - t0)
    out = cs.phase_regions(dev, rows_per_card=args.rows_per_card)
    print(json.dumps({"regions": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
