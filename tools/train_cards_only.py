"""Run `chip_smoke.py`'s ``train_cards`` phase alone.

    python3 tools/train_cards_only.py [--steps N]

The phase lays a train state on the cards present, each leaf in pieces
by the reference's specs, and trains it there (`chip_smoke.phase_train_cards`):
with four or more cards yi-6b FULL through ``launch.train --mesh 2x2
--vp-loss`` and its parity, MoE, compression and checkpoint gates on a
(data 2, model 2) mesh; with two or three a (1, 2) mesh at a 4-layer cut;
with one card the cut on a (2, 2) mesh of that card. It builds no kernel
and launches none. Prints each card's name and power limit, the phase's
JSON lines, then one ``{"train_cards": {...}}`` line. Exits non-zero when
a gate fails or no card is present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10,
                   help="launcher steps of the full-width run")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = cs.setup()
    if dev is None:
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    cs.CARD = smi[0]
    out = cs.phase_train_cards(dev, full_steps=args.steps)
    print(json.dumps({"train_cards": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
