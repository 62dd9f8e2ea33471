#!/usr/bin/env python3
"""Training curves of granite-moe-1b-a400m FULL on one NVIDIA card under a
few AdamW schedules, without checkpoints.

    python3 tools/train_schedules.py                       # the default set
    python3 tools/train_schedules.py --schedules 3e-4:0.1:5:60,1e-3:0.1:5:20

Each schedule ``peak:weight_decay:warmup:steps`` draws the model from seed
0, trains ``steps`` steps of 8 x 1024 tokens from
``synthetic_lm_batches(seed=0)`` with ``adamw(cosine_schedule(peak,
warmup, steps), weight_decay)`` (the launcher's optimizer, another
schedule), and prints one JSON line: the loss a step, the cross-entropy
and the summed load-balancing term (``aux``, weighted by moe_aux_weight in
the loss) on a fixed probe batch (seed 99) before and after, the median
step time and the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

DEFAULT = ("3e-4:0.1:5:20,1e-3:0.1:5:20,3e-3:0.1:5:20,1e-3:0:5:20,"
           "1e-4:0.1:5:20,3e-5:0.1:5:20,3e-4:0.1:5:60,1e-3:0.1:5:60")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedules", default=DEFAULT,
                    help="comma-separated peak:weight_decay:warmup:steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_schedules: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import granite_moe_1b
    from repro_torch.data.lm_pipeline import synthetic_lm_batches
    from repro_torch.models import transformer as tfm
    from repro_torch.training.optimizer import adamw, cosine_schedule
    from repro_torch.training.train_loop import init_state, make_train_step

    cfg, dev = granite_moe_1b.FULL, torch.device("cuda")
    probe = next(synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq,
                                      seed=99))

    def xent_aux(model):
        with torch.no_grad():
            logits, aux = tfm.forward(model, cfg, probe["tokens"])
            lf = logits.float()
            gold = lf.gather(-1, probe["labels"].to(dev).long()[..., None])
            xent = (torch.logsumexp(lf, -1) - gold[..., 0]).mean()
        return float(xent), float(aux)

    for spec in args.schedules.split(","):
        peak, wd, warmup, steps = spec.split(":")
        peak, wd, warmup, steps = float(peak), float(wd), int(warmup), int(steps)
        torch.cuda.reset_peak_memory_stats()
        model = tfm.init(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
        opt = adamw(cosine_schedule(peak, warmup, steps), weight_decay=wd)
        step = make_train_step(lambda p, b: tfm.loss_fn(p, cfg, b), opt)
        state = init_state(model, opt)
        before = xent_aux(model)
        data = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq,
                                    seed=0)
        losses, times = [], []
        for _ in range(steps):
            batch = next(data)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        print(json.dumps({
            "peak": peak, "weight_decay": wd, "warmup": warmup,
            "steps": steps, "losses": losses,
            "xent_aux_before": before, "xent_aux_after": xent_aux(
                state["params"]),
            "step_ms_median": statistics.median(times) * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del state, model, step, opt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
