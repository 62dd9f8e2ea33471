"""Training on the PyTorch / CUDA port: train a small LM on the synthetic
next-token stream with the full production loop -- checkpointed,
straggler-monitored, crash-restartable. The port's twin of
``examples/train_lm.py``: the same model (lm-10m), optimizer, schedule,
data and flags. Training's attention is the plain PyTorch math (the
reference trains in plain jnp too), so no kernel runs here.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --steps 400   # resumes at 200
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu

The checkpoint lives under the temporary directory (``--ckpt`` moves
it). Weights are drawn from a seeded generator on the training device;
`main` takes a numpy parameter tree of the reference's layout instead
(``params=``, carried across by `models.transformer.from_numpy`) and
returns what it prints as a dict.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core.store import resolve_device
from repro_torch.data.lm_pipeline import Prefetcher, synthetic_lm_batches
from repro_torch.models.transformer import (TransformerConfig, from_numpy,
                                            init, loss_fn)
from repro_torch.training.fault_tolerance import StragglerDetector, resume_or_init
from repro_torch.training.optimizer import adamw, cosine_schedule
from repro_torch.training.train_loop import (Trainer, TrainerConfig, init_state,
                                             make_train_step)

# ~10M params -- sized so a few hundred CPU steps visibly learn the
# synthetic Markov stream; the same loop drives the pod-scale configs
LM_10M = TransformerConfig(name="lm-10m", n_layers=4, d_model=256, n_heads=8,
                           n_kv_heads=4, d_ff=688, vocab_size=512,
                           dtype="float32", attn_impl="naive")


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LM_10M
    opt = adamw(cosine_schedule(3e-3, warmup=20, total=args.steps),
                weight_decay=0.01)

    def fresh():
        if params is None:
            model = init(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
        else:
            model = from_numpy(params, cfg, device=dev)
        n = sum(p.numel() for p in model.parameters())
        print(f"init {n/1e6:.1f}M params")
        return init_state(model, opt)

    state, start = resume_or_init(args.ckpt, fresh, device=dev)
    if start:
        print(f"resumed from checkpoint at step {start}")

    step_fn = make_train_step(lambda p, b: loss_fn(p, cfg, b), opt,
                              donate=False)
    data = Prefetcher(synthetic_lm_batches(cfg.vocab_size, args.batch,
                                           args.seq, start_step=start,
                                           device=dev))
    det = StragglerDetector()
    trainer = Trainer(TrainerConfig(total_steps=args.steps,
                                    ckpt_dir=args.ckpt, ckpt_every=50,
                                    log_every=args.log_every),
                      step_fn, state, data, straggler_detector=det)
    trainer.run()
    if det.events:
        print(f"straggler events: "
              f"{[(s, f'{t:.2f}s') for s, t, _ in det.events]}")
    out = {"device": str(dev), "start": start, "steps": args.steps,
           "losses": [(h["step"], h["loss"]) for h in trainer.history],
           "straggler_events": len(det.events),
           "mean_step_ms": det.mean_step_s * 1e3}
    if trainer.history:
        first, last = trainer.history[0]["loss"], trainer.history[-1]["loss"]
        print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps - start} "
              f"steps (mean step {det.mean_step_s*1e3:.0f} ms)")
    return out


if __name__ == "__main__":
    main()
