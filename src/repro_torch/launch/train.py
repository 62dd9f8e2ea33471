"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --batch 8 --seq 256 --steps 50 --reduced --device cpu   # CPU-sized run
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --batch 8 --seq 1024 --steps 20  # one card
  ... --mesh 2x2 --vp-loss      # on a (data=2, model=2) mesh of cards 0-3
  ... --mesh 2x4 --vp-loss --device cuda   # logical shards of one card

A registry LM with AdamW (cosine schedule, peak 3e-4, warmup 100) or, from
100 B parameters, Adafactor; synthetic batches; a `Trainer` with async
checkpoints every steps / 4 under ``--ckpt`` (which also resumes from the
newest one) and straggler detection. Runs on the card unless ``--device``
names another.

``--mesh DxM`` lays the state by the reference's `lm_rules` specs
(`distributed.sharding.place`) on a (data, model) mesh of the first D x M
cards, as the reference's ``make_mesh`` takes the first devices, and
raises when there are fewer: every card holds its pieces of the
parameters and the optimizer's state, and the step runs on all of them
(one controller, ``training.train_loop``). With ``--device X`` the mesh
is D x M logical shards of X instead (the state stays whole on X, its
shards views). ``--vp-loss`` trains with the vocab-parallel loss over the
mesh; without ``--mesh`` it is the plain loss, as in the reference.
"""
from __future__ import annotations

import argparse
import math


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 (data x model)")
    ap.add_argument("--vp-loss", action="store_true",
                    help="vocab-parallel cross-entropy (needs a 'model' axis)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); with --mesh, "
                         "every shard on it")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get
    from repro_torch.core.store import resolve_device
    from repro_torch.data.lm_pipeline import Prefetcher, synthetic_lm_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training.fault_tolerance import (StragglerDetector,
                                                      resume_or_init)
    from repro_torch.training.optimizer import (adafactor, adamw,
                                                cosine_schedule)
    from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                                 init_state, make_train_step)

    arch = get(args.arch)
    if arch.family != "lm":
        raise ValueError("train.py drives the LM family")
    cfg = arch.reduced if args.reduced else arch.full
    dev = resolve_device(args.device)

    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        axes = ("data", "model")[: len(shape)]
        mesh = (make_mesh(shape, axes) if args.device is None else
                make_mesh(shape, axes, devices=[dev] * math.prod(shape)))

    opt = (adafactor(1e-3) if cfg.param_count() >= 100e9
           else adamw(cosine_schedule(3e-4, 100, args.steps), weight_decay=0.1))

    if args.vp_loss and mesh is not None:
        loss = tfm.make_vp_loss_fn(cfg, mesh)
    else:
        loss = lambda p, b: tfm.loss_fn(p, cfg, b)  # noqa: E731
    step_fn = make_train_step(loss, opt, donate=False)

    shardings = None
    if mesh is not None:
        skeleton = tfm.Transformer(cfg, device="meta")
        shardings = shd.state_shardings(
            mesh, {"params": skeleton, "opt": opt.init(skeleton), "step": 0},
            shd.lm_rules(mesh))

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(0)
        return init_state(tfm.init(cfg, generator=gen, device=dev), opt,
                          shardings=shardings)

    on_cards = mesh is not None and not shd.one_device(mesh)
    state, start = resume_or_init(
        args.ckpt, fresh, like=init_state(skeleton, opt) if on_cards else None,
        shardings=shardings if on_cards else None)
    if mesh is not None and not on_cards:
        state = shd.place(state, shardings)
    data = Prefetcher(synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq,
                                           start_step=start))
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                      ckpt_every=max(args.steps // 4, 1), log_every=10),
        step_fn, state, data, straggler_detector=StragglerDetector())
    return trainer.run()


if __name__ == "__main__":
    main()
