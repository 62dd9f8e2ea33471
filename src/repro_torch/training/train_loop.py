"""Generic training loop (port of ``repro/training/train_loop.py``).

`make_train_step` builds the step for any (loss_fn, optimizer) pair, with
optional micro-batch gradient accumulation; `Trainer` owns the host loop:
data iterator, periodic async checkpoints, straggler detection and
crash-restart (see ``fault_tolerance.py``).

A `TrainState` is ``{"params", "opt", "step"}``: the parameters (a
`Transformer` or a tree of tensors, updated in place by each step), the
optimizer's state (the reference's tree) and the step as an int.
Gradients come from ``torch.autograd.grad`` over the parameters' tensors;
a parameter the loss does not reach gets a zero gradient, as
``jax.grad`` gives. A state laid on a mesh of several devices
(`distributed.sharding.place`: every parameter a `Placed`) takes the
same step: the loss gathers each block where it computes with it, and
the backward pass reduce-scatters the blocks' gradients into gradient
pieces of each parameter's layout, in shard order
(`collectives.gather_param`); the optimizer updates every piece on its
device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T
from repro_torch.training.optimizer import (Optimizer, apply_updates,
                                            global_norm)

TrainState = dict[str, Any]     # {"params", "opt", "step"}


def init_state(params, optimizer: Optimizer, shardings=None, *,
               split: bool | None = None) -> TrainState:
    """The state at step 0. Switches ``requires_grad`` on for every
    floating-point parameter (a model's serving path runs under
    ``no_grad`` and is unaffected).

    With ``shardings`` (a state's tree of `NamedSharding`, e.g.
    `sharding.state_shardings` of a state built on ``meta``) the state is
    laid on that mesh (`sharding.place`): the parameters copied into
    their pieces, the optimizer's state (zeros, as every optimizer here
    starts) allocated piece by piece on the pieces' devices, never
    whole; ``split`` as in `sharding.place` (True lays pieces on a mesh
    of one device too)."""
    if shardings is not None:
        params = shd.place(params, shardings["params"], split=split)
        if shd.is_placed(params):
            like = optimizer.init(_meta_tree(params))
            items = T.ref_items(like)
            opt = T.unflatten([p for p, _ in items], [
                shd.zeros_on(T.at(shardings["opt"], p), T.shape(leaf),
                             T.first(leaf).dtype) for p, leaf in items])
            return {"params": params, "opt": opt, "step": 0}
    for p in T.leaves(params):
        if torch.is_tensor(p) and p.is_floating_point():
            p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def _meta_tree(params) -> dict:
    """A placed tree's leaves as empty tensors of their shapes on meta."""
    items = T.ref_items(params)
    return T.unflatten([p for p, _ in items],
                       [torch.empty(leaf.shape, dtype=leaf.dtype,
                                    device="meta") for _, leaf in items])


def _placed_grads(loss_fn, params, batch):
    """(loss detached, gradients of a placed tree: a `Placed` of each
    parameter's layout, filled by the backward pass)."""
    leaves = [leaf for _, leaf in T.ref_items(params)]
    for leaf in leaves:
        leaf.grad = leaf.zeros()
    try:
        loss = loss_fn(params, batch)
        torch.autograd.backward(loss)
        items = T.ref_items(params)
        grads = T.unflatten([p for p, _ in items],
                            [leaf.grad for _, leaf in items])
    finally:
        for leaf in leaves:
            leaf.grad = None
    return loss.detach(), grads


def _grads(loss_fn, params, batch):
    """(loss detached, gradients as a tree of the params' structure)."""
    if shd.is_placed(params):
        return _placed_grads(loss_fn, params, batch)
    leaves = T.leaves(params)
    loss = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    it = iter(gs)
    return loss.detach(), T.tree_map(lambda _: next(it), params)


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    accum_steps: int = 1, donate: bool = True):
    """loss_fn(params, batch) -> scalar tensor. Returns
    step(state, batch) -> (state, metrics {"loss", "grad_norm"}: 0-d f32
    tensors, not synchronised).

    With accum_steps > 1, batch leaves must have a leading micro-batch
    axis of that size; the micro-batches' gradients are summed in f32 and
    averaged (f32 gradients go to the optimizer, as the reference's).
    ``donate`` is accepted and does nothing: the step updates the
    parameters in place."""

    def step_fn(state: TrainState, batch):
        params = state["params"]
        if accum_steps == 1:
            loss, grads = _grads(loss_fn, params, batch)
        else:
            gsum, lsum = None, torch.zeros((), dtype=torch.float32)
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                l, g = _grads(loss_fn, params, mb)
                g = T.tree_map(_float, g)
                gsum = g if gsum is None else T.tree_map(_add, gsum, g)
                lsum = lsum.to(l.device) + l
            grads = T.tree_map(lambda x: _divided(x, accum_steps), gsum)
            loss = lsum / accum_steps

        updates, opt_state = optimizer.update(grads, state["opt"], params,
                                              state["step"])
        apply_updates(params, updates)
        del updates
        gnorm = global_norm(grads)
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step_fn


def _float(x):
    return x.map(lambda t: t.float()) if isinstance(x, shd.Placed) \
        else x.float()


def _add(a, b):
    return a.map(torch.add, b) if isinstance(a, shd.Placed) else a + b


def _divided(x, n: int):
    return x.map(lambda t: t / n) if isinstance(x, shd.Placed) else x / n


def _block(t: torch.Tensor) -> None:
    """Wait for the device work that produces ``t``."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    ckpt_keep: int = 3
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn, state: TrainState,
                 data: Iterator, *, straggler_detector=None, log_fn=print):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.log_fn = log_fn
        self.straggler = straggler_detector
        self.ckpt = (ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.ckpt_keep)
                     if cfg.ckpt_dir else None)
        self.history: list[dict] = []

    def run(self) -> TrainState:
        start = int(self.state["step"])
        for step in range(start, self.cfg.total_steps):
            batch = next(self.data)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            _block(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.straggler is not None:
                self.straggler.record(step, dt)
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, step_time_s=dt)
                self.history.append(m)
                self.log_fn(f"step {step:6d}  loss {m['loss']:.4f}  "
                            f"gnorm {m['grad_norm']:.3f}  {dt*1e3:.1f} ms")
            if self.ckpt and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state)
        if self.ckpt:
            self.ckpt.save(self.cfg.total_steps, self.state)
            self.ckpt.close()
        return self.state
