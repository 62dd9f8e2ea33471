"""Optimizers over trees of tensors (port of ``repro/training/optimizer.py``;
not ``torch.optim``, whose AdamW keeps its moments in the parameter's dtype).

Interface (optax-like, as the reference's):
  opt = adamw(lr=...) / adafactor(lr=...) / sgd(lr=...)
  state = opt.init(params)
  updates, state = opt.update(grads, state, params, step)
  params = apply_updates(params, updates)

``params`` is a tree of tensors (`training.tree`) or a module with a
``tree()`` (the port's `Transformer`); ``grads`` has the same structure.
The optimizer works in the reference's view of the tree: a leaf of the
model's layers is the (n_layers, ...) stack of its per-layer tensors, so
states and updates are the reference's leaves -- f32 moments whatever the
parameter's dtype, Adafactor's factored ``vr`` / ``vc`` over the last two
axes of every leaf of ndim >= 2 (stacked norms included) and its RMS
clipping over the whole leaf. ``step`` is an int; bias corrections take
t = step + 1; weight decay is decoupled (-lr·wd·p); clipping by the global
norm comes before the moments. ``apply_updates`` writes
``(p.float() + u).to(p.dtype)`` into the parameters in place (the
reference returns new arrays) and returns ``params``.

`lr` may be a float or a schedule fn step -> float. AdamW is the default
for <= 7B models; Adafactor (factored second moments, no momentum) is the
choice for grok-1-314b, where f32 Adam moments alone exceed a pod's HBM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.training import tree as T

Params = Any
Schedule = Callable[[int], float]


def _lr_at(lr, step) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _ref_f32(tree) -> tuple[list, list[torch.Tensor]]:
    """(paths, leaves as stacked f32 tensors) of a tree's reference view."""
    items = T.ref_items(tree)
    return ([path for path, _ in items],
            [T.stacked(leaf).float() for _, leaf in items])


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return T.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params, updates):
    for (_, p), (_, u) in zip(T.ref_items(params), T.ref_items(updates)):
        pairs = zip(p, u) if isinstance(p, T.Group) else ((p, u),)
        for p_i, u_i in pairs:
            p_i.copy_((p_i.float() + u_i).to(p_i.dtype))
    return params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]
    name: str = "opt"


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------

def sgd(lr, momentum: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": T.f32_zeros(params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = _lr_at(lr, step)
        paths, gs = _ref_f32(grads)
        if momentum == 0.0:
            return T.unflatten(paths, [-lr_t * g for g in gs]), state
        mus = [momentum * m + g for m, g in
               zip((leaf for _, leaf in T.ref_items(state["mu"])), gs)]
        return (T.unflatten(paths, [-lr_t * m for m in mus]),
                {"mu": T.unflatten(paths, mus)})

    return Optimizer(init, update, "sgd")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": T.f32_zeros(params), "v": T.f32_zeros(params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        t = float(step) + 1.0
        lr_t = _lr_at(lr, step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        paths = [path for path, _ in T.ref_items(params)]
        ms, vs, us = [], [], []
        for (_, g), (_, m_), (_, v_), (_, p) in zip(
                T.ref_items(grads), T.ref_items(state["m"]),
                T.ref_items(state["v"]), T.ref_items(params)):
            # the reference's expressions, each rounding in its order, with
            # the intermediates written in place: a 6.66 GB leaf (DLRM's
            # tables) holds one temporary at a time, not three
            g = T.stacked(g).float()
            m = torch.mul(m_, b1).add_(torch.mul(g, 1 - b1))
            v = torch.mul(v_, b2).add_(torch.square(g).mul_(1 - b2))
            del g
            denom = torch.div(v, bc2).sqrt_().add_(eps)
            u = torch.div(m, bc1).mul_(-lr_t).div_(denom)
            del denom
            if weight_decay:
                u.sub_(lr_t * weight_decay * T.stacked(p).float())
            ms.append(m)
            vs.append(v)
            us.append(u)
        return (T.unflatten(paths, us),
                {"m": T.unflatten(paths, ms), "v": T.unflatten(paths, vs)})

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, arXiv:1804.04235) -- factored second moments
# ---------------------------------------------------------------------------

def adafactor(lr, decay: float = 0.8, eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """Memory cost for a (n, m) matrix: n + m f32 (vs 2·n·m for Adam)."""

    def init(params):
        items = T.ref_items(params)

        def per_param(leaf):
            shape, dev = T.shape(leaf), T.first(leaf).device
            f32 = dict(dtype=torch.float32, device=dev)
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], **f32),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
            return {"v": torch.zeros(shape, **f32)}
        return {"f": T.unflatten([path for path, _ in items],
                                 [per_param(leaf) for _, leaf in items])}

    def update(grads, state, params, step):
        t = float(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = _lr_at(lr, step)
        paths = [path for path, _ in T.ref_items(params)]
        us, new_states = [], []
        for path, (_, g), (_, p) in zip(paths, T.ref_items(grads),
                                        T.ref_items(params)):
            s = state["f"]
            for key in path:
                s = s[key]
            gf = T.stacked(g).float()
            g2 = torch.square(gf) + eps1
            if gf.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                        eps1)
                precond = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                u = gf * torch.rsqrt(torch.clamp_min(precond, eps1))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(torch.clamp_min(v, eps1))
                new_s = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps1)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            u = -lr_t * u
            if weight_decay:
                u = u - lr_t * weight_decay * T.stacked(p).float()
            us.append(u)
            new_states.append(new_s)
        return (T.unflatten(paths, us),
                {"f": T.unflatten(paths, new_states)})

    return Optimizer(init, update, "adafactor")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    def fn(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + math.cos(math.pi * frac)))
    return fn
