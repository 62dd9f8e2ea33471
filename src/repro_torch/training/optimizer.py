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

A state laid on a mesh of several devices (`distributed.sharding.Placed`
leaves) is updated piece by piece on the pieces' devices: a gradient is
brought to its moment's layout and an update to its parameter's (the
reference's specs give an optimizer leaf the spec of the first parameter
of its shape, which may not be its own parameter's); the global norm,
Adafactor's row and column means and its RMS clip sum the pieces'
partial sums across devices in shard order, each value counted once
(`Placed.distinct`), through ``distributed.collectives``.

`lr` may be a float or a schedule fn step -> float. AdamW is the default
for <= 7B models; Adafactor (factored second moments, no momentum) is the
choice for grok-1-314b, where f32 Adam moments alone exceed a pod's HBM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (P, NamedSharding, Placed,
                                              relayout, zeros_on)
from repro_torch.training import tree as T

Params = Any
Schedule = Callable[[int], float]


def _lr_at(lr, step) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _each(fn, like, *leaves):
    """``fn`` over reference leaves: for a `Placed` ``like``, over its
    pieces with every placed leaf brought to its layout (None passes as
    None); otherwise over the leaves as stacked tensors."""
    if not isinstance(like, Placed):
        return fn(*(None if x is None else T.stacked(x) for x in leaves))
    args = [relayout(x, like) if isinstance(x, Placed) else x
            for x in leaves]
    live = [k for k, a in enumerate(args) if a is not None]

    def on_pieces(*ts):
        full = [None] * len(args)
        for k, t in zip(live, ts):
            full[k] = t
        return fn(*full)
    return args[live[0]].map(on_pieces, *(args[k] for k in live[1:]))


def _scalar_on(x: torch.Tensor, cache: dict, device) -> torch.Tensor:
    """A 0-d ``x`` copied to ``device`` once
    (`collectives.gather_boxes`)."""
    if device not in cache:
        cache[device] = C.gather_boxes([((), x, x.device)],
                                       [((), device)])[0]
    return cache[device]


def _total(parts: list) -> torch.Tensor:
    """0-d partial sums added in order on the first one's device."""
    return C.reduce_boxes([((), t) for t in parts],
                          [((), parts[0].device)], torch.float32)[0]


def _sq_parts(leaf) -> list:
    if isinstance(leaf, Placed):
        return [torch.sum(torch.square(t.float()))
                for _, t, _ in leaf.distinct()]
    return [torch.sum(torch.square(leaf.float()))]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf; over placed leaves each
    piece's sum of squares is taken on its device (a replicated piece
    once) and the sums added in shard order on the first piece's
    device."""
    parts = [p for x in T.leaves(tree) for p in _sq_parts(x)]
    if not any(isinstance(x, Placed) for x in T.leaves(tree)):
        return torch.sqrt(sum(parts))
    return torch.sqrt(_total(parts))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    cache: dict = {}

    def clip(g):
        s = _scalar_on(scale, cache, g.device)
        return (g.float() * s).to(g.dtype)
    return T.tree_map(lambda g: g.map(clip) if isinstance(g, Placed)
                      else clip(g), grads), norm


@torch.no_grad()
def apply_updates(params, updates):
    for (_, p), (_, u) in zip(T.ref_items(params), T.ref_items(updates)):
        if isinstance(p, Placed):
            p.map(lambda p_i, u_i: p_i.copy_((p_i.float() + u_i)
                                             .to(p_i.dtype)),
                  relayout(u, p))
            continue
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
        items = T.ref_items(grads)
        paths = [path for path, _ in items]
        if momentum == 0.0:
            return T.unflatten(paths, [_each(lambda g: -lr_t * g.float(), g, g)
                                       for _, g in items]), state
        mus = [_each(lambda m, g: momentum * m + g.float(), m, m, g)
               for (_, g), (_, m) in zip(items, T.ref_items(state["mu"]))]
        return (T.unflatten(paths, [_each(lambda m: -lr_t * m, m, m)
                                    for m in mus]),
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

        def adam(g, m_, v_, p):
            # the reference's expressions, each rounding in its order, with
            # the intermediates written in place: a 6.66 GB leaf (DLRM's
            # tables) holds one temporary at a time, not three
            g = g.float()
            m = torch.mul(m_, b1).add_(torch.mul(g, 1 - b1))
            v = torch.mul(v_, b2).add_(torch.square(g).mul_(1 - b2))
            del g
            denom = torch.div(v, bc2).sqrt_().add_(eps)
            u = torch.div(m, bc1).mul_(-lr_t).div_(denom)
            del denom
            if weight_decay:
                u.sub_(lr_t * weight_decay * p.float())
            return m, v, u

        ms, vs, us = [], [], []
        for (_, g), (_, m_), (_, v_), (_, p) in zip(
                T.ref_items(grads), T.ref_items(state["m"]),
                T.ref_items(state["v"]), T.ref_items(params)):
            m, v, u = _each(adam, m_, g, m_, v_, p if weight_decay else None)
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
            shape = T.shape(leaf)
            if isinstance(leaf, Placed):
                spec = tuple(leaf.spec) + (None,) * (len(shape)
                                                     - len(leaf.spec))

                def zeros(keep):
                    return zeros_on(NamedSharding(leaf.mesh, P(*(
                        spec[d] for d in keep))), tuple(shape[d] for d in
                                                        keep), torch.float32)
            else:
                def zeros(keep):
                    return torch.zeros(tuple(shape[d] for d in keep),
                                       dtype=torch.float32,
                                       device=T.first(leaf).device)
            n = len(shape)
            if n >= 2:
                return {"vr": zeros(range(n - 1)),
                        "vc": zeros([*range(n - 2), n - 1])}
            return {"v": zeros(range(n))}
        return {"f": T.unflatten([path for path, _ in items],
                                 [per_param(leaf) for _, leaf in items])}

    def factored(gf, g2, s, beta):
        vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
        vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
        denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps1)
        precond = (vr[..., None] / denom[..., None]) * vc[..., None, :]
        return gf * torch.rsqrt(torch.clamp_min(precond, eps1)), vr, vc

    def factored_placed(gf: Placed, g2: Placed, s, beta):
        """`factored` over pieces: each mean is a sum of the pieces'
        partial sums over the box of the piece that needs it, divided by
        the dimension's length."""
        n_r, n_c = gf.shape[-2], gf.shape[-1]
        rows = [(b[:-1], t.sum(-1)) for b, t, _ in g2.distinct()]
        cols = [(b[:-2] + b[-1:], t.sum(-2)) for b, t, _ in g2.distinct()]
        vr = s["vr"].build(lambda b, d, t: beta * t + (1 - beta) * (
            C.reduce_boxes(rows, [(b, d)], torch.float32)[0] / n_c))
        vc = s["vc"].build(lambda b, d, t: beta * t + (1 - beta) * (
            C.reduce_boxes(cols, [(b, d)], torch.float32)[0] / n_r))
        vr_sums = [(b[:-1], t.sum(-1)) for b, t, _ in vr.distinct()]

        def precondition(b, d, g):
            denom = torch.clamp_min(C.reduce_boxes(
                vr_sums, [(b[:-2], d)], torch.float32)[0] / n_r, eps1)
            r = C.gather_boxes(vr.parts(), [(b[:-1], d)], fresh=False)[0]
            c = C.gather_boxes(vc.parts(), [(b[:-2] + b[-1:], d)],
                               fresh=False)[0]
            precond = (r[..., None] / denom[..., None, None]) * c[..., None, :]
            return g * torch.rsqrt(torch.clamp_min(precond, eps1))
        return gf.build(precondition), vr, vc

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
            placed = isinstance(g, Placed)
            gf = g.map(lambda x: x.float()) if placed else T.stacked(g).float()
            g2 = (gf.map(lambda x: torch.square(x) + eps1) if placed
                  else torch.square(gf) + eps1)
            if len(T.shape(g)) >= 2:
                u, vr, vc = (factored_placed if placed else factored)(
                    gf, g2, s, beta)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = _each(lambda v_, x: beta * v_ + (1 - beta) * x,
                          s["v"], s["v"], g2)
                u = _each(lambda x, v_: x * torch.rsqrt(
                    torch.clamp_min(v_, eps1)), v, gf, v)
                new_s = {"v": v}
            # update clipping (RMS)
            if placed:
                n = math.prod(u.shape)
                rms = torch.sqrt(_total(_sq_parts(u)) / n + eps1)
            else:
                rms = torch.sqrt(torch.mean(torch.square(u)) + eps1)
            fac = torch.clamp_min(rms / clip_threshold, 1.0)
            cache: dict = {}
            u = _each(lambda x: -lr_t * (x / _scalar_on(fac, cache,
                                                         x.device)), u, u)
            if weight_decay:
                u = _each(lambda x, w: x - lr_t * weight_decay * w.float(),
                          u, u, p)
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
