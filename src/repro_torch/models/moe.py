"""Mixture-of-Experts FFN -- GShard-style grouped dispatch / combine (port
of ``repro/models/moe.py``).

Top-k routing with per-group expert capacity. ``moe_apply`` expresses
dispatch and combine as contractions over a one-hot dispatch tensor built
per *group* of tokens, so its footprint is O(G · T_g · E · C_g);
``moe_apply_scatter`` moves the same tokens with ``index_add`` / ``gather``.
All of it is plain PyTorch, as the reference computes it outside any
Pallas kernel, and differentiable.

Kept from the reference because they decide which tokens drop:
  * top-k ties go to the lower expert (``jax.lax.top_k``'s order): a
    stable descending sort, since ``torch.topk`` promises no order;
  * a token's position within its expert is first come, first served over
    the (t, k) flattening, k fastest;
  * the capacity rounds up to a multiple of 8 with a floor of 8 (a TPU
    tiling artefact of the reference);
  * the combine chain is bf16 whatever the model's dtype: the gate is
    rounded to bf16 before the combine, and ``dispatch = combine > 0``.

FLOPs scale with top_k · capacity_factor (active experts), not n_experts.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init_

Params = dict[str, Any]

@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int           # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    impl: str = "einsum"   # "einsum" (GShard one-hot) | "scatter" (sort-based)


def moe_init(generator: torch.Generator, spec: MoESpec, dtype,
             device=None) -> Params:
    """The reference's laws, drawn from ``generator`` (on ``device``): the
    router (D, E) f32 (kept f32 in any model), w_gate / w_up (E, D, F) and
    w_down (E, F, D) in ``dtype``, each truncated normal / sqrt(its
    d_in)."""
    E, D, Fh = spec.n_experts, spec.d_model, spec.d_ff
    dev = torch.device("cpu" if device is None else device)
    p = {"router": torch.empty((D, E), dtype=torch.float32, device=dev),
         "w_gate": torch.empty((E, D, Fh), dtype=dtype, device=dev),
         "w_up": torch.empty((E, D, Fh), dtype=dtype, device=dev),
         "w_down": torch.empty((E, Fh, D), dtype=dtype, device=dev)}
    for w in p.values():
        dense_init_(w, generator)
    return p


def capacity(group_tokens: int, spec: MoESpec) -> int:
    c = int(np.ceil(spec.top_k * group_tokens / spec.n_experts
                    * spec.capacity_factor))
    return max(8, -(-c // 8) * 8)  # the reference's multiple of 8 (TPU tiling)


def _route(p: Params, spec: MoESpec, x: torch.Tensor):
    """Shared routing: returns (topk_p normalised, topk_e, pos-in-expert,
    fits mask, router probs). pos is first come, first served within each
    group, over (t, k) with k fastest."""
    G, T, D = x.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    logits = x.float() @ p["router"]                          # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: descending, ties to the lower expert
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_e = srt[..., :K], idx[..., :K]               # (G,T,K)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)

    flat = F.one_hot(topk_e.reshape(G, T * K), E)             # (G,T*K,E) int
    before = torch.cumsum(flat, dim=1) - flat                 # earlier (t, k)
    pos = before.gather(-1, topk_e.reshape(G, T * K, 1)).reshape(G, T, K)
    fits = pos < C
    return topk_p, topk_e, pos, fits, probs


def _aux(probs: torch.Tensor, topk_e: torch.Tensor, E: int) -> torch.Tensor:
    """The load-balancing loss over every group of ``probs``."""
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(topk_e[..., 0], E).float().mean(dim=(0, 1))
    return E * torch.sum(me * ce)


def group_stats(probs: torch.Tensor, topk_e: torch.Tensor, E: int):
    """(G, E) router-probability means and first-choice shares a group:
    the mean of a set of groups' rows is that set's ``me`` / ``ce`` (every
    group holds T tokens)."""
    return (probs.mean(dim=1),
            F.one_hot(topk_e[..., 0], E).float().mean(dim=1))


def _experts(p: Params, xin: torch.Tensor) -> torch.Tensor:
    """xin (G,E,C,D) -> (G,E,C,D) through the per-expert SwiGLU."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", xin, p["w_up"])
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


# mesh context for the mesh-local dispatch variant (set by the launcher; as
# in the reference, a mesh rides module state rather than the config)
_MOE_MESH = {"mesh": None, "dp_axes": ()}


def set_moe_mesh(mesh, dp_axes) -> None:
    _MOE_MESH["mesh"] = mesh
    _MOE_MESH["dp_axes"] = tuple(dp_axes)


def moe_apply(p: Params, spec: MoESpec, x: torch.Tensor):
    """x: (G, T, D) grouped tokens -> (y (G,T,D), aux_loss scalar f32).

    aux_loss is the standard load-balancing loss (Switch / GShard):
      E * sum_e( frac_tokens_e * frac_router_prob_e ).

    The combine tensor (G, T, E, C) is the bf16 gate at (expert, position)
    of each kept (t, k). It is built by contracting k between the gated
    expert one-hots (G, T, K, E) and the position one-hots (G, T, K, C), one
    product of two factors: the reference's three-way einsum, whose sum over
    k has at most one non-zero term (a token's k experts differ), so both
    are exact; no (G, T, K, E, C) tensor exists."""
    if spec.impl == "scatter":
        return moe_apply_scatter(p, spec, x)
    if spec.impl == "scatter_shmap":
        return moe_apply_scatter_shmap(p, spec, x)
    route = _route(p, spec, x)
    return _einsum_dispatch(p, spec, x, route), _aux(route[4], route[1],
                                                     spec.n_experts)


def _einsum_dispatch(p: Params, spec: MoESpec, x: torch.Tensor, route):
    G, T, D = x.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    topk_p, topk_e, pos, fits, _ = route
    gate = topk_p * fits                                       # drop overflow

    # combine chain in bf16, as the reference (gate precision only weighs
    # expert outputs); a position past C one-hots to a zero row, as jax's
    bt = torch.bfloat16
    gated = F.one_hot(topk_e, E).to(bt) * gate.to(bt)[..., None]   # (G,T,K,E)
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).to(bt)
    combine = torch.matmul(gated.transpose(-1, -2), pos_oh)    # (G,T,E,C)
    dispatch = (combine > 0).to(x.dtype)

    xin = torch.einsum("gtec,gtd->gecd", dispatch, x)
    yout = _experts(p, xin)
    return torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), yout)


def moe_apply_scatter(p: Params, spec: MoESpec, x: torch.Tensor):
    """Sort/scatter-based dispatch: the same routing (`_route`), dispatch
    as an ``index_add`` into the (E · C) slot arena (each slot receives
    exactly one token; overflow goes to a trash row) and combine as a
    ``gather`` mixed by gate -- O(T · K · D) data movement, no one-hot
    matmul. Identical outputs to `moe_apply` up to floating-point order."""
    route = _route(p, spec, x)
    return _scatter_dispatch(p, spec, x, route), _aux(route[4], route[1],
                                                      spec.n_experts)


def _scatter_dispatch(p: Params, spec: MoESpec, x: torch.Tensor, route):
    G, T, D = x.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    topk_p, topk_e, pos, fits, _ = route
    gate = (topk_p * fits).to(x.dtype)                         # (G,T,K)

    # flat destination slot for each (t, k): e*C + pos; overflow -> trash row
    slot = torch.where(fits, topk_e * C + pos, E * C)          # (G,T,K)
    base = torch.arange(G, device=x.device)[:, None, None]
    x_rep = x.repeat_interleave(K, dim=1).reshape(G * T * K, D)
    arena = torch.zeros((G * (E * C + 1), D), dtype=x.dtype, device=x.device)
    xin = arena.index_add(0, (base * (E * C + 1) + slot).reshape(-1), x_rep)
    xin = xin.reshape(G, E * C + 1, D)[:, : E * C].reshape(G, E, C, D)

    yout = _experts(p, xin).reshape(G * E * C, D)
    # gather each (t, k)'s result back and mix by gate
    safe = torch.clamp_max(slot, E * C - 1) + base * (E * C)
    gath = yout[safe.reshape(-1)].reshape(G, T, K, D)
    return torch.einsum("gtk,gtkd->gtd", gate, gath)


def moe_groups(p: Params, spec: MoESpec, x: torch.Tensor):
    """x: (G, T, D) -> (y (G, T, D), me (G, E), ce (G, E)): the dispatch
    of ``spec.impl`` ("scatter_shmap" runs the scatter) with each group's
    routing statistics (`group_stats`) in place of the aux loss, for a
    caller that forms aux over groups held on several devices."""
    route = _route(p, spec, x)
    dispatch = _einsum_dispatch if spec.impl == "einsum" else \
        _scatter_dispatch
    return (dispatch(p, spec, x, route),
            *group_stats(route[4], route[1], spec.n_experts))


def chunk_aux(me: torch.Tensor, ce: torch.Tensor, E: int) -> torch.Tensor:
    """The aux loss of a set of groups from their `group_stats`."""
    return E * torch.sum(me.mean(0) * ce.mean(0))


def moe_apply_scatter_shmap(p: Params, spec: MoESpec, x: torch.Tensor):
    """Scatter dispatch kept local to each data shard. With no mesh set
    (`set_moe_mesh`) this is `moe_apply_scatter`, as in the reference.
    Under a mesh the G groups split into n_dp contiguous chunks over the
    data axes (the reference's shard_map over ``dp_axes``); each chunk
    runs `moe_apply_scatter` on its own, y is the chunks' outputs in
    order, and aux is the MEAN of the chunks' aux losses (the reference's
    ``pmean``), not the aux of all G groups at once. G must divide by
    n_dp, else ValueError.

    Over a mesh of one device the chunks run in turn on x's device. Over
    a mesh of several devices (of x's device type) chunk i runs on the
    devices of data shard i, each over its slice of the experts' hidden
    width (``w_gate`` / ``w_up`` columns, ``w_down`` rows, when the model
    axis divides it; whole otherwise), the slices' outputs all-reduced
    over the model axis; y comes back to x's device and aux is the
    all-reduced mean of the chunks' aux, every byte through
    ``distributed.collectives``."""
    mesh, dp = _MOE_MESH["mesh"], _MOE_MESH["dp_axes"]
    if mesh is None:
        return moe_apply_scatter(p, spec, x)
    from repro_torch.distributed.sharding import check_mesh, one_device
    from repro_torch.launch.mesh import n_shards
    check_mesh(mesh, x.device)
    n = n_shards(mesh, dp)
    G = x.shape[0]
    if G % n:
        raise ValueError(f"{G} MoE groups do not divide over the {n} data "
                         f"shards {dp}")
    if one_device(mesh):
        ys, auxs = zip(*(moe_apply_scatter(p, spec, chunk)
                         for chunk in x.chunk(n, dim=0)))
        return torch.cat(ys, dim=0), torch.stack(auxs).mean()
    return _scatter_over_cards(p, spec, x, mesh, dp, n)


def _scatter_over_cards(p, spec, x, mesh, dp, n):
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import dp_tp_coords
    n_tp = mesh.shape.get("model", 1)
    split = n_tp > 1 and spec.d_ff % n_tp == 0
    fw = spec.d_ff // n_tp if split else spec.d_ff
    coords = [(i, j if split else 0) for i, j in dp_tp_coords(mesh,
                                                             dp_axes=dp)]
    devs = mesh.devices
    G, T, D = x.shape
    g = G // n
    xs = C.move([x], [C.full_box(x.shape)],
                [(((i * g, (i + 1) * g), (0, T), (0, D)), d)
                 for (i, _), d in zip(coords, devs)])

    def cut(name, dim):
        w = p[name]
        boxes = []
        for _, j in coords:
            box = list(C.full_box(w.shape))
            box[dim] = (j * fw, (j + 1) * fw)
            boxes.append(tuple(box))
        return C.move([w], [C.full_box(w.shape)], list(zip(boxes, devs)))

    router = C.move([p["router"]], [C.full_box(p["router"].shape)],
                    [(C.full_box(p["router"].shape), d) for d in devs])
    wg, wu, wd = cut("w_gate", 2), cut("w_up", 2), cut("w_down", 1)
    outs = [moe_apply_scatter({"router": router[c], "w_gate": wg[c],
                               "w_up": wu[c], "w_down": wd[c]}, spec, xs[c])
            for c in range(len(devs))]
    ys = [y for y, _ in outs]
    if split:
        for i in range(n):
            row = [c for c, (ci, _) in enumerate(coords) if ci == i]
            for c, y in zip(row, C.all_reduce([ys[c] for c in row])):
                ys[c] = y
    first = [next(c for c, (ci, j) in enumerate(coords) if ci == i and j == 0)
             for i in range(n)]
    y = C.move([ys[c] for c in first],
               [((i * g, (i + 1) * g), (0, T), (0, D)) for i in range(n)],
               [(C.full_box(x.shape), x.device)])[0]
    total = C.all_reduce([outs[c][1] for c in first])[0]
    return y, C.move([total], [()], [((), x.device)])[0] / n
