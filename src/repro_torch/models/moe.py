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
    fits mask, aux loss). pos is first come, first served within each
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

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(topk_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return topk_p, topk_e, pos, fits, aux


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
    G, T, D = x.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    topk_p, topk_e, pos, fits, aux = _route(p, spec, x)
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
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), yout)
    return y, aux


def moe_apply_scatter(p: Params, spec: MoESpec, x: torch.Tensor):
    """Sort/scatter-based dispatch: the same routing (`_route`), dispatch
    as an ``index_add`` into the (E · C) slot arena (each slot receives
    exactly one token; overflow goes to a trash row) and combine as a
    ``gather`` mixed by gate -- O(T · K · D) data movement, no one-hot
    matmul. Identical outputs to `moe_apply` up to floating-point order."""
    G, T, D = x.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    topk_p, topk_e, pos, fits, aux = _route(p, spec, x)
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
    y = torch.einsum("gtk,gtkd->gtd", gate, gath)
    return y, aux


def moe_apply_scatter_shmap(p: Params, spec: MoESpec, x: torch.Tensor):
    """Scatter dispatch kept local to each data shard. With no mesh set
    (`set_moe_mesh`) this is `moe_apply_scatter`, as in the reference.
    Under a mesh the G groups split into n_dp contiguous chunks over the
    data axes (the reference's shard_map over ``dp_axes``); each chunk
    runs `moe_apply_scatter` on its own, y is the chunks' outputs in
    order, and aux is the MEAN of the chunks' aux losses (the reference's
    ``pmean``), not the aux of all G groups at once. The port's mesh is
    logical shards of one device: every mesh device must be x's device,
    and G must divide by n_dp, else ValueError."""
    mesh, dp = _MOE_MESH["mesh"], _MOE_MESH["dp_axes"]
    if mesh is None:
        return moe_apply_scatter(p, spec, x)
    from repro_torch.distributed.sharding import check_mesh_device
    from repro_torch.launch.mesh import n_shards
    check_mesh_device(mesh, x.device)
    n = n_shards(mesh, dp)
    G = x.shape[0]
    if G % n:
        raise ValueError(f"{G} MoE groups do not divide over the {n} data "
                         f"shards {dp}")
    ys, auxs = zip(*(moe_apply_scatter(p, spec, chunk)
                     for chunk in x.chunk(n, dim=0)))
    return torch.cat(ys, dim=0), torch.stack(auxs).mean()
