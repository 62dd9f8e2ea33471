"""Gradient compression for the slow (cross-pod / DCN) axis (port of
``repro.distributed.compression``).

Two production levers, composable:

  1. bf16 reduction -- gradients cross the pod boundary in bf16 instead of
     fp32 (2x fewer bytes).
  2. int8 + error feedback -- per-tensor shared-scale int8 quantisation
     with an error-feedback accumulator (residual carried to the next
     step), the EF-SGD construction. The shared scale is the max |x| over
     the shards (a scalar collective), so the int8 payloads sum exactly in
     int32.

The port's mesh is single-controller (`launch.mesh`), so a reduction over
an axis takes the per-shard tensors as a sequence, as
`collectives.topk_allgather_merge` takes per-shard lists. When they all
sit on one device it returns the reduced tensor; when they sit on
several it returns the reduced tensor on every shard's device (one a
shard, the same bits), the shards' payloads summed in shard order
through ``distributed.collectives``. `ef_init` / `ef_compress` work over
a tree's reference view (`training.tree.ref_items`: a model's layers
stacked), leaf for leaf the reference's; over a placed tree
(`sharding.Placed` leaves) piece by piece, the shared scale the max over
every piece.

>>> import torch
>>> xs = [torch.tensor([1.0, -2.0]), torch.tensor([0.5, 2.0])]
>>> psum_bf16(xs).tolist()
[1.5, 0.0]
>>> [round(v, 4) for v in psum_int8(xs).tolist()]    # 96 steps of 2 / 127
[1.5118, 0.0]
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import Placed, relayout
from repro_torch.launch.mesh import normalize_device, tensor_device
from repro_torch.training import tree as T


# ---------------------------------------------------------------------------
# bf16 cross-axis psum
# ---------------------------------------------------------------------------

def _devices(xs, devices) -> list:
    """The shards' devices: ``devices`` (mesh entries) or the tensors'."""
    return list(devices) if devices is not None else [x.device for x in xs]


def _spread(devices) -> bool:
    return len({normalize_device(d) for d in devices}) > 1


def _sum_in_order(parts, device, dtype):
    """``parts`` added in shard order in ``dtype`` on ``device``."""
    acc = parts[0].to(device, copy=True)
    for x in parts[1:]:
        acc = acc + x.to(device, non_blocking=True)
    return acc.to(dtype)


def psum_bf16(xs, devices=None):
    """All-reduce in bf16 wire format; accumulate back to the input dtype:
    each shard's tensor rounds to bf16, the sum is taken in bf16 in shard
    order, and the result is cast back. ``devices``: the shards' mesh
    entries (default: the tensors' devices); when they are several, the
    result comes back on each (a list)."""
    xs = list(xs)
    devs = _devices(xs, devices)
    wire = [x.to(torch.bfloat16) for x in xs]
    if not _spread(devs):
        return _sum_in_order(wire, xs[0].device, xs[0].dtype)
    box = C.full_box(xs[0].shape)
    return [_sum_in_order([C.gather_boxes([(box, w, s)], [(box, d)])[0]
                           for w, s in zip(wire, devs)],
                          tensor_device(d), xs[0].dtype) for d in devs]


# ---------------------------------------------------------------------------
# int8 + error feedback
# ---------------------------------------------------------------------------

def _quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-12) / 127.0


def psum_int8(xs, devices=None):
    """Shared-scale int8 all-reduce: max over the shards of max |x| ->
    quantise each shard -> int32 sum -> dequantise. Wire bytes: 1 scalar +
    N int8 a shard (vs N fp32). On several devices (``devices``, as in
    `psum_bf16`) every shard's device receives the max and the int8
    payloads and forms the same sum (a list, one a shard)."""
    xs = list(xs)
    devs = _devices(xs, devices)
    amaxes = [torch.max(torch.abs(x.float())) for x in xs]
    if not _spread(devs):
        scale = _scale(torch.stack(amaxes).max())
        q = [_quantize_int8(x.float(), scale) for x in xs]
        s = _sum_in_order([t.to(torch.int32) for t in q], xs[0].device,
                          torch.int32)
        return (s.float() * scale).to(xs[0].dtype)
    scales = [_scale(m) for m in C.all_max(amaxes)]
    q = [_quantize_int8(x.float(), s) for x, s in zip(xs, scales)]
    box = C.full_box(xs[0].shape)
    out = []
    for d, scale in zip(devs, scales):
        wire = [C.gather_boxes([(box, t, s)], [(box, d)])[0]
                for t, s in zip(q, devs)]
        s = _sum_in_order([t.to(torch.int32) for t in wire],
                          tensor_device(d), torch.int32)
        out.append((s.float() * scale).to(xs[0].dtype))
    return out


def ef_init(params) -> dict:
    """Error-feedback residual state: one f32 zero buffer per leaf of the
    params' reference view (a model's layers stacked)."""
    return T.f32_zeros(params)


@torch.no_grad()
def ef_compress(grads, ef_state):
    """Quantise (grad + residual) to int8 per leaf; return (q_grads
    dequantised in the grad's dtype, new_residual f32), both trees of the
    reference view. The dequantised value is what enters the optimizer;
    the residual carries the quantisation error to the next step
    (EF-SGD)."""
    paths, qs, es = [], [], []
    for (path, g), (_, e) in zip(T.ref_items(grads), T.ref_items(ef_state)):
        paths.append(path)
        if isinstance(g, Placed):
            x = relayout(g, e).map(lambda a, b: a.float() + b, e)
            scale = _scale(C.all_max([torch.max(torch.abs(t))
                                      for _, t, _ in x.distinct()])[0])
            on: dict = {}

            def quant(t, scale=scale, on=on, dtype=g.dtype):
                if t.device not in on:
                    on[t.device] = C.gather_boxes([((), scale, scale.device)],
                                                  [((), t.device)])[0]
                deq = _quantize_int8(t, on[t.device]).float() * on[t.device]
                return deq.to(dtype), t - deq
            q, r = x.map(quant)
            qs.append(q)
            es.append(r)
            continue
        g = T.stacked(g)
        x = g.float() + e
        scale = _scale(torch.max(torch.abs(x)))
        deq = _quantize_int8(x, scale).float() * scale
        qs.append(deq.to(g.dtype))
        es.append(x - deq)
    return T.unflatten(paths, qs), T.unflatten(paths, es)
