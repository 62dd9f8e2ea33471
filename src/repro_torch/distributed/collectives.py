"""Collectives over a mesh's devices (port of
``repro.distributed.collectives``).

The port's mesh is single-controller (`launch.mesh`): one process holds
every shard, so a collective takes the per-shard tensors as a sequence
and returns the per-shard results. Every byte that crosses between two
devices of a mesh moves here, by ``Tensor.copy_`` between them (a peer
copy between cards); a sum always runs in shard order, accumulated in
f32 and cast back, so every device that receives it holds the same bits
whichever device's thread runs it.

* `all_reduce`, `all_gather`, `reduce_scatter`: the reference's psum /
  all_gather / psum_scatter over the tensors a mesh axis holds, each an
  autograd function: all_gather's backward is a reduce-scatter, the
  others' the matching collective of the gradients;
* `move`: regions of source tensors copied to (box, device) targets; its
  backward sums each target's gradient back into its sources;
* `gather_param`: a parameter's block gathered from the pieces that hold
  it (`distributed.sharding.Placed`) onto the devices that compute with
  it; its backward reduce-scatters the blocks' gradients into the
  pieces' gradient buffers;
* `gather_boxes` / `reduce_boxes`: the copies and the sums under them.

A box is a tuple of (start, stop) a dimension, in a global array's
coordinates. `allgather_bytes` counts a gather's wire bytes from the
shapes handed to it; `constrain` checks a sharding constraint against the
mesh and moves nothing. `collective_bytes_of_hlo` is the reference's
framework-free parser of an HLO dump, kept for the contract: the port
compiles no HLO, and its launch tools reckon collectives by rule
(``launch/dryrun.py``).

>>> import torch
>>> s, i = topk_allgather_merge(
...     [torch.tensor([[0.9, 0.5]]), torch.tensor([[0.9, 0.7]])],
...     [torch.tensor([[7, 1]]), torch.tensor([[3, 2]])], 3)
>>> s.tolist(), i.tolist()
([[0.8999999761581421, 0.8999999761581421, 0.699999988079071]], [[3, 7, 2]])
>>> allgather_bytes((8, 10), torch.float32, 4)
1280
>>> cpus = [torch.device("cpu", i) for i in range(2)]
>>> [t.tolist() for t in all_reduce([torch.ones(2), torch.full((2,), 2.0)])]
[[3.0, 3.0], [3.0, 3.0]]
>>> all_gather([torch.zeros(1), torch.ones(1)], 0, cpus)[1].tolist()
[0.0, 1.0]
>>> [t.tolist() for t in reduce_scatter([torch.ones(2)] * 2, 0, cpus)]
[[2.0], [2.0]]
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.launch.mesh import normalize_device, tensor_device


def constrain(x, mesh, spec):
    """The reference's ``with_sharding_constraint``: on the
    one-controller mesh no data moves, so this checks that every entry of
    ``spec`` names axes of ``mesh`` and that the mesh's devices are of one
    type, and returns ``x`` itself."""
    types = {torch.device(d).type for d in mesh.devices}
    if len(types) > 1:
        raise ValueError(f"the mesh's devices are of more than one type: "
                         f"{sorted(types)}")
    for entry in spec:
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            if axis not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {axis!r}; the mesh "
                                 f"has {mesh.axis_names}")
    return x


# ---------------------------------------------------------------------------
# boxes, copies and sums
# ---------------------------------------------------------------------------

def full_box(shape) -> tuple:
    return tuple((0, int(n)) for n in shape)


def box_shape(box) -> tuple:
    return tuple(e - s for s, e in box)


def intersect(a, b):
    """The box both ``a`` and ``b`` hold, or None."""
    out = []
    for (s0, e0), (s1, e1) in zip(a, b):
        s, e = max(s0, s1), min(e0, e1)
        if s >= e:
            return None
        out.append((s, e))
    return tuple(out)


def local(box, within) -> tuple:
    """``box`` as slices of a tensor that holds ``within``."""
    return tuple(slice(s - w, e - w) for (s, e), (w, _) in zip(box, within))


def gather_boxes(sources, targets, *, fresh: bool = True) -> list:
    """Each target ``(box, device)`` assembled from ``sources``, a sequence
    of ``(box, tensor, device)`` (``device`` the source's mesh entry) whose
    boxes are equal or disjoint: of sources with one box the one on the
    target's device is read, else the first. Without ``fresh`` a target
    that one source on its device holds whole is a view of it."""
    by_box: dict = {}
    for box, t, dev in sources:
        by_box.setdefault(tuple(box), []).append((t, normalize_device(dev)))
    out = []
    for tbox, dev in targets:
        tbox, want = tuple(tbox), normalize_device(dev)
        hits = []
        for box, cands in by_box.items():
            inter = intersect(tbox, box)
            if inter is not None:
                t = next((c for c, d in cands if d == want), cands[0][0])
                hits.append((inter, box, t))
        if sum(math.prod(box_shape(i)) for i, _, _ in hits) != \
                math.prod(box_shape(tbox)):
            raise ValueError(f"the sources do not cover the box {tbox}")
        where = tensor_device(dev)
        if not fresh and len(hits) == 1 and hits[0][2].device == where:
            inter, box, t = hits[0]
            out.append(t[local(tbox, box)])
            continue
        o = torch.empty(box_shape(tbox), dtype=hits[0][2].dtype, device=where)
        for inter, box, t in hits:
            o[local(inter, tbox)].copy_(t[local(inter, box)],
                                        non_blocking=True)
        out.append(o)
    return out


def reduce_boxes(contribs, targets, dtype=None) -> list:
    """Each target ``(box, device)`` as the sum of every contribution
    ``(box, tensor)`` over the region they share, in the order given,
    accumulated in f32 on the target's device and cast to ``dtype`` (the
    first contribution's by default); zero where none reaches."""
    dtype = dtype or contribs[0][1].dtype
    out = []
    for tbox, dev in targets:
        where = tensor_device(dev)
        acc = torch.zeros(box_shape(tbox), dtype=torch.float32, device=where)
        for box, t in contribs:
            inter = intersect(tbox, box)
            if inter is not None:
                part = t[local(inter, box)].to(where, non_blocking=True)
                acc[local(inter, tbox)] += part.float()
        out.append(acc if dtype == torch.float32 else acc.to(dtype))
    return out


# ---------------------------------------------------------------------------
# autograd collectives
# ---------------------------------------------------------------------------

class _Move(torch.autograd.Function):
    """Regions of the inputs copied to targets; the gradient of each input
    is the sum of the targets' gradients over its box (shard order)."""

    @staticmethod
    def forward(ctx, boxes, targets, *xs):
        ctx.set_materialize_grads(False)
        ctx.boxes, ctx.targets = boxes, targets
        ctx.inputs = [(x.device, x.dtype) for x in xs]
        return tuple(gather_boxes([(b, x, x.device) for b, x in
                                   zip(boxes, xs)], targets))

    @staticmethod
    def backward(ctx, *gs):
        contribs = [(b, g) for (b, _), g in zip(ctx.targets, gs)
                    if g is not None]
        if not contribs:
            return (None, None) + (None,) * len(ctx.inputs)
        return (None, None) + tuple(
            reduce_boxes(contribs, [(b, dev)], dtype)[0]
            for b, (dev, dtype) in zip(ctx.boxes, ctx.inputs))


def move(xs, boxes, targets) -> list:
    """``xs[i]`` holds the region ``boxes[i]`` of one global array; returns
    the region of each target ``(box, device)`` on its device, a fresh
    tensor. Differentiable: a target's gradient flows back to the inputs
    it was read from (a sum where several targets read one region)."""
    return list(_Move.apply(tuple(boxes), tuple(targets), *xs))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.set_materialize_grads(False)
        ctx.devices = [x.device for x in xs]
        return tuple(_sum_on(list(xs), ctx.devices))

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        if not live:
            return (None,) * len(gs)
        return tuple(_sum_on(live, ctx.devices))


def _sum_on(xs, devices) -> list:
    box = full_box(xs[0].shape)
    return reduce_boxes([(box, x) for x in xs],
                        [(box, d) for d in devices], xs[0].dtype)


def all_reduce(xs) -> list:
    """The sum of ``xs`` (one tensor a shard, one shape) in shard order,
    on every shard's device. Its backward hands each shard the sum of the
    outputs' gradients (the true gradient of a value every shard
    receives)."""
    return list(_AllReduce.apply(*xs))


def all_max(xs) -> list:
    """The elementwise max of ``xs`` on every shard's device (no
    gradient: the vocab-parallel loss detaches its row max)."""
    with torch.no_grad():
        outs = []
        for d in [x.device for x in xs]:
            acc = xs[0].to(d, copy=True)
            for x in xs[1:]:
                acc = torch.maximum(acc, x.to(d, non_blocking=True))
            outs.append(acc)
        return outs


def _chunks(shape, dim: int, n: int) -> list:
    size = shape[dim] // n
    if size * n != shape[dim]:
        raise ValueError(f"dimension {dim} ({shape[dim]}) does not divide "
                         f"over {n} shards")
    base = full_box(shape)
    return [base[:dim] + ((k * size, (k + 1) * size),) + base[dim + 1:]
            for k in range(n)]


def all_gather(xs, dim: int, devices) -> list:
    """``xs[k]`` (shard k's block, all one shape) concatenated along
    ``dim`` on every device of ``devices`` (mesh entries). The backward
    reduce-scatters the outputs' gradients into the blocks."""
    shape = list(xs[0].shape)
    shape[dim] *= len(xs)
    return move(xs, _chunks(shape, dim, len(xs)),
                [(full_box(shape), d) for d in devices])


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *xs):
        ctx.set_materialize_grads(False)
        boxes = _chunks(xs[0].shape, dim, len(devices))
        ctx.boxes, ctx.devices = boxes, devices
        ctx.inputs, ctx.shape = [x.device for x in xs], xs[0].shape
        ctx.dtype = xs[0].dtype
        box = full_box(xs[0].shape)
        return tuple(reduce_boxes([(box, x) for x in xs],
                                  list(zip(boxes, devices)), xs[0].dtype))

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return (None, None) + (None,) * len(ctx.inputs)
        gs = [torch.zeros(box_shape(b), dtype=ctx.dtype,
                          device=tensor_device(d)) if g is None else g
              for g, b, d in zip(gs, ctx.boxes, ctx.devices)]
        full = gather_boxes([(b, g, g.device) for b, g in zip(ctx.boxes, gs)],
                            [(full_box(ctx.shape), d) for d in ctx.inputs])
        return (None, None) + tuple(full)


def reduce_scatter(xs, dim: int, devices) -> list:
    """The sum of ``xs`` (one tensor a shard, one shape) in shard order,
    cut along ``dim`` into ``len(devices)`` blocks: block k on
    ``devices[k]``. The backward all-gathers the blocks' gradients."""
    return list(_ReduceScatter.apply(dim, tuple(devices), *xs))


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sink, leaf, targets):
        ctx.set_materialize_grads(False)
        ctx.leaf, ctx.targets = leaf, targets
        return tuple(gather_boxes(leaf.parts(), targets))

    @staticmethod
    def backward(ctx, *gs):
        ctx.leaf.add_grad([(b, g) for (b, _), g in zip(ctx.targets, gs)
                           if g is not None])
        return None, None, None


def gather_param(sink: torch.Tensor, leaf, targets) -> list:
    """The block of a placed parameter (`sharding.Placed`) that each
    target ``(box, device)`` names, a fresh tensor on that device,
    assembled from the pieces that hold it (a piece on the target's own
    device read first). ``sink`` is a scalar that requires grad: it makes
    the blocks part of the graph. The backward sums the blocks' gradients
    into every piece's gradient buffer (``leaf.add_grad``: a
    reduce-scatter in shard order) instead of returning them, so a
    piece's gradient never passes through autograd's per-device
    accumulation, whose order would follow the devices' threads."""
    return list(_GatherParam.apply(sink, leaf, tuple(targets)))


def lex_order(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, n) column order by score desc, then id asc, then column asc:
    ``jax.lax.sort(num_keys=2)`` has no twin, so one stable sort by id,
    then one stable descending sort by score."""
    _, order = torch.sort(ids, dim=1, stable=True)
    _, by_score = torch.sort(torch.gather(scores, 1, order), dim=1,
                             descending=True, stable=True)
    return torch.gather(order, 1, by_score)


def topk_allgather_merge(scores, idx, k: int):
    """Distributed top-k merge: each shard contributes its local (B, k_s)
    best; the lists are gathered and reselected. Payload O(shards * k),
    constant in corpus size. ``scores`` and ``idx`` are sequences of
    per-shard tensors. Equal scores break by *global* id ascending, not by
    gathered column position (which encodes shard order), so the merge is
    placement-invariant."""
    s_all, i_all = torch.cat(list(scores), dim=1), torch.cat(list(idx), dim=1)
    order = lex_order(s_all, i_all)[:, :k]
    return torch.gather(s_all, 1, order), torch.gather(i_all, 1, order)


def allgather_bytes(local_shape, dtype, n_shards: int) -> int:
    """Bytes a tiled all-gather of one (local_shape, dtype) block from each
    of ``n_shards`` shards produces: the gathered result, counted once, as
    the reference counts a collective's result shape in its HLO."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.prod(local_shape) * n_shards * itemsize


_HLO_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
                    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4,
                    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16}
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# lines like: %x = f32[128,256]{1,0} all-gather(%y), ...
_HLO_OP = re.compile(r"=\s+(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+([\w-]+)")
_HLO_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")


def _hlo_size(dtype: str, dims: str) -> int:
    if dtype not in _HLO_DTYPE_BYTES:
        return 0
    return math.prod(int(d) for d in dims.split(",") if d) \
        * _HLO_DTYPE_BYTES[dtype]


def collective_bytes_of_hlo(hlo_text: str) -> dict[str, int]:
    """Sum the result bytes of every collective op in an HLO dump, by kind
    (the reference's parser, the same function on the same text): an
    async pair counts at its ``-start``, a tuple result sums its
    members."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for line in hlo_text.splitlines():
        m = _HLO_OP.search(line)
        if not m:
            continue
        op = m.group(4)
        base = next((k for k in COLLECTIVE_KINDS
                     if op == k or op.startswith(k + "-start")
                     or op == k + "-done"), None)
        if base is None or op.endswith("-done"):
            continue
        if m.group(1) is not None:
            total = sum(_hlo_size(dt, dims)
                        for dt, dims in _HLO_SHAPE.findall(m.group(1)))
        else:
            total = _hlo_size(m.group(2), m.group(3))
        out[base] += total
    return out
