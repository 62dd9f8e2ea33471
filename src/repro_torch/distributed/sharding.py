"""Sharding rules: param-path regex -> PartitionSpec (port of
``repro.distributed.sharding``).

Scheme (single pod): mesh ("data", "model") = (16, 16)
  * FSDP: weight matrices shard one dim over "data"
  * TP:   the other dim over "model" (heads / ffn-hidden / vocab)
Multi-pod adds a leading "pod" axis that joins the FSDP group for parameters
(cross-pod traffic = gradient all-reduce only; TP never crosses pods).

Rules are matched against the flattened path string (keys joined by '/')
of the tree's reference view (`training.tree.ref_items`: a model's layers
are one stacked (n_layers, ...) leaf). First match wins; unmatched params
replicate. The specs are the reference's, leaf for leaf.

The port's mesh is single-controller (`launch.mesh.Mesh`): one process
holds every shard. `place` lays a state on a mesh by these specs. Over
a mesh of one device a shard's piece of a leaf is a zero-copy view
(`NamedSharding.piece`) and the state stays as it is. Over a mesh of
several devices (of one type) each leaf becomes a `Placed`: one piece a
mesh coordinate, each its own allocation on its coordinate's device
(coordinates that share a device and a box share one), copied from the
leaf's device; the model's forward and backward, the optimizers and
the checkpoints work on those pieces (``models.transformer``,
``training``), and bytes cross devices only through
``distributed.collectives``.

>>> from repro_torch.launch.mesh import make_mesh
>>> m = make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)
>>> fit_spec(m, P("model", "data"), (49155, 1024))
P(None, 'data')
>>> NamedSharding(m, P(None, "data")).shard_shape((49155, 1024))
(49155, 64)
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Sequence

import torch

from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import (Mesh, normalize_device, same_device,
                                     tensor_device)
from repro_torch.training import tree as T


class P(tuple):
    """A PartitionSpec: one entry a dimension, each None (replicated), an
    axis name, or a tuple of axis names (major first). A one-name tuple
    reads as the name, as ``jax.sharding.PartitionSpec`` reads it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def fsdp_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def lm_rules(mesh: Mesh) -> list[tuple[str, P]]:
    fsdp = fsdp_axes(mesh)
    tp = "model"
    return [
        # embeddings: vocab over TP, model-dim over FSDP
        (r"embed$", P(tp, fsdp)),
        (r"lm_head$", P(fsdp, tp)),
        # attention (stacked (L, ...)): contract dim FSDP, head dim TP
        (r"attn/w[qkv]$", P(None, fsdp, tp)),
        (r"attn/wo$", P(None, tp, fsdp)),
        (r"attn/b[qkv]$", P(None, tp)),
        (r"attn/[qk]_norm$", P(None, None)),
        # dense FFN
        (r"ffn/w_(gate|up)$", P(None, fsdp, tp)),
        (r"ffn/w_down$", P(None, tp, fsdp)),
        # MoE: expert-count-agnostic -- shard d_model/d_ff, replicate E
        (r"moe/router$", P(None, fsdp, None)),
        (r"moe/w_(gate|up)$", P(None, None, fsdp, tp)),
        (r"moe/w_down$", P(None, None, tp, fsdp)),
        # norms
        (r"(attn_norm|ffn_norm|final_norm)$", P()),
    ]


def recsys_rules(mesh: Mesh) -> list[tuple[str, P]]:
    fsdp = fsdp_axes(mesh)
    tp = "model"
    return [
        # embedding tables (F, V, d): rows (vocab) over TP -- row-wise
        # sharding
        (r"tables$|^v$|items$", P(None, tp, None)),
        (r"^w$", P(None, tp)),
        (r"(bot|top)/layer\d+/w$", P(fsdp, tp)),
        (r"blocks/\d+/w[qkvo1-2]$", P(fsdp, tp)),
    ]


def gnn_rules(mesh: Mesh) -> list[tuple[str, P]]:
    # GCN weights are tiny (d_hidden=16): replicate weights, shard the graph.
    return [(r".*", P())]


def match_pspec(path: str, rules: Sequence[tuple[str, P]]) -> P:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return P()


def _path_str(path) -> str:
    return "/".join(str(key) for key in path)


def _group(ax) -> tuple:
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def _group_size(mesh: Mesh, ax) -> int:
    if ax is None:
        return 1
    return math.prod(mesh.shape[a] for a in _group(ax))


def fit_spec(mesh: Mesh, spec: P, shape: tuple[int, ...]) -> P:
    """Make `spec` legal for `shape` on `mesh`: every sharded dim must divide
    evenly. For a non-dividing axis group, try progressively smaller
    subgroups (drop members right-to-left, then left-to-right, then
    singles); fall back to None. Rank-extends short specs with None."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries[: len(shape)]):
        if ax is None:
            out.append(None)
            continue
        group = _group(ax)
        cands = [group]
        for i in range(len(group) - 1, 0, -1):
            cands.append(group[:i])
        for i in range(1, len(group)):
            cands.append(group[i:])
        cands += [(a,) for a in group]
        chosen = None
        for c in cands:
            if dim % _group_size(mesh, c) == 0:
                chosen = c if len(c) > 1 else c[0]
                break
        out.append(chosen)
    return P(*out)


def _spec_tree(tree, fn):
    """``fn(path, leaf)`` over the reference view of ``tree``, as a nested
    dict (or, for a bare leaf, the one value)."""
    items = T.ref_items(tree)
    if len(items) == 1 and items[0][0] == ():
        return fn((), items[0][1])
    return T.unflatten([p for p, _ in items], [fn(p, v) for p, v in items])


def param_pspecs(params, rules: Sequence[tuple[str, P]], mesh: Mesh):
    """Tree of `P` matching the reference view of ``params`` (a model or a
    tree of tensors); every spec is fit_spec'd against the leaf's shape."""
    return _spec_tree(params, lambda path, leaf: fit_spec(
        mesh, match_pspec(_path_str(path), rules), T.shape(leaf)))


def opt_pspecs(opt_state, params_pspecs, params):
    """Optimizer-state specs: leaves shaped like their param inherit its
    spec (Adam m/v); reduced-shape leaves (Adafactor vr/vc) drop the
    missing axis; anything else replicates. The first param (in flatten
    order) of a shape decides, as in the reference. Input specs must be
    rank-complete (`param_pspecs` guarantees this)."""
    by_shape: dict[tuple, P] = {}
    for path, leaf in T.ref_items(params):
        spec, shape = T.at(params_pspecs, path), T.shape(leaf)
        full = tuple(spec) + (None,) * (len(shape) - len(spec))
        by_shape.setdefault(shape, spec)
        if len(shape) >= 2:
            # adafactor vr drops the last dim; vc the second-to-last
            by_shape.setdefault(shape[:-1], P(*full[:-1]))
            by_shape.setdefault(shape[:-2] + shape[-1:],
                                P(*(full[:-2] + (full[-1],))))
    return _spec_tree(opt_state,
                      lambda path, leaf: by_shape.get(T.shape(leaf), P()))


def state_pspecs(mesh: Mesh, state, rules):
    """Specs for a full TrainState {"params", "opt", "step"}."""
    pp = param_pspecs(state["params"], rules, mesh)
    return {"params": pp,
            "opt": opt_pspecs(state["opt"], pp, state["params"]),
            "step": P()}


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec laid on a mesh. ``shard_shape`` is one shard's piece of a
    global shape; ``piece`` is that piece of a leaf at one mesh coordinate,
    a view (``narrow``) of the leaf, never a copy."""
    mesh: Mesh
    spec: P

    def _entries(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than a rank-"
                             f"{ndim} leaf")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def shard_shape(self, global_shape) -> tuple:
        out = []
        for dim, ax in zip(global_shape, self._entries(len(global_shape))):
            n = _group_size(self.mesh, ax)
            if dim % n:
                raise ValueError(f"{self.spec} does not fit shape "
                                 f"{tuple(global_shape)}: {dim} % {n} != 0")
            out.append(dim // n)
        return tuple(out)

    def coords(self):
        """Every mesh coordinate ({axis: index}), devices' row-major order."""
        names = self.mesh.axis_names
        for idx in itertools.product(*(range(self.mesh.shape[a])
                                       for a in names)):
            yield dict(zip(names, idx))

    def box(self, global_shape, coord: dict) -> tuple:
        """The (start, stop) a dimension of the shard at ``coord``."""
        out = []
        for ax, size in zip(self._entries(len(global_shape)),
                            self.shard_shape(global_shape)):
            i = 0
            for a in (() if ax is None else _group(ax)):
                i = i * self.mesh.shape[a] + coord[a]
            out.append((i * size, (i + 1) * size))
        return tuple(out)

    def piece(self, leaf, coord: dict):
        """The shard of ``leaf`` (a tensor, or a `Group` read as its stack)
        held at mesh coordinate ``coord``: a view."""
        shape = T.shape(leaf)
        local = self.shard_shape(shape)
        starts = [s for s, _ in self.box(shape, coord)]
        if isinstance(leaf, T.Group):
            layers = leaf[starts[0]: starts[0] + local[0]]
            return T.Group(_narrow(t, starts[1:], local[1:]) for t in layers)
        return _narrow(leaf, starts, local)


def _narrow(t: torch.Tensor, starts, sizes) -> torch.Tensor:
    for d, (s, n) in enumerate(zip(starts, sizes)):
        if n != t.shape[d]:
            t = t.narrow(d, s, n)
    return t


def named(mesh: Mesh, pspecs):
    """The tree of `P` as a tree of `NamedSharding`s."""
    if isinstance(pspecs, P):
        return NamedSharding(mesh, pspecs)
    return {k: named(mesh, v) for k, v in pspecs.items()}


def state_shardings(mesh: Mesh, state, rules):
    return named(mesh, state_pspecs(mesh, state, rules))


class Placed:
    """A leaf laid on a mesh of several devices: its global ``shape`` and
    ``dtype``, its ``spec``, and per mesh coordinate (``mesh.devices``
    order) its ``boxes`` (a (start, stop) a dimension) and ``pieces``,
    each on its coordinate's device; coordinates that share a device and
    a box share one tensor. ``grad`` is a `Placed` of the same layout
    while a backward pass fills it (`collectives.gather_param`)."""

    def __init__(self, mesh: Mesh, spec, shape, dtype, boxes, pieces):
        self.mesh, self.spec = mesh, spec
        self.shape, self.dtype = tuple(shape), dtype
        self.boxes, self.pieces = tuple(boxes), tuple(pieces)
        self.grad = None

    def __repr__(self) -> str:
        return (f"Placed({self.shape}, {self.dtype}, {self.spec}, "
                f"{len(self.parts())} pieces)")

    @property
    def devices(self) -> tuple:
        return self.mesh.devices

    def parts(self) -> list:
        """(box, tensor, mesh device), once a tensor: the pieces as
        `collectives.gather_boxes` reads them."""
        seen, out = set(), []
        for box, dev, t in zip(self.boxes, self.devices, self.pieces):
            if id(t) not in seen:
                seen.add(id(t))
                out.append((box, t, dev))
        return out

    def distinct(self) -> list:
        """(box, tensor, mesh device), once a box: the leaf's values each
        counted once (a replicated piece at its first coordinate)."""
        seen, out = set(), []
        for box, t, dev in self.parts():
            if box not in seen:
                seen.add(box)
                out.append((box, t, dev))
        return out

    def nbytes_by_device(self) -> dict:
        """{normalised device: bytes of the pieces it holds}."""
        out: dict = {}
        for _, t, dev in self.parts():
            key = normalize_device(dev)
            out[key] = out.get(key, 0) + t.numel() * t.element_size()
        return out

    def build(self, fn) -> "Placed":
        """A leaf of this layout whose piece at (box, device), where this
        leaf holds ``t``, is ``fn(box, device, t)``, once a shared
        piece."""
        made: dict = {}
        pieces = []
        for box, dev, t in zip(self.boxes, self.devices, self.pieces):
            if id(t) not in made:
                made[id(t)] = fn(box, dev, t)
            pieces.append(made[id(t)])
        return Placed(self.mesh, self.spec, self.shape, pieces[0].dtype,
                      self.boxes, pieces)

    def map(self, fn, *others):
        """``fn`` over the pieces of this leaf and of ``others`` (one
        layout), once a shared piece; a tuple result gives a tuple of
        leaves."""
        for o in others:
            if o.boxes != self.boxes or o.devices != self.devices:
                raise ValueError("map over leaves of different layouts")
        made: dict = {}
        outs = []
        for k, t in enumerate(self.pieces):
            if id(t) not in made:
                made[id(t)] = fn(t, *(o.pieces[k] for o in others))
            outs.append(made[id(t)])
        if isinstance(outs[0], tuple):
            return tuple(Placed(self.mesh, self.spec, self.shape, o[0].dtype,
                                self.boxes, o) for o in zip(*outs))
        return Placed(self.mesh, self.spec, self.shape, outs[0].dtype,
                      self.boxes, outs)

    def zeros(self, dtype=None) -> "Placed":
        return self.build(lambda box, dev, _: torch.zeros(
            C.box_shape(box), dtype=dtype or self.dtype,
            device=tensor_device(dev)))

    def add_grad(self, contribs) -> None:
        """Add the sum of ``contribs`` ((box, gradient) of blocks read
        from this leaf, in shard order) into every piece's gradient."""
        span = tuple((min(b[d][0] for b, _ in contribs),
                      max(b[d][1] for b, _ in contribs))
                     for d in range(len(self.shape)))
        for (box, _, dev), (_, g, _) in zip(self.parts(), self.grad.parts()):
            region = C.intersect(span, box)
            if region is not None:
                g[C.local(region, box)] += C.reduce_boxes(
                    contribs, [(region, dev)], g.dtype)[0]

    def assemble(self, device) -> torch.Tensor:
        """The whole leaf on ``device``."""
        return C.gather_boxes(self.parts(),
                              [(C.full_box(self.shape), device)])[0]


def relayout(leaf: Placed, like: Placed) -> Placed:
    """``leaf``'s values in ``like``'s layout (its own pieces where the
    layouts agree, else copies gathered from the pieces that hold
    them)."""
    if leaf.boxes == like.boxes and leaf.devices == like.devices:
        return leaf
    src = leaf.parts()
    return like.build(lambda box, dev, _: C.gather_boxes(
        src, [(box, dev)], fresh=False)[0])


def is_placed(tree) -> bool:
    """Whether ``tree``'s leaves are `Placed` (a tree laid on a mesh of
    several devices)."""
    return any(isinstance(leaf, Placed) for _, leaf in T.ref_items(tree))


def placed_mesh(tree) -> Mesh:
    return next(leaf.mesh for _, leaf in T.ref_items(tree)
                if isinstance(leaf, Placed))


def check_mesh(mesh: Mesh, device=None) -> None:
    """ValueError unless every device of ``mesh`` has one type, and, with
    ``device``, the type of ``device``."""
    types = {torch.device(d).type for d in mesh.devices}
    if device is not None:
        types.add(torch.device(device).type)
    if len(types) > 1:
        raise ValueError(
            f"the mesh's devices {sorted({str(d) for d in mesh.devices})} "
            + (f"and the state's device {device} " if device is not None
               else "") + "are of more than one type")


def one_device(mesh: Mesh) -> bool:
    """Whether every entry of ``mesh`` is one device (logical shards)."""
    return len({normalize_device(d) for d in mesh.devices}) == 1


def _leaf_sources(leaf) -> list:
    """(box, tensor, device) pieces that hold a leaf (a tensor, a `Group`
    read as its stack, or a `Placed`)."""
    if isinstance(leaf, Placed):
        return leaf.parts()
    if isinstance(leaf, T.Group):
        rest = C.full_box(leaf[0].shape)
        return [(((i, i + 1),) + rest, t.detach().unsqueeze(0), t.device)
                for i, t in enumerate(leaf)]
    return [(C.full_box(leaf.shape), leaf.detach(), leaf.device)]


def place_leaf(leaf, sh: NamedSharding) -> Placed:
    """One leaf laid on ``sh``'s mesh: a piece a coordinate, each a new
    allocation on its device, one for coordinates that share a device and
    a box; copied from wherever the leaf lives."""
    shape = T.shape(leaf)
    sh.shard_shape(shape)
    src = _leaf_sources(leaf)
    boxes = [sh.box(shape, coord) for coord in sh.coords()]
    made: dict = {}
    pieces = []
    for box, dev in zip(boxes, sh.mesh.devices):
        key = (normalize_device(dev), box)
        if key not in made:
            made[key] = C.gather_boxes(src, [(box, dev)])[0]
        pieces.append(made[key])
    return Placed(sh.mesh, sh.spec, shape, pieces[0].dtype, boxes, pieces)


def zeros_on(sh: NamedSharding, shape, dtype) -> Placed:
    """A zero leaf of ``shape`` laid on ``sh``'s mesh, each piece
    allocated on its device."""
    shape = tuple(shape)
    boxes = [sh.box(shape, coord) for coord in sh.coords()]
    made: dict = {}
    pieces = []
    for box, dev in zip(boxes, sh.mesh.devices):
        key = (normalize_device(dev), box)
        if key not in made:
            made[key] = torch.zeros(C.box_shape(box), dtype=dtype,
                                    device=tensor_device(dev))
        pieces.append(made[key])
    return Placed(sh.mesh, sh.spec, shape, dtype, boxes, pieces)


def place(tree, shardings, *, split: bool | None = None):
    """Lay ``tree`` (a state or params: a model or a tree of tensors, or
    one already placed) on the mesh of ``shardings`` (the matching tree
    of `NamedSharding`, e.g. from `state_shardings`). Every spec must fit
    its leaf (each sharded dim divides by its axis group), a non-tensor
    leaf takes P(), and the mesh's devices must be of the leaves' device
    type; ValueError otherwise.

    Over a mesh of one device (and ``split`` not set) returns ``tree``
    itself, whose shards are views (`NamedSharding.piece`); the leaves
    must live on that device. Otherwise (or with ``split=True``) returns
    the reference's tree of the state with every tensor leaf a `Placed`,
    its pieces on their own devices."""
    items = T.ref_items(tree)
    shs = []
    for path, leaf in items:
        sh = T.at(shardings, path)
        if not isinstance(sh, NamedSharding):
            raise ValueError(f"no sharding for {_path_str(path)}")
        if isinstance(leaf, Placed) or torch.is_tensor(T.first(leaf)):
            sh.shard_shape(T.shape(leaf))
            dev = (leaf.devices[0] if isinstance(leaf, Placed)
                   else T.first(leaf).device)
            check_mesh(sh.mesh, dev)
        elif tuple(sh.spec):
            raise ValueError(f"{_path_str(path)}: a non-tensor leaf takes "
                             f"P(), not {sh.spec}")
        shs.append(sh)
    if not shs:
        return tree
    if split is None:
        split = not one_device(shs[0].mesh) or is_placed(tree)
    if not split:
        for (path, leaf), sh in zip(items, shs):
            if torch.is_tensor(T.first(leaf)) and not all(
                    same_device(d, T.first(leaf).device)
                    for d in sh.mesh.devices):
                raise ValueError(
                    f"{_path_str(path)} lives on {T.first(leaf).device}, "
                    f"not on the mesh's device {sh.mesh.devices[0]}")
        return tree
    leaves = [place_leaf(leaf, sh)
              if isinstance(leaf, Placed) or torch.is_tensor(T.first(leaf))
              else leaf for (_, leaf), sh in zip(items, shs)]
    if len(items) == 1 and items[0][0] == ():
        return leaves[0]
    return T.unflatten([p for p, _ in items], leaves)
