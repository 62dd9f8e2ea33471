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
holds every shard, and a shard's piece of a leaf is a zero-copy view
(`NamedSharding.piece`). `place` checks that a state can be laid on a
mesh -- every spec fits its leaf and every mesh device is the leaf's
device -- and never copies; a mesh over other devices raises, naming the
ROADMAP item it waits for.

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

from repro_torch.launch.mesh import Mesh, same_device
from repro_torch.training import tree as T

#: the ROADMAP item that parameters on their own cards wait for
OWN_CARDS = ("parameters placed on their own cards (ROADMAP queue 1, item "
             "2's remainder: it waits for a four-card cell)")


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


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def opt_pspecs(opt_state, params_pspecs, params):
    """Optimizer-state specs: leaves shaped like their param inherit its
    spec (Adam m/v); reduced-shape leaves (Adafactor vr/vc) drop the
    missing axis; anything else replicates. The first param (in flatten
    order) of a shape decides, as in the reference. Input specs must be
    rank-complete (`param_pspecs` guarantees this)."""
    by_shape: dict[tuple, P] = {}
    for path, leaf in T.ref_items(params):
        spec, shape = _get(params_pspecs, path), T.shape(leaf)
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

    def piece(self, leaf, coord: dict):
        """The shard of ``leaf`` (a tensor, or a `Group` read as its stack)
        held at mesh coordinate ``coord``: a view."""
        shape = T.shape(leaf)
        local = self.shard_shape(shape)
        starts = []
        for ax, size in zip(self._entries(len(shape)), local):
            i = 0
            for a in (() if ax is None else _group(ax)):
                i = i * self.mesh.shape[a] + coord[a]
            starts.append(i * size)
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


def check_mesh_device(mesh: Mesh, device) -> None:
    """Raise ValueError unless every device of ``mesh`` is ``device``: the
    port's mesh is logical shards of one device."""
    if not all(same_device(d, device) for d in mesh.devices):
        raise ValueError(
            f"the mesh's devices {sorted({str(d) for d in mesh.devices})} are "
            f"not the state's device {device}; {OWN_CARDS}")


def mesh_device(shardings) -> torch.device:
    """The one device of the mesh of a tree of `NamedSharding`s; ValueError
    when the mesh spans several devices."""
    def walk(node):
        if isinstance(node, NamedSharding):
            yield node
        else:
            for v in node.values():
                yield from walk(v)
    sh = next(walk(shardings), None)
    if sh is None:
        raise ValueError("shardings holds no NamedSharding")
    check_mesh_device(sh.mesh, sh.mesh.devices[0])
    return sh.mesh.devices[0]


def place(tree, shardings):
    """Lay ``tree`` (a state or params: a model or a tree of tensors) on
    the mesh of ``shardings`` (the matching tree of `NamedSharding`, e.g.
    from `state_shardings`). Checks that every spec fits its leaf (each
    sharded dim divides by its axis group) and that every mesh device is
    the leaf's device; raises ValueError otherwise. Returns ``tree``
    itself: each shard's piece is a view (`NamedSharding.piece`)."""
    for path, leaf in T.ref_items(tree):
        sh = _get(shardings, path) if path else shardings
        if not isinstance(sh, NamedSharding):
            raise ValueError(f"no sharding for {_path_str(path)}")
        if torch.is_tensor(T.first(leaf)):
            check_mesh_device(sh.mesh, T.first(leaf).device)
            sh.shard_shape(T.shape(leaf))
        elif tuple(sh.spec):
            raise ValueError(f"{_path_str(path)}: a non-tensor leaf takes "
                             f"P(), not {sh.spec}")
    return tree
