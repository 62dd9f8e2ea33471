"""Trees of tensors for the training stack -- the port's stand-in for
``jax.tree_util`` over nested dicts, lists and tuples.

Two views of one tree:

* the structural one (`leaves`, `tree_map`): every tensor where it sits;
* the reference's one (`ref_items`): the leaves in ``jax.tree_util``'s
  flatten order (dict keys sorted, sequences by index) as the reference's
  pytree holds them. The reference stacks its scanned layers on a leading
  n_layers axis, while the port keeps one module a layer, so a list of
  dicts (``layers``) reads as ONE dict whose every leaf is a `Group`: the
  per-layer tensors the reference holds as one stacked array.

An ``nn.Module`` with a ``tree()`` method (`models.transformer.Transformer`)
reads as that tree. Optimizer states and checkpoints live in the
reference's view, so a state's leaves, paths, shapes and dtypes are the
reference's.
"""
from __future__ import annotations

import torch


class Group(list):
    """The per-layer tensors of one leaf of the reference's stacked
    layers, in layer order."""


def expand(node):
    """A module with ``tree()`` as its tree; anything else as it is."""
    tree = getattr(node, "tree", None)
    return tree() if callable(tree) and isinstance(node, torch.nn.Module) \
        else node


def _is_layer_list(node, path) -> bool:
    return bool(path) and path[-1] == "layers" and isinstance(node, list) \
        and bool(node) and all(isinstance(e, dict) for e in node)


def ref_items(tree, prefix=()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs in the reference's flatten order; a leaf of a
    layer list is a `Group`."""
    node = expand(tree)
    if isinstance(node, dict):
        return [item for key in sorted(node)
                for item in ref_items(node[key], prefix + (key,))]
    if _is_layer_list(node, prefix):
        return [(prefix + path, Group(at(e, path) for e in node))
                for path, _ in ref_items(node[0])]
    if isinstance(node, (list, tuple)):
        return [item for i, v in enumerate(node)
                for item in ref_items(v, prefix + (i,))]
    return [(prefix, node)]


def at(node, path):
    """The node of ``node`` at ``path`` (modules read as their trees)."""
    for key in path:
        node = expand(node)[key]
    return node


def first(leaf):
    """A reference leaf's first tensor: layer 0 of a `Group`, else itself."""
    return leaf[0] if isinstance(leaf, Group) else leaf


def shape(leaf) -> tuple:
    """A reference leaf's shape: a `Group` as its (n_layers, ...) stack; ()
    for a non-tensor leaf (the step)."""
    if isinstance(leaf, Group):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(getattr(leaf, "shape", ()))


def f32_zeros(tree) -> dict:
    """An f32 zero tensor for every leaf of ``tree``'s reference view, on
    the leaf's device (a placed leaf's: f32 zero pieces of its layout):
    the reference's structure (optimizer moments, error-feedback
    residuals)."""
    items = ref_items(tree)
    return unflatten([path for path, _ in items],
                     [leaf.zeros(torch.float32) if hasattr(leaf, "zeros")
                      else torch.zeros(shape(leaf), dtype=torch.float32,
                                       device=first(leaf).device)
                      for _, leaf in items])


def stacked(leaf) -> torch.Tensor:
    """A reference leaf as one tensor: a `Group` stacked on a new leading
    axis (a copy), a tensor as it is."""
    return torch.stack(list(leaf)) if isinstance(leaf, Group) else leaf


def unflatten(paths, values) -> dict:
    """A nested dict from (path, value) pairs: the reference's structure."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def leaves(tree) -> list:
    """Every tensor (or other leaf) of the tree in structural order."""
    node = expand(tree)
    if isinstance(node, dict):
        return [x for key in sorted(node) for x in leaves(node[key])]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in leaves(v)]
    return [node]


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves of trees of one structure (modules
    expanded), in `leaves`' order; returns plain dicts (keys sorted) /
    lists / tuples."""
    node, others = expand(tree), [expand(r) for r in rest]
    if isinstance(node, dict):
        return {key: tree_map(fn, node[key], *(o[key] for o in others))
                for key in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(tree_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(node))
    return fn(node, *others)


def rebuild(like, values: dict, on_module=None):
    """``like``'s structure with its reference leaves replaced: ``values``
    maps each reference path to the new value (for a `Group` path, a
    stacked value indexed by layer). Dicts, lists and tuples are rebuilt;
    a module's tree is rebuilt and handed to ``on_module(module, tree)``,
    whose result takes the module's place (the tree itself without it)."""
    def go(node, path, layer):
        tree = expand(node)
        if tree is not node:
            new = go(tree, path, layer)
            return on_module(node, new) if on_module else new
        if isinstance(node, dict):
            return {k: go(v, path + (k,), layer) for k, v in node.items()}
        if _is_layer_list(node, path):
            return [go(e, path, i) for i, e in enumerate(node)]
        if isinstance(node, (list, tuple)):
            return type(node)(go(v, path + (i,), layer)
                              for i, v in enumerate(node))
        v = values[path]
        return v if layer is None else v[layer]
    return go(like, (), None)
