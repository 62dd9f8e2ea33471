"""Collective helpers (port of ``repro.distributed.collectives``).

The port's mesh is single-controller: one process holds every shard, so
the reference's ``all_gather`` is a concatenation of per-shard lists, its
wire bytes are counted from the shapes handed to it (`allgather_bytes`),
and a sharding constraint moves nothing (`constrain`).
`collective_bytes_of_hlo` is the reference's framework-free parser of an
HLO dump, kept for the contract: the port compiles no HLO, and its launch
tools reckon collectives by rule (``launch/dryrun.py``).

>>> import torch
>>> s, i = topk_allgather_merge(
...     [torch.tensor([[0.9, 0.5]]), torch.tensor([[0.9, 0.7]])],
...     [torch.tensor([[7, 1]]), torch.tensor([[3, 2]])], 3)
>>> s.tolist(), i.tolist()
([[0.8999999761581421, 0.8999999761581421, 0.699999988079071]], [[3, 7, 2]])
>>> allgather_bytes((8, 10), torch.float32, 4)
1280
"""
from __future__ import annotations

import math
import re

import torch


def constrain(x, mesh, spec):
    """The reference's ``with_sharding_constraint``: on the one-controller
    mesh no data moves, so this checks that every entry of ``spec`` names
    axes of ``mesh`` and that ``x`` lives on the mesh's device
    (`sharding.check_mesh_device`), and returns ``x`` itself."""
    from repro_torch.distributed.sharding import check_mesh_device
    for entry in spec:
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            if axis not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {axis!r}; the mesh "
                                 f"has {mesh.axis_names}")
    check_mesh_device(mesh, x.device)
    return x


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
