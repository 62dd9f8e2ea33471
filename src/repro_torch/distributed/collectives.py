"""Cross-shard merge helpers (port of the sharded-engine part of
``repro.distributed.collectives``).

The port's sharded engine is single-controller: one process holds every
shard's (B, k) list, so the reference's ``all_gather`` is a concatenation
of per-shard lists, and its wire bytes are counted from the shapes handed
to it (`allgather_bytes`) instead of parsed from compiled HLO.

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

import torch


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
