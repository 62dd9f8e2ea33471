"""RecSys model zoo: DLRM, FM, MIND, BERT4Rec (port of
``repro/models/recsys.py``) -- the ranking tier of the RAG production
stack.

  <m>_init(generator, cfg, device=)  -> the model (a `layers.ParamTree`)
  <m>_forward / <m>_loss / <m>_score(params, cfg, ...)
  from_numpy(tree, cfg, device=)     <- the reference's params pytree

``params`` is the model or its tree (``model.tree()``): the reference's
pytree of tensors, so `training` (optimizers, `make_train_step`,
checkpoints) works on it unchanged. `embedding_bag` (a gather and an
``index_add`` / ``scatter_reduce``) is the system's lookup primitive;
embedding tables are stacked (F, V, d). All of it is plain PyTorch, as
the reference computes it outside any Pallas kernel. On the card the
tables' backward and the bags' sums add by atomics, so their last bits
depend on order unless ``torch.use_deterministic_algorithms`` is on.

MIND's routing logits start from a fixed normal draw, the reference's
``jax.random.normal(fold_in(PRNGKey(17), 0), (1, K, L))``: `_routing_init`
recomputes it in numpy (threefry-2x32, the bits-to-uniform map and the
f32 inverse error function), equal to the reference's within 3e-7.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.store import resolve_device
from repro_torch.models.layers import (ParamTree, dense_init_, embed_init,
                                       fill_from_numpy, layernorm, mlp_apply)
from repro_torch.training import tree as T

Params = dict[str, Any]
NEG_INF = torch.finfo(torch.float32).min


def _p(params) -> Params:
    return T.expand(params)


# ---------------------------------------------------------------------------
# EmbeddingBag -- the gather-reduce lookup primitive
# ---------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segments: torch.Tensor, num_segments: int,
                  mode: str = "sum", weights: torch.Tensor | None = None):
    """table (V, d); ids (nnz,) int; segments (nnz,) int sorted bag ids.
    Returns (num_segments, d). mode: sum | mean | max. An empty bag is 0
    (sum, mean) or -inf (max), as the reference's segment ops give."""
    emb = table[ids]
    if weights is not None:
        emb = emb * weights[:, None]
    out = torch.zeros((num_segments, emb.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    if mode == "sum":
        return out.index_add(0, segments, emb)
    if mode == "mean":
        s = out.index_add(0, segments, emb)
        cnt = torch.zeros(num_segments, dtype=torch.float32,
                          device=emb.device).index_add(
            0, segments, torch.ones(segments.shape, device=emb.device))
        return s / torch.clamp_min(cnt, 1.0)[:, None]
    if mode == "max":
        base = torch.full_like(out, -math.inf)
        idx = segments.long()[:, None].expand_as(emb)
        return base.scatter_reduce(0, idx, emb, "amax", include_self=False)
    raise ValueError(mode)


def fielded_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables (F, V, d); ids (B, F, n_hot) -> bag-summed (B, F, d)."""
    fields = torch.arange(tables.shape[0], device=tables.device)
    return tables[fields[None, :, None], ids.to(tables.device)].sum(dim=2)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------------------
# DLRM (Naumov et al., arXiv:1906.00091) -- RM2 configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1_000_000
    embed_dim: int = 64
    bot_mlp: tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    multi_hot: int = 1
    dtype: str = "float32"

    def param_count(self) -> int:
        n = self.n_sparse * self.vocab * self.embed_dim
        dims = self.bot_mlp
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        d_inter = self.embed_dim + (self.n_sparse + 1) * self.n_sparse // 2
        dims = (d_inter,) + self.top_mlp[1:]
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return n


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _mlp_skeleton(dims, dtype, dev) -> Params:
    return {f"layer{i}": {"w": torch.empty((dims[i], dims[i + 1]), dtype=dtype,
                                           device=dev),
                          "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                           device=dev)}
            for i in range(len(dims) - 1)}


class DLRM(ParamTree):
    """{"tables" (F, V, d), "bot" MLP, "top" MLP}."""

    def __init__(self, cfg: DLRMConfig, device=None):
        dev, dtype = resolve_device(device), _dtype(cfg)
        d_inter = cfg.embed_dim + (cfg.n_sparse + 1) * cfg.n_sparse // 2
        super().__init__(cfg, {
            "tables": torch.empty((cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                                  dtype=dtype, device=dev),
            "bot": _mlp_skeleton(cfg.bot_mlp, dtype, dev),
            "top": _mlp_skeleton((d_inter,) + cfg.top_mlp[1:], dtype, dev)})


@torch.no_grad()
def dlrm_init(generator: torch.Generator, cfg: DLRMConfig,
              device=None) -> DLRM:
    """The reference's laws from ``generator`` (on ``device``): tables
    N(0, 1 / d), the MLPs' weights truncated normal / sqrt(d_in), biases
    zero. The tables are drawn a field at a time (FULL's are 6.66 GB)."""
    model = DLRM(cfg, device)
    p = model.tree()
    for table in p["tables"]:
        table.copy_(torch.empty(table.shape, dtype=torch.float32,
                                device=table.device).normal_(
            generator=generator).mul_(1.0 / np.sqrt(cfg.embed_dim)))
    for mlp in (p["bot"], p["top"]):
        for lay in mlp.values():
            dense_init_(lay["w"], generator)
    return model


def dlrm_forward(params, cfg: DLRMConfig, dense: torch.Tensor,
                 sparse_ids: torch.Tensor) -> torch.Tensor:
    """dense (B, n_dense) f32; sparse_ids (B, n_sparse, multi_hot) int ->
    logits (B,)."""
    p = _p(params)
    tables = p["tables"]
    x = mlp_apply(p["bot"], dense.to(tables.device, tables.dtype),
                  final_act=True)                                  # (B, d)
    emb = fielded_lookup(tables, sparse_ids)                       # (B, F, d)
    z = torch.cat([x[:, None, :], emb], dim=1)                     # (B, F+1, d)
    inter = torch.einsum("bid,bjd->bij", z, z)                     # dot interaction
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1,
                                device=z.device)
    flat = inter[:, iu, ju]                                        # (B, (F+1)F/2)
    top_in = torch.cat([x, flat], dim=1)
    return mlp_apply(p["top"], top_in)[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, batch: dict) -> torch.Tensor:
    logits = dlrm_forward(params, cfg, batch["dense"], batch["sparse_ids"])
    return bce_loss(logits, batch["label"].to(logits.device).float())


# ---------------------------------------------------------------------------
# FM (Rendle, ICDM'10) -- O(nk) sum-square trick
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    vocab: int = 1_000_000
    embed_dim: int = 10
    dtype: str = "float32"

    def param_count(self) -> int:
        return self.n_sparse * self.vocab * (self.embed_dim + 1) + 1


class FM(ParamTree):
    """{"v" (F, V, d), "w" (F, V), "b" ()}."""

    def __init__(self, cfg: FMConfig, device=None):
        dev, dtype = resolve_device(device), _dtype(cfg)
        super().__init__(cfg, {
            "v": torch.empty((cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                             dtype=dtype, device=dev),
            "w": torch.zeros((cfg.n_sparse, cfg.vocab), dtype=dtype,
                             device=dev),
            "b": torch.zeros((), dtype=dtype, device=dev)})


@torch.no_grad()
def fm_init(generator: torch.Generator, cfg: FMConfig, device=None) -> FM:
    """v N(0, 0.01^2), w and b zero (the reference's laws)."""
    model = FM(cfg, device)
    v = model.tree()["v"]
    v.copy_(torch.empty(v.shape, dtype=torch.float32, device=v.device)
            .normal_(generator=generator).mul_(0.01))
    return model


def fm_forward(params, cfg: FMConfig, sparse_ids: torch.Tensor):
    """sparse_ids (B, F) -> logits (B,). sum_{i<j} <v_i, v_j> =
    1/2 [(sum v)^2 - sum v^2]."""
    p = _p(params)
    ids = sparse_ids.to(p["v"].device)
    fields = torch.arange(ids.shape[1], device=ids.device)[None, :]
    v = p["v"][fields, ids]                                        # (B, F, d)
    w = p["w"][fields, ids]                                        # (B, F)
    sum_v = v.sum(dim=1)                                           # (B, d)
    second = 0.5 * (sum_v * sum_v - (v * v).sum(dim=1)).sum(dim=-1)
    return p["b"] + w.sum(dim=1) + second


def fm_loss(params, cfg: FMConfig, batch: dict) -> torch.Tensor:
    logits = fm_forward(params, cfg, batch["sparse_ids"])
    return bce_loss(logits, batch["label"].to(logits.device).float())


# ---------------------------------------------------------------------------
# MIND (Li et al., arXiv:1904.08030) -- multi-interest capsule routing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    vocab: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 1.0          # label-aware attention sharpness
    dtype: str = "float32"

    def param_count(self) -> int:
        return self.vocab * self.embed_dim + self.embed_dim * self.embed_dim


class MIND(ParamTree):
    """{"items" (V, d), "S" (d, d) bilinear map}."""

    def __init__(self, cfg: MINDConfig, device=None):
        dev, dtype = resolve_device(device), _dtype(cfg)
        d = cfg.embed_dim
        super().__init__(cfg, {
            "items": torch.empty((cfg.vocab, d), dtype=dtype, device=dev),
            "S": torch.empty((d, d), dtype=dtype, device=dev)})


@torch.no_grad()
def mind_init(generator: torch.Generator, cfg: MINDConfig,
              device=None) -> MIND:
    model = MIND(cfg, device)
    p = model.tree()
    p["items"].copy_(embed_init(generator, cfg.vocab, cfg.embed_dim,
                                p["items"].dtype, p["items"].device))
    dense_init_(p["S"], generator)
    return model


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(key, x1, x2):
    """The threefry-2x32 block cipher (20 rounds), as jax.random's."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x1, x2 = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x1 = x1 + x2
                x2 = _rotl(x2, r) ^ x1
            x1 = x1 + ks[(i + 1) % 3]
            x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """Giles' single-precision inverse error function (XLA's for f32)."""
    f32 = np.float32
    w = (-np.log1p(-x * x)).astype(f32)
    ws, wl = w - f32(2.5), np.sqrt(w) - f32(3)
    p, q = f32(2.81022636e-08), f32(-0.000200214257)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        p = f32(c) + p * ws
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        q = f32(c) + q * wl
    return (np.where(w < f32(5), p, q) * x).astype(f32)


@functools.lru_cache(maxsize=None)
def _routing_init(K: int, L: int) -> np.ndarray:
    """(1, K, L) f32: ``jax.random.normal(fold_in(PRNGKey(17), 0), (1, K,
    L))``, recomputed (partitionable threefry bits, uniform on [nextafter
    (-1, 0), 1), sqrt(2) * erfinv)."""
    zero = np.zeros(1, np.uint32)
    key = _threefry2x32((0, 17), zero, zero.copy())        # fold_in(., 0)
    n = K * L
    b1, b2 = _threefry2x32((key[0][0], key[1][0]), np.zeros(n, np.uint32),
                           np.arange(n, dtype=np.uint32))
    bits = (b1 ^ b2) >> np.uint32(9) | np.float32(1.0).view(np.uint32)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = bits.view(np.float32) - np.float32(1.0)
    u = np.maximum(lo, u * (np.float32(1) - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(1, K, L)


def mind_interests(params, cfg: MINDConfig, hist_ids: torch.Tensor,
                   hist_mask: torch.Tensor) -> torch.Tensor:
    """hist_ids (B, L) int; hist_mask (B, L) bool -> interests (B, K, d).

    B2I dynamic routing: fixed (non-learned) routing logits refined for
    capsule_iters; the logits carry no gradient, per the paper."""
    p = _p(params)
    items = p["items"]
    dev = items.device
    hist_ids, hist_mask = hist_ids.to(dev), hist_mask.to(dev)
    B, Lh = hist_ids.shape
    e = items[hist_ids] @ p["S"]                                   # (B, L, d)
    e = torch.where(hist_mask[..., None], e, 0.0)
    ef = e.float()
    logits = torch.from_numpy(_routing_init(cfg.n_interests, Lh)).to(dev) \
        * torch.ones((B, 1, 1), device=dev)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1)                           # over K
        w = torch.where(hist_mask[:, None, :], w, 0.0)
        z = torch.einsum("bkl,bld->bkd", w, ef)
        u = _squash(z)
        upd = torch.einsum("bkd,bld->bkl", u, ef)
        logits = (logits + upd).detach()
    return u.to(e.dtype)                                           # (B, K, d)


def mind_loss(params, cfg: MINDConfig, batch: dict) -> torch.Tensor:
    """Sampled-softmax training with in-batch negatives.
    batch: hist_ids (B,L), hist_mask (B,L), label_id (B,)."""
    p = _p(params)
    interests = mind_interests(p, cfg, batch["hist_ids"], batch["hist_mask"])
    label_emb = p["items"][batch["label_id"].to(interests.device)]  # (B, d)
    # label-aware attention over interests
    att = torch.einsum("bkd,bd->bk", interests, label_emb)
    att = torch.softmax(cfg.pow_p * att, dim=-1)
    user = torch.einsum("bk,bkd->bd", att, interests)              # (B, d)
    scores = (user @ label_emb.T).float()                          # (B, B)
    labels = torch.arange(scores.shape[0], device=scores.device)
    logz = torch.logsumexp(scores, dim=1)
    gold = scores.gather(1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def mind_score(params, cfg: MINDConfig, hist_ids, hist_mask,
               cand_ids: torch.Tensor) -> torch.Tensor:
    """Serving: max-over-interests dot. cand_ids (B, C) -> scores (B, C)."""
    p = _p(params)
    interests = mind_interests(p, cfg, hist_ids, hist_mask)        # (B,K,d)
    cand = p["items"][cand_ids.to(interests.device)]               # (B,C,d)
    return torch.einsum("bkd,bcd->bkc", interests, cand).amax(dim=1)


# ---------------------------------------------------------------------------
# BERT4Rec (Sun et al., arXiv:1904.06690) -- bidirectional seq encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    vocab: int = 50_000          # item vocabulary ([MASK] = vocab, +1 row)
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    dtype: str = "float32"

    @property
    def mask_id(self) -> int:
        return self.vocab

    def param_count(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 4 * d + 2 * (4 * d * d) + 4 * d + 4 * d + 2 * d
        return (self.vocab + 1) * d + self.seq_len * d + self.n_blocks * per_block


_BLOCK_MATS = ("wq", "wk", "wv", "wo", "w1", "w2")


class BERT4Rec(ParamTree):
    """{"items" (V+1, d), "pos" (S, d), "blocks": a list of per-block
    dicts (wq wk wv wo (d, d), ln1_s / ln1_b, w1 (d, 4d), b1, w2 (4d, d),
    b2, ln2_s / ln2_b)} -- a plain list, as the reference's (its paths are
    ``blocks/<i>/...``)."""

    def __init__(self, cfg: BERT4RecConfig, device=None):
        dev, dtype = resolve_device(device), _dtype(cfg)
        d = cfg.embed_dim

        def empty(*shape):
            return torch.empty(shape, dtype=dtype, device=dev)

        def full(n, value):
            return torch.full((n,), value, dtype=dtype, device=dev)

        blocks = [{"wq": empty(d, d), "wk": empty(d, d), "wv": empty(d, d),
                   "wo": empty(d, d), "ln1_s": full(d, 1.0),
                   "ln1_b": full(d, 0.0), "w1": empty(d, 4 * d),
                   "b1": full(4 * d, 0.0), "w2": empty(4 * d, d),
                   "b2": full(d, 0.0), "ln2_s": full(d, 1.0),
                   "ln2_b": full(d, 0.0)} for _ in range(cfg.n_blocks)]
        super().__init__(cfg, {"items": empty(cfg.vocab + 1, d),
                               "pos": empty(cfg.seq_len, d),
                               "blocks": blocks})


@torch.no_grad()
def bert4rec_init(generator: torch.Generator, cfg: BERT4RecConfig,
                  device=None) -> BERT4Rec:
    model = BERT4Rec(cfg, device)
    p = model.tree()
    for key in ("items", "pos"):
        t = p[key]
        t.copy_(embed_init(generator, t.shape[0], t.shape[1], t.dtype,
                           t.device))
    for blk in p["blocks"]:
        for key in _BLOCK_MATS:
            dense_init_(blk[key], generator)
    return model


def bert4rec_encode(params, cfg: BERT4RecConfig, ids: torch.Tensor,
                    pad_mask: torch.Tensor) -> torch.Tensor:
    """ids (B, S) int; pad_mask (B, S) bool -> hidden (B, S, d).
    Bidirectional (no causal mask) post-LN blocks with a GELU (tanh) FFN,
    per the paper."""
    p = _p(params)
    dev = p["items"].device
    ids, pad_mask = ids.to(dev), pad_mask.to(dev)
    B, S = ids.shape
    d, H = cfg.embed_dim, cfg.n_heads
    hd = d // H
    x = p["items"][ids] + p["pos"][None, :S]
    keep = pad_mask[:, None, None, :]                              # (B,1,1,S)
    for blk in p["blocks"]:
        q = (x @ blk["wq"]).reshape(B, S, H, hd)
        k = (x @ blk["wk"]).reshape(B, S, H, hd)
        v = (x @ blk["wv"]).reshape(B, S, H, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / np.sqrt(hd)
        s = torch.where(keep, s, NEG_INF)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, S, d) @ blk["wo"]
        x = layernorm(x + o, blk["ln1_s"], blk["ln1_b"])
        h = F.gelu(x @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"] \
            + blk["b2"]
        x = layernorm(x + h, blk["ln2_s"], blk["ln2_b"])
    return x


def bert4rec_loss(params, cfg: BERT4RecConfig, batch: dict) -> torch.Tensor:
    """Masked-item prediction (cloze). batch: ids (B,S) with [MASK]
    tokens, pad_mask (B,S), mask_positions (B,M) positions that were
    masked, mask_targets (B,M) original ids (-1 = padding entry). Hidden
    states are gathered at the M masked positions before the vocab
    projection, so the logits are (B, M, V+1), not (B, S, V+1)."""
    p = _p(params)
    h = bert4rec_encode(p, cfg, batch["ids"], batch["pad_mask"])
    pos = batch["mask_positions"].to(h.device).long()              # (B, M)
    hm = h.gather(1, pos[..., None].expand(-1, -1, h.shape[-1]))   # (B, M, d)
    logits = (hm @ p["items"].T).float()                           # (B, M, V+1)
    targets = batch["mask_targets"].to(h.device)
    sel = targets >= 0
    t = torch.clamp_min(targets, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t[..., None])[..., 0]
    return torch.sum((logz - gold) * sel) / torch.clamp_min(sel.sum(), 1)


def bert4rec_score(params, cfg: BERT4RecConfig, ids, pad_mask,
                   cand_ids: torch.Tensor) -> torch.Tensor:
    """Next-item scoring: encode with a trailing [MASK]; dot with
    candidates at the last valid position. cand_ids (B, C) -> (B, C)."""
    p = _p(params)
    h = bert4rec_encode(p, cfg, ids, pad_mask)
    last = pad_mask.to(h.device).int().sum(dim=1) - 1              # (B,)
    hb = h[torch.arange(h.shape[0], device=h.device), last]        # (B, d)
    cand = p["items"][cand_ids.to(h.device)]                       # (B,C,d)
    return torch.einsum("bd,bcd->bc", hb, cand)


# ---------------------------------------------------------------------------
# the reference's parameters
# ---------------------------------------------------------------------------

_MODELS = {DLRMConfig: DLRM, FMConfig: FM, MINDConfig: MIND,
           BERT4RecConfig: BERT4Rec}


def from_numpy(tree, cfg, device=None) -> ParamTree:
    """The port's model from the reference's params as numpy arrays
    (``jax.tree.map(np.asarray, params)``), bit for bit."""
    return fill_from_numpy(_MODELS[type(cfg)](cfg, device), tree)
