"""Decoder-only transformer, dense and MoE (port of
``repro/models/transformer.py``).

  init(cfg, generator=, device=)                    -> Transformer
  from_numpy(tree, cfg, device=) / to_numpy(model)  <-> the reference's
                                                       params pytree
  backbone(model, cfg, tokens)             -> (hidden (B,S,D), aux)   # train
  forward(model, cfg, tokens)              -> (logits (B,S,V), aux)   # train
  loss_fn(model, cfg, batch)               -> scalar f32              # train
  make_vp_loss_fn(cfg, mesh)               -> loss(model, batch)      # train
  make_cache(cfg, batch, max_len, device=)          -> {"k", "v"}
  prefill(model, cfg, tokens, cache_len)            -> (logits_last, cache)
  decode_step(model, cfg, token, cache, cur_index)  -> (logits, cache)

The weights keep the reference's ``x @ w`` layout (d_in, d_out), so moving
the reference's parameters across is a copy, never a transpose. Layers are
a Python loop (``cfg.unroll_layers`` is accepted and does nothing); with
``cfg.remat`` the training path checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint``. Parameters are built with ``requires_grad=False``:
serving runs under ``no_grad`` and ``training.train_loop.init_state``
switches them on. The training path's attention is plain PyTorch (the
flash kernel is forward-only; ``layers.attention_full``). The KV cache is
written in place: ``prefill`` fills positions [0, S) of a cache it
allocates, ``decode_step`` writes position cur_index of the cache it is
given and returns the same tensors. ``make_vp_loss_fn`` is the
vocab-parallel loss over a single-controller mesh (`launch.mesh`): the
reference's shard_map region run shard by shard on the mesh's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.store import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoESpec, moe_apply

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # None -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # numerics / compilation
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: bool = True
    attn_impl: str = "auto"      # "naive" | "chunked" | "auto" (see layers)
    moe_group: int = 1024        # tokens per MoE dispatch group
    unroll_layers: bool = False  # accepted; the port always loops in Python
    moe_impl: str = "einsum"     # "einsum" | "scatter"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_spec(self) -> L.AttentionSpec:
        return L.AttentionSpec(
            d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.hd, qk_norm=self.qk_norm, qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps)

    def moe_spec(self) -> MoESpec:
        return MoESpec(d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
                       top_k=self.top_k, capacity_factor=self.capacity_factor,
                       impl=self.moe_impl)

    def param_count(self) -> int:
        """Exact parameter count (for 6·N·D roofline accounting)."""
        D, hd, H, KV, F, V = self.d_model, self.hd, self.n_heads, self.n_kv_heads, self.d_ff, self.vocab_size
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.qkv_bias:
            attn += H * hd + 2 * KV * hd
        if self.qk_norm:
            attn += 2 * hd
        if self.is_moe:
            ffn = D * self.n_experts + self.n_experts * 3 * D * F
        else:
            ffn = 3 * D * F
        per_layer = attn + ffn + 2 * D
        head = 0 if self.tie_embeddings else D * V
        return V * D + self.n_layers * per_layer + D + head

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * self.n_experts * 3 * D * F
        return dense_like + self.n_layers * self.top_k * 3 * D * F


def compute_dtype(cfg: TransformerConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm block: ``attn_norm``, ``attn`` (a ParameterDict with the
    reference's keys wq / wk / wv / wo, bq / bk / bv, q_norm / k_norm),
    ``ffn_norm``, and ``ffn`` (w_gate / w_up / w_down) or, in an MoE
    config, ``moe`` (router (D, E) f32 in any model, w_gate / w_up
    (E, D, F), w_down (E, F, D))."""

    def __init__(self, cfg: TransformerConfig, dtype, device):
        super().__init__()
        D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cfg.d_ff)
        self.attn_norm = _param((D,), dtype, device, 1.0)
        attn = {"wq": _param((D, H * hd), dtype, device),
                "wk": _param((D, KV * hd), dtype, device),
                "wv": _param((D, KV * hd), dtype, device),
                "wo": _param((H * hd, D), dtype, device)}
        if cfg.qkv_bias:
            attn.update(bq=_param((H * hd,), dtype, device, 0.0),
                        bk=_param((KV * hd,), dtype, device, 0.0),
                        bv=_param((KV * hd,), dtype, device, 0.0))
        if cfg.qk_norm:
            attn.update(q_norm=_param((hd,), dtype, device, 1.0),
                        k_norm=_param((hd,), dtype, device, 1.0))
        self.attn = nn.ParameterDict(attn)
        self.ffn_norm = _param((D,), dtype, device, 1.0)
        self.ffn_key = "moe" if cfg.is_moe else "ffn"
        if cfg.is_moe:
            E = cfg.n_experts
            self.moe = nn.ParameterDict({
                "router": _param((D, E), torch.float32, device),
                "w_gate": _param((E, D, F), dtype, device),
                "w_up": _param((E, D, F), dtype, device),
                "w_down": _param((E, F, D), dtype, device)})
        else:
            self.ffn = nn.ParameterDict({
                "w_gate": _param((D, F), dtype, device),
                "w_up": _param((D, F), dtype, device),
                "w_down": _param((F, D), dtype, device)})

    @property
    def ffn_params(self) -> nn.ParameterDict:
        """``moe`` in an MoE layer, ``ffn`` in a dense one."""
        return getattr(self, self.ffn_key)


class Transformer(nn.Module):
    """The decoder's parameters, named as the reference's tree: ``embed``,
    ``layers[i]`` (`DecoderLayer`), ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (D, V). Construction allocates
    uninitialised weights on ``device`` (the card unless the caller asks
    for another; raises with no card); `init` and `from_numpy` fill them."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = compute_dtype(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), dtype, dev, 1.0)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((cfg.d_model, cfg.vocab_size), dtype, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> dict:
        """The live parameters as the reference's params tree, except that
        ``layers`` is a list of one dict a layer where the reference stacks
        each leaf on a leading n_layers axis (``training.tree`` reads the
        list as those stacked leaves)."""
        def layer_tree(m: DecoderLayer) -> dict:
            return {"attn_norm": m.attn_norm, "ffn_norm": m.ffn_norm,
                    "attn": dict(m.attn.items()),
                    m.ffn_key: dict(m.ffn_params.items())}
        t = {"embed": self.embed, "final_norm": self.final_norm,
             "layers": [layer_tree(m) for m in self.layers]}
        if self.lm_head is not None:
            t["lm_head"] = self.lm_head
        return t


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init(cfg: TransformerConfig, *, generator: torch.Generator,
         device=None) -> Transformer:
    """A model with the reference's init laws, drawn from ``generator``
    (which must live on ``device``): dense weights truncated normal / sqrt
    (d_in) (experts: / sqrt of their own d_in; the router f32), embeddings
    N(0, 0.02^2), norms one, biases zero. The numbers
    differ from ``repro``'s ``init`` (another generator); the tests carry
    the reference's parameters across with `from_numpy`."""
    model = Transformer(cfg, device=device)
    t = torch.empty(model.embed.shape, dtype=torch.float32,
                    device=model.device)
    model.embed.copy_(t.normal_(0.0, 0.02, generator=generator))
    del t
    for layer in model.layers:
        for key in ("wq", "wk", "wv", "wo"):
            L.dense_init_(layer.attn[key], generator)
        for key in ("router", "w_gate", "w_up", "w_down"):
            if key in layer.ffn_params:
                L.dense_init_(layer.ffn_params[key], generator)
    if model.lm_head is not None:
        L.dense_init_(model.lm_head, generator)
    return model


_tensor_of = L.tensor_of


@torch.no_grad()
def from_numpy(tree: dict, cfg: TransformerConfig, device=None) -> Transformer:
    """The port's model from the reference's parameters as numpy arrays
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``layers`` stacked on
    a leading n_layers axis (``layers.ffn.*`` or ``layers.moe.*``),
    ``final_norm``, ``lm_head``. Every tensor is copied bit for bit into its
    parameter's storage (the compute dtype; an MoE router f32); shapes and
    dtypes must match."""
    model = Transformer(cfg, device=device)

    def put(dst: torch.Tensor, src, name: str):
        t = _tensor_of(np.asarray(src))
        if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)

    put(model.embed, tree["embed"], "embed")
    put(model.final_norm, tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"], "lm_head")
    stacked = tree["layers"]
    for i, layer in enumerate(model.layers):
        put(layer.attn_norm, stacked["attn_norm"][i], f"layers.{i}.attn_norm")
        put(layer.ffn_norm, stacked["ffn_norm"][i], f"layers.{i}.ffn_norm")
        for key, p in layer.attn.items():
            put(p, stacked["attn"][key][i], f"layers.{i}.attn.{key}")
        for key, p in layer.ffn_params.items():
            put(p, stacked[layer.ffn_key][key][i],
                f"layers.{i}.{layer.ffn_key}.{key}")
    return model


def _array_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_numpy(model: Transformer) -> dict:
    """The model as the reference's tree of numpy arrays, layers stacked;
    bf16 tensors come back as their uint16 bit patterns (numpy has no
    bfloat16), which `from_numpy` takes back."""
    layers = model.layers
    ffn_key = layers[0].ffn_key
    tree = {"embed": _array_of(model.embed),
            "final_norm": _array_of(model.final_norm),
            "layers": {
                "attn_norm": np.stack([_array_of(m.attn_norm) for m in layers]),
                "ffn_norm": np.stack([_array_of(m.ffn_norm) for m in layers]),
                "attn": {k: np.stack([_array_of(m.attn[k]) for m in layers])
                         for k in layers[0].attn},
                ffn_key: {k: np.stack([_array_of(m.ffn_params[k])
                                       for m in layers])
                          for k in layers[0].ffn_params}}}
    if model.lm_head is not None:
        tree["lm_head"] = _array_of(model.lm_head)
    return tree


# ---------------------------------------------------------------------------
# layer body (shared by train / prefill / decode)
# ---------------------------------------------------------------------------

def _ffn_block(layer: DecoderLayer, cfg: TransformerConfig, x: torch.Tensor):
    """x: (B,S,D) -> (y, aux). An MoE layer dispatches groups of
    min(moe_group, S) tokens (B * S must divide by it, as the reference
    assumes); a dense layer's aux is 0."""
    h = L.rmsnorm(x, layer.ffn_norm, cfg.norm_eps)
    if cfg.is_moe:
        B, S, D = h.shape
        t = min(cfg.moe_group, S)
        y, aux = moe_apply(layer.moe, cfg.moe_spec(), h.reshape(B * S // t, t, D))
        return y.reshape(B, S, D), aux
    return L.swiglu(layer.ffn, h), 0.0


def _train_layer(layer: DecoderLayer, cfg: TransformerConfig,
                 x: torch.Tensor):
    h = L.rmsnorm(x, layer.attn_norm, cfg.norm_eps)
    x = x + L.attention_full(layer.attn, cfg.attn_spec(), h, causal=True,
                             impl=cfg.attn_impl)
    y, aux = _ffn_block(layer, cfg, x)
    return x + y, aux


# ---------------------------------------------------------------------------
# forward / loss (training)
# ---------------------------------------------------------------------------

def backbone(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor):
    """tokens: (B,S) -> (final-norm hidden states (B,S,D), aux_loss f32
    scalar). With ``cfg.remat`` and grad enabled each layer is a
    non-reentrant activation checkpoint: its inside is recomputed in the
    backward pass."""
    x = model.embed[tokens.to(model.device)]
    auxs = []
    for layer in model.layers:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_train_layer, layer, cfg, x,
                                use_reentrant=False)
        else:
            x, aux = _train_layer(layer, cfg, x)
        auxs.append(aux)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    aux = (torch.stack(auxs).sum() if cfg.is_moe
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return x, aux


def lm_head_matrix(model: Transformer, cfg: TransformerConfig) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def forward(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor):
    """tokens: (B,S) int -> (logits (B,S,V) compute dtype, aux_loss f32)."""
    x, aux = backbone(model, cfg, tokens)
    return x @ lm_head_matrix(model, cfg), aux


def loss_fn(model: Transformer, cfg: TransformerConfig, batch: dict):
    """batch: {tokens (B,S), labels (B,S)}; labels == -1 are masked. Mean
    next-token cross-entropy in f32 plus ``moe_aux_weight`` x aux."""
    logits, aux = forward(model, cfg, batch["tokens"])
    labels = batch["labels"].to(logits.device)
    mask = labels >= 0
    labels = torch.clamp_min(labels, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    xent = nll.sum() / torch.clamp_min(mask.sum(), 1)
    return xent + cfg.moe_aux_weight * aux


def make_vp_loss_fn(cfg: TransformerConfig, mesh, *, tp_axis: str = "model"):
    """Vocab-parallel cross-entropy (Megatron-LM style) over ``mesh``.

    Each (dp, tp) shard computes only its (b / n_dp, S, V_pad / n_tp) f32
    logits from its slice of the head (the vocab padded with zero columns
    to a multiple of n_tp, which the softmax masks to finfo(f32).min):

        m     = max over the tp shards of each shard's row max
        logz  = m + log(sum over tp of sum exp(logits - m))
        gold  = the label's logit, from the one shard whose range holds it
        loss  = sum of (logz - gold) over labelled tokens / their count,
                both summed over the dp shards

    The reference runs this as a shard_map region; the port's mesh is
    logical shards of one device, so the shards run in turn and the
    psums are sums over them. m is detached (logz does not depend on it;
    the reference's gradient through it is zero analytically). Labels -1
    are masked. Every mesh device must be the model's device, and the
    batch must divide by the dp shards, else ValueError."""
    from repro_torch.distributed.sharding import check_mesh_device
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"the vocab-parallel loss needs a {tp_axis!r} mesh "
                         f"axis; the mesh has {mesh.axis_names}")
    dp_axes = tuple(a for a in mesh.axis_names if a != tp_axis)
    n_dp = int(np.prod([mesh.shape[a] for a in dp_axes]))
    n_tp = mesh.shape[tp_axis]
    v_real = cfg.vocab_size
    v_pad = (-v_real) % n_tp          # pad vocab to a tp multiple (49155)
    neg = torch.finfo(torch.float32).min

    def xent(x, head, labels):
        B = x.shape[0]
        if B % n_dp:
            raise ValueError(f"batch {B} does not divide over the {n_dp} "
                             f"data-parallel shards of the mesh")
        b, v_local = B // n_dp, head.shape[1] // n_tp
        nll_sum = cnt = 0.0
        for i in range(n_dp):
            xi, lab_i = x[i * b:(i + 1) * b], labels[i * b:(i + 1) * b]
            mask = lab_i >= 0
            lab = torch.clamp_min(lab_i, 0).long()
            logits = []
            for j in range(n_tp):
                off = j * v_local
                lg = (xi @ head[:, off:off + v_local]).float()
                col = off + torch.arange(v_local, device=lg.device)
                logits.append(torch.where(col < v_real, lg, neg))
            m = torch.stack([lg.detach().amax(-1) for lg in logits]).amax(0)
            se = sum(torch.exp(lg - m[..., None]).sum(-1) for lg in logits)
            logz = m + torch.log(se)
            gold = 0.0
            for j, lg in enumerate(logits):
                off = j * v_local
                in_range = (lab >= off) & (lab < off + v_local)
                local = torch.clamp(lab - off, 0, v_local - 1)
                g = lg.gather(-1, local[..., None])[..., 0]
                gold = gold + torch.where(in_range, g, 0.0)
            nll_sum = nll_sum + torch.sum((logz - gold) * mask)
            cnt = cnt + mask.sum()
        return nll_sum / torch.clamp_min(torch.as_tensor(cnt), 1)

    def loss(model, batch: dict):
        check_mesh_device(mesh, model.device)
        x, aux = backbone(model, cfg, batch["tokens"])
        head = lm_head_matrix(model, cfg)
        if v_pad:
            head = torch.nn.functional.pad(head, (0, v_pad))
        labels = batch["labels"].to(x.device)
        return xent(x, head, labels) + cfg.moe_aux_weight * aux

    return loss


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def make_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Zeroed {"k", "v"}, each (n_layers, batch, max_len, n_kv_heads, hd)."""
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def prefill(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor,
            cache_len: int):
    """tokens: (B, S) int -> (last-position logits (B, V), cache dict). The
    head multiplies the last position only: no (B, S, V) tensor exists."""
    B, S = tokens.shape
    cache = make_cache(cfg, B, cache_len, device=model.device)
    x = model.embed[tokens.to(model.device)]
    spec = cfg.attn_spec()
    for i, layer in enumerate(model.layers):
        h = L.rmsnorm(x, layer.attn_norm, cfg.norm_eps)
        attn_out, _ = L.attention_prefill(
            layer.attn, spec, h, cache_len, impl=cfg.attn_impl,
            cache=(cache["k"][i], cache["v"][i]))
        x = x + attn_out
        y, _ = _ffn_block(layer, cfg, x)
        x = x + y
    x = L.rmsnorm(x[:, -1, :], model.final_norm, cfg.norm_eps)
    return x @ lm_head_matrix(model, cfg), cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: TransformerConfig,
                token: torch.Tensor, cache: dict, cur_index):
    """token: (B,) int; cache from make_cache / prefill; cur_index: int,
    below the cache's max_len.

    Writes position cur_index of every layer's cache in place and returns
    (logits (B, V), the same cache). Cost is O(S_max) per token. The decode
    kernel's ``lengths`` (cur_index + 1 for every sequence) is built once
    here for all layers. An MoE layer routes groups of one token. A
    cur_index at or past max_len raises ValueError
    (`layers.attention_decode`, before any cache write): the reference
    clamps the write onto the last cached row and returns logits from a
    corrupted cache; the port refuses."""
    idx = int(cur_index)
    x = model.embed[token.to(model.device)[:, None]]
    lengths = torch.full((x.shape[0],), idx + 1, dtype=torch.int32,
                         device=x.device)
    spec = cfg.attn_spec()
    for i, layer in enumerate(model.layers):
        h = L.rmsnorm(x, layer.attn_norm, cfg.norm_eps)
        attn_out, _ = L.attention_decode(layer.attn, spec, h, cache["k"][i],
                                         cache["v"][i], idx, lengths)
        x = x + attn_out
        y, _ = _ffn_block(layer, cfg, x)
        x = x + y
    x = L.rmsnorm(x[:, -1, :], model.final_norm, cfg.norm_eps)
    return x @ lm_head_matrix(model, cfg), cache
