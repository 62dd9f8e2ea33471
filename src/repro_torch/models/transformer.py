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
reference's shard_map region run on the mesh's devices. The training
functions also take a model laid on a mesh of several devices
(`distributed.sharding.place`: a tree of `Placed` pieces) and run it
there, FSDP over the data axes and tensor parallel over "model"
(`_grid_backbone`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.store import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import dp_tp_coords, same_device, tensor_device
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
    backward pass. A placed model (`distributed.sharding.place` over
    several devices) runs on its mesh (`_Grid`); the hidden states and
    aux then come back to the mesh's first device."""
    if _placed(model):
        grid = _Grid(_mesh_of(model))
        run = _grid_backbone(model, cfg, tokens, grid)
        xs = [run.xs[c] for c in grid.first_of_rows()]
        B, S = tokens.shape
        hidden = C.move(xs, [grid.row_box(i, (B, S, cfg.d_model))
                             for i in range(grid.n_dp)],
                        [(C.full_box((B, S, cfg.d_model)),
                          grid.devs[grid.ctrl])])[0]
        return hidden, run.aux
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
    """The (D, V) head; of a placed model, gathered whole on the mesh's
    first device."""
    if _placed(model):
        grid = _Grid(_mesh_of(model))
        leaf = model["embed"] if cfg.tie_embeddings else model["lm_head"]
        w = C.gather_param(_sink(), leaf, [(C.full_box(leaf.shape),
                                            grid.devs[grid.ctrl])])[0]
        return w.T if cfg.tie_embeddings else w
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def forward(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor):
    """tokens: (B,S) int -> (logits (B,S,V) compute dtype, aux_loss f32)."""
    x, aux = backbone(model, cfg, tokens)
    return x @ lm_head_matrix(model, cfg), aux


def loss_fn(model: Transformer, cfg: TransformerConfig, batch: dict):
    """batch: {tokens (B,S), labels (B,S)}; labels == -1 are masked. Mean
    next-token cross-entropy in f32 plus ``moe_aux_weight`` x aux. A
    placed model computes it vocab-parallel on its mesh, as
    `make_vp_loss_fn` does (the same quantity: no device holds a whole
    row of logits)."""
    if _placed(model):
        return _grid_loss(model, cfg, batch, _Grid(_mesh_of(model)))
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

    Mesh coordinate (i, j) holds data shard i's rows (b = B / n_dp) and
    vocab slice j of the head (the vocab padded with zero columns to a
    multiple of n_tp, which the softmax masks to finfo(f32).min), and
    computes only its (b, S, V_pad / n_tp) f32 logits:

        m     = max over the tp slices of each slice's row max
        logz  = m + log(all-reduce over tp of sum exp(logits - m))
        gold  = all-reduce over tp of the label's logit where the slice
                holds it
        loss  = all-reduce over dp of sum (logz - gold) over labelled
                tokens / the count of them

    The reference runs this as a shard_map region; the port runs it on
    the mesh's devices (`_Grid`), every sum in shard order
    (``distributed.collectives``). A model on one device sends each
    coordinate its rows of the hidden states and its slice of the head
    (views where the coordinate is the model's device); a placed model
    gathers them where they are computed. m is detached
    (logz does not depend on it; the reference's gradient through it is
    zero analytically). Labels -1 are masked. The mesh's devices must be
    of the model's device type, a placed model's mesh must be ``mesh``'s
    shape, and the batch must divide by the dp shards, else
    ValueError."""
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"the vocab-parallel loss needs a {tp_axis!r} mesh "
                         f"axis; the mesh has {mesh.axis_names}")
    grid = _Grid(mesh, tp_axis)

    def loss(model, batch: dict):
        if _placed(model):
            own = _mesh_of(model)
            if dict(own.shape) != dict(mesh.shape) or \
                    own.axis_names != mesh.axis_names:
                raise ValueError(f"the model is placed on a {dict(own.shape)} "
                                 f"mesh, the loss is over {dict(mesh.shape)}")
            return _grid_loss(model, cfg, batch, _Grid(own, tp_axis))
        shd.check_mesh(mesh, model.device)
        x, aux = backbone(model, cfg, batch["tokens"])
        grid.check_rows(x.shape[0])
        D = x.shape[-1]
        head = lm_head_matrix(model, cfg)
        vl = grid.vocab_slice(cfg.vocab_size)
        head = torch.nn.functional.pad(head, (0, vl * grid.n_tp
                                              - cfg.vocab_size))
        xboxes = [grid.row_box(i, x.shape) for i, _ in grid.ij]
        hboxes = [((0, D), (j * vl, (j + 1) * vl)) for _, j in grid.ij]
        if all(same_device(d, x.device) for d in grid.devs):
            # logical shards of x's device: views, nothing copied
            xs = [x[C.local(b, C.full_box(x.shape))] for b in xboxes]
            heads = [head[C.local(b, C.full_box(head.shape))]
                     for b in hboxes]
        else:
            xs = C.move([x], [C.full_box(x.shape)],
                        list(zip(xboxes, grid.devs)))
            heads = C.move([head], [C.full_box(head.shape)],
                           list(zip(hboxes, grid.devs)))
        xent = _grid_xent(xs, heads, batch["labels"], grid, cfg.vocab_size)
        xent = C.move([xent], [()], [((), x.device)])[0]
        return xent + cfg.moe_aux_weight * aux

    return loss


# ---------------------------------------------------------------------------
# training over a placed model: its pieces on the devices of a mesh
# ---------------------------------------------------------------------------

def _placed(model) -> bool:
    return isinstance(model, dict) and shd.is_placed(model)


def _mesh_of(model):
    return shd.placed_mesh(model)


def _sink() -> torch.Tensor:
    """The scalar that puts gathered parameter blocks in the graph
    (`collectives.gather_param`)."""
    return torch.zeros((), requires_grad=True)


class _Grid:
    """A mesh read as (data shard i, tp slice j) a coordinate, in
    ``mesh.devices`` order: i runs over the axes other than ``tp_axis``
    (major first), j over ``tp_axis`` (0 without one). ``devs`` are the
    mesh's entries, ``rows[i]`` the coordinates of data shard i by j (a
    tp group)."""

    def __init__(self, mesh, tp_axis: str = "model"):
        names = mesh.axis_names
        self.n_tp = mesh.shape[tp_axis] if tp_axis in names else 1
        dp_axes = tuple(a for a in names if a != tp_axis)
        self.n_dp = int(np.prod([mesh.shape[a] for a in dp_axes]))
        self.ij = dp_tp_coords(mesh, tp_axis)
        self.devs = list(mesh.devices)
        self.rows = [[c for c, (ci, _) in sorted(
            enumerate(self.ij), key=lambda e: e[1][1]) if ci == i]
            for i in range(self.n_dp)]
        self.ctrl = self.rows[0][0]     # (0, 0): where the loss lands

    def first_of_rows(self) -> list:
        return [row[0] for row in self.rows]

    def check_rows(self, B: int) -> None:
        if B % self.n_dp:
            raise ValueError(f"batch {B} does not divide over the "
                             f"{self.n_dp} data-parallel shards of the mesh")

    def row_box(self, i: int, shape) -> tuple:
        b = shape[0] // self.n_dp
        return ((i * b, (i + 1) * b),) + C.full_box(shape[1:])

    def vocab_slice(self, V: int) -> int:
        return -(-V // self.n_tp)

    def all_reduce_rows(self, xs: list) -> list:
        """``xs`` (one a coordinate) all-reduced over each tp group."""
        out = list(xs)
        for row in self.rows:
            for c, y in zip(row, C.all_reduce([xs[c] for c in row])):
                out[c] = y
        return out

    def rows_of(self, t: torch.Tensor) -> list:
        """Data shard i's rows of ``t`` on each coordinate's device."""
        self.check_rows(t.shape[0])
        return C.gather_boxes([(C.full_box(t.shape), t, t.device)],
                              [(self.row_box(i, t.shape), d)
                               for (i, _), d in zip(self.ij, self.devs)])


def _block(shape, dim, j: int, n: int) -> tuple:
    """The full box of ``shape`` with dimension ``dim`` cut to slice j of
    n (whole with ``dim`` None)."""
    box = list(C.full_box(shape))
    if dim is not None:
        size = shape[dim] // n
        box[dim] = (j * size, (j + 1) * size)
    return tuple(box)


# the dimension of each per-layer weight that a tp slice cuts
_ATTN_CUT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}
_FFN_CUT = {"w_gate": 1, "w_up": 1, "w_down": 0}
_MOE_CUT = {"router": None, "w_gate": 2, "w_up": 2, "w_down": 1}


class _GridRun:
    def __init__(self, xs, aux, emb):
        self.xs, self.aux, self.emb = xs, aux, emb


def _grid_backbone(params: dict, cfg: TransformerConfig, tokens, grid: _Grid,
                   sink=None) -> _GridRun:
    """The backbone over a placed model. Coordinate (i, j) runs data shard
    i's rows on tp slice j: its heads of wq / wk / wv / wo, its columns of
    w_gate / w_up and rows of w_down (an expert's, in an MoE layer), its
    vocab rows of embed; a block the tp slices do not divide (heads or
    KV heads, d_ff, the vocab) runs whole on every slice. Each layer's
    blocks are gathered from the pieces that hold them just before use
    (`collectives.gather_param`) and, under ``cfg.remat``, freed after the
    layer's forward and gathered again by its recomputation (a reentrant
    checkpoint a layer). The partial
    sums after wo, w_down and a split embedding lookup are all-reduced
    over the tp group. Returns the final-norm hidden states a coordinate
    (data shard i's rows, the same on every j), the aux loss on the
    mesh's first device and the embedding blocks (the tied head reads
    them)."""
    sink = _sink() if sink is None else sink
    n, ij, devs = grid.n_tp, grid.ij, grid.devs
    V, D, H, KV, F = (cfg.vocab_size, cfg.d_model, cfg.n_heads,
                      cfg.n_kv_heads, cfg.d_ff)
    split_v = n > 1 and V % n == 0
    split_attn = n > 1 and H % n == 0 and KV % n == 0
    split_ffn = n > 1 and F % n == 0

    emb = params["embed"]
    vl = V // n if split_v else V
    E = C.gather_param(sink, emb, [(((j * vl, (j + 1) * vl) if split_v
                                     else (0, V), (0, D)), d)
                                   for (_, j), d in zip(ij, devs)])
    xs = []
    for c, tok in enumerate(grid.rows_of(tokens)):
        tok = tok.long()
        if split_v:
            loc = tok - ij[c][1] * vl
            inside = (loc >= 0) & (loc < vl)
            xs.append(torch.where(inside[..., None],
                                  E[c][torch.clamp(loc, 0, vl - 1)], 0.0))
        else:
            xs.append(E[c][tok])
    if split_v:
        xs = grid.all_reduce_rows(xs)

    layers = params["layers"]
    spec = cfg.attn_spec()
    if split_attn:
        spec = dataclasses.replace(spec, n_heads=H // n, n_kv_heads=KV // n)
    ffn_key = "moe" if cfg.is_moe else "ffn"
    ffn_cut = (_MOE_CUT if cfg.is_moe else _FFN_CUT) if split_ffn else {}
    attn_cut = _ATTN_CUT if split_attn else {}

    def gather(leaf, l, dim):
        per = leaf.shape[1:]
        return [t.squeeze(0) for t in C.gather_param(
            sink, leaf, [(((l, l + 1),) + _block(per, dim, j, n), d)
                         for (_, j), d in zip(ij, devs)])]

    def layer(l, *xs):
        an = gather(layers["attn_norm"], l, None)
        pa = {k: gather(v, l, attn_cut.get(k)) for k, v in
              layers["attn"].items()}
        a = [L.attention_full({k: w[c] for k, w in pa.items()}, spec,
                              L.rmsnorm(x, an[c], cfg.norm_eps), causal=True,
                              impl=cfg.attn_impl) for c, x in enumerate(xs)]
        if split_attn:
            a = grid.all_reduce_rows(a)
        xs = [x + y for x, y in zip(xs, a)]
        fn = gather(layers["ffn_norm"], l, None)
        pf = {k: gather(v, l, ffn_cut.get(k)) for k, v in
              layers[ffn_key].items()}
        hs = [L.rmsnorm(x, fn[c], cfg.norm_eps) for c, x in enumerate(xs)]
        if cfg.is_moe:
            ys, aux = _grid_moe(pf, cfg, hs, grid)
        else:
            ys = [L.swiglu({k: w[c] for k, w in pf.items()}, h)
                  for c, h in enumerate(hs)]
            aux = torch.zeros((), dtype=torch.float32,
                              device=tensor_device(devs[grid.ctrl]))
        if split_ffn:
            ys = grid.all_reduce_rows(ys)
        return (*[x + y for x, y in zip(xs, ys)], aux)

    auxs = []
    for l in range(cfg.n_layers):
        if cfg.remat and torch.is_grad_enabled():
            # reentrant: the recomputation runs once, inside this layer's
            # backward node; the non-reentrant form recomputes from the
            # first saved tensor unpacked, and with a layer on several
            # cards two devices' backward threads unpack at once
            *xs, aux = checkpoint(layer, l, *xs, use_reentrant=True,
                                  preserve_rng_state=False)
        else:
            *xs, aux = layer(l, *xs)
        auxs.append(aux)
    fin = C.gather_param(sink, params["final_norm"],
                         [(C.full_box((D,)), d) for d in devs])
    xs = [L.rmsnorm(x, fin[c], cfg.norm_eps) for c, x in enumerate(xs)]
    return _GridRun(xs, torch.stack(auxs).sum(), E)


def _grid_moe(pf: dict, cfg: TransformerConfig, hs: list, grid: _Grid):
    """One MoE layer a coordinate over its rows and its experts' slice:
    (partial outputs, aux on the mesh's first device). aux is the
    reference's: with the "scatter_shmap" dispatch under an MoE mesh, the
    mean of the aux of that mesh's data chunks (each data shard's groups
    cut into its share of them); otherwise the aux of all groups at once,
    from the routing statistics all-reduced over the data shards."""
    from repro_torch.launch.mesh import n_shards
    from repro_torch.models.moe import _MOE_MESH, chunk_aux, moe_groups
    spec = cfg.moe_spec()
    E = cfg.n_experts
    ys, stats = [], []
    for c, h in enumerate(hs):
        B, S, D = h.shape
        t = min(cfg.moe_group, S)
        y, me, ce = moe_groups({k: w[c] for k, w in pf.items()}, spec,
                               h.reshape(B * S // t, t, D))
        ys.append(y.reshape(B, S, D))
        stats.append((me, ce))
    firsts = grid.first_of_rows()
    if cfg.moe_impl == "scatter_shmap" and _MOE_MESH["mesh"] is not None:
        k = n_shards(_MOE_MESH["mesh"], _MOE_MESH["dp_axes"])
        if k % grid.n_dp:
            raise ValueError(f"{k} MoE data chunks do not divide over the "
                             f"{grid.n_dp} data shards of the placement")
        per = k // grid.n_dp
        sums = []
        for c in firsts:
            me, ce = stats[c]
            sums.append(sum(chunk_aux(a, b, E) for a, b in
                            zip(me.chunk(per), ce.chunk(per))))
        aux = C.all_reduce(sums)[0] / k
    else:
        me = C.all_reduce([stats[c][0].mean(0) for c in firsts])[0]
        ce = C.all_reduce([stats[c][1].mean(0) for c in firsts])[0]
        aux = E * torch.sum((me / grid.n_dp) * (ce / grid.n_dp))
    return ys, aux


def _grid_heads(params: dict, cfg: TransformerConfig, grid: _Grid, run,
                sink) -> list:
    """Each coordinate's (D, V_pad / n_tp) slice of the head, the vocab
    padded with zero columns to a tp multiple."""
    n, V, D = grid.n_tp, cfg.vocab_size, cfg.d_model
    vl = grid.vocab_slice(V)
    spans = [(j * vl, min((j + 1) * vl, V)) for _, j in grid.ij]
    if cfg.tie_embeddings:
        rows = run.emb[0].shape[0]
        if rows == V:          # the lookup gathered the whole table
            heads = [e[s:t].T for e, (s, t) in zip(run.emb, spans)]
        else:                  # the lookup's vocab slice is the head's
            heads = [e.T for e in run.emb]
    else:
        heads = C.gather_param(sink, params["lm_head"],
                               [(((0, D), span), d)
                                for span, d in zip(spans, grid.devs)])
    return [torch.nn.functional.pad(h, (0, vl - h.shape[1])) for h in heads]


def _grid_xent(xs: list, heads: list, labels: torch.Tensor, grid: _Grid,
               v_real: int) -> torch.Tensor:
    """The vocab-parallel mean cross-entropy from each coordinate's hidden
    rows and head slice; on the mesh's first device."""
    neg = torch.finfo(torch.float32).min
    vl = heads[0].shape[1]
    labs = grid.rows_of(labels)
    logits, gold = [], []
    for c, (x, head, lab) in enumerate(zip(xs, heads, labs)):
        off = grid.ij[c][1] * vl
        lg = (x @ head).float()
        col = off + torch.arange(vl, device=lg.device)
        lg = torch.where(col < v_real, lg, neg)
        lab = torch.clamp_min(lab, 0).long()
        in_range = (lab >= off) & (lab < off + vl)
        g = lg.gather(-1, torch.clamp(lab - off, 0, vl - 1)[..., None])[..., 0]
        logits.append(lg)
        gold.append(torch.where(in_range, g, 0.0))
    ms = [lg.detach().amax(-1) for lg in logits]
    for row in grid.rows:
        for c, m in zip(row, C.all_max([ms[c] for c in row])):
            ms[c] = m
    se = grid.all_reduce_rows([torch.exp(lg - m[..., None]).sum(-1)
                               for lg, m in zip(logits, ms)])
    gold = grid.all_reduce_rows(gold)
    firsts = grid.first_of_rows()
    nll, cnt = [], []
    for c in firsts:
        mask = labs[c] >= 0
        logz = ms[c] + torch.log(se[c])
        nll.append(torch.sum((logz - gold[c]) * mask))
        cnt.append(mask.sum().float())
    total = C.all_reduce(nll)[0]
    with torch.no_grad():
        count = C.all_reduce(cnt)[0]
    return total / torch.clamp_min(count, 1)


def _grid_loss(params: dict, cfg: TransformerConfig, batch: dict,
               grid: _Grid) -> torch.Tensor:
    """The vocab-parallel loss of a placed model on its mesh's first
    device."""
    sink = _sink()
    run = _grid_backbone(params, cfg, batch["tokens"], grid, sink)
    heads = _grid_heads(params, cfg, grid, run, sink)
    xent = _grid_xent(run.xs, heads, batch["labels"], grid, cfg.vocab_size)
    return xent + cfg.moe_aux_weight * run.aux


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
