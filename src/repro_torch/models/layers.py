"""Core layers of the decoder (port of ``repro/models/layers.py``), over
plain dicts (or ``nn.ParameterDict``s) of tensors in the reference's
``x @ w`` layout: weights are (d_in, d_out).

Conventions kept from the reference: parameters are stored in the compute
dtype the config asks for (bf16 for production configs); norms and RoPE run
in f32 and cast back; the naive attention path casts its probabilities to
the query's dtype. Attention supports GQA (n_kv_heads <= n_heads), qk-norm,
QKV bias and RoPE, for prefill and single-token decode with a KV cache.

``impl="chunked"`` (or ``"auto"`` at S >= 2048) sends attention through
``kernels.flash_attention.ops.flash_attention`` and decode always goes
through ``kernels.decode_attention.ops.decode_attention``: on the card
these are the hand-written CUDA kernels, on the CPU their plain versions.
Both kernels are forward-only, as the reference's: where autograd records
(grad enabled and an input that requires grad), ``attention_full`` takes
``gqa_chunked``, the flash kernel's plain version in the (B, S, H, hd)
layout -- the reference trains through the same plain math -- and the
kernels' wrappers raise. ``unroll`` is accepted for the reference's
signatures and does nothing: PyTorch runs eagerly, with no scan to unroll.
The generic ``mlp_*`` layers belong to the recsys / gnn slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.flash_attention import ops as fa_ops

Params = dict[str, Any]
NEG_INF = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated-normal fan-in init in place (the reference's
    ``dense_init``): N(0, 1) cut at +-3, times 1 / sqrt(d_in), drawn in f32
    on ``w``'s device and cast; d_in is ``w.shape[-2]`` (an expert stack
    (E, d_in, d_out) draws each expert's matrix by its own fan-in)."""
    t = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    w.copy_(t.mul_(1.0 / np.sqrt(w.shape[-2])))


@torch.no_grad()
def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> torch.Tensor:
    """A (vocab, d) table drawn N(0, 0.02^2) in f32 and cast."""
    t = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return t.normal_(0.0, 0.02, generator=generator).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python base: no host-to-device copy (and no sync) per call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)      # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6


def _project_qkv(p: Params, spec: AttentionSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,KV,hd) with rope/qk-norm
    applied."""
    B, S, _ = x.shape
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"], spec.norm_eps)
        k = rmsnorm(k, p["k_norm"], spec.norm_eps)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def gqa_scores_softmax_out(q, k, v, mask, n_heads: int, n_kv: int):
    """Grouped-query attention core. q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd).

    mask: broadcastable to (B, KV, G, Sq, Sk) bool (True = keep).
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    G = n_heads // n_kv
    qg = q.reshape(B, Sq, n_kv, G, hd)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(q.dtype))
    return out.reshape(B, Sq, H, hd)


def gqa_chunked(q, k, v, n_heads: int, n_kv: int, *, causal: bool,
                blk_q: int = 1024, blk_k: int = 1024, unroll: bool = False):
    """Flash-style GQA attention in plain PyTorch -- the flash kernel's
    plain version (`flash_attention_plain`): an online softmax over blocks
    of blk_q x blk_k, f32 Q . K^T, bf16 P . V, f32 accumulators. Blocks may
    be ragged (the reference asserts S % blk == 0). ``unroll`` does nothing.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    qg = q.reshape(B, Sq, n_kv, n_heads // n_kv, hd)
    out = _fa.flash_attention_plain(qg, k, v, causal=causal, blk_q=blk_q,
                                    blk_k=blk_k)
    return out.reshape(B, Sq, H, hd)


def _naive_mask(S: int, causal: bool, segment_ids, device):
    mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=device)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool,
                          device=device).tril()[None, None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, None, None, :, None]
               == segment_ids[:, None, None, None, :])
        mask = mask & seg
    return mask


def attention_full(p: Params, spec: AttentionSpec, x: torch.Tensor, *,
                   positions: torch.Tensor | None = None, causal: bool = True,
                   segment_ids: torch.Tensor | None = None,
                   impl: str = "auto", unroll: bool = False) -> torch.Tensor:
    """Full self-attention (training / prefill without cache). x: (B,S,D).

    impl: "naive" materialises (Sq, Sk) scores; "chunked" runs the flash
    kernel (its plain version on the CPU) -- or, when autograd records,
    `gqa_chunked` with the reference's 1024-row blocks, since the kernel
    has no backward; "auto" takes chunked at S >= 2048. ``segment_ids``
    always takes the naive path."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, spec, x, positions)
    if impl == "auto":
        impl = "chunked" if S >= 2048 else "naive"
    if impl == "chunked" and segment_ids is None:
        if torch.is_grad_enabled() and q.requires_grad:
            out = gqa_chunked(q, k, v, spec.n_heads, spec.n_kv_heads,
                              causal=causal)
        else:
            out = fa_ops.flash_attention(q, k, v, spec.n_kv_heads,
                                         causal=causal)
    else:
        mask = _naive_mask(S, causal, segment_ids, x.device)
        out = gqa_scores_softmax_out(q, k, v, mask, spec.n_heads,
                                     spec.n_kv_heads)
    return out.reshape(B, S, -1) @ p["wo"]


def attention_prefill(p: Params, spec: AttentionSpec, x: torch.Tensor,
                      cache_len: int, impl: str = "auto",
                      unroll: bool = False, *, cache=None):
    """Prefill: causal attention AND the KV cache of length cache_len.

    Returns (out (B,S,D), (k_cache, v_cache) each (B, cache_len, KV, hd)).
    With ``cache=(k_cache, v_cache)`` the new rows are written into those
    tensors in place (positions [0, S)) and they are returned, instead of a
    padded copy: the engine passes its layer's slice of one cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, spec, x, positions)
    if impl == "auto":
        impl = "chunked" if S >= 2048 else "naive"
    if impl == "chunked":
        out = fa_ops.flash_attention(q, k, v, spec.n_kv_heads, causal=True)
    else:
        mask = _naive_mask(S, True, None, x.device)
        out = gqa_scores_softmax_out(q, k, v, mask, spec.n_heads,
                                     spec.n_kv_heads)
    out = out.reshape(B, S, -1) @ p["wo"]
    if cache is None:
        shape = (B, cache_len, spec.n_kv_heads, spec.head_dim)
        cache = (torch.zeros(shape, dtype=k.dtype, device=x.device),
                 torch.zeros(shape, dtype=v.dtype, device=x.device))
    k_cache, v_cache = cache
    k_cache[:, :S] = k
    v_cache[:, :S] = v
    return out, (k_cache, v_cache)


def attention_decode(p: Params, spec: AttentionSpec, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_index, lengths: torch.Tensor | None = None):
    """Single-token decode. x: (B, 1, D); caches (B, S_max, KV, hd);
    cur_index: int -- the number of tokens already in the cache, below
    S_max (ValueError otherwise: the reference clamps the write onto the
    last row, the port refuses).

    The new K/V row is written into the caches IN PLACE at cur_index (the
    reference's dynamic_update_slice returns a copy; a 2.43 GB cache copied
    a token is not an option), and attention runs through the decode kernel
    with lengths = cur_index + 1 for every sequence -- the reference's
    mask ``arange(S_max) <= cur_index``. ``lengths`` is that (B,) int32
    tensor when the caller has built it (``decode_step`` builds it once a
    step for all layers); None builds it here. Returns (out (B,1,D),
    (k_cache, v_cache))."""
    B = x.shape[0]
    idx = int(cur_index)
    if not 0 <= idx < k_cache.shape[1]:
        raise ValueError(f"decode at cur_index {idx} is past the KV cache: "
                         f"max_len {k_cache.shape[1]}")
    positions = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, spec, x, positions)
    k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    if lengths is None:
        lengths = torch.full((B,), idx + 1, dtype=torch.int32,
                             device=x.device)
    out = dec_ops.decode_attention(q[:, 0], k_cache, v_cache, lengths,
                                   spec.n_kv_heads, live=idx + 1)
    return out.reshape(B, 1, -1) @ p["wo"], (k_cache, v_cache)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ p["w_gate"])
            * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# generic MLP (recsys / gnn substrate)
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, dims: tuple[int, ...], dtype,
             device=None) -> Params:
    """{"layer<i>": {"w" (dims[i], dims[i+1]), "b" zeros}}, w by
    `dense_init_`'s law."""
    p = {f"layer{i}": {"w": torch.empty((dims[i], dims[i + 1]), dtype=dtype,
                                        device=device),
                       "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                        device=device)}
         for i in range(len(dims) - 1)}
    for lay in p.values():
        dense_init_(lay["w"], generator)
    return p


def mlp_apply(p: Params, x: torch.Tensor, *, final_act: bool = False):
    n = len(p)
    for i in range(n):
        lay = p[f"layer{i}"]
        x = x @ lay["w"] + lay["b"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# a model as a tree of parameters
# ---------------------------------------------------------------------------

class _Node(torch.nn.Module):
    """One dict of a parameter tree: tensors as parameters (requires_grad
    off, as the Transformer's), dicts as child nodes, lists as
    ModuleLists of nodes; keys keep their order."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, v in tree.items():
            if torch.is_tensor(v):
                self.register_parameter(
                    key, torch.nn.Parameter(v, requires_grad=False))
            elif isinstance(v, dict):
                self.add_module(key, _Node(v))
            else:
                self.add_module(key, torch.nn.ModuleList(_Node(e) for e in v))

    def as_tree(self) -> dict:
        out = {}
        for key in self._keys:
            v = getattr(self, key)
            if isinstance(v, _Node):
                v = v.as_tree()
            elif isinstance(v, torch.nn.ModuleList):
                v = [e.as_tree() for e in v]
            out[key] = v
        return out


class ParamTree(torch.nn.Module):
    """A model whose parameters are the reference's params pytree (nested
    dicts and lists of tensors). ``tree()`` gives that tree of live
    parameters, so ``training.tree``, the optimizers and the checkpoints
    work on it as on the `Transformer`. A subclass builds its skeleton
    from ``(cfg, device=)`` (the signature `checkpoint.restore` remakes a
    module by)."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.params = _Node(tree)

    def tree(self) -> dict:
        return self.params.as_tree()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def tensor_of(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, a copy (bf16 as its uint16 bit pattern or ml_dtypes'
    bfloat16, bit for bit; a 0-d array stays 0-d)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def fill_from_numpy(model: ParamTree, tree) -> ParamTree:
    """Copy the reference's params (a tree of numpy arrays of the model's
    structure) into ``model``'s parameters bit for bit; shapes and dtypes
    must match."""
    from repro_torch.training import tree as T

    def put(dst, src):
        t = tensor_of(np.asarray(src))
        if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
            raise ValueError(f"got {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)
    T.tree_map(put, model, tree)
    return model
