"""Cells: (arch x shape x mesh) -> a step function and its
arguments (port of ``repro.launch.steps``).

A Cell carries everything ``launch/dryrun.py`` needs:
  fn             the step function
  args           its arguments: on the ``meta`` device (the default)
                 tensors and modules that hold shapes only, on the card
                 drawn from a seeded ``torch.Generator``
  in_shardings   `NamedSharding` tree matching args
  out_shardings  `NamedSharding` tree or None (the reference lets the
                 compiler choose)
  model_flops    napkin "useful" FLOPs for the roofline ratio
  model_bytes    minimal HBM traffic floor (global, bytes)
  note           one-line description

The cells are the reference's, family by family, with its optimizers,
sharding rules (every spec ``fit_spec``'d as the reference's ``_shard`` /
``state_shardings`` / ``named(param_pspecs)``), napkin formulas and notes,
and its two toggles: ``REPRO_LM_VP_LOSS=1`` (the vocab-parallel loss in
the LM train cell) and ``REPRO_RAG_SHARDED=1`` (the per-shard scan and
merge in the RAG query cell). Differences by design:

* the port's mesh is one controller's logical shards (`launch.mesh`):
  shardings are specs for the reckoning, no data moves;
* a train state's ``step`` is a Python int, and the LM decode cell's
  ``index`` is the Python int S - 1 where the reference passes an
  abstract int32 scalar: the reference's program reads the whole S cache
  masked, and with every row live the port's decode kernel reads as much.
  Both are reckoned as int32 scalars (``launch/dryrun.py``);
* the store's ``acl`` column and the ingest's ``acl`` are int32 holding
  the uint32 bit pattern (``core/store.py``);
* the sharded RAG query's tie check may relaunch a shard wider after
  reading values on the host (``kernels/arena_scan/sharded.py``); on
  ``meta`` the cell stops at the first launch of k + 1 entries a shard and
  its speculative merge, which is what it reckons.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch

from repro_torch.configs import Arch, get
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, NamedSharding
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import adafactor, adamw
from repro_torch.training.train_loop import init_state, make_train_step


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    model_flops: float
    note: str
    model_bytes: float = 0.0   # minimal HBM traffic floor (global, bytes)


class Draw:
    """The cell's arguments on ``device``: on ``meta`` empty tensors and
    skeleton modules (shapes only); elsewhere values from ``generator``:
    parameters by the port's inits, floats N(0, 1), ids uniform in
    [0, high), masks all true, KV caches random bf16 (the compute dtype)
    drawn one layer at a time."""

    def __init__(self, device="meta", generator: torch.Generator | None = None):
        self.device = torch.device(device)
        self.meta = self.device.type == "meta"
        if not self.meta and generator is None:
            raise ValueError("a cell off the meta device needs a generator")
        self.gen = generator

    def ints(self, shape, high: int, dtype=torch.int32) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.randint(0, high, tuple(shape), generator=self.gen,
                             dtype=dtype, device=self.device)

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=self.device)
        return t if self.meta else t.normal_(generator=self.gen)

    def ones(self, shape, dtype=torch.bool) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.ones(shape, dtype=dtype, device=self.device)

    def cache(self, cfg: tfm.TransformerConfig, B: int, S: int) -> dict:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        dt = tfm.compute_dtype(cfg)
        out = {}
        for key in ("k", "v"):
            t = torch.empty(shape, dtype=dt, device=self.device)
            if not self.meta:
                for layer in t:
                    layer.normal_(generator=self.gen)
            out[key] = t
        return out

    def lm(self, cfg: tfm.TransformerConfig) -> tfm.Transformer:
        if self.meta:
            return tfm.Transformer(cfg, device=self.device)
        return tfm.init(cfg, generator=self.gen, device=self.device)

    def model(self, skeleton, init, cfg):
        """A recsys / GNN model: ``skeleton(cfg, device=)`` on meta,
        ``init(generator, cfg, device=)`` elsewhere."""
        if self.meta:
            return skeleton(cfg, device=self.device)
        return init(self.gen, cfg, device=self.device)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map_specs(fn, spec_tree, *rest):
    """``fn`` over the `P` leaves of ``spec_tree`` and the matching nodes
    of ``rest`` (dicts and tuples walked in step)."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    return type(spec_tree)(_map_specs(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(spec_tree))


def _named(mesh, tree):
    return _map_specs(lambda s: NamedSharding(mesh, s), tree)


def _shard(mesh, spec_tree, arg_tree):
    """NamedShardings with every spec fit_spec'd against the matching
    argument's shape (divisibility-safe)."""
    return _map_specs(lambda spec, a: NamedSharding(
        mesh, shd.fit_spec(mesh, spec, tuple(a.shape))), spec_tree, arg_tree)


def _dp(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _all_axes(mesh):
    return tuple(mesh.axis_names)


def _metrics_sh(mesh):
    return _named(mesh, {"loss": P(), "grad_norm": P()})


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_optimizer(cfg: tfm.TransformerConfig):
    if cfg.param_count() >= 100e9:
        return adafactor(1e-3)
    return adamw(3e-4, weight_decay=0.1)


def _lm_train_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    cfg: tfm.TransformerConfig = arch.full
    B, S = shape["batch"], shape["seq"]
    opt = _lm_optimizer(cfg)
    state = init_state(draw.lm(cfg), opt)
    batch = {"tokens": draw.ints((B, S), cfg.vocab_size),
             "labels": draw.ints((B, S), cfg.vocab_size)}

    state_sh = shd.state_shardings(mesh, state, shd.lm_rules(mesh))
    dp = _dp(mesh)
    batch_sh = _named(mesh, {"tokens": P(dp, None), "labels": P(dp, None)})

    if os.environ.get("REPRO_LM_VP_LOSS", "0") == "1":
        # vocab-parallel cross-entropy (models/transformer.py)
        loss = tfm.make_vp_loss_fn(cfg, mesh)
    else:
        def loss(p, b):
            return tfm.loss_fn(p, cfg, b)
    fn = make_train_step(loss, opt, donate=False)

    tokens = B * S
    flops = 6.0 * cfg.active_param_count() * tokens
    pbytes = cfg.param_count() * 2.0
    # floor: read params (fwd+bwd) + grads + opt state r/w + residual stream
    mbytes = 4.0 * pbytes + 2.0 * cfg.n_layers * tokens * cfg.d_model * 2.0
    return Cell(arch.arch_id, "train", fn, (state, batch),
                (state_sh, batch_sh), (state_sh, _metrics_sh(mesh)),
                flops, f"train {B}x{S}, opt={opt.name}, FSDP{dp}xTP", mbytes)


def _lm_params_sh(mesh, model):
    return shd.named(mesh, shd.param_pspecs(model, shd.lm_rules(mesh), mesh))


class _Stand:
    """A shape stand-in for `fit_spec` (an output the cell never holds)."""

    def __init__(self, *shape):
        self.shape = shape


def _lm_prefill_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    cfg: tfm.TransformerConfig = arch.full
    B, S = shape["batch"], shape["seq"]
    model = draw.lm(cfg)
    params_sh = _lm_params_sh(mesh, model)
    dp = _dp(mesh)
    tokens_sh = _named(mesh, P(dp, None))

    def fn(params, tokens):
        return tfm.prefill(params, cfg, tokens, cache_len=S)

    cache = _Stand(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    cache_spec = {"k": P(None, dp, "model", None, None),
                  "v": P(None, dp, "model", None, None)}
    out_sh = (_shard(mesh, P(dp, "model"), _Stand(B, cfg.vocab_size)),
              _shard(mesh, cache_spec, {"k": cache, "v": cache}))
    flops = 2.0 * cfg.active_param_count() * B * S \
        + 4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * B * S * S / 2
    kv_bytes = 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2.0
    mbytes = cfg.param_count() * 2.0 + kv_bytes \
        + 2.0 * cfg.n_layers * B * S * cfg.d_model * 2.0
    return Cell(arch.arch_id, "prefill", fn,
                (model, draw.ints((B, S), cfg.vocab_size)),
                (params_sh, tokens_sh), out_sh, flops,
                f"prefill {B}x{S}, cache seq-sharded over model", mbytes)


def _lm_decode_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    cfg: tfm.TransformerConfig = arch.full
    B, S = shape["batch"], shape["seq"]
    model = draw.lm(cfg)
    params_sh = _lm_params_sh(mesh, model)
    dp = _dp(mesh)
    cache = draw.cache(cfg, B, S)
    if B == 1:
        # long-context: batch unshardable -> sequence over EVERY axis
        cache_spec = P(None, None, _all_axes(mesh), None, None)
        tok_spec = P()
        note = f"decode B=1 S={S}: KV seq-sharded over ALL axes (split-K decode)"
    else:
        cache_spec = P(None, dp, "model", None, None)
        tok_spec = P(dp)
        note = f"decode B={B} S={S}: batch over {dp}, KV seq over model"
    cache_sh = _shard(mesh, {"k": cache_spec, "v": cache_spec}, cache)

    def fn(params, cache, token, index):
        return tfm.decode_step(params, cfg, token, cache, index)

    out_sh = (_shard(mesh, P(dp if B > 1 else None, "model"),
                     _Stand(B, cfg.vocab_size)), cache_sh)
    flops = 2.0 * cfg.active_param_count() * B \
        + 4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * B * S
    kv_bytes = 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2.0
    mbytes = cfg.active_param_count() * 2.0 + kv_bytes
    # every cache row live: index S - 1 (the reference: an abstract scalar)
    return Cell(arch.arch_id, "decode", fn,
                (model, cache, draw.ints((B,), cfg.vocab_size), S - 1),
                (params_sh, cache_sh, _named(mesh, tok_spec),
                 _named(mesh, P())),
                out_sh, flops, note, mbytes)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

_RECSYS_MODELS = {
    "dlrm-rm2": (rec.DLRM, rec.dlrm_init),
    "fm": (rec.FM, rec.fm_init),
    "mind": (rec.MIND, rec.mind_init),
    "bert4rec": (rec.BERT4Rec, rec.bert4rec_init),
}


def _recsys_batch(arch: Arch, B: int, draw: Draw):
    """(batch, batch spec fn(dp), loss_fn, serve_fn)."""
    cfg = arch.full
    if arch.arch_id == "dlrm-rm2":
        batch = {"dense": draw.normal((B, cfg.n_dense)),
                 "sparse_ids": draw.ints((B, cfg.n_sparse, cfg.multi_hot),
                                         cfg.vocab),
                 "label": draw.ints((B,), 2)}

        def spec(dp):
            return {"dense": P(dp, None), "sparse_ids": P(dp, None, None),
                    "label": P(dp)}

        def loss(p, b):
            return rec.dlrm_loss(p, cfg, b)

        def serve(p, b):
            return rec.dlrm_forward(p, cfg, b["dense"], b["sparse_ids"])
    elif arch.arch_id == "fm":
        batch = {"sparse_ids": draw.ints((B, cfg.n_sparse), cfg.vocab),
                 "label": draw.ints((B,), 2)}

        def spec(dp):
            return {"sparse_ids": P(dp, None), "label": P(dp)}

        def loss(p, b):
            return rec.fm_loss(p, cfg, b)

        def serve(p, b):
            return rec.fm_forward(p, cfg, b["sparse_ids"])
    elif arch.arch_id == "mind":
        L = cfg.hist_len
        batch = {"hist_ids": draw.ints((B, L), cfg.vocab),
                 "hist_mask": draw.ones((B, L)),
                 "label_id": draw.ints((B,), cfg.vocab)}

        def spec(dp):
            return {"hist_ids": P(dp, None), "hist_mask": P(dp, None),
                    "label_id": P(dp)}

        def loss(p, b):
            return rec.mind_loss(p, cfg, b)

        def serve(p, b):
            return rec.mind_score(p, cfg, b["hist_ids"], b["hist_mask"],
                                  b["label_id"][:, None])[:, 0]
    elif arch.arch_id == "bert4rec":
        S, M = cfg.seq_len, max(1, cfg.seq_len // 10)
        batch = {"ids": draw.ints((B, S), cfg.vocab),
                 "pad_mask": draw.ones((B, S)),
                 "mask_positions": draw.ints((B, M), S),
                 "mask_targets": draw.ints((B, M), cfg.vocab)}

        def spec(dp):
            return {"ids": P(dp, None), "pad_mask": P(dp, None),
                    "mask_positions": P(dp, None),
                    "mask_targets": P(dp, None)}

        def loss(p, b):
            return rec.bert4rec_loss(p, cfg, b)

        def serve(p, b):
            return rec.bert4rec_score(p, cfg, b["ids"], b["pad_mask"],
                                      b["mask_targets"][:, :1])[:, 0]
    else:
        raise KeyError(arch.arch_id)
    return batch, spec, loss, serve


def _recsys_model(arch: Arch, draw: Draw):
    if arch.arch_id not in _RECSYS_MODELS:
        raise KeyError(arch.arch_id)
    return draw.model(*_RECSYS_MODELS[arch.arch_id], arch.full)


def _recsys_flops(arch: Arch, B: int, train: bool) -> float:
    cfg = arch.full
    mul = 6.0 if train else 2.0
    if arch.arch_id == "dlrm-rm2":
        dims = cfg.bot_mlp
        d_inter = cfg.embed_dim + (cfg.n_sparse + 1) * cfg.n_sparse // 2
        tdims = (d_inter,) + cfg.top_mlp[1:]
        dense = sum(a * b for a, b in zip(dims, dims[1:])) + \
            sum(a * b for a, b in zip(tdims, tdims[1:])) + \
            (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
        return mul * B * dense
    if arch.arch_id == "fm":
        return mul * B * cfg.n_sparse * cfg.embed_dim * 3
    if arch.arch_id == "mind":
        return mul * B * cfg.hist_len * cfg.embed_dim * cfg.embed_dim
    if arch.arch_id == "bert4rec":
        d, S = cfg.embed_dim, cfg.seq_len
        per = cfg.n_blocks * (12 * d * d + 4 * S * d) * S
        return mul * B * (per + S * d * cfg.vocab) / S  # per-sequence avg
    raise KeyError(arch.arch_id)


def _recsys_params_sh(mesh, model):
    return shd.named(mesh, shd.param_pspecs(model, shd.recsys_rules(mesh),
                                            mesh))


def _recsys_train_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    B = shape["batch"]
    opt = adamw(1e-3, weight_decay=0.0)
    state = init_state(_recsys_model(arch, draw), opt)
    state_sh = shd.state_shardings(mesh, state, shd.recsys_rules(mesh))
    dp = _dp(mesh)
    batch, spec_fn, loss, _ = _recsys_batch(arch, B, draw)
    batch_sh = _shard(mesh, spec_fn(dp), batch)
    step = make_train_step(loss, opt, donate=False)
    emb_touched = B * 64.0 * 4.0 * 8  # ids touched x dim x fp32 x (r+w, grad, opt)
    return Cell(arch.arch_id, "train", step, (state, batch),
                (state_sh, batch_sh), (state_sh, _metrics_sh(mesh)),
                _recsys_flops(arch, B, True),
                f"train B={B}, tables row-sharded over model", emb_touched)


def _recsys_serve_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    B = shape["batch"]
    model = _recsys_model(arch, draw)
    params_sh = _recsys_params_sh(mesh, model)
    dp = _dp(mesh)
    batch, spec_fn, _, serve = _recsys_batch(arch, B, draw)
    batch_sh = _shard(mesh, spec_fn(dp), batch)
    return Cell(arch.arch_id, "serve", serve, (model, batch),
                (params_sh, batch_sh), None,
                _recsys_flops(arch, B, False), f"serve B={B}",
                B * 64.0 * 4.0 * 2)


def _recsys_retrieval_cell(arch: Arch, shape: dict, mesh,
                           draw: Draw) -> Cell:
    """1 query x 1M candidates -- the paper's hot path, batched-dot (no
    loop)."""
    C = shape["n_candidates"]
    cfg = arch.full
    model = _recsys_model(arch, draw)
    params_sh = _recsys_params_sh(mesh, model)
    all_ax = _all_axes(mesh)

    if arch.arch_id in ("mind", "bert4rec"):
        # two-tower style: encode the user once, batched-dot against C items
        L = cfg.hist_len if arch.arch_id == "mind" else cfg.seq_len
        cand = draw.ints((1, C), cfg.vocab)
        args = (model, draw.ints((1, L), cfg.vocab), draw.ones((1, L)), cand)
        in_sh = (params_sh, _named(mesh, P(None, None)),
                 _named(mesh, P(None, None)),
                 _shard(mesh, P(None, all_ax), cand))
        if arch.arch_id == "mind":
            def fn(p, h, m, c):
                return rec.mind_score(p, cfg, h, m, c)
        else:
            def fn(p, i, m, c):
                return rec.bert4rec_score(p, cfg, i, m, c)
        flops = 2.0 * C * cfg.embed_dim
        note = f"retrieval 1x{C}: user tower once, candidates sharded over {all_ax}"
    else:
        # pair-scoring models: candidate-major batch (user features broadcast)
        batch, spec_fn, _, serve = _recsys_batch(arch, C, draw)
        args = (model, batch)
        in_sh = (params_sh, _shard(mesh, spec_fn(all_ax), batch))
        fn = serve
        flops = _recsys_flops(arch, C, False)
        note = f"retrieval 1x{C}: candidate-major pair scoring over {all_ax}"
    mbytes = C * float(getattr(cfg, "embed_dim", 64)) * 4.0
    return Cell(arch.arch_id, "retrieval", fn, args, in_sh, None, flops, note,
                mbytes)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gcn_cfg_for(arch: Arch, shape: dict) -> gnn_mod.GCNConfig:
    return dataclasses.replace(arch.full, d_feat=shape["d_feat"],
                               n_classes=shape["n_classes"])


def _gnn_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    kind = shape["kind"]
    cfg = _gcn_cfg_for(arch, shape)
    opt = adamw(1e-2, weight_decay=0.0)
    all_ax = _all_axes(mesh)

    if kind == "gnn_batched":
        B, Nn, Ne = shape["batch"], shape["n_nodes"], shape["n_edges"]
        batch = {"feats": draw.normal((B, Nn, cfg.d_feat)),
                 "src": draw.ints((B, Ne), Nn), "dst": draw.ints((B, Ne), Nn),
                 "edge_mask": draw.ones((B, Ne)),
                 "node_mask": draw.ones((B, Nn)),
                 "labels": draw.ints((B,), cfg.n_classes)}
        spec = {"feats": P(all_ax, None, None), "src": P(all_ax, None),
                "dst": P(all_ax, None), "edge_mask": P(all_ax, None),
                "node_mask": P(all_ax, None), "labels": P(all_ax)}

        def loss(p, b):
            return gnn_mod.gcn_loss_batched(p, cfg, b)
        flops = 6.0 * B * (Ne * cfg.d_hidden + Nn * cfg.d_feat * cfg.d_hidden)
        note = f"batched {B} graphs x ({Nn}n, {Ne}e)"
    else:
        n_dev = 1
        for a in all_ax:
            n_dev *= mesh.shape[a]
        if kind == "gnn_sampled":
            Bn = shape["batch_nodes"]
            f1, f2 = shape["fanouts"]
            Nn = Bn * (1 + f1 + f1 * f2)
            Ne = Bn * f1 + Bn * f1 * f2
            note = f"sampled fanout{shape['fanouts']} -> {Nn}n/{Ne}e per batch"
        else:
            Nn, Ne = shape["n_nodes"], shape["n_edges"]
            note = f"full graph {Nn}n/{Ne}e"
        # pad rows/edges up to mesh-divisible sizes (padded edges carry
        # edge_mask=False; padded nodes are isolated and label-masked)
        Nn = -(-Nn // n_dev) * n_dev
        Ne = -(-Ne // n_dev) * n_dev
        batch = {"feats": draw.normal((Nn, cfg.d_feat)),
                 "src": draw.ints((Ne,), Nn), "dst": draw.ints((Ne,), Nn),
                 "edge_mask": draw.ones((Ne,)),
                 "labels": draw.ints((Nn,), cfg.n_classes),
                 "label_mask": draw.ones((Nn,), torch.float32)}
        spec = {"feats": P(all_ax, None), "src": P(all_ax), "dst": P(all_ax),
                "edge_mask": P(all_ax), "labels": P(all_ax),
                "label_mask": P(all_ax)}

        def loss(p, b):
            return gnn_mod.gcn_loss(p, cfg, b)
        flops = 6.0 * (Ne * cfg.d_hidden + Nn * cfg.d_feat * cfg.d_hidden)

    state = init_state(draw.model(gnn_mod.GCN, gnn_mod.gcn_init, cfg), opt)
    state_sh = shd.state_shardings(mesh, state, shd.gnn_rules(mesh))
    step = make_train_step(loss, opt, donate=False)
    # the reference takes the product of the feats shape in int32; no shape
    # of the registry reaches 2^31 there, so Python ints give its numbers
    feat_bytes = float(batch["feats"].numel()) * 4.0
    edge_bytes = float(batch["src"].shape[-1]) * 8.0
    return Cell(arch.arch_id, shape["kind"], step, (state, batch),
                (state_sh, _shard(mesh, spec, batch)),
                (state_sh, _metrics_sh(mesh)),
                flops, note, 2.0 * feat_bytes + 3.0 * edge_bytes)


# ---------------------------------------------------------------------------
# RAG (the paper's own system)
# ---------------------------------------------------------------------------

def _rag_cell(arch: Arch, shape: dict, mesh, draw: Draw) -> Cell:
    from repro_torch.core.query import unified_query_ref
    from repro_torch.core.store import StoreConfig
    scfg: StoreConfig = arch.full
    N, D = scfg.capacity, scfg.dim
    all_ax = _all_axes(mesh)
    i32 = 1 << 30
    store = {
        "emb": draw.normal((N, D)), "tenant": draw.ints((N,), 64),
        "category": draw.ints((N,), scfg.n_categories),
        "updated_at": draw.ints((N,), i32), "acl": draw.ints((N,), i32),
        "doc_id": draw.ints((N,), i32), "version": draw.ints((N,), 4),
        "commit_ts": draw.ints((), i32), "n_live": draw.ints((), N),
    }
    row = P(all_ax)
    store_spec = {"emb": P(all_ax, None), "tenant": row, "category": row,
                  "updated_at": row, "acl": row, "doc_id": row, "version": row,
                  "commit_ts": P(), "n_live": P()}
    store_sh = _named(mesh, store_spec)

    if shape["kind"] == "rag_query":
        B, k = shape["batch"], shape["k"]
        if os.environ.get("REPRO_RAG_SHARDED", "0") == "1":
            # local top-k per shard + constant-size merge
            from repro_torch.kernels.arena_scan.sharded import \
                make_sharded_arena_scan
            scan = make_sharded_arena_scan(mesh, all_ax, N, k)

            def fn(store, q, pred):
                launched = scan.launch(store, q, pred)
                if q.device.type == "meta":
                    # the tie check reads values: reckon the first launch
                    return launched.scores, launched.slots
                return launched.finish()
            note = f"unified query B={B} k={k}: per-shard top-k + O(shards*k) merge"
        else:
            def fn(store, q, pred):
                return unified_query_ref(store, q, pred, k)
            note = f"unified query B={B} k={k} over {N}x{D} row-sharded corpus"
        args = (store, draw.normal((B, D)), draw.ints((4,), i32))
        in_sh = (store_sh, _named(mesh, P(None, None)), _named(mesh, P()))
        flops = 2.0 * B * N * D
        return Cell(arch.arch_id, "rag_query", fn, args, in_sh, None, flops,
                    note, N * (D * 4.0 + 16.0))

    # ingest: one atomic transactional write (embedding + metadata together)
    from repro_torch.core import transactions as txn
    M = shape["batch"]

    def fn(store, slots, emb, tenant, category, updated_at, acl, doc_id):
        return txn.ingest(store, scfg, slots, emb, tenant, category,
                          updated_at, acl, doc_id)

    args = (store, draw.ints((M,), N), draw.normal((M, D)),
            draw.ints((M,), 64), draw.ints((M,), scfg.n_categories),
            draw.ints((M,), i32), draw.ints((M,), i32), draw.ints((M,), i32))
    in_sh = (store_sh, _named(mesh, P()), _named(mesh, P(None, None)),
             _named(mesh, P()), _named(mesh, P()), _named(mesh, P()),
             _named(mesh, P()), _named(mesh, P()))
    return Cell(arch.arch_id, "rag_ingest", fn, args, in_sh, store_sh,
                2.0 * M * D, f"atomic ingest of {M} docs", M * D * 8.0)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, mesh, cfg_override=None, *,
               device="meta", generator: torch.Generator | None = None
               ) -> Cell:
    """The cell of (arch, shape) on ``mesh``. ``cfg_override`` replaces
    arch.full (e.g. a 1-layer variant). ``device`` is where the arguments
    live: ``meta`` (shapes only, the dry run's) or a device with a
    ``generator`` to draw them from (`Draw`). An MoE LM sets the MoE mesh
    (`models.moe.set_moe_mesh`), as the reference does: process-global
    state, which a caller that must not keep it saves and restores."""
    arch = get(arch_id)
    if cfg_override is not None:
        arch = dataclasses.replace(arch, full=cfg_override)
    shape = arch.shapes[shape_name]
    if arch.family == "lm" and getattr(arch.full, "is_moe", False):
        from repro_torch.models.moe import set_moe_mesh
        set_moe_mesh(mesh, _dp(mesh))   # used by the scatter_shmap dispatch
    draw = Draw(device, generator)
    kind = shape["kind"]
    if arch.family == "lm":
        cell = {"train": _lm_train_cell, "prefill": _lm_prefill_cell,
                "decode": _lm_decode_cell}[kind](arch, shape, mesh, draw)
    elif arch.family == "recsys":
        cell = {"train": _recsys_train_cell, "serve": _recsys_serve_cell,
                "retrieval": _recsys_retrieval_cell}[kind](arch, shape, mesh,
                                                           draw)
    elif arch.family == "gnn":
        cell = _gnn_cell(arch, shape, mesh, draw)
    elif arch.family == "rag":
        cell = _rag_cell(arch, shape, mesh, draw)
    else:
        raise KeyError(arch.family)
    cell.shape_name = shape_name
    return cell
