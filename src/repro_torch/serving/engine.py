"""Batched RAG serving engine (port of ``repro/serving/engine.py``):
unified retrieval -> prompt assembly -> prefill -> decode loop.

The data layer sits where it belongs in a production stack: retrieval is
one fused device call per batch (engine-level predicates included), and its
result feeds the generator's prefill. The engine batches concurrent
requests and runs greedy or temperature decoding against one KV cache. On
the card, generation runs the port's two attention kernels: ``prefill``
takes the flash-attention kernel (``attn_impl`` "chunked", or "auto" at a
prompt of >= 2048 tokens) and every ``decode_step`` the flash-decode kernel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.executor import CompiledShapes, run_grouped
from repro_torch.api.ragdb import RagDB
from repro_torch.core.store import Store, resolve_device
from repro_torch.core.tenancy import Principal, build_predicate
from repro_torch.models import transformer as tfm


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` (the current card) and ``cuda:0`` name one card when 0 is
    the current one."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


@dataclasses.dataclass
class Request:
    """One user request: the authenticated principal, the query embedding,
    the prompt, and the caller-visible predicate clauses (recency bound +
    category list -- tenant/ACL always come from the principal)."""
    principal: Principal
    query_emb: np.ndarray          # (D,) embedding of the user query
    prompt_tokens: np.ndarray      # (<=max_prompt,) int32
    min_ts: int = 0
    categories: list[int] | None = None
    max_new_tokens: int = 16
    match_terms: Any | None = None   # lexical clause (str or term ids):
                                     # lowers through QueryBuilder.match()
                                     # -> the hybrid engine (front-door
                                     # path only; needs a lexical arena)
    fusion: str = "wsum"             # score mix for match requests


@dataclasses.dataclass
class Response:
    """Per-request serving output: retrieved-document provenance (slots,
    scores, tiers), the generated tokens, and stage timings in ms."""
    doc_slots: np.ndarray          # (k,) retrieved doc slots (provenance)
    doc_scores: np.ndarray
    tokens: np.ndarray             # generated token ids
    retrieval_ms: float
    prefill_ms: float
    decode_ms: float
    doc_tiers: np.ndarray | None = None   # (k,) 0 = hot arena, 1 = warm arena


class RAGEngine:
    """Single-model, batched-request engine.

    ``store`` is a `RagDB` (the front door: each request lowers through a
    principal's session, the batch runs as one `RagDB.execute`, fused
    groups scan the arena once) or a raw `Store` snapshot (the batch goes
    to `run_grouped`, one call per unique predicate, bucket-padded through
    the engine's own `CompiledShapes`). ``engine`` is the retrieval engine
    hint, "ref" or "cuda". ``model`` is a `Transformer` on ``device`` (the
    card unless the caller asks for another; raises with no card).
    ``scheduler=`` (a `serving.scheduler.Scheduler`, front-door path only)
    routes retrieval through admission control, deadline degradation and
    staleness-bounded serves instead of a direct `RagDB.execute`; a shed
    request serves with no retrieved context (slots -1, scores -inf),
    counted in `last_shed_requests`. `last_retrieval_device_calls`
    reports the retrieval calls per batch.
    """

    def __init__(self, store: Store | RagDB, cfg: tfm.TransformerConfig,
                 model: tfm.Transformer, *, k: int = 4, max_prompt: int = 64,
                 max_len: int = 128,
                 doc_token_fn: Callable[[int], np.ndarray] | None = None,
                 warm_doc_token_fn: Callable[[int], np.ndarray] | None = None,
                 engine: str = "ref", scheduler=None, device=None):
        if engine not in ("ref", "cuda"):
            raise ValueError(f"engine must be 'ref' or 'cuda', got {engine!r}")
        self.device = resolve_device(device)
        if not _same_device(model.device, self.device):
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"serves on {self.device}")
        if isinstance(store, RagDB):
            self.db: RagDB | None = store
            self.store = None          # serve reads live snapshots via db
        else:
            self.db = None
            self.store = store
        self._shapes = CompiledShapes()    # raw-store path's bucketed shapes
        if scheduler is not None and not isinstance(store, RagDB):
            raise ValueError("scheduler-backed retrieval needs the "
                             "front-door path -- construct with a RagDB")
        self.scheduler = scheduler
        self.last_retrieval_device_calls = 0
        self.last_shed_requests = 0
        self.cfg = cfg
        self.model = model
        self.k = k
        self.max_prompt = max_prompt
        self.max_len = max_len
        self.engine = engine
        # maps a retrieved doc slot to its "content" tokens (the corpus side
        # of the prompt); synthetic corpora supply a deterministic stub.
        # doc_token_fn indexes the HOT arena; warm-tier slots index a
        # different arena and need their own mapping -- without one they
        # contribute provenance only (counted in last_warm_docs_skipped).
        self.doc_token_fn = doc_token_fn or (lambda slot: np.asarray(
            [int(slot) % max(cfg.vocab_size - 1, 1)], np.int32))
        self.warm_doc_token_fn = warm_doc_token_fn
        self.last_warm_docs_skipped = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- prompt assembly -------------------------------------------------
    def _build_prompts(self, requests: list[Request], slots: np.ndarray,
                       tiers: np.ndarray) -> np.ndarray:
        B = len(requests)
        toks = np.zeros((B, self.max_prompt), np.int32)
        self.last_warm_docs_skipped = 0
        for i, r in enumerate(requests):
            ctx: list[int] = []
            for s, t in zip(slots[i], tiers[i]):
                if s < 0:
                    continue
                if t == 0:
                    ctx.extend(self.doc_token_fn(int(s)).tolist())
                elif self.warm_doc_token_fn is not None:
                    ctx.extend(self.warm_doc_token_fn(int(s)).tolist())
                else:
                    # warm slot with no content mapping: provenance only
                    self.last_warm_docs_skipped += 1
            joined = np.asarray(ctx + r.prompt_tokens.tolist(), np.int32)
            joined = joined[-self.max_prompt:]
            # RIGHT-aligned (left-padded) so the last prefill position is the
            # true last prompt token and decode continues at max_prompt. The
            # reference's documented simplification, kept: left pads are
            # attended (no pad masking in the prefill path).
            toks[i, self.max_prompt - len(joined):] = joined
        return toks

    # -- request lowering (front-door path) -------------------------------
    def _lower_request(self, r: Request, q_row: np.ndarray):
        """Lower one request through the session API: tenant/ACL clauses come
        from the principal via db.session -- the engine cannot widen them."""
        b = (self.db.session(r.principal)
             .search(q_row, normalize=False)       # batch-normalised above
             .limit(self.k))
        if r.match_terms is not None:
            # a keyword-anchored request: the match clause forces the
            # hybrid engine, so the engine hint must not be pinned
            b = b.match(r.match_terms).fuse(r.fusion)
        else:
            b = b.using(self.engine)
        if r.min_ts:
            b = b.newer_than(r.min_ts)
        if r.categories is not None:
            b = b.in_categories(r.categories)
        return b.plan()

    def _serve_scheduled(self, plans):
        """Route a batch of lowered plans through the attached scheduler:
        admission control, deadline degradation and staleness-bounded
        serves all apply. Results come back in request order; a shed
        request contributes empty provenance (slots -1, -inf scores)."""
        from repro_torch.serving.scheduler import ServeRequest
        sched = self.scheduler
        now = sched.clock()
        k = plans[0].logical.k
        B = len(plans)
        scores = np.full((B, k), -np.inf, np.float32)
        slots = np.full((B, k), -1, np.int32)
        tiers = np.zeros((B, k), np.int32)
        self.last_shed_requests = 0
        admitted = set()
        for i, p in enumerate(plans):
            req = ServeRequest(plan=p, arrival_t=now, req_id=i,
                               tenant=p.pred.tenant)
            if sched.offer(req):
                admitted.add(i)
            else:
                self.last_shed_requests += 1
        for res in sched.run_until_idle():
            i = res.request.req_id
            if i in admitted:
                scores[i] = res.scores[0]
                slots[i] = res.slots[0]
                tiers[i] = res.tiers[0]
        return scores, slots, tiers

    # -- the serving step -------------------------------------------------
    def serve(self, requests: list[Request], *, greedy: bool = True,
              seed: int = 0) -> list[Response]:
        """Serve a batch end to end: grouped+bucketed retrieval -> prompt
        assembly -> batched prefill -> decode loop. Returns one `Response`
        per request, in request order."""
        B = len(requests)
        max_new = max(r.max_new_tokens for r in requests)
        if self.max_prompt + max_new > self.max_len:
            # decode would write past the KV cache (the reference clamps and
            # corrupts it): refuse before any retrieval or prefill runs
            raise ValueError(
                f"max_prompt {self.max_prompt} + max_new_tokens {max_new} "
                f"exceeds the KV cache: max_len {self.max_len}")
        t0 = time.perf_counter()
        # 1) retrieval: predicates are server-built, and the batch is
        # predicate-group batched
        q = np.stack([r.query_emb for r in requests]).astype(np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        if self.db is not None:
            plans = [self._lower_request(r, q[i]) for i, r in enumerate(requests)]
            calls0 = self.db.stats.device_calls
            if self.scheduler is not None:
                scores, slots, tiers = self._serve_scheduled(plans)
            else:
                scores, slots, tiers = self.db.execute(plans)
            self.last_retrieval_device_calls = self.db.stats.device_calls - calls0
        else:
            if any(r.match_terms is not None for r in requests):
                raise ValueError("match_terms requests need the front-door "
                                 "path -- construct RAGEngine with a RagDB "
                                 "built with lexical_cfg")
            preds = [build_predicate(r.principal, min_ts=r.min_ts,
                                     categories=r.categories)
                     for r in requests]
            scores, slots, n_calls = run_grouped(self.store, q, preds, self.k,
                                                 engine=self.engine,
                                                 shapes=self._shapes)
            tiers = np.zeros_like(slots)
            self.last_retrieval_device_calls = n_calls
        t1 = time.perf_counter()

        # 2) prefill
        prompts = self._build_prompts(requests, slots, tiers)
        tokens = torch.from_numpy(prompts).to(self.device)
        logits, cache = tfm.prefill(self.model, self.cfg, tokens,
                                    cache_len=self.max_len)
        self._sync()
        t2 = time.perf_counter()

        # 3) decode loop (greedy or temperature sampling)
        out_tokens = np.zeros((B, max_new), np.int32)
        rng = np.random.default_rng(seed)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)   # first max wins
        idx = self.max_prompt
        for t in range(max_new):
            out_tokens[:, t] = cur.cpu().numpy()
            logits, cache = tfm.decode_step(self.model, self.cfg, cur, cache,
                                            idx)
            if greedy:
                cur = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                probs = torch.softmax(logits, dim=-1).cpu().double().numpy()
                probs /= probs.sum(-1, keepdims=True)
                cur = torch.as_tensor(
                    [rng.choice(len(p_), p=p_) for p_ in probs],
                    dtype=torch.int32, device=self.device)
            idx += 1
        # the loop's final decode launch is still in flight here: sync it so
        # decode_ms charges all the decode work
        self._sync()
        t3 = time.perf_counter()

        return [Response(doc_slots=slots[i], doc_scores=scores[i],
                         tokens=out_tokens[i, : requests[i].max_new_tokens],
                         retrieval_ms=(t1 - t0) * 1e3 / B,
                         prefill_ms=(t2 - t1) * 1e3,
                         decode_ms=(t3 - t2) * 1e3,
                         doc_tiers=tiers[i])
                for i in range(B)]
