"""Parity of the port's paged arena-scan regime with the JAX reference's.

The paged regime scans the arena in pages of ``page_rows`` rows, one
running top-k list per page; its lists equal the resident regime's. The
same numpy inputs go through the reference's plain paged engines (its
streaming scans tiled at the page, not its interpret-mode paged kernel:
ROADMAP's note on the failing conformance cells) and through the port on
the CPU: `unified_query` / `unified_query_grouped` / `grouped_topk` /
`filtered_topk` / `hybrid_score` / the probe with ``page_rows``, which take
the paged kernel's plain version (the streaming scan at ``blk_n =
page_rows``) for CPU tensors. The kernel itself runs only on the card and
is held to the resident kernel and to its plain version by chip_smoke.py;
here a step-for-step emulator of its schedule (sub-tile selection, the
running-list rank merge, one list per page, merge rounds, finish) is held
to the dense oracle, and shown to catch the faults it guards against.

Contract (ROADMAP North star): integers exact; f32 scores within rtol =
atol = 1e-5; slots may differ only inside a run of tied scores at the k-th
place; no leaked slot. Planner and plan parity (knobs, stamping, reason
text, keys, the ``paging:`` explain line) and the executor's audits
(`paged_scans`, `rows_scanned`, `terms_scanned`) are compared exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import executor as j_executor
from repro.api.executor import CompiledShapes as JCompiledShapes
from repro.api.executor import ExecStats as JExecStats
from repro.api.executor import _finish_hot as j_finish_hot
from repro.api.executor import _launch_hybrid as j_launch_hybrid
from repro.api.executor import run_grouped_fused as j_run_grouped_fused
from repro.api.plan import LogicalPlan as JLogicalPlan
from repro.api.planner import PlannerConfig as JPlannerConfig
from repro.api.planner import compile_plan as j_compile_plan
from repro.core.query import Predicate as JPredicate
from repro.core.query import stack_predicates as j_stack
from repro.core.query import unified_query as j_unified_query
from repro.core.query import unified_query_grouped as j_unified_grouped
from repro.kernels.grouped_topk.ops import grouped_topk as j_grouped_topk
from repro.kernels.hybrid_score.ops import hybrid_score as j_hybrid_score
from repro.kernels.ivf_probe.ref import ivf_probe_scan_ref as j_probe_scan
from repro_torch.api import RagDB
from repro_torch.api import executor as t_executor
from repro_torch.api.executor import (CompiledShapes, ExecStats, _finish_hot,
                                      _launch_hybrid, run_grouped_fused)
from repro_torch.api.plan import LogicalPlan
from repro_torch.api.planner import (CostModel, PlannerConfig, compile_plan,
                                     degrade_plan)
from repro_torch.core.ivf import IVFConfig
from repro_torch.core.query import (BLOCK_ALL, Predicate, stack_predicates,
                                    unified_query, unified_query_grouped)
from repro_torch.core.store import StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.data.corpus import CorpusConfig, make_corpus
from repro_torch.kernels.arena_scan import kernel as kernel_mod
from repro_torch.kernels.arena_scan.kernel import arena_scan
from repro_torch.kernels.arena_scan.ops import _packed_meta, default_blk_n
from repro_torch.kernels.arena_scan.ref import arena_scan_ref
from repro_torch.kernels.filtered_topk.ops import filtered_topk
from repro_torch.kernels.grouped_topk import ref as grouped_ref
from repro_torch.kernels.grouped_topk.ops import grouped_topk
from repro_torch.kernels.hybrid_score.ops import hybrid_score
from repro_torch.kernels.ivf_probe.ivf_probe import ivf_probe_plain
from repro_torch.kernels.ivf_probe.ref import (gather_candidates,
                                               ivf_probe_ref,
                                               ivf_probe_scan_ref)
from tests.test_torch_arena_scan import (GEOMETRY_SPECS, NEG, NO_ROW,
                                         _before, _count, assert_no_leak,
                                         assert_topk_agree, check_geometry,
                                         jpred, np_arena, np_mask, np_meta,
                                         torch_cols, unit)

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

V, T_LANES = 64, 6
W = dict(w_dense=0.8, w_lex=1.7)


def _lanes(rng, n):
    terms = rng.integers(-1, V, (n, T_LANES)).astype(np.int32)
    lexnorm = np.where(terms >= 0, rng.random((n, T_LANES)) * 2,
                       0).astype(np.float32)
    return terms, lexnorm, (rng.random(V) * 5).astype(np.float32)


def _jcols(a):
    return (jnp.asarray(a["emb"]), jnp.asarray(a["tenant"]),
            jnp.asarray(a["updated_at"]), jnp.asarray(a["category"]),
            jnp.asarray(a["acl"]))


def _tcols(a):
    c = torch_cols(a)
    return (c["emb"], c["tenant"], c["updated_at"], c["category"], c["acl"])


# ---------------------------------------------------------------------------
# the plain paged engines against the reference's plain paged scans
# ---------------------------------------------------------------------------

# (family, B, N, D, k, G, qt, page_rows): test_arena_scan_conformance.py's
# paged cells, plus k > P, k > N, P >= N and P = 1
CELLS = [
    ("filtered", 5, 700, 48, 8, 1, 0, 256),
    ("filtered", 8, 1024, 128, 10, 1, 0, 512),
    ("filtered", 3, 513, 64, 8, 1, 0, 128),
    ("filtered", 4, 300, 16, 40, 1, 0, 32),       # k > P
    ("grouped", 8, 1000, 96, 10, 3, 0, 256),
    ("grouped", 3, 513, 64, 8, 4, 0, 128),
    ("grouped", 16, 2048, 128, 5, 7, 0, 512),
    ("grouped", 6, 300, 16, 310, 3, 0, 64),       # k > N
    ("grouped", 5, 300, 16, 12, 3, 0, 512),       # P >= N
    ("grouped", 3, 40, 8, 4, 2, 0, 1),            # P = 1
    ("ivf", 5, 512, 48, 8, 1, 0, 128),
    ("ivf", 3, 768, 32, 6, 1, 0, 256),
    ("ivf", 4, 300, 16, 70, 1, 0, 64),            # k > P, P ragged
    ("hybrid-wsum", 5, 700, 48, 8, 3, 4, 256),
    ("hybrid-wsum", 8, 1024, 128, 10, 3, 16, 512),
    ("hybrid-wsum", 3, 513, 64, 8, 4, 4, 128),
    ("hybrid-wsum", 4, 300, 16, 80, 2, 4, 32),    # k > P
    ("hybrid-rrf", 5, 700, 48, 8, 3, 4, 256),
    ("hybrid-rrf", 8, 1024, 128, 10, 3, 16, 512),
    ("hybrid-rrf", 4, 200, 16, 210, 2, 4, 1000),  # k > N, P >= N
]
IDS = [f"{f}-B{B}-N{N}-D{D}-k{k}-G{G}-qt{qt}-pg{pg}"
       for f, B, N, D, k, G, qt, pg in CELLS]


def _preds(G):
    return [Predicate(tenant=i % 3, min_ts=100) for i in range(G)]


def _filtered(rng, arena, B, N, D, k, G, qt, page):
    pred = Predicate(tenant=1, min_ts=100)
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    jstore = dict(zip(("emb", "tenant", "updated_at", "category", "acl"),
                      _jcols(arena)))
    ref = j_unified_query(jstore, jnp.asarray(q), jpred(pred), k,
                          engine="ref", page_rows=page)
    store = torch_cols(arena)
    tq = torch.from_numpy(q)
    emb, *cols = _tcols(arena)
    port = {
        "unified-ref": unified_query(store, tq, pred, k, engine="ref",
                                     page_rows=page),
        "unified-cuda": unified_query(store, tq, pred, k, engine="cuda",
                                      page_rows=page),
        "filtered_topk": filtered_topk(tq, emb, *cols, pred.as_array(), k,
                                       page_rows=page),
    }
    return ref, port, [pred], np.zeros(B, np.int32)


def _grouped(rng, arena, B, N, D, k, G, qt, page):
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    gids = rng.integers(0, G, B).astype(np.int32)
    preds = _preds(G)
    jpa = j_stack([jpred(p) for p in preds])
    ref = j_grouped_topk(q, *_jcols(arena), gids, jpa, k, use_kernel=False,
                         page_rows=page)
    store = torch_cols(arena)
    tq, tg = torch.from_numpy(q), torch.from_numpy(gids)
    pa = stack_predicates(preds)
    cols = _tcols(arena)
    meta = _packed_meta(*cols[1:])
    port = {
        "grouped-scan": grouped_topk(tq, *cols, tg, pa, k, use_kernel=False,
                                     page_rows=page),
        "grouped-kernel-plain": grouped_topk(tq, *cols, tg, pa, k,
                                             use_kernel=True,
                                             page_rows=page),
        "unified-grouped": unified_query_grouped(store, tq, tg, preds, k,
                                                 engine="cuda",
                                                 page_rows=page),
        "arena_scan": arena_scan(tq, cols[0], meta, tg, pa, k,
                                 page_rows=page),
    }
    jr = j_unified_grouped(dict(zip(("emb", "tenant", "updated_at",
                                     "category", "acl"), _jcols(arena))),
                           jnp.asarray(q), jnp.asarray(gids), jpa, k,
                           engine="ref", page_rows=page)
    assert_topk_agree(*(np.asarray(a) for a in jr), *ref)
    return ref, port, preds, gids


def _ivf(rng, arena, B, N, D, k, G, qt, page):
    """A candidate set of N positions over a 4N-row arena, ~1/8 of it dead
    member padding (slot -1); the reference's scan needs P % page == 0, so
    its candidate set is padded with dead rows (which change no result)."""
    pred = Predicate(tenant=1, min_ts=100)
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    big = np_arena(rng, 4 * N, D)
    cand = rng.permutation(4 * N)[:N].astype(np.int32)
    cand[rng.random(N) < 0.125] = -1
    t_emb, t_meta = gather_candidates(torch.from_numpy(big["emb"]),
                                      torch.from_numpy(np_meta(big)),
                                      torch.from_numpy(cand))
    c_emb, c_meta = t_emb.numpy(), t_meta.numpy()
    pad = (-N) % page
    j_emb = np.concatenate([c_emb, np.zeros((pad, D), np.float32)])
    j_meta = np.concatenate([c_meta, np.tile(np.array([[-1, 0, 0, 0, -1]],
                                                      np.int32), (pad, 1))])
    ref = j_probe_scan(jnp.asarray(q), jnp.asarray(j_emb),
                       jnp.asarray(j_meta), jpred(pred).as_array(), k,
                       blk_p=page)
    tq, pa = torch.from_numpy(q), pred.as_array()
    port = {
        "probe-scan": ivf_probe_scan_ref(tq, t_emb, t_meta, pa, k, page),
        "probe-plain": ivf_probe_plain(tq, torch.from_numpy(big["emb"]),
                                       torch.from_numpy(np_meta(big)),
                                       torch.from_numpy(cand), pa, k,
                                       page_rows=page),
    }
    legal = np_mask(big, pred)
    for name, (_, i) in port.items():
        got = i.numpy()[i.numpy() >= 0]
        assert legal[got].all(), f"{name} leaked"
        assert set(got.tolist()) <= set(cand.tolist())
    return ref, port, None, None


def _hybrid(mode):
    def lanes(rng, arena, B, N, D, k, G, qt, page):
        q = unit(rng.standard_normal((B, D)).astype(np.float32))
        terms, lexnorm, idf = _lanes(rng, N)
        qterms = rng.integers(-1, V, (B, qt)).astype(np.int32)
        qterms[:, 0] = rng.integers(0, V, B)
        gids = rng.integers(0, G, B).astype(np.int32)
        preds = _preds(G)
        kw = dict(mode=mode, **W)
        ref = j_hybrid_score(q, *_jcols(arena), jnp.asarray(terms),
                             jnp.asarray(lexnorm), jnp.asarray(idf), gids,
                             j_stack([jpred(p) for p in preds]), qterms, k,
                             use_kernel=False, page_rows=page, **kw)
        args = (torch.from_numpy(q), *_tcols(arena), torch.from_numpy(terms),
                torch.from_numpy(lexnorm), torch.from_numpy(idf),
                torch.from_numpy(gids), stack_predicates(preds),
                torch.from_numpy(qterms), k)
        port = {"hybrid": hybrid_score(*args, page_rows=page, **kw)}
        if mode == "rrf":
            lists = hybrid_score(*args, page_rows=page, lists=True, **kw)
            jl = j_hybrid_score(q, *_jcols(arena), jnp.asarray(terms),
                                jnp.asarray(lexnorm), jnp.asarray(idf), gids,
                                j_stack([jpred(p) for p in preds]), qterms,
                                k, use_kernel=False, page_rows=page,
                                lists=True, **kw)
            for j in (0, 2):
                assert_topk_agree(lists[j].numpy(), lists[j + 1].numpy(),
                                  np.asarray(jl[j]), np.asarray(jl[j + 1]))
                assert_no_leak(arena, preds, gids, lists[j + 1].numpy())
        return ref, port, preds, gids
    return lanes


FAMILIES = {"filtered": _filtered, "grouped": _grouped, "ivf": _ivf,
            "hybrid-wsum": _hybrid("wsum"), "hybrid-rrf": _hybrid("rrf")}


@pytest.mark.parametrize("family,B,N,D,k,G,qt,page", CELLS, ids=IDS)
def test_plain_paged_engines_match_reference(family, B, N, D, k, G, qt,
                                              page):
    rng = np.random.default_rng(B * 1000 + N + k)
    arena = np_arena(rng, N, D)
    ref, port, preds, gids = FAMILIES[family](rng, arena, B, N, D, k, G, qt,
                                              page)
    s_r, i_r = (np.asarray(a) for a in ref)
    for name, (s, i) in port.items():
        assert_topk_agree(s.numpy(), i.numpy(), s_r, i_r)
        if preds is not None:
            assert_no_leak(arena, preds, gids, i.numpy())


def test_default_blk_n_takes_the_page():
    assert default_blk_n(5000, 1000) == 1000
    assert default_blk_n(5000) == 8192
    with pytest.raises(ValueError, match="page_rows"):
        arena_scan(torch.zeros((1, 4)), torch.zeros((8, 4)),
                   torch.zeros((8, 4), dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32),
                   torch.zeros((1, 4), dtype=torch.int32), 2, page_rows=0)


# ---------------------------------------------------------------------------
# the paged kernel's schedule, emulated step for step
# ---------------------------------------------------------------------------

TILE = 256


def _rank_merge(a, b, n_out, pad=NO_ROW):
    """merge_kernel / fold_lists: each element of the sorted lists a and b
    placed by its rank (a binary search in the other list; a's element
    first on an exact tie), the first n_out kept."""
    out = [None] * n_out
    for e, x in enumerate(a):
        r = e + _count(b, lambda y, x=x: _before(y, x))
        if r < n_out:
            out[r] = x
    for j, x in enumerate(b):
        r = j + _count(a, lambda y, x=x: not _before(x, y))
        if r < n_out:
            out[r] = x
    assert None not in out, "merge ranks collided"
    return out


def _emulate_paged(scores, keep, k, P, *, key=None, merge_pad=NO_ROW):
    """csrc/arena_scan.cuh's paged_scan_kernel on one query row, then the
    merge rounds and finish. Page p is rows [p P, min((p + 1) P, n)); its
    block walks 256-row sub-tiles, selects each one's top k_sub = min(L,
    256) with every masked or out-of-page row as (NEG_INF, NO_ROW), folds
    it into the running list of L = min(k, P) entries (started as L
    (NEG_INF, NO_ROW) pads), and writes that list as the page's list. The
    merge rounds pad an odd list out with (NEG_INF, ``merge_pad``).
    ``key(r)`` is what the lists carry for row r (its position; a probe
    maps positions to slots only in finish). Returns (scores (k,),
    positions (k,), -1 where NEG_INF)."""
    n = len(scores)
    key = key or (lambda r: r)
    L = min(k, P)
    k_sub = min(L, TILE)
    lists = []
    for pb in range(0, n, P):
        pe = min(pb + P, n)
        run = [(NEG, NO_ROW)] * L
        for base in range(pb, pe, TILE):
            ent = [(float(scores[r]), key(r)) if r < pe and keep[r]
                   else (NEG, NO_ROW) for r in range(base, base + TILE)]
            ent.sort(key=lambda e: (-e[0], e[1]))
            run = _rank_merge(run, ent[:k_sub], L)
        lists.append(run)
    while len(lists) > 1:
        L2 = min(k, 2 * L)
        nxt = []
        for p in range(0, len(lists), 2):
            if p + 1 == len(lists):
                nxt.append(lists[p] + [(NEG, merge_pad)] * (L2 - L))
            else:
                nxt.append(_rank_merge(lists[p], lists[p + 1], L2))
        lists, L = nxt, L2
    fin = lists[0] + [(NEG, NO_ROW)] * max(0, k - L)
    s = np.asarray([e[0] for e in fin[:k]], np.float32)
    i = np.asarray([e[1] if e[0] > NEG else -1 for e in fin[:k]], np.int64)
    return s, i


def _emulated_rows(arena, q, preds, k, P, **kw):
    cols = torch_cols(arena)
    scores = (torch.from_numpy(q) @ cols["emb"].T).numpy()
    return [_emulate_paged(scores[b], np_mask(arena, preds[b]), k, P, **kw)
            for b in range(q.shape[0])]


def _oracle(arena, q, preds, k):
    cols = torch_cols(arena)
    meta = _packed_meta(cols["tenant"], cols["updated_at"], cols["category"],
                        cols["acl"])
    s, i = arena_scan_ref(torch.from_numpy(q), cols["emb"], meta,
                          torch.arange(len(preds), dtype=torch.int32),
                          stack_predicates(preds), k)
    return s.numpy(), i.numpy()


def _tied_arena(n, d=16, dead=None, seed=0):
    """Rows n-1-j copy rows j (exact ties across pages); queries aimed at
    the copies; ``dead`` a slice of rows with tenant -1."""
    rng = np.random.default_rng(seed)
    arena = np_arena(rng, n, d)
    for j in range(24):
        for col in arena:
            arena[col][n - 1 - j] = arena[col][j]
    arena["tenant"][:24] = np.maximum(arena["tenant"][:24], 0)
    arena["tenant"][n - 24:] = arena["tenant"][23::-1]
    if dead is not None:
        arena["tenant"][dead] = -1
    q = unit(rng.standard_normal((3, d)).astype(np.float32))
    q[0] = arena["emb"][0]
    q[1] = arena["emb"][3]
    return arena, q


# (n, k, P, dead rows): ties and duplicates across pages, an all-dead page,
# k > 256, k > P, a ragged last page, P not a multiple of 256, P >= n
EMU_CELLS = [
    (700, 10, 256, None),
    (700, 10, 1000, slice(256, 512)),         # P >= n, dead stretch
    (1000, 300, 512, slice(512, 1000)),       # k > 256, dead last page
    (900, 140, 128, slice(128, 256)),         # k > P, an all-dead page
    (1100, 37, 300, None),                    # P % 256 != 0, ragged
    (600, 620, 200, slice(0, 200)),           # k > N, first page dead
]


@pytest.mark.parametrize("n,k,P,dead", EMU_CELLS,
                         ids=[f"n{c[0]}-k{c[1]}-P{c[2]}" for c in EMU_CELLS])
def test_paged_schedule_emulation_matches_oracle(n, k, P, dead):
    arena, q = _tied_arena(n, dead=dead, seed=n + k)
    preds = [Predicate(), Predicate(tenant=1, min_ts=300), BLOCK_ALL]
    s_o, i_o = _oracle(arena, q, preds, k)
    for b, (s, i) in enumerate(_emulated_rows(arena, q, preds, k, P)):
        np.testing.assert_array_equal(s, s_o[b])
        np.testing.assert_array_equal(i, i_o[b])
    if dead is not None and dead.stop - dead.start >= P:
        assert not np.isin(i_o, np.arange(n)[dead]).any()


@pytest.mark.parametrize("mode", list(GEOMETRY_SPECS))
@pytest.mark.parametrize("BB", [8, 16, 32, 64])
@pytest.mark.parametrize("QT", [1, 4, 16])
@pytest.mark.parametrize("G", [1, 16])
def test_paged_launch_geometry(mode, BB, QT, G):
    """The paged kernel's launch at the planner's default page (2^15 rows):
    the resident kernel's micro-tile and ring, plus the sub-tile lists and,
    where they fit 24 KB, the running lists in shared memory."""
    check_geometry(mode, BB, G, QT, 1 << 15)


def _caught(fn) -> bool:
    """True when a mutant emulator disagrees with the oracle: a rank
    collision (AssertionError inside the merge) or a different list."""
    try:
        return not fn()
    except AssertionError:
        return True


def test_emulator_mutant_padding_without_no_row_is_caught():
    """Padding an odd list out with index -1 instead of NO_ROW puts (NEG,
    -1) after (NEG, NO_ROW) entries: the list is no longer sorted and the
    binary searches of the next round place two entries at one rank. It
    takes an odd list count in a round where the lists grow (k > P; here 3
    pages) and a page whose list ends in masked rows."""
    n, k, P = 380, 300, 128
    arena, q = _tied_arena(n, dead=slice(256, 340), seed=1)
    preds = [Predicate(), Predicate(tenant=1),
             Predicate(tenant=2, min_ts=500)]
    s_o, i_o = _oracle(arena, q, preds, k)

    def agrees(**kw):
        rows = _emulated_rows(arena, q, preds, k, P, **kw)
        return all((s == s_o[b]).all() and (i == i_o[b]).all()
                   for b, (s, i) in enumerate(rows))

    assert agrees()
    assert _caught(lambda: agrees(merge_pad=-1))


def test_emulator_mutant_probe_ties_by_slot_is_caught():
    """The probe's lists carry candidate positions and break exact ties
    by them (finish maps position -> slot). Tied duplicates listed high
    slot first: a mutant keyed on the slot puts the low slot first and
    disagrees with the slot-lane oracle."""
    rng = np.random.default_rng(5)
    arena = np_arena(rng, 400, 16)
    arena["tenant"][:] = np.maximum(arena["tenant"], 0)
    pairs = [(j, 399 - j) for j in range(30)]
    for lo, hi in pairs:
        for col in arena:
            arena[col][hi] = arena[col][lo]
    cand = np.asarray([hi for _, hi in pairs] + [lo for lo, _ in pairs]
                      + list(range(100, 300)), np.int32)
    q = unit(rng.standard_normal((2, 16)).astype(np.float32))
    q[0] = arena["emb"][0]
    pred = Predicate()
    k, P = 50, 64
    t_emb, t_meta = gather_candidates(torch.from_numpy(arena["emb"]),
                                      torch.from_numpy(np_meta(arena)),
                                      torch.from_numpy(cand))
    s_o, i_o = ivf_probe_ref(torch.from_numpy(q), t_emb, t_meta,
                             pred.as_array(), k)
    scores = (torch.from_numpy(q) @ t_emb.T).numpy()
    keep = np_mask(arena, pred)[cand] & (cand >= 0)

    def agrees(key):
        for b in range(2):
            s, pos = _emulate_paged(scores[b], keep, k, P, key=key)
            if key is None:              # finish maps position -> slot
                slots = np.where(pos >= 0, cand[np.maximum(pos, 0)], -1)
            else:                        # the mutant carries slots already
                slots = pos
            if not ((s == s_o.numpy()[b]).all()
                    and (slots == i_o.numpy()[b]).all()):
                return False
        return True

    assert agrees(None)
    assert _caught(lambda: agrees(lambda r: int(cand[r])))


# ---------------------------------------------------------------------------
# planner and plan against the reference's compile_plan
# ---------------------------------------------------------------------------

def test_planner_config_paged_knobs_match_reference():
    fields = {f.name: f.default for f in dataclasses.fields(PlannerConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(JPlannerConfig)}
    for name in ("paged_min_rows", "page_rows"):
        assert fields[name] == jfields[name]
    assert (fields["paged_min_rows"], fields["page_rows"]) == (None, 1 << 15)


class _Index:
    """Duck-typed IVF index for compile_plan (both frameworks)."""
    n_clusters, cluster_cap = 16, 64
    cfg = IVFConfig(n_clusters=16, nprobe=4)

    def candidate_rows(self, nprobe, rows=1):
        return nprobe * self.cluster_cap * rows


# (logical kwargs, port engine hint, n_rows, cfg kwargs, expect paged)
PLAN_CASES = {
    "ref": (dict(tenant=1), None, 5000, dict(paged_min_rows=4096), True),
    "cuda": (dict(tenant=1, engine="cuda"), "pallas", 5000,
             dict(paged_min_rows=4096, page_rows=512), True),
    "hybrid-wsum": (dict(match_terms=(3, 9)), None, 5000,
                    dict(paged_min_rows=1000), True),
    "hybrid-rrf": (dict(match_terms=(3,), fusion="rrf"), None, 5000,
                   dict(paged_min_rows=1000, page_rows=700), True),
    "ivf": (dict(), None, 5000, dict(paged_min_rows=1000), False),
    "below-threshold": (dict(tenant=2), None, 4095,
                        dict(paged_min_rows=4096), False),
    "default-cfg": (dict(tenant=2), None, 1 << 20, dict(), False),
}


def _to_reference_text(s: str) -> str:
    return s.replace("'cuda'", "'pallas'").replace("cuda    ", "pallas  ")


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_paged_stamping_matches_reference(case):
    """page_rows, the reason suffix, group / fuse keys and the explain text
    (with its ``paging:`` line) equal the reference's; ivf and plans below
    the threshold are never stamped."""
    lp_kw, j_engine, n_rows, cfg_kw, paged = PLAN_CASES[case]
    q = np.ones((2, 8), np.float32)
    j_kw = dict(lp_kw)
    if j_engine is not None:
        j_kw["engine"] = j_engine
    kw = dict(n_rows=n_rows, hot_window_s=1 << 30, now_ts=0, warm_rows=0,
              index=_Index(), lex=object())
    jp = j_compile_plan(JLogicalPlan(k=7, q=q, **j_kw),
                        cfg=JPlannerConfig(**cfg_kw), **kw)
    tp = compile_plan(LogicalPlan(k=7, q=q, **lp_kw),
                      cfg=PlannerConfig(**cfg_kw), device="cpu", **kw)
    assert (tp.page_rows is not None) == paged
    assert tp.page_rows == jp.page_rows
    assert _to_reference_text(tp.engine_reason) == jp.engine_reason
    assert ("paged regime" in tp.engine_reason) == paged
    assert tp.engine == ("cuda" if jp.engine == "pallas" else jp.engine)
    assert tp.group_key[1:2] + tp.group_key[3:] == \
        jp.group_key[1:2] + jp.group_key[3:]
    assert tp.fuse_key[:1] + tp.fuse_key[2:] == \
        jp.fuse_key[:1] + jp.fuse_key[2:]
    assert _to_reference_text(tp.explain()) == jp.explain()
    assert ("  paging:    paged arena scan" in tp.explain()) == paged
    if paged:
        cold = compile_plan(LogicalPlan(k=7, q=q, **lp_kw),
                            cfg=PlannerConfig(), device="cpu", **kw)
        assert cold.group_key != tp.group_key
        assert cold.fuse_key != tp.fuse_key


# ---------------------------------------------------------------------------
# executor and front door
# ---------------------------------------------------------------------------

def _stores(rng, n, d):
    a = np_arena(rng, n, d)
    jstore = dict(zip(("emb", "tenant", "updated_at", "category", "acl"),
                      _jcols(a)))
    return a, jstore, torch_cols(a)


def test_paged_plan_execution_bit_identical():
    """Planner-stamped paged plans through execute_plans: the port's rows
    agree with the reference's, paged equals resident inside each
    framework, and paged_scans / rows_scanned equal the reference's."""
    rng = np.random.default_rng(0)
    N, D, K = 3000, 16, 8
    a, jstore, tstore = _stores(rng, N, D)
    q = unit(rng.standard_normal((6, D)).astype(np.float32))
    lps = [dict(tenant=t % 3, k=K, q=q[2 * t:2 * t + 2]) for t in range(3)]
    kw = dict(n_rows=N, hot_window_s=100, now_ts=1000, warm_rows=0)
    out = {}
    for name, cfg_kw in (("res", {}),
                         ("pg", dict(paged_min_rows=1, page_rows=512))):
        jcfg, tcfg = JPlannerConfig(**cfg_kw), PlannerConfig(**cfg_kw)
        jplans = [j_compile_plan(JLogicalPlan(**lp), cfg=jcfg, **kw)
                  for lp in lps]
        tplans = [compile_plan(LogicalPlan(**lp), cfg=tcfg, device="cpu",
                               **kw) for lp in lps]
        jst, tst = JExecStats(), ExecStats()
        js, ji, _ = j_executor.execute_plans(dict(jstore), None, jplans,
                                             stats=jst, planner_cfg=jcfg)
        ts, ti, _ = t_executor.execute_plans(dict(tstore), None, tplans,
                                             stats=tst, planner_cfg=tcfg)
        assert_topk_agree(ts, ti, np.asarray(js), np.asarray(ji))
        assert_no_leak(a, [p.pred for p in tplans for _ in range(2)],
                       np.arange(6), ti)
        for f in ("paged_scans", "rows_scanned", "device_calls",
                  "fused_scans"):
            assert getattr(tst, f) == getattr(jst, f), f
        out[name] = (ts, ti, tst)
    assert out["res"][2].paged_scans == 0
    assert out["pg"][2].paged_scans == 1
    assert_topk_agree(*out["pg"][:2], *out["res"][:2])


def test_rows_scanned_audit_paged_equals_resident():
    """A paged fused grouped scan reports the arena N once, as resident
    does and as the reference does, and keys its own shape slot."""
    rng = np.random.default_rng(1)
    N, D, B, G, k = 1000, 32, 9, 3, 7
    a, jstore, tstore = _stores(rng, N, D)
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    uniq = [Predicate(tenant=i % 3, min_ts=100) for i in range(G)]
    preds = [uniq[i % G] for i in range(B)]
    jpreds = [jpred(p) for p in preds]
    shapes, jshapes = CompiledShapes(), JCompiledShapes()
    res = {}
    for page in (None, 256):
        st, jst = ExecStats(), JExecStats()
        s, i, _ = run_grouped_fused(dict(tstore), q, preds, k, stats=st,
                                    shapes=shapes, page_rows=page)
        js, ji, _ = j_run_grouped_fused(dict(jstore), q, jpreds, k,
                                        stats=jst, shapes=jshapes,
                                        page_rows=page)
        assert_topk_agree(s, i, np.asarray(js), np.asarray(ji))
        assert st.rows_scanned == jst.rows_scanned == N
        res[page] = (s, i)
    assert_topk_agree(*res[256], *res[None])
    assert shapes.misses == jshapes.misses == 2


def test_terms_scanned_audit_paged_equals_resident():
    rng = np.random.default_rng(2)
    N, D, B, G, k, qt = 768, 16, 6, 3, 5, 4
    a, jstore, tstore = _stores(rng, N, D)
    terms, lexnorm, idf = _lanes(rng, N)
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    qterms = rng.integers(0, V, (B, qt)).astype(np.int32)
    gids = np.asarray([i % G for i in range(B)], np.int32)
    preds = [Predicate(tenant=i % 3, min_ts=100) for i in range(G)]
    kw = dict(mode="wsum", rrf_c=60.0, **W)
    jlex = {"terms": jnp.asarray(terms), "lexnorm": jnp.asarray(lexnorm),
            "idf": jnp.asarray(idf)}
    tlex = {"terms": torch.from_numpy(terms),
            "lexnorm": torch.from_numpy(lexnorm),
            "idf": torch.from_numpy(idf)}
    res = {}
    for page in (None, 256):
        st, jst = ExecStats(), JExecStats()
        hot = _launch_hybrid(dict(tstore), tlex, q, gids, preds, qterms, k,
                             stats=st, shapes=CompiledShapes(),
                             page_rows=page, **kw)
        jhot = j_launch_hybrid(dict(jstore), jlex, q, gids,
                               [jpred(p) for p in preds], qterms, k,
                               stats=jst, shapes=JCompiledShapes(),
                               page_rows=page, **kw)
        s, i = _finish_hot(hot)
        js, ji = j_finish_hot(jhot)
        assert_topk_agree(s, i, js, ji)
        assert st.terms_scanned == jst.terms_scanned == N * T_LANES
        res[page] = (s, i)
    assert_topk_agree(*res[256], *res[None])


CCFG = dict(n_docs=3000, dim=16, n_tenants=4, n_categories=4, seed=0)


def test_ragdb_paged_flow(monkeypatch):
    """RagDB(planner_cfg=PlannerConfig(paged_min_rows=...)): execute,
    launch / finish and the ivf -> exact degrade rung all reach the scan
    with the page size; explain() has the paging: line; the rows equal the
    resident RagDB's under the contract; paged_scans counts each launch."""
    seen = []
    real = kernel_mod.arena_scan_scan_ref

    def spy(*a, **kw):
        seen.append(a[6])
        return real(*a, **kw)

    # the kernel's plain version and the ref engine's streaming scan
    monkeypatch.setattr(kernel_mod, "arena_scan_scan_ref", spy)
    monkeypatch.setattr(grouped_ref, "arena_scan_scan_ref", spy)
    curves = (("ref", ((1 << 10, 0.01), (1 << 14, 0.02))),
              ("cuda", ((1 << 10, 0.01), (1 << 14, 0.02))),
              ("ivf", ((1 << 10, 40.0), (1 << 14, 40.0))))
    dbs = {}
    for name, cfg in (
            ("res", PlannerConfig(cost_model=CostModel(curves=curves))),
            ("pg", PlannerConfig(paged_min_rows=1024, page_rows=700,
                                 cost_model=CostModel(curves=curves)))):
        db = RagDB(StoreConfig(capacity=4096, dim=16), planner_cfg=cfg,
                   device="cpu")
        db.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
        dbs[name] = db
    q = unit(np.random.default_rng(4).standard_normal((8, 16))
             .astype(np.float32))
    out = {}
    for name, db in dbs.items():
        plans = [db.session(Principal(r % 3, 0xFF)).search(q[r]).limit(5)
                 .using("cuda").plan() for r in range(8)]
        before = len(seen)
        s, sl, _ = db.execute(plans, use_cache=False)
        pending = db.launch(plans, use_cache=False)
        s2, sl2, _ = db.finish(pending)
        np.testing.assert_array_equal(sl, sl2)
        out[name] = (s, sl)
        if name == "pg":
            assert all(p.page_rows == 700 for p in plans)
            assert "paging:" in plans[0].explain()
            assert "paging:" in db.session(Principal(0, 0xFF)).search(
                q[0]).limit(5).explain()
            assert seen[before:] == [700, 700]
            assert db.stats.paged_scans == 2
        else:
            assert seen[before:] == [] and db.stats.paged_scans == 0
    assert_topk_agree(*out["pg"], *out["res"])
    # the degrade ladder: ivf plans never page; the ivf -> exact rung
    # compiles a fresh exact plan, which the paged config stamps
    db = dbs["pg"]
    db.build_index(IVFConfig(n_clusters=16, nprobe=2))
    plan = db.admin_session().search(q[0]).limit(5).using("ivf").plan()
    assert plan.engine == "ivf" and plan.page_rows is None
    while plan is not None and plan.engine == "ivf":
        plan = db.degrade(plan)
    assert plan is not None and plan.engine == "ref"
    assert plan.page_rows == 700 and plan.degraded[-1] == "ivf->ref"
    before = len(seen)
    db.execute([plan], use_cache=False)
    assert seen[before:] == [700]
