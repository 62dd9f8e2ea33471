"""Parity of the port's IVF path with the JAX reference's.

The same numpy inputs go through the reference and through the port on the
CPU: candidate assembly (`_assemble`), the probe's plain engines (the
public `ivf_probe`, which takes the plain version for CPU tensors,
`ivf_probe_plain` and the streaming scan `ivf_probe_scan_ref`, the CUDA
kernel's tile schedule) against the reference's `ivf_probe(...,
use_kernel=False)`; `IVFIndex`'s host logic (probe, incremental upkeep,
the mirror's counters) on the reference index's arrays; the planner's
engine choice, guard, keys, explain text and degrade rungs; and the front
door with the reference index injected as ``db.index`` / ``db.log.ivf``
(k-means seeds cannot be reproduced across frameworks, so parity runs on
one index; the port's own k-means is held to recall instead). The CUDA
kernel runs only on the card and is held to its plain version by
chip_smoke.py.

Contract (ROADMAP North star): integers exact; f32 scores within
rtol = atol = 1e-5; slots may differ only inside a run of tied scores at
the k-th place (counted as multisets: a slot a poisoned member table lists
twice comes out twice); ties go to the lower CANDIDATE position.
"""
import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LogicalPlan as JLogicalPlan
from repro.api import RagDB as JRagDB
from repro.api.planner import CostModel as JCostModel
from repro.api.planner import PlannerConfig as JPlannerConfig
from repro.api.planner import compile_plan as j_compile_plan
from repro.api.planner import degrade_plan as j_degrade_plan
from repro.core import TransactionLog as JTransactionLog
from repro.core import empty as j_empty
from repro.core.ivf import IVFConfig as JIVFConfig
from repro.core.ivf import build_ivf as j_build_ivf
from repro.core.store import DocBatch as JDocBatch
from repro.core.store import StoreConfig as JStoreConfig
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro.kernels.ivf_probe.ops import _assemble as j_assemble
from repro.kernels.ivf_probe.ops import ivf_probe as j_ivf_probe
from repro_torch.api import LogicalPlan, RagDB
from repro_torch.api.planner import (CostModel, PlannerConfig, compile_plan,
                                     degrade_plan)
from repro_torch.core.ivf import IVFConfig, IVFIndex
from repro_torch.core.query import Predicate
from repro_torch.core.store import DocBatch, StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.core.transactions import CRASH_POINTS
from repro_torch.data.corpus import CorpusConfig, make_corpus, make_queries
from repro_torch.kernels.arena_scan.ops import _packed_meta
from repro_torch.kernels.ivf_probe import ivf_probe as ivf_mod
from repro_torch.kernels.ivf_probe import ops as ivf_ops
from repro_torch.kernels.ivf_probe.ref import (candidate_slots,
                                               gather_candidates,
                                               ivf_probe_scan_ref)
from repro_torch.serving.faults import CrashError, FaultPlan, FaultRule
from tests.test_torch_arena_scan import TOL, np_arena, np_mask, torch_cols

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


def assert_probe_agree(s_p, i_p, s_r, i_r):
    """Port probe result vs the reference's, both (B, k): scores within
    TOL, fills equal, and slots equal as multisets except inside a run of
    tied scores at the k-th place."""
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    s_r, i_r = np.asarray(s_r), np.asarray(i_r)
    assert s_p.shape == s_r.shape and i_p.shape == i_r.shape
    assert i_p.dtype == np.int32
    np.testing.assert_allclose(s_p, s_r, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(i_p < 0, s_p == np.float32(
        np.finfo(np.float32).min))
    for b in range(s_p.shape[0]):
        real_p, real_r = i_p[b][i_p[b] >= 0], i_r[b][i_r[b] >= 0]
        assert len(real_p) == len(real_r), f"row {b}: fill differs"
        cp, cr = Counter(real_p.tolist()), Counter(real_r.tolist())
        for slot in (cp - cr) + (cr - cp):
            kth = s_r[b][len(real_r) - 1]
            src_s, src_i = (s_p, i_p) if slot in cp else (s_r, i_r)
            sc = src_s[b][src_i[b] == slot][0]
            assert abs(sc - kth) <= TOL, (
                f"row {b}: slot {slot} differs away from a k-th place tie")


def _cols_j(a):
    return (jnp.asarray(a["emb"]), jnp.asarray(a["tenant"]),
            jnp.asarray(a["updated_at"]), jnp.asarray(a["category"]),
            jnp.asarray(a["acl"]))


def _cols_t(a):
    c = torch_cols(a)
    return (c["emb"], c["tenant"], c["updated_at"], c["category"], c["acl"])


def _table(rng, n, C, cap, poison=False):
    """A member table with per-cluster fill and -1 padding, an overflow
    tail and a -1-padded probed-cluster list; ``poison`` plants slots past
    the arena, negative ones and a duplicated run."""
    members = np.full((C, cap), -1, np.int32)
    for c in range(C):
        fill = int(rng.integers(0, cap + 1))
        members[c, :fill] = rng.integers(0, n, fill)
    overflow = rng.integers(0, n, 13).astype(np.int32)
    if poison:
        bad = rng.random(members.shape) < 0.25
        members[bad] = rng.integers(-5, n + 500, int(bad.sum()))
        members[1, :cap // 2] = members[0, :cap // 2]
        overflow = rng.integers(-5, n + 500, 13).astype(np.int32)
    U = min(C, 6)
    clusters = np.full(8, -1, np.int32)
    clusters[:U] = rng.permutation(C)[:U]
    return members, overflow, clusters


# ---------------------------------------------------------------------------
# candidate assembly and the probe's plain engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clean", "poisoned", "no-clusters"])
def test_assemble_matches_reference(case):
    """`_assemble`'s rows and (P, 5) metadata exactly: cluster padding
    gives -1 rows, slots outside [0, n) are dead (slot -1, tenant -1), not
    clamped."""
    rng = np.random.default_rng(3)
    a = np_arena(rng, 300, 8)
    members, overflow, clusters = _table(rng, 300, 7, 32,
                                         poison=case == "poisoned")
    if case == "no-clusters":
        clusters = np.full(4, -1, np.int32)
    je, jm = j_assemble(*_cols_j(a), jnp.asarray(members),
                        jnp.asarray(overflow), jnp.asarray(clusters))
    te, tm = ivf_ops._assemble(*_cols_t(a), torch.from_numpy(members),
                               torch.from_numpy(overflow), clusters)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.int32 and tm.shape[1] == 5


def _ref_index(n, dim, n_clusters=16, cap=None, seed=0):
    """A store and the reference's IVF index over it (the reference build:
    the parity tests share ITS centroids and member table)."""
    ccfg = JCorpusConfig(n_docs=n, dim=dim, n_tenants=4, n_categories=4,
                         seed=seed)
    scfg = JStoreConfig(capacity=1 << int(np.ceil(np.log2(n)) + 1), dim=dim)
    log = JTransactionLog(scfg, j_empty(scfg))
    log.ingest(j_make_corpus(ccfg))
    snap = log.snapshot()
    index = j_build_ivf(snap, JIVFConfig(n_clusters=n_clusters,
                                         cluster_cap=cap))
    return snap, index


def _np_snap(snap):
    return {c: np.array(snap[c]) for c in ("emb", "tenant", "updated_at",
                                           "category", "acl")}


PROBE_CASES = {
    # test_ivf_engine.py's grid: (n, dim, k, cap, B)
    "n1500-d32-k5": (1500, 32, 5, None, 2),
    "n1200-d48-k8-overflow": (1200, 48, 8, 64, 4),
    "n900-d64-k10-B11": (900, 64, 10, None, 11),
    "k-over-P": (400, 16, None, 16, 3),
    "empty": (400, 16, 10, None, 3),
    "poisoned": (800, 16, 12, None, 5),
    "tied-duplicates": (600, 16, 20, None, 4),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_matches_reference(case):
    n, dim, k, cap, B = PROBE_CASES[case]
    snap, jix = _ref_index(n, dim, cap=cap)
    a = _np_snap(snap)
    members, overflow = jix.members.copy(), np.asarray(
        jix.device_arrays()["overflow"]).copy()
    rng = np.random.default_rng(7)
    q = a["emb"][rng.integers(0, n, B)]
    q = (q + 0.05 * rng.standard_normal(q.shape)).astype(np.float32)
    clusters, _, _ = jix.probe(q, nprobe=6)
    pred = Predicate(min_ts=3, cat_mask=0b0111)
    if case == "k-over-P":
        clusters, _, _ = jix.probe(q, nprobe=1)
        k = len(clusters) * jix.cluster_cap + len(overflow) + 7
    elif case == "empty":
        clusters, overflow = np.zeros(0, np.int32), overflow[:0]
    elif case == "poisoned":
        bad = rng.random(members.shape) < 0.25
        members[bad] = rng.integers(-5, n + 500, int(bad.sum()))
        members[0, :20] = members[1, :20]
        overflow = rng.integers(-5, n + 500, 16).astype(np.int32)
        pred = Predicate()
    elif case == "tied-duplicates":
        # pairs of identical rows, the higher slot listed FIRST: the tie
        # must go to the lower candidate position, not the lower slot
        live = np.nonzero(a["tenant"] >= 0)[0]
        lo, hi = live[:12], live[-12:]
        a["emb"][hi] = a["emb"][lo]
        for c in ("tenant", "updated_at", "category", "acl"):
            a[c][hi] = a[c][lo]
        members = np.full_like(members, -1)
        members.reshape(-1)[:24] = np.concatenate([hi, lo])
        clusters = np.arange(len(clusters), dtype=np.int32) % len(members)
        clusters[1:] = -1
        overflow = overflow[:0]
        q = a["emb"][lo[:B]].copy()
        pred = Predicate()
    s_r, i_r = j_ivf_probe(jnp.asarray(q), *_cols_j(a), jnp.asarray(members),
                           jnp.asarray(overflow), jnp.asarray(clusters),
                           jnp.asarray(np.asarray(pred.as_array())), k,
                           use_kernel=False)
    s_r, i_r = np.asarray(s_r), np.asarray(i_r)
    cols = _cols_t(a)
    tq, tm, to = (torch.from_numpy(x) for x in (q, members, overflow))
    pa = pred.as_array()
    outs = {"public": ivf_ops.ivf_probe(tq, *cols, tm, to, clusters, pa, k)}
    cand = candidate_slots(tm, to, clusters)
    if cand.numel():
        meta = _packed_meta(*cols[1:])
        kp = min(k, cand.numel())
        outs["plain"] = ivf_mod.ivf_probe_plain(tq, cols[0], meta, cand, pa,
                                                kp)
        ce, cm = gather_candidates(cols[0], meta, cand)
        for blk in (64, 256):
            outs[f"scan{blk}"] = ivf_probe_scan_ref(tq, ce, cm, pa, kp, blk)
    for name, (s, i) in outs.items():
        s, i = s.numpy(), i.numpy()
        w = s.shape[1]
        assert_probe_agree(s, i, s_r[:, :w], i_r[:, :w])
    s, i = outs["public"][0].numpy(), outs["public"][1].numpy()
    mask = np_mask(a, pred)
    for b in range(B):
        real = i[b][i[b] >= 0]
        assert ((real >= 0) & (real < n)).all() and mask[real].all()
    if case == "empty":
        assert (i == -1).all()
    if case == "k-over-P":
        assert (i[:, -7:] == -1).all()
    if case == "tied-duplicates":
        # hi before lo in candidate order: the tie comes out hi first, as
        # the reference puts it, in every port engine
        for name, (s, i) in outs.items():
            np.testing.assert_array_equal(i.numpy()[:, :2],
                                          np.stack([hi[:B], lo[:B]], 1))
            np.testing.assert_array_equal(i.numpy(), i_r[:, :i.shape[1]])


def test_probe_wrapper_dispatch(monkeypatch):
    """CPU tensors take the plain version and never the kernel wrapper;
    the kernel wrapper refuses CPU tensors; any other device raises."""
    rng = np.random.default_rng(0)
    a = np_arena(rng, 64, 8)
    members, overflow, clusters = _table(rng, 64, 4, 8)
    calls = []
    monkeypatch.setattr(ivf_ops, "ivf_probe_cuda",
                        lambda *a, **kw: calls.append(a) or ("s", "i"))
    q = torch.from_numpy(a["emb"][:2].copy())
    ivf_ops.ivf_probe(q, *_cols_t(a), torch.from_numpy(members),
                      torch.from_numpy(overflow), clusters,
                      Predicate().as_array(), 3)
    assert calls == []
    x = torch.zeros((2, 4))
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ivf_mod.ivf_probe_cuda(x, x, x, i, i, 2)
    meta_t = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="no ivf_probe engine"):
        ivf_ops.ivf_probe(meta_t, meta_t, meta_t[:, 0], meta_t[:, 0],
                          meta_t[:, 0], meta_t[:, 0], meta_t, meta_t[0],
                          np.zeros(1, np.int32), meta_t[0], 2)
    assert ivf_mod.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the index: host logic and device mirror on the reference's arrays
# ---------------------------------------------------------------------------

def _port_index(jix) -> IVFIndex:
    return IVFIndex(IVFConfig(**dataclasses.asdict(jix.cfg)),
                    np.asarray(jix.centroids).copy(), jix.members.copy(),
                    jix.fill.copy(), list(jix.overflow), jix.n_at_build,
                    jix.epoch, device="cpu")


def _index_fp(ix) -> dict:
    return {"members": ix.members.copy(), "fill": np.asarray(ix.fill).copy(),
            "overflow": list(ix.overflow), "churn": ix.churn,
            "needs_rebuild": ix.needs_rebuild(),
            "slot_pos": dict(ix._slot_pos), "starved": len(ix.starved),
            "mirror": (ix.mirror_uploads, ix.mirror_patches,
                       ix.mirror_bytes_uploaded)}


def _fp_equal(a, b):
    return all(np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
               else a[k] == b[k] for k in a)


@pytest.mark.parametrize("cap", [None, 32])
def test_index_matches_reference_over_writes(cap):
    """probe() on several batch shapes, then the same add / re-embed /
    remove sequence on both indexes (overflow spills with a small cap):
    members, fill, overflow, churn, slot map, drift flag and the mirror's
    counters and bytes stay equal, and the mirror equals the host truth."""
    snap, jix = _ref_index(700, 16, n_clusters=12, cap=cap, seed=2)
    tix = _port_index(jix)
    assert tix._slot_pos == jix._slot_pos
    rng = np.random.default_rng(5)
    for B, nprobe in ((1, 1), (3, 4), (16, 8), (2, 50)):
        q = rng.standard_normal((B, 16)).astype(np.float32)
        jc, jn, jr = jix.probe(q, nprobe)
        tc, tn, tr = tix.probe(q, nprobe)
        np.testing.assert_array_equal(tc, jc)
        assert (tn, tr) == (jn, jr)
        assert tix.candidate_rows(nprobe, B) == jix.candidate_rows(nprobe, B)
    for ix in (jix, tix):
        ix.device_arrays()
        ix.starved.add("x")
    n = 700
    steps = [("add", list(range(n, n + 40)), None),
             ("add", [int(s) for s in jix.members[0, :3]] + [n + 1], None),
             ("remove", [int(s) for s in jix.members[1, :5]] + [n + 2,
                                                              99_999], None),
             ("remove", list(jix.overflow[:2]), None),
             ("add", list(range(n + 40, n + 300)), None)]
    for op, slots, _ in steps:
        emb = rng.standard_normal((len(slots), 16)).astype(np.float32)
        for ix in (jix, tix):
            if op == "add":
                ix.add_rows(slots, emb)
            else:
                ix.remove_slots(slots)
        jd, td = jix.device_arrays(), tix.device_arrays()
        assert _fp_equal(_index_fp(tix), _index_fp(jix)), op
        np.testing.assert_array_equal(td["members"].numpy(),
                                      np.asarray(jd["members"]))
        np.testing.assert_array_equal(td["overflow"].numpy(),
                                      np.asarray(jd["overflow"]))
        np.testing.assert_array_equal(td["members"].numpy(), tix.members)
    assert tix.mirror_uploads == 1 and tix.mirror_patches >= 3
    assert tix.needs_rebuild() == jix.needs_rebuild()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_kmeans_recall_at_10_on_seed_grid(seed):
    """The port builds its own index (seeds by random keys, chunked
    Lloyd steps): held to recall@10 >= 0.95 against the exact engine on the
    reference test's seed grid, not to the reference's bits."""
    ccfg = CorpusConfig(n_docs=3000, dim=32, n_tenants=4, n_categories=4,
                        seed=seed)
    db = RagDB(StoreConfig(capacity=8192, dim=32), device="cpu")
    db.ingest(make_corpus(ccfg, device="cpu"))
    ix = db.build_index()
    assert int(ix.fill.sum()) + len(ix.overflow) == 3000
    admin = db.admin_session()
    qs = make_queries(ccfg, 16, batch=1, seed=seed + 100,
                      device="cpu").numpy()
    hits = 0
    for q in qs:
        iv = admin.search(q[0]).limit(10).using("ivf").run()
        ex = admin.search(q[0]).limit(10).using("ref").run()
        assert iv.plan.engine == "ivf"
        hits += len(set(iv.slots[0].tolist()) & set(ex.slots[0].tolist()))
    assert hits / 160 >= 0.95, f"recall@10 {hits / 160:.3f} below bar"


def test_chunked_kmeans_equals_one_block():
    """The Lloyd steps and the assignment in row chunks give the same
    centroids and assignment as one (N, C) block."""
    from repro_torch.core import ivf as ivf_core
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((500, 8)).astype(np.float32))
    live = torch.from_numpy(rng.random(500) < 0.9)
    one = ivf_core._kmeans_allocations([emb], [live], 7, 4, 0, "cpu")
    saved = ivf_core._BLOCK_BYTES
    try:
        ivf_core._BLOCK_BYTES = 4 * 7 * 33          # 33-row chunks
        chunked = ivf_core._kmeans_allocations([emb], [live], 7, 4, 0, "cpu")
        a_chunk = ivf_core._assign(emb, chunked)
    finally:
        ivf_core._BLOCK_BYTES = saved
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), atol=1e-5)
    np.testing.assert_array_equal(a_chunk.numpy(),
                                  torch.argmax(emb @ chunked.T, 1).numpy())


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "admin": (dict(), {}),
    "small-arena": (dict(), {"n_rows": 1 << 10}),
    "tenant": (dict(tenant=2), {}),
    "no-op-categories": (dict(categories=tuple(range(32))), {}),
    "categories": (dict(categories=(1, 2)), {}),
    "acl": (dict(acl_bits=0b101), {}),
    "recency": (dict(min_ts=500), {}),
    "hint-ivf-on-tenant": (dict(tenant=1, engine="ivf"), {}),
    "cfg-nprobe": (dict(), {"cfg": dict(ivf_nprobe=3)}),
    "no-index": (dict(), {"index": False}),
    "batch-rows": (dict(q_rows=5), {}),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_planner_matches_reference(case):
    """Engine, reason, nprobe, ivf_est, group key and explain text."""
    lp_kw, env = PLAN_CASES[case]
    _, jix = _ref_index(900, 16, n_clusters=32)
    tix = _port_index(jix)
    rows = lp_kw.pop("q_rows", 1)
    q = np.random.default_rng(1).standard_normal((rows, 16)).astype(
        np.float32)
    kw = dict(n_rows=env.get("n_rows", 1 << 14), hot_window_s=1 << 30,
              now_ts=0, warm_rows=0)
    with_index = env.get("index", True)
    jp = j_compile_plan(JLogicalPlan(k=7, q=q, **lp_kw),
                        cfg=JPlannerConfig(**env.get("cfg", {})),
                        index=jix if with_index else None, **kw)
    tp = compile_plan(LogicalPlan(k=7, q=q, **lp_kw),
                      cfg=PlannerConfig(**env.get("cfg", {})), device="cpu",
                      index=tix if with_index else None, **kw)
    assert (tp.engine, tp.engine_reason) == (jp.engine, jp.engine_reason)
    assert (tp.nprobe, tp.ivf_est) == (jp.nprobe, jp.ivf_est)
    assert dataclasses.astuple(tp.pred) == dataclasses.astuple(jp.pred)
    assert tp.group_key[1:] == jp.group_key[1:]
    assert tp.explain() == jp.explain()


@pytest.mark.parametrize("floor,cost", [(1, False), (2, False), (1, True)])
def test_degrade_rungs_match_reference(floor, cost):
    """nprobe halves down to ``degrade_min_nprobe``; at the floor the
    ivf -> exact rung fires only with a cost model that prices the exact
    engine under the probe (the port ships none, so by default None)."""
    _, jix = _ref_index(900, 16, n_clusters=32)
    tix = _port_index(jix)
    curves = (("ref", ((1 << 10, 0.5), (1 << 14, 1.0))),
              ("ivf", ((1 << 10, 40.0), (1 << 14, 40.0))))
    jcfg = JPlannerConfig(degrade_min_nprobe=floor,
                          cost_model=JCostModel(curves=curves) if cost
                          else None)
    tcfg = PlannerConfig(degrade_min_nprobe=floor,
                         cost_model=CostModel(curves=curves) if cost
                         else None)
    q = np.ones((2, 16), np.float32)
    kw = dict(n_rows=1 << 14, hot_window_s=1 << 30, now_ts=0, warm_rows=0)
    jp = j_compile_plan(JLogicalPlan(k=5, q=q, engine="ivf"), cfg=jcfg,
                        index=jix, **kw)
    tp = compile_plan(LogicalPlan(k=5, q=q, engine="ivf"), cfg=tcfg,
                      device="cpu", index=tix, **kw)
    rungs = 0
    while jp is not None:
        assert tp is not None
        assert (tp.engine, tp.nprobe, tp.ivf_est, tp.degraded,
                tp.est_cost_ms) == (jp.engine, jp.nprobe, jp.ivf_est,
                                    jp.degraded, jp.est_cost_ms)
        assert tp.explain() == jp.explain()
        jp = j_degrade_plan(jp, cfg=jcfg, index=jix, **kw)
        tp = degrade_plan(tp, cfg=tcfg, device="cpu", index=tix, **kw)
        rungs += 1
    assert tp is None
    assert rungs == {(1, False): 4, (2, False): 3, (1, True): 5}[floor, cost]


# ---------------------------------------------------------------------------
# the front door, with the reference's index injected on the port side
# ---------------------------------------------------------------------------

CAP, DIM = 4096, 16
CCFG = dict(n_docs=1500, dim=DIM, n_tenants=4, n_categories=4, seed=0)
COUNTERS = ("device_calls", "queries", "hot_queries", "rows_scanned",
            "fused_groups", "fused_scans", "padded_groups", "padded_rows",
            "degraded_plans")


def _dbs(index_cfg=None):
    jdb = JRagDB(JStoreConfig(capacity=CAP, dim=DIM))
    jdb.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    jdb.build_index(JIVFConfig(**index_cfg) if index_cfg else None)
    tdb = RagDB(StoreConfig(capacity=CAP, dim=DIM), device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
    tdb.index = _port_index(jdb.index)
    tdb.log.ivf = tdb.index
    return jdb, tdb


def _queries(n, seed):
    return make_queries(CorpusConfig(**CCFG), n, seed=seed,
                        device="cpu").numpy()[:, 0]


def test_front_door_ivf_batch_matches_reference():
    """Admin requests plan "ivf" and one probe answers each group, on both
    sides alike: plans, explain text, results, counters (rows_scanned is
    the probe's padded candidate rows) and the db's ivf line."""
    jdb, tdb = _dbs()
    qs = _queries(6, 3)
    now = JCorpusConfig(**CCFG).now_ts

    def chains(db):
        admin = db.admin_session()
        return ([admin.search(q).limit(8) for q in qs]
                + [admin.search(qs[0]).newer_than(now // 2).limit(8)])

    jplans = [b.plan() for b in chains(jdb)]
    tplans = [b.plan() for b in chains(tdb)]
    for jp, tp in zip(jplans, tplans):
        assert tp.engine == jp.engine == "ivf"
        assert tp.group_key[1:] == jp.group_key[1:]
        assert tp.explain() == jp.explain()
    js, jsl, _ = jdb.execute(jplans)
    ts, tsl, _ = tdb.execute(tplans)
    assert_probe_agree(ts, tsl, js, jsl)
    for c in COUNTERS:
        assert getattr(tdb.stats, c) == getattr(jdb.stats, c), c
    assert tdb.stats.device_calls == 2
    line = lambda db: [ln for ln in db.explain().splitlines()
                       if "ivf index:" in ln]
    assert line(tdb) == line(jdb)


def test_tenant_guard_and_forced_probe_match_reference():
    jdb, tdb = _dbs()
    q = _queries(1, 4)[0]
    tenant_of = np.asarray(tdb.log.snapshot()["tenant"])
    out = []
    for db in (jdb, tdb):
        sess = db.session(Principal(tenant_id=1, group_bits=0xFFFFFFFF))
        plan = sess.search(q).limit(8).plan()
        assert plan.engine == "ref" and "ivf skipped" in plan.engine_reason
        forced = sess.search(q).limit(8).using("ivf").run()
        got = forced.slots[forced.slots >= 0]
        assert len(got) == 8 and (tenant_of[got] == 1).all()
        out.append((plan.engine_reason, forced))
    assert out[0][0] == out[1][0]
    assert_probe_agree(out[1][1].scores, out[1][1].slots, out[0][1].scores,
                       out[0][1].slots)
    with pytest.raises(ValueError, match="build_index"):
        RagDB(StoreConfig(capacity=64, dim=DIM), device="cpu") \
            .admin_session().search(q).using("ivf").plan()


@pytest.mark.parametrize("clear,k", [(20, 10), (5, 10)])
def test_rescan_and_starved_memo_match_reference(clear, k):
    """A recency bound only ``clear`` rows pass: the probe under-fills and
    one exact rescan completes the k-list (rows_scanned + the arena), equal
    to the exact engine; when even the arena cannot fill k the predicate is
    memoised as starved and the next batch goes straight to the exact
    scan."""
    jdb, tdb = _dbs()
    q = _queries(1, 21)[0]
    ts = np.asarray(tdb.log.snapshot()["updated_at"])
    min_ts = int(np.sort(ts)[-clear])
    out = []
    for db in (jdb, tdb):
        admin = db.admin_session()
        plan = admin.search(q).newer_than(min_ts).limit(k).plan()
        assert plan.engine == "ivf"
        r0 = db.stats.rows_scanned
        res = db.execute([plan], use_cache=False)
        d1 = db.stats.rows_scanned - r0
        ref = admin.search(q).newer_than(min_ts).limit(k).using("ref").run()
        np.testing.assert_array_equal(res[1], ref.slots)
        np.testing.assert_array_equal(res[0], ref.scores)
        r0 = db.stats.rows_scanned
        db.execute([plan], use_cache=False)
        d2 = db.stats.rows_scanned - r0
        starved = {(dataclasses.astuple(p), kk) for p, kk in db.index.starved}
        out.append((res, d1, d2, starved))
    (jres, jd1, jd2, jst), (tres, td1, td2, tst) = out
    assert_probe_agree(tres[0], tres[1], jres[0], jres[1])
    assert (td1, td2, tst) == (jd1, jd2, jst)
    assert td1 > CAP
    assert (td2 == CAP) == (clear < k) and bool(tst) == (clear < k)


def test_epoch_keyed_cache_matches_reference():
    jdb, tdb = _dbs()
    q = _queries(1, 11)[0]
    flags = []
    for db in (jdb, tdb):
        admin = db.admin_session()
        run = lambda: admin.search(q).limit(5).run()
        seq = [run().cached, run().cached]
        exact = admin.search(q).limit(5).using("ref")
        seq.append(exact.run().cached)
        epoch = db.index.epoch
        db.build_index(db.index.cfg)   # no arena commit, a new epoch
        assert db.index.epoch == epoch + 1
        seq += [run().cached, exact.run().cached]
        flags.append(seq)
    assert flags[0] == flags[1] == [False, True, False, False, True]


def test_writes_write_through_like_reference():
    """Ingest at a query's embedding, re-embed a doc, delete: the written
    row is probeable at once, the deleted one is gone, and the two indexes
    (members, fill, overflow, churn, slot map, mirror counters) stay
    equal; the result cache misses after each write."""
    jdb, tdb = _dbs()
    q = _queries(1, 9)[0]
    q = q / np.linalg.norm(q)
    now = JCorpusConfig(**CCFG).now_ts
    for db, torch_side in ((jdb, False), (tdb, True)):
        admin = db.admin_session()
        run = lambda: admin.search(q).limit(5).run()
        assert not run().cached and run().cached
        cols = dict(tenant=np.zeros(1, np.int32),
                    category=np.zeros(1, np.int32),
                    updated_at=np.full(1, now, np.int32),
                    doc_id=np.asarray([70_000], np.int32))
        if torch_side:
            db.ingest(DocBatch(emb=torch.from_numpy(q[None].copy()),
                               acl=torch.tensor([-1], dtype=torch.int32),
                               **{c: torch.from_numpy(v)
                                  for c, v in cols.items()}))
        else:
            db.ingest(JDocBatch(emb=jnp.asarray(q[None]),
                                acl=jnp.asarray([0xFFFFFFFF], jnp.uint32),
                                **{c: jnp.asarray(v) for c, v in cols.items()}))
        res = run()
        assert not res.cached and res.plan.engine == "ivf"
        assert db.log.slot_of(70_000) == res.slots[0, 0]
        db.update([17], q[None, :] * -1.0, [now])
        db.delete([70_000])
        res = run()
        assert not res.cached
        assert db.log.slot_of(17) not in res.slots[0].tolist()
    assert _fp_equal(_index_fp(tdb.index), _index_fp(jdb.index))
    assert tdb.index.churn == 3 and tdb.index.mirror_patches >= 1


def test_degrade_through_the_db_matches_reference():
    jdb, tdb = _dbs()
    q = _queries(1, 13)[0]
    out = []
    for db in (jdb, tdb):
        plan = db.admin_session().search(q).limit(6).plan()
        chain = []
        while plan is not None:
            chain.append((plan.engine, plan.nprobe, plan.ivf_est,
                          plan.degraded))
            res = db.execute([plan], use_cache=False)
            plan = db.degrade(plan)
        out.append((chain, res))
    assert out[0][0] == out[1][0] and len(out[1][0]) == 4
    assert_probe_agree(out[1][1][0], out[1][1][1], out[0][1][0],
                       out[0][1][1])
    assert tdb.stats.degraded_plans == jdb.stats.degraded_plans == 3


# ---------------------------------------------------------------------------
# the ivf write-ahead step under crashes
# ---------------------------------------------------------------------------

def _crash_dbs():
    small = dict(n_docs=48, dim=8, n_tenants=2, n_categories=2)
    jdb = JRagDB(JStoreConfig(capacity=96, dim=8))
    jdb.ingest(j_make_corpus(JCorpusConfig(**small)))
    jdb.build_index(JIVFConfig(n_clusters=4, cluster_cap=16))
    jdb.delete([40, 41, 42])
    tdb = RagDB(StoreConfig(capacity=96, dim=8), device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**small), device="cpu"))
    tdb.index = _port_index(jdb.index)
    tdb.log.ivf = tdb.index
    tdb.delete([40, 41, 42])
    return jdb, tdb


def _write(db, op, torch_side):
    rng = np.random.default_rng(11)
    if op == "delete":
        db.log.delete([3, 4, 5])
        return
    if op == "update":
        emb = rng.standard_normal((2, 8)).astype(np.float32)
        if torch_side:
            db.log.update([6, 7], torch.from_numpy(emb),
                          torch.tensor([9, 9], dtype=torch.int32))
        else:
            db.log.update([6, 7], jnp.asarray(emb),
                          jnp.asarray([9, 9], jnp.int32))
        return
    n = 4
    cols = dict(emb=rng.standard_normal((n, 8)).astype(np.float32),
                tenant=np.zeros(n, np.int32), category=np.zeros(n, np.int32),
                updated_at=np.full(n, 5, np.int32),
                doc_id=np.asarray([100, 101, 102, 103], np.int32))
    if torch_side:
        db.log.ingest(DocBatch(acl=torch.full((n,), -1, dtype=torch.int32),
                               **{k: torch.from_numpy(v)
                                  for k, v in cols.items()}))
    else:
        db.log.ingest(JDocBatch(acl=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
                                **{k: jnp.asarray(v) for k, v in cols.items()}))


def _crash_fp(db) -> dict:
    fp = _index_fp(db.index)
    del fp["mirror"]
    fp["commit_count"] = db.log.commit_count
    return fp


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("op", ["ingest", "update", "delete"])
def test_crash_around_the_ivf_step_then_recover(op, point):
    """A crash at every write step, the ivf step included, then
    `recover()`: the index is exactly its pre- or post-write state (never
    half-applied, churn counted once) and equals the reference's after the
    same crash."""
    from repro.serving.faults import CrashError as JCrashError
    from repro.serving.faults import FaultPlan as JFaultPlan
    from repro.serving.faults import FaultRule as JFaultRule
    jdb, tdb = _crash_dbs()
    pre = _crash_fp(tdb)
    twin = _crash_dbs()[1]
    _write(twin, op, True)
    post = _crash_fp(twin)
    outcomes = []
    for db, torch_side, plan, rule, crash in (
            (jdb, False, JFaultPlan, JFaultRule, JCrashError),
            (tdb, True, FaultPlan, FaultRule, CrashError)):
        db.log.faults = plan(0, {f"txn.{op}.{point}": rule(at=(0,))})
        with pytest.raises(crash):
            _write(db, op, torch_side)
        outcomes.append(db.log.recover())
        db.log.faults = None
    assert outcomes[0] == outcomes[1]
    rec = _crash_fp(tdb)
    if point in ("prepare", "intent"):
        assert _fp_equal(rec, pre)
    else:
        assert _fp_equal(rec, post) and outcomes[1] == "rolled-forward"
    assert _fp_equal(_crash_fp(jdb), rec)


def test_rescan_span_nests_under_device_sync_like_reference():
    """With the tracer on, the completeness rescan is a ``rescan`` span
    inside the unit's ``device_sync`` span, and the span trees' names match
    the reference's."""
    from repro.obs import FlightRecorder as JFlightRecorder
    from repro.obs import Tracer as JTracer
    from repro_torch.obs import FlightRecorder, Tracer
    jdb, tdb = _dbs()
    q = _queries(1, 21)[0]
    min_ts = int(np.sort(np.asarray(tdb.log.snapshot()["updated_at"]))[-20])
    names = []
    for db, tracer, recorder in ((jdb, JTracer, JFlightRecorder),
                                 (tdb, Tracer, FlightRecorder)):
        rec = recorder()
        db.attach_tracer(tracer(enabled=True, recorder=rec))
        db.admin_session().search(q).newer_than(min_ts).limit(10).run()
        (trace,) = rec.traces()
        by_id = {s.span_id: s for s in trace.spans}
        (rescan,) = [s for s in trace.spans if s.name == "rescan"]
        assert by_id[rescan.parent_id].name == "device_sync"
        assert rescan.ann["rows"] == CAP
        names.append([s.name for s in trace.spans])
    assert names[0] == names[1]
