"""Hybrid, IVF and tiers over arena regions on their own devices, and the
sharded kernel entry points over pieces on distinct devices, against the
reference.

A `RagDB(mesh=)` whose shards sit on distinct devices holds its lexical
lanes beside each allocation, keeps one IVF member-table mirror a device
and its warm tier on the controller; hybrid, ivf and tiered plans launch
on every allocation and merge on the controller. Here the devices are
``torch.device("cpu", i)`` (their tensors all land on the one CPU, so the
code of several cards runs with several allocations). S = 4 regions of
256 rows, D = 16, T = 4 lanes, k = 5, as ``test_torch_regions.py``:

  * hybrid wsum and rrf, resident and paged, under hash and tenant
    placement, after an ingest / update / delete sequence with lanes:
    against the reference's `RagDB(mesh=, lexical_cfg=)` over 4 fake XLA
    host devices (one subprocess for the whole file), its
    `hybrid_score_ref` and the one-device port db; `ExecStats` equal to
    the reference's, no leaked slot;
  * IVF with the reference's index carried over (its lists, its
    `ivf_probe` plain engine, `rows_scanned`, the rescan), and the port's
    own `build_index` over the allocations (each live slot once, recall
    against the exact engine on the reference's seed grid, mirrors
    patched per device for the dirty clusters only, the starved path);
  * tiers: `warm_cfg` + `hot_window_s` over the regions against the
    reference's tiered mesh db (routes, (scores, slots, tiers), a warm
    delete, a warm doc updated at now moving hot, wsum and rrf tails);
  * a `FaultPlan` crash at every `CRASH_POINTS` entry with lanes and an
    index, then `recover`, against the one-device db;
  * `filtered_topk_sharded` and `decode_attention_sharded` with pieces on
    ``cpu:0..3`` against the one-tensor call.

Scores within rtol = atol = 1e-5 (each region's product rounds apart from
the whole arena's), slots equal except inside tie runs.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hybrid_score.ref import hybrid_score_ref as j_hybrid_ref
from repro.kernels.hybrid_score.ref import qidf_of as j_qidf_of
from repro.kernels.ivf_probe.ops import ivf_probe as j_ivf_probe
from repro_torch.api import RagDB
from repro_torch.api.planner import PlannerConfig
from repro_torch.core.ivf import IVFConfig, IVFIndex
from repro_torch.core.query import Predicate, predicate_mask
from repro_torch.core.store import (ALLOCS, DocBatch, StoreConfig,
                                    from_numpy, layout, to_numpy)
from repro_torch.core.tenancy import Principal
from repro_torch.core.transactions import CRASH_POINTS
from repro_torch.data.corpus import CorpusConfig, make_corpus, make_queries
from repro_torch.index.lexical import LexicalConfig
from repro_torch.index.lexical.arena import allocations as lex_allocations
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_sharded)
from repro_torch.kernels.filtered_topk.ops import filtered_topk_sharded
from repro_torch.kernels.arena_scan.ops import _pack_meta
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.faults import CrashError, FaultPlan, FaultRule
from tests.test_torch_arena_scan import assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, RPS, DIM, K, T, V = 4, 256, 16, 5, 4, 64
CAP = S * RPS
CPUS = [torch.device("cpu", i) for i in range(S)]
ALL = 0xFFFFFFFF
LEX = LexicalConfig(vocab_size=V, doc_terms=T)
PAGED = PlannerConfig(paged_min_rows=1, page_rows=64)
HYB_STATS = ("device_calls", "queries", "rows_scanned", "terms_scanned",
             "fused_groups", "fused_scans", "paged_scans", "padded_groups")
TIER_STATS = ("device_calls", "queries", "hot_queries", "warm_queries",
              "rows_scanned", "terms_scanned", "fused_scans")
NOW, WINDOW = 100, 50
SHARD_MIN_ROWS = 64           # the hot arena's CAP rows plan "sharded"


def _docs(seed, n, first=0):
    """n docs with lanes (lane 0 always holds a term)."""
    rng = np.random.default_rng(seed)
    terms = rng.integers(-1, V, (n, T)).astype(np.int32)
    terms[:, 0] = rng.integers(0, V, n)
    return dict(emb=rng.standard_normal((n, DIM), dtype=np.float32),
                tenant=rng.integers(0, 6, n).astype(np.int32),
                category=rng.integers(0, 4, n).astype(np.int32),
                updated_at=rng.integers(1, NOW, n).astype(np.int32),
                acl=rng.integers(1, 4, n).astype(np.int32),
                doc_id=np.arange(first, first + n, dtype=np.int32),
                terms=terms,
                tfs=rng.integers(1, 4, (n, T)).astype(np.int32))


def _writes(seed=0):
    """Ingest with lanes, update, delete, ingest again: (op, arg) pairs."""
    rng = np.random.default_rng(seed + 1)
    gone = rng.choice(500, 40, replace=False).tolist()
    upd = rng.choice([d for d in range(500) if d not in gone], 30,
                     replace=False).tolist()
    return [("ingest", _docs(seed, 500)),
            ("update", (upd, rng.standard_normal((30, DIM),
                                                 dtype=np.float32),
                        rng.integers(NOW, NOW + 50, 30).astype(np.int32))),
            ("delete", gone),
            ("ingest", _docs(seed + 2, 60, first=1000))]


WRITES = _writes(seed=3)
TIER_DOCS = _docs(11, 900)
QS = np.random.default_rng(9).standard_normal((8, DIM), dtype=np.float32)
#: (tenant, group bits, min_ts) of each query row: 4 tenant groups
ROWS = [(t % 4, (1, 3, 2, 1)[t % 4], (0, 20, 50, 10)[t % 4])
        for t in range(8)]
#: each row's match() terms: the lanes of a doc of the first batch, as
#: match() lowers them (unique, in order)
TERMS = [list(dict.fromkeys(int(t) for t in WRITES[0][1]["terms"][7 * r]
                            if t >= 0)) for r in range(8)]
MOVER_EMB = np.random.default_rng(12).standard_normal(DIM).astype(np.float32)


def _batch(d):
    return DocBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in d.items()})


def _apply(db, op, arg):
    if op == "ingest":
        db.ingest(_batch(arg))
    elif op == "update":
        db.update(arg[0], torch.from_numpy(arg[1]), torch.from_numpy(arg[2]))
    else:
        db.delete(arg)


def _db(placement="hash", devices=CPUS, **kw):
    """A RagDB with lanes over the mesh of ``devices``, its controller the
    first."""
    return RagDB(StoreConfig(capacity=CAP, dim=DIM, metric="dot"),
                 mesh=make_mesh((S,), ("data",), devices=devices),
                 placement=placement, device=devices[0], lexical_cfg=LEX,
                 **kw)


def _written(placement="hash", devices=CPUS, **kw):
    db = _db(placement, devices, **kw)
    for w in WRITES:
        _apply(db, *w)
    return db


def _tiered(devices=CPUS):
    db = _db("hash", devices,
             warm_cfg=StoreConfig(capacity=CAP, dim=DIM, metric="dot"),
             hot_window_s=WINDOW, now_ts=NOW)
    db.ingest(_batch(TIER_DOCS))
    return db


def _hybrid_plans(db, mode):
    return [db.session(Principal(tenant_id=t, group_bits=b))
            .search(QS[r], normalize=False).newer_than(ts)
            .match(TERMS[r]).fuse(mode, w_dense=0.8, w_lex=1.7)
            .limit(K).plan() for r, (t, b, ts) in enumerate(ROWS)]


def _ivf_plans(db, tight=None):
    """Forced ivf plans: the 8 rows' predicates, or (``tight``) an admin
    plan whose recency bound only a few rows clear."""
    if tight is not None:
        return [db.admin_session().search(QS[0], normalize=False)
                .newer_than(tight).limit(K).using("ivf").plan()]
    return [db.session(Principal(tenant_id=t, group_bits=b))
            .search(QS[r], normalize=False).newer_than(ts).limit(K)
            .using("ivf").plan() for r, (t, b, ts) in enumerate(ROWS)]


def _tier_plans(db, kind):
    out = []
    for r, (t, b, _) in enumerate(ROWS):
        q = db.session(Principal(tenant_id=t, group_bits=b)).search(
            QS[r], normalize=False)
        if kind == "hot":
            q = q.newer_than(NOW - 40).in_categories([0, 1, 2])
        elif kind in ("wsum", "rrf"):
            q = q.match(TERMS[r]).fuse(kind)
        out.append(q.limit(K).plan())
    return out


def _stats(db, names):
    return {n: getattr(db.stats, n) for n in names}


def _leaks(store, rows, slots):
    """Returned slots failing their row's predicate, on a plain copy."""
    plain = from_numpy(to_numpy(store), "cpu")
    n = 0
    for r, (t, b, ts) in enumerate(rows):
        keep = predicate_mask(plain, Predicate(tenant=t, min_ts=ts,
                                               acl_bits=b).as_array())
        live = slots[r][slots[r] >= 0]
        n += int((~keep[torch.from_numpy(live).long()]).sum())
    return n


def _enc(slots, tiers):
    return np.where(slots >= 0, tiers * (1 << 24) + slots, -1).astype(
        np.int32)


# -- the reference, once for the file ------------------------------------

REF_CODE = textwrap.dedent("""
    import json, sys, jax, jax.numpy as jnp, numpy as np
    from repro.api.planner import PlannerConfig
    from repro.api.ragdb import RagDB
    from repro.core.ivf import IVFConfig
    from repro.core.store import DocBatch, StoreConfig
    from repro.core.tenancy import Principal
    from repro.index.lexical import LexicalConfig
    from repro.launch.mesh import make_mesh
    a = json.loads(sys.stdin.read())
    assert len(jax.devices()) == 4
    K, ALL = a["k"], 0xFFFFFFFF
    q = np.asarray(a["q"], np.float32)
    DT = {"acl": np.uint32, "emb": np.float32}

    def batch(d):
        return DocBatch(**{k: jnp.asarray(np.asarray(v, DT.get(k, np.int32)))
                           for k, v in d.items()})

    def db_of(placement, **kw):
        return RagDB(StoreConfig(capacity=a["cap"], dim=a["dim"],
                                 metric="dot"),
                     mesh=make_mesh((4,), ("data",)), shard_axes=("data",),
                     placement=placement,
                     lexical_cfg=LexicalConfig(vocab_size=a["V"],
                                               doc_terms=a["T"]), **kw)

    def stats(db, names):
        return {n: getattr(db.stats, n) for n in names}

    def lists(out):
        return [np.asarray(x).tolist() for x in out]

    def run(db, plans, names, **kw):
        out = db.execute(plans, use_cache=kw.pop("use_cache", False))
        return {"out": lists(out), "stats": stats(db, names),
                "routes": [p.route for p in plans],
                "engines": [p.engine for p in plans]}

    def hyb(db, mode):
        return [db.session(Principal(tenant_id=t, group_bits=b))
                .search(q[r], normalize=False).newer_than(ts)
                .match(a["terms"][r]).fuse(mode, w_dense=0.8, w_lex=1.7)
                .limit(K).plan() for r, (t, b, ts) in enumerate(a["rows"])]

    res = {}
    for placement in ("hash", "tenant"):
        db = db_of(placement)
        for op, arg in a["writes"]:
            if op == "ingest":
                db.ingest(batch(arg))
            elif op == "update":
                db.update(arg[0], jnp.asarray(np.asarray(arg[1], np.float32)),
                          jnp.asarray(np.asarray(arg[2], np.int32)))
            else:
                db.delete(arg)
        runs = []
        for paged in (False, True):
            db.planner_cfg = (PlannerConfig(paged_min_rows=1, page_rows=64)
                              if paged else PlannerConfig())
            for mode in ("wsum", "rrf"):
                runs.append(run(db, hyb(db, mode), a["hyb_stats"]))
        db.planner_cfg = PlannerConfig()
        res[placement] = runs
        if placement != "hash":
            continue
        ix = db.build_index(IVFConfig(n_clusters=16, nprobe=4))
        db.stats = type(db.stats)()          # the ivf runs' counts alone
        res["index"] = {"centroids": ix.centroids.tolist(),
                        "members": ix.members.tolist(),
                        "fill": ix.fill.tolist(), "overflow": ix.overflow,
                        "n_at_build": ix.n_at_build}
        ivf = [db.session(Principal(tenant_id=t, group_bits=b))
               .search(q[r], normalize=False).newer_than(ts).limit(K)
               .using("ivf").plan() for r, (t, b, ts) in enumerate(a["rows"])]
        res["ivf"] = run(db, ivf, ["device_calls", "rows_scanned"])
        tight = [db.admin_session().search(q[0], normalize=False)
                 .newer_than(a["tight"]).limit(K).using("ivf").plan()]
        res["ivf_tight"] = [run(db, tight, ["rows_scanned"])
                            for _ in range(2)]
        res["ivf_starved"] = len(db.index.starved)

    db = db_of("hash", warm_cfg=StoreConfig(capacity=a["cap"], dim=a["dim"],
                                            metric="dot"),
               hot_window_s=a["window"], now_ts=a["now"])
    db.ingest(batch(a["tier_docs"]))
    tiers = {"hot_docs": int(db.log.snapshot()["n_live"]),
             "warm_docs": db.router.warm.n_docs}

    def tier_plans(kind):
        out = []
        for r, (t, b, _) in enumerate(a["rows"]):
            p = db.session(Principal(tenant_id=t, group_bits=b)).search(
                q[r], normalize=False)
            if kind == "hot":
                p = p.newer_than(a["now"] - 40).in_categories([0, 1, 2])
            elif kind in ("wsum", "rrf"):
                p = p.match(a["terms"][r]).fuse(kind)
            out.append(p.limit(K).plan())
        return out

    for kind in ("hot", "tail", "wsum", "rrf"):
        tiers[kind] = run(db, tier_plans(kind), a["tier_stats"])
    # the planner's own choice once the hot arena holds shard_min_rows:
    # the sharded engine; each run's counts alone
    db.planner_cfg = PlannerConfig(shard_min_rows=a["shard_min_rows"])
    for kind in ("hot", "tail"):
        s0 = stats(db, a["tier_stats"])
        r0 = list(db.stats.shard_rows_scanned)
        r = run(db, tier_plans(kind), a["tier_stats"])
        r["stats"] = {n: r["stats"][n] - s0[n] for n in s0}
        r0 += [0] * (len(db.stats.shard_rows_scanned) - len(r0))
        r["shard_rows"] = [x - y for x, y in
                           zip(db.stats.shard_rows_scanned, r0)]
        tiers["sharded_" + kind] = r
    db.planner_cfg = PlannerConfig()
    warm = db.router.warm
    s, sl, tr = (np.asarray(x) for x in tiers["tail"]["out"])
    wslots = sl[tr == 1]
    victim, mover = (int(warm.meta["doc_id"][int(w)]) for w in wslots[:2])
    tail = tier_plans("tail")
    db.execute(tail)
    db.execute(tail)
    hits = db.result_cache.hits
    db.delete([victim])
    tiers["after_delete"] = run(db, tail, a["tier_stats"], use_cache=True)
    tiers["hits"] = [hits, db.result_cache.hits]
    mover_tenant = int(warm.meta["tenant"][warm.slot_of(mover)])
    db.update([mover], jnp.asarray(np.asarray([a["mover_emb"]], np.float32)),
              jnp.asarray(np.asarray([a["now"]], np.int32)))
    moved = [db.session(Principal(tenant_id=mover_tenant, group_bits=ALL))
             .search(np.asarray(a["mover_emb"], np.float32),
                     normalize=False).newer_than(a["now"] - 40)
             .limit(K).plan()]
    tiers["moved"] = run(db, moved, a["tier_stats"])
    tiers.update(victim=victim, mover=mover, mover_tenant=mover_tenant,
                 mover_slot=db.log.slot_of(mover))
    res["tiers"] = tiers
    print("RESULT" + json.dumps(res))
""")


def _tight_ts():
    """A recency bound only 3 of the written rows clear."""
    db = _written()
    ts = to_numpy(db.log.snapshot())["updated_at"]
    return int(np.sort(ts[to_numpy(db.log.snapshot())["tenant"] >= 0])[-3])


@pytest.fixture(scope="module")
def ref():
    def js(v):
        return v.tolist() if isinstance(v, np.ndarray) else v
    payload = json.dumps({
        "cap": CAP, "dim": DIM, "k": K, "V": V, "T": T, "q": QS.tolist(),
        "rows": ROWS, "terms": TERMS, "hyb_stats": HYB_STATS,
        "tier_stats": TIER_STATS, "now": NOW, "window": WINDOW,
        "tight": _tight_ts(), "mover_emb": MOVER_EMB.tolist(),
        "shard_min_rows": SHARD_MIN_ROWS,
        "tier_docs": {k: js(v) for k, v in TIER_DOCS.items()},
        "writes": [(op, {k: js(v) for k, v in arg.items()}
                    if op == "ingest" else [js(a) for a in arg]
                    if op == "update" else arg)
                   for op, arg in WRITES]})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF_CODE], input=payload,
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


def _agree(got, want):
    s, sl = (np.asarray(x) for x in got[:2])
    assert_topk_agree(s, sl, np.asarray(want[0], np.float32),
                      np.asarray(want[1], np.int32))


# -- hybrid ---------------------------------------------------------------

def _plain_hybrid(db, mode):
    """The reference's dense oracle, `hybrid_score_ref`, over the whole
    arena and the port's lanes, one predicate group a row."""
    st = to_numpy(db.log.snapshot())
    views = lex_allocations(db.lex.snapshot())
    terms = np.concatenate([v["terms"].numpy() for v in views])
    lexnorm = np.concatenate([v["lexnorm"].numpy() for v in views])
    idf = views[0]["idf"].numpy()
    meta = np.stack([st["tenant"], st["updated_at"], st["category"],
                     st["acl"].view(np.int32)], 1)
    s_all, i_all = [], []
    for r, (t, b, ts) in enumerate(ROWS):
        qt = np.full((1, 4), -1, np.int32)
        qt[0, :len(TERMS[r])] = TERMS[r]
        pred = Predicate(tenant=t, min_ts=ts, acl_bits=b).as_array().numpy()
        s, i = j_hybrid_ref(jnp.asarray(QS[r:r + 1]), jnp.asarray(st["emb"]),
                            jnp.asarray(meta), jnp.asarray(terms),
                            jnp.asarray(lexnorm), jnp.zeros(1, jnp.int32),
                            jnp.asarray(pred[None]), jnp.asarray(qt),
                            j_qidf_of(jnp.asarray(idf), jnp.asarray(qt)), K,
                            mode=mode, w_dense=0.8, w_lex=1.7, rrf_c=60.0)
        s_all.append(np.asarray(s))
        i_all.append(np.asarray(i))
    return np.concatenate(s_all), np.concatenate(i_all)


@pytest.mark.parametrize("placement", ["hash", "tenant"])
def test_hybrid_matches_reference_mesh(ref, placement):
    """wsum and rrf, resident and paged, on a db over four devices after
    the write sequence: the lists against the reference's RagDB(mesh=)
    over 4 XLA host devices, its dense oracle and the one-device port db;
    one hybrid unit a batch, `ExecStats` equal to the reference's after
    every batch, no leaked slot."""
    multi, one = _written(placement), _written(placement, ["cpu"] * S)
    assert len(multi.log.snapshot()[ALLOCS]) == S
    assert len(lex_allocations(multi.lex.snapshot())) == S
    runs = iter(ref[placement])
    for paged in (False, True):
        for db in (multi, one):
            db.planner_cfg = PAGED if paged else PlannerConfig()
        for mode in ("wsum", "rrf"):
            want = next(runs)
            plans = _hybrid_plans(multi, mode)
            assert {p.engine for p in plans} == {"hybrid"}
            assert ({p.page_rows for p in plans}
                    == {64 if paged else None})
            got = multi.execute(plans, use_cache=False)
            _agree(got, want["out"])
            assert _stats(multi, HYB_STATS) == want["stats"], (paged, mode)
            assert _leaks(multi.log.snapshot(), ROWS, got[1]) == 0
            assert_topk_agree(*got[:2], *_plain_hybrid(multi, mode))
            single = one.execute(_hybrid_plans(one, mode), use_cache=False)
            assert_topk_agree(*got[:2], *single[:2])
    assert _stats(multi, HYB_STATS) == _stats(one, HYB_STATS)


def test_rrf_fuses_global_ranks():
    """Over several allocations a fused rrf unit ranks each signal over the
    whole arena: its list equals the one-arena rrf of the merged per-signal
    lists, never a fusion of one region's ranks."""
    from repro_torch.api import executor as ex
    from repro_torch.kernels.hybrid_score.ref import rrf_fuse
    db = _written()
    plan = _hybrid_plans(db, "rrf")[1]
    qt = ex._qterms_rows([plan], [0], plan.lex[1])
    args = (db.log.snapshot(), db.lex.snapshot(), plan.logical.q,
            np.zeros(1, np.int32), [plan.pred], qt, K)
    kw = dict(mode="rrf", w_dense=0.8, w_lex=1.7, rrf_c=60.0)
    fused = ex._launch_hybrid(*args, **kw)
    lists = ex._launch_hybrid(*args, lists=True, **kw)
    want = rrf_fuse(lists.s, lists.sl, *lists.extra, K, 60.0)
    assert torch.equal(fused.s, want[0]) and torch.equal(fused.sl, want[1])
    # the dense list spans regions: a region's own top-k would not do
    assert len({int(s) // RPS for s in lists.sl[0] if s >= 0}) > 1


# -- IVF ------------------------------------------------------------------

def _carry(jix: dict, db, cfg=IVFConfig(n_clusters=16, nprobe=4)):
    """The reference's index (its arrays) as the port db's, one mirror a
    device."""
    snap = db.log.snapshot()
    ix = IVFIndex(cfg, np.asarray(jix["centroids"], np.float32),
                  np.asarray(jix["members"], np.int32),
                  np.asarray(jix["fill"], np.int64), jix["overflow"],
                  n_at_build=jix["n_at_build"], device=CPUS[0],
                  regions=layout(snap) if ALLOCS in snap else None)
    db.index = ix
    db.log.ivf = ix
    return ix


def test_ivf_carried_index_matches_reference(ref):
    """The reference's index carried onto the db over four devices: the
    mirrors are the member table made local to each region; the forced
    ivf batch against the reference's lists, its plain probe over the
    whole arena and rows_scanned; a recency bound 3 rows clear fires the
    exact rescan over every allocation, then the starved path."""
    db = _written()
    ix = _carry(ref["index"], db)
    mirrors = ix.device_arrays()["regions"]
    for (_, lo, rows), m in zip(layout(db.log.snapshot()), mirrors):
        table = ix.members
        local = np.where((table >= lo) & (table < lo + rows), table - lo, -1)
        np.testing.assert_array_equal(m["members"].numpy(), local)
    plans = _ivf_plans(db)
    assert {p.engine for p in plans} == {"ivf"}
    got = db.execute(plans, use_cache=False)
    _agree(got, ref["ivf"]["out"])
    assert _stats(db, ("device_calls", "rows_scanned")) == ref["ivf"]["stats"]
    assert _leaks(db.log.snapshot(), ROWS, got[1]) == 0
    st = to_numpy(db.log.snapshot())
    for r, (t, b, ts) in enumerate(ROWS):
        # the group's probe: the union over the rows of its predicate
        clusters, _, _ = ix.probe(QS[[r % 4, r % 4 + 4]], 4)
        pred = Predicate(tenant=t, min_ts=ts, acl_bits=b).as_array().numpy()
        js, ji = j_ivf_probe(
            jnp.asarray(QS[r:r + 1]), jnp.asarray(st["emb"]),
            jnp.asarray(st["tenant"]), jnp.asarray(st["updated_at"]),
            jnp.asarray(st["category"]), jnp.asarray(st["acl"]),
            jnp.asarray(ix.members), jnp.asarray(ix._overflow_host()),
            jnp.asarray(clusters), jnp.asarray(pred), K, use_kernel=False)
        assert_topk_agree(got[0][r:r + 1], got[1][r:r + 1], np.asarray(js),
                          np.asarray(ji))
    tight = _ivf_plans(db, _tight_ts())
    rows = []
    for want in ref["ivf_tight"]:
        r0 = db.stats.rows_scanned
        out = db.execute(tight, use_cache=False)
        rows.append(db.stats.rows_scanned - r0)
        _agree(out, want["out"])
    assert rows[0] > CAP and rows[1] == CAP
    assert rows == [w["stats"]["rows_scanned"] - prev for w, prev in zip(
        ref["ivf_tight"], [ref["ivf"]["stats"]["rows_scanned"],
                           ref["ivf_tight"][0]["stats"]["rows_scanned"]])]
    assert len(ix.starved) == ref["ivf_starved"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_build_index_over_allocations(seed):
    """`build_index` over four allocations (each device assigns its rows,
    the controller reduces): every live slot in exactly one member entry
    or in the overflow tail, recall@10 >= 0.95 against the exact engine on
    the reference test's seed grid, one mirror a device."""
    ccfg = CorpusConfig(n_docs=3000, dim=32, n_tenants=4, n_categories=4,
                        seed=seed)
    db = RagDB(StoreConfig(capacity=4096, dim=32),
               mesh=make_mesh((S,), ("data",), devices=CPUS),
               device=CPUS[0])
    db.ingest(make_corpus(ccfg, device="cpu"))
    ix = db.build_index()
    assert ix.regions is not None and len(ix.device_arrays()["regions"]) == S
    live = np.flatnonzero(to_numpy(db.log.snapshot())["tenant"] >= 0)
    listed = np.concatenate([ix.members[ix.members >= 0],
                             np.asarray(ix.overflow, np.int64)])
    assert len(listed) == len(live) == 3000
    np.testing.assert_array_equal(np.sort(listed), live)
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


def test_kmeans_over_allocations_matches_one(monkeypatch):
    """k-means over four allocations draws the same C distinct live seed
    rows as over the same rows held in one allocation, and its Lloyd
    steps (each device summing its own rows, the controller adding) give
    the same centroids within 1e-5 and the same assignment; a build over
    the allocations lists every live slot once and finds a written doc."""
    from repro_torch.core import ivf as ivf_core
    db = _written()
    snap = db.log.snapshot()
    lives = [p["tenant"] >= 0 for p in snap[ALLOCS]]
    embs = [p["emb"] for p in snap[ALLOCS]]
    drawn = []
    real = torch.topk

    def spy(x, k, *a, **kw):
        out = real(x, k, *a, **kw)
        drawn.append(out.indices)
        return out
    monkeypatch.setattr(torch, "topk", spy)
    multi = ivf_core._kmeans_allocations(embs, lives, 16, 4, 0, CPUS[0])
    one = ivf_core._kmeans_allocations([torch.cat(embs)], [torch.cat(lives)],
                                       16, 4, 0, "cpu")
    monkeypatch.setattr(torch, "topk", real)
    seeds, seeds_one = drawn
    assert torch.equal(seeds, seeds_one)
    assert len(set(seeds.tolist())) == 16
    assert torch.cat(lives)[seeds].all()
    np.testing.assert_allclose(multi.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)
    live = torch.cat(lives)
    np.testing.assert_array_equal(
        ivf_core._assign(torch.cat(embs), multi)[live].numpy(),
        ivf_core._assign(torch.cat(embs), one)[live].numpy())
    ix = db.build_index(IVFConfig(n_clusters=16, nprobe=4))
    live = np.flatnonzero(to_numpy(db.log.snapshot())["tenant"] >= 0)
    listed = np.concatenate([ix.members[ix.members >= 0],
                             np.asarray(ix.overflow, np.int64)])
    np.testing.assert_array_equal(np.sort(listed), live)
    res = (db.session(Principal(tenant_id=0, group_bits=ALL))
           .search(QS[0], normalize=False).limit(K).using("ivf").run())
    assert (res.slots[0] >= 0).all()


def test_ivf_writes_patch_each_device_and_starve():
    """A write through the ivf hook patches only its clusters' rows, on
    every device's mirror, and the probe sees it; a predicate the whole
    arena cannot fill goes to the exact engine over every allocation."""
    db = _written()
    ix = db.build_index(IVFConfig(n_clusters=16, nprobe=4))
    before = [{k: m[k].clone() for k in ("members", "overflow")}
              for m in ix.device_arrays()["regions"]]
    patches = ix.mirror_patches
    new = _docs(21, 6, first=7000)
    new["emb"][0] = QS[2]
    new["tenant"][0], new["acl"][0], new["updated_at"][0] = 2, 2, 90
    _apply(db, "ingest", new)
    dirty = set(ix._dirty_clusters)
    assert dirty
    res = (db.session(Principal(tenant_id=2, group_bits=2))
           .search(QS[2], normalize=False).limit(K).using("ivf").run())
    assert int(to_numpy(db.log.snapshot())["doc_id"][res.slots[0][0]]) \
        == 7000
    assert ix.mirror_patches == patches + 1
    for (dev, lo, rows), old, m in zip(layout(db.log.snapshot()), before,
                                       ix.device_arrays()["regions"]):
        changed = set(np.flatnonzero(
            (m["members"] != old["members"]).any(1).numpy()).tolist())
        assert changed <= dirty
        local = np.where((ix.members >= lo) & (ix.members < lo + rows),
                         ix.members - lo, -1)
        np.testing.assert_array_equal(m["members"].numpy(), local)
    starved = (db.admin_session().search(QS[0], normalize=False)
               .newer_than(10 ** 6).limit(K).using("ivf"))
    plan = starved.plan()
    first = db.execute([plan], use_cache=False)
    assert (first[1] == -1).all() and len(ix.starved) == 1
    r0 = db.stats.rows_scanned
    db.execute([plan], use_cache=False)
    assert db.stats.rows_scanned - r0 == CAP


# -- tiers ----------------------------------------------------------------

def test_tiers_match_reference_mesh(ref):
    """A tiered db whose hot arena sits in four regions on their own
    devices and whose warm tier lives on the controller: routes, (scores,
    slots, tiers) and `ExecStats` of hot, tail, tail wsum and tail rrf
    batches as the reference's; a warm delete misses the cache and never
    comes back; a warm doc updated at now moves hot and tops its tenant's
    next hot batch from tier 0."""
    want = ref["tiers"]
    db = _tiered()
    assert len(db.log.snapshot()[ALLOCS]) == S
    assert int(db.log.snapshot()["n_live"]) == want["hot_docs"]
    assert db.router.warm.n_docs == want["warm_docs"]
    for kind in ("hot", "tail", "wsum", "rrf"):
        plans = _tier_plans(db, kind)
        assert [p.route for p in plans] == want[kind]["routes"]
        assert [p.engine for p in plans] == want[kind]["engines"]
        got = db.execute(plans, use_cache=False)
        w = [np.asarray(x) for x in want[kind]["out"]]
        assert_topk_agree(got[0], _enc(got[1], got[2]), w[0].astype(
            np.float32), _enc(w[1], w[2]))
        assert _stats(db, TIER_STATS) == want[kind]["stats"], kind
    assert set(want["hot"]["routes"]) == {"hot"}
    assert set(want["rrf"]["routes"]) == {"hot+warm"}
    warm = db.router.warm
    s, sl, tr = db.execute(_tier_plans(db, "tail"), use_cache=False)
    victim, mover = (int(warm.meta["doc_id"][int(w)]) for w in sl[tr == 1][:2])
    assert (victim, mover) == (want["victim"], want["mover"])
    tail = _tier_plans(db, "tail")
    db.execute(tail)
    db.execute(tail)
    hits = db.result_cache.hits
    db.delete([victim])
    got = db.execute(tail)
    assert [hits, db.result_cache.hits] == want["hits"]
    assert hits > 0 and db.result_cache.hits == hits
    w = [np.asarray(x) for x in want["after_delete"]["out"]]
    assert_topk_agree(got[0], _enc(got[1], got[2]), w[0].astype(np.float32),
                      _enc(w[1], w[2]))
    assert not ((got[2] == 1) & (got[1] == sl[tr == 1][0])).any()
    db.update([mover], torch.from_numpy(MOVER_EMB[None]),
              torch.tensor([NOW], dtype=torch.int32))
    assert db.log.has_doc(mover) and not warm.has_doc(mover)
    assert db.log.slot_of(mover) == want["mover_slot"]
    res = (db.session(Principal(tenant_id=want["mover_tenant"],
                                group_bits=ALL))
           .search(MOVER_EMB, normalize=False).newer_than(NOW - 40)
           .limit(K).run())
    assert res.plan.route == "hot"
    assert (res.slots[0][0], res.tiers[0][0]) == (want["mover_slot"], 0)
    w = [np.asarray(x) for x in want["moved"]["out"]]
    assert_topk_agree(res.scores, _enc(res.slots, res.tiers),
                      w[0].astype(np.float32), _enc(w[1], w[2]))


@pytest.mark.parametrize("kind", ["hot", "tail"])
def test_tiers_sharded_engine_match_reference_mesh(ref, kind):
    """The planner's default choice for a hot arena of shard_min_rows
    over the regions, the sharded engine: each group's hot scan one launch
    a region on the region's device, then the warm probe; routes,
    engines, (scores, slots, tiers), `ExecStats` and each region's rows
    scanned as the reference's tiered mesh db."""
    want = ref["tiers"]["sharded_" + kind]
    db = _tiered()
    db.planner_cfg = PlannerConfig(shard_min_rows=SHARD_MIN_ROWS)
    plans = _tier_plans(db, kind)
    assert [p.route for p in plans] == want["routes"]
    assert [p.engine for p in plans] == want["engines"]
    assert set(want["engines"]) == {"sharded"}
    s0, r0 = _stats(db, TIER_STATS), list(db.stats.shard_rows_scanned)
    got = db.execute(plans, use_cache=False)
    w = [np.asarray(x) for x in want["out"]]
    assert_topk_agree(got[0], _enc(got[1], got[2]), w[0].astype(np.float32),
                      _enc(w[1], w[2]))
    s1 = _stats(db, TIER_STATS)
    assert {n: s1[n] - s0[n] for n in s0} == want["stats"]
    r0 += [0] * (len(db.stats.shard_rows_scanned) - len(r0))
    assert [x - y for x, y in zip(db.stats.shard_rows_scanned, r0)] == \
        want["shard_rows"]
    assert len(want["shard_rows"]) == S and all(want["shard_rows"])


# -- the lexical arena ----------------------------------------------------

def test_lexical_lanes_one_pair_a_device():
    """The lanes of a db over four devices: one pair an allocation, the
    same rows and statistics as the one-device db's lanes after the same
    writes; each allocation's lexnorm equals the one arena's rows (one
    global avgdl) and every device's idf has the same bits."""
    multi, one = _written(), _written("hash", ["cpu"] * S)
    views = lex_allocations(multi.lex.snapshot())
    whole = one.lex.snapshot()
    assert [v["terms"].shape[0] for v in views] == [RPS] * S
    for name in ("terms", "tfs", "lexnorm"):
        torch.testing.assert_close(torch.cat([v[name] for v in views]),
                                   whole[name], rtol=0, atol=0)
    for v in views:
        assert torch.equal(v["idf"], whole["idf"])
    for a, b in ((multi.lex.stats, one.lex.stats),):
        assert (a.n_docs, a.total_len, a.version) == (
            b.n_docs, b.total_len, b.version)
        np.testing.assert_array_equal(a.df, b.df)
    slots = [1, RPS + 3, 3 * RPS + 7, 2]
    for x, y in zip(multi.lex.rows(slots), one.lex.rows(slots)):
        np.testing.assert_array_equal(x, y)


def test_regions_db_takes_every_part():
    """A RagDB over four distinct devices builds with lexical_cfg,
    warm_cfg and build_index(), and explain() says where it is held."""
    db = _tiered()
    ix = db.build_index(IVFConfig(n_clusters=8))
    assert ix.n_clusters == 8 and ix.device.type == "cpu"
    assert [dev for dev, _, _ in ix.regions] == [torch.device("cpu")] * S
    assert "held on 4 devices" in db.explain()
    plan = (db.session(Principal(tenant_id=1, group_bits=ALL))
            .search(QS[0], normalize=False).match(TERMS[0]).plan())
    assert plan.engine == "hybrid" and plan.route == "hot+warm"


# -- crashes --------------------------------------------------------------

def _crash_fp(db) -> dict:
    snap = to_numpy(db.log.snapshot())
    views = lex_allocations(db.lex.snapshot())
    st, ix = db.lex.stats, db.index
    return {**snap,
            "terms": np.concatenate([v["terms"].numpy() for v in views]),
            "tfs": np.concatenate([v["tfs"].numpy() for v in views]),
            "df": st.df.copy(), "lexn": np.array(
                [st.n_docs, st.total_len, st.version, db.lex.commit_count]),
            "members": ix.members.copy(), "fill": ix.fill.copy(),
            "overflow": np.asarray(ix.overflow),
            "ix": np.array([ix.churn, db.log.commit_count])}


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("op", ["ingest", "update", "delete"])
def test_crash_with_lanes_and_index_matches_one_device(op, point):
    """A crash at every publish point of a write, with lanes and an index,
    then recover: the db over four devices equals the one-device db with
    the write undone (prepare, intent) or done -- columns, lanes, BM25
    statistics, member table -- and every mirror is the table made local
    to its region."""
    last = {"ingest": WRITES[3], "update": WRITES[1],
            "delete": WRITES[2]}[op]
    pre = [w for w in WRITES if w is not last]
    dbs = [_db("hash"), _db("hash", ["cpu"] * S), _db("hash", ["cpu"] * S)]
    for db in dbs:
        for w in pre:
            _apply(db, *w)
    built = dbs[1].build_index(IVFConfig(n_clusters=16, nprobe=4))
    jix = {"centroids": built.centroids, "members": built.members,
           "fill": built.fill, "overflow": built.overflow,
           "n_at_build": built.n_at_build}
    for db in (dbs[0], dbs[2]):
        _carry(jix, db)
    multi, pre_db, post_db = dbs
    _apply(post_db, *last)
    multi.log.faults = FaultPlan(0, {f"txn.{op}.{point}":
                                     FaultRule(at=(0,))})
    with pytest.raises(CrashError):
        _apply(multi, *last)
    outcome = multi.log.recover()
    want = pre_db if point in ("prepare", "intent") else post_db
    assert outcome == ("rolled-forward" if want is post_db
                       else ("noop", "rolled-back")[point == "intent"])
    a, b = _crash_fp(multi), _crash_fp(want)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    ix = multi.index
    for (_, lo, rows), m in zip(layout(multi.log.snapshot()),
                                ix.device_arrays()["regions"]):
        local = np.where((ix.members >= lo) & (ix.members < lo + rows),
                         ix.members - lo, -1)
        np.testing.assert_array_equal(m["members"].numpy(), local)


# -- the sharded entry points ---------------------------------------------

@pytest.mark.parametrize("layout_", [(0, 1, 2, 3), (0, 0, 1, 1)])
def test_filtered_topk_sharded_takes_pieces(layout_):
    """Pieces on the mesh's devices, one a device group in row order,
    give the one-tensor call's lists: the same per-shard launches, merged
    by position on q's device."""
    rng = np.random.default_rng(5)
    N = 1024
    emb = torch.from_numpy(rng.standard_normal((N, DIM), dtype=np.float32))
    meta = _pack_meta(*(torch.from_numpy(x) for x in (
        rng.integers(0, 3, N).astype(np.int32),
        rng.integers(0, 100, N).astype(np.int32),
        rng.integers(0, 4, N).astype(np.int32),
        rng.integers(1, 4, N).astype(np.int32))))
    q = torch.from_numpy(rng.standard_normal((6, DIM), dtype=np.float32))
    pred = Predicate(tenant=1, min_ts=20, acl_bits=1).as_array()
    mesh = make_mesh((S,), ("data",), devices=[CPUS[i] for i in layout_])
    groups = sorted(set(layout_))
    per = N // S
    cut = [per * layout_.count(g) for g in groups]
    e_p, m_p = torch.split(emb, cut), torch.split(meta, cut)
    got = filtered_topk_sharded(mesh, "data", q, e_p, m_p, pred, K)
    want = filtered_topk_sharded(mesh, "data", q, emb, meta, pred, K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pieces"):
        filtered_topk_sharded(mesh, "data", q, e_p[:-1], m_p[:-1], pred, K)


@pytest.mark.parametrize("layout_", [(0, 1, 2, 3), (0, 1, 1, 1)])
def test_decode_attention_sharded_takes_pieces(layout_):
    """KV cache pieces along S on the mesh's devices give the one-tensor
    call's output within 2e-5, and the unsharded kernel's."""
    rng = np.random.default_rng(6)
    B, Sq, KV, G, hd = 3, 512, 2, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, KV * G, hd),
                                             dtype=np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((B, Sq, KV, hd),
                                                   dtype=np.float32))
              for _ in range(2))
    lengths = torch.tensor([100, 300, 512], dtype=torch.int32)
    mesh = make_mesh((S,), ("seq",), devices=[CPUS[i] for i in layout_])
    per = Sq // S
    cut = [per * layout_.count(g) for g in sorted(set(layout_))]
    k_p, v_p = torch.split(kc, cut, dim=1), torch.split(vc, cut, dim=1)
    got = decode_attention_sharded(mesh, "seq", q, k_p, v_p, lengths, KV)
    want = decode_attention_sharded(mesh, "seq", q, kc, vc, lengths, KV)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, decode_attention(q, kc, vc, lengths, KV),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="positions"):
        decode_attention_sharded(mesh, "seq", q, [kc[:, :-4]] + list(k_p[1:]),
                                 [vc[:, :-4]] + list(v_p[1:]), lengths, KV)
