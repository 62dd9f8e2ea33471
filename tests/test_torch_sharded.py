"""Parity of the port's sharded engine with the reference's.

The port drives S logical shards from one controller, here all on the
CPU (``make_mesh((S,), ("data",), devices=["cpu"] * S)``), where each
shard's scan is the arena-scan kernel's plain version; the reference runs
``shard_map`` over a JAX mesh (one device in this process, 8 fake XLA
devices in the one subprocess below). The same numpy inputs go through
both:

  * `lex_topk` / `lex_merge` against a brute-force (score desc, doc_id
    asc) oracle and the reference's functions, under quantised-score ties
    and NEG_INF rows;
  * `make_sharded_arena_scan` at S in {1, 2, 8}, hash and tenant
    placement, against the reference's dense oracle (scores within
    rtol = atol = 1e-5: a shard's matmul rounds differently from the whole
    arena's on the CPU; slots equal but for ties at the k-th place), the
    lists in exact (score, doc_id) order, rows_scanned exactly;
  * placement invariance under 64 constructed ties at S = 8 (the tie
    widening must fire), the tenant-affine property sweep with poisoned
    rows, the slot allocator against the reference's;
  * a mesh-built `RagDB` at S = 1 against the reference's in process (plan
    keys, explain() lines, `ExecStats`, collective bytes included), and
    the reference's collective bytes, rows vectors and lists at S = 8 from
    one subprocess;
  * `filtered_topk_sharded` and `decode_attention_sharded` (plain
    versions) against the reference's single-device oracles, a shard with
    no live row included; the misuse probes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.ragdb import RagDB as JRagDB
from repro.core.query import Predicate as JPredicate
from repro.core.query import unified_query_ref as j_unified_query_ref
from repro.core.store import DocBatch as JDocBatch
from repro.core.store import ShardPlacement as JShardPlacement
from repro.core.store import StoreConfig as JStoreConfig
from repro.core.store import empty as j_empty
from repro.core.tenancy import Principal as JPrincipal
from repro.core.transactions import TransactionLog as JTransactionLog
from repro.kernels.arena_scan.sharded import lex_merge as j_lex_merge
from repro.kernels.arena_scan.sharded import lex_topk as j_lex_topk
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.filtered_topk.ref import filtered_topk_ref
from repro.launch.mesh import make_mesh as j_make_mesh
from repro_torch.api import RagDB
from repro_torch.api.plan import bucket_rows
from repro_torch.core.query import Predicate, make_sharded_query
from repro_torch.core.store import DocBatch, ShardPlacement, StoreConfig
from repro_torch.core.store import to_numpy
from repro_torch.core.tenancy import Principal
from repro_torch.core.transactions import TransactionLog
from repro_torch.distributed.collectives import topk_allgather_merge
from repro_torch.kernels.arena_scan import sharded as sh_mod
from repro_torch.kernels.arena_scan.sharded import (INT32_MAX, lex_merge,
                                                    lex_topk,
                                                    make_sharded_arena_scan,
                                                    sharded_collective_bytes)
from repro_torch.kernels.arena_scan.stages import NEG_INF
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_sharded)
from repro_torch.kernels.filtered_topk.ops import (filtered_topk,
                                                   filtered_topk_sharded)
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from tests.test_property_isolation import SEED_GRID, _args_from_seed, _corpus
from tests.test_torch_arena_scan import TOL, assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _mesh(S):
    return make_mesh((S,), ("data",), devices=["cpu"] * S)


def _lex_oracle(scores, doc_ids, k):
    """Brute-force lexicographic (score desc, id asc) top-k per row."""
    b, n = scores.shape
    out_s = np.full((b, k), NEG_INF, np.float32)
    out_d = np.full((b, k), INT32_MAX, np.int64)
    out_p = np.full((b, k), -1, np.int64)
    for r in range(b):
        order = sorted(range(n), key=lambda j: (-scores[r, j], doc_ids[j]))
        take = order[:min(k, n)]
        out_s[r, :len(take)] = scores[r, take]
        out_d[r, :len(take)] = doc_ids[take]
        out_p[r, :len(take)] = take
    return out_s, out_d, out_p


def _tied_scores(rng, b, n):
    """Quantised scores (real ties) with a sprinkle of NEG_INF entries."""
    scores = rng.integers(0, 8, (b, n)).astype(np.float32)
    scores[rng.random((b, n)) < 0.2] = NEG_INF
    return scores


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n,k", [(3, 5), (64, 7), (200, 10)])
def test_lex_topk_matches_oracle_and_reference(seed, n, k):
    rng = np.random.default_rng(seed)
    scores = _tied_scores(rng, 3, n)
    doc_ids = rng.permutation(10_000)[:n].astype(np.int32)
    s, d, p = (a.numpy() for a in lex_topk(torch.from_numpy(scores),
                                           torch.from_numpy(doc_ids), k))
    assert d.dtype == np.int32 and p.dtype == np.int32
    es, ed, ep = _lex_oracle(scores, doc_ids, k)
    np.testing.assert_array_equal(s, es)
    np.testing.assert_array_equal(d, ed)
    np.testing.assert_array_equal(p, ep)
    js, jd, jp = (np.asarray(a) for a in j_lex_topk(
        jnp.asarray(scores), jnp.asarray(doc_ids), k))
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("S,k", [(2, 4), (8, 10)])
def test_lex_merge_matches_oracle_and_reference(seed, S, k):
    """Gathered per-shard lists (each with (NEG_INF, INT32_MAX, -1)
    padding) merge to the oracle's (score, doc_id) top-k, slots -1 past
    the fill, as the reference's merge gives them."""
    rng = np.random.default_rng(seed)
    b = 3
    scores = _tied_scores(rng, b, S * k)
    doc_ids = np.tile(rng.permutation(10_000)[:S * k].astype(np.int32),
                      (b, 1))
    slots = np.tile(np.arange(S * k, dtype=np.int32) * 7, (b, 1))
    pad = scores == NEG_INF
    doc_ids[pad], slots[pad] = INT32_MAX, -1
    s, sl = (a.numpy() for a in lex_merge(
        torch.from_numpy(scores), torch.from_numpy(doc_ids),
        torch.from_numpy(slots), k))
    js, jsl = (np.asarray(a) for a in j_lex_merge(
        jnp.asarray(scores), jnp.asarray(doc_ids), jnp.asarray(slots), k))
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(sl, jsl)
    for r in range(b):
        es, _, ep = _lex_oracle(scores[r:r + 1], doc_ids[r], k)
        np.testing.assert_array_equal(s[r], es[0])
        want = np.where(es[0] > NEG_INF, slots[r][np.maximum(ep[0], 0)], -1)
        np.testing.assert_array_equal(sl[r], want)


def test_topk_allgather_merge_breaks_ties_by_id():
    rng = np.random.default_rng(3)
    parts_s = [_tied_scores(rng, 2, 5) for _ in range(4)]
    parts_i = [rng.permutation(1000)[:5][None, :].repeat(2, 0) + 1000 * j
               for j in range(4)]
    s, i = topk_allgather_merge([torch.from_numpy(a) for a in parts_s],
                                [torch.from_numpy(a) for a in parts_i], 6)
    all_s, all_i = np.concatenate(parts_s, 1), np.concatenate(parts_i, 1)
    for r in range(2):
        es, ed, _ = _lex_oracle(all_s[r:r + 1], all_i[r], 6)
        np.testing.assert_array_equal(s[r].numpy(), es[0])
        np.testing.assert_array_equal(i[r].numpy(), ed[0])


# -- the shard-mapped scan ------------------------------------------------

def _placed_store(S, kind, n_docs, dim, *, seed, n_tenants=6, cap=None):
    """A store built through the port's TransactionLog under a placement
    (regions sized for the fullest shard unless ``cap`` is given), and the
    rows' columns in doc-id order."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_docs, dim), dtype=np.float32)
    tenant = rng.integers(0, n_tenants, n_docs).astype(np.int32)
    cat = rng.integers(0, 4, n_docs).astype(np.int32)
    ts = rng.integers(1, 100, n_docs).astype(np.int32)
    doc = np.arange(n_docs, dtype=np.int32)
    key = tenant if kind == "tenant" else doc
    cap = cap or S * (int(np.bincount(key % S, minlength=S).max()) + 3)
    log = TransactionLog(StoreConfig(capacity=cap, dim=dim, metric="dot"),
                         placement=ShardPlacement(S, cap, kind), device="cpu")
    log.ingest(_batch(emb, tenant, cat, ts, np.full(n_docs, 3), doc))
    return log.snapshot(), dict(emb=emb, tenant=tenant, cat=cat, ts=ts)


def _batch(emb, tenant, cat, ts, acl, doc):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    return DocBatch(emb=torch.from_numpy(np.ascontiguousarray(emb)),
                    tenant=t(tenant), category=t(cat), updated_at=t(ts),
                    acl=t(acl), doc_id=t(doc))


def _j_store(store):
    return {k: jnp.asarray(v) for k, v in to_numpy(store).items()}


def assert_lex_ordered(scores, slots, doc_of_slot):
    """Within each row the list is in exact (score desc, doc_id asc)
    order, and -1 slots only past the fill."""
    for b in range(scores.shape[0]):
        live = slots[b] >= 0
        n = int(live.sum())
        assert live[:n].all()
        keys = [(-float(s), int(doc_of_slot[i]))
                for s, i in zip(scores[b][:n], slots[b][:n])]
        assert keys == sorted(keys), f"row {b}: not (score, doc_id) ordered"


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("kind", ["hash", "tenant"])
@pytest.mark.parametrize("scoped", [False, True])
def test_sharded_scan_matches_dense_oracle(S, kind, scoped):
    store, _ = _placed_store(S, kind, 300, 16, seed=S + 7 * scoped)
    N = store["emb"].shape[0]
    k = 7
    rng = np.random.default_rng(S)
    q = rng.standard_normal((3, 16), dtype=np.float32)
    pred = Predicate(tenant=4 if scoped else -2, min_ts=20,
                     cat_mask=0b1011)
    fn = make_sharded_arena_scan(_mesh(S), ("data",), N, k,
                                 placement_kind=kind)
    s, sl, rows = fn(store, torch.from_numpy(q), pred)
    assert s.dtype == torch.float32 and sl.dtype == torch.int32
    js, ji = j_unified_query_ref(
        _j_store(store), jnp.asarray(q),
        JPredicate(tenant=pred.tenant, min_ts=20, cat_mask=0b1011).as_array(),
        k)
    assert_topk_agree(s.numpy(), sl.numpy(), np.asarray(js), np.asarray(ji))
    assert_lex_ordered(s.numpy(), sl.numpy(), store["doc_id"].numpy())
    n_local = N // S
    owner = 4 % S
    want = [n_local if (kind != "tenant" or not scoped or sid == owner)
            else 0 for sid in range(S)]
    assert rows.tolist() == want
    # the 2-output wrapper returns the same lists
    s2, sl2 = make_sharded_query(_mesh(S), "data", N, k, kind)(
        store, torch.from_numpy(q), pred)
    assert torch.equal(s2, s) and torch.equal(sl2, sl)


def _int_store(order, n=512, dim=8, seed=0):
    """Integer-valued embeddings (exact dot products in any summation
    order) with rows 0..63 sharing ONE embedding: 64 exact score ties."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-3, 4, (n, dim)).astype(np.float32)
    emb[:64] = emb[0]
    tenant = rng.integers(0, 4, n).astype(np.int32)
    docs = np.arange(n, dtype=np.int32)
    zeros = np.zeros(n, np.int32)
    return {"emb": torch.from_numpy(emb[order]),
            "tenant": torch.from_numpy(tenant[order]),
            "category": torch.from_numpy(zeros),
            "updated_at": torch.from_numpy(zeros + 5),
            "acl": torch.from_numpy(zeros + 1),
            "doc_id": torch.from_numpy(docs[order]),
            "version": torch.from_numpy(zeros),
            "commit_ts": torch.tensor(1, dtype=torch.int32),
            "n_live": torch.tensor(n, dtype=torch.int32)}, emb


@pytest.mark.parametrize("k", [5, 10])
def test_placement_invariance_under_constructed_ties(k):
    """64 rows share one embedding (exact ties); shuffling which shard
    holds which rows cannot move the merged (score, doc_id) lists, and the
    tie widening fires (a shard's k+1 list ends inside the tie run)."""
    n, S = 512, 8
    perm = np.random.default_rng(1).permutation(n)
    outs = []
    widens0 = sh_mod.TIE_WIDENS
    for order in (np.arange(n), perm):
        store, emb = _int_store(order, n)
        q = emb[:1].repeat(2, 0) + np.array([[0.0] * 8, [1.0] + [0.0] * 7],
                                            np.float32)
        fn = make_sharded_arena_scan(_mesh(S), ("data",), n, k)
        s, sl, _ = fn(store, torch.from_numpy(q), Predicate())
        docs = store["doc_id"].numpy()
        outs.append((s.numpy(), np.where(sl.numpy() >= 0,
                                         docs[np.maximum(sl.numpy(), 0)], -1)))
    assert sh_mod.TIE_WIDENS > widens0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    # the tied run resolves to the smallest doc ids: rows 0.. of the run
    assert (outs[0][1][0] == np.arange(k)).all()


@pytest.mark.parametrize("seed", SEED_GRID[:10])
def test_sharded_affine_isolation_property(seed):
    """The reference's tenant-affine sweep (`_check_sharded_affine_
    isolation`) through a mesh-built port RagDB at S = 8: only the owning
    shard scans, a poisoned foreign-tenant row built to out-score the
    corpus never surfaces, and the lists match the reference's oracle."""
    emb, tenant, ts, cat, acl, pred, q, k = _corpus(_args_from_seed(seed))
    n, S = emb.shape[0], 8
    tenant = np.abs(tenant).astype(np.int32) % 6
    principal_tenant = abs(pred.tenant) % 6
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-6)
    emb = np.concatenate([emb, 100.0 * qn.astype(np.float32)])
    tenant = np.concatenate(
        [tenant, np.full(2, (principal_tenant + 1) % 6, np.int32)])
    ts = np.concatenate([ts, np.full(2, 600, np.int32)])
    cat = np.concatenate([cat, cat[:2]])
    acl = np.concatenate([acl, np.full(2, 0xFFFFFFFF, np.uint32)])
    n += 2
    cap = S * (int(np.bincount(tenant % S, minlength=S).max()) + 1)
    db = RagDB(StoreConfig(capacity=cap, dim=8, metric="dot"), mesh=_mesh(S),
               shard_axes=("data",), placement="tenant", device="cpu")
    db.ingest(_batch(emb, tenant, cat, ts, acl.view(np.int32),
                     np.arange(n)))
    principal = Principal(tenant_id=principal_tenant,
                          group_bits=pred.acl_bits)
    res = (db.session(principal).search(q, normalize=False)
           .newer_than(pred.min_ts).limit(k).using("sharded").run())
    snap = db.log.snapshot()
    snap_tenant = snap["tenant"].numpy()
    for b in range(2):
        got = res.slots[b][res.slots[b] >= 0]
        assert (snap_tenant[got] == principal_tenant).all()
        assert (res.scores[b] < 50.0).all(), "poisoned score leaked"
    owner = principal_tenant % S
    assert db.stats.shard_rows_scanned == [cap // S if s == owner else 0
                                           for s in range(S)]
    lowered = JPredicate(tenant=principal_tenant, min_ts=pred.min_ts,
                         acl_bits=pred.acl_bits)
    s_ref, i_ref = j_unified_query_ref(_j_store(snap), jnp.asarray(q),
                                       lowered.as_array(), k)
    assert_topk_agree(res.scores, res.slots, np.asarray(s_ref),
                      np.asarray(i_ref))


@pytest.mark.parametrize("kind", ["hash", "tenant"])
def test_slot_allocator_matches_reference(kind):
    """The placement allocator (vectorised in the port) gives every doc
    the reference's slot, through ingests, deletes (LIFO recycling inside
    the owning region) and re-ingests."""
    S, cap, dim = 4, 96, 4
    rng = np.random.default_rng(5)
    jcfg = JStoreConfig(capacity=cap, dim=dim)
    jlog = JTransactionLog(jcfg, j_empty(jcfg),
                           placement=JShardPlacement(S, cap, kind))
    tlog = TransactionLog(StoreConfig(capacity=cap, dim=dim),
                          placement=ShardPlacement(S, cap, kind),
                          device="cpu")
    next_doc = 0

    def ingest(m):
        nonlocal next_doc
        emb = rng.standard_normal((m, dim), dtype=np.float32)
        ten = rng.integers(0, 7, m).astype(np.int32)
        doc = np.arange(next_doc, next_doc + m, dtype=np.int32)
        next_doc += m
        z = np.zeros(m, np.int32)
        jlog.ingest(JDocBatch(emb=jnp.asarray(emb), tenant=jnp.asarray(ten),
                              category=jnp.asarray(z),
                              updated_at=jnp.asarray(z + 1),
                              acl=jnp.asarray(z.astype(np.uint32) + 1),
                              doc_id=jnp.asarray(doc)))
        tlog.ingest(_batch(emb, ten, z, z + 1, z + 1, doc))
        return doc

    docs = list(ingest(40))
    gone = rng.choice(docs, 15, replace=False).tolist()
    jlog.delete(gone)
    tlog.delete(gone)
    docs = [d for d in docs if d not in gone] + list(ingest(30))
    for d in docs:
        assert tlog.slot_of(int(d)) == jlog.slot_of(int(d))


# -- the front door ---------------------------------------------------------

def _mesh_dbs(placement, n=256, dim=16, n_docs=200, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_docs, dim), dtype=np.float32)
    ten = rng.integers(0, 6, n_docs).astype(np.int32)
    cat = rng.integers(0, 4, n_docs).astype(np.int32)
    ts = rng.integers(1, 100, n_docs).astype(np.int32)
    doc = np.arange(n_docs, dtype=np.int32)
    jdb = JRagDB(JStoreConfig(capacity=n, dim=dim, metric="dot"),
                 mesh=j_make_mesh((1,), ("data",)), shard_axes=("data",),
                 placement=placement)
    jdb.ingest(JDocBatch(emb=jnp.asarray(emb), tenant=jnp.asarray(ten),
                         category=jnp.asarray(cat), updated_at=jnp.asarray(ts),
                         acl=jnp.asarray(np.ones(n_docs, np.uint32)),
                         doc_id=jnp.asarray(doc)))
    tdb = RagDB(StoreConfig(capacity=n, dim=dim, metric="dot"), mesh=_mesh(1),
                shard_axes=("data",), placement=placement, device="cpu")
    tdb.ingest(_batch(emb, ten, cat, ts, np.ones(n_docs), doc))
    return jdb, tdb, rng


def _key(key):
    pred, *rest = key
    return (dataclasses.astuple(pred), *rest)


STATS = ("device_calls", "queries", "hot_queries", "rows_scanned",
         "padded_rows", "fused_groups", "fused_scans", "shards_used",
         "collective_bytes", "shard_rows_scanned")


@pytest.mark.parametrize("placement", ["hash", "tenant"])
def test_mesh_ragdb_s1_matches_reference(placement):
    """A mesh-built RagDB at S = 1 in both packages: plan keys, the
    `sharding:` explain line, the slots, the `ExecStats` (collective bytes
    included) and the `sharded:` line of RagDB.explain() agree, for one
    plan and then for a batch of 8 rows in 4 tenant groups."""
    jdb, tdb, rng = _mesh_dbs(placement)
    q = rng.standard_normal((16,), dtype=np.float32)
    builders = [db.session(P(tenant_id=3, group_bits=1))
                .search(q, normalize=False).limit(5).using("sharded")
                for db, P in ((jdb, JPrincipal), (tdb, Principal))]
    jp, tp = (b.plan() for b in builders)
    assert tp.shards == 1 and tp.placement == placement
    assert _key(tp.group_key) == _key(jp.group_key)
    assert tp.fuse_key == jp.fuse_key and not tp.fusable
    assert tp.explain() == jp.explain()
    jr, tr = (b.run() for b in builders)
    np.testing.assert_array_equal(tr.slots, jr.slots)
    np.testing.assert_allclose(tr.scores, jr.scores, rtol=TOL, atol=TOL)
    qs = rng.standard_normal((8, 16), dtype=np.float32)
    (js, jsl, _), (ts, tsl, _) = (
        db.execute([db.session(P(tenant_id=t % 4, group_bits=1))
                    .search(qs[t], normalize=False).limit(5)
                    .using("sharded").plan() for t in range(8)])
        for db, P in ((jdb, JPrincipal), (tdb, Principal)))
    assert_topk_agree(ts, tsl, js, jsl)
    for name in STATS:
        assert getattr(tdb.stats, name) == getattr(jdb.stats, name), name
    line = lambda db: [ln for ln in db.explain().splitlines()
                       if "sharded:" in ln]
    assert line(tdb) == line(jdb) and len(line(tdb)) == 1


@pytest.mark.parametrize("placement", ["hash", "tenant"])
@pytest.mark.parametrize("n", [3, 5])
def test_padded_group_does_not_widen(placement, n):
    """A group of n rows is padded with zero rows to its pow2 bucket; a
    zero row scores 0 on every qualifying row, a tie at every place. The
    tie checks read only the real rows, so no shard is relaunched wider,
    and the real rows agree with the dense engine."""
    rng = np.random.default_rng(n)
    n_docs, dim = 200, 16
    db = RagDB(StoreConfig(capacity=512, dim=dim, metric="dot"),
               mesh=_mesh(4), placement=placement, device="cpu")
    db.ingest(_batch(rng.standard_normal((n_docs, dim), dtype=np.float32),
                     rng.integers(0, 6, n_docs), rng.integers(0, 4, n_docs),
                     rng.integers(1, 100, n_docs), np.ones(n_docs),
                     np.arange(n_docs)))
    qs = rng.standard_normal((n, dim), dtype=np.float32)
    plans = {e: [db.session(Principal(tenant_id=2, group_bits=1))
                 .search(q, normalize=False).limit(5).using(e).plan()
                 for q in qs] for e in ("sharded", "ref")}
    widens0, padded0 = sh_mod.TIE_WIDENS, db.stats.padded_rows
    s, sl, _ = db.execute(plans["sharded"], use_cache=False)
    assert db.stats.padded_rows - padded0 == bucket_rows(n) - n > 0
    assert sh_mod.TIE_WIDENS == widens0
    s_r, sl_r, _ = db.execute(plans["ref"], use_cache=False)
    assert_topk_agree(s, sl, s_r, sl_r)


@pytest.mark.parametrize("placement", ["hash", "tenant"])
def test_sharded_trace_matches_reference(placement):
    """With the tracer on, a sharded unit's ``device_sync`` span carries
    the shard count and the collective bytes, as the reference's does, and
    the span trees' names match."""
    from repro.obs import FlightRecorder as JFlightRecorder
    from repro.obs import Tracer as JTracer
    from repro_torch.obs import FlightRecorder, Tracer
    jdb, tdb, rng = _mesh_dbs(placement)
    q = rng.standard_normal((16,), dtype=np.float32)
    seen = []
    for db, P, tracer, recorder in (
            (jdb, JPrincipal, JTracer, JFlightRecorder),
            (tdb, Principal, Tracer, FlightRecorder)):
        rec = recorder()
        db.attach_tracer(tracer(enabled=True, recorder=rec))
        db.session(P(tenant_id=3, group_bits=1)).search(
            q, normalize=False).limit(5).using("sharded").run()
        (trace,) = rec.traces()
        (sync,) = [sp for sp in trace.spans if sp.name == "device_sync"]
        seen.append(([sp.name for sp in trace.spans],
                     {a: sync.ann[a] for a in ("shards", "collective_bytes",
                                               "rows_scanned")}))
    assert seen[1] == seen[0]
    assert seen[1][1]["shards"] == 1


def test_planner_picks_sharded_from_shard_min_rows():
    """The shard_min_rows rule: a mesh-built RagDB plans "sharded" on its
    own once the arena holds shard_min_rows rows (the reference's rule)."""
    from repro.api.planner import PlannerConfig as JPlannerConfig
    from repro_torch.api.planner import PlannerConfig
    jdb = JRagDB(JStoreConfig(capacity=64, dim=8), mesh=j_make_mesh(
        (1,), ("data",)), planner_cfg=JPlannerConfig(shard_min_rows=64))
    tdb = RagDB(StoreConfig(capacity=64, dim=8), mesh=_mesh(1),
                planner_cfg=PlannerConfig(shard_min_rows=64), device="cpu")
    for db, P in ((jdb, JPrincipal), (tdb, Principal)):
        p = db.session(P(tenant_id=1, group_bits=1)).search(
            np.ones(8, np.float32)).limit(3).plan()
        assert p.engine == "sharded"
        assert p.engine_reason == "mesh present and 64 rows >= 64"


def test_reference_counts_at_s8_subprocess():
    """The reference's collective bytes (from its compiled HLO), rows
    vectors and lists on an 8-way fake-device mesh, against the port's
    count and its logical 8-shard scan on the same store."""
    code = textwrap.dedent("""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.kernels.arena_scan.sharded import (
            make_sharded_arena_scan, sharded_collective_bytes)
        from repro.launch.mesh import make_mesh
        arrays = np.load(%r)
        st = {k: jnp.asarray(arrays[k]) for k in arrays.files
              if k not in ("q",)}
        q = jnp.asarray(arrays["q"])
        out = {"bytes": [], "rows": {}, "lists": {}}
        for S in (2, 8):
            mesh = make_mesh((S,), ("data",))
            for k in (1, 3, 10):
                fn = make_sharded_arena_scan(mesh, ("data",), 512, k)
                out["bytes"].append([S, k, int(sharded_collective_bytes(
                    fn, st, np.zeros((1, 8), np.float32),
                    np.zeros((4,), np.int32)))])
        mesh = make_mesh((8,), ("data",))
        fn = make_sharded_arena_scan(mesh, ("data",), 512, 6,
                                     placement_kind="tenant")
        for t in (-2, 3):
            s, sl, rows = fn(st, q, jnp.array([t, 10, -1, -1], jnp.int32))
            out["rows"][str(t)] = np.asarray(rows).tolist()
            out["lists"][str(t)] = [np.asarray(s).tolist(),
                                    np.asarray(sl).tolist()]
        print("RESULT" + json.dumps(out))
    """)
    store, _ = _placed_store(8, "tenant", 320, 8, seed=11, n_tenants=8,
                             cap=512)
    arrays = to_numpy(store)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"sharded_s8_{os.getpid()}.npz")
    q = np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32)
    np.savez(path, q=q, **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    try:
        proc = subprocess.run([sys.executable, "-c", code % path],
                              capture_output=True, text=True, env=env,
                              timeout=600)
    finally:
        os.remove(path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.split("RESULT", 1)[1])
    for S, k, cbytes in ref["bytes"]:
        assert sharded_collective_bytes(S, 1, k, 512 // S) == cbytes
    fn = make_sharded_arena_scan(_mesh(8), ("data",), 512, 6,
                                 placement_kind="tenant")
    for t in (-2, 3):
        s, sl, rows = fn(store, torch.from_numpy(q),
                         Predicate(tenant=t, min_ts=10))
        assert rows.tolist() == ref["rows"][str(t)]
        js, jsl = (np.asarray(a) for a in ref["lists"][str(t)])
        assert_topk_agree(s.numpy(), sl.numpy(), js.astype(np.float32),
                          jsl.astype(np.int32))


def test_sharded_without_mesh_rejected_at_plan_time():
    db = RagDB(StoreConfig(capacity=16, dim=4), device="cpu")
    b = (db.session(Principal(tenant_id=0, group_bits=1))
         .search(np.zeros(4, np.float32)).using("sharded").limit(2))
    with pytest.raises(ValueError, match="mesh"):
        b.plan()


def test_placement_slot_recycling_stays_in_region():
    """Delete returns a slot to the OWNING shard's free list and the next
    doc routed there reuses it; every live row sits in its tenant's
    region."""
    rng = np.random.default_rng(0)
    db = RagDB(StoreConfig(capacity=128, dim=8, metric="dot"), mesh=_mesh(4),
               placement="tenant", device="cpu")
    n = 40
    db.ingest(_batch(rng.standard_normal((n, 8), dtype=np.float32),
                     rng.integers(0, 6, n), np.zeros(n), np.full(n, 5),
                     np.ones(n), np.arange(n)))
    pl = db.log.placement
    tenant = db.log.snapshot()["tenant"].numpy()
    live = np.nonzero(tenant >= 0)[0]
    np.testing.assert_array_equal(pl.shards_of(tenant[live], 0),
                                  live // pl.rows_per_shard)
    assert all(pl.shard_of_doc(int(tenant[s]), 0) == pl.shard_of_slot(s)
               for s in live)
    victim = 7
    vslot = db.log.slot_of(victim)
    vtenant = int(tenant[vslot])
    db.delete([victim])
    db.ingest(_batch(rng.standard_normal((1, 8), dtype=np.float32),
                     [vtenant], [0], [50], [1], [9999]))
    assert db.log.slot_of(9999) == vslot


def test_sharded_region_full_is_loud():
    """A shard whose region fills raises instead of spilling into another
    shard's rows (spilling would silently break the affine audit)."""
    rng = np.random.default_rng(0)
    db = RagDB(StoreConfig(capacity=8, dim=4, metric="dot"), mesh=_mesh(1),
               placement="tenant", device="cpu")
    with pytest.raises(RuntimeError, match="region full"):
        db.ingest(_batch(rng.standard_normal((9, 4), dtype=np.float32),
                         rng.integers(0, 2, 9), np.zeros(9), np.ones(9),
                         np.ones(9), np.arange(9)))


def test_mesh_naming_another_device_raises():
    with pytest.raises(ValueError, match="arena regions on their own cards"):
        RagDB(StoreConfig(capacity=8, dim=4), device="cpu",
              mesh=make_mesh((2,), ("data",), devices=["cpu", "meta"]))
    fn = make_sharded_arena_scan(make_mesh((1,), ("data",), devices=["meta"]),
                                 "data", 8, 2)
    store, _ = _int_store(np.arange(8), n=8)
    with pytest.raises(ValueError, match="store's device"):
        fn(store, torch.zeros((1, 8)), Predicate())


def test_meshes():
    m = make_host_mesh(2, 4)
    assert dict(m.shape) == {"data": 2, "model": 4} and len(m.devices) == 8
    assert m.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh((2,), ("data",))
    with pytest.raises(ValueError, match="256 CUDA devices|CUDA devices"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("data",), devices=["cpu"] * 3)


# -- filtered_topk_sharded, decode_attention_sharded ------------------------

@pytest.mark.parametrize("S", [1, 4])
def test_filtered_topk_sharded_matches_reference(S):
    rng = np.random.default_rng(S)
    N, D, k = 512, 32, 7
    q = rng.standard_normal((3, D), dtype=np.float32)
    emb = rng.standard_normal((N, D), dtype=np.float32)
    meta = np.stack([rng.integers(-1, 5, N), rng.integers(0, 99, N),
                     rng.integers(0, 4, N), rng.integers(1, 8, N)],
                    1).astype(np.int32)
    pred = np.array([1, 20, 0b1010, 0b11], np.int32)
    s, sl = filtered_topk_sharded(_mesh(S), "data", torch.from_numpy(q),
                                  torch.from_numpy(emb),
                                  torch.from_numpy(meta),
                                  torch.from_numpy(pred), k)
    js, ji = filtered_topk_ref(jnp.asarray(q), jnp.asarray(emb),
                               jnp.asarray(meta), jnp.asarray(pred), k)
    assert_topk_agree(s.numpy(), sl.numpy(), np.asarray(js), np.asarray(ji))
    # the positional merge breaks ties as the unsharded scan: (score, slot)
    cols = [torch.from_numpy(meta[:, j].copy()) for j in range(4)]
    s1, sl1 = filtered_topk(torch.from_numpy(q), torch.from_numpy(emb),
                            cols[0], cols[1], cols[2], cols[3],
                            torch.from_numpy(pred), k)
    assert_topk_agree(s.numpy(), sl.numpy(), s1.numpy(), sl1.numpy())


@pytest.mark.parametrize("lengths", [(300, 900), (0, 1024), (1, 256)])
def test_decode_attention_sharded_matches_reference(lengths):
    """4 sequence shards of 256 positions; (300, 900) leaves a shard with
    no live row for sequence 0, (0, 1024) a sequence with none at all (the
    mean of V, as the reference), (1, 256) one live row."""
    rng = np.random.default_rng(sum(lengths))
    B, S, KV, G, hd = 2, 1024, 2, 4, 64
    q = rng.standard_normal((B, KV * G, hd), dtype=np.float32)
    kc = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    vc = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    ln = np.asarray(lengths, np.int32)
    out = decode_attention_sharded(make_mesh((2, 4), ("data", "model"),
                                             devices=["cpu"] * 8),
                                   "model", torch.from_numpy(q),
                                   torch.from_numpy(kc), torch.from_numpy(vc),
                                   torch.from_numpy(ln), n_kv=KV)
    ref = np.asarray(decode_attention_ref(
        jnp.asarray(q.reshape(B, KV, G, hd)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ln))).reshape(B, KV * G, hd)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    one = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(ln), KV)
    np.testing.assert_allclose(out.numpy(), one.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_decode_cache_layouts():
    """The decode kernel reads a contiguous cache, or a slice along S of
    one in place (its batch stride in the tensor map); other layouts
    raise before any launch."""
    cache = torch.zeros((3, 32, 2, 64))
    shape = lambda t: tuple(t.shape)
    cpu = torch.device("cpu")
    rows = dec_mod._cache_rows
    assert rows("k", cache, torch.float32, shape(cache), cpu) == 32
    part = cache[:, 8:16]
    assert rows("k", part, torch.float32, shape(part), cpu) == 32
    assert rows("k", cache[:1, 8:16], torch.float32, (1, 8, 2, 64), cpu) == 8
    swapped = cache.transpose(1, 2)
    with pytest.raises(ValueError, match="slice along S"):
        rows("k", swapped, torch.float32, shape(swapped), cpu)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        rows("k", part, torch.bfloat16, shape(part), cpu)
