"""Arena regions on their own devices: a `RagDB(mesh=)` whose shards sit
on distinct devices, against the reference's.

The port holds such an arena in one allocation a device, writes and scans
each region on its own device and merges the lists on the controller.
Here the devices are ``torch.device("cpu", i)``: distinct mesh entries
whose tensors all land on the one CPU, so the code of several cards runs
with several allocations. S = 4 regions of 256 rows, D = 16:

  * `device_groups` (contiguity error included) and the controller-device
    error; a mesh of one device keeps the single arena;
  * ingest / update / delete under hash and tenant placement against the
    reference's `TransactionLog` with the same `ShardPlacement`, column for
    column (metric "dot": no normalisation, so exactly); allocations a
    tenant-placed commit does not touch stay the same tensors, and an older
    snapshot keeps its values;
  * a `FaultPlan` crash at every publish point, then `recover`, against the
    one-device db after the same operations;
  * the sharded and exact engines against the reference's `RagDB(mesh=)`
    over 4 fake XLA host devices (one subprocess; several regions a device
    against the one-device db) and its
    `unified_query_ref`: scores within 1e-5 (each region's product rounds
    apart from the whole arena's on the CPU), slots equal but inside tie
    runs, no leaked slot, `ExecStats` equal; the tie widening on several
    allocations;
  * `on_device`, which every ctypes launch enters: the tensors' card
    current for the launch and the thread's card restored (stand-ins for
    the CUDA calls);
  * what raises: a scan given a store laid out for another mesh.

Hybrid, IVF and tiers over regions on their own devices, and the sharded
kernel entry points over pieces on distinct devices, are held to the
reference in ``test_torch_regions_hybrid.py``.
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

from repro.core.query import Predicate as JPredicate
from repro.core.query import unified_query_ref as j_unified_query_ref
from repro.core.store import DocBatch as JDocBatch
from repro.core.store import ShardPlacement as JShardPlacement
from repro.core.store import StoreConfig as JStoreConfig
from repro.core.store import empty as j_empty
from repro.core.transactions import TransactionLog as JTransactionLog
from repro_torch.api import RagDB
from repro_torch.core.query import Predicate, predicate_mask
from repro_torch.core.store import (ALLOCS, COLUMNS, DocBatch, StoreConfig,
                                    allocations, from_numpy, to_numpy)
from repro_torch.core.tenancy import Principal
from repro_torch.core.transactions import CRASH_POINTS
from repro_torch.kernels import _attention
from repro_torch.kernels.arena_scan import sharded as sh_mod
from repro_torch.kernels.arena_scan.sharded import make_sharded_arena_scan
from repro_torch.launch.mesh import device_groups, make_mesh
from repro_torch.serving.faults import CrashError, FaultPlan, FaultRule
from tests.test_torch_arena_scan import assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, RPS, DIM, K = 4, 256, 16, 5
CAP = S * RPS
CPUS = [torch.device("cpu", i) for i in range(S)]
STATS = ("device_calls", "queries", "hot_queries", "rows_scanned",
         "padded_rows", "fused_groups", "fused_scans", "shards_used",
         "collective_bytes", "shard_rows_scanned")


def _mesh(devices=CPUS):
    return make_mesh((S,), ("data",), devices=devices)


def _db(placement, devices=CPUS, **kw):
    """A RagDB over the mesh of ``devices``, its controller the first."""
    return RagDB(StoreConfig(capacity=CAP, dim=DIM, metric="dot"),
                 mesh=_mesh(devices), placement=placement,
                 device=devices[0], **kw)


def _docs(seed, n, first=0, n_tenants=6):
    rng = np.random.default_rng(seed)
    return dict(emb=rng.standard_normal((n, DIM), dtype=np.float32),
                tenant=rng.integers(0, n_tenants, n).astype(np.int32),
                category=rng.integers(0, 4, n).astype(np.int32),
                updated_at=rng.integers(1, 100, n).astype(np.int32),
                acl=rng.integers(1, 4, n).astype(np.int32),
                doc_id=np.arange(first, first + n, dtype=np.int32))


def _batch(d):
    return DocBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in d.items()})


def _j_batch(d):
    return JDocBatch(**{k: jnp.asarray(v.astype(np.uint32) if k == "acl"
                                       else v) for k, v in d.items()})


def _writes(seed=0):
    """The write sequence every test below replays: (op, args) pairs."""
    rng = np.random.default_rng(seed + 1)
    base = _docs(seed, 500)
    gone = rng.choice(500, 40, replace=False).tolist()
    upd = rng.choice([d for d in range(500) if d not in gone], 30,
                     replace=False).tolist()
    return [("ingest", base),
            ("update", (upd, rng.standard_normal((30, DIM),
                                                 dtype=np.float32),
                        rng.integers(100, 200, 30).astype(np.int32))),
            ("delete", gone),
            ("ingest", _docs(seed + 2, 60, first=1000))]


def _apply(db_or_log, op, arg, jax_side=False):
    if op == "ingest":
        db_or_log.ingest(_j_batch(arg) if jax_side else _batch(arg))
    elif op == "update":
        ids, emb, ts = arg
        if jax_side:
            db_or_log.update(ids, jnp.asarray(emb), jnp.asarray(ts))
        else:
            db_or_log.update(ids, torch.from_numpy(emb),
                             torch.from_numpy(ts))
    else:
        db_or_log.delete(arg)


def _assert_same_store(a, b):
    a, b = to_numpy(a), to_numpy(b)
    for c in COLUMNS:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


# -- layout ---------------------------------------------------------------

def test_device_groups_and_contiguity():
    assert device_groups(_mesh()) == tuple((d, (i,))
                                           for i, d in enumerate(CPUS))
    two = [CPUS[0], CPUS[0], CPUS[1], CPUS[1]]
    assert device_groups(_mesh(two)) == ((CPUS[0], (0, 1)),
                                         (CPUS[1], (2, 3)))
    assert device_groups(_mesh(["cpu"] * S)) == ((torch.device("cpu"),
                                                  (0, 1, 2, 3)),)
    # a (data, model) mesh sharded over "data": shard s on (s, 0)
    grid = make_mesh((2, 2), ("data", "model"), devices=CPUS)
    assert device_groups(grid, "data") == ((CPUS[0], (0,)), (CPUS[2], (1,)))
    with pytest.raises(ValueError, match="contiguous"):
        device_groups(_mesh([CPUS[0], CPUS[1], CPUS[0], CPUS[1]]))
    with pytest.raises(ValueError, match="contiguous"):
        _db("hash", [CPUS[0], CPUS[1], CPUS[0], CPUS[1]])


def test_controller_must_be_a_mesh_device():
    with pytest.raises(ValueError, match="controller device"):
        RagDB(StoreConfig(capacity=CAP, dim=DIM), mesh=_mesh(),
              device="cpu")
    with pytest.raises(ValueError, match="controller device"):
        RagDB(StoreConfig(capacity=CAP, dim=DIM), mesh=_mesh([CPUS[0], CPUS[0], CPUS[1], CPUS[1]]),
              device=CPUS[3])


@pytest.mark.parametrize("devices", [["cpu"] * S, [CPUS[2]] * S])
def test_one_device_mesh_keeps_the_single_arena(devices):
    db = _db("hash", devices)
    snap = db.log.snapshot()
    assert ALLOCS not in snap and set(snap) == set(COLUMNS)
    assert snap["emb"].shape == (CAP, DIM) and allocations(snap) == (snap,)


def test_several_devices_hold_one_allocation_each():
    db = _db("tenant", [CPUS[0], CPUS[0], CPUS[1], CPUS[3]])
    snap = db.log.snapshot()
    assert [p["emb"].shape[0] for p in snap[ALLOCS]] == [2 * RPS, RPS, RPS]
    assert set(snap) == {ALLOCS, "commit_ts", "n_live"}
    assert all(set(p) == set(COLUMNS[:7]) for p in snap[ALLOCS])


# -- writes ---------------------------------------------------------------

@pytest.mark.parametrize("placement", ["hash", "tenant"])
def test_writes_match_reference_log(placement):
    jcfg = JStoreConfig(capacity=CAP, dim=DIM, metric="dot")
    jlog = JTransactionLog(jcfg, j_empty(jcfg),
                           placement=JShardPlacement(S, CAP, placement))
    db = _db(placement)
    for op, arg in _writes():
        _apply(jlog, op, arg, jax_side=True)
        _apply(db, op, arg)
        ref = {k: np.asarray(v) for k, v in jlog.snapshot().items()}
        got = to_numpy(db.log.snapshot())
        for c in COLUMNS:
            np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    assert len(db.log.snapshot()[ALLOCS]) == S
    for d in range(500):
        if jlog.has_doc(d):
            assert db.log.slot_of(d) == jlog.slot_of(d)


def test_tenant_commit_shares_untouched_allocations():
    db = _db("tenant")
    _apply(db, "ingest", _docs(0, 200))
    before = db.log.snapshot()
    old = {c: before[ALLOCS][1][c].clone() for c in COLUMNS[:7]}
    docs = _docs(3, 20, first=5000)
    docs["tenant"][:] = 5                   # tenant 5 lives on shard 1
    _apply(db, "ingest", docs)
    after = db.log.snapshot()
    for i in (0, 2, 3):
        assert all(after[ALLOCS][i][c] is before[ALLOCS][i][c]
                   for c in COLUMNS[:7]), f"allocation {i} was rebuilt"
    assert after[ALLOCS][1]["emb"] is not before[ALLOCS][1]["emb"]
    # the older snapshot keeps an unchanging view (no write in place)
    for c in COLUMNS[:7]:
        assert torch.equal(before[ALLOCS][1][c], old[c]), c
    assert int(after["n_live"]) == int(before["n_live"]) + 20
    assert int(after["commit_ts"]) == int(before["commit_ts"]) + 1


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("op", ["ingest", "update", "delete"])
def test_crash_recovery_matches_one_device(op, point):
    """A crash at every publish point of each write, then recover: the
    db over four devices equals the one-device db with the write undone
    (prepare, intent) or done (every later point), slots and counters
    included."""
    writes = _writes()
    last = {"ingest": writes[3], "update": writes[1],
            "delete": writes[2]}[op]
    pre = [w for w in writes if w is not last]
    multi, pre_db, post_db = (_db("hash"), _db("hash", ["cpu"] * S),
                              _db("hash", ["cpu"] * S))
    for db in (multi, pre_db, post_db):
        for w in pre:
            _apply(db, *w)
    _apply(post_db, *last)
    multi.log.faults = FaultPlan(0, {f"txn.{op}.{point}":
                                     FaultRule(at=(0,))})
    with pytest.raises(CrashError):
        _apply(multi, *last)
    outcome = multi.log.recover()
    want = pre_db if point in ("prepare", "intent") else post_db
    assert outcome == ("rolled-forward" if want is post_db
                       else ("noop", "rolled-back")[point == "intent"])
    _assert_same_store(multi.log.snapshot(), want.log.snapshot())
    assert multi.log.commit_count == want.log.commit_count
    assert multi.log._slot_of_doc == want.log._slot_of_doc
    assert multi.log._shard_free == want.log._shard_free
    assert multi.log._shard_cursor == want.log._shard_cursor
    multi.log.faults = None
    assert multi.log.recover() == "noop"


# -- the engines ----------------------------------------------------------

REF_CODE = textwrap.dedent("""
    import json, sys, jax, jax.numpy as jnp, numpy as np
    from repro.api.ragdb import RagDB
    from repro.core.store import DocBatch, StoreConfig
    from repro.core.tenancy import Principal
    from repro.launch.mesh import make_mesh
    import repro.kernels.arena_scan.sharded as sharded
    args = json.loads(sys.stdin.read())
    # the same shard_map program, compiled once a shape: called eagerly it
    # dispatches op by op, some 10 s a call over 4 fake host devices
    make = sharded.make_sharded_arena_scan
    sharded.make_sharded_arena_scan = lambda *a, **kw: jax.jit(make(*a, **kw))
    assert len(jax.devices()) == 4
    out = {}
    for placement in ("hash", "tenant"):
        db = RagDB(StoreConfig(capacity=args["cap"], dim=args["dim"],
                               metric="dot"),
                   mesh=make_mesh((4,), ("data",)), shard_axes=("data",),
                   placement=placement)
        for op, arg in args["writes"]:
            if op == "ingest":
                db.ingest(DocBatch(**{k: jnp.asarray(np.asarray(
                    v, np.uint32 if k == "acl" else
                    np.float32 if k == "emb" else np.int32))
                    for k, v in arg.items()}))
            elif op == "update":
                db.update(arg[0], jnp.asarray(np.asarray(arg[1], np.float32)),
                          jnp.asarray(np.asarray(arg[2], np.int32)))
            else:
                db.delete(arg)
        q = np.asarray(args["q"], np.float32)
        runs = []
        for engine in ("sharded", "ref"):
            plans = [db.session(Principal(tenant_id=t, group_bits=b))
                     .search(q[r], normalize=False).newer_than(ts)
                     .limit(args["k"]).using(engine).plan()
                     for r, (t, b, ts) in enumerate(args["rows"])]
            s, sl, _ = db.execute(plans, use_cache=False)
            runs.append([np.asarray(s).tolist(), np.asarray(sl).tolist()])
        admin = (db.admin_session().search(q[0], normalize=False)
                 .limit(args["k"]).using("sharded").run())
        runs.append([admin.scores.tolist(), admin.slots.tolist()])
        out[placement] = {"runs": runs, "stats": {
            n: getattr(db.stats, n) for n in args["stats"]}}
    print("RESULT" + json.dumps(out))
""")


def _rows(n=8):
    """(tenant, group bits, min_ts) of each query row: 4 tenant groups."""
    return [(t % 4, (1, 3, 2, 1)[t % 4], (0, 20, 50, 10)[t % 4])
            for t in range(n)]


def _reference_runs(writes, q):
    def js(v):
        return v.tolist() if isinstance(v, np.ndarray) else v
    payload = json.dumps({
        "cap": CAP, "dim": DIM, "k": K, "q": q.tolist(), "rows": _rows(),
        "stats": STATS,
        "writes": [(op, {k: js(v) for k, v in arg.items()}
                    if op == "ingest" else [js(a) for a in arg]
                    if op == "update" else arg)
                   for op, arg in writes]})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF_CODE], input=payload,
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


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


def test_engines_match_reference_mesh_subprocess():
    """The sharded and exact ("ref") engines of a db over four devices,
    hash then tenant placement, after the write sequence: the lists
    against the reference's RagDB(mesh=) over 4 XLA host devices and its
    dense oracle, no leaked slot, and `ExecStats` equal."""
    writes = _writes(seed=4)
    q = np.random.default_rng(9).standard_normal((8, DIM), dtype=np.float32)
    ref = _reference_runs(writes, q)
    for placement in ("hash", "tenant"):
        db = _db(placement)
        for w in writes:
            _apply(db, *w)
        snap = db.log.snapshot()
        jstore = {k: jnp.asarray(v) for k, v in to_numpy(snap).items()}
        got = []
        for engine in ("sharded", "ref"):
            plans = [db.session(Principal(tenant_id=t, group_bits=b))
                     .search(q[r], normalize=False).newer_than(ts)
                     .limit(K).using(engine).plan()
                     for r, (t, b, ts) in enumerate(_rows())]
            assert {p.engine for p in plans} == {engine}
            s, sl, _ = db.execute(plans, use_cache=False)
            got.append((s, sl))
            assert _leaks(snap, _rows(), sl) == 0, engine
            for r, (t, b, ts) in enumerate(_rows()):
                js, ji = j_unified_query_ref(
                    jstore, jnp.asarray(q[r:r + 1]),
                    JPredicate(tenant=t, min_ts=ts, acl_bits=b).as_array(),
                    K)
                assert_topk_agree(s[r:r + 1], sl[r:r + 1], np.asarray(js),
                                  np.asarray(ji))
        admin = (db.admin_session().search(q[0], normalize=False).limit(K)
                 .using("sharded").run())
        got.append((admin.scores, admin.slots))
        for (s, sl), (rs, rsl) in zip(got, ref[placement]["runs"]):
            assert_topk_agree(s, sl, np.asarray(rs, np.float32),
                              np.asarray(rsl, np.int32))
        for name in STATS:
            assert getattr(db.stats, name) == ref[placement]["stats"][name], \
                (placement, name)
        # the sharded engine's exact (score, doc_id) order equals the
        # exact engine's (score, slot) order but inside tie runs
        assert_topk_agree(*got[0], *got[1])


@pytest.mark.parametrize("layout", [(0, 0, 1, 1), (0, 1, 1, 1)])
@pytest.mark.parametrize("placement", ["hash", "tenant"])
def test_several_shards_a_device_match_one_device(placement, layout):
    """Devices of several regions each (allocations of 2 + 2 and 1 + 3
    regions): the sharded engine's lists equal the one-device db's bit for
    bit (each region scans the same view), the exact engine's within the
    contract, and the `ExecStats` alike."""
    writes = _writes(seed=6)
    q = np.random.default_rng(10).standard_normal((8, DIM), dtype=np.float32)
    runs = []
    for devices in ([CPUS[i] for i in layout], ["cpu"] * S):
        db = _db(placement, devices)
        for w in writes:
            _apply(db, *w)
        got = [db.execute([db.session(Principal(tenant_id=t, group_bits=b))
                           .search(q[r], normalize=False).newer_than(ts)
                           .limit(K).using(engine).plan()
                           for r, (t, b, ts) in enumerate(_rows())],
                          use_cache=False)[:2]
               for engine in ("sharded", "ref")]
        runs.append((got, [getattr(db.stats, n) for n in STATS]))
    (two, two_stats), (one, one_stats) = runs
    np.testing.assert_array_equal(two[0][0], one[0][0])
    np.testing.assert_array_equal(two[0][1], one[0][1])
    assert_topk_agree(*two[1], *one[1])
    assert two_stats == one_stats


def test_tie_widening_on_its_own_region():
    """64 rows share one integer embedding (exact scores in any order)
    and spread over the four allocations (hash placement): every region's
    k + 1 list ends inside the tie run, so each shard is relaunched wider
    on its own device, and the run resolves to the smallest doc ids, as
    on one device."""
    docs = _docs(7, 400)
    rng = np.random.default_rng(8)
    docs["emb"] = rng.integers(-2, 3, (400, DIM)).astype(np.float32)
    docs["emb"][:64] = 3.0
    docs["tenant"][:] = 1
    docs["acl"][:] = 1
    q = np.ones(DIM, np.float32)
    lists, widens = [], []
    for devices in (CPUS, ["cpu"] * S):
        db = _db("hash", devices)
        _apply(db, "ingest", docs)
        w0 = sh_mod.TIE_WIDENS
        res = (db.session(Principal(tenant_id=1, group_bits=1))
               .search(q, normalize=False).limit(K).using("sharded").run())
        widens.append(sh_mod.TIE_WIDENS - w0)
        doc_of = to_numpy(db.log.snapshot())["doc_id"]
        lists.append((res.scores, doc_of[res.slots[0]]))
    assert widens[0] >= S and widens[0] == widens[1]
    np.testing.assert_array_equal(lists[0][1], np.arange(K))
    np.testing.assert_array_equal(lists[0][0], lists[1][0])
    np.testing.assert_array_equal(lists[0][1], lists[1][1])


# -- the launch device ----------------------------------------------------

def test_launches_enter_the_tensors_device(monkeypatch):
    """`on_device` (around every ctypes launch) makes the tensors' card
    current for the launch, reads that card's stream there, and restores
    the thread's card after it, also when the launch raises; on the
    current card it switches nothing. The CUDA calls are stood in for:
    this rig has no card."""
    state = {"current": 0, "sets": []}
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["current"])

    def set_device(i):
        state["sets"].append(i)
        state["current"] = i
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(_attention, "stream_of",
                        lambda dev: ("stream", dev.index, state["current"]))
    with _attention.on_device(torch.device("cuda", 2)) as stream:
        assert state["current"] == 2 and stream == ("stream", 2, 2)
    assert state["current"] == 0 and state["sets"] == [2, 0]
    with pytest.raises(RuntimeError):
        with _attention.on_device(torch.device("cuda", 3)):
            raise RuntimeError("launch failed")
    assert state["current"] == 0 and state["sets"] == [2, 0, 3, 0]
    with _attention.on_device(torch.device("cuda", 0)) as stream:
        assert stream == ("stream", 0, 0)
    assert state["sets"] == [2, 0, 3, 0]


# -- what raises ----------------------------------------------------------

def test_scan_refuses_a_store_of_another_layout():
    single = _db("hash", ["cpu"] * S)
    _apply(single, "ingest", _docs(0, 50))
    fn = make_sharded_arena_scan(_mesh(), "data", CAP, K)
    with pytest.raises(ValueError, match="store's device"):
        fn(single.log.snapshot(), torch.zeros((1, DIM)), Predicate())
    multi = _db("hash")
    fn1 = make_sharded_arena_scan(_mesh(["cpu"] * S), "data", CAP, K)
    with pytest.raises(ValueError, match="store's device"):
        fn1(multi.log.snapshot(), torch.zeros((1, DIM)), Predicate())
