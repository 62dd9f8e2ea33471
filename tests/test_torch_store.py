"""Parity of the port's store and commit log with the JAX reference.

The same write sequences (ingest, update, delete, recycled slots, tenant
placement) run through both `TransactionLog`s; every column, `commit_ts`,
`n_live` and the slot maps must agree (embeddings within 1e-6 after the
two frameworks' normalisations, everything else exactly). The recovery
grid of tests/test_faults.py (3 ops x 6 crash points) is replayed on the
port, and `from_numpy` / `to_numpy` round-trip a reference snapshot.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.transactions import TransactionLog as JLog
from repro_torch.core.store import (DocBatch, ShardPlacement, StoreConfig,
                                    empty, from_numpy, live_mask, to_numpy)
from repro_torch.core.transactions import CRASH_POINTS, TransactionLog
from repro_torch.serving.faults import CrashError, FaultPlan, FaultRule

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

ALL_BITS = 0xFFFFFFFF


def np_batch(rng, ids, dim, n_tenants=3):
    n = len(ids)
    return dict(
        emb=rng.standard_normal((n, dim)).astype(np.float32),
        tenant=rng.integers(0, n_tenants, n, dtype=np.int32),
        category=rng.integers(0, 32, n, dtype=np.int32),
        updated_at=rng.integers(0, 1000, n, dtype=np.int32),
        acl=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        doc_id=np.asarray(ids, np.int32))


def j_batch(b):
    return jstore.DocBatch(**{k: jax.numpy.asarray(v) for k, v in b.items()})


def t_batch(b):
    return DocBatch(**{k: torch.from_numpy(v.view(np.int32)
                                           if v.dtype == np.uint32 else v)
                       for k, v in b.items()})


def assert_logs_equal(tlog, jlog):
    got = to_numpy(tlog.snapshot())
    ref = jax.device_get(jlog.snapshot())
    assert set(got) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        assert got[k].dtype == want.dtype, k
        if k == "emb":
            np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert tlog.commit_count == jlog.commit_count
    assert tlog._slot_of_doc == jlog._slot_of_doc
    assert tlog._free_slots == jlog._free_slots
    assert tlog._cursor == jlog._cursor


@pytest.mark.parametrize("placement", [None, "tenant", "hash"])
def test_write_sequence_matches_reference(placement):
    rng = np.random.default_rng(5)
    cfg = StoreConfig(capacity=64, dim=8)
    jcfg = jstore.StoreConfig(capacity=64, dim=8)
    plc = (None if placement is None
           else ShardPlacement(n_shards=4, capacity=64, kind=placement))
    jplc = (None if placement is None
            else jstore.ShardPlacement(n_shards=4, capacity=64, kind=placement))
    tlog = TransactionLog(cfg, placement=plc, device="cpu")
    jlog = JLog(jcfg, jstore.empty(jcfg), placement=jplc)
    steps = [("ingest", list(range(10))), ("update", [2, 5, 9]),
             ("delete", [1, 3, 3, 8]), ("ingest", [100, 101, 102, 103, 104]),
             ("delete", [100]), ("update", [104]), ("ingest", [200, 201])]
    for op, ids in steps:
        if op == "ingest":
            b = np_batch(rng, ids, 8)
            tlog.ingest(t_batch(b))
            jlog.ingest(j_batch(b))
        elif op == "update":
            emb = rng.standard_normal((len(ids), 8)).astype(np.float32)
            ts = rng.integers(0, 2000, len(ids)).tolist()
            tlog.update(ids, torch.from_numpy(emb), ts)
            jlog.update(ids, jax.numpy.asarray(emb), ts)
        else:
            assert tlog.delete(ids) == jlog.delete(ids)
        assert_logs_equal(tlog, jlog)
    if plc is not None:
        assert tlog._shard_free == jlog._shard_free
        assert tlog._shard_cursor == jlog._shard_cursor
    np.testing.assert_array_equal(live_mask(tlog.snapshot()).numpy(),
                                  np.asarray(jstore.live_mask(jlog.snapshot())))


def test_snapshots_are_immutable_across_writes():
    rng = np.random.default_rng(1)
    log = TransactionLog(StoreConfig(capacity=16, dim=4), device="cpu")
    log.ingest(t_batch(np_batch(rng, range(6), 4)))
    old = log.snapshot()
    before = {k: v.clone() for k, v in old.items()}
    log.update([2], torch.ones((1, 4)), [7])
    log.delete([3])
    log.ingest(t_batch(np_batch(rng, [50], 4)))
    for k, v in before.items():
        assert torch.equal(old[k], v), f"{k} changed under a reader"
    assert log.inconsistency_window_s == 0.0


def test_from_numpy_round_trips_a_reference_snapshot():
    rng = np.random.default_rng(2)
    jcfg = jstore.StoreConfig(capacity=32, dim=6)
    jlog = JLog(jcfg, jstore.empty(jcfg))
    jlog.ingest(j_batch(np_batch(rng, range(20), 6)))
    jlog.delete([4, 7])
    snap = jax.device_get(jlog.snapshot())
    store = from_numpy(snap, device="cpu")
    assert store["acl"].dtype == torch.int32
    back = to_numpy(store)
    for k in snap:
        np.testing.assert_array_equal(back[k], np.asarray(snap[k]))
        assert back[k].dtype == np.asarray(snap[k]).dtype
    fresh = to_numpy(empty(StoreConfig(capacity=32, dim=6), device="cpu"))
    for k, v in jax.device_get(jstore.empty(jcfg)).items():
        np.testing.assert_array_equal(fresh[k], np.asarray(v))


# -- the recovery grid of tests/test_faults.py, replayed on the port --------

def _crash_log() -> TransactionLog:
    """A hot-tier log with a populated free list, so ingest recycles."""
    rng = np.random.default_rng(48)
    log = TransactionLog(StoreConfig(capacity=96, dim=8), device="cpu")
    log.ingest(t_batch(np_batch(rng, range(48), 8, n_tenants=2)))
    log.delete([40, 41, 42])
    return log


def _apply_op(log, op):
    if op == "ingest":
        b = np_batch(np.random.default_rng(11), [100, 101, 102, 103], 8)
        b.update(tenant=np.zeros(4, np.int32), category=np.zeros(4, np.int32),
                 updated_at=np.full(4, 5, np.int32),
                 acl=np.full(4, ALL_BITS, np.uint32))
        log.ingest(t_batch(b))
    elif op == "update":
        log.update([1, 2], torch.full((2, 8), 0.5), [7, 7])
    else:
        log.delete([3, 4])


def _fingerprint(log) -> dict:
    fp = {f"store.{k}": v for k, v in to_numpy(log.snapshot()).items()}
    fp["cursor"] = log._cursor
    fp["slot_of_doc"] = dict(log._slot_of_doc)
    fp["free_slots"] = tuple(log._free_slots)
    fp["commit_count"] = log.commit_count
    return fp


def _fp_diff(a: dict, b: dict) -> list[str]:
    return [k for k in a
            if not (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                    else a[k] == b[k])]


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("op", ["ingest", "update", "delete"])
def test_crash_recovery_grid_bit_identical_never_torn(op, point):
    ref = _crash_log()
    fp_pre = _fingerprint(ref)
    _apply_op(ref, op)
    fp_post = _fingerprint(ref)
    log = _crash_log()
    assert not _fp_diff(_fingerprint(log), fp_pre), "twin construction drifted"
    log.faults = FaultPlan(0, {f"txn.{op}.{point}": FaultRule(at=(0,))})
    with pytest.raises(CrashError):
        _apply_op(log, op)
    outcome = log.recover()
    fp_rec = _fingerprint(log)
    assert fp_rec["commit_count"] in (fp_pre["commit_count"],
                                      fp_post["commit_count"])
    diff_pre, diff_post = _fp_diff(fp_rec, fp_pre), _fp_diff(fp_rec, fp_post)
    assert not diff_pre or not diff_post, (
        f"TORN STATE after crash at {op}.{point}: differs from pre in "
        f"{diff_pre} and from post in {diff_post}")
    if point in ("prepare", "intent"):
        assert outcome in ("noop", "rolled-back") and not diff_pre
    else:
        assert outcome == "rolled-forward" and not diff_post
    log.faults = None
    assert log.recover() == "noop"
