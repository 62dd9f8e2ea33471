"""Parity of the port's front door with the reference's single-tier RagDB.

The same builder chains run through both `RagDB`s over the same corpus:
group and fuse keys, `ExecStats` counters and `explain()` text must be
identical, slots equal (ties at the k-th place aside) with scores within
1e-5, and the cache must hit on a repeat and miss after a write. The
misuse probes of the verify skill behave alike. Three rules of the port are
checked too: no `device` means the card (and raises without one), the
kernel wrapper never hands a CUDA tensor to the plain version, and the
package imports neither jax nor repro.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import RagDB as JRagDB
from repro.core.store import StoreConfig as JStoreConfig
from repro.data.corpus import CorpusConfig as JCorpusConfig
from repro.data.corpus import make_corpus as j_make_corpus
from repro_torch.api import RagDB
from repro_torch.core.store import StoreConfig
from repro_torch.core.tenancy import Principal
from repro_torch.data.corpus import DAY_S, CorpusConfig, make_corpus
from repro_torch.kernels.arena_scan import kernel as kernel_mod
from tests.test_torch_arena_scan import assert_topk_agree

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

CAP, DIM = 1024, 16
CCFG = dict(n_docs=700, dim=DIM, n_tenants=4, n_categories=5, seed=1)

COUNTERS = ("device_calls", "queries", "hot_queries", "rows_scanned",
            "fused_groups", "fused_scans", "padded_groups", "padded_rows")


def _dbs():
    jdb = JRagDB(JStoreConfig(capacity=CAP, dim=DIM))
    jdb.ingest(j_make_corpus(JCorpusConfig(**CCFG)))
    tdb = RagDB(StoreConfig(capacity=CAP, dim=DIM), device="cpu")
    tdb.ingest(make_corpus(CorpusConfig(**CCFG), device="cpu"))
    return jdb, tdb


def _chains(db, qs, k=6, engine=None):
    """One builder chain per query row: four principals, recency and
    category clauses."""
    now = CorpusConfig(**CCFG).now_ts
    spec = [(Principal(0, 0b11), 90, [0, 1]), (Principal(1, 0xFF), 150, None),
            (Principal(2, 0b100), 30, [2, 3, 4]), (Principal(3, 0xFF), 0, [4])]
    out = []
    for r, q in enumerate(qs):
        p, days, cats = spec[r % len(spec)]
        b = db.session(p).search(q).limit(k)
        if days:
            b = b.newer_than(now - days * DAY_S)
        if cats is not None:
            b = b.in_categories(cats)
        if engine is not None:
            b = b.using(engine)
        out.append(b)
    return out


def _key(key):
    pred, *rest = key
    return (dataclasses.astuple(pred), *rest)


@pytest.mark.parametrize("rows", [1, 5, 12])
def test_front_door_matches_reference(rows):
    jdb, tdb = _dbs()
    qs = np.random.default_rng(rows).standard_normal((rows, DIM)).astype(
        np.float32)
    jplans = [b.plan() for b in _chains(jdb, qs)]
    tplans = [b.plan() for b in _chains(tdb, qs)]
    for jp, tp in zip(jplans, tplans):
        assert _key(tp.group_key) == _key(jp.group_key)
        assert tp.fuse_key == jp.fuse_key
        assert tp.explain() == jp.explain()
        assert tp.engine == "ref"
    js, jsl, jt = jdb.execute(jplans)
    ts, tsl, tt = tdb.execute(tplans)
    assert_topk_agree(ts, tsl, js, jsl)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    for c in COUNTERS:
        assert getattr(tdb.stats, c) == getattr(jdb.stats, c), c
    # the kernel engine (its plain version on the CPU) answers alike
    tplans_k = [b.plan() for b in _chains(tdb, qs, engine="cuda")]
    assert all(p.engine == "cuda" for p in tplans_k)
    ks, ksl, _ = tdb.execute(tplans_k)
    assert_topk_agree(ks, ksl, js, jsl)


def test_cache_hit_then_miss_after_write():
    jdb, tdb = _dbs()
    q = np.random.default_rng(0).standard_normal(DIM).astype(np.float32)
    outs = []
    for db in (jdb, tdb):
        sess = db.session(Principal(1, 0xFF))
        first = sess.search(q).limit(5).run()
        again = sess.search(q).limit(5).run()
        top_doc = int(np.asarray(db.log.snapshot()["doc_id"])[first.slots[0, 0]])
        db.delete([top_doc])
        after = sess.search(q).limit(5).run()
        assert (first.cached, again.cached, after.cached) == (False, True, False)
        assert first.slots[0, 0] not in after.slots[0].tolist()
        outs.append((after.scores, after.slots))
    assert_topk_agree(outs[1][0], outs[1][1], outs[0][0], outs[0][1])
    assert tdb.explain().splitlines()[1:4] == jdb.explain().splitlines()[1:4]


def test_update_is_visible_and_matches_reference():
    jdb, tdb = _dbs()
    q = np.random.default_rng(4).standard_normal(DIM).astype(np.float32)
    target = 17
    res = []
    for db in (jdb, tdb):
        db.update([target], q[None, :], [CorpusConfig(**CCFG).now_ts])
        r = db.admin_session().search(q).limit(3).run()
        assert int(np.asarray(db.log.snapshot()["doc_id"])[r.slots[0, 0]]) == target
        res.append(r)
    assert_topk_agree(res[1].scores, res[1].slots, res[0].scores,
                      res[0].slots)


@pytest.mark.parametrize("probe", ["bad_category", "bogus_engine",
                                   "limit_over_arena", "future_newer_than",
                                   "empty_db"])
def test_misuse_probes_match_reference(probe):
    jdb, tdb = _dbs()
    if probe == "empty_db":
        jdb = JRagDB(JStoreConfig(capacity=64, dim=DIM))
        tdb = RagDB(StoreConfig(capacity=64, dim=DIM), device="cpu")
    q = np.ones(DIM, np.float32)
    now = CorpusConfig(**CCFG).now_ts
    outs = []
    for db in (jdb, tdb):
        b = db.session(Principal(2, 0xFF)).search(q)
        if probe == "bad_category":
            with pytest.raises(ValueError):
                b.in_categories([33])
            continue
        if probe == "bogus_engine":
            with pytest.raises(ValueError):
                b.using("bogus").run()
            continue
        if probe == "limit_over_arena":
            r = b.limit(CAP + 50).run()
        elif probe == "future_newer_than":
            r = b.newer_than(now + 10 * DAY_S).limit(4).run()
        else:
            r = b.limit(4).run()
        outs.append(r)
    if outs:
        (jr, tr) = outs
        assert_topk_agree(tr.scores, tr.slots, jr.scores, jr.slots)
        if probe != "limit_over_arena":
            assert (tr.slots == -1).all()
        else:
            assert tr.slots.shape == (1, CAP + 50)
            assert (tr.slots[0, CAP:] == -1).all()


def test_later_slices_and_tpu_engine_are_refused():
    tdb = RagDB(StoreConfig(capacity=8, dim=4), device="cpu")
    b = tdb.admin_session().search(np.ones(4, np.float32))
    for eng in ("ivf", "sharded", "hybrid"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            b.using(eng)
    with pytest.raises(ValueError, match="cuda"):
        b.using("pallas")
    with pytest.raises(NotImplementedError):
        b.match("error 17")
    with pytest.raises(NotImplementedError):
        tdb.build_index()
    for kw in (dict(warm_cfg=StoreConfig(capacity=8, dim=4)),
               dict(mesh=object()), dict(lexical_cfg=object())):
        with pytest.raises(NotImplementedError):
            RagDB(StoreConfig(capacity=8, dim=4), device="cpu", **kw)
    assert b.plan().route_reason == "warm tier empty"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RagDB(StoreConfig(capacity=8, dim=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_corpus(CorpusConfig(n_docs=4, dim=4))


def test_wrapper_never_runs_plain_on_a_cuda_tensor(monkeypatch):
    class CudaClaim:              # stands in for a tensor on the card
        device = torch.device("cuda")

    def plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    calls = []
    monkeypatch.setattr(kernel_mod, "arena_scan_plain", plain)
    monkeypatch.setattr(kernel_mod, "arena_scan_cuda",
                        lambda *a: calls.append(a) or "kernel")
    assert kernel_mod.arena_scan(CudaClaim(), None, None, None, None, 3) == "kernel"
    assert len(calls) == 1
    monkeypatch.undo()
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_mod.arena_scan_cuda(x, x, x, x, x, 2)
    meta_t = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no arena-scan engine"):
        kernel_mod.arena_scan(meta_t, meta_t, meta_t, meta_t, meta_t, 2)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert len(mods) > 20, mods\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
