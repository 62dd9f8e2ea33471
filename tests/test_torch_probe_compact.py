"""The IVF probe's compacted candidates and its device-side quantizer.

The CUDA compaction kernel (``csrc/arena_scan_probe.cu``) keeps the live
slots of a probed candidate vector in order and leaves their count on the
card; its plain version is `ref.live_candidates`, held here to
`candidate_slots`' live entries. The probe's lists on the compacted vector
must equal the padded vector's slot for slot: selection breaks ties by
candidate position, and compaction keeps the live positions' order. The
quantizer the executor runs (`IVFIndex.probe_device`, `probe_union`) is
held on CPU tensors to the host `probe` and to the reference's. The CUDA
kernels run only on the card and are held to these plain versions by
chip_smoke.py (phase ivf_kernel) and tools/scan_probe.py.

Contract: integers exact; f32 scores within rtol = atol = 1e-5 (the plain
matmul's reduction may move with the gather's shape); the device union
equals the host one except in a row whose nprobe-th and (nprobe+1)-th
sims lie within TIE_MARGIN.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ivf import IVFIndex, probe_union
from repro_torch.kernels.arena_scan import kernel as K
from repro_torch.kernels.arena_scan.ops import _packed_meta
from repro_torch.kernels.arena_scan.stages import ScanSpec
from repro_torch.kernels.ivf_probe import ivf_probe as ivf_mod
from repro_torch.kernels.ivf_probe import ops as ivf_ops
from repro_torch.kernels.ivf_probe.ref import (candidate_slots,
                                               gather_candidates,
                                               ivf_probe_scan_ref,
                                               live_candidates)
from tests.test_torch_arena_scan import TOL, np_arena, torch_cols
from tests.test_torch_ivf import (_dbs, _port_index, _queries, _ref_index,
                                  assert_probe_agree)

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

#: sims closer than this at the nprobe-th place may order differently in
#: two f32 products of different reduction order
TIE_MARGIN = 1e-5


def _tables(case, rng, n=400, C=9, cap=24):
    """(members, overflow, clusters) of one compaction edge case over an
    arena of n rows."""
    members = np.full((C, cap), -1, np.int32)
    for c in range(C):
        fill = int(rng.integers(0, cap + 1))
        members[c, :fill] = rng.integers(0, n, fill)
    overflow = rng.integers(0, n, 11).astype(np.int32)
    clusters = np.full(8, -1, np.int32)
    clusters[:5] = rng.permutation(C)[:5]
    if case == "poisoned":
        bad = rng.random(members.shape) < 0.3
        members[bad] = rng.integers(-5, n + 50, int(bad.sum()))
        members[2, :cap // 2] = members[3, :cap // 2]         # repeats
        overflow = rng.integers(-5, n + 50, 11).astype(np.int32)
    elif case == "all-dead":
        members = np.where(rng.random(members.shape) < 0.5, -1,
                           n + rng.integers(0, 9, members.shape))
        overflow = np.full(11, -3, np.int32)
    elif case == "live-under-k":
        members[:] = -1
        members[clusters[1], 3] = 7
        overflow = np.array([-1, n, 12], np.int32)
    elif case == "padding-cluster-only":
        clusters[:] = -1
        overflow = overflow[:0]
    elif case == "overflow-only":
        clusters = clusters[:0]
    elif case == "cluster-ids-out-of-range":
        clusters[5:7] = [C, C + 3]
    return members.astype(np.int32), overflow.astype(np.int32), clusters


CASES = ["clean", "poisoned", "all-dead", "live-under-k",
         "padding-cluster-only", "overflow-only", "cluster-ids-out-of-range"]


@pytest.mark.parametrize("case", CASES)
def test_live_candidates_keep_candidate_order(case):
    """The compaction's plain version: `candidate_slots`' live entries
    (inside [0, n)) in candidate order, then -1 to length P, and their
    count -- every dead kind (member padding, a padding cluster, slots
    past or below the arena, a cluster id past C) dropped, repeats kept."""
    rng = np.random.default_rng(CASES.index(case))
    n = 400
    members, overflow, clusters = _tables(case, rng, n)
    tm, to = torch.from_numpy(members), torch.from_numpy(overflow)
    out, n_live = live_candidates(tm, to, clusters, n)
    cl = np.where(clusters < members.shape[0], clusters, -1)
    padded = candidate_slots(tm, to, cl).numpy()
    want = padded[(padded >= 0) & (padded < n)]
    assert out.dtype == torch.int32 and n_live.dtype == torch.int32
    assert out.shape == (len(clusters) * members.shape[1] + len(overflow),)
    assert n_live.shape == (1,) and int(n_live) == len(want)
    np.testing.assert_array_equal(out.numpy()[:len(want)], want)
    assert (out.numpy()[len(want):] == -1).all()
    expect = {"all-dead": 0, "live-under-k": 2, "padding-cluster-only": 0}
    if case in expect:
        assert int(n_live) == expect[case]
    if case == "overflow-only":
        np.testing.assert_array_equal(want, overflow)
    # the wrapper's plain path is this function
    got = ivf_mod.compact_candidates_plain(tm, to, clusters, n)
    assert all(torch.equal(a, b) for a, b in zip(got, (out, n_live)))


@pytest.mark.parametrize("k", [1, 5, 40])
@pytest.mark.parametrize("case", ["clean", "poisoned", "live-under-k"])
def test_probe_on_compacted_vector_equals_padded(case, k):
    """`ivf_probe_plain` and the streaming scan at the kernel's tile (256)
    and at a small one on the compacted vector return the padded vector's
    lists slot for slot (scores within TOL): selection follows candidate
    position, and compaction keeps the live positions' order."""
    rng = np.random.default_rng(10 + CASES.index(case) + k)
    n = 400
    a = np_arena(rng, n, 16)
    # exact ties: two identical live rows, listed high slot first
    a["emb"][9] = a["emb"][7]
    for c, v in (("tenant", 0), ("updated_at", 5), ("category", 1),
                 ("acl", 0xFFFFFFFF)):
        a[c][[7, 9]] = v
    members, overflow, clusters = _tables(case, rng, n)
    members[clusters[0], :2] = [9, 7]
    cols = torch_cols(a)
    meta = _packed_meta(cols["tenant"], cols["updated_at"], cols["category"],
                        cols["acl"])
    tm, to = torch.from_numpy(members), torch.from_numpy(overflow)
    q = torch.from_numpy(np.concatenate([a["emb"][[7]], rng.standard_normal(
        (4, 16)).astype(np.float32)]))
    pred = torch.tensor([-2, 0, -1, -1], dtype=torch.int32)
    padded = candidate_slots(tm, to, clusters)
    cand, _ = live_candidates(tm, to, clusters, n)
    kk = min(k, padded.numel())
    s_p, i_p = ivf_mod.ivf_probe_plain(q, cols["emb"], meta, padded, pred, kk)
    s_c, i_c = ivf_mod.ivf_probe_plain(q, cols["emb"], meta, cand, pred, kk)
    np.testing.assert_array_equal(i_c.numpy(), i_p.numpy())
    np.testing.assert_allclose(s_c.numpy(), s_p.numpy(), rtol=TOL, atol=TOL)
    for blk in (K.TILE_ROWS, 7):
        ce, cm = gather_candidates(cols["emb"], meta, cand)
        s_t, i_t = ivf_probe_scan_ref(q, ce, cm, pred, kk, blk)
        np.testing.assert_array_equal(i_t.numpy(), i_p.numpy())
        np.testing.assert_allclose(s_t.numpy(), s_p.numpy(), rtol=TOL,
                                   atol=TOL)
    if case == "clean" and kk >= 2:
        np.testing.assert_array_equal(i_c.numpy()[0, :2], [9, 7])


def test_public_probe_compacts_through_the_plain_versions(monkeypatch):
    """CPU tensors take the compaction's and the probe's plain versions,
    never a kernel wrapper; the wrappers refuse CPU tensors."""
    rng = np.random.default_rng(3)
    a = np_arena(rng, 64, 8)
    members, overflow, clusters = _tables("poisoned", rng, 64)
    calls = []
    monkeypatch.setattr(ivf_ops, "compact_candidates_cuda",
                        lambda *x: calls.append("compact"))
    monkeypatch.setattr(ivf_ops, "ivf_probe_cuda",
                        lambda *x, **kw: calls.append("probe"))
    seen = []
    plain = ivf_ops.compact_candidates_plain
    monkeypatch.setattr(ivf_ops, "compact_candidates_plain",
                        lambda *x: seen.append(1) or plain(*x))
    cols = torch_cols(a)
    ivf_ops.ivf_probe(torch.from_numpy(a["emb"][:3].copy()), cols["emb"],
                      cols["tenant"], cols["updated_at"], cols["category"],
                      cols["acl"], torch.from_numpy(members),
                      torch.from_numpy(overflow), clusters,
                      torch.tensor([-2, 0, -1, -1], dtype=torch.int32), 4)
    assert calls == [] and seen == [1]
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ivf_mod.compact_candidates_cuda(i[None], i, i, 10)
    assert ivf_mod.COMPACT_LAUNCHES == 0


@pytest.mark.parametrize("paged", [None, 1 << 15])
def test_probe_stages_its_tile_slots(paged):
    """The slot-lane block holds its sub-tile's TILE_ROWS slots in shared
    memory (staged once a sub-tile, read by every chunk's copies): the
    mirror's layout is the dense spec's plus those 1024 bytes, at the
    same ring depth and still two blocks an SM up to B = 32."""
    probe = ScanSpec(slot_lane=True)
    for BB in (8, 16, 32):
        geo = K.scan_geometry(probe, BB, 1, 10, paged)
        dense = K.scan_geometry(ScanSpec(), BB, 1, 10, paged)
        assert geo["stages"] == dense["stages"]
        assert geo["smem_bytes"] == dense["smem_bytes"] + 4 * K.TILE_ROWS
        assert geo["smem_bytes"] <= K.SMEM_CAPS[0]
        assert geo["smem_bytes"] == K.scan_smem(
            BB, probe, 1, 0, 10, geo["stages"], paged is not None,
            geo["run_lists_in_smem"])


def _union_rows_agree(q, cent, nprobe, got, want):
    """Unions equal, or every row whose top-nprobe sets differ sits at a
    tie within TIE_MARGIN."""
    if np.array_equal(got, want):
        return True
    sims = q @ cent.T
    srt = -np.sort(-sims, axis=1)
    return bool((np.abs(srt[:, nprobe - 1] - srt[:, nprobe])
                 <= TIE_MARGIN).any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_quantizer_matches_probe_and_reference(seed):
    """`IVFIndex.probe_device` on CPU tensors (the executor's quantizer:
    product, per-row top-nprobe, union ascending, -1 padded to the same
    U_pad) against the host `probe` and the reference's `probe` on the
    seed grid; `candidate_rows` is the host probe's rows_scanned."""
    _, jix = _ref_index(700 + 100 * seed, 16, n_clusters=12 + 4 * seed,
                        seed=seed)
    tix = _port_index(jix)
    rng = np.random.default_rng(seed)
    cent = np.asarray(tix.centroids)
    for B, nprobe in ((1, 1), (3, 4), (16, 8), (5, 40), (32, 3)):
        q = rng.standard_normal((B, 16)).astype(np.float32)
        got = tix.probe_device(torch.from_numpy(q), nprobe).numpy()
        tc, tn, tr = tix.probe(q, nprobe)
        jc, _, jr = jix.probe(q, nprobe)
        assert got.dtype == np.int32 and got.shape == tc.shape
        assert _union_rows_agree(q, cent, min(nprobe, tix.n_clusters - 1)
                                 if nprobe < tix.n_clusters else 1, got, tc)
        np.testing.assert_array_equal(tc, jc)
        assert (got[:tn] >= 0).all() and (got[tn:] == -1).all()
        assert np.all(np.diff(got[:tn]) > 0)
        assert tix.candidate_rows(nprobe, B) == tr == jr


def test_probe_union_pads_and_dedups():
    """`probe_union`: repeated clusters across rows counted once,
    ascending, padding -1; nprobe = C takes every cluster."""
    cent = torch.eye(4, 3)[[0, 1, 2, 0]] * torch.tensor([[1.], [1.], [1.],
                                                        [.5]])
    q = torch.tensor([[1., .1, 0.], [.9, 0., .2], [0., 1., 0.]])
    out = probe_union(q, cent, 1, 4).tolist()
    assert out == [0, 1, -1, -1]
    assert probe_union(q, cent, 4, 4).tolist() == [0, 1, 2, 3]


def test_front_door_ivf_runs_the_device_union(monkeypatch):
    """An ivf batch through the front door never calls the host `probe`:
    the executor's quantizer is `probe_device`, and the rows still match
    the reference's (the existing parity tests hold the counters)."""
    jdb, tdb = _dbs()
    qs = _queries(5, 17)
    jplans = [jdb.admin_session().search(q).limit(6).plan() for q in qs]
    tplans = [tdb.admin_session().search(q).limit(6).plan() for q in qs]
    assert all(p.engine == "ivf" for p in tplans)
    monkeypatch.setattr(IVFIndex, "probe", lambda *a, **kw: pytest.fail(
        "the executor called the host probe"))
    used = []
    dev_probe = IVFIndex.probe_device
    monkeypatch.setattr(IVFIndex, "probe_device",
                        lambda self, q, n: used.append(q.shape[0])
                        or dev_probe(self, q, n))
    ts, tsl, _ = tdb.execute(tplans)
    js, jsl, _ = jdb.execute(jplans)
    assert used == [5]
    assert_probe_agree(ts, tsl, js, jsl)
