"""Parity of the port's arena scan with the JAX reference's dense oracles.

The same numpy inputs go through the reference (`arena_scan_ref`,
`grouped_topk_ref`, `unified_query_ref`) and through the port's plain
engines on the CPU: its dense oracle, its streaming scan (the CUDA
kernel's tile schedule) and the `filtered_topk` / `grouped_topk` wrappers
(which take the kernel's plain version for CPU tensors). The kernel itself
runs only on the card and is held to its plain version by chip_smoke.py.

Contract (ROADMAP North star): masks and slots exact, f32 scores allclose
at rtol = atol = 1e-5 on unit-norm data (XLA and torch reduce in different
orders), slots may differ only inside a run of tied scores at the k-th
place, and no returned slot fails its group's predicate under an
independent numpy mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.query import Predicate as JPredicate
from repro.core.query import stack_predicates as j_stack
from repro.core.query import unified_query_ref as j_unified_query_ref
from repro.kernels.grouped_topk.ref import grouped_topk_ref as j_grouped_ref
from repro_torch.core.query import (BLOCK_ALL, Predicate, predicate_mask,
                                    stack_predicates, unified_query,
                                    unified_query_grouped, unified_query_ref)
from repro_torch.kernels.arena_scan.kernel import arena_scan
from repro_torch.kernels.arena_scan.ops import _packed_meta
from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.arena_scan.stages import ScanSpec
from repro_torch.kernels.filtered_topk.ops import filtered_topk
from repro_torch.kernels.filtered_topk.ref import filtered_topk_ref
from repro_torch.kernels.grouped_topk.ops import grouped_topk
from repro_torch.kernels.grouped_topk.ref import (group_masks,
                                                  grouped_topk_ref,
                                                  grouped_topk_scan_ref)

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-5


# ---------------------------------------------------------------------------
# shared helpers (imported by the other port test files)
# ---------------------------------------------------------------------------

def unit(x: np.ndarray) -> np.ndarray:
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-12)).astype(np.float32)


def np_arena(rng, n, d, n_tenants=5, dead=False):
    """numpy arena columns; acl as uint32 with high bits, categories up to
    31 (the sign bit of the int32 shift)."""
    tenant = rng.integers(-1, n_tenants, n, dtype=np.int32)
    if dead:
        tenant[:] = -1
    return {
        "emb": unit(rng.standard_normal((n, d)).astype(np.float32)),
        "tenant": tenant,
        "updated_at": rng.integers(0, 1000, n, dtype=np.int32),
        "category": rng.integers(0, 32, n, dtype=np.int32),
        "acl": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
    }


def torch_cols(a: dict) -> dict:
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v.copy()) for k, v in a.items()}


def np_meta(a: dict) -> np.ndarray:
    return np.stack([a["tenant"], a["updated_at"], a["category"],
                     a["acl"].view(np.int32)], axis=1).astype(np.int32)


def np_mask(a: dict, pred) -> np.ndarray:
    """Independent numpy WHERE clause (no jax, no torch)."""
    tenant = a["tenant"]
    ok = tenant >= 0
    if pred.tenant != -2:
        ok &= tenant == pred.tenant
    ok &= a["updated_at"] >= pred.min_ts
    ok &= ((np.uint64(pred.cat_mask & 0xFFFFFFFF)
            >> a["category"].astype(np.uint64)) & np.uint64(1)) != 0
    ok &= (a["acl"] & np.uint32(pred.acl_bits & 0xFFFFFFFF)) != 0
    return ok


def jpred(p) -> JPredicate:
    return JPredicate(tenant=p.tenant, min_ts=p.min_ts, cat_mask=p.cat_mask,
                      acl_bits=p.acl_bits)


def assert_topk_agree(s_p, i_p, s_r, i_r, *, exact_slots=False):
    """Port result (s_p, i_p) vs reference (s_r, i_r), both (B, k)."""
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    s_r, i_r = np.asarray(s_r), np.asarray(i_r)
    assert s_p.shape == s_r.shape and i_p.shape == i_r.shape
    assert i_p.dtype == np.int32
    np.testing.assert_allclose(s_p, s_r, rtol=TOL, atol=TOL)
    if exact_slots:
        np.testing.assert_array_equal(i_p, i_r)
        return
    for b in range(s_p.shape[0]):
        real_p, real_r = i_p[b][i_p[b] >= 0], i_r[b][i_r[b] >= 0]
        assert len(real_p) == len(real_r), f"row {b}: fill differs"
        diff = set(real_p.tolist()) ^ set(real_r.tolist())
        if diff:
            kth = s_r[b][len(real_r) - 1]
            for slot in diff:
                src_s, src_i = ((s_p, i_p) if (i_p[b] == slot).any()
                                else (s_r, i_r))
                sc = src_s[b][src_i[b] == slot][0]
                assert abs(sc - kth) <= TOL, (
                    f"row {b}: slot {slot} differs away from a k-th place tie")


def assert_no_leak(arena: dict, preds, gids, slots):
    masks = [np_mask(arena, p) for p in preds]
    slots = np.asarray(slots)
    for b in range(slots.shape[0]):
        real = slots[b][slots[b] >= 0]
        assert masks[int(gids[b])][real].all(), (
            f"row {b} leaked {real[~masks[int(gids[b])][real]]}")


def ref_grouped(arena, q, gids, preds, k):
    """The reference's dense oracle on the same numpy inputs."""
    meta = jnp.asarray(np_meta(arena))
    return j_grouped_ref(jnp.asarray(q), jnp.asarray(arena["emb"]), meta,
                         jnp.asarray(gids), j_stack([jpred(p) for p in preds]),
                         k)


def port_engines(arena, q, gids, preds, k, blk):
    """Every plain engine of the port on the same inputs."""
    cols = torch_cols(arena)
    tq, tg = torch.from_numpy(q), torch.from_numpy(gids)
    pa = stack_predicates(preds)
    meta = _packed_meta(cols["tenant"], cols["updated_at"], cols["category"],
                        cols["acl"])
    out = {
        "oracle": arena_scan_ref(tq, cols["emb"], meta, tg, pa, k),
        "scan": arena_scan_scan_ref(tq, cols["emb"], meta, tg, pa, k, blk),
        "kernel-plain": arena_scan(tq, cols["emb"], meta, tg, pa, k),
        "grouped-ref": grouped_topk_ref(tq, cols["emb"], meta, tg, pa, k),
        "grouped-scan-ref": grouped_topk_scan_ref(tq, cols["emb"], meta, tg,
                                                  pa, k, blk),
        "grouped-scan": grouped_topk(tq, cols["emb"], cols["tenant"],
                                     cols["updated_at"], cols["category"],
                                     cols["acl"], tg, pa, k, blk_n=blk),
        "grouped-wrapper": grouped_topk(tq, cols["emb"], cols["tenant"],
                                        cols["updated_at"], cols["category"],
                                        cols["acl"], tg, pa, k,
                                        use_kernel=True),
    }
    if len(preds) == 1:
        out["filtered"] = filtered_topk(tq, cols["emb"], cols["tenant"],
                                        cols["updated_at"], cols["category"],
                                        cols["acl"], pa[0], k)
        out["filtered-ref"] = filtered_topk_ref(tq, cols["emb"], meta, pa[0],
                                                k)
    np.testing.assert_array_equal(
        group_masks(meta, pa).numpy(),
        np.stack([np_mask(arena, p) for p in preds]))
    return out


# ---------------------------------------------------------------------------
# the dense cells of the conformance grid, plus the pinned hazards
# ---------------------------------------------------------------------------

# (B, N, D, k, G, scan tile) — test_arena_scan_conformance.py's filtered and
# grouped cells (odd N = 513, G in {1, 3 -> 4, 4, 7}), the tile at the page
# size the reference used there
CELLS = [
    (1, 64, 8, 4, 1, 64),
    (5, 700, 48, 8, 1, 256),
    (8, 1024, 128, 10, 1, 512),
    (3, 513, 64, 8, 1, 128),
    (8, 1000, 96, 10, 3, 256),
    (3, 513, 64, 8, 4, 128),
    (16, 2048, 128, 5, 7, 512),
]


def _preds(rng, G, block_all=False):
    preds = [Predicate(tenant=i % 3, min_ts=100,
                       cat_mask=int(rng.integers(1, 1 << 32)) | (1 << 31),
                       acl_bits=int(rng.integers(1, 1 << 32)) | (1 << 31))
             for i in range(G)]
    preds[0] = Predicate(tenant=1, min_ts=100)
    if block_all:
        preds[-1] = BLOCK_ALL
    return preds


@pytest.mark.parametrize("B,N,D,k,G,blk", CELLS,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-k{c[3]}-G{c[4]}"
                              for c in CELLS])
def test_engines_match_reference_oracle(B, N, D, k, G, blk):
    rng = np.random.default_rng(B * 1000 + N + G)
    arena = np_arena(rng, N, D)
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    gids = rng.integers(0, G, B).astype(np.int32)
    preds = _preds(rng, G)
    s_r, i_r = ref_grouped(arena, q, gids, preds, k)
    for name, (s, i) in port_engines(arena, q, gids, preds, k, blk).items():
        assert_topk_agree(s.numpy(), i.numpy(), s_r, i_r)
        assert_no_leak(arena, preds, gids, i.numpy())


@pytest.mark.parametrize("case", ["k_gt_n", "cat31_acl_high", "block_all",
                                  "duplicates", "all_dead"])
def test_pinned_hazards(case):
    rng = np.random.default_rng(7)
    N, D, B, G, k = 300, 32, 6, 3, 10
    arena = np_arena(rng, N, D, dead=(case == "all_dead"))
    q = unit(rng.standard_normal((B, D)).astype(np.float32))
    gids = (np.arange(B) % G).astype(np.int32)
    preds = _preds(rng, G, block_all=(case == "block_all"))
    exact = False
    if case == "k_gt_n":
        k = N + 9
    elif case == "cat31_acl_high":
        arena["category"][::2] = 31
        arena["acl"][::3] = np.uint32(1 << 31)
        preds = [Predicate(cat_mask=1 << 31, acl_bits=1 << 31),
                 Predicate(tenant=2, cat_mask=(1 << 31) | 1),
                 Predicate(acl_bits=0x80000001)]
    elif case == "duplicates":
        # rows n and N-1-n are identical; queries aim at the copies, so the
        # tie must go to the lower slot in every engine, bit for bit
        for j in range(40):
            for col in arena:
                arena[col][N - 1 - j] = arena[col][j]
        q[:] = arena["emb"][:B]
        preds = [Predicate(), Predicate(), Predicate()]
        exact = True
    s_r, i_r = ref_grouped(arena, q, gids, preds, k)
    if case == "block_all":
        assert (np.asarray(i_r)[gids == G - 1] == -1).all()
    if case == "all_dead":
        assert (np.asarray(i_r) == -1).all()
    for name, (s, i) in port_engines(arena, q, gids, preds, k, 64).items():
        assert_topk_agree(s.numpy(), i.numpy(), s_r, i_r, exact_slots=exact)
        assert_no_leak(arena, preds, gids, i.numpy())
        if case == "k_gt_n":
            assert (i.numpy()[:, N:] == -1).all()
            assert (s.numpy()[:, N:] == np.finfo(np.float32).min).all()


def test_predicate_mask_and_as_array_match_reference():
    rng = np.random.default_rng(3)
    arena = np_arena(rng, 400, 8)
    cols = torch_cols(arena)
    jstore = {k: jnp.asarray(v) for k, v in arena.items()}
    from repro.core.query import predicate_mask as j_predicate_mask
    for p in [Predicate(), Predicate(tenant=2, min_ts=300),
              Predicate(cat_mask=(1 << 31) | 0b101, acl_bits=0xF0000000),
              BLOCK_ALL]:
        got = predicate_mask(cols, p.as_array()).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(j_predicate_mask(jstore, jpred(p).as_array())))
        np.testing.assert_array_equal(got, np_mask(arena, p))
        np.testing.assert_array_equal(p.as_array().numpy(),
                                      np.asarray(jpred(p).as_array()))
    assert Predicate().as_array("cpu") is Predicate().as_array("cpu")


@pytest.mark.parametrize("k", [5, 420])
def test_unified_query_matches_reference(k):
    rng = np.random.default_rng(11)
    arena = np_arena(rng, 400, 16)
    q = unit(rng.standard_normal((4, 16)).astype(np.float32))
    pred = Predicate(tenant=3, min_ts=200)
    s_r, i_r = j_unified_query_ref({kk: jnp.asarray(v) for kk, v in arena.items()},
                                   jnp.asarray(q), jpred(pred).as_array(), k)
    store = torch_cols(arena)
    for engine in ("ref", "cuda"):
        s, i = unified_query(store, torch.from_numpy(q), pred, k,
                             engine=engine)
        assert_topk_agree(s.numpy(), i.numpy(), s_r, i_r)
    s, i = unified_query_ref(store, torch.from_numpy(q), pred.as_array(), k)
    assert_topk_agree(s.numpy(), i.numpy(), s_r, i_r)
    for engine in ("ref", "cuda"):
        s, i = unified_query_grouped(store, torch.from_numpy(q),
                                     torch.zeros(4, dtype=torch.int32),
                                     [pred], k, engine=engine)
        assert_topk_agree(s.numpy(), i.numpy(), s_r, i_r)


def test_engine_names_and_later_specs_are_refused():
    store = torch_cols(np_arena(np.random.default_rng(0), 8, 4))
    q = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="cuda"):
        unified_query(store, q, Predicate(), 2, engine="pallas")
    with pytest.raises(ValueError, match="unknown"):
        unified_query_grouped(store, q, torch.zeros(1, dtype=torch.int32),
                              [Predicate()], 2, engine="bogus")
    assert (ScanSpec(score="fused").n_lists,
            ScanSpec(score="both").n_lists) == (1, 2)
    with pytest.raises(ValueError, match="unknown"):
        ScanSpec(score="bogus")
    # the IVF slice is ported: the slot lane is a 5-wide metadata block
    assert (ScanSpec(slot_lane=True).meta_width, ScanSpec().meta_width) == (
        5, 4)


# ---------------------------------------------------------------------------
# the CUDA kernel's selection and merge algorithm, emulated step for step
# ---------------------------------------------------------------------------

NEG = float(np.finfo(np.float32).min)
NO_ROW = 2**31 - 1


def _before(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _count(lst, pred):
    """The kernel's binary search: length of the prefix of ``lst`` where
    ``pred`` holds (the kernel assumes the prefix property)."""
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(lst[mid]):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _emulate_kernel(scores, keep, k, tile):
    """csrc/arena_scan.cu on one query row: per-tile top-k_loc with every
    NEG_INF entry indexed NO_ROW, pairwise merge rounds that place each
    element by its rank (padding the odd list out with (NEG_INF, NO_ROW)),
    then finish. Returns (scores (k,), slots (k,))."""
    n = len(scores)
    k_loc = min(k, tile)
    lists = []
    for base in range(0, n, tile):
        ent = [(float(scores[r]), r) if r < n and keep[r] else (NEG, NO_ROW)
               for r in range(base, base + tile)]
        ent.sort(key=lambda e: (-e[0], e[1]))
        lists.append(ent[:k_loc])
    L = k_loc
    while len(lists) > 1:
        L2 = min(k, 2 * L)
        nxt = []
        for p in range(0, len(lists), 2):
            a = lists[p]
            if p + 1 == len(lists):
                nxt.append(a + [(NEG, NO_ROW)] * (L2 - L))
                continue
            b = lists[p + 1]
            out = [None] * L2
            for e, x in enumerate(a):
                r = e + _count(b, lambda y, x=x: _before(y, x))
                if r < L2:
                    out[r] = x
            for j, x in enumerate(b):
                r = j + _count(a, lambda y, x=x: not _before(x, y))
                if r < L2:
                    out[r] = x
            assert None not in out, "merge ranks collided"
            nxt.append(out)
        lists, L = nxt, L2
    fin = lists[0] + [(NEG, NO_ROW)] * max(0, k - L)
    s = np.asarray([e[0] for e in fin[:k]], np.float32)
    i = np.asarray([e[1] if e[0] > NEG else -1 for e in fin[:k]], np.int32)
    return s, i


@pytest.mark.parametrize("n,k,tile", [(700, 10, 256), (513, 520, 256),
                                      (1000, 300, 128), (300, 40, 32),
                                      (64, 1, 8)])
def test_kernel_algorithm_emulation_matches_oracle(n, k, tile):
    """The kernel's merge ranks are unique only while every list stays
    sorted: masked rows and padding must all carry (NEG_INF, NO_ROW). The
    emulation asserts no rank collision and matches the oracle exactly."""
    rng = np.random.default_rng(n + k)
    arena = np_arena(rng, n, 16)
    for j in range(20):                      # exact ties across tiles
        arena["emb"][n - 1 - j] = arena["emb"][j]
        for col in ("tenant", "updated_at", "category", "acl"):
            arena[col][n - 1 - j] = arena[col][j]
    q = unit(rng.standard_normal((3, 16)).astype(np.float32))
    q[0] = arena["emb"][0]
    preds = [Predicate(), Predicate(tenant=1, min_ts=300), BLOCK_ALL]
    gids = np.arange(3, dtype=np.int32)
    cols = torch_cols(arena)
    meta = _packed_meta(cols["tenant"], cols["updated_at"], cols["category"],
                        cols["acl"])
    s_o, i_o = arena_scan_ref(torch.from_numpy(q), cols["emb"], meta,
                              torch.from_numpy(gids), stack_predicates(preds),
                              k)
    scores = (torch.from_numpy(q) @ cols["emb"].T).numpy()
    for b in range(3):
        s, i = _emulate_kernel(scores[b], np_mask(arena, preds[b]), k, tile)
        np.testing.assert_array_equal(s, s_o.numpy()[b])
        np.testing.assert_array_equal(i, i_o.numpy()[b])


def test_merge_topk_stage_matches_reference():
    """The running-merge stage on tied scores: the running list wins ties,
    then tile order, exactly as the reference's `merge_topk`."""
    from repro.kernels.arena_scan.stages import merge_topk as j_merge_topk
    from repro_torch.kernels.arena_scan.stages import merge_topk
    rng = np.random.default_rng(9)
    best_s = np.sort(rng.integers(0, 4, (3, 5)).astype(np.float32))[:, ::-1]
    best_i = np.tile(np.arange(5, dtype=np.int32), (3, 1))
    tile_s = rng.integers(0, 4, (3, 7)).astype(np.float32)
    tile_i = np.tile(np.arange(10, 17, dtype=np.int32), (3, 1))
    args = (best_s.copy(), best_i, tile_s, tile_i)
    s, i = merge_topk(*(torch.from_numpy(a) for a in args), 6)
    js, ji = j_merge_topk(*(jnp.asarray(a) for a in args), 6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# the kernels' launch geometry (csrc/arena_scan.cuh), mirrored on the host
# ---------------------------------------------------------------------------

GEOMETRY_SPECS = {"dense": ScanSpec(), "wsum": ScanSpec(score="fused"),
                  "rrf": ScanSpec(score="both"),
                  "probe": ScanSpec(slot_lane=True)}


def check_geometry(mode, BB, G, QT, page_rows):
    """The launch the C launcher would pick for these shapes, as
    `scan_geometry` mirrors it: the micro-tiles cover the block's TILE_ROWS
    x BB scores exactly once, a warp holds 32 row groups and one query
    group, the shared memory is the layout's and fits a block, every mode
    (the lexical ones too, now that their lanes never pass through shared
    memory) keeps 32-dim stages and two blocks an SM at BB <= 32, and the
    same shapes give the same geometry."""
    from repro_torch.kernels.arena_scan import kernel as K
    spec = GEOMETRY_SPECS[mode]
    QT = QT if spec.has_lex else 0
    geo = K.scan_geometry(spec, BB, G, 10, page_rows, QT=QT)
    assert geo == K.scan_geometry(spec, BB, G, 10, page_rows, QT=QT)
    R, QN = geo["micro_tile"]
    assert geo["block_rows"] == BB and geo["tile_rows"] == K.TILE_ROWS
    assert R * QN * K.THREADS == K.TILE_ROWS * BB
    owned = []
    for tid in range(K.THREADS):
        rows, qrows = K.micro_tile(tid, BB)
        assert len(rows) == R and len(qrows) == QN
        owned += [(r, b) for r in rows for b in qrows]
    assert sorted(owned) == [(r, b) for r in range(K.TILE_ROWS)
                             for b in range(BB)]
    for w in range(K.THREADS // 32):
        tiles = [K.micro_tile(t, BB) for t in range(32 * w, 32 * w + 32)]
        assert len({rows[0] for rows, _ in tiles}) == 32
        assert len({tuple(qrows) for _, qrows in tiles}) == 1
    L = min(10, page_rows or K.TILE_ROWS)
    assert geo["smem_bytes"] == K.scan_smem(
        BB, spec, G, QT, L, geo["stages"], page_rows is not None,
        geo["run_lists_in_smem"])
    assert geo["chunk_dims"] == K.CHUNK_DIMS == 32
    assert 2 <= geo["stages"] <= K.MAX_STAGES
    assert geo["smem_bytes"] <= K.SMEM_CAPS[1]
    assert not geo["run_lists_in_smem"] or page_rows is not None
    if BB <= 32:
        assert geo["smem_bytes"] <= K.SMEM_CAPS[0]


@pytest.mark.parametrize("mode", list(GEOMETRY_SPECS))
@pytest.mark.parametrize("BB", [8, 16, 32, 64])
@pytest.mark.parametrize("QT", [1, 4, 16])
@pytest.mark.parametrize("G", [1, 16])
def test_resident_launch_geometry(mode, BB, QT, G):
    check_geometry(mode, BB, G, QT, None)


@pytest.mark.parametrize("ch", [32])
def test_stage_swizzle_is_conflict_free(ch):
    """The emb chunk's swizzled float4 slots (`emb_column`, the kernel's
    e_col, 128-byte rows of CHUNK_DIMS floats) hold every (row, column) of
    a stage once, and eight consecutive rows at one column -- a quarter
    warp's float4 loads in the micro-tile -- fall in eight distinct 16-byte
    bank groups."""
    from repro_torch.kernels.arena_scan import kernel as K
    assert ch == K.CHUNK_DIMS
    c4s = ch // 4
    slots = [K.emb_column(r, c) for r in range(K.TILE_ROWS)
             for c in range(c4s)]
    assert sorted(slots) == list(range(K.TILE_ROWS * c4s))
    for r0 in range(0, K.TILE_ROWS, 8):
        for c in range(c4s):
            assert len({K.emb_column(r, c) % 8
                        for r in range(r0, r0 + 8)}) == 8


def test_geometry_block_rows_and_misfit():
    """B maps to the instantiated block rows; a predicate block that fits
    no shared memory is refused, not launched."""
    from repro_torch.kernels.arena_scan import kernel as K
    assert [K.block_rows(b) for b in (1, 8, 9, 16, 17, 32, 33, 64, 100)] \
        == [8, 8, 16, 16, 32, 32, 64, 64, 64]
    with pytest.raises(ValueError, match="fits"):
        K.scan_geometry(ScanSpec(), 32, 1 << 15, 10)
