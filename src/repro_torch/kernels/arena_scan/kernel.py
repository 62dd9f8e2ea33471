"""The unified arena scan on the card: the CUDA kernel's wrapper and its
plain PyTorch version.

`arena_scan_cuda` launches the kernels of ``csrc/arena_scan.cuh`` (the
Hopper port of the Pallas kernel ``arena_scan_pallas``, resident regime --
``src/repro/kernels/arena_scan/kernel.py:97,171`` -- in its dense spec, its
two lexical specs, ``ScanSpec("fused" | "both")``, which
``hybrid_score_pallas`` runs, and its slot-lane spec, which
``ivf_probe_pallas`` runs; the header states the design and its bound).
`arena_scan_probe_cuda` launches the slot-lane mode. Each mode's C entry
point is one source (``arena_scan.cu``, ``arena_scan_fused.cu``,
``arena_scan_both.cu``, ``arena_scan_probe.cu``); at first use one ``nvcc``
per source compiles them all at once, from the sources in the package only,
and the objects link into one library in ``src/repro_torch/build/`` (listed
in ``.gitignore``), loaded with ``ctypes``.

Both take ``page_rows``: ``None`` launches the resident kernel, an int >= 1
the paged kernel (``paged_scan_kernel`` in the header, the Hopper port of
the Pallas kernel's paged regime ``_paged_kernel``,
``src/repro/kernels/arena_scan/kernel.py:121``), which returns the same
lists bit for bit. The two share one score stage: each thread holds a
register micro-tile of 4 arena rows x BB / 4 query rows, fed by a ring of
shared-memory stages of 32 dims that TMA tile loads fill (``cp.async`` for
the slot-lane gather). In the lexical specs the epilogue compacts the
(query row, arena row) pairs that pass the mask and computes BM25 for
those alone, reading their lanes straight from device memory
(`ref.lexical_pairs` and `ref.bm25_pairs` emulate it). `scan_geometry`
mirrors the launcher's choice of geometry on the host, and `scan_info`
asks the library for it (with the blocks an SM holds) on the card.

`arena_scan` is the dispatch every caller uses: CUDA tensors go to the
kernel, CPU tensors to `arena_scan_plain` (resident) or to the streaming
scan at ``blk_n = page_rows`` (paged), and nothing else is taken. There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import operator
import os

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels._attention import on_device
from repro_torch.kernels._nvcc import check_tensor as _check
from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.arena_scan.stages import ScanSpec
from repro_torch.launch import _cost

#: the kernels, and the mbarrier / TMA helpers they share with the
#: attention kernels
HEADERS = tuple(os.path.join(_nvcc.CSRC, f) for f in (
    "arena_scan.cuh", "attention.cuh"))
#: one source per mode's C entry point, compiled in parallel
SOURCES = tuple(os.path.join(_nvcc.CSRC, f) for f in (
    "arena_scan.cu", "arena_scan_fused.cu", "arena_scan_both.cu",
    "arena_scan_probe.cu"))

#: dense-spec kernel launches through `arena_scan_cuda` (the main-path
#: audit); the lexical specs and the slot-lane mode are counted by their
#: one caller each, ``kernels.hybrid_score.hybrid_score.LAUNCHES`` and
#: ``kernels.ivf_probe.ivf_probe.LAUNCHES``
LAUNCHES = 0
#: paged-kernel launches through `arena_scan_cuda` and
#: `arena_scan_probe_cuda` (``page_rows`` set), every spec
PAGED_LAUNCHES = 0
#: nvcc's output of the build that made the library (ptxas register,
#: spill and shared-memory report), set by `build`
BUILD_LOG = ""

_lib = None


def build() -> str:
    """Compile the kernel library if these sources have not been built yet
    (`_nvcc.build`: one nvcc per source, all started together, then one
    link). Returns the path of the shared library."""
    global BUILD_LOG
    path, log = _nvcc.build("arena_scan", HEADERS, SOURCES)
    if log:
        BUILD_LOG = log
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.arena_scan_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                          p, p, p, p, p, p, p]
        lib.arena_scan_launch.restype = i
        for fn in (lib.arena_scan_fused_launch, lib.arena_scan_both_launch):
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                           p, p, p, p, p, p, p]
            fn.restype = i
        lib.arena_scan_probe_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                i, p, p, p, p, p, p, p]
        lib.arena_scan_probe_launch.restype = i
        lib.arena_scan_compact_launch.argtypes = [p, i, i, p, i, p, i, i, p,
                                                  p, p, p]
        lib.arena_scan_compact_blocks.argtypes = [i]
        lib.arena_scan_paged_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                i, p, p, p, p, p, p, p]
        for fn in (lib.arena_scan_fused_paged_launch,
                   lib.arena_scan_both_paged_launch):
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                           p, p, p, p, p, p, p]
        lib.arena_scan_probe_paged_launch.argtypes = [p, p, p, p, p, p, i, i,
                                                      i, i, i, i, p, p, p, p,
                                                      p, p, p]
        for fn in (lib.arena_scan_info, lib.arena_scan_fused_info,
                   lib.arena_scan_both_info, lib.arena_scan_probe_info):
            fn.argtypes = [i, i, i, i, i, i, p]
        for fn in (lib.arena_scan_paged_launch,
                   lib.arena_scan_fused_paged_launch,
                   lib.arena_scan_both_paged_launch,
                   lib.arena_scan_probe_paged_launch,
                   lib.arena_scan_compact_launch,
                   lib.arena_scan_compact_blocks,
                   lib.arena_scan_info,
                   lib.arena_scan_fused_info,
                   lib.arena_scan_both_info,
                   lib.arena_scan_probe_info):
            fn.restype = i
        lib.arena_scan_error_string.argtypes = [i]
        lib.arena_scan_error_string.restype = ctypes.c_char_p
        lib.arena_scan_tile_rows.argtypes = []
        lib.arena_scan_tile_rows.restype = i
        _lib = lib
    return _lib


def _check_page_rows(page_rows):
    """``page_rows`` as an int in [1, 2^31), or None; raises otherwise."""
    if page_rows is None:
        return None
    if isinstance(page_rows, bool) or not hasattr(page_rows, "__index__") \
            or not 1 <= operator.index(page_rows) < 1 << 31:
        raise ValueError(f"page_rows must be None or an int in [1, 2^31), "
                         f"got {page_rows!r}")
    return operator.index(page_rows)


def _scratch(lib, rows: int, n: int, k: int, dev,
             page_rows: int | None = None):
    """Outputs (rows, k) and the merge rounds' two candidate buffers for a
    scan of ``n`` rows in tiles (or, with ``page_rows``, pages): (out_s,
    out_i, buffers, the launch's pointer tuple; the stream follows it). The
    caller holds ``buffers`` until the launch is enqueued."""
    tile = page_rows or lib.arena_scan_tile_rows()
    n_tiles = -(-n // tile)
    n_pow2 = 1 << (n_tiles - 1).bit_length()
    cand = rows * n_pow2 * min(k, tile)
    bufs = [torch.empty(cand, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    out_s = torch.empty((rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=dev)
    return out_s, out_i, bufs, (*(b.data_ptr() for b in bufs),
                                out_s.data_ptr(), out_i.data_ptr())


#: predicate groups one launch takes: the kernel stages the batch's (G, 4)
#: predicate block in shared memory; `split_by_groups` takes more
MAX_GROUPS = 8192


def split_by_groups(scan, q, gids, preds, lex=None, cap: int = MAX_GROUPS):
    """A batch of more than ``cap`` predicate groups as launches of at most
    ``cap``: the rows ordered by group, one ``scan(q, gids, preds, lex)``
    a range of ``cap`` groups that holds rows -- its rows' queries (and
    query terms), their gids rebased to the range, the range's predicates
    -- and each list scattered back to its rows. Returns what one scan of
    the whole batch returns (a row's lists depend on its own query, group
    and terms only). Reads the group counts on the host: a batch this
    large waits for the card once."""
    G = preds.shape[0]
    order = torch.argsort(gids, stable=True)
    ends = torch.bincount(gids.long(), minlength=G).cumsum(0).tolist()
    outs = None
    for g0 in range(0, G, cap):
        g1 = min(G, g0 + cap)
        r0, r1 = ends[g0 - 1] if g0 else 0, ends[g1 - 1]
        if r0 == r1:
            continue
        rows = order[r0:r1]
        sub = None if lex is None else (lex[0], lex[1], lex[2][rows],
                                        lex[3][rows])
        lists = scan(q[rows], gids[rows] - g0, preds[g0:g1].contiguous(), sub)
        if outs is None:
            outs = [torch.empty((q.shape[0],) + t.shape[1:], dtype=t.dtype,
                                device=t.device) for t in lists]
        for out, t in zip(outs, lists):
            out[rows] = t
    return tuple(outs)


def arena_scan_cuda(q, emb, meta, gids, preds, k: int, *,
                    spec: ScanSpec = ScanSpec(), lex: tuple | None = None,
                    page_rows: int | None = None):
    """Launch the CUDA arena scan on the current stream (no sync). q (B, D)
    f32; emb (N, D) f32; meta (N, 4) int32; gids (B,) int32; preds (G, 4)
    int32; for the lexical specs lex = (terms (N, T) int32, lexnorm (N, T)
    f32, qterms (B, QT) int32, qidf (B, QT) f32); all contiguous on one
    CUDA device. ``page_rows`` None launches the resident kernel, an int
    >= 1 the paged kernel (pages of that many rows, the same lists). Returns
    `spec.n_lists` (scores (B, k) f32, slots (B, k) int32) pairs flattened.
    Any T and QT whose launch fits a block (`scan_geometry`); more than
    MAX_GROUPS predicate groups run as several launches
    (`split_by_groups`). Raises on any input it cannot take; the
    slot-lane spec is `arena_scan_probe_cuda`'s."""
    global LAUNCHES, PAGED_LAUNCHES
    page_rows = _check_page_rows(page_rows)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"arena_scan_cuda needs CUDA tensors, got {dev}")
    if spec.slot_lane:
        raise ValueError("the slot-lane scan gathers its candidates by slot: "
                         "launch it with arena_scan_probe_cuda")
    if q.dim() != 2 or emb.dim() != 2 or preds.dim() != 2:
        raise ValueError("q, emb and preds must be 2-D")
    B, D = q.shape
    N, G = emb.shape[0], preds.shape[0]
    _check("q", q, torch.float32, (B, D), dev)
    _check("emb", emb, torch.float32, (N, D), dev)
    _check("meta", meta, torch.int32, (N, 4), dev)
    _check("gids", gids, torch.int32, (B,), dev)
    _check("preds", preds, torch.int32, (G, 4), dev)
    if B < 1 or N < 1 or D < 1 or G < 1 or k < 1:
        raise ValueError(f"arena_scan_cuda needs B, N, D, G, k >= 1, got "
                         f"B={B} N={N} D={D} G={G} k={k}")
    if max(B, N, k) >= 1 << 31:
        raise ValueError("B, N and k must fit in int32")
    T = QT = 0
    if spec.has_lex:
        if lex is None:
            raise ValueError(f"ScanSpec(score={spec.score!r}) needs "
                             "lex=(terms, lexnorm, qterms, qidf)")
        terms, lexnorm, qterms, qidf = lex
        if terms.dim() != 2 or qterms.dim() != 2:
            raise ValueError("terms and qterms must be 2-D")
        T, QT = terms.shape[1], qterms.shape[1]
        _check("terms", terms, torch.int32, (N, T), dev)
        _check("lexnorm", lexnorm, torch.float32, (N, T), dev)
        _check("qterms", qterms, torch.int32, (B, QT), dev)
        _check("qidf", qidf, torch.float32, (B, QT), dev)
        if T < 1 or QT < 1:
            raise ValueError(f"the kernel takes T={T} lanes and QT={QT} "
                             "query terms: each at least 1")
    if G > MAX_GROUPS:
        return split_by_groups(
            lambda q_, g_, p_, lex_: arena_scan_cuda(
                q_, emb, meta, g_, p_, k, spec=spec, lex=lex_,
                page_rows=page_rows), q, gids, preds, lex)
    if spec.has_lex:
        _lexical_fits(spec, block_rows(B), G, k, page_rows, QT)
    lib = _load()
    out_s, out_i, _bufs, scratch = _scratch(lib, spec.n_lists * B, N, k,
                                            dev, page_rows)
    dense_in = (q.data_ptr(), emb.data_ptr(), meta.data_ptr(),
                gids.data_ptr(), preds.data_ptr())
    paged = () if page_rows is None else (page_rows,)
    with on_device(dev) as stream:
        if spec.has_lex:
            name = f"arena_scan_{spec.score}{'_paged' * bool(paged)}_launch"
            rc = getattr(lib, name)(*dense_in, terms.data_ptr(),
                                    lexnorm.data_ptr(), qterms.data_ptr(),
                                    qidf.data_ptr(), B, N, D, G, T, QT, k,
                                    *paged, *scratch, stream)
        elif paged:
            rc = lib.arena_scan_paged_launch(*dense_in, B, N, D, G, k,
                                             *paged, *scratch, stream)
        else:
            rc = lib.arena_scan_launch(*dense_in, B, N, D, G, k, *scratch,
                                       stream)
    if rc != 0:
        raise RuntimeError(
            f"arena_scan kernel launch failed (spec {spec.score!r}, B={B} "
            f"N={N} D={D} G={G} T={T} QT={QT} k={k} page_rows={page_rows}): "
            + lib.arena_scan_error_string(rc).decode())
    if paged:
        PAGED_LAUNCHES += 1
    elif not spec.has_lex:
        LAUNCHES += 1
    if spec.n_lists == 1:
        return out_s, out_i
    return out_s[:B], out_i[:B], out_s[B:], out_i[B:]


def arena_scan_probe_cuda(q, emb, meta, cand, pred, k: int, *,
                          n_live=None, page_rows: int | None = None):
    """Launch the slot-lane (IVF candidate) scan on the current stream (no
    sync). q (B, D) f32; the ARENA's emb (N, D) f32 and packed meta (N, 4)
    int32; cand (P,) int32 arena slots of the candidate rows, in candidate
    order (slots outside [0, N) are dead rows); pred (4,) int32; all
    contiguous on one CUDA device. ``n_live`` ((1,) int32 on the card, as
    `arena_scan_compact_cuda` leaves it) makes the kernel walk only
    ``cand[:n_live]``, read from device memory: P still sizes the launch,
    and blocks past the live count write empty lists; None walks all P.
    The kernel reads each candidate's rows through its slot; no (P, D) copy
    is made. ``page_rows`` (an int >= 1) takes the paged kernel over pages
    of that many candidate positions. Returns (scores (B, k) f32, arena
    slots (B, k) int32): ties to the lower candidate position, -1 wherever
    the score is NEG_INF. Raises on any input it cannot take."""
    global PAGED_LAUNCHES
    page_rows = _check_page_rows(page_rows)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"arena_scan_probe_cuda needs CUDA tensors, got "
                         f"{dev}")
    if q.dim() != 2 or emb.dim() != 2 or cand.dim() != 1:
        raise ValueError("q and emb must be 2-D, cand 1-D")
    B, D = q.shape
    N, P = emb.shape[0], cand.shape[0]
    _check("q", q, torch.float32, (B, D), dev)
    _check("emb", emb, torch.float32, (N, D), dev)
    _check("meta", meta, torch.int32, (N, 4), dev)
    _check("cand", cand, torch.int32, (P,), dev)
    _check("pred", pred, torch.int32, (4,), dev)
    if n_live is not None:
        _check("n_live", n_live, torch.int32, (1,), dev)
    if B < 1 or N < 1 or P < 1 or D < 1 or k < 1:
        raise ValueError(f"arena_scan_probe_cuda needs B, N, P, D, k >= 1, "
                         f"got B={B} N={N} P={P} D={D} k={k}")
    if max(B, N, P, k) >= 1 << 31:
        raise ValueError("B, N, P and k must fit in int32")
    lib = _load()
    out_s, out_i, _bufs, scratch = _scratch(lib, B, P, k, dev, page_rows)
    inputs = (q.data_ptr(), emb.data_ptr(), meta.data_ptr(), cand.data_ptr(),
              None if n_live is None else n_live.data_ptr(), pred.data_ptr(),
              B, N, P, D, k)
    with on_device(dev) as stream:
        if page_rows is None:
            rc = lib.arena_scan_probe_launch(*inputs, *scratch, stream)
        else:
            rc = lib.arena_scan_probe_paged_launch(*inputs, page_rows,
                                                   *scratch, stream)
    if rc != 0:
        raise RuntimeError(
            f"arena_scan probe kernel launch failed (B={B} N={N} P={P} "
            f"D={D} k={k} page_rows={page_rows}): "
            + lib.arena_scan_error_string(rc).decode())
    if page_rows is not None:
        PAGED_LAUNCHES += 1
    return out_s, out_i


def arena_scan_compact_cuda(members, overflow, clusters, n_arena: int):
    """Launch the candidate compaction on the current stream (no sync):
    members (C, cap) int32, overflow (O,) int32 and clusters (U,) int32
    (-1 padding; an id outside [0, C) counts as padding), contiguous on one
    CUDA device, U * cap + O = P >= 1. Returns (cand (P,) int32: the live
    slots -- inside [0, n_arena) -- of the probed clusters' member rows
    and the overflow tail, in candidate order, then -1; n_live (1,) int32,
    their count, left on the card for `arena_scan_probe_cuda`). Raises on
    any input it cannot take."""
    dev = members.device
    if dev.type != "cuda":
        raise ValueError(f"arena_scan_compact_cuda needs CUDA tensors, got "
                         f"{dev}")
    if members.dim() != 2 or overflow.dim() != 1 or clusters.dim() != 1:
        raise ValueError("members must be 2-D, overflow and clusters 1-D")
    (C, cap), O, U = members.shape, overflow.shape[0], clusters.shape[0]
    _check("members", members, torch.int32, (C, cap), dev)
    _check("overflow", overflow, torch.int32, (O,), dev)
    _check("clusters", clusters, torch.int32, (U,), dev)
    P = U * cap + O
    if not 1 <= P < 1 << 31 or not 0 <= n_arena < 1 << 31:
        raise ValueError(f"the compaction needs 1 <= U * cap + O < 2^31 and "
                         f"an int32 arena, got P={P} n_arena={n_arena}")
    lib = _load()
    counts = torch.empty(lib.arena_scan_compact_blocks(P), dtype=torch.int32,
                         device=dev)
    cand = torch.empty(P, dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    with on_device(dev) as stream:
        rc = lib.arena_scan_compact_launch(
            members.data_ptr(), C, cap, clusters.data_ptr(), U,
            overflow.data_ptr(), O, int(n_arena), counts.data_ptr(),
            cand.data_ptr(), n_live.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"candidate compaction launch failed (C={C} cap={cap} U={U} "
            f"O={O}): " + lib.arena_scan_error_string(rc).decode())
    return cand, n_live


def scan_info(spec: ScanSpec, B: int, N: int, G: int, k: int,
              page_rows: int | None = None, QT: int = 0) -> dict:
    """What a launch of these shapes uses on this card, from the library's
    info entry point (builds the kernels if needed): `scan_geometry`'s keys
    as the C launcher computes them, plus the blocks an SM holds at that
    shared memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
    the blocks along x (resident: tiles; paged: pages). The lanes a row do
    not change the launch: they never pass through shared memory."""
    lib = _load()
    out = (ctypes.c_int * 10)()
    name = ("arena_scan_probe_info" if spec.slot_lane else
            f"arena_scan_{spec.score}_info" if spec.has_lex else
            "arena_scan_info")
    rc = getattr(lib, name)(B, N, G, QT, k,
                            _check_page_rows(page_rows) or 0, out)
    if rc != 0:
        raise RuntimeError(f"{name} failed: "
                           + lib.arena_scan_error_string(rc).decode())
    return dict(smem_bytes=out[0], stages=out[1],
                run_lists_in_smem=bool(out[2]), blocks_per_sm=out[3],
                grid_x=out[4], tile_rows=out[5], micro_tile=(out[6], out[7]),
                chunk_dims=out[8], block_rows=out[9])


# ---------------------------------------------------------------------------
# The launch geometry of csrc/arena_scan.cuh, mirrored on the host (the CPU
# tests hold it to its invariants; chip_smoke.py holds it to `scan_info`)
# ---------------------------------------------------------------------------

THREADS = 256            #: threads a block
TILE_ROWS = THREADS      #: arena rows a block scores at once
MICRO_ROWS = 4           #: arena rows of a thread's micro-tile
QUERY_GROUPS = 4         #: a micro-tile holds block_rows / 4 query rows
SEL_ROWS = 8             #: query rows selected together, one a warp
WARP_K = 32              #: largest list the warp argmax selects
MAX_STAGES = 4
#: dims a ring stage holds in every spec (``CH``): 128-byte rows
CHUNK_DIMS = 32
RUN_SMEM_BUDGET = 24 * 1024
#: shared memory a block may take to keep two blocks on an SM, then one
SMEM_CAPS = (113 * 1024, 227 * 1024)


def block_rows(B: int) -> int:
    """Query rows a block covers (BB): the kernels are instantiated at 8,
    16, 32 and 64; a batch above 64 takes more blocks along y."""
    return 8 if B <= 8 else 16 if B <= 16 else 32 if B <= 32 else 64


def _align(x: int, to: int = 16) -> int:
    return (x + to - 1) & ~(to - 1)


def scan_smem(BB: int, spec: ScanSpec, G: int, QT: int, L: int,
              stages: int, paged: bool, run_smem: bool) -> int:
    """Bytes of a block's shared memory (``scan_layout``): the ring (each
    stage a 1024-byte multiple: the TMA swizzle's period), the selection
    buffers (a paged block's two lists of the "both" spec share their index
    array when a list holds at most WARP_K entries), a paged block's
    sub-tile lists and running lists, the predicates, the group ids, the
    slot-lane spec's TILE_ROWS slots, the lexical modes' query terms and
    idf (QT rounded up to 4 a row) and pair lists (SEL_ROWS counts and
    SEL_ROWS x TILE_ROWS one-byte rows), the ring's mbarriers and 1024
    bytes of slack to align the ring."""
    nl = spec.n_lists
    ring = stages * _align(4 * (TILE_ROWS + BB) * CHUNK_DIMS, 1024)
    sel = nl * SEL_ROWS * TILE_ROWS * 8 - (
        SEL_ROWS * TILE_ROWS * 4 if paged and nl == 2 and L <= WARP_K else 0)
    sub = _align(nl * SEL_ROWS * min(L, TILE_ROWS) * 8) if paged else 0
    run = _align(2 * nl * BB * L * 8) if run_smem else 0
    fixed = _align(16 * G) + _align(4 * BB) + (
        _align(4 * TILE_ROWS) if spec.slot_lane else 0)
    lex = (_align(8 * BB * _align(QT, 4)) + _align(SEL_ROWS * (4 + TILE_ROWS))
           if spec.has_lex else 0)
    return ring + sel + sub + run + fixed + lex + _align(8 * stages) + 1024


def scan_geometry(spec: ScanSpec, B: int, G: int, k: int,
                  page_rows: int | None = None, QT: int = 0) -> dict:
    """The launch geometry the C launcher picks (``scan_config``): block
    rows BB, the micro-tile (MICRO_ROWS arena rows x BB / 4 query rows a
    thread), the ring's depth, where a paged block's running lists live and
    the block's shared memory -- the deepest ring (2..4 stages) that fits
    two blocks an SM, running lists in shared memory when both copies fit
    24 KB, else the deepest that fits one. Raises when nothing fits."""
    BB = block_rows(B)
    paged = page_rows is not None
    L = min(k, page_rows if paged else TILE_ROWS)
    run_fits = paged and 2 * spec.n_lists * BB * L * 8 <= RUN_SMEM_BUDGET
    for cap in SMEM_CAPS:
        for run_smem in (run_fits, False):
            for stages in range(MAX_STAGES, 1, -1):
                smem = scan_smem(BB, spec, G, QT, L, stages, paged, run_smem)
                if smem <= cap:
                    return dict(block_rows=BB, tile_rows=TILE_ROWS,
                                micro_tile=(MICRO_ROWS, BB // QUERY_GROUPS),
                                chunk_dims=CHUNK_DIMS, stages=stages,
                                run_lists_in_smem=run_smem, smem_bytes=smem)
    raise ValueError(f"no launch of BB={BB} G={G} QT={QT} L={L} fits a "
                     "block's shared memory")


@functools.lru_cache(maxsize=256)
def _lexical_fits(spec: ScanSpec, BB: int, G: int, k: int, page_rows, QT):
    """Raise when no lexical launch fits a block's shared memory: the modes
    stage the batch's query terms there, so QT sets the size (the lanes
    are read from device memory: T does not). Cached, as the wrapper
    asks once a launch."""
    scan_geometry(spec, BB, G, k, page_rows, QT=QT)


def micro_tile(tid: int, BB: int) -> tuple[list[int], list[int]]:
    """Thread ``tid``'s micro-tile in the kernel's map: its tile rows
    rg + 64 i (i < MICRO_ROWS) and its query rows qg * QN + j (j < QN),
    rg = 32 ((tid // 32) % 2) + tid % 32, qg = tid // 64 -- a warp holds 32
    row groups and one query group, so its query loads are warp-uniform."""
    rg = ((tid // 32) % 2) * 32 + tid % 32
    qg = tid // 64
    qn = BB // QUERY_GROUPS
    n_rg = TILE_ROWS // MICRO_ROWS
    return ([rg + n_rg * i for i in range(MICRO_ROWS)],
            [qg * qn + j for j in range(qn)])


def emb_column(r: int, c4: int) -> int:
    """The float4 slot of a ring stage that holds dims 4 c4 .. 4 c4 + 3 of
    tile row ``r`` (``e_col``): rows of CHUNK_DIMS floats under the TMA's
    128-byte swizzle, the 16-byte unit c4 XOR bits 0-2 of the row."""
    return r * (CHUNK_DIMS // 4) + (c4 ^ (r & 7))


#: The plain PyTorch version of the resident kernel (the port of
#: `arena_scan_ref`): predicate mask, ``keep[gids]``, `torch.matmul` scores,
#: and a stable descending sort (ties to the lower index). On the card,
#: callers keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
#: False``). The paged kernel's plain version is the streaming scan at
#: ``blk_n = page_rows``, `arena_scan_scan_ref`: one local top-k per page,
#: one merge.
arena_scan_plain = arena_scan_ref


def scan_work(q, emb, preds, k: int, spec: ScanSpec = ScanSpec(),
              lex: tuple | None = None) -> tuple[int, int]:
    """(flops, bytes) of one resident or paged scan (the bound of
    ``PERF.md``'s kernel table): 2 * B * N * D; the arena's embeddings and
    packed metadata, q, the group ids and predicates read once, each list
    (score, slot) written once, and with lanes the (N, T) terms and
    weights and the (B, QT) query terms and idf read once."""
    B, D = q.shape
    N, G = emb.shape[0], preds.shape[0]
    nbytes = (N * (4 * D + 16) + B * D * 4 + B * 4 + G * 16
              + spec.n_lists * B * k * 8)
    if lex is not None and spec.has_lex:
        terms, _, qterms, _ = lex
        nbytes += 8 * terms.numel() + 8 * qterms.numel()
    return 2 * B * N * D, nbytes


def arena_scan(q, emb, meta, gids, preds, k: int, *,
               spec: ScanSpec = ScanSpec(), lex: tuple | None = None,
               page_rows: int | None = None):
    """The unified scan: the CUDA kernel (resident, or paged with
    ``page_rows``) for tensors on the card, its plain version for tensors
    on the CPU; on ``meta`` (the launch tools' dry run) empty lists of the
    kernel's shapes, no launch; any other device raises. On the card and
    on ``meta`` the call reports the kernel's work to an active
    `launch._cost` counter (`scan_work`)."""
    if _cost.counting() and q.device.type in ("cuda", "meta"):
        flops, nbytes = scan_work(q, emb, preds, k, spec, lex)
        _cost.report("arena_scan", flops=flops, nbytes=nbytes)
    if q.device.type == "cuda":
        return arena_scan_cuda(q, emb, meta, gids, preds, k, spec=spec,
                               lex=lex, page_rows=page_rows)
    if q.device.type == "meta":
        B = q.shape[0]
        out_s = torch.empty((spec.n_lists * B, k), dtype=torch.float32,
                            device=q.device)
        out_i = torch.empty((spec.n_lists * B, k), dtype=torch.int32,
                            device=q.device)
        if spec.n_lists == 1:
            return out_s, out_i
        return out_s[:B], out_i[:B], out_s[B:], out_i[B:]
    if q.device.type == "cpu":
        if page_rows is not None:
            return arena_scan_scan_ref(q, emb, meta, gids, preds, k,
                                       _check_page_rows(page_rows),
                                       spec=spec, lex=lex)
        return arena_scan_plain(q, emb, meta, gids, preds, k, spec=spec,
                                lex=lex)
    raise ValueError(f"no arena-scan engine for device {q.device}")
