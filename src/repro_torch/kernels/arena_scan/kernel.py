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
lists bit for bit.

`arena_scan` is the dispatch every caller uses: CUDA tensors go to the
kernel, CPU tensors to `arena_scan_plain` (resident) or to the streaming
scan at ``blk_n = page_rows`` (paged), and nothing else is taken. There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import operator
import os

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import check_tensor as _check
from repro_torch.kernels.arena_scan.ref import (arena_scan_ref,
                                                arena_scan_scan_ref)
from repro_torch.kernels.arena_scan.stages import ScanSpec

HEADER = os.path.join(_nvcc.CSRC, "arena_scan.cuh")
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
#: nvcc's output of the build this process made (ptxas register and
#: shared-memory report), or "" when the library was already built
BUILD_LOG = ""

_lib = None


def build() -> str:
    """Compile the kernel library if these sources have not been built yet
    (`_nvcc.build`: one nvcc per source, all started together, then one
    link). Returns the path of the shared library."""
    global BUILD_LOG
    path, log = _nvcc.build("arena_scan", (HEADER,), SOURCES)
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
        lib.arena_scan_probe_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                p, p, p, p, p, p, p]
        lib.arena_scan_probe_launch.restype = i
        lib.arena_scan_paged_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                i, p, p, p, p, p, p, p]
        for fn in (lib.arena_scan_fused_paged_launch,
                   lib.arena_scan_both_paged_launch):
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                           p, p, p, p, p, p, p]
        lib.arena_scan_probe_paged_launch.argtypes = [p, p, p, p, p, i, i, i,
                                                      i, i, i, p, p, p, p, p,
                                                      p, p]
        lib.arena_scan_paged_info.argtypes = [i, i, i, i, i, p]
        for fn in (lib.arena_scan_fused_paged_info,
                   lib.arena_scan_both_paged_info):
            fn.argtypes = [i, i, i, i, i, i, i, p]
        lib.arena_scan_probe_paged_info.argtypes = [i, i, i, i, p]
        for fn in (lib.arena_scan_paged_launch,
                   lib.arena_scan_fused_paged_launch,
                   lib.arena_scan_both_paged_launch,
                   lib.arena_scan_probe_paged_launch,
                   lib.arena_scan_paged_info,
                   lib.arena_scan_fused_paged_info,
                   lib.arena_scan_both_paged_info,
                   lib.arena_scan_probe_paged_info):
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
    out_i, buffers, the launch's pointer tuple ending with the stream). The
    caller holds ``buffers`` until the launch is enqueued."""
    tile = page_rows or lib.arena_scan_tile_rows()
    n_tiles = -(-n // tile)
    n_pow2 = 1 << (n_tiles - 1).bit_length()
    cand = rows * n_pow2 * min(k, tile)
    bufs = [torch.empty(cand, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    out_s = torch.empty((rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    return out_s, out_i, bufs, (*(b.data_ptr() for b in bufs),
                                out_s.data_ptr(), out_i.data_ptr(), stream)


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
    Raises on any input it cannot take; the slot-lane spec is
    `arena_scan_probe_cuda`'s."""
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
    if G > 8192:       # the (G, 4) predicate block lives in shared memory
        raise ValueError(f"G={G} predicate groups exceed the kernel's "
                         "shared-memory block (8192)")
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
        if not (1 <= T <= 64 and 1 <= QT <= 64):
            raise ValueError(f"the kernel stages T={T} lanes and QT={QT} "
                             "query terms in shared memory: each in [1, 64]")
    lib = _load()
    out_s, out_i, _bufs, scratch = _scratch(lib, spec.n_lists * B, N, k,
                                            dev, page_rows)
    dense_in = (q.data_ptr(), emb.data_ptr(), meta.data_ptr(),
                gids.data_ptr(), preds.data_ptr())
    paged = () if page_rows is None else (page_rows,)
    if spec.has_lex:
        name = f"arena_scan_{spec.score}{'_paged' * bool(paged)}_launch"
        rc = getattr(lib, name)(*dense_in, terms.data_ptr(),
                                lexnorm.data_ptr(), qterms.data_ptr(),
                                qidf.data_ptr(), B, N, D, G, T, QT, k,
                                *paged, *scratch)
    elif paged:
        rc = lib.arena_scan_paged_launch(*dense_in, B, N, D, G, k, *paged,
                                         *scratch)
    else:
        rc = lib.arena_scan_launch(*dense_in, B, N, D, G, k, *scratch)
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
                          page_rows: int | None = None):
    """Launch the slot-lane (IVF candidate) scan on the current stream (no
    sync). q (B, D) f32; the ARENA's emb (N, D) f32 and packed meta (N, 4)
    int32; cand (P,) int32 arena slots of the candidate rows, in candidate
    order (slots outside [0, N) are dead rows); pred (4,) int32; all
    contiguous on one CUDA device. The kernel reads each candidate's rows
    through its slot; no (P, D) copy is made. ``page_rows`` (an int >= 1)
    takes the paged kernel over pages of that many candidate positions.
    Returns (scores (B, k) f32, arena slots (B, k) int32): ties to the lower
    candidate position, -1 wherever the score is NEG_INF. Raises on any
    input it cannot take."""
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
    if B < 1 or N < 1 or P < 1 or D < 1 or k < 1:
        raise ValueError(f"arena_scan_probe_cuda needs B, N, P, D, k >= 1, "
                         f"got B={B} N={N} P={P} D={D} k={k}")
    if max(B, N, P, k) >= 1 << 31:
        raise ValueError("B, N, P and k must fit in int32")
    lib = _load()
    out_s, out_i, _bufs, scratch = _scratch(lib, B, P, k, dev, page_rows)
    inputs = (q.data_ptr(), emb.data_ptr(), meta.data_ptr(), cand.data_ptr(),
              pred.data_ptr(), B, N, P, D, k)
    if page_rows is None:
        rc = lib.arena_scan_probe_launch(*inputs, *scratch)
    else:
        rc = lib.arena_scan_probe_paged_launch(*inputs, page_rows, *scratch)
    if rc != 0:
        raise RuntimeError(
            f"arena_scan probe kernel launch failed (B={B} N={N} P={P} "
            f"D={D} k={k} page_rows={page_rows}): "
            + lib.arena_scan_error_string(rc).decode())
    if page_rows is not None:
        PAGED_LAUNCHES += 1
    return out_s, out_i


def paged_info(spec: ScanSpec, B: int, N: int, G: int, k: int,
               page_rows: int, T: int = 0, QT: int = 0) -> dict:
    """What a paged launch of these shapes uses on this card (builds the
    kernels if needed): shared memory a block, ring stages, whether the
    running lists live in shared memory, blocks an SM holds, and pages."""
    lib = _load()
    out = (ctypes.c_int * 5)()
    if spec.slot_lane:
        rc = lib.arena_scan_probe_paged_info(B, N, k, page_rows, out)
    elif spec.has_lex:
        rc = getattr(lib, f"arena_scan_{spec.score}_paged_info")(
            B, N, G, T, QT, k, page_rows, out)
    else:
        rc = lib.arena_scan_paged_info(B, N, G, k, page_rows, out)
    if rc != 0:
        raise RuntimeError("paged_info failed: "
                           + lib.arena_scan_error_string(rc).decode())
    return dict(smem_bytes=out[0], stages=out[1],
                run_lists_in_smem=bool(out[2]), blocks_per_sm=out[3],
                pages=out[4])


#: The plain PyTorch version of the resident kernel (the port of
#: `arena_scan_ref`): predicate mask, ``keep[gids]``, `torch.matmul` scores,
#: and a stable descending sort (ties to the lower index). On the card,
#: callers keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
#: False``). The paged kernel's plain version is the streaming scan at
#: ``blk_n = page_rows``, `arena_scan_scan_ref`: one local top-k per page,
#: one merge.
arena_scan_plain = arena_scan_ref


def arena_scan(q, emb, meta, gids, preds, k: int, *,
               spec: ScanSpec = ScanSpec(), lex: tuple | None = None,
               page_rows: int | None = None):
    """The unified scan: the CUDA kernel (resident, or paged with
    ``page_rows``) for tensors on the card, its plain version for tensors
    on the CPU; any other device raises."""
    if q.device.type == "cuda":
        return arena_scan_cuda(q, emb, meta, gids, preds, k, spec=spec,
                               lex=lex, page_rows=page_rows)
    if q.device.type == "cpu":
        if page_rows is not None:
            return arena_scan_scan_ref(q, emb, meta, gids, preds, k,
                                       _check_page_rows(page_rows),
                                       spec=spec, lex=lex)
        return arena_scan_plain(q, emb, meta, gids, preds, k, spec=spec,
                                lex=lex)
    raise ValueError(f"no arena-scan engine for device {q.device}")
