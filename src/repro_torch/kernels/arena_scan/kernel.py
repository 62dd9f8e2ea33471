"""The unified arena scan on the card: the CUDA kernel's wrapper and its
plain PyTorch version.

`arena_scan_cuda` launches ``csrc/arena_scan.cu`` (the Hopper port of the
Pallas kernel ``arena_scan_pallas``, resident regime, dense spec --
``src/repro/kernels/arena_scan/kernel.py:97,171``; its header states the
design and its bound). The library is built with ``nvcc`` at first use,
from the sources in the package only, into ``src/repro_torch/build/``
(listed in ``.gitignore``), and loaded with ``ctypes``.

`arena_scan` is the dispatch every caller uses: CUDA tensors go to the
kernel, CPU tensors to `arena_scan_plain`, and nothing else is taken.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from repro_torch.kernels.arena_scan.ref import arena_scan_ref
from repro_torch.kernels.arena_scan.stages import ScanSpec

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "arena_scan.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches through `arena_scan_cuda` (the main-path audit)
LAUNCHES = 0
#: nvcc's output of the build this process made (ptxas register and
#: shared-memory report), or "" when the library was already built
BUILD_LOG = ""

_lib = None


def _nvcc() -> str:
    """nvcc on PATH, else under the CUDA toolkit PyTorch itself found."""
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc") or (
        CUDA_HOME and shutil.which(os.path.join(CUDA_HOME, "bin", "nvcc")))
    if not found:
        raise RuntimeError("nvcc not found: the arena-scan kernel is built "
                           "from csrc/arena_scan.cu with the CUDA toolkit")
    return found


def build() -> str:
    """Compile the kernel library if this source has not been built yet.
    Returns the path of the shared library."""
    global BUILD_LOG
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libarena_scan-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, check=False)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.arena_scan_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                          p, p, p, p, p, p, p]
        lib.arena_scan_launch.restype = i
        lib.arena_scan_error_string.argtypes = [i]
        lib.arena_scan_error_string.restype = ctypes.c_char_p
        lib.arena_scan_tile_rows.argtypes = []
        lib.arena_scan_tile_rows.restype = i
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def arena_scan_cuda(q, emb, meta, gids, preds, k: int):
    """Launch the CUDA arena scan on the current stream (no sync). q (B, D)
    f32; emb (N, D) f32; meta (N, 4) int32; gids (B,) int32; preds (G, 4)
    int32; all contiguous on one CUDA device. Returns (scores (B, k) f32,
    slots (B, k) int32). Raises on any input it cannot take."""
    global LAUNCHES
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"arena_scan_cuda needs CUDA tensors, got {dev}")
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
    lib = _load()
    tile = lib.arena_scan_tile_rows()
    n_tiles = -(-N // tile)
    n_pow2 = 1 << (n_tiles - 1).bit_length()
    cand = B * n_pow2 * min(k, tile)
    s0 = torch.empty(cand, dtype=torch.float32, device=dev)
    i0 = torch.empty(cand, dtype=torch.int32, device=dev)
    s1 = torch.empty(cand, dtype=torch.float32, device=dev)
    i1 = torch.empty(cand, dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.arena_scan_launch(
        q.data_ptr(), emb.data_ptr(), meta.data_ptr(), gids.data_ptr(),
        preds.data_ptr(), B, N, D, G, k, s0.data_ptr(), i0.data_ptr(),
        s1.data_ptr(), i1.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError("arena_scan kernel launch failed: "
                           + lib.arena_scan_error_string(rc).decode())
    LAUNCHES += 1
    return out_s, out_i


#: The plain PyTorch version of the kernel (the port of `arena_scan_ref`):
#: predicate mask, ``keep[gids]``, `torch.matmul` scores, and a stable
#: descending sort (ties to the lower index). On the card, callers keep
#: TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``).
arena_scan_plain = arena_scan_ref


def arena_scan(q, emb, meta, gids, preds, k: int, *,
               spec: ScanSpec = ScanSpec()):
    """The unified scan: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU; any other device raises."""
    if q.device.type == "cuda":
        return arena_scan_cuda(q, emb, meta, gids, preds, k)
    if q.device.type == "cpu":
        return arena_scan_plain(q, emb, meta, gids, preds, k, spec=spec)
    raise ValueError(f"no arena-scan engine for device {q.device}")
