"""Build of the port's CUDA libraries: nvcc by hand into a shared library
with a plain C interface, loaded with ``ctypes`` by each kernel's wrapper,
which checks its arguments with `check_tensor` first.

`build` compiles one library from its sources in ``src/repro_torch/csrc``:
one ``nvcc`` per source, all started together, then one link. The library
is keyed by a hash of its sources and headers and lands in
``src/repro_torch/build/`` (listed in ``.gitignore``), so a second call in
the same checkout finds it built. Nothing here runs at import.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc() -> str:
    """nvcc on PATH, else under the CUDA toolkit PyTorch itself found."""
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc") or (
        CUDA_HOME and shutil.which(os.path.join(CUDA_HOME, "bin", "nvcc")))
    if not found:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from src/repro_torch/csrc with the CUDA toolkit")
    return found


def check_tensor(name, t, dtype, shape, device) -> None:
    """Device, dtype, shape, contiguity and 16-byte alignment of a kernel
    argument, or raise: the C entry points check none of them."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def build(name: str, headers, sources) -> tuple[str, str]:
    """Compile ``lib<name>-<hash>.so`` from ``sources`` (paths; ``headers``
    enter the hash) unless it is built already. Returns (path of the
    library, nvcc's output of the build that made it, kept beside it as
    ``<library>.log``). Raises with nvcc's output when a source does not
    compile or link."""
    h = hashlib.sha256()
    for path in (*headers, *sources):
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        try:
            with open(out + ".log") as f:
                return out, f.read()
        except OSError:
            return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources]
        procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        try:
            logs = [proc.communicate()[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log = "".join(logs)
        failed = [src for src, proc in zip(sources, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([exe, *ARCH, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True, check=False)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"linking lib{name} failed:\n{log}")
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(lib, out)
    return out, log
