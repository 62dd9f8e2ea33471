"""The attention kernels' library: ``csrc/flash_attention.cu`` and
``csrc/decode_attention.cu`` (with ``csrc/attention.cuh``), built by
`_nvcc.build` at first use into ``src/repro_torch/build/`` and loaded with
``ctypes``. The wrappers in ``kernels/flash_attention/flash_attention.py``
and ``kernels/decode_attention/decode_attention.py`` call it; nothing here
runs at import."""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels import _nvcc

HEADER = os.path.join(_nvcc.CSRC, "attention.cuh")
SOURCES = tuple(os.path.join(_nvcc.CSRC, f) for f in (
    "flash_attention.cu", "decode_attention.cu"))
#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims both kernels are built for (their C launchers refuse any
#: other): every config of the registry and every example's generator
HEAD_DIMS = (16, 32, 64, 128)
#: nvcc's output of the build that made the library, set by `build`
BUILD_LOG = ""

_lib = None


def build() -> str:
    """Compile the attention library unless these sources are built (one
    nvcc per source, all at once, then one link). Returns its path."""
    global BUILD_LOG
    path, log = _nvcc.build("attention", (HEADER,), SOURCES)
    if log:
        BUILD_LOG = log
    return path


def load():
    """The loaded library, its C functions typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                               i, p]
        lib.flash_attention_launch.restype = i
        lib.decode_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                                i, i, p, p, p, p, p, p, p, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_blocks_per_sm.argtypes = [i, i, i, i]
        lib.decode_attention_blocks_per_sm.restype = i
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_rc(lib, rc: int, what: str) -> None:
    """Raise with CUDA's message when a launch returned an error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.attention_error_string(rc).decode())


def check_head_dim(name: str, hd: int) -> None:
    """Raise ValueError, naming the set, for a head dim the kernels are not
    built for."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}, the "
                         "head dims the kernel is built for")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record through a forward-only kernel: its
    output would carry no grad_fn and every gradient through it would be
    lost without a word. Training takes the plain attention math instead
    (`models.layers.attention_full`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only: an input requires grad "
                           "with grad enabled (train through models.layers."
                           "gqa_chunked, or call under torch.no_grad())")


#: the current stream's raw handle without a Stream object (Triton's
#: launcher reads it the same way); the public call where torch lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(device) -> int:
    """The raw handle of ``device``'s current stream."""
    if _raw_stream is not None:
        index = device.index
        return _raw_stream(torch.cuda.current_device() if index is None
                           else index)
    return torch.cuda.current_stream(device).cuda_stream


class on_device:
    """``with on_device(dev) as stream:`` makes ``dev`` (the tensors' CUDA
    device) current for the block and gives the raw handle of its current
    stream. A ctypes launch runs on the thread's current device -- its
    ``cudaFuncSetAttribute`` and its ``<<<>>>`` alike -- so every launch
    of the port sits inside this: on a second card it would otherwise fail
    with an invalid handle or a shared-memory limit, or run on the wrong
    device. When ``dev`` is current already it switches nothing, and it
    is a plain class, not a generator: the decode wrapper paces the host,
    and ``torch.cuda.device`` costs it microseconds a call."""
    __slots__ = ("device", "index", "prev")

    def __init__(self, device):
        self.device = device
        self.index = (torch.cuda.current_device() if device.index is None
                      else device.index)

    def __enter__(self) -> int:
        self.prev = torch.cuda.current_device()
        if self.prev != self.index:
            torch.cuda.set_device(self.index)
        return stream_of(self.device)

    def __exit__(self, *exc) -> None:
        if self.prev != self.index:
            torch.cuda.set_device(self.prev)
