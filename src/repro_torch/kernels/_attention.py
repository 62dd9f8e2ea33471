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
#: the widths both kernels are built at (``launch_width`` in both C
#: launchers): a head dim runs at the first that holds it
WIDTHS = (16, 32, 64, 128, 192, 256)
#: the widest row a block takes whole: wgmma's N, and so the width of
#: P . V, is at most 256 (and a TMA box at most 256 elements a dimension);
#: a wider row runs as column pieces (`row_pieces`)
ROW_MAX = WIDTHS[-1]
#: the widest column piece of a row past ROW_MAX, by dtype: 128 in bf16
#: (the wgmma body's consumers hold a piece's accumulators; at 256 they
#: spill and ran 2.9x slower at hd 512, PERF.md), 256 in f32 (the scalar
#: body has no such cap, and fewer pieces recompute Q . K^T fewer times)
PIECE_MAX = {torch.float32: 256, torch.bfloat16: 128}
#: a row a tensor map reads in place is a multiple of 8 elements (16 bytes
#: of bf16: TMA's rule for global strides); any other head dim is copied,
#: zero-padded, to the next multiple
ROW_ALIGN = 8
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
                                               i, i, p]
        lib.flash_attention_launch.restype = i
        lib.decode_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                                i, i, i, i, p, p, p, p, p, p,
                                                p, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_tc_launch.argtypes = [p, p, p, p, i, i, i, i,
                                                   i, i, i, i, i, p, p, p, p,
                                                   p, p, p, p]
        lib.decode_attention_tc_launch.restype = i
        lib.decode_attention_tc_info.argtypes = [i, i, p]
        lib.decode_attention_tc_info.restype = i
        lib.decode_attention_blocks_per_sm.argtypes = [i, i, i, i]
        lib.decode_attention_blocks_per_sm.restype = i
        lib.attention_launch_width.argtypes = [i, i]
        lib.attention_launch_width.restype = i
        lib.attention_piece_cols.argtypes = [i, i]
        lib.attention_piece_cols.restype = i
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_rc(lib, rc: int, what: str) -> None:
    """Raise with CUDA's message when a launch returned an error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.attention_error_string(rc).decode())


def launch_width(dtype, hd: int, name: str = "attention") -> tuple[int, bool]:
    """The one head-dim rule of both kernels, for (dtype, hd): (HDP, copy).
    HDP is the width the kernel is built at, the first of WIDTHS that holds
    a piece of the row (`row_pieces`: the whole row, ``hd`` rounded up to
    ROW_ALIGN, up to ROW_MAX); ``copy`` says the wrapper must pass q, k
    and v (q and the caches in decode) as a zero-padded copy of that
    rounded width, since a tensor map cannot read a row that is not a
    multiple of 16 bytes in place. Columns past hd up to HDP come in as
    zeros from the tensor map's out-of-bounds fill, so the scores are the
    true ones; the scale is always 1 / sqrt(hd) of the true hd. Past
    ROW_MAX a row runs as column pieces, each scoring with the whole row
    and writing its own columns. Raises ValueError, naming the rule, for
    an unknown dtype or hd under 1. Both C launchers hold the same rule
    (``attention_launch_width``, ``attention_piece_cols``)."""
    if dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {dtype} not float32 or bfloat16")
    if hd < 1:
        raise ValueError(f"{name}: head_dim {hd} under 1")
    row = padded_head_dim(hd)
    piece, _ = row_pieces(dtype, row)
    return next(w for w in WIDTHS if w >= piece), row != hd


def row_pieces(dtype, hd: int) -> tuple[int, int]:
    """(P, n): a row of ``hd`` columns (rounded up to ROW_ALIGN) as n
    column pieces of P columns, the last one possibly narrower: the whole
    row (n = 1) up to ROW_MAX, else the fewest pieces of at most
    PIECE_MAX[dtype], balanced to multiples of ROW_ALIGN (bf16: 320 = 3 x
    112 at width 128, 512 = 4 x 128; f32: 320 = 2 x 160 at width 192, 512
    = 2 x 256, 1000 = 3 x 256 + 232 at 256). Piece i holds columns
    [i P, min(row, (i + 1) P)). ``attn::piece_cols`` in
    ``csrc/attention.cuh`` is the same rule."""
    row = padded_head_dim(hd)
    if row <= ROW_MAX:
        return row, 1
    n = -(-row // PIECE_MAX[dtype])
    piece = padded_head_dim(-(-row // n))
    return piece, -(-row // piece)


def padded_head_dim(hd: int) -> int:
    """hd rounded up to ROW_ALIGN: the width of the padded copy."""
    return -(-hd // ROW_ALIGN) * ROW_ALIGN


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with its last dimension zero-padded to ``width`` (a copy), or x
    itself when it is that wide already."""
    extra = width - x.shape[-1]
    return x if extra == 0 else torch.nn.functional.pad(x, (0, extra))


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
