"""Flash-attention forward on the card: the CUDA kernel's wrapper, its plain
PyTorch version and an emulator of the kernel's tile schedule.

`flash_attention_cuda` launches ``csrc/flash_attention.cu``, the Hopper
port of the Pallas kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/flash_attention.py:79``): one block per
(q tile, kv head, sequence) holding the tile's 128 rows for all G query
heads, walking the key tiles up to the diagonal with an online softmax in
registers; f32 scores, P and V rounded to bf16 for P . V with f32
accumulation, as the reference kernel. bf16 inputs run a warp-specialised
kernel: TMA loads of K and V into a 3-stage ring of shared memory (2 at
width 256), both products on wgmma; f32 inputs run scalar f32 FMAs. Any
head_dim >= 1 (`_attention.launch_width`: the kernel runs at the first
built width that holds the row, the columns past hd zeros; a head dim that
is not a multiple of 8 goes in as a zero-padded copy; past 256 the row's
column pieces (`_attention.row_pieces`) are blocks of their own, each
scoring with the whole row, streamed in 64-column chunks, and writing its
own columns) and any G (more than 64 heads a KV head split into balanced
chunks on the grid, `head_chunks`). It is bound by operations at the
prefill shape (the source states the bound and the design).

`flash_attention_plain` is the chunked online softmax of the reference's
``models/layers.py:gqa_chunked`` in the kernel's (B, S, KV, G, hd) layout:
f32 Q . K^T, blocks of ``blk_q`` x ``blk_k``, P and V rounded to bf16 for
P . V whose block product is bf16, f32 accumulators. It takes any S (the
last block may be ragged) and skips key blocks wholly above the diagonal,
which contribute exactly nothing. It is the CPU path of ``ops`` and of the
port's ``gqa_chunked``, and the kernel's on-card reference.

`flash_attention_tiled` replays the bf16 kernel's own schedule in plain
PyTorch (the head chunks, 128-row tiles of (position, head) rows, the
launch width's zero columns, `key_tile`-key tiles, the diagonal skip,
edge-only masks, exp2 with the true hd's scale folded in, P rounded to
bf16 with l from the unrounded p; past 256 the column pieces, each scoring
with the whole row), so that the CPU tests check the kernel's algorithm
against the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _attention, _nvcc
from repro_torch.kernels.flash_attention.ref import NEG_INF

#: kernel launches through `flash_attention_cuda` (the main-path audit)
LAUNCHES = 0
#: rows (query position, head) a block of the bf16 kernel
TILE_ROWS = 128
#: keys a tile of the bf16 kernel up to width 128 (``key_tile`` in the
#: source; `key_tile`)
KEY_TILE = 64
#: most query heads a block takes (``kMaxChunk`` in the source)
MAX_CHUNK_HEADS = 64
LOG2E = 1.4426950408889634


def key_tile(width: int) -> int:
    """Keys a tile of the bf16 kernel at a launch width: KEY_TILE, or 32
    past width 128, where a consumer's width / 2 accumulators leave room
    for 32 keys' scores and P only (``key_tile`` in the source)."""
    return 32 if width > 128 else KEY_TILE


def head_chunks(G: int) -> tuple[int, int]:
    """(GC, n_gc): the G query heads of a KV head in n_gc balanced chunks
    of at most MAX_CHUNK_HEADS, chunk c holding heads [c GC, min(G, (c + 1)
    GC)) -- ``chunk_heads`` of the source. Falcon-7B's G 71 is 36 + 35."""
    n_gc = -(-G // MAX_CHUNK_HEADS)
    gc = -(-G // n_gc)
    return gc, -(-G // gc)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          blk_q: int = 1024, blk_k: int = 1024):
    """q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)
    in q's dtype. Causality compares absolute positions (query i sees keys
    j <= i), as the reference does."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    blk_q, blk_k = min(blk_q, Sq), min(blk_k, Sk)
    scale = 1.0 / np.sqrt(hd)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]             # (B,KV,1,hd,Sk)
    vb = v.to(torch.bfloat16).permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,Sk,hd)
    out = torch.empty_like(q)
    dev = q.device
    for q0 in range(0, Sq, blk_q):
        q1 = min(q0 + blk_q, Sq)
        qb = q[:, q0:q1].float().permute(0, 2, 3, 1, 4)          # (B,KV,G,bq,hd)
        bq = q1 - q0
        m = torch.full((B, KV, G, bq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, bq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=dev)
        k_end = min(Sk, q1) if causal else Sk
        qpos = torch.arange(q0, q1, device=dev)
        for k0 in range(0, k_end, blk_k):
            k1 = min(k0 + blk_k, Sk)
            s = torch.matmul(qb, kt[..., k0:k1]) * scale          # (B,KV,G,bq,bk)
            if causal and k1 - 1 > q0:
                keep = qpos[:, None] >= torch.arange(k0, k1, device=dev)[None]
                s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p.to(torch.bfloat16), vb[..., k0:k1, :]).float()
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out


def flash_attention_tiled(q, k, v, *, causal: bool = True):
    """The bf16 kernel's schedule in plain PyTorch, same contract as
    `flash_attention_plain`: rows of hd columns zero-padded to the launch
    width (`_attention.launch_width`), the scale the true hd's; per
    (b, kv) the G heads in the chunks of `head_chunks`, and per chunk
    tiles of TILE_ROWS // GC positions times its heads (rows (position,
    head), (TILE_ROWS // GC) * GC of them in use); per tile the key tiles
    of `key_tile` keys up to the diagonal, zero-padded past S, masked only
    where a tile crosses the diagonal or the end of S; the online softmax
    in the log2 domain, the row max taken on the raw scores and scaled by
    scale * log2(e), p = exp2(s c - m); P rounded to bf16 (RNE) and V to
    bf16 for P . V with f32 products and sums; l summed from the unrounded
    p; o = acc / max(l, 1e-30), its hd columns. Past 256 each column piece
    of the row (`_attention.row_pieces`) is a run of its own: the scores
    over the whole (padded) row, P . V over the piece's columns zero-padded
    to the launch width, the piece's own columns written."""
    B, S, KV, G, hd = q.shape
    hdp, _ = _attention.launch_width(q.dtype, hd, "flash_attention_tiled")
    pw, n_pc = _attention.row_pieces(q.dtype, hd)
    row = _attention.padded_head_dim(hd)
    qk_w = hdp if n_pc == 1 else row
    gc, n_gc = head_chunks(G)
    kp, vp = (_attention.pad_head_dim(t, qk_w) for t in (k, v))
    out = torch.empty(q.shape[:-1] + (row,), dtype=q.dtype, device=q.device)
    for c in range(n_gc):
        heads = slice(c * gc, min(G, (c + 1) * gc))
        qc = _attention.pad_head_dim(q[:, :, :, heads], qk_w)
        for pc in range(n_pc):
            p0 = pc * pw
            cols = min(pw, row - p0)
            out[:, :, :, heads, p0:p0 + cols] = _tiles(
                qc, kp,
                _attention.pad_head_dim(vp[..., p0:p0 + hdp], hdp),
                TILE_ROWS // gc, key_tile(hdp),
                float(np.float32(LOG2E / np.sqrt(hd))), causal)[..., :cols]
    return out[..., :hd]


def _tiles(q, k, v, BQ, kn, scale_log2, causal):
    """One head chunk's tiles of BQ positions and ``kn``-key tiles
    (`flash_attention_tiled`): scores over q's and k's columns, P . V over
    v's."""
    B, S, KV, G, hd = q.shape
    vw = v.shape[-1]
    dev = q.device
    n_keys = -(-S // kn) * kn
    pad = (0, 0, 0, 0, 0, n_keys - S)                       # keys to a tile
    kt = torch.nn.functional.pad(k.float(), pad).permute(0, 2, 3, 1)
    vb = torch.nn.functional.pad(v.to(torch.bfloat16).float(),
                                 pad).permute(0, 2, 1, 3)   # (B,KV,keys,hd)
    out = torch.empty(q.shape[:-1] + (vw,), dtype=q.dtype, device=dev)
    for q0 in range(0, S, BQ):
        n = min(S, q0 + BQ) - q0                            # live positions
        rows = q[:, q0:q0 + n].float().permute(0, 2, 1, 3, 4).reshape(
            B, KV, n * G, hd)                               # row p * G + g
        pos = q0 + torch.arange(n * G, device=dev)[:, None] // G
        m = torch.full((B, KV, n * G, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, n * G, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, n * G, vw), dtype=torch.float32,
                          device=dev)
        n_tiles = (q0 + n - 1) // kn + 1 if causal else n_keys // kn
        for t in range(n_tiles):
            k0 = t * kn
            s = torch.matmul(rows, kt[..., k0:k0 + kn])
            if k0 + kn > S or (causal and k0 + kn - 1 > q0):
                col = torch.arange(k0, k0 + kn, device=dev)[None]
                keep = col < S
                if causal:
                    keep = keep & (col <= pos)
                s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p.to(torch.bfloat16).float(), vb[:, :, k0:k0 + kn])
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + n] = o.reshape(B, KV, n, G, vw).permute(
            0, 2, 1, 3, 4).to(q.dtype)
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch the kernel on the current stream (no sync). q (B, S, KV, G,
    hd), k / v (B, S, KV, hd), all f32 or all bf16, any hd >= 1
    (`_attention.launch_width`; past 256 as column pieces on the grid,
    `_attention.row_pieces`), any G >= 1, any S >= 1; all contiguous on
    one CUDA device. A head dim that is not a multiple of 8 is launched on
    zero-padded copies of q, k and v (the one copy the wrapper makes; the
    output is then a view of the padded one's hd columns). Returns o (B,
    S, KV, G, hd) in q's dtype. Raises on any input it cannot take, and on
    inputs that require grad with grad enabled (forward-only)."""
    global LAUNCHES
    _attention.refuse_grad("flash_attention_cuda", q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError("q must be (B, S, KV, G, hd) and k, v (B, S, KV, hd)")
    B, S, KV, G, hd = q.shape
    dt = q.dtype
    if dt not in _attention.DTYPES:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16, "
                         f"got {dt}")
    _nvcc.check_tensor("q", q, dt, (B, S, KV, G, hd), dev)
    _nvcc.check_tensor("k", k, dt, (B, S, KV, hd), dev)
    _nvcc.check_tensor("v", v, dt, (B, S, KV, hd), dev)
    _, copy = _attention.launch_width(dt, hd, "flash_attention_cuda")
    if min(B, S, KV, G) < 1:
        raise ValueError(f"flash_attention_cuda needs B, S, KV, G >= 1, got "
                         f"B={B} S={S} KV={KV} G={G}")
    gc, n_gc = head_chunks(G)
    n_pc = _attention.row_pieces(dt, hd)[1]
    if (B > 65535 or KV > 65535
            or -(-S // (TILE_ROWS // gc)) * n_gc * n_pc >= 1 << 31
            or B * S * KV * G * _attention.padded_head_dim(hd) >= 1 << 62):
        raise ValueError("shapes past the kernel's grid or index range")
    row = _attention.padded_head_dim(hd)
    if copy:
        q, k, v = (_attention.pad_head_dim(t, row) for t in (q, k, v))
    lib = _attention.load()
    o = torch.empty_like(q)
    with _attention.on_device(dev) as stream:
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _attention.DTYPES[dt], B, S, KV, G, row, hd, int(bool(causal)),
            stream)
    _attention.check_rc(lib, rc, f"flash_attention (B={B} S={S} KV={KV} "
                                 f"G={G} hd={hd} {dt} causal={causal})")
    LAUNCHES += 1
    return o[..., :hd] if copy else o
