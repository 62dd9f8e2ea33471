"""Flash-decode on the card: the CUDA kernel's wrapper, its plain PyTorch
version and an emulator of the kernel's schedule.

`decode_attention_cuda` launches ``csrc/decode_attention.cu``, the Hopper
port of the Pallas kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention/decode_attention.py:77``): a split-K
flash-decode in ONE launch, one block per (S chunk, kv head, sequence)
streaming its K and V rows through a ring of TMA tile loads, the last block
of each (b, kv) merging the chunks' partial (acc, m, l) by the logsumexp
rule.
Decode is bound by the bytes of the live K and V rows (the source states
the bound and the design). `decode_attention_plain` computes the same
un-normalised triple in plain PyTorch, all in f32; it is the CPU path and
the kernel's on-card reference. `decode_attention_tiled` replays the
kernel's own schedule (the split into chunks, dead chunks skipped, the
merge in chunk order) so that the CPU tests check its algorithm. The
Pallas kernel's (B, KV, G, 128) lane-uniform m and l are (B, KV, G, 1)
here: the lanes were a TPU artefact.

Any head_dim >= 1 (`_attention.launch_width`: the kernel runs at the
first built width that holds the row, the tensor maps filling the columns
past hd with zeros; past 256 the row's column pieces (`_attention.
row_pieces`) are blocks of their own on the grid, each scoring with the
whole row -- K read in column chunks of the launch width -- and
accumulating its own columns of V) and any G: a block stages its heads' q
and scores in shared memory, and only where G heads of that width do not
fit (`block_heads`) do the heads split into chunks on the grid, each
chunk's blocks reading the chunk's cache rows again. A head dim that is not
a multiple of 8 goes in as zero-padded copies of q and BOTH caches, made on
every call: a decode step then copies the whole cache (read and written
once more) before the kernel reads it.

Two bodies share the workspace and the merge (`uses_tc` picks): the SIMT
body above (f32, and rows past 256) scores and accumulates with f32 FMAs;
the tensor-core body (bf16 rows up to 256, at every G: it ran faster than
the SIMT body at each G measured, 1 included) takes a block's query heads
as the rows of wgmma products -- 64 a warpgroup, one or two warpgroups a
block (`tc_plan`) -- and so reads a chunk's K and V rows once for all of
them: S = Q . K^T and O += P . V on the tensor cores with an online
softmax over 64- (32-, past width 128) key tiles, P split into three bf16
terms whose sum is P, so that every product is exact in f32 as the SIMT
body's widened FMAs are. `decode_attention_tc_tiled` replays its schedule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _attention, _nvcc
from repro_torch.kernels.decode_attention.ref import NEG_INF

#: kernel launches through `decode_attention_cuda` (the main-path audit),
#: both bodies
LAUNCHES = 0
#: those of them that launched the tensor-core body (`uses_tc`)
TC_LAUNCHES = 0
#: resident blocks of the SIMT body an SM that its split assumes: those it
#: had at lm_serve's bf16 shape, which it served before the tensor-core body
#: (4 at hd 128, G 4: 47.8 KB of shared memory, 116 registers a thread)
BLOCKS_PER_SM = 4
#: rows of the smallest chunk
MIN_SPLIT = 64
#: bytes of the kernel's ring stage (``kSubBytes``); a sub-tile, which it
#: loads whole, is `tile_rows` rows of it: a chunk is rounded up to whole
#: sub-tiles of its rows
SUB_BYTES = 8192
#: f32 scores a block keeps in shared memory (G x split)
MAX_SCORES = 8192
#: the kernel's warps, ring stages and most heads accumulated at once in
#: P . V (``kWarps``, ``kStages``, ``kGChunkMax``): its shared memory's
#: terms
WARPS, STAGES, G_CHUNK_MAX = 4, 4, 8
#: dynamic shared memory a block may use, less 1 KB for the static
#: ``is_last`` and the alignment slack
SMEM_LIMIT = 227 * 1024 - 1024

#: the tensor-core body (``tc::`` in csrc/decode_attention.cu): query heads
#: a warpgroup (wgmma's M), most warpgroups a block, and the bytes of K and
#: V its ring holds at most (``kWgHeads``, ``kMaxWgs``, ``kRingBytes``)
TC_WG_HEADS, TC_MAX_WGS, TC_RING_BYTES = 64, 2, 65536
#: the tensor-core body's chunks (`tc_plan`): enough that the blocks of all
#: (b, kv, head block) fill TC_BLOCKS_PER_SM an SM once (bytes in flight),
#: but at least TC_MERGE_ROWS cache rows for each 16-byte load of partials
#: a thread of the merging block makes a chunk (the merge runs alone after
#: every other block: at Falcon-7B's 71 heads 33 chunks of 64 rows took
#: 34 us, 11 of 192 17 us on an NVIDIA H100 80GB HBM3 at 700 W), and at
#: least TC_MIN_TILES key tiles
TC_BLOCKS_PER_SM = 2
TC_MERGE_ROWS = 40
TC_MIN_TILES = 2

_SM_COUNT: dict = {}
#: the kernel's workspace by (device, B, KV, n_split, G, hd): partials and
#: counters, allocated once (see `decode_attention_cuda`)
_WORKSPACE: dict = {}
#: a shape's launch plan by (device, dtype, B, S, KV, G, hd): its dtype
#: code, split, workspace pointers and body, checked and sized on first
#: use
_PLANS: dict = {}


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


def lane_layout(hdp: int, itemsize: int) -> tuple[int, int]:
    """(LPR, EPL) of the kernel's ``Tile``: a row of width ``hdp`` over LPR
    lanes (a power of two, at most 32) of EPL elements (one 16-byte
    vector, or two for f32 past width 128). LPR * EPL >= hdp: at width 192
    the last 8 lanes of a row group hold no column."""
    vec = 16 // itemsize
    nvec = hdp // vec
    lpr = min(32, 1 << (nvec - 1).bit_length())
    return lpr, -(-nvec // lpr) * vec


def tile_rows(hdp: int, itemsize: int) -> int:
    """Rows of the kernel's sub-tile at width ``hdp`` (``Tile::TR``): a
    power of two of rows for each of the block's row groups, as many as
    SUB_BYTES holds -- 16 (f32 width 128) to 256 (bf16 width 16) rows;
    16 and 8 at width 192 (6 KB), whose rows do not divide 8 KB."""
    lpr, _ = lane_layout(hdp, itemsize)
    groups = WARPS * (32 // lpr)
    return groups * _pow2_floor(SUB_BYTES // (hdp * itemsize) // groups)


def q_width(hdp: int, hd: int) -> int:
    """q's row in the kernel's shared memory (``q_width``): the launch
    width up to 256, past it the row rounded up to whole column chunks of
    the launch width (512 at hd 512; 384 at hd 320, on width 128 or
    192)."""
    row = _attention.padded_head_dim(hd)
    return hdp if row <= _attention.ROW_MAX else -(-row // hdp) * hdp


def smem_bytes(hdp: int, heads: int, split: int, qw: int | None = None) -> int:
    """The kernel's dynamic shared memory (``smem_bytes``) for blocks of
    ``heads`` query heads and chunks of ``split`` positions: the ring, the
    cross-warp sums, q (rows of ``qw``, `q_width`; ``hdp`` when None) and
    the chunk's f32 scores, the mbarriers."""
    group = 4 if heads <= 4 else G_CHUNK_MAX
    floats = (WARPS * group * hdp + heads * (qw or hdp)
              + -(-heads // 4) * 4 * split)
    return 128 + STAGES * SUB_BYTES + -(-4 * floats // 8) * 8 + 16 * STAGES


def _split(B, KV, G, S, n_sm, hdp, itemsize):
    rnd = tile_rows(hdp, itemsize)
    n_chunks = max(1, n_sm * BLOCKS_PER_SM // (B * KV))
    split = -(-S // n_chunks)
    split = -(-split // rnd) * rnd
    low = -(-MIN_SPLIT // rnd) * rnd
    cap = max(rnd, MAX_SCORES // G // rnd * rnd)
    return min(max(split, low), cap)


def block_heads(B: int, KV: int, G: int, S: int, n_sm: int, hd: int,
                itemsize: int) -> tuple[int, int]:
    """(split, GB): the positions a block covers and the query heads it
    takes. GB = G -- one block reads a chunk's K and V rows once for all G
    heads of its KV head -- unless q and the scores of G heads at the
    launch width do not fit a block's shared memory; then the fewest
    balanced head chunks that fit, each a block of its own (the cache rows
    read again per chunk, from L2 when they are close). The split as in
    `split_for`, for the blocks' heads (and, past 256, the row's column
    pieces, each a block of its own)."""
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    hdp, _ = _attention.launch_width(dt, hd, "decode_attention_cuda")
    n_pc = _attention.row_pieces(dt, hd)[1]
    qw = q_width(hdp, hd)
    for n_hc in range(1, G + 1):
        gb = -(-G // n_hc)
        split = _split(B, KV * n_hc * n_pc, gb, S, n_sm, hdp, itemsize)
        if smem_bytes(hdp, gb, split, qw) <= SMEM_LIMIT:
            return split, gb
    raise ValueError(f"decode_attention_cuda: no block of hd {hd} fits "
                     "shared memory")


def split_for(B: int, KV: int, G: int, S: int, n_sm: int, hd: int,
              itemsize: int) -> int:
    """Positions a block covers: enough chunks that B * KV * chunks fill the
    card's resident blocks about once, rounded up to whole sub-tiles
    (`tile_rows` of the launch width: 8 to 256 rows), so that no block
    loads rows it does not use; no chunk's scores past MAX_SCORES unless
    one sub-tile's do, and within that no chunk under MIN_SPLIT rows."""
    return block_heads(B, KV, G, S, n_sm, hd, itemsize)[0]


def uses_tc(dtype, hd: int) -> bool:
    """Whether `decode_attention_cuda` launches the tensor-core body: bf16
    and a row of at most 256 (one piece), at any G -- it ran faster than
    the SIMT body at every G measured on an NVIDIA H100 80GB HBM3 at
    700 W, 1 included (PERF.md). f32 (the tensor cores' products would
    round its q and caches) and rows past 256 (the column pieces) take the
    SIMT body."""
    return (dtype == torch.bfloat16
            and _attention.padded_head_dim(hd) <= _attention.ROW_MAX)


def tc_key_tile(hdp: int) -> int:
    """Keys a tile of the tensor-core body at width ``hdp`` (``key_tile``):
    64, or 32 past 128, where a thread's hdp / 2 accumulators leave room
    for 16 scores and three P fragments."""
    return 32 if hdp > 128 else 64


def tc_stages(hdp: int) -> int:
    """Ring stages of the tensor-core body (``Layout::kStages``): as many K
    and V tiles as TC_RING_BYTES holds, 2 to 8."""
    tile = hdp * 2 * tc_key_tile(hdp)
    return min(8, max(2, TC_RING_BYTES // (2 * tile)))


def tc_smem_bytes(hdp: int, heads: int) -> int:
    """The tensor-core body's dynamic shared memory at width ``hdp`` for
    blocks of ``heads`` query heads (``Layout::kSmem``): q of 64 heads a
    warpgroup, the ring of K and V tiles, the mbarriers, 1 KB of alignment
    slack."""
    nwg = -(-heads // TC_WG_HEADS)
    q = hdp * 2 * nwg * TC_WG_HEADS
    ring = 2 * tc_stages(hdp) * hdp * 2 * tc_key_tile(hdp)
    return q + ring + 8 * (1 + 3 * tc_stages(hdp)) + 1024


def tc_plan(B: int, KV: int, G: int, S: int, n_sm: int,
            hd: int) -> tuple[int, int]:
    """(split, GB) of the tensor-core body: GB query heads a block, all G
    up to 128 (two warpgroups past 64), else the fewest balanced head
    blocks of at most 128, each reading the chunk's rows again; chunks of
    ``split`` positions, whole key tiles: enough that the blocks of all
    (b, kv, head block) fill TC_BLOCKS_PER_SM an SM once, but no fewer
    rows than TC_MERGE_ROWS for each 16-byte load of partials a thread of
    the merging block makes a chunk (GB x width x 4 bytes over its 128 or
    256 threads), nor than TC_MIN_TILES key tiles. No score array bounds a
    chunk: the softmax runs online."""
    hdp, _ = _attention.launch_width(torch.bfloat16, hd,
                                     "decode_attention_cuda")
    kn = tc_key_tile(hdp)
    n_hc = -(-G // (TC_WG_HEADS * TC_MAX_WGS))
    gb = -(-G // n_hc)
    threads = 128 * -(-gb // TC_WG_HEADS)
    n_chunks = max(1, n_sm * TC_BLOCKS_PER_SM // (B * KV * n_hc))
    rows = max(-(-S // n_chunks), TC_MIN_TILES * kn,
               -(-TC_MERGE_ROWS * gb * hdp // (4 * threads)))
    return -(-rows // kn) * kn, gb


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """q (B, KV, G, hd); caches (B, S, KV, hd); lengths (B,) int32 ->
    UN-normalised (acc (B, KV, G, hd), m (B, KV, G, 1), l (B, KV, G, 1)),
    all f32: position s of sequence b is live when s < lengths[b]; a masked
    score is NEG_INF, so lengths[b] <= 0 gives p = 1 everywhere (the mean of
    V, as the reference) and lengths[b] > S the whole cache."""
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return acc, m, l


def decode_attention_tiled(q, k_cache, v_cache, lengths, split: int,
                           heads: int | None = None, tc: bool = False):
    """The kernel's schedule in plain PyTorch -- with ``tc`` the
    tensor-core body's (`decode_attention_tc_tiled`) --, same contract as
    `decode_attention_plain`: rows zero-padded to the launch width
    (`_attention.launch_width`), the scale the true hd's; the G heads in
    blocks of ``heads`` (all G when None; `block_heads`); S cut in chunks
    of ``split`` positions; a chunk that starts at or past lengths[b] > 0
    is skipped; a live chunk takes (acc, m, l) over its live rows (every
    row, with p = 1, when lengths[b] <= 0); the chunks merge in order by
    m* = max m_i, w_i = exp(m_i - m*), l* = sum w_i l_i, acc* = sum w_i
    acc_i; acc's hd columns are returned. Past 256 each column piece
    (`decode_attention_pieces`) fills its own columns, and m and l are
    piece 0's, as the kernel's piece 0 writes them."""
    if tc:
        return decode_attention_tc_tiled(q, k_cache, v_cache, lengths, split,
                                         heads)
    B, KV, G, hd = q.shape
    pieces = decode_attention_pieces(q, k_cache, v_cache, lengths, split,
                                     heads)
    acc = torch.cat([p[0] for p in pieces], dim=-1)
    return acc[..., :hd], pieces[0][1], pieces[0][2]


def decode_attention_pieces(q, k_cache, v_cache, lengths, split: int,
                            heads: int | None = None):
    """The kernel's blocks of each column piece of the row
    (`_attention.row_pieces`: one piece up to 256), as in
    `decode_attention_tiled`: a list of (acc, m, l) a piece, acc holding
    the piece's own columns (the last piece's up to the padded row). Every
    piece scores with the whole row zero-padded to whole column chunks of
    the launch width, the chunks' partial dot products summed, and
    accumulates only its piece's columns of V (zero-padded to the launch
    width); each keeps its own m and l, which are equal across the pieces
    by construction."""
    B, KV, G, hd = q.shape
    hdp, _ = _attention.launch_width(q.dtype, hd, "decode_attention_tiled")
    pw, n_pc = _attention.row_pieces(q.dtype, hd)
    row, qw = _attention.padded_head_dim(hd), q_width(hdp, hd)
    gb = heads or G
    qp, kp, vp = (_attention.pad_head_dim(t, qw)
                  for t in (q, k_cache, v_cache))
    out = []
    for pc in range(n_pc):
        p0 = pc * pw
        vpc = _attention.pad_head_dim(vp[..., p0:p0 + hdp], hdp)
        parts = [_chunks(qp[:, :, g:g + gb], kp, vpc, lengths, split,
                         1.0 / (hd ** 0.5), hdp)
                 for g in range(0, G, gb)]
        acc, m, l = (torch.cat(t, dim=2) for t in zip(*parts))
        out.append((acc[..., :min(pw, row - p0)], m, l))
    return out


def _chunks(q, k_cache, v_cache, lengths, split, scale, cw):
    """One head block's split and merge (`decode_attention_tiled`): the
    scores summed over the row's column chunks of ``cw``, P . V over
    v_cache's columns."""
    B, KV, G, _ = q.shape
    S, hd = k_cache.shape[1], v_cache.shape[-1]
    qf = q.float()
    acc = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    m_out = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    l_out = torch.empty_like(m_out)
    for b in range(B):
        length = int(lengths[b])
        none_live, length = length <= 0, min(length, S)
        parts = []
        for start in range(0, S, split):
            n = min(split, S - start)
            if not none_live and start >= length:
                continue
            if none_live:
                p = torch.ones((KV, G, n), dtype=torch.float32,
                               device=q.device)
                m = torch.full((KV, G, 1), NEG_INF, dtype=torch.float32,
                               device=q.device)
            else:
                n = min(length - start, n)
                kb = k_cache[b, start:start + n].float()
                s = sum(torch.einsum("kgh,skh->kgs", qf[b, ..., c:c + cw],
                                     kb[..., c:c + cw])
                        for c in range(0, kb.shape[-1], cw)) * scale
                m = s.amax(dim=-1, keepdim=True)
                p = torch.exp(s - m)
            parts.append((torch.einsum("kgs,skh->kgh", p,
                                       v_cache[b, start:start + n].float()),
                          m, p.sum(dim=-1, keepdim=True)))
        m = torch.stack([part[1] for part in parts]).amax(dim=0)
        a = torch.zeros((KV, G, hd), dtype=torch.float32, device=q.device)
        l = torch.zeros((KV, G, 1), dtype=torch.float32, device=q.device)
        for acc_i, m_i, l_i in parts:
            w = torch.exp(m_i - m)
            l = l + l_i * w
            a = a + acc_i * w
        acc[b], m_out[b], l_out[b] = a, m, l
    return acc, m_out, l_out


def split3(p: torch.Tensor):
    """p (f32) as three bf16 tensors hi, mid, lo (the tensor-core body's
    ``split3``): hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
    mid), each rounded to nearest even; hi + mid + lo == p wherever p's
    bits lie at or above bf16's smallest subnormal, 2^-133."""
    hi = p.to(torch.bfloat16)
    r = p - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def decode_attention_tc_tiled(q, k_cache, v_cache, lengths, split: int,
                              heads: int | None = None):
    """The tensor-core body's schedule in plain PyTorch, same contract as
    `decode_attention_plain` (bf16 rows up to 256): rows zero-padded to the
    launch width, the scale the true hd's; the G heads in blocks of
    ``heads`` (all G when None; `tc_plan`), each padded with zero q rows to
    whole warpgroups of 64; S cut in chunks of ``split`` positions, a chunk
    that starts at or past lengths[b] > 0 skipped; in a live chunk an
    online softmax over key tiles of `tc_key_tile` keys in order (keys past
    the live ones masked; every key of the chunk with p = 1 when lengths[b]
    <= 0): the running max m of the raw scores, p = 2^(s c - m c) with c =
    scale * log2(e), l and acc rescaled by 2^((m_old - m) c), and P . V as
    the sum of three f32 products of V with P's bf16 terms (`split3`); the
    chunk's m is the raw max times the scale (NEG_INF with nothing live);
    the chunks merge in order as in `decode_attention_tiled`."""
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    hdp, _ = _attention.launch_width(q.dtype, hd, "decode_attention_tc_tiled")
    scale = 1.0 / (hd ** 0.5)
    c = scale * 1.4426950408889634
    kn = tc_key_tile(hdp)
    gb = heads or G
    qp, kp, vp = (_attention.pad_head_dim(t, hdp).float()
                  for t in (q, k_cache, v_cache))
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KV, G, hdp), **f32)
    m_out = torch.empty((B, KV, G, 1), **f32)
    l_out = torch.empty_like(m_out)
    for g0 in range(0, G, gb):
        gn = min(gb, G - g0)
        rows = -(-gn // TC_WG_HEADS) * TC_WG_HEADS
        qb = torch.zeros((B, KV, rows, hdp), **f32)
        qb[:, :, :gn] = qp[:, :, g0:g0 + gn]
        for b in range(B):
            length = int(lengths[b])
            none_live, length = length <= 0, min(length, S)
            parts = []
            for start in range(0, S, split):
                n = min(split, S - start)
                if not none_live and start >= length:
                    continue
                live = n if none_live else min(length - start, n)
                m = torch.full((KV, rows, 1), NEG_INF, **f32)
                l = torch.zeros((KV, rows, 1), **f32)
                a = torch.zeros((KV, rows, hdp), **f32)
                for k0 in range(0, live, kn):
                    ks = slice(start + k0, start + min(k0 + kn, live))
                    kb, vb = kp[b, ks], vp[b, ks]
                    s = torch.einsum("kgh,skh->kgs", qb[b], kb)
                    if none_live:
                        s = torch.zeros_like(s)
                    mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                    alpha = torch.exp2((m - mn) * c)
                    p = torch.exp2(s * c - mn * c)
                    pv = sum(torch.einsum("kgs,skh->kgh", t.float(), vb)
                             for t in split3(p))
                    a = a * alpha + pv
                    l = l * alpha + p.sum(dim=-1, keepdim=True)
                    m = mn
                parts.append((a[:, :gn], NEG_INF if none_live
                              else m[:, :gn] * scale, l[:, :gn]))
            ms = torch.stack([torch.as_tensor(part[1], **f32).expand(
                KV, gn, 1) for part in parts])
            mx = ms.amax(dim=0)
            a_b = torch.zeros((KV, gn, hdp), **f32)
            l_b = torch.zeros((KV, gn, 1), **f32)
            for (acc_i, _, l_i), m_i in zip(parts, ms):
                w = torch.exp(m_i - mx)
                l_b = l_b + l_i * w
                a_b = a_b + acc_i * w
            acc[b, :, g0:g0 + gn] = a_b
            m_out[b, :, g0:g0 + gn] = mx
            l_out[b, :, g0:g0 + gn] = l_b
    return acc[..., :hd], m_out, l_out


def _sm_count(dev) -> int:
    """The SMs of ``dev``, the tensors' own device (never the current
    one), read once a device."""
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def _workspace(dev, B, KV, n_split, G, hd, n_hc=1, n_pc=1):
    """Partials of width ``hd`` (the launch width), a set a column piece of
    the row (``n_pc``, past 256), and one merge counter a (b, kv, head
    block, piece)."""
    key = (dev, B, KV, n_split, G, hd, n_hc, n_pc)
    ws = _WORKSPACE.get(key)
    if ws is None:
        f32 = dict(dtype=torch.float32, device=dev)
        ws = (torch.empty((B, KV, n_split, n_pc * G, hd), **f32),
              torch.empty((B, KV, n_split, n_pc * G), **f32),
              torch.empty((B, KV, n_split, n_pc * G), **f32),
              torch.zeros((B, KV * n_hc * n_pc), dtype=torch.int32,
                          device=dev))
        _WORKSPACE[key] = ws
    return ws


def workspace_bytes() -> int:
    """Device bytes the kernel's workspaces hold, all keys together."""
    return sum(t.numel() * t.element_size()
               for ws in _WORKSPACE.values() for t in ws)


def _plan(dev, dt, B, S, KV, G, hd):
    """Validate a shape the kernel takes and size its launch: (dtype code,
    split, heads a block, the row width (hd, or its padded copy's), the
    workspace pointers (part_acc, part_m, part_l, counters), the workspace
    itself, which the plan keeps alive, whether the tensor-core body runs
    (`uses_tc`))."""
    if dt not in _attention.DTYPES:
        raise ValueError(f"decode_attention_cuda takes float32 or bfloat16, "
                         f"got {dt}")
    hdp, _ = _attention.launch_width(dt, hd, "decode_attention_cuda")
    row = _attention.padded_head_dim(hd)
    if min(B, S, KV, G) < 1:
        raise ValueError(f"decode_attention_cuda needs B, S, KV, G >= 1, got "
                         f"B={B} S={S} KV={KV} G={G}")
    tc = uses_tc(dt, hd)
    split, gb = (tc_plan(B, KV, G, S, _sm_count(dev), hd) if tc else
                 block_heads(B, KV, G, S, _sm_count(dev), hd, dt.itemsize))
    n_hc = -(-G // gb)
    n_pc = _attention.row_pieces(dt, hd)[1]
    if (B * S * KV * row >= 1 << 62 or KV * n_hc * n_pc > 65535
            or B > 65535
            or B * KV * n_pc * G * hdp * -(-S // split) >= 1 << 62):
        raise ValueError("shapes past the kernel's grid or index range")
    ws = _workspace(dev, B, KV, -(-S // split), G, hdp, n_hc, n_pc)
    return (_attention.DTYPES[dt], split, gb, row,
            tuple(t.data_ptr() for t in ws), ws, tc)


def _cache_rows(name, t, dtype, shape, dev) -> int:
    """Rows from one sequence's start to the next in a (B, S, KV, hd)
    cache: S when it is contiguous, the full length when it is a slice
    along S of a longer contiguous cache (a sequence shard's view). Raises
    on any other layout, device, dtype, shape or alignment."""
    B, S, KV, hd = shape
    st, row = t.stride(), KV * hd
    if t.is_contiguous():
        rows = S
    elif st[1:] == (row, hd, 1) and B == 1:
        rows = S                  # one sequence: its stride is never used
    elif st[1:] == (row, hd, 1) and st[0] % row == 0 and st[0] >= S * row:
        rows = st[0] // row
    else:
        rows = None
    if (t.device != dev or t.dtype != dtype or t.shape != shape
            or t.data_ptr() % 16 or rows is None):
        if rows is None and t.device == dev and t.dtype == dtype \
                and t.shape == shape:
            raise ValueError(f"{name} must be contiguous, or a slice along "
                             "S of a contiguous (B, S, KV, hd) cache")
        _nvcc.check_tensor(name, t, dtype, shape, dev)
        raise ValueError(f"{name} must be 16-byte aligned")
    return rows


def decode_attention_meta(q):
    """The kernel's outputs on the ``meta`` device, allocated as
    `decode_attention_cuda` allocates them (one buffer, three views):
    shape propagation for the launch tools' dry run; no launch, LAUNCHES
    unchanged."""
    B, KV, G, hd = q.shape
    n_acc, n_ml = B * KV * G * hd, B * KV * G
    out = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=q.device)
    ml = (KV * G, G, 1, 1)
    return (out.as_strided((B, KV, G, hd), (KV * G * hd, G * hd, hd, 1)),
            out.as_strided((B, KV, G, 1), ml, n_acc),
            out.as_strided((B, KV, G, 1), ml, n_acc + n_ml))


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the kernel on the current stream (no sync): one launch, which
    also merges the chunks. q (B, KV, G, hd), k_cache / v_cache
    (B, S, KV, hd), all f32 or all bf16, any hd >= 1
    (`_attention.launch_width`; past 256 as column pieces on the grid; one
    that is not a multiple of 8 is launched on zero-padded copies of q and
    of both caches, made on every call), any G >= 1;
    lengths (B,) int32; all on one CUDA device, q and lengths contiguous,
    the caches contiguous or both the same slice along S of longer
    contiguous caches (the kernel's tensor maps take their batch stride,
    so a sequence shard's view is read in place). Returns the
    merged UN-normalised (acc (B, KV, G, hd), m (B, KV, G, 1),
    l (B, KV, G, 1)), f32: views of the one buffer a call allocates. The
    partials and the merge counters live in a workspace kept per (device,
    B, KV, n_split, G, width, head blocks, pieces) and allocated once; it
    assumes ONE stream: two calls of the same shape in flight on two
    streams at once would share it. `uses_tc` picks the body. Raises on
    any input it cannot take, and on inputs that require grad with grad
    enabled (forward-only)."""
    global LAUNCHES, TC_LAUNCHES
    _attention.refuse_grad("decode_attention_cuda", q, k_cache, v_cache)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("q must be (B, KV, G, hd) and the caches "
                         "(B, S, KV, hd)")
    B, KV, G, hd = q.shape
    S = k_cache.shape[1]
    dt = q.dtype
    key = (dev, dt, B, S, KV, G, hd)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan(dev, dt, B, S, KV, G, hd)
    code, split, gb, row, ws, _, tc = plan
    if row != hd:
        q, k_cache, v_cache = (_attention.pad_head_dim(t, row)
                               for t in (q, k_cache, v_cache))
    # device, dtype, shape, contiguity and alignment of each argument, each
    # pointer read once (the host paces a decode call as much as the card);
    # check_tensor names the fault
    kv_shape = (B, S, KV, row)
    s_mem = S
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        # a sequence shard's view, read in place through its batch stride
        s_mem = _cache_rows("k_cache", k_cache, dt, kv_shape, dev)
        if _cache_rows("v_cache", v_cache, dt, kv_shape, dev) != s_mem:
            raise ValueError("k_cache and v_cache must have the same layout")
    ptrs = []
    for name, t, dtype, shape in (("q", q, dt, q.shape),
                                  ("k_cache", k_cache, dt, kv_shape),
                                  ("v_cache", v_cache, dt, kv_shape),
                                  ("lengths", lengths, torch.int32, (B,))):
        ptr = t.data_ptr()
        # the caches' layout was checked above when they are not contiguous
        if (t.device != dev or t.dtype != dtype or t.shape != shape
                or ptr % 16 or not (t.is_contiguous() or shape is kv_shape)):
            _nvcc.check_tensor(name, t, dtype, shape, dev)
        ptrs.append(ptr)
    lib = _attention.load()
    n_acc, n_ml = B * KV * G * row, B * KV * G
    out = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=dev)
    p_out = out.data_ptr()
    with _attention.on_device(dev) as stream:
        if tc:
            rc = lib.decode_attention_tc_launch(
                *ptrs, B, S, s_mem, KV, G, row, hd, split, gb, *ws, p_out,
                p_out + 4 * n_acc, p_out + 4 * (n_acc + n_ml), stream)
        else:
            rc = lib.decode_attention_launch(
                *ptrs, code, B, S, s_mem, KV, G, row, hd, split, gb, *ws,
                p_out, p_out + 4 * n_acc, p_out + 4 * (n_acc + n_ml), stream)
    if rc:
        _attention.check_rc(lib, rc, f"decode_attention (B={B} S={S} "
                                     f"KV={KV} G={G} hd={hd} {dt}, "
                                     f"{'tensor-core' if tc else 'SIMT'} "
                                     "body)")
    LAUNCHES += 1
    TC_LAUNCHES += tc
    # acc, m and l as views of the one buffer (as_strided: the cheapest
    # view on the host, which paces a decode call as much as the card)
    ml = (KV * G, G, 1, 1)
    return (out.as_strided((B, KV, G, hd), (KV * G * row, G * row, row, 1)),
            out.as_strided((B, KV, G, 1), ml, n_acc),
            out.as_strided((B, KV, G, 1), ml, n_acc + n_ml))
