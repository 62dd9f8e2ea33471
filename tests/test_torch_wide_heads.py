"""Both attention kernels at every head_dim up to 256 and every query-group
size, held to the reference (``repro.kernels.flash_attention`` /
``decode_attention`` and ``repro.models.transformer``) on the CPU.

The kernels' own schedules, emulated in plain torch
(`flash_attention_tiled`: the head chunks of at most 64, 128-row tiles,
the launch width's zero columns, the true hd's scale; `decode_attention_
tiled`: the same padding, the split, the head blocks and the merge), go
against the reference's oracles over hd 8 / 48 / 80 / 96 / 100 / 192 / 256
and G 1 / 48 / 71 / 130 with ragged S, and at two shapes against the
reference's Pallas kernels in interpret mode. A padded launch's emulated
output equals the unpadded plain version (the scale is the true hd's: the
padded width's would not pass). The decode split is whole sub-tiles of the
padded row at every hd. Model parity: 2-layer TransformerConfigs at
Phi-3-mini's (hd 96, G 1), Gemma-2B's (hd 256, G 8) and Falcon-7B's (hd 64,
G 71) attention shapes on a narrow d_model, the port's prefill and
decode_step against the reference's on the same numpy weights.
Tolerances are those of ``test_torch_attention.py``: flash rtol 1e-2, atol
8e-3 (P and V rounded to bf16 for P . V, as ``test_kernels.py:96-97``);
decode 2e-5 (all f32 math, as ``test_kernels.py:60``); the chunked model
path as ``test_torch_models.py`` (1e-2 / 8e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fref
from repro.models import transformer as jt
from repro_torch.kernels import _attention
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

DEC_TOL = 2e-5
FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3
WIDE_HD = (8, 48, 80, 96, 100, 192, 256)
WIDE_G = (1, 48, 71, 130)


def _normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _kv_of(G):
    """Two KV heads for the narrow groups, one (multi-query) for the wide."""
    return 2 if G == 1 else 1


def _flash_case(seed, B, S, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, S, KV, G, hd)), _normal(rng, (B, S, KV, hd)),
            _normal(rng, (B, S, KV, hd)))


@pytest.mark.parametrize("G", WIDE_G)
@pytest.mark.parametrize("hd", WIDE_HD)
def test_flash_tiled_matches_reference_oracle(hd, G):
    """The bf16 kernel's schedule -- head chunks, padded width, true-hd
    scale -- against the reference's oracle, causal, S ragged to the
    tile (and to the key tile)."""
    B, KV = 1, _kv_of(G)
    S = 67 if G > 1 else 150
    q, k, v = _flash_case(hd * 7 + G, B, S, KV, G, hd)
    want = np.asarray(j_fref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True))
    got = fa_mod.flash_attention_tiled(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=True)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("hd,G", [(96, 1), (256, 8), (80, 71), (100, 3)])
def test_flash_tiled_full_attention_matches_reference_oracle(hd, G):
    """The same schedule without the causal mask (every key tile of S)."""
    B, S, KV = 2, 45, _kv_of(G)
    q, k, v = _flash_case(hd + G, B, S, KV, G, hd)
    want = np.asarray(j_fref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False))
    got = fa_mod.flash_attention_tiled(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("G", WIDE_G)
@pytest.mark.parametrize("hd", WIDE_HD)
def test_decode_tiled_matches_reference_oracle(hd, G):
    """The decode kernel's schedule at its own split and head blocks
    (`block_heads` on a 132-SM card), lengths 0 (the mean of V), 1, random
    and past S in one batch, S ragged to the sub-tile."""
    B, S, KV = 4, 211, _kv_of(G)
    rng = np.random.default_rng(hd * 11 + G)
    lengths = np.asarray([0, 1, int(rng.integers(2, S)), S + 5], np.int32)
    q = _normal(rng, (B, KV, G, hd))
    k, v = _normal(rng, (B, S, KV, hd)), _normal(rng, (B, S, KV, hd))
    want = np.asarray(j_dref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lengths)))
    split, heads = dec_mod.block_heads(B, KV, G, S, 132, hd, 4)
    args = tuple(torch.from_numpy(a) for a in (q, k, v, lengths))
    acc, m, l = dec_mod.decode_attention_tiled(*args, split, heads)
    assert acc.shape == (B, KV, G, hd) and m.shape == l.shape == (B, KV, G, 1)
    np.testing.assert_allclose((acc / l).numpy(), want, rtol=DEC_TOL,
                               atol=DEC_TOL)
    acc_p, m_p, l_p = dec_mod.decode_attention_plain(*args)
    for got, ref in ((m, m_p), (l, l_p), (acc, acc_p)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=DEC_TOL,
                                   atol=DEC_TOL)


@pytest.mark.parametrize("hd,G,heads", [(256, 130, 65), (64, 71, 36),
                                        (100, 48, 16)])
def test_decode_head_blocks_match_reference_oracle(hd, G, heads):
    """The head-chunked schedule (blocks of ``heads`` query heads, each
    reading the cache rows again) gives the unchunked result."""
    B, S, KV = 2, 150, 1
    rng = np.random.default_rng(G + hd)
    lengths = np.asarray([97, 150], np.int32)
    q = _normal(rng, (B, KV, G, hd))
    k, v = _normal(rng, (B, S, KV, hd)), _normal(rng, (B, S, KV, hd))
    want = np.asarray(j_dref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lengths)))
    args = tuple(torch.from_numpy(a) for a in (q, k, v, lengths))
    acc, m, l = dec_mod.decode_attention_tiled(*args, 64, heads)
    np.testing.assert_allclose((acc / l).numpy(), want, rtol=DEC_TOL,
                               atol=DEC_TOL)


def test_decode_blocks_split_heads_only_past_shared_memory():
    """A block takes all G heads of its KV head while their q and scores
    fit its shared memory (the cache read once per chunk); f32 at hd 256
    with 256 heads does not fit, so the heads split into the fewest
    balanced blocks that do."""
    for hd, G, itemsize in [(96, 1, 2), (256, 8, 2), (64, 71, 2),
                            (256, 130, 2), (256, 130, 4), (8, 130, 2)]:
        split, heads = dec_mod.block_heads(8, 1, G, 2064, 132, hd, itemsize)
        assert heads == G
        hdp, _ = _attention.launch_width(torch.float32, hd)
        assert dec_mod.smem_bytes(hdp, heads, split) <= dec_mod.SMEM_LIMIT
    split, heads = dec_mod.block_heads(1, 1, 256, 2064, 132, 256, 4)
    assert heads == 128
    assert dec_mod.smem_bytes(256, heads, split) <= dec_mod.SMEM_LIMIT
    assert dec_mod.smem_bytes(256, 256, dec_mod.tile_rows(256, 4)) \
        > dec_mod.SMEM_LIMIT


@pytest.mark.parametrize("hd", [6, 80, 100, 200])
def test_padded_launch_equals_unpadded_math(hd):
    """A launch at the padded width -- the wrapper's zero-padded copy for
    hd 6 / 100, the tensor maps' zero columns for 80 / 200 -- equals the
    plain version at the true hd, because the scale is the true hd's; the
    same schedule with the padded width's scale would not."""
    rng = np.random.default_rng(hd)
    B, S, KV, G = 2, 40, 2, 3
    q, k, v = (torch.from_numpy(a) for a in _flash_case(hd, B, S, KV, G, hd))
    row = _attention.padded_head_dim(hd)
    hdp, copy = _attention.launch_width(torch.float32, hd)
    assert copy == (row != hd) and hdp >= row
    qp, kp, vp = (_attention.pad_head_dim(t, row) for t in (q, k, v))
    assert qp.shape[-1] == row and (qp[..., hd:] == 0).all()
    want = fa_mod.flash_attention_plain(q, k, v, causal=True)
    got = fa_mod.flash_attention_tiled(qp, kp, vp, causal=True)
    # the emulator on the padded copy scales by 1 / sqrt(row): only its
    # first hd columns at the true hd's scale are the kernel's launch
    got_true = _scaled_tiles(qp, kp, vp, hd)
    np.testing.assert_allclose(got_true.numpy(), want.numpy(),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)
    assert (got_true.shape[-1] == hd)
    if row != hd:
        assert not np.allclose(got[..., :hd].numpy(), want.numpy(),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)

    lengths = torch.tensor([17, 40], dtype=torch.int32)
    qd = torch.from_numpy(_normal(rng, (B, KV, G, hd)))
    acc_p, m_p, l_p = dec_mod.decode_attention_plain(qd, k, v, lengths)
    acc, m, l = dec_mod.decode_attention_tiled(qd, k, v, lengths, 16)
    np.testing.assert_allclose((acc / l).numpy(), (acc_p / l_p).numpy(),
                               rtol=DEC_TOL, atol=DEC_TOL)
    np.testing.assert_allclose(m.numpy(), m_p.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)
    wrong = dec_mod.decode_attention_tiled(
        _attention.pad_head_dim(qd, hdp), _attention.pad_head_dim(k, hdp),
        _attention.pad_head_dim(v, hdp), lengths, 16)
    if hdp != hd:
        assert not np.allclose(wrong[1].numpy(), m_p.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)


def _scaled_tiles(qp, kp, vp, hd):
    """`flash_attention_tiled`'s schedule on padded rows at the true hd's
    scale: the kernel's launch on the wrapper's padded copy."""
    B, S, KV, G, row = qp.shape
    hdp, _ = _attention.launch_width(torch.float32, row)
    gc, n_gc = fa_mod.head_chunks(G)
    out = []
    for c in range(n_gc):
        heads = slice(c * gc, min(G, (c + 1) * gc))
        out.append(fa_mod._tiles(
            _attention.pad_head_dim(qp[:, :, :, heads], hdp),
            _attention.pad_head_dim(kp, hdp), _attention.pad_head_dim(vp, hdp),
            fa_mod.TILE_ROWS // gc, fa_mod.key_tile(hdp),
            float(np.float32(fa_mod.LOG2E / np.sqrt(hd))), True)[..., :hd])
    return torch.cat(out, dim=3)


@pytest.mark.parametrize("B,S,KV,G,hd,blk,causal", [
    (1, 128, 1, 3, 96, 64, True),
    (1, 128, 2, 2, 80, 32, False),
])
def test_flash_tiled_matches_pallas_interpret(B, S, KV, G, hd, blk, causal):
    """The kernel's schedule at hd 96 and 80 (padded to width 128) against
    the reference's Pallas kernel in interpret mode."""
    q, k, v = _flash_case(3 + hd, B, S, KV, G, hd)
    want = np.asarray(j_flash(jnp.asarray(q).reshape(B, S, KV * G, hd),
                              jnp.asarray(k), jnp.asarray(v), n_kv=KV,
                              causal=causal, blk_q=blk, blk_k=blk,
                              interpret=True))
    got = fa_mod.flash_attention_tiled(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.reshape(B, S, KV * G, hd).numpy(), want,
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("B,S,KV,G,hd,blk,lengths", [
    (2, 128, 1, 8, 256, 64, [37, 128]),
    (1, 128, 1, 3, 96, 32, [0]),
])
def test_decode_tiled_matches_pallas_triple(B, S, KV, G, hd, blk, lengths):
    """The un-normalised (acc, m, l) of the decode schedule at hd 256 and
    96 against the reference kernel in interpret mode (its lane-uniform m
    and l read at lane 0)."""
    rng = np.random.default_rng(hd + G)
    q = _normal(rng, (B, KV, G, hd))
    k, v = _normal(rng, (B, S, KV, hd)), _normal(rng, (B, S, KV, hd))
    L = np.asarray(lengths, np.int32)
    acc, m, l = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(L),
                                        blk_s=blk, interpret=True)
    split, heads = dec_mod.block_heads(B, KV, G, S, 132, hd, 4)
    ta, tm, tl = dec_mod.decode_attention_tiled(
        *(torch.from_numpy(a) for a in (q, k, v, L)), split, heads)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m)[..., :1],
                               rtol=DEC_TOL, atol=DEC_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l)[..., :1],
                               rtol=DEC_TOL, atol=DEC_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(acc), rtol=DEC_TOL,
                               atol=DEC_TOL)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_split_is_whole_padded_subtiles_at_every_head_dim(itemsize):
    """At every hd in [1, 2048] the split is whole sub-tiles of the PADDED
    row (`tile_rows` of the launch width -- a piece's, past 256: a power of
    two of rows for each row group, within SUB_BYTES), so no block loads
    rows it does not use; the lanes of a row group cover the width; the
    block fits shared memory, q's row counted at `q_width`."""
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    for hd in range(1, 2049):
        hdp, _ = _attention.launch_width(dt, hd)
        rows = dec_mod.tile_rows(hdp, itemsize)
        lpr, epl = dec_mod.lane_layout(hdp, itemsize)
        assert lpr * epl >= hdp and lpr & (lpr - 1) == 0 and lpr <= 32
        assert epl in (16 // itemsize, 32 // itemsize)
        assert rows * hdp * itemsize <= dec_mod.SUB_BYTES and rows <= 256
        groups = dec_mod.WARPS * 32 // lpr
        assert rows % groups == 0 and (rows // groups) & (rows // groups - 1) \
            == 0
        for B, KV, G, S in [(1, 1, 1, 1), (8, 4, 2, 62), (8, 1, 71, 2064),
                            (2, 1, 130, 300), (8, 8, 4, 32_768)]:
            split, heads = dec_mod.block_heads(B, KV, G, S, 132, hd,
                                               itemsize)
            assert split % rows == 0 and split >= rows
            assert dec_mod.smem_bytes(hdp, heads, split,
                                      dec_mod.q_width(hdp, hd)) \
                <= dec_mod.SMEM_LIMIT
    # the served shapes keep their splits (hd 128 / 64 bf16, hd 32 f32)
    assert dec_mod.split_for(8, 8, 4, 2064, 132, 128, 2) == 288
    assert dec_mod.split_for(8, 8, 2, 2064, 132, 64, 2) == 320
    assert dec_mod.split_for(8, 4, 2, 62, 132, 32, 4) == 64


@pytest.mark.parametrize("G,chunk,n_chunks,rows", [
    (1, 1, 1, 128), (4, 4, 1, 128), (48, 48, 1, 96), (64, 64, 1, 128),
    (71, 36, 2, 108), (128, 64, 2, 128), (130, 44, 3, 88)])
def test_flash_head_chunks(G, chunk, n_chunks, rows):
    """The f32 body's (and the bf16 rows past 256's) balanced chunks of at
    most 64 heads a KV head (Falcon-7B's 71 is 36 + 35: 3 positions x 36 =
    108 rows of a 128-row tile); the bf16 body up to 256 fills its tiles
    instead (`chunk_plan`: 64-head chunks and the rest, 71 = 64 + 7, 128
    and 126 rows); 128-key tiles at widths 64 to 128, 64-key ones
    elsewhere."""
    assert [fa_mod.key_tile(w) for w in (16, 64, 96, 128, 192, 256)] == [
        64, 128, 128, 128, 64, 64]
    assert fa_mod.head_chunks(G) == (chunk, n_chunks)
    assert (fa_mod.TILE_ROWS // chunk) * chunk == rows
    assert chunk * (n_chunks - 1) < G <= chunk * n_chunks
    bf16 = {1: ([1], [128]), 4: ([4], [128]), 48: ([48], [96]),
            64: ([64], [128]), 71: ([64, 7], [128, 126]),
            128: ([64, 64], [128, 128]), 130: ([64, 64, 2], [128] * 3)}
    assert (fa_mod.chunk_plan(G), fa_mod.tile_rows(G)) == bf16[G]


# ---------------------------------------------------------------------------
# the model at public attention shapes, narrow
# ---------------------------------------------------------------------------

#: Phi-3-mini's (hd 96, G 1), Gemma-2B's (hd 256, G 8) and Falcon-7B's (hd
#: 64, G 71) attention shapes on a narrow d_model (head_dim decoupled)
WIDE_CONFIGS = {
    "phi3-mini-shape": dict(n_heads=2, n_kv_heads=2, head_dim=96),
    "gemma-2b-shape": dict(n_heads=8, n_kv_heads=1, head_dim=256),
    "falcon-7b-shape": dict(n_heads=71, n_kv_heads=1, head_dim=64),
}


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("name", sorted(WIDE_CONFIGS))
def test_wide_head_models_match_reference(name, impl):
    """A 2-layer model at each public attention shape: the port's prefill
    and 3 greedy decode_steps against the reference's on the same numpy
    weights (`from_numpy`); the chunked path's prefill is the flash
    kernel's plain version, every decode step the decode kernel's."""
    cfg = jt.TransformerConfig(name=name, n_layers=2, d_model=64, d_ff=128,
                               vocab_size=128, dtype="float32",
                               attn_impl=impl, **WIDE_CONFIGS[name])
    params = jt.init(jax.random.PRNGKey(1), cfg)
    tcfg = tt.TransformerConfig(**dataclasses.asdict(cfg))
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                          device="cpu")
    rtol, atol = (1e-4, 1e-4) if impl == "naive" else (1e-2, 8e-3)
    B, S, L = 2, 20, 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jl, jc = jt.prefill(params, cfg, jnp.asarray(toks), L)
    tl, tc = tt.prefill(model, tcfg, torch.from_numpy(toks), L)
    assert tc["k"].shape == (cfg.n_layers, B, L, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                               atol=atol)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for t in range(3):
        jl, jc = jt.decode_step(params, cfg, jnp.asarray(cur), jc,
                                jnp.int32(S + t))
        tl, tc = tt.decode_step(model, tcfg, torch.from_numpy(cur), tc, S + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                                   atol=atol)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
