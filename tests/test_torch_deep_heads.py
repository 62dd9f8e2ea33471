"""Both attention kernels past head_dim 256, held to the reference
(``repro.kernels.flash_attention`` / ``decode_attention`` and
``repro.models.transformer``) on the CPU.

Past 256 a row runs as column pieces (`_attention.row_pieces`: of at most
128 columns in bf16, 256 in f32): every piece scores with the whole row
and writes its own columns of the output.
The kernels' schedules with those pieces, emulated in plain torch
(`flash_attention_tiled`, `decode_attention_tiled` and its per-piece
`decode_attention_pieces`), go against the reference's oracles and the
port's plain versions at hd 264 / 320 / 384 / 512 / 1000, f32 and bf16,
G 1 / 4 / 71; the decode pieces' m and l are equal to piece 0's, which the
kernel writes. The rule covers every row up to 2048 with pieces of the
built widths, and the decode planners fit shared memory there. Model
parity: a 2-layer decoder at hd 512 (2 heads x 512, one KV head), the
port's prefill and decode_step against the reference's on the same numpy
weights. Tolerances are those of ``test_torch_wide_heads.py``: flash rtol
1e-2, atol 8e-3 (P and V rounded to bf16 for P . V); decode 2e-5 (all f32
math); the chunked model path 1e-2 / 8e-3, the naive one 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
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
DEEP_HD = (264, 320, 384, 512, 1000)
DEEP_G = (1, 4, 71)
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(seed, dtype, *shapes):
    """Standard normal draws from a numpy seed, in ``dtype``, and the same
    values in f32 numpy (the reference's inputs)."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
          for s in shapes]
    return ts, [t.float().numpy() for t in ts]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("G", DEEP_G)
@pytest.mark.parametrize("hd", DEEP_HD)
def test_flash_tiled_pieces_match_reference_oracle(hd, G, dtype):
    """The flash schedule with the row's column pieces -- each scoring with
    the whole row, P . V over its own columns at the launch width --
    against the reference's oracle and the port's plain version, causal,
    S ragged to the tile and the key tile."""
    B, S, KV = (2, 65, 1) if G < 71 else (1, 40, 1)
    (q, k, v), (qn, kn, vn) = _inputs(hd * 13 + G, dtype, (B, S, KV, G, hd),
                                      (B, S, KV, hd), (B, S, KV, hd))
    width, _ = _attention.launch_width(dtype, hd)
    assert width == 128 if dtype == torch.bfloat16 else width in (192, 256)
    got = fa_mod.flash_attention_tiled(q, k, v, causal=True)
    assert got.shape == q.shape and got.dtype == dtype
    want = np.asarray(j_fref(jnp.asarray(qn), jnp.asarray(kn),
                             jnp.asarray(vn), causal=True))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)
    plain = fa_mod.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("hd", (320, 512))
def test_flash_tiled_pieces_full_attention(hd):
    """The pieces without the causal mask (every key tile of S)."""
    (q, k, v), (qn, kn, vn) = _inputs(hd, torch.float32, (2, 45, 2, 3, hd),
                                      (2, 45, 2, hd), (2, 45, 2, hd))
    want = np.asarray(j_fref(jnp.asarray(qn), jnp.asarray(kn),
                             jnp.asarray(vn), causal=False))
    got = fa_mod.flash_attention_tiled(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("G", DEEP_G)
@pytest.mark.parametrize("hd", DEEP_HD)
def test_decode_tiled_pieces_match_reference_oracle(hd, G, dtype):
    """The decode schedule with the row's column pieces at its own split
    and head blocks (`block_heads` on a 132-SM card), lengths 0 (the mean
    of V) and ragged: (acc / l, m, l) against the reference's oracle and
    the plain version; every piece's m and l equal piece 0's bit for bit
    (the kernel's piece 0 writes them), and the pieces' columns cover the
    row."""
    B, S, KV = 2, 61, 1
    (q, k, v), (qn, kn, vn) = _inputs(hd * 17 + G, dtype, (B, KV, G, hd),
                                      (B, S, KV, hd), (B, S, KV, hd))
    lengths = torch.tensor([0, S - 9], dtype=torch.int32)
    split, heads = dec_mod.block_heads(B, KV, G, S, 132, hd, dtype.itemsize)
    pieces = dec_mod.decode_attention_pieces(q, k, v, lengths, split, heads)
    pw, n_pc = _attention.row_pieces(dtype, hd)
    assert len(pieces) == n_pc >= 2
    assert sum(p[0].shape[-1] for p in pieces) == \
        _attention.padded_head_dim(hd)
    for _, m_i, l_i in pieces[1:]:
        assert torch.equal(m_i, pieces[0][1]) and torch.equal(l_i,
                                                              pieces[0][2])
    acc, m, l = dec_mod.decode_attention_tiled(q, k, v, lengths, split, heads)
    assert acc.shape == (B, KV, G, hd) and m.shape == (B, KV, G, 1)
    want = np.asarray(j_dref(jnp.asarray(qn), jnp.asarray(kn),
                             jnp.asarray(vn), jnp.asarray(lengths.numpy())))
    np.testing.assert_allclose((acc / l).numpy(), want, rtol=DEC_TOL,
                               atol=DEC_TOL)
    acc_p, m_p, l_p = dec_mod.decode_attention_plain(q, k, v, lengths)
    for got, ref in ((m, m_p), (l, l_p), (acc, acc_p)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=DEC_TOL,
                                   atol=DEC_TOL)


def test_rule_pieces_cover_every_row_up_to_2048():
    """At every hd in [1, 2048] the pieces cover the padded row, no piece
    is wider than 256 (past 256: than the dtype's PIECE_MAX) or other than
    a ROW_ALIGN multiple, the launch width is the first built width that
    holds a piece (past 256, of the widths pieces are built at,
    PIECE_WIDTHS), the count is the fewest pieces of at most PIECE_MAX,
    and up to 256 the rule is the whole row at the first built width
    that holds it."""
    for dtype in DTYPES:
        pmax = _attention.PIECE_MAX[dtype]
        for hd in range(1, 2049):
            row = _attention.padded_head_dim(hd)
            pw, n = _attention.row_pieces(dtype, hd)
            width, copy = _attention.launch_width(dtype, hd)
            assert copy == (row != hd)
            assert pw % _attention.ROW_ALIGN == 0 and pw <= 256
            assert (n - 1) * pw < row <= n * pw
            assert width in _attention.WIDTHS and width >= pw
            widths = (_attention.WIDTHS if row <= 256
                      else _attention.PIECE_WIDTHS)
            assert width == min(w for w in widths if w >= pw)
            if row <= 256:
                assert (pw, n) == (row, 1)
            else:
                assert pw <= pmax and n == -(-row // pmax)
                assert width == 128 if pmax == 128 else width in (192, 256)
    with pytest.raises(ValueError, match="under 1"):
        _attention.launch_width(torch.float32, 0)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_planners_fit_shared_memory_past_256(itemsize):
    """Past 256 the row group, sub-tile, head blocks and q's row in shared
    memory (`q_width`: whole column chunks of the launch width) fit a
    block at every hd to 2048, the q rows of a block's heads counted at
    that width; the split is whole sub-tiles."""
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    for hd in range(257, 2049):
        hdp, _ = _attention.launch_width(dt, hd)
        lpr, epl = dec_mod.lane_layout(hdp, itemsize)
        assert lpr * epl >= hdp and lpr <= 32
        rows = dec_mod.tile_rows(hdp, itemsize)
        qw = dec_mod.q_width(hdp, hd)
        assert qw % hdp == 0 and qw >= _attention.padded_head_dim(hd) > qw \
            - hdp
        for B, KV, G, S in [(1, 1, 1, 1), (8, 1, 4, 2064), (2, 1, 71, 300)]:
            split, heads = dec_mod.block_heads(B, KV, G, S, 132, hd,
                                               itemsize)
            assert split % rows == 0 and 1 <= heads <= G
            assert dec_mod.smem_bytes(hdp, heads, split, qw) \
                <= dec_mod.SMEM_LIMIT


def test_decode_workspace_holds_the_pieces():
    """Partials, m and l a piece and a counter a (b, kv, head block,
    piece); one piece is the shape the kernel always took."""
    dev = torch.device("cpu")
    dec_mod._WORKSPACE.clear()
    acc, m, l, counters = dec_mod._workspace(dev, 2, 1, 3, 4, 256, 1, 2)
    assert acc.shape == (2, 1, 3, 8, 256) and m.shape == l.shape == \
        (2, 1, 3, 8)
    assert counters.shape == (2, 2) and (counters == 0).all()
    one = dec_mod._workspace(dev, 2, 1, 3, 4, 256)
    assert one[0].shape == (2, 1, 3, 4, 256)
    dec_mod._WORKSPACE.clear()


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_hd512_decoder_matches_reference(impl):
    """A 2-layer decoder at hd 512 (d_model 1024, 2 query heads x 512, one
    KV head, f32): the port's prefill and 3 greedy decode_steps against
    the reference's on the same numpy weights (`from_numpy`)."""
    cfg = jt.TransformerConfig(name="hd512", n_layers=2, d_model=1024,
                               n_heads=2, n_kv_heads=1, head_dim=512,
                               d_ff=256, vocab_size=128, dtype="float32",
                               attn_impl=impl)
    params = jt.init(jax.random.PRNGKey(2), cfg)
    tcfg = tt.TransformerConfig(**dataclasses.asdict(cfg))
    assert tcfg.hd == 512
    model = tt.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                          device="cpu")
    rtol, atol = (1e-4, 1e-4) if impl == "naive" else (1e-2, 8e-3)
    B, S, L = 2, 20, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jl, jc = jt.prefill(params, cfg, jnp.asarray(toks), L)
    tl, tc = tt.prefill(model, tcfg, torch.from_numpy(toks), L)
    assert tc["k"].shape == (cfg.n_layers, B, L, 1, 512)
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
