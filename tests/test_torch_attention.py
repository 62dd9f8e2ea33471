"""Parity of the port's two attention kernels' plain versions with the
reference (``repro.kernels.decode_attention`` / ``flash_attention``).

The same numpy inputs go through the reference's oracles (and, on two
shapes each, its Pallas kernels in interpret mode) and through the port's
CPU path, which is each CUDA kernel's plain version: the wrappers take it
only because the tensors lie on the CPU. Each kernel's own schedule is
emulated in plain torch too (`flash_attention_tiled`: 128-row tiles of
(position, head) rows, ragged when G does not divide 128, the chosen key
tile, the diagonal skip, exp2 with the scale folded in, P rounded to bf16
and l from the unrounded p; `decode_attention_tiled`: the kernel's split of
S into chunks and the merge in chunk order) and held to the reference's
oracles over G 1 / 3 / 4 / 8, hd 16 / 32 / 64 / 128 (the other head
dims and G past 64 in ``test_torch_wide_heads.py``), S 1 / 17 / 129 / 300, causal and full, and lengths 0, 1,
random and past S; the decode split at each head dim's own rule. Tolerances: decode is all f32 math
(rtol = atol = 2e-5, as ``test_kernels.py:60``; bf16 outputs rounded once
more, 3e-2); flash rounds P and V to bf16 for P . V (rtol 1e-2, atol 8e-3,
as ``test_kernels.py:96-97``); the port's f32 oracles against the
reference's at 1e-5. The dispatch rules are checked too: a CUDA tensor goes
to the kernel's wrapper and never to the plain version, and the wrappers
refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas
from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fref
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

DEC_TOL = 2e-5
FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3


def _normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _decode_inputs(seed, B, S, KV, G, hd, lengths=None):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, KV * G, hd))
    k = _normal(rng, (B, S, KV, hd))
    v = _normal(rng, (B, S, KV, hd))
    if lengths is None:
        lengths = rng.integers(1, S + 1, B, dtype=np.int32)
    return q, k, v, np.asarray(lengths, np.int32)


# the reference's decode grid (test_kernels.py:44-50) at S <= 512, plus
# ragged S and lengths 0 and past S
DECODE_GRID = [
    (2, 512, 4, 8, 128, None),
    (1, 512, 2, 1, 64, None),
    (4, 512, 8, 4, 128, None),
    (2, 512, 1, 16, 64, None),      # MQA
    (3, 17, 2, 4, 64, [0, 5, 17]),
    (2, 300, 2, 2, 32, [0, 0]),
    (2, 257, 1, 4, 64, [400, 1]),
]


@pytest.mark.parametrize("B,S,KV,G,hd,lengths", DECODE_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference_oracle(B, S, KV, G, hd, lengths,
                                               dtype):
    q, k, v, L = _decode_inputs(S + G, B, S, KV, G, hd, lengths)
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    want = np.asarray(j_dref(jq.reshape(B, KV, G, hd), jk, jv,
                             jnp.asarray(L)))
    acc, m, l = dec_mod.decode_attention_plain(tq.reshape(B, KV, G, hd), tk,
                                               tv, torch.from_numpy(L))
    np.testing.assert_allclose((acc / l).numpy(), want, rtol=DEC_TOL,
                               atol=DEC_TOL)
    got = dec_ops.decode_attention(tq, tk, tv, torch.from_numpy(L), KV)
    assert got.dtype == tq.dtype and got.shape == (B, KV * G, hd)
    tol = DEC_TOL if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want.reshape(B, -1, hd),
                               rtol=tol, atol=tol)
    ported = decode_attention_ref(tq.reshape(B, KV, G, hd), tk, tv,
                                  torch.from_numpy(L))
    np.testing.assert_allclose(ported.numpy(), want, rtol=1e-5, atol=1e-5)


def test_decode_length_zero_is_the_mean_of_v():
    """lengths[b] = 0: every score is NEG_INF, so p = exp(0) = 1 and the
    reference returns the mean of V over the whole cache; so does the port."""
    B, S, KV, G, hd = 2, 40, 2, 2, 32
    q, k, v, L = _decode_inputs(3, B, S, KV, G, hd, [0, 0])
    acc, m, l = dec_mod.decode_attention_plain(
        torch.from_numpy(q).reshape(B, KV, G, hd), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(L))
    assert (m == torch.finfo(torch.float32).min).all()
    assert (l == S).all()
    mean_v = v.mean(axis=1)                                  # (B, KV, hd)
    for g in range(G):
        np.testing.assert_allclose((acc / l)[:, :, g].numpy(), mean_v,
                                   rtol=DEC_TOL, atol=DEC_TOL)
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(L), n_kv=KV, blk_s=8))
    np.testing.assert_allclose((acc / l).reshape(B, -1, hd).numpy(), want,
                               rtol=DEC_TOL, atol=DEC_TOL)


@pytest.mark.parametrize("B,S,KV,G,hd,blk,lengths", [
    (2, 256, 2, 4, 64, 64, [37, 256]),
    (1, 128, 1, 8, 32, 32, [0]),
])
def test_decode_plain_matches_pallas_triple(B, S, KV, G, hd, blk, lengths):
    """The un-normalised (acc, m, l) of the reference kernel in interpret
    mode, its lane-uniform m and l read at lane 0."""
    q, k, v, L = _decode_inputs(11, B, S, KV, G, hd, lengths)
    qg = q.reshape(B, KV, G, hd)
    acc, m, l = decode_attention_pallas(jnp.asarray(qg), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(L),
                                        blk_s=blk, interpret=True)
    ta, tm, tl = dec_mod.decode_attention_plain(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(L))
    assert ta.shape == (B, KV, G, hd) and tm.shape == tl.shape == (B, KV, G, 1)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m)[..., :1],
                               rtol=DEC_TOL, atol=DEC_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l)[..., :1],
                               rtol=DEC_TOL, atol=DEC_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(acc), rtol=DEC_TOL,
                               atol=DEC_TOL)


def _flash_inputs(seed, B, S, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, S, KV * G, hd)), _normal(rng, (B, S, KV, hd)),
            _normal(rng, (B, S, KV, hd)))


# the reference's flash grid (test_kernels.py:80-84) plus ragged S
FLASH_GRID = [
    (2, 256, 2, 4, 64, 64, 64),
    (1, 512, 4, 2, 128, 128, 128),
    (2, 256, 1, 8, 64, 128, 64),    # MQA, rectangular blocks
    (2, 100, 2, 2, 32, 64, 32),     # ragged: S not a multiple of a block
    (1, 1, 2, 4, 64, 512, 512),     # one token
]


@pytest.mark.parametrize("B,S,KV,G,hd,blkq,blkk", FLASH_GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference_oracle(B, S, KV, G, hd, blkq, blkk,
                                              causal):
    q, k, v = _flash_inputs(S + hd, B, S, KV, G, hd)
    want = np.asarray(j_fref(jnp.asarray(q).reshape(B, S, KV, G, hd),
                             jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), KV, causal=causal,
                                 blk_q=blkq, blk_k=blkk)
    assert got.shape == (B, S, KV * G, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.reshape(B, S, -1, hd),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)
    ported = flash_attention_ref(torch.from_numpy(q).reshape(B, S, KV, G, hd),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal)
    np.testing.assert_allclose(ported.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,KV,G,hd,blk,causal", [
    (2, 128, 2, 4, 64, 64, True),
    (1, 128, 1, 2, 32, 32, False),
])
def test_flash_plain_matches_pallas_interpret(B, S, KV, G, hd, blk, causal):
    q, k, v = _flash_inputs(7, B, S, KV, G, hd)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_kv=KV, causal=causal, blk_q=blk, blk_k=blk,
                              interpret=True))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), KV, causal=causal,
                                 blk_q=blk, blk_k=blk)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


def test_flash_plain_in_bf16_keeps_dtype_and_tolerance():
    B, S, KV, G, hd = 1, 96, 2, 2, 64
    q, k, v = _flash_inputs(5, B, S, KV, G, hd)
    jq, tq = _both(q, "bfloat16")
    jk, tk = _both(k, "bfloat16")
    jv, tv = _both(v, "bfloat16")
    want = np.asarray(j_fref(jq.reshape(B, S, KV, G, hd), jk, jv,
                             causal=True).astype(jnp.float32))
    got = fa_ops.flash_attention(tq, tk, tv, KV, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.reshape(B, S, -1, hd),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)


class _CudaClaim:
    """Stands in for a tensor on the card: only its device is read before
    the dispatch hands it to the kernel's wrapper."""
    device = torch.device("cuda")
    dtype = torch.float32
    shape = (2, 4, 8, 16)

    def reshape(self, *shape):
        out = _CudaClaim()
        out.shape = shape
        return out

    def contiguous(self):
        return self


def test_dispatch_sends_cuda_tensors_to_the_kernels(monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    calls = []
    monkeypatch.setattr(fa_mod, "flash_attention_plain", plain)
    monkeypatch.setattr(dec_mod, "decode_attention_plain", plain)
    monkeypatch.setattr(fa_mod, "flash_attention_cuda",
                        lambda q, k, v, causal: calls.append("flash") or q)

    def fake_decode(q, k, v, lengths):
        calls.append("decode")
        one = torch.ones((2, 2, 2, 1))
        return torch.zeros((2, 2, 2, 16)), one, one

    monkeypatch.setattr(dec_mod, "decode_attention_cuda", fake_decode)
    q = _CudaClaim()
    fa_ops.flash_attention(q, q, q, 2, causal=True)
    q.shape = (2, 4, 16)
    dec_ops.decode_attention(q, None, None, None, 2)
    assert calls == ["flash", "decode"]


class _OtherDeviceClaim(_CudaClaim):
    """Stands in for a tensor on a device with no engine (neither the
    card, the CPU nor ``meta``)."""
    device = torch.device("xpu")

    def reshape(self, *shape):
        out = _OtherDeviceClaim()
        out.shape = shape
        return out


def test_wrappers_refuse_cpu_and_other_devices():
    x = torch.zeros((1, 4, 2, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_mod.flash_attention_cuda(x, x[:, :, :, 0], x[:, :, :, 0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        dec_mod.decode_attention_cuda(x[:, 0], x[:, :, :, 0], x[:, :, :, 0],
                                      torch.zeros(1, dtype=torch.int32))
    o = _OtherDeviceClaim()
    o.shape = (1, 4, 4, 32)
    with pytest.raises(ValueError, match="no flash-attention engine"):
        fa_ops.flash_attention(o, o, o, 2)
    o.shape = (1, 4, 32)
    with pytest.raises(ValueError, match="no decode-attention engine"):
        dec_ops.decode_attention(o, o, o, o, 2)
    # meta propagates the kernels' shapes (the launch tools' dry run)
    m = torch.zeros((1, 4, 4, 32), device="meta")
    assert fa_ops.flash_attention(m, m, m, 2).shape == m.shape
    assert dec_ops.decode_attention(m[:, 0], m, m, m[:, 0, 0, 0],
                                    2).shape == m[:, 0].shape


# the kernels' own schedules, emulated in plain torch, against the
# reference's oracles
SCHED_G = (1, 3, 4, 8)
SCHED_HD = (16, 32, 64, 128)
SCHED_S = (1, 17, 129, 300)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SCHED_S)
@pytest.mark.parametrize("hd", SCHED_HD)
@pytest.mark.parametrize("G", SCHED_G)
def test_flash_tile_schedule_matches_reference_oracle(G, hd, S, causal):
    B, KV = 2, 2
    q, k, v = _flash_inputs(G * 1000 + S + hd, B, S, KV, G, hd)
    q5 = q.reshape(B, S, KV, G, hd)
    want = np.asarray(j_fref(jnp.asarray(q5), jnp.asarray(k), jnp.asarray(v),
                             causal=causal))
    got = fa_mod.flash_attention_tiled(torch.from_numpy(q5),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    assert got.shape == q5.shape and got.dtype == torch.float32
    assert fa_mod.TILE_ROWS // G * G <= fa_mod.TILE_ROWS
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("S", SCHED_S)
@pytest.mark.parametrize("hd", SCHED_HD)
@pytest.mark.parametrize("G", SCHED_G)
def test_decode_split_schedule_matches_reference_oracle(G, hd, S):
    """lengths 0 (the mean of V), 1, random and past S in one batch; the
    split is the kernel's own rule on a 132-SM card, so S 129 and 300 merge
    several chunks."""
    B, KV = 4, 2
    rng = np.random.default_rng(G * 1000 + S + hd)
    lengths = [0, 1, int(rng.integers(1, S + 1)), S + 3]
    q, k, v, L = _decode_inputs(G + S + hd, B, S, KV, G, hd, lengths)
    qg = q.reshape(B, KV, G, hd)
    want = np.asarray(j_dref(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(L)))
    split = dec_mod.split_for(B, KV, G, S, 132, hd, 4)
    args = (torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(L))
    acc, m, l = dec_mod.decode_attention_tiled(*args, split)
    np.testing.assert_allclose((acc / l).numpy(), want, rtol=DEC_TOL,
                               atol=DEC_TOL)
    acc_p, m_p, l_p = dec_mod.decode_attention_plain(*args)
    np.testing.assert_allclose(m.numpy(), m_p.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)
    np.testing.assert_allclose(l.numpy(), l_p.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)


def test_decode_split_rule_fills_the_card_once():
    """The serving shape takes 8 chunks of 288 rows (512 blocks for 528
    resident ones on 132 SMs); chunks are whole 32-row sub-tiles, never
    under MIN_SPLIT rows, and their scores fit the block's share."""
    assert dec_mod.split_for(8, 8, 4, 2064, 132, 128, 2) == 288
    for B, KV, G, S in [(1, 1, 1, 1), (1, 1, 32, 100_000), (64, 8, 8, 64),
                        (2, 2, 3, 4096), (8, 8, 4, 32_768)]:
        split = dec_mod.split_for(B, KV, G, S, 132, 128, 2)
        assert split % (dec_mod.SUB_BYTES // (128 * 2)) == 0
        assert split >= dec_mod.MIN_SPLIT
        assert G * split <= max(dec_mod.MAX_SCORES,
                                G * dec_mod.MIN_SPLIT)


def test_decode_split_rounds_every_head_dim_to_whole_subtiles():
    """The kernel loads a sub-tile of SUB_BYTES whole (16 rows at hd 128 in
    f32, 256 at hd 16 in bf16): a chunk is whole sub-tiles at every head
    dim, so no block loads rows past its chunk. gen-25m's decode (B 8, KV
    4, G 2, hd 32, f32, a 62-row cache) is one chunk of one 64-row
    sub-tile; granite FULL's (B 8, KV 8, G 2, hd 64, bf16, 2064 rows) 7
    chunks of five 64-row sub-tiles."""
    assert dec_mod.split_for(8, 4, 2, 62, 132, 32, 4) == 64
    assert dec_mod.split_for(8, 8, 2, 2064, 132, 64, 2) == 320
    for hd, itemsize, rows in [(16, 2, 256), (16, 4, 128), (32, 2, 128),
                               (32, 4, 64), (64, 2, 64), (64, 4, 32),
                               (128, 2, 32), (128, 4, 16)]:
        assert dec_mod.SUB_BYTES // (hd * itemsize) == rows
        for B, KV, G, S in [(1, 1, 1, 1), (8, 4, 2, 62), (2, 2, 3, 4096),
                            (8, 8, 4, 32_768), (1, 2, 32, 100_000)]:
            split = dec_mod.split_for(B, KV, G, S, 132, hd, itemsize)
            assert split % rows == 0 or split == dec_mod.MAX_SCORES // G
            assert split >= dec_mod.MIN_SPLIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,width,copy,pieces", [
    (8, 16, False, 1), (48, 64, False, 1), (80, 96, False, 1),
    (96, 96, False, 1), (256, 256, False, 1), (6, 16, True, 1),
    (100, 128, True, 1), (1, 16, True, 1),
    (264, (192, 128), False, (2, 3)), (512, (256, 128), False, (2, 4)),
    (0, None, None, None)])
def test_head_dims_outside_the_set_raise(hd, width, copy, pieces, dtype):
    """The one head-dim rule of both kernels (`_attention.launch_width`,
    `_attention.row_pieces`): every hd runs at the first built width that
    holds a piece of its row -- in place when a row is a multiple of 8
    elements, else through a zero-padded copy of the next multiple; 80 and
    96 at width 96, 100 (padded to 104) at 128 --,
    the whole row up to 256 and past it column pieces (f32: of at most
    256, 264 = 2 x 136 at width 192, 512 = 2 x 256; bf16: of at most 128,
    264 = 3 x 88, 512 = 4 x 128, at width 128); a head dim under 1 raises
    ValueError naming the rule, in both wrappers' checks, before any build
    or launch."""
    from repro_torch.kernels import _attention
    if width is None:
        with pytest.raises(ValueError, match="under 1"):
            _attention.launch_width(dtype, hd)
        with pytest.raises(ValueError, match="under 1"):
            dec_mod._plan(torch.device("cpu"), dtype, 1, 8, 1, 1, hd)
        return
    if isinstance(width, tuple):
        k = dtype == torch.bfloat16
        width, pieces = width[k], pieces[k]
    assert _attention.launch_width(dtype, hd) == (width, copy)
    assert _attention.row_pieces(dtype, hd)[1] == pieces
    assert _attention.padded_head_dim(hd) % _attention.ROW_ALIGN == 0
    assert (_attention.padded_head_dim(hd) == hd) != copy
    split, heads = dec_mod.block_heads(1, 1, 1, 8, 132, hd, dtype.itemsize)
    assert heads == 1 and split % dec_mod.tile_rows(width,
                                                   dtype.itemsize) == 0


def test_decode_workspace_is_allocated_once():
    """One workspace a (device, B, KV, n_split, G, hd), counters zero."""
    dev = torch.device("cpu")
    dec_mod._WORKSPACE.clear()
    first = dec_mod._workspace(dev, 2, 3, 4, 5, 64)
    again = dec_mod._workspace(dev, 2, 3, 4, 5, 64)
    assert all(a is b for a, b in zip(first, again))
    assert first[0].shape == (2, 3, 4, 5, 64) and first[1].shape == (2, 3, 4, 5)
    assert first[3].dtype == torch.int32 and (first[3] == 0).all()
    dec_mod._workspace(dev, 2, 3, 8, 5, 64)
    assert len(dec_mod._WORKSPACE) == 2
    assert dec_mod.workspace_bytes() == 4 * (2 * 3 * 4 * 5 * 66
                                             + 2 * 3 * 8 * 5 * 66 + 2 * 6)
    dec_mod._WORKSPACE.clear()
