"""The decode kernel's tensor-core body, held to the reference
(``repro.kernels.decode_attention``) on the CPU.

The body's schedule, emulated in plain torch (`decode_attention_tc_tiled`:
the chunks, the online softmax over key tiles in order, the heads padded
with zero q rows to whole warpgroups of 64, P split into three bf16 terms
each multiplied by V in f32), goes against the reference's oracle and the
port's plain version over G 1 .. 200, hd 16 / 64 / 96 / 128 / 256 and
lengths 0 (the mean of V), 1, a partial key tile, S and past S in one
batch, on bf16 inputs (the body takes bf16 only) widened to f32 for the
oracle. The three-term split reproduces every f32 p in [0, 1] whose bits
lie at or above bf16's smallest subnormal, and the body's planner
(`tc_plan`, `uses_tc`) fits every bf16 shape of widths 16 .. 256 and G up
to 256 in a block's shared memory and leaves f32 and rows past 256 to the
SIMT body. Tolerance: rtol = atol = 2e-5, as ``test_kernels.py:60`` (all
products exact in f32, the sums in another order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro_torch.kernels import _attention
from repro_torch.kernels.decode_attention import decode_attention as dec_mod

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

DEC_TOL = 2e-5
TC_G = (1, 2, 4, 7, 8, 9, 16, 48, 71, 72, 128, 200)
TC_HD = (16, 64, 96, 128, 256)
SMEM_MAX = 232448  # a block's shared memory on the card (227 KB)
BF16_SUB = 2.0 ** -133  # bf16's smallest subnormal


def _split_sum(p: float) -> tuple[float, float]:
    """(hi + mid + lo summed in f32, p) for one f32 value."""
    t = torch.tensor([p], dtype=torch.float32)
    hi, mid, lo = dec_mod.split3(t)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    return float(hi.float() + mid.float() + lo.float()), float(t)


def _next_to_ties():
    """f32 values one f32 step either side of a bf16 rounding tie, and the
    ties themselves, in [0, 1]."""
    def build(bits, side):
        tie = np.uint32((bits << 16) | 0x8000).view(np.float32)
        return float(np.nextafter(tie, np.float32(side * 2.0),
                                  dtype=np.float32)) if side else float(tie)
    return st.builds(build, st.integers(0, 0x3F7F),
                     st.sampled_from((-1, 0, 1)))


@settings(max_examples=400, deadline=None)
@given(st.one_of(st.floats(0.0, 1.0, width=32, allow_subnormal=True),
                 _next_to_ties()))
@example(1.0)
@example(0.0)
@example(2.0 ** -149)
@example(2.0 ** -126)
@example(2.0 ** -110)
@example(float(np.float32(1.0) - np.float32(2.0 ** -24)))
def test_three_bf16_terms_sum_to_p(p):
    """hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid): the sum is
    p bit for bit whenever p is a multiple of 2^-133 (every p >= 2^-110,
    1.0, values beside bf16's ties; the residues are exact in f32 and 3 x 8
    significand bits cover f32's 24), and within 2^-134 of it otherwise
    (bits under bf16's smallest subnormal: a weight of at most 2^-110 beside
    a chunk's largest, 1)."""
    got, p = _split_sum(p)
    if math.floor(p / BF16_SUB) == p / BF16_SUB:
        assert got == p
    else:
        assert abs(got - p) <= BF16_SUB / 2


def _tc_inputs(seed, B, S, KV, G, hd):
    """bf16-valued q (B, KV, G, hd) and caches (B, S, KV, hd), as numpy f32
    (the values the oracle sees) and torch bf16 (the body's inputs)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return [t.float().numpy() for t in ts], ts


@pytest.mark.parametrize("hd", TC_HD)
@pytest.mark.parametrize("G", TC_G)
def test_tc_schedule_matches_oracle_and_plain(G, hd):
    """The tensor-core body's schedule at the planner's head blocks on a
    132-SM card (G 200 in two blocks of 100 heads) and chunks of two key
    tiles (several chunks, a ragged last tile) against the
    reference's oracle (the normalised output) and the plain version (m and
    l), lengths 0, 1, 37, S and S + 3 in one batch."""
    B, S, KV = 5, 150, 1 if G > 16 else 2
    (qn, kn, vn), (q, k, v) = _tc_inputs(G * 7 + hd, B, S, KV, G, hd)
    L = np.asarray([0, 1, 37, S, S + 3], np.int32)
    kt = dec_mod.tc_key_tile(_attention.launch_width(torch.bfloat16, hd)[0])
    heads = dec_mod.tc_plan(B, KV, G, S, 132, hd)[1]
    acc, m, l = dec_mod.decode_attention_tiled(q, k, v, torch.from_numpy(L),
                                               2 * kt, heads, tc=True)
    assert acc.shape == (B, KV, G, hd) and acc.dtype == torch.float32
    want = np.asarray(j_dref(jnp.asarray(qn), jnp.asarray(kn),
                             jnp.asarray(vn), jnp.asarray(L)))
    np.testing.assert_allclose((acc / l).numpy(), want, rtol=DEC_TOL,
                               atol=DEC_TOL)
    acc_p, m_p, l_p = dec_mod.decode_attention_plain(q, k, v,
                                                     torch.from_numpy(L))
    np.testing.assert_allclose((acc / l).numpy(), (acc_p / l_p).numpy(),
                               rtol=DEC_TOL, atol=DEC_TOL)
    np.testing.assert_allclose(m.numpy(), m_p.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)
    np.testing.assert_allclose(l.numpy(), l_p.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)
    assert (m[0] == dec_mod.NEG_INF).all() and (l[0] == S).all()


@pytest.mark.parametrize("hd", (16, 64, 128, 256))
def test_tc_schedule_one_chunk_and_tile_edges(hd):
    """One chunk of the whole cache (split >= S) and chunks of one key tile,
    at lengths on both sides of a tile's edge: the same outputs as the
    plain version either way."""
    B, S, KV, G = 4, 130, 2, 8
    kt = dec_mod.tc_key_tile(_attention.launch_width(torch.bfloat16, hd)[0])
    _, (q, k, v) = _tc_inputs(hd, B, S, KV, G, hd)
    L = torch.tensor([kt - 1, kt, kt + 1, 2 * kt], dtype=torch.int32)
    acc_p, m_p, l_p = dec_mod.decode_attention_plain(q, k, v, L)
    for split in (kt, 256):
        acc, m, l = dec_mod.decode_attention_tiled(q, k, v, L, split,
                                                   tc=True)
        np.testing.assert_allclose((acc / l).numpy(), (acc_p / l_p).numpy(),
                                   rtol=DEC_TOL, atol=DEC_TOL)
        np.testing.assert_allclose(m.numpy(), m_p.numpy(), rtol=DEC_TOL,
                                   atol=DEC_TOL)
        np.testing.assert_allclose(l.numpy(), l_p.numpy(), rtol=DEC_TOL,
                                   atol=DEC_TOL)


def test_tc_planner_fits_every_bf16_shape():
    """Every bf16 row of 8 .. 256 (widths 16 .. 256) at every G up to 256:
    blocks of at most 128 heads, balanced, two warpgroups past 64, whose
    shared memory fits a block's 227 KB; chunks of whole key tiles, never
    under TC_MIN_TILES of them, covering S."""
    for hd in range(8, 257, 8):
        hdp = _attention.launch_width(torch.bfloat16, hd)[0]
        kt = dec_mod.tc_key_tile(hdp)
        for G in range(1, 257):
            for B, KV, S in ((8, 1, 2064), (1, 4, 524_288), (2, 8, 17)):
                split, gb = dec_mod.tc_plan(B, KV, G, S, 132, hd)
                n_hc = -(-G // gb)
                assert gb <= 128 and n_hc == -(-G // 128)
                assert gb * n_hc - G < n_hc
                assert dec_mod.tc_smem_bytes(hdp, gb) <= SMEM_MAX
                assert split % kt == 0
                assert split >= dec_mod.TC_MIN_TILES * kt
    assert dec_mod.tc_smem_bytes(256, 128) == (256 * 2 * 128 + 2 * 2 * 256
                                               * 2 * 32 + 8 * 7 + 1024)


@pytest.mark.parametrize("dtype,hd,G,body", [
    (torch.bfloat16, 64, 71, True), (torch.bfloat16, 256, 8, True),
    (torch.bfloat16, 128, 8, True), (torch.bfloat16, 100, 8, True),
    (torch.bfloat16, 16, 128, True), (torch.bfloat16, 96, 1, True),
    (torch.bfloat16, 128, 4, True), (torch.bfloat16, 512, 4, False),
    (torch.bfloat16, 264, 71, False), (torch.float32, 64, 71, False),
    (torch.float32, 128, 8, False)])
def test_tc_body_choice(dtype, hd, G, body):
    """bf16 rows up to 256 take the tensor-core body at every G (Falcon-7B's
    G 71, Gemma-2B's and yi-6b's G 8, Phi-3-mini's G 1); f32 and rows past
    256 (the column pieces) keep the SIMT body, whose planner
    (`block_heads`, `split_for`) is unchanged."""
    assert dec_mod.uses_tc(dtype, hd) is body
    if body:
        split, heads = dec_mod.tc_plan(8, 1, G, 2064, 132, hd)
        assert heads <= 2 * dec_mod.TC_WG_HEADS and split % \
            dec_mod.tc_key_tile(_attention.launch_width(dtype, hd)[0]) == 0
