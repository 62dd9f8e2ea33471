"""The bf16 flash body's schedule at its wide shapes, held to the reference
(``repro.kernels.flash_attention``) on the CPU.

The body runs in persistent blocks, one an SM, sharing a list of work
units -- a q tile times a chunk of heads of one (kv, b) -- heaviest first
within groups of (kv, b) pairs;
past 64 heads a KV head the chunks are 64 heads and the rest
(`chunk_plan`), so a tile's 128 rows stay full; rows of 72 to 96 columns
run at width 96, and the key tile is 128 at widths 64 to 128, else 64. Its
emulator (`flash_attention_tiled`) goes against the reference's oracle
(``flash_attention_ref``) and the plain version (`flash_attention_plain`)
over G 1 .. 130, hd 64 .. 256 and S 1, ragged and 300, causal and full;
the unit list (`work_units`, and `unit_of`, the closed form the card
computes) covers every (q tile, chunk, kv, b) once, in groups of (kv, b)
pairs (`l2_group`) and in non-increasing work within a group, and the
blocks' rounds (`block_units`) share it out once. Tolerances are
those of ``test_torch_attention.py``: rtol 1e-2, atol 8e-3 (P and V
rounded to bf16 for P . V, as ``test_kernels.py:96-97``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.flash_attention.ref import flash_attention_ref as j_fref
from repro_torch.kernels import _attention
from repro_torch.kernels.flash_attention import flash_attention as fa

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3
PLAN_G = (1, 7, 8, 63, 64, 65, 71, 128, 130)
PLAN_HD = (64, 80, 96, 100, 128, 192, 256)
#: one query position; a last tile ragged for every chunk's q tile (37 is
#: prime) and every key tile; several key tiles of 64 and 128 keys
PLAN_S = (1, 37, 300)
#: the served shapes (S, KV, G, hd, B): lm_serve, moe_serve, Phi-3-mini,
#: Gemma-2B, Falcon-7B
SERVED = ((2048, 8, 4, 128, 8), (2048, 8, 2, 64, 8), (2048, 32, 1, 96, 8),
          (2048, 1, 8, 256, 8), (2048, 1, 71, 64, 8))


def _case(seed, B, S, KV, G, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((B, S, KV, G, hd), (B, S, KV, hd),
                               (B, S, KV, hd)))


def _check_tiled(q, k, v, causal):
    want = np.asarray(j_fref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal))
    args = tuple(torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention_tiled(*args, causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)
    plain = fa.flash_attention_plain(*args, causal=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("G", PLAN_G)
def test_tiled_chunk_plan_matches_reference(G, S, causal):
    """Every G of the chunk plan -- one chunk up to 64, 64 and the rest
    past it (65 = 64 + 1, 71 = 64 + 7, 130 = 64 + 64 + 2) -- at hd 64 and
    at one of the other head dims (widths 96, 128, 192, 256, padded
    100), against the oracle and the plain version."""
    KV = 2 if G == 1 else 1
    for hd in (64, PLAN_HD[1 + PLAN_G.index(G) % (len(PLAN_HD) - 1)]):
        q, k, v = _case(G * 1000 + S + hd, 1, S, KV, G, hd)
        _check_tiled(q, k, v, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", PLAN_HD)
@pytest.mark.parametrize("G", [1, 71])
def test_tiled_widths_match_reference(G, hd, causal):
    """Every head dim (widths 64, 96, 128, 192 and 256; 80 and 96 at width
    96; 100 through the padded copy at 128) at G 1 and 71, S 300."""
    KV = 2 if G == 1 else 1
    q, k, v = _case(G * 7 + hd, 1, 300, KV, G, hd)
    _check_tiled(q, k, v, causal)


def test_width_96_rule():
    """Rows of 72 to 96 columns run at width 96 in place; a row past 256
    never takes 96 for its pieces (bf16 pieces of 88 stay at 128); the key
    tile is 128 at widths 64 to 128, else 64."""
    for dt in (torch.bfloat16, torch.float32):
        for hd in (72, 80, 88, 96):
            assert _attention.launch_width(dt, hd) == (96, False)
        assert _attention.launch_width(dt, 100) == (128, True)
        assert _attention.launch_width(dt, 64) == (64, False)
    assert _attention.row_pieces(torch.bfloat16, 264) == (88, 3)
    assert _attention.launch_width(torch.bfloat16, 264) == (128, False)
    assert [fa.key_tile(w) for w in _attention.WIDTHS] == [
        64, 64, 128, 128, 128, 64, 64]


def _check_units(S, KV, G, hd, B, causal):
    """The unit list covers every (q tile, chunk, kv, b) once, group by
    group of (kv, b) pairs, in non-increasing work within a group, equal
    entry by entry to the closed form, and the persistent blocks' rounds
    share it out once."""
    units = fa.work_units(S, KV, G, hd, B, causal=causal)
    width, _ = _attention.launch_width(torch.bfloat16, hd)
    kn = fa.key_tile(width)
    plan = fa.chunk_plan(G)
    starts = [sum(plan[:c]) for c in range(len(plan))]
    want = {(q0, g0, kv, b)
            for c, gc in enumerate(plan)
            for q0 in range(0, S, fa.TILE_ROWS // gc)
            for kv in range(KV) for b in range(B)
            for g0 in (starts[c],)}
    got = [(u.q0, u.g0, u.kv, u.b) for u in units]
    assert len(got) == len(set(got)) == len(want)
    assert set(got) == want
    assert len(units) == fa.n_units(B, S, KV, G, hd)
    # heaviest first within each group of (kv, b) pairs
    group = fa.l2_group(B, S, KV, hd)
    assert 1 <= group <= KV * B
    per = len(units) // (KV * B)
    for e0 in range(0, KV * B, group):
        size = min(group, KV * B - e0)
        chunk = units[e0 * per:(e0 + size) * per]
        assert {(u.kv + KV * u.b) for u in chunk} == set(
            range(e0, e0 + size))
        work = [u.n_tiles for u in chunk]
        assert work == sorted(work, reverse=True)
    for u in units:
        assert u.bq == fa.TILE_ROWS // u.gc and u.gc == plan[
            starts.index(u.g0)]
        q_end = min(S, u.q0 + u.bq)
        assert u.n_tiles == ((q_end - 1) // kn + 1 if causal
                             else -(-S // kn))
    for i in range(len(units)):
        assert fa.unit_of(i, B, S, KV, G, hd, causal) == units[i]
    for n_blocks in (1, 7, 132):
        n = fa.persistent_blocks(len(units), n_blocks)
        taken = [u for i in range(n)
                 for u in fa.block_units(len(units), n, i)]
        assert sorted(taken) == list(range(len(units)))


def test_l2_groups_at_served_shapes():
    """One group of (kv, b) pairs unless all pairs' K and V pass 128 MB:
    lm_serve's 64 MB, moe_serve's 32, Gemma-2B's 16, Falcon-7B's 4 and
    width 192's 96 in one; Phi-3-mini's 201 MB in groups of 10 pairs,
    GPT-J's 256 in groups of 4."""
    assert [fa.l2_group(8, 2048, KV, hd) for KV, hd in (
        (8, 128), (8, 64), (1, 256), (1, 64), (8, 192), (32, 96),
        (16, 256))] == [64, 64, 8, 8, 64, 10, 4]


@pytest.mark.parametrize("S,KV,G,hd,B", SERVED)
def test_work_units_at_served_shapes(S, KV, G, hd, B):
    """The served prefill shapes' unit lists, causal (the heaviest q tile
    first, the lightest last)."""
    _check_units(S, KV, G, hd, B, True)
    units = fa.work_units(S, KV, G, hd, B)
    assert units[0].q0 + units[0].bq >= S and units[-1].q0 == 0


@settings(max_examples=40, deadline=None)
@given(S=st.integers(1, 200), KV=st.integers(1, 3), G=st.integers(1, 140),
       hd=st.sampled_from(PLAN_HD), B=st.integers(1, 3),
       causal=st.booleans())
def test_work_units_random_shapes(S, KV, G, hd, B, causal):
    """Random small shapes, causal and full."""
    _check_units(S, KV, G, hd, B, causal)


@pytest.mark.parametrize("G", [71, 65, 130, 100])
def test_chunk_plan_fills_tiles(G):
    """Rows in use: at least 98% of the tiles' rows at G 71 (S 2048: 64 +
    7 heads, 128 and 126 rows a tile, against 108 in the balanced 36 +
    35), and every (position, head) row written once by the units' tiles
    -- G 65, 71, 130 at least 98%, 100 (64 + 36: 108 rows) at least 90%."""
    S, KV, B = 2048, 1, 1
    units = fa.work_units(S, KV, G, 64, B)
    written = np.zeros((S, G), np.int32)
    for u in units:
        for r in range(u.bq * u.gc):
            p, g = u.q0 + r // u.gc, u.g0 + r % u.gc
            if p < S:
                written[p, g] += 1
    assert (written == 1).all()
    share = S * G / (len(units) * fa.TILE_ROWS)
    assert share >= (0.90 if G == 100 else 0.98)
    if G == 71:
        old_gc, old_n = fa.head_chunks(G)
        old = S * G / (-(-S // (fa.TILE_ROWS // old_gc)) * old_n
                       * fa.TILE_ROWS)
        assert old < 0.85 < share
