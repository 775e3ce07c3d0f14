"""Decode attention in the PyTorch port, dense and paged: the wrappers' CPU
path (the clamps, then the plain versions) against the JAX oracles
(``decode_attention_ref``, ``paged_decode_attention_ref``) and against the
JAX wrappers running their Pallas kernels in interpret mode, on the same
numpy inputs. The CUDA kernel itself is held against the plain versions in
tests/test_torch_cuda.py (card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jax_ops
from repro.kernels.decode_attention.ref import decode_attention_ref, paged_decode_attention_ref
from repro.models.attention import densify_pages as jax_densify
from repro_torch.kernels.decode_attention import ops

# fp32 on both sides; the reference's own decode tests hold its kernel to
# its oracle at 2e-5 (tests/test_kernels.py), and the two frameworks' sums
# differ by a few ulps of O(1) outputs
TOL = 2e-5

# B, H, Hkv, hd, Skv, rolling, softcap, kv_len
DENSE_CASES = [
    pytest.param((2, 4, 4, 32, 96, False, None, [1, 96]), id="G1-linear"),
    pytest.param((2, 12, 2, 32, 130, False, None, [17, 129]), id="G6-linear-ragged"),
    pytest.param((1, 16, 1, 64, 80, True, None, [80 + 37]), id="G16-rolling-wrapped"),
    pytest.param((2, 12, 2, 32, 64, False, 30.0, [64 + 50, 5]), id="G6-softcap-past-Skv"),
    pytest.param((3, 16, 1, 32, 48, True, 20.0, [3, 48, 48 + 64]), id="G16-rolling-softcap"),
]


def _dense_inputs(case, seed=0):
    B, H, Hkv, hd, Skv = case[:5]
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((B, H, hd), dtype=np.float32)
    k = rs.standard_normal((B, Skv, Hkv, hd), dtype=np.float32)
    v = rs.standard_normal((B, Skv, Hkv, hd), dtype=np.float32)
    return q, k, v, np.asarray(case[7], np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_plain_matches_oracle(case):
    q, k, v, kv_len = _dense_inputs(case)
    rolling, softcap = case[5:7]
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
                               rolling=rolling, softcap=softcap)
    out = ops.decode_attention_plain(*_t(q, k, v, kv_len), rolling=rolling, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_wrapper_matches_pallas_interpret(case):
    q, k, v, kv_len = _dense_inputs(case, seed=1)
    rolling, softcap = case[5:7]
    ref = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
                                   rolling=rolling, softcap=softcap, bk=128, interpret=True)
    before = ops.decode_attention.launches
    out = ops.decode_attention(*_t(q, k, v, kv_len), rolling=rolling, softcap=softcap)
    assert ops.decode_attention.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_dense_wrapper_takes_a_scalar_kv_len():
    q, k, v, _ = _dense_inputs(DENSE_CASES[1].values[0], seed=2)
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 40)
    out = ops.decode_attention(*_t(q, k, v), 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


# B, Hkv, G, hd, P, ps, NP, rolling, softcap, kv_len
PAGED_CASES = [
    pytest.param((2, 2, 6, 32, 16, 8, 4, False, None, [32, 13]), id="G6-full-and-partial-page"),
    pytest.param((3, 1, 16, 32, 24, 4, 5, True, None, [20, 20 + 7, 2]), id="G16-rolling-wrapped"),
    pytest.param((2, 4, 1, 16, 20, 8, 3, False, 30.0, [24 + 40, 1]), id="G1-softcap-past-capacity"),
    pytest.param((1, 2, 6, 64, 8, 16, 3, True, 25.0, [40]), id="G6-rolling-softcap"),
]


def _paged_inputs(case, seed=0):
    B, Hkv, G, hd, P, ps, NP = case[:7]
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((B, Hkv * G, hd), dtype=np.float32)
    k = rs.standard_normal((P, ps, Hkv, hd), dtype=np.float32)
    v = rs.standard_normal((P, ps, Hkv, hd), dtype=np.float32)
    pt = rs.permutation(P)[: B * NP].reshape(B, NP).astype(np.int32)  # disjoint, out of order
    return q, k, v, pt, np.asarray(case[9], np.int32)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_oracle(case):
    q, k, v, pt, kv_len = _paged_inputs(case)
    rolling, softcap = case[7:9]
    ref = paged_decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, pt, kv_len)),
                                     rolling=rolling, softcap=softcap)
    out = ops.paged_decode_attention_plain(*_t(q, k, v, pt, kv_len), rolling=rolling, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_wrapper_matches_pallas_interpret(case):
    q, k, v, pt, kv_len = _paged_inputs(case, seed=1)
    rolling, softcap = case[7:9]
    ref = jax_ops.paged_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pt, kv_len)),
                                         rolling=rolling, softcap=softcap, interpret=True)
    before = ops.paged_decode_attention.launches
    out = ops.paged_decode_attention(*_t(q, k, v, pt, kv_len), rolling=rolling, softcap=softcap)
    assert ops.paged_decode_attention.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_paged_tail_clamp_matches_the_reference_wrapper():
    """Table entries past a slot's last occupied page (here -1 and past the
    pool) are never followed: the port's clamp gives the reference
    wrapper's table, and both wrappers the same output."""
    case = PAGED_CASES[0].values[0]
    q, k, v, pt, _ = _paged_inputs(case, seed=3)
    P, ps = case[4], case[5]
    kv_len = np.asarray([2 * ps - 3, ps], np.int32)  # 2 pages and 1 page occupied
    pt[0, 2:] = -1
    pt[1, 1:] = [P + 5, 10**6, -7]
    clamped = ops.clamp_page_table(torch.from_numpy(pt), torch.from_numpy(kv_len), P, ps)
    assert clamped.tolist() == [[pt[0, 0], pt[0, 1], pt[0, 1], pt[0, 1]], [pt[1, 0]] * 4]
    ref = jax_ops.paged_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pt, kv_len)), interpret=True)
    out = ops.paged_decode_attention(*_t(q, k, v, pt, kv_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_densify_pages_matches_reference_bitwise():
    q, k, v, pt, _ = _paged_inputs(PAGED_CASES[1].values[0], seed=4)
    np.testing.assert_array_equal(ops.densify_pages(torch.from_numpy(k), torch.from_numpy(pt)).numpy(),
                                  np.asarray(jax_densify(jnp.asarray(k), jnp.asarray(pt))))


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 4, 64, device="meta")
    k = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.paged_decode_attention(q, k, k, torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                                   torch.ones(1, dtype=torch.int32, device="meta"))


# resident blocks of the decode kernel in clusters of 1..8 splits, as CUDA's
# cluster occupancy reported them on an NVIDIA H100 80GB HBM3 (132 SMs) at
# two and at one block per SM
H100_RESIDENT = {2: (264, 264, 237, 248, 235, 234, 224, 240), 1: (132, 132, 117, 120, 110, 102, 105, 120)}


def _resident(n_sms: int, per_sm: int) -> tuple[int, ...]:
    """A card whose clusters of s pack its n_sms · per_sm slots perfectly."""
    return tuple(n_sms * per_sm // s * s for s in range(1, 9))


@pytest.mark.parametrize("n_sms", [132, 114, 1])
@pytest.mark.parametrize("B,Hkv,cap", [(2, 8, 1040), (8, 8, 32768), (2, 1, 2048), (1, 1, 1), (64, 8, 100),
                                        (1, 1, 1 << 20)])
def test_split_plan_covers_the_cache(B, Hkv, cap, n_sms):
    for resident in (_resident(n_sms, 1), _resident(n_sms, 2), *H100_RESIDENT.values()):
        chunk, splits = ops.split_plan(B, Hkv, cap, resident)
        assert chunk % 64 == 0 and 1 <= splits <= 1024
        assert splits <= 8 or splits % 8 == 0  # one cluster, or whole clusters of 8
        assert (splits - 1) * chunk < cap <= splits * chunk  # no split starts past the capacity
        csize = min(splits, 8)
        assert resident[csize - 1] >= csize  # the card holds a cluster of that size


@pytest.mark.parametrize("per_sm", [2, 1])
@pytest.mark.parametrize("B,Hkv", [(2, 8), (2, 1), (8, 8), (1, 1)])
def test_split_plan_gives_no_block_a_single_tile(B, Hkv, per_sm):
    """Every split, the last one too, owns at least 2 of the cache's 64-key
    tiles whenever the cache has 2, so each block's ring has a load in
    flight while it multiplies."""
    for tiles in range(1, 200):
        chunk, splits = ops.split_plan(B, Hkv, 64 * tiles, H100_RESIDENT[per_sm])
        per = chunk // 64
        if tiles >= 2:
            assert per >= 2 and tiles - (splits - 1) * per >= 2, (tiles, chunk, splits)


@pytest.mark.parametrize("per_sm", [2, 1])
@pytest.mark.parametrize("B,Hkv", [(8, 8), (4, 1), (64, 8), (100, 1), (33, 8), (2, 8)])
def test_split_plan_fills_whole_waves_on_long_caches(B, Hkv, per_sm):
    """On a long cache the blocks come in whole resident waves of their
    cluster size (one, or the last at least 3/4 full), enough of them to
    stream at the card's rate, and no more splits than that takes (one
    fewer split, or one fewer cluster of 8 a pair, would not reach it)."""
    resident = H100_RESIDENT[per_sm]
    chunk, splits = ops.split_plan(B, Hkv, 1 << 17, resident)
    blocks, csize = B * Hkv * splits, min(splits, 8)
    waves = -(-blocks // resident[csize - 1])
    assert waves == 1 or blocks >= 0.75 * waves * resident[csize - 1]
    assert blocks >= ops._CARD_BLOCKS
    step = 8 if splits > 8 else 1
    assert splits == 1 or B * Hkv * (splits - step) < ops._CARD_BLOCKS


# chip_smoke's paged call: 8 ragged slots in pages of 16, the pool holding
# their pages and two spare pages a slot
SMOKE_LENS = (4096, 3000, 2048, 1500, 1024, 700, 100, 17)
SMOKE_POOL_TILES = -(-(sum(-(-n // 16) for n in SMOKE_LENS) + 16) * 16 // 64)


def test_split_plan_splits_a_ragged_pool_more():
    """A paged call with one long slot among short ones (chip_smoke's, at
    Mixtral's widths) gives the long slot more blocks than the dense split
    plan of the same capacity gives every slot, which the card's bytes
    bind: its work list sees the lengths."""
    blocks = ops.paged_blocks(8, 8, 6, 128, 8 * (SMOKE_POOL_TILES + 8), H100_RESIDENT[2][0])
    items = ops.paged_work_items(torch.tensor(SMOKE_LENS), 8, 4096, blocks)
    long_slot = int(((items[:, 0] == 0) & (items[:, 1] == 0)).sum())
    assert long_slot > ops.split_plan(8, 8, 4096, H100_RESIDENT[2])[1]


def test_split_plan_skips_cluster_sizes_the_card_cannot_hold():
    """A card that holds no cluster of 2 or more gets one block per (slot,
    KV head), however long the cache."""
    assert ops.split_plan(2, 8, 1 << 16, (100, 0, 0, 0, 0, 0, 0, 0)) == (1 << 16, 1)
    assert ops.split_plan(1, 1, 1 << 16, (100, 2, 0, 0, 0, 0, 0, 0))[1] == 2

@pytest.mark.parametrize("B,Hkv,per_sm", [(1, 8, 2), (1, 1, 2), (1, 1, 1), (2, 1, 1)])
def test_split_plan_gives_few_pairs_several_clusters(B, Hkv, per_sm):
    """A long cache read by few (slot, KV head) pairs gets whole clusters of
    8 splits, more than one a pair, in one resident wave of clusters of 8,
    with enough blocks to stream at the card's rate or to fill half the
    card's clusters."""
    resident = H100_RESIDENT[per_sm]
    chunk, splits = ops.split_plan(B, Hkv, 32768, resident)
    blocks = B * Hkv * splits
    assert splits > 8 and splits % 8 == 0
    assert blocks <= resident[7]
    assert blocks >= min(ops._CARD_BLOCKS, resident[7] // 2)


def test_split_plan_reads_cluster_occupancy():
    """Where the splits come in clusters of 8, the card's cluster occupancy
    changes the plan: an H100 holds 120 blocks in clusters of 8 at one block
    per SM, not 132, so one pair over 32768 keys at hd 256 gets one wave of
    64 blocks where perfect packing would plan 128, a second wave."""
    real = ops.split_plan(1, 1, 32768, H100_RESIDENT[1])
    packed = ops.split_plan(1, 1, 32768, _resident(132, 1))
    assert real != packed
    assert real[1] <= H100_RESIDENT[1][7] < packed[1] <= _resident(132, 1)[7]


def test_split_plan_charges_blocks_past_kv_len():
    """No block of a paged call sits past its slot's kv_len: at chip_smoke's
    hd 256 shape (8 slots, one KV head, one block per SM) every item holds
    admitted keys, the long slot gets several items, and the grid (blocks
    + B·Hkv, every block that may hold an item) fits one resident wave."""
    resident = H100_RESIDENT[1][0]
    blocks = ops.paged_blocks(8, 1, 16, 256, SMOKE_POOL_TILES + 8, resident)
    items = ops.paged_work_items(torch.tensor(SMOKE_LENS), 1, 4096, blocks)
    assert bool((items[:, 3] > items[:, 2]).all())
    assert int((items[:, 0] == 0).sum()) > 8
    assert blocks + 8 <= resident


def _check_work_items(lens, Hkv, cap, blocks):
    """paged_work_items' rule: every admitted 64-key tile of every (slot, KV
    head) in exactly one item, in whole-tile ranges in the kernel's order;
    no item past ceil(total / blocks) + 1 tiles; no item for an empty slot;
    no more items than the kernel's grid (blocks + B·Hkv) holds."""
    kv_len = torch.tensor(lens, dtype=torch.int32)
    items = ops.paged_work_items(kv_len, Hkv, cap, blocks)
    admitted = [min(max(n, 0), cap) for n in lens]
    total = Hkv * sum(-(-n // 64) for n in admitted)
    assert len(items) <= blocks + len(lens) * Hkv
    order = items[:, 0] * Hkv + items[:, 1]
    assert bool((order[1:] >= order[:-1]).all())  # slot by slot, KV head by KV head
    tiles = -(-(items[:, 3] - items[:, 2]) // 64)
    if len(items):
        assert int(tiles.max()) <= -(-total // blocks) + 1
    for b, n in enumerate(admitted):
        for kvh in range(Hkv):
            mine = items[(items[:, 0] == b) & (items[:, 1] == kvh)]
            if n == 0:
                assert len(mine) == 0
                continue
            covered = [(int(s), int(e)) for s, e in mine[:, 2:].tolist()]
            assert covered[0][0] == 0 and covered[-1][1] == n
            assert all(s % 64 == 0 and s < e for s, e in covered)
            assert all(e == s2 for (_, e), (s2, _) in zip(covered, covered[1:]))
    return items


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("blocks", [1, 7, 64, 200, 1024])
def test_paged_work_items_cover_ragged_lengths(seed, blocks):
    rs = np.random.default_rng(seed)
    B, Hkv, cap = int(rs.integers(1, 12)), int(rs.choice([1, 2, 8])), int(rs.choice([64, 640, 4096, 5000]))
    lens = rs.integers(0, cap + 200, B).tolist()  # past cap is clamped
    lens[0] = 1
    if B > 1:
        lens[1] = cap
    _check_work_items(lens, Hkv, cap, blocks)


@pytest.mark.parametrize("blocks", [1, 16, 200])
def test_paged_work_items_give_one_slot_the_card(blocks):
    """A pool with one non-empty slot: every item is that slot's, as many
    as its tiles allow up to the plan's blocks."""
    items = _check_work_items([0, 0, 32768, 0, -3], 2, 32768, blocks)
    assert bool((items[:, 0] == 2).all())
    assert len(items) == 2 * min(-(-512 // max(-(-1024 // blocks), 2)), 512)


def test_paged_work_items_at_smoke_shapes():
    """chip_smoke's paged calls at both widths, at its lengths and 8x them:
    the long slot gets the most items, and the items of each (slot, KV head)
    differ by at most one tile."""
    for Hkv, G, hd, per_sm in ((8, 6, 128, 2), (1, 16, 256, 1)):
        for scale in (1, 8):
            lens = [scale * n for n in SMOKE_LENS]
            blocks = ops.paged_blocks(8, Hkv, G, hd, Hkv * (scale * SMOKE_POOL_TILES + 8), H100_RESIDENT[per_sm][0])
            items = _check_work_items(lens, Hkv, max(lens), blocks)
            counts = torch.bincount(items[:, 0], minlength=8)
            assert int(counts.argmax()) == 0
            tiles = -(-(items[:, 3] - items[:, 2]) // 64)
            pair = items[:, 0] * Hkv + items[:, 1]
            for p in pair.unique():
                mine = tiles[pair == p]
                assert int(mine.max()) - int(mine.min()) <= 1


@pytest.mark.parametrize("B,Hkv,G,hd,resident", [(8, 8, 6, 128, 264), (8, 1, 16, 256, 132), (64, 8, 6, 128, 264),
                                                  (300, 8, 4, 64, 264), (1, 1, 16, 256, 132)])
def test_paged_blocks_sizes_one_wave_where_the_pairs_allow(B, Hkv, G, hd, resident):
    """The grid (blocks + pairs) fits the fewest whole resident waves that
    hold the pairs and half a wave more; where the pairs take at most half
    a wave, one wave and half the resident blocks at most; the merge of one
    pair's partials stays within _MERGE_BYTES."""
    pairs = B * Hkv
    blocks = ops.paged_blocks(B, Hkv, G, hd, 10**6, resident)
    waves = -(-(pairs + resident // 2) // resident)
    assert 1 <= blocks <= ops._MAX_BLOCKS
    assert blocks + pairs <= waves * resident
    assert blocks * G * hd * 4 <= ops._MERGE_BYTES
    if pairs <= resident // 2:
        assert blocks + pairs <= resident and blocks <= resident // 2
