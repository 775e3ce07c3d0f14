"""The hand-written CUDA kernels (flash attention, RG-LRU scan, dense and
paged decode attention, tiered gather and gather-matmul) against their
plain PyTorch versions, on the card, at every served model's attention
widths; a reduced modal config's multimodal prefill launching the flash
kernel for its decoder self layers only; and the mesh on a one-rank NCCL
world (a 1×1 cold start equal to none, ``compressed_psum`` over one rank);
the cost counter on a card matmul and dry-run cells with fake tensors on
the card; ``ThreadComm`` refusing a CUDA backward.
Needs an NVIDIA GPU and nvcc (the
kernel has no CPU mode); skips elsewhere. Imports no JAX (and
``--noconftest`` skips the JAX fixtures of tests/conftest.py), so it runs
where only torch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import sm_count
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.tiered_gather import ops as tg_ops
from repro_torch.serving import PagePool

# B, Sq, Sk, H, Hkv, hd, causal, window, softcap, q_offset
CASES = [
    (1, 130, 130, 8, 2, 128, True, 32, None, 0),
    (1, 64, 200, 4, 4, 64, True, None, 30.0, 136),
    (2, 77, 90, 6, 2, 128, False, 40, None, 0),
    (1, 100, 100, 4, 1, 64, True, None, None, 0),
    # head_dim 256, MQA (G=16, Hkv=1) as RecurrentGemma's local attention
    (2, 200, 200, 16, 1, 256, True, 64, None, 0),
    (1, 70, 150, 16, 1, 256, True, None, 20.0, 80),
    (1, 130, 130, 4, 2, 256, False, None, None, 0),
    # the tile edges of the wgmma kernel (BQ 128; BK 128 at hd 64/128, 64 at hd 256)
    (2, 1, 300, 8, 2, 128, True, None, None, 299),  # Sq = 1
    (1, 129, 129, 8, 2, 128, True, None, None, 0),  # one row in the second q tile
    (1, 100, 257, 8, 2, 128, True, None, None, 157),  # Sk = 257, q_offset = Sk - Sq
    (1, 256, 256, 4, 2, 128, True, 40, None, 0),  # window < BK
    (1, 300, 300, 4, 2, 128, True, 150, None, 0),  # window straddling two key tiles
    (2, 256, 256, 48, 8, 128, True, None, None, 0),  # Mixtral's G = 6
    (1, 200, 333, 4, 2, 64, False, None, 30.0, 0),  # hd 64, not causal, softcap
    (1, 300, 300, 16, 1, 256, True, 100, 25.0, 0),  # hd 256, window and softcap
    # served widths: Whisper's decoder (hd 64, G = 1, its 448-token context),
    # Llama-3.2-Vision's self layers (G = 8), Yi-34B (G = 7), Phi-3-medium
    # (G = 4) and Mistral-Large (G = 12)
    (2, 448, 448, 8, 8, 64, True, None, None, 0),
    (1, 300, 300, 64, 8, 128, True, None, None, 0),
    (1, 200, 200, 56, 8, 128, True, None, None, 0),
    (1, 200, 200, 40, 10, 128, True, None, None, 0),
    (1, 200, 200, 96, 8, 128, True, None, None, 0),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(card, case):
    B, Sq, Sk, H, Hkv, hd, causal, window, softcap, q_offset = case
    rs = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card, torch.bfloat16)
               for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    ref = fa_ops.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                       window=window, softcap=softcap, q_offset=q_offset)
    # bf16 rounding is relative (8 significant bits): 1e-2 per unit of
    # max(1, |output|), i.e. 1e-2 absolute at unit-scale values
    assert ((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_kernel_rows_with_no_admitted_key_are_zero(card, hd):
    """Causal window 64 over 100 keys: q rows 163..199 see no key and must
    be exactly 0, as in flash_attention_plain; the rest match it."""
    rs = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card, torch.bfloat16)
               for shape in ((1, 200, 4, hd), (1, 100, 2, hd), (1, 100, 2, hd)))
    out = fa_ops.flash_attention(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    ref = fa_ops.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, window=64)
    assert (ref[:, 163:] == 0).all()
    assert (out[:, 163:] == 0).all()
    assert ((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-2


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 4, 128, device=card, dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa_ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros(1, 8, 4, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)


# the reduced configs' head dims through the zero-padded hd-64 kernel:
# B, Sq, Sk, H, Hkv, hd, causal, window, softcap, q_offset
PADDED_CASES = [
    (2, 16, 16, 4, 2, 16, True, 32, None, 0),  # reduced Mixtral's served prefill
    (1, 200, 200, 4, 2, 16, True, 32, None, 0),  # window 32 across key tiles, GQA
    (2, 150, 150, 8, 2, 8, True, None, None, 0),  # reduced Yi: hd 8, causal, GQA
    (1, 130, 130, 4, 1, 8, True, 32, None, 0),  # hd 8, window 32, MQA
    (1, 100, 120, 4, 2, 16, False, None, None, 0),  # not causal
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PADDED_CASES, ids=str)
def test_padded_head_dims_match_plain_on_card(card, case):
    """hd 8 and 16: one launch of the kernel on q, k, v zero-padded to 64,
    sliced back to hd, within the kernel tolerance of the plain version."""
    B, Sq, Sk, H, Hkv, hd, causal, window, softcap, q_offset = case
    rs = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card, torch.bfloat16)
               for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    ref = fa_ops.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal, window=window,
                                       softcap=softcap, q_offset=q_offset)
    assert ((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-2


# (B, S, W): the served prefill (32 lanes a block, TMA), ragged S and W past a
# tile (1017 steps, W = 4096 + 32), W below a block's 32 lanes through TMA (20)
# and through the copy loader (30: not a multiple of 4), 64 lanes a block
# (B·W/64 ≥ the SMs), and 64 lanes with a ragged W off TMA (4099)
SCAN_SHAPES = [(2, 37, 200), (1, 1000, 4096), (3, 5, 1), (2, 1024, 4096), (1, 1017, 4128), (2, 40, 20),
               (2, 70, 30), (3, 100, 4096), (4, 33, 4099)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_rglru_kernel_matches_plain_on_card(card, shape):
    rs = np.random.default_rng(1)
    a = torch.from_numpy(rs.uniform(0.5, 0.999, shape).astype(np.float32)).to(card)
    b = torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card)
    before = lru_ops.rglru_scan.launches
    out = lru_ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert lru_ops.rglru_scan.launches == before + 1
    ref = lru_ops.rglru_scan_plain(a, b)
    # the same fp32 roundings in the same order (multiply, then add): bit for bit
    assert torch.equal(out, ref)
    assert ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-5


@pytest.mark.gpu
def test_rglru_kernel_rejects_what_it_does_not_take(card):
    a = torch.zeros(1, 8, 16, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        lru_ops.rglru_scan(a, a)
    a = torch.zeros(1, 16, 8, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lru_ops.rglru_scan(a, a)


def _scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    # bf16 output rounding: 1e-2 per unit of max(1, |plain output|)
    return ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max().item()


def _randn(rs, shape, card, dtype=torch.bfloat16):
    return torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card, dtype)


# B, H, Hkv, hd, Skv, softcap, kv_len (past Skv is clamped; one split when
# the cache is a single 64-key tile)
DECODE_CASES = [
    (2, 48, 8, 128, 1040, None, [1040, 517]),
    (2, 16, 1, 256, 300, None, [300 + 45, 1]),
    (3, 4, 4, 64, 50, 30.0, [50, 7, 64]),
    (1, 12, 2, 128, 4100, 20.0, [4099]),
    (4, 16, 1, 64, 129, None, [129, 64, 65, 2]),
    # RecurrentGemma's widths: a rolling 2048 window past its end
    (2, 16, 1, 256, 2048, None, [2148, 2148]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_kernel_matches_plain_on_card(card, case):
    B, H, Hkv, hd, Skv, softcap, lens = case
    rs = np.random.default_rng(2)
    q, k, v = (_randn(rs, s, card) for s in ((B, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, kv_len, softcap=softcap)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    ref = da_ops.decode_attention_plain(q, k, v, kv_len.clamp(max=Skv), softcap=softcap)
    assert _scaled_err(out, ref) <= 1e-2


# B, H, Hkv, hd, Skv, kv_len: several clusters of 8 splits a (slot, KV head)
# (the first three 16-32 splits, then 64 and 128 splits over one pair) and
# one cluster of 8 or 6 splits (the last two), later splits and clusters of
# the short slots empty, slots with no admitted key
MANY_SPLIT_CASES = [
    (4, 16, 2, 128, 8192, [8192, 5000, 700, 0]),
    (3, 8, 1, 64, 4096, [4000, 129, 1]),
    (2, 16, 1, 256, 4096, [4096, 1000]),
    (1, 16, 1, 256, 32768, [20000]),
    (1, 4, 1, 64, 65536, [65536]),
    (2, 16, 1, 256, 2048, [2048, 300]),
    (4, 8, 2, 128, 1040, [1040, 500, 1, 0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MANY_SPLIT_CASES, ids=str)
def test_decode_kernel_merges_splits_in_one_launch(card, case):
    """Each call is one launch, whatever its split count; two calls and a
    CUDA-graph replay give the same output and leave the clusters' counters
    at 0, so neither merge keeps state between calls; a slot with kv_len 0
    gives exactly 0."""
    B, H, Hkv, hd, Skv, lens = case
    rs = np.random.default_rng(6)
    q, k, v = (_randn(rs, s, card) for s in ((B, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))
    assert da_ops.dense_plan(q, k)[1] > 1
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    before = da_ops.decode_attention.launches
    first = da_ops.decode_attention(q, k, v, kv_len)
    second = da_ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = da_ops.decode_attention(q, k, v, kv_len)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)
    assert not any(bool(c.any()) for c in da_ops._counters.values())
    ref = da_ops.decode_attention_plain(q, k, v, kv_len)
    live = kv_len > 0
    assert bool((first[~live] == 0).all())
    assert _scaled_err(first[live], ref[live]) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_resident_blocks_per_cluster_size(card, hd):
    """What the split plan reads: whole clusters, at least one block per SM
    without clusters, never more with them."""
    n_sms = sm_count(card)
    for paged in (False, True):
        resident = da_ops.resident_blocks(card, hd, paged)
        assert len(resident) == 8 and resident[0] >= n_sms
        assert all(r % s == 0 and s <= r <= resident[0] for s, r in enumerate(resident, start=1))


def _granted_table(B, NP, ps, card):
    """A table from a pool that granted and freed other slots first."""
    pool = PagePool(B * NP + 5, ps, B + 1)
    pool.alloc(B, 3 * ps)
    for b in range(B):
        assert pool.alloc(b, NP * ps)
        if b == 0:
            pool.free(B)
    return pool.n_pages, torch.from_numpy(pool.page_table(np_max=NP)[:B]).to(card)


# B, Hkv, G, hd, ps, NP, softcap, kv_len
PAGED_CASES = [
    (8, 8, 6, 128, 16, 40, None, [640, 600, 513, 300, 100, 64, 17, 1]),
    (2, 1, 16, 256, 16, 20, None, [320, 150]),
    (3, 2, 3, 64, 12, 9, 25.0, [108 + 30, 50, 12]),  # a page size TMA cannot tile: the cp.async loader
    (2, 2, 4, 128, 128, 4, None, [500, 129]),  # pages of two tiles
    (3, 1, 8, 64, 8, 30, None, [240, 57, 9]),  # 8 pages a tile
    (2, 1, 8, 128, 16, 256, None, [4096, 100]),  # several clusters a (slot, KV head), TMA pages
    (1, 1, 4, 64, 12, 326, None, [3900]),  # several clusters, the cp.async loader
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_decode_kernel_matches_plain_on_card(card, case):
    B, Hkv, G, hd, ps, NP, softcap, lens = case
    P, pt = _granted_table(B, NP, ps, card)
    rs = np.random.default_rng(3)
    q = _randn(rs, (B, Hkv * G, hd), card)
    k, v = (_randn(rs, (P, ps, Hkv, hd), card) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    # the tail past each slot's last occupied page is never followed
    last = (kv_len.clamp(max=NP * ps).long() + ps - 1) // ps
    cols = torch.arange(NP, device=card)[None, :]
    garbage = torch.where(cols % 2 == 0, -1, P + 100).to(torch.int32)
    raw = torch.where(cols >= last[:, None], garbage, pt)
    before = da_ops.paged_decode_attention.launches
    out = da_ops.paged_decode_attention(q, k, v, raw, kv_len, softcap=softcap)
    torch.cuda.synchronize()
    assert da_ops.paged_decode_attention.launches == before + 1
    kv = kv_len.clamp(max=NP * ps)
    ref = da_ops.paged_decode_attention_plain(q, k, v, da_ops.clamp_page_table(raw, kv, P, ps), kv,
                                              softcap=softcap)
    assert _scaled_err(out, ref) <= 1e-2


def _paged_inputs(B, Hkv, G, hd, ps, NP, card, seed):
    P, pt = _granted_table(B, NP, ps, card)
    rs = np.random.default_rng(seed)
    q = _randn(rs, (B, Hkv * G, hd), card)
    k, v = (_randn(rs, (P, ps, Hkv, hd), card) for _ in range(2))
    return P, pt, q, k, v


def _check_paged(out, q, k, v, pt, kv_len, P, ps):
    """Kernel output vs plain at the clamped lengths and table; slots with no
    admitted key are exactly 0 (the plain version averages V there)."""
    NP = pt.shape[1]
    kv = kv_len.clamp(max=NP * ps)
    ref = da_ops.paged_decode_attention_plain(q, k, v, da_ops.clamp_page_table(pt, kv, P, ps), kv)
    live = kv > 0
    assert bool((out[~live] == 0).all())
    assert _scaled_err(out[live], ref[live]) <= 1e-2


# B, Hkv, G, hd, ps, NP, kv_len: the paged work list at ragged lengths with 1,
# NP·ps and empty slots; pages of 64 rows (TMA, one piece a tile) and 16
# (TMA, four pieces), 12 (the cp.async loader); a pool with one non-empty
# slot, whose items are many and merge through the workspace
WORKLIST_CASES = [
    (6, 2, 4, 128, 64, 8, [512, 1, 300, 0, 64, 65]),
    (8, 8, 6, 128, 16, 64, [1024, 1, 1000, 17, 0, 513, 64, 999]),
    (4, 1, 16, 256, 12, 30, [360, 1, 200, 13]),
    (5, 8, 6, 128, 16, 64, [0, 0, 1024, 0, 0]),
    (3, 1, 16, 256, 16, 2048, [32768, 0, 17]),
    (2, 2, 4, 64, 12, 700, [8400, 3]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WORKLIST_CASES, ids=str)
def test_paged_work_list_matches_plain_on_card(card, case):
    """One launch a call; two calls and a CUDA-graph replay agree exactly and
    leave every pair's counter at 0, so the items' merge keeps no state."""
    B, Hkv, G, hd, ps, NP, lens = case
    P, pt, q, k, v = _paged_inputs(B, Hkv, G, hd, ps, NP, card, seed=7)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=card)
    before = da_ops.paged_decode_attention.launches
    first = da_ops.paged_decode_attention(q, k, v, pt, kv_len)
    second = da_ops.paged_decode_attention(q, k, v, pt, kv_len)
    torch.cuda.synchronize()
    assert da_ops.paged_decode_attention.launches == before + 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = da_ops.paged_decode_attention(q, k, v, pt, kv_len)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)
    assert not any(bool(c.any()) for c in da_ops._counters.values())
    _check_paged(first, q, k, v, pt, kv_len, P, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 12], ids=str)
def test_paged_graph_follows_lengths_and_table_changed_in_place(card, ps):
    """A graph captured once stays right when kv_len and the page table
    change in place between replays: the work list is built on the card."""
    B, Hkv, G, hd, NP = 4, 2, 6, 128, 64
    P, pt, q, k, v = _paged_inputs(B, Hkv, G, hd, ps, NP, card, seed=8)
    kv_len = torch.tensor([NP * ps, 100, 1, 300], dtype=torch.int32, device=card)
    da_ops.paged_decode_attention(q, k, v, pt, kv_len)  # build, plan and counters outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.paged_decode_attention(q, k, v, pt, kv_len)
    for lens, table in (([NP * ps, 100, 1, 300], pt.clone()), ([1, NP * ps, 0, 17], pt.flip(0)),
                        ([5, 6, 7, NP * ps - 3], pt.roll(1, 1))):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        pt.copy_(table)
        graph.replay()
        torch.cuda.synchronize()
        _check_paged(out, q, k, v, pt, kv_len, P, ps)
    assert not any(bool(c.any()) for c in da_ops._counters.values())


@pytest.mark.gpu
def test_decode_kernels_reject_what_they_do_not_take(card):
    q = torch.zeros(1, 4, 128, device=card)
    k = torch.zeros(1, 8, 2, 128, device=card)
    with pytest.raises(TypeError, match="bfloat16"):
        da_ops.decode_attention(q, k, k, 3)
    q, k = q.bfloat16(), k.bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        da_ops.decode_attention(q[..., :96].contiguous(), k[..., :96].contiguous(), k[..., :96].contiguous(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        da_ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, 3)
    with pytest.raises(ValueError, match="query heads"):
        da_ops.decode_attention(torch.zeros(1, 34, 128, device=card, dtype=torch.bfloat16), k, k, 3)
    pages = torch.zeros(4, 16, 2, 128, device=card, dtype=torch.bfloat16)
    table = torch.zeros(1, 8, dtype=torch.int32, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        da_ops.paged_decode_attention(q, pages, pages, table, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("D", [6144, 100, 3], ids=str)  # 16-, 4- and 2-byte word copies
def test_gather_kernel_matches_plain_bitwise_on_card(card, dtype, D):
    rs = np.random.default_rng(4)
    V, gs, N = 1000, 64, 300
    table = _randn(rs, (V, D), card, dtype)
    ids = torch.from_numpy(rs.integers(-3, V + 3, N)).to(card)
    ids[:3] = torch.tensor([-1, V, 2**31 - 1])
    mask = torch.from_numpy(rs.integers(0, 2, -(-V // gs))).to(card)
    before = tg_ops.tiered_gather.launches
    out, miss = tg_ops.tiered_gather(table, ids, mask, group_size=gs)
    torch.cuda.synchronize()
    assert tg_ops.tiered_gather.launches == before + 1
    ref, ref_miss = tg_ops.tiered_gather_plain(table, ids.int(), mask.int(), group_size=gs)
    assert torch.equal(miss, ref_miss) and torch.equal(out, ref)
    assert bool((out[miss == 1] == 0).all()) and miss[:3].tolist() == [1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 256, 384, 130, 64), (64, 40, 136, 7, 8), (4096, 1024, 2048, 512, 256)],
                         ids=str)
@pytest.mark.parametrize("kind", ["all", "half", "none"])
def test_gather_matmul_kernel_matches_plain_on_card(card, shape, kind):
    V, D, F, N, gs = shape
    rs = np.random.default_rng(5)
    table, w = _randn(rs, (V, D), card), _randn(rs, (D, F), card) * D**-0.5
    ids = torch.from_numpy(rs.integers(-2, V + 2, N)).to(card)
    G = -(-V // gs)
    mask = {"all": torch.ones(G), "none": torch.zeros(G),
            "half": torch.from_numpy(rs.integers(0, 2, G))}[kind].to(card)
    before = tg_ops.tiered_gather_matmul.launches
    out, miss = tg_ops.tiered_gather_matmul(table, w, ids, mask, group_size=gs)
    torch.cuda.synchronize()
    assert tg_ops.tiered_gather_matmul.launches == before + 1
    ref, ref_miss = tg_ops.tiered_gather_matmul_plain(table, w, ids.int(), mask.int(), group_size=gs)
    assert torch.equal(miss, ref_miss)
    assert bool((out[miss == 1] == 0).all())
    assert _scaled_err(out, ref) <= 1e-2


# V, D, F, N, gs: hits that fill no whole 128-row slice, D and F that are not
# multiples of the kernel's 64-deep k slice and 256 columns
GM_EDGE_SHAPES = [(3000, 200, 520, 300, 100), (500, 8, 8, 129, 50), (4096, 6144, 264, 700, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GM_EDGE_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["all", "half", "none"])
def test_gather_matmul_edges_match_plain_on_card(card, shape, kind):
    V, D, F, N, gs = shape
    rs = np.random.default_rng(9)
    table, w = _randn(rs, (V, D), card), _randn(rs, (D, F), card) * D**-0.5
    ids = torch.from_numpy(rs.integers(0, V, N)).to(card)
    ids[:3] = torch.tensor([-1, V, V - 1])
    G = -(-V // gs)
    mask = {"all": torch.ones(G), "none": torch.zeros(G),
            "half": torch.arange(G) % 2}[kind].to(card)
    out, miss = tg_ops.tiered_gather_matmul(table, w, ids, mask, group_size=gs)
    torch.cuda.synchronize()
    ref, ref_miss = tg_ops.tiered_gather_matmul_plain(table, w, ids.int(), mask.int(), group_size=gs)
    assert torch.equal(miss, ref_miss) and miss[:2].tolist() == [1, 1]
    assert bool((out[miss == 1] == 0).all())
    assert _scaled_err(out, ref) <= 1e-2


@pytest.mark.gpu
def test_gather_matmul_graph_follows_mask_changed_in_place(card):
    """The hits are packed on the card: a graph captured once stays right
    when the group mask changes in place between replays."""
    V, D, F, N, gs = 2048, 320, 520, 300, 128
    rs = np.random.default_rng(10)
    table, w = _randn(rs, (V, D), card), _randn(rs, (D, F), card) * D**-0.5
    ids = torch.from_numpy(rs.integers(-1, V + 1, N)).to(card, torch.int32)
    mask = torch.ones(V // gs, dtype=torch.int32, device=card)
    tg_ops.tiered_gather_matmul(table, w, ids, mask, group_size=gs)  # build outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, miss = tg_ops.tiered_gather_matmul(table, w, ids, mask, group_size=gs)
    for resident in (torch.ones(V // gs), torch.arange(V // gs) % 3 == 0, torch.zeros(V // gs)):
        mask.copy_(resident.to(torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref, ref_miss = tg_ops.tiered_gather_matmul_plain(table, w, ids, mask, group_size=gs)
        assert torch.equal(miss, ref_miss)
        assert bool((out[miss == 1] == 0).all())
        assert _scaled_err(out, ref) <= 1e-2


@pytest.mark.gpu
def test_gather_kernels_reject_what_they_do_not_take(card):
    ids = torch.zeros(4, dtype=torch.int32, device=card)
    mask = torch.ones(2, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="2- or 4-byte"):
        tg_ops.tiered_gather(torch.zeros(16, 8, device=card, dtype=torch.float64), ids, mask, group_size=8)
    with pytest.raises(ValueError, match="contiguous"):
        tg_ops.tiered_gather(torch.zeros(8, 16, device=card).t(), ids, mask, group_size=8)
    with pytest.raises(ValueError, match="group_mask"):
        tg_ops.tiered_gather(torch.zeros(16, 8, device=card), ids, mask[:1], group_size=8)
    table = torch.zeros(16, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        tg_ops.tiered_gather_matmul(table.float(), torch.zeros(64, 32, device=card), ids, mask, group_size=8)
    with pytest.raises(ValueError, match="multiples of 8"):
        tg_ops.tiered_gather_matmul(table, torch.zeros(64, 30, device=card, dtype=torch.bfloat16), ids, mask,
                                    group_size=8)


def _serve_stats_and_before(device, outdir):
    """Reduced Mixtral (fp32 weights; head_dim widened from 16 to 64, which
    the flash kernel takes) served under stats with the prefetcher and from
    the before bundle of the same weights. Returns both tokens, the stats
    server's loader and prefetch stats, and its prefetch threads."""
    import threading

    from repro_torch.configs import get_reduced
    from repro_torch.core import DeploymentProfile, analyze, build_artifact, write_monolithic
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.serving import GenerationEngine, cold_start

    cfg = get_reduced("mixtral-8x22b").replace(head_dim=64, collect_moe_usage=True)
    model = build_model(cfg)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=64)
    result = analyze(model, profile, trace_B=1, trace_S=32)
    params = model.init(torch.Generator(device).manual_seed(0), device=device)
    opt = init_adamw(params)
    write_monolithic({"params": params, "opt_state": {"m": opt.m, "v": opt.v}}, outdir)
    build_artifact(params, result, outdir)
    del params, opt
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3)).to(device)
    with cold_start(model, outdir, mode="before", warm_shapes=((2, 16),), device=device) as server:
        want, _ = GenerationEngine(server, max_seq=40).generate(prompt, 12)
    with cold_start(model, outdir, result, residency="stats", warm_shapes=((2, 16),), device=device) as server:
        pf = server.prefetcher
        threads = {pf._reader, pf._uploader}
        launches = fa_ops.flash_attention.launches
        out, stats = GenerationEngine(server, max_seq=40).generate(prompt, 12)
        flash = fa_ops.flash_attention.launches - launches
        assert pf.drain(30.0)
    alive = threads & set(threading.enumerate())
    return want, out, stats, flash, server.tiered, pf.stats, alive


@pytest.mark.gpu
def test_stats_policy_serves_before_mode_tokens_on_card(card, tmp_path):
    want, out, stats, flash, tiered, pstats, alive = _serve_stats_and_before("cuda", str(tmp_path))
    np.testing.assert_array_equal(out, want)
    assert flash == 2 * stats.prefill_runs  # both layers' prefill attention ran the kernel
    assert stats.faulted_units > 0 and tiered.stats.evictions > 0
    res = tiered.residency
    assert res.max_resident_bytes <= res.budget_bytes or res.overshoot_events > 0
    assert tiered.resident_bytes <= res.budget_bytes
    assert pstats.hints > 0 and pstats.errors == 0
    assert not alive  # close() joined the reader and the uploader


def _reduced_card_model():
    """Reduced Mixtral with head_dim widened from 16 to 64 (the flash
    kernel's smallest), fp32 weights, bf16 compute, on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    cfg = get_reduced("mixtral-8x22b").replace(head_dim=64, collect_moe_usage=True)
    return build_model(cfg)


def _monolithic_server(model, card):
    from repro_torch.serving import ColdStartReport, ColdStartServer

    params = model.init(torch.Generator(card).manual_seed(0), device=card)
    return ColdStartServer(model, params, ColdStartReport(mode="before"), device=card)


def _batch(kind, B, S, vocab, card, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "prefill":
        return {"tokens": torch.randint(0, vocab, (B, S), generator=g).to(card)}
    batch = {"tokens": torch.randint(0, vocab, (B, 1), generator=g).to(card),
             "pos": torch.randint(S // 2, S, (B,), generator=g).to(card)}
    if kind == "decode_masked":
        batch["active"] = torch.tensor([True, False, True], device=card)[:B]
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-base"])
def test_multimodal_prefill_launches_flash_for_self_layers_only(card, arch):
    """A reduced modal config's multimodal prefill on the card (bf16, gates
    set nonzero so the image path counts): the flash kernel runs once per
    decoder self layer, never for the encoder or the cross-attention (plain,
    as in the reference), and the logits match the same prefill through the
    plain attention; the text-only prefill launches as many."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model

    model = build_model(get_reduced(arch))
    cfg = model.cfg
    params = model.init(torch.Generator(card).manual_seed(0), device=card)
    if cfg.vlm is not None:  # both gates start at zero
        params["groups"]["u4"]["cross"]["gate"].fill_(0.7)
        params["groups"]["u4"]["gate_ffn"].fill_(0.7)
    g = torch.Generator().manual_seed(3)
    B, S = 2, 24
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(card)}
    if cfg.vlm is not None:
        batch["image_embeds"] = torch.randn(B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim, generator=g).to(
            card, torch.bfloat16)
    else:
        batch["frames"] = torch.randn(B, S, cfg.d_model, generator=g).to(card, torch.bfloat16)
    self_layers = cfg.attn_kinds.count("self")
    with torch.inference_mode():
        before = fa_ops.flash_attention.launches
        logits, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        assert fa_ops.flash_attention.launches == before + self_layers
        xk = caches["groups"]["u4" if cfg.vlm is not None else "u0"]["xk"]
        assert xk.shape[-2:] == (cfg.num_kv_heads, cfg.resolved_head_dim)
        orig = attn_mod.flash_attention
        attn_mod.flash_attention = fa_ops.flash_attention_plain
        try:
            plain, _ = model.prefill(params, batch)
        finally:
            attn_mod.flash_attention = orig
        assert fa_ops.flash_attention.launches == before + self_layers
        before = fa_ops.flash_attention.launches
        model.prefill(params, {"tokens": batch["tokens"]})
        assert fa_ops.flash_attention.launches == before + self_layers
    assert torch.isfinite(logits.float()).all()
    # bf16 attention outputs (kernel: P rounded to bf16) walking through a
    # few residual blocks: within 10% of the plain path's max |logit|
    assert (logits.float() - plain.float()).abs().max().item() <= 0.1 * plain.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["prefill", "decode", "decode_masked"])
def test_graph_replay_equals_eager(card, kind):
    """Each compiled entry replayed twice on new inputs equals the plain call
    on the same inputs (decode: on a copy of the caches); the decode graph
    writes the K/V row of its own caches in place; replays add the launches
    the graph recorded, and the capture added none."""
    from repro_torch.serving.engine import commit_decode_caches
    from repro_torch.utils.tree import flatten_with_paths, tree_map

    model = _reduced_card_model()
    server = _monolithic_server(model, card)
    B, S = 3, 40
    launches = fa_ops.flash_attention.launches
    if kind == "prefill":
        entry = server.compiled_prefill(B, S)
        assert fa_ops.flash_attention.launches == launches + 2  # the warm-up ran both layers; the capture counts 0
        assert entry.launches["flash_attention"] == 2
    else:
        entry = getattr(server, f"compiled_{kind}")(B, S)
        assert set(entry.launches.values()) == {0}  # the served decode is plain
    params = server.live_params()
    for seed in (1, 2):
        batch = _batch(kind, B, S, model.cfg.vocab_size, card, seed)
        if kind == "prefill":
            want_logits, want = model.prefill(params, batch)
            before = fa_ops.flash_attention.launches
            logits, got = entry(params, batch)
            assert fa_ops.flash_attention.launches == before + 2
        else:
            for _, leaf in flatten_with_paths(entry.caches):
                leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator(card).manual_seed(seed),
                                       device=card).to(leaf.dtype))
            mine = tree_map(torch.clone, entry.caches)
            with torch.inference_mode():
                want_logits, want = getattr(model, f"{kind}_step" if kind == "decode" else "decode_step_masked")(
                    params, mine, batch)
            commit_decode_caches(mine, want)
            k_ptr = entry.caches["groups"]["u0"]["k"].data_ptr()
            logits, got = entry(params, entry.caches, batch)
            assert got["groups"]["u0"]["k"].data_ptr() == k_ptr
            commit_decode_caches(entry.caches, got)
            want, got = mine, entry.caches
        torch.cuda.synchronize()
        torch.testing.assert_close(logits.float(), want_logits.float(), atol=2e-2, rtol=2e-2)
        assert torch.equal(logits.argmax(-1), want_logits.argmax(-1))
        for (p, a), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(want)):
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=p)


@pytest.mark.gpu
def test_graph_reads_units_installed_and_evicted_after_capture(card, tmp_path):
    """Strict after2 server: the prefill graph is captured while every
    expert is a placeholder. A unit faulted in after the capture, and then
    one evicted, are what the next replay reads (the params are written in
    place at the addresses the graph was captured with)."""
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.serving import cold_start

    model = _reduced_card_model()
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=64)
    result = analyze(model, profile, trace_B=1, trace_S=32)
    build_artifact(model.init(torch.Generator(card).manual_seed(0), device=card), result, str(tmp_path))
    batch = _batch("prefill", 2, 24, model.cfg.vocab_size, card, 3)
    with cold_start(model, str(tmp_path), result, residency="full", warm_shapes=((2, 24),), device=card,
                    prefetch=False) as server:
        entry, tiered = server.compiled_prefill(2, 24), server.tiered
        live = server.live_params()
        cold, _ = entry(live, batch)
        cold = cold.clone()
        tiered.ensure_all()  # every unit installed after the capture
        loaded, _ = entry(live, batch)
        loaded = loaded.clone()
        with torch.inference_mode():
            want, _ = model.prefill(live, batch)
        torch.testing.assert_close(loaded.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert not torch.allclose(loaded.float(), cold.float(), atol=1e-1)
        expert = next(k for k in tiered.resident_keys if "#l" in k)
        assert tiered.evict([expert]) > 0
        evicted, _ = entry(live, batch)
        with torch.inference_mode():
            want, _ = model.prefill(live, batch)
        torch.testing.assert_close(evicted.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_scheduler_replays_graphs_and_matches_eager(card, monkeypatch):
    """Five requests through three slots on the card (graphs) and with every
    entry made eagerly: the same tokens, and the one masked-decode graph."""
    import importlib

    from repro_torch.serving import ContinuousBatchingScheduler, EagerEntry, GenerationEngine

    cs_mod = importlib.import_module("repro_torch.serving.cold_start")

    model = _reduced_card_model()
    prompts = [torch.randint(0, model.cfg.vocab_size, (S,), generator=torch.Generator().manual_seed(i)).numpy()
               for i, S in enumerate((12, 20, 12, 7, 20))]
    outs = {}
    for how in ("graph", "eager"):
        if how == "eager":
            monkeypatch.setattr(cs_mod, "GraphEntry", EagerEntry)
        server = _monolithic_server(model, card)
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=40), max_batch=3)
        reqs = [sched.submit(p, n) for p, n in zip(prompts, (6, 4, 8, 3, 5))]
        sched.run()
        assert all(r.done and r.error is None for r in reqs)
        kinds = {type(e).__name__ for e in server._compiled.values()}
        assert kinds == {"GraphEntry" if how == "graph" else "EagerEntry"}
        outs[how] = [r.out for r in reqs]
        server.close()
    assert outs["graph"] == outs["eager"]


@pytest.mark.gpu
def test_failed_capture_raises(card):
    """A forward run that cannot be captured (a host sync inside it) raises
    from the compiled entry, and the server keeps no entry for the shape.
    In a child process: a failed capture can leave the CUDA context unusable."""
    import os
    import subprocess
    import sys

    code = """
import torch
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.serving import ColdStartReport, ColdStartServer

model = build_model(get_reduced("mixtral-8x22b").replace(head_dim=64))
params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda")
server = ColdStartServer(model, params, ColdStartReport(mode="before"), device="cuda")
real = model.prefill
def syncing(p, batch):
    float(batch["tokens"].float().sum())  # a device-to-host read: not capturable
    return real(p, batch)
model.prefill = syncing
try:
    server.compiled_prefill(1, 16)
except RuntimeError as e:
    print("raised:", type(e).__name__, ("prefill", 1, 16) in server._compiled)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert "raised: " in res.stdout and res.stdout.strip().endswith("False"), res.stdout + res.stderr[-3000:]


def _reduced_bf16(card, tmp, policy="full"):
    """Reduced Mixtral as the launcher serves it on the card (head_dim 16,
    bf16 weights from a seeded generator), its artifact and plan: the
    launcher's stats profile (a hot set), or with ``policy="strict"`` its
    strict one (no hot set)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import build_model

    cfg = get_reduced("mixtral-8x22b").replace(collect_moe_usage=True)
    model = build_model(cfg, param_dtype=torch.bfloat16)
    prof = dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))
    hot = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 128, 8)).vocab_row_stats(row_group=prof["vocab_row_group"])
    if policy == "strict":
        prof.update(resident_experts=0, hot_vocab_fraction=0.0)
        hot = None
    result = analyze(model, DeploymentProfile(**prof), hot_units_stats=hot, trace_B=1, trace_S=32)
    build_artifact(model.init(torch.Generator(card).manual_seed(0), device=card), result, tmp)
    return model, result


@pytest.mark.gpu
def test_prefill_entries_bounded_on_card(card, tmp_path):
    """N + 3 prompt lengths, longest first, through a server that keeps N
    prefill entries beyond its warm set: memory_allocated after the N-th
    length is never passed (each later entry replaces a larger, freed one,
    whose graph's pool memory the next capture reuses), and each length's
    tokens equal those of a server that evicts nothing."""
    from repro_torch.serving import GenerationEngine, cold_start

    model, result = _reduced_bf16(card, str(tmp_path))
    N, lengths = 2, [32, 30, 28, 26, 24]  # inside reduced Mixtral's window of 32, which the graft needs
    prompt = torch.randint(0, model.cfg.vocab_size, (2, max(lengths)),
                           generator=torch.Generator().manual_seed(5)).to(card)
    outs, mem = {}, []
    for name, bound in (("fresh", len(lengths)), ("bounded", N)):
        with cold_start(model, str(tmp_path), result, residency="full", prefetch=False, warm_shapes=((2, 8, 56),),
                        device=card) as server:
            server.max_prefill_entries = bound
            server.tiered.ensure_all()
            eng = GenerationEngine(server, max_seq=56)
            outs[name] = []
            for S in lengths:
                outs[name].append(eng.generate(prompt[:, :S], 4)[0])
                torch.cuda.synchronize()
                if name == "bounded":
                    mem.append((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()))
                    assert len([k for k in server.prefill_entries() if k not in server._kept]) <= N
            if name == "bounded":
                assert server.evicted_prefill_entries == len(lengths) - N
    print("memory_allocated, memory_reserved per length:", mem)
    assert max(a for a, _ in mem[N:]) <= mem[N - 1][0]
    for a, b in zip(outs["fresh"], outs["bounded"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_reduced_launcher_serves_on_card_as_the_plain_path(card, tmp_path, capsys, monkeypatch):
    """``--reduced --param-dtype bfloat16`` serves on the card through the
    padded kernel (launches > 0) with the tokens of the same command whose
    attention is the plain version."""
    import json

    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod

    args = ["--arch", "mixtral-8x22b", "--reduced", "--param-dtype", "bfloat16", "--prompt-len", "16",
            "--gen-steps", "8", "--artifact-dir", str(tmp_path)]
    got = {}
    for how in ("kernel", "plain"):
        if how == "plain":
            monkeypatch.setattr(attn_mod, "flash_attention", fa_ops.flash_attention_plain)
        before = fa_ops.flash_attention.launches
        assert serve.main(args) == 0
        out = capsys.readouterr().out
        got[how] = json.loads(next(ln for ln in out.splitlines() if ln.startswith("[serve] tokens: "))[16:])
        got[how + "_launches"] = fa_ops.flash_attention.launches - before
    assert got["kernel_launches"] > 0 and got["plain_launches"] == 0
    assert got["kernel"] == got["plain"]


@pytest.mark.gpu
def test_retier_round_trip_on_card(card, tmp_path):
    """Serve the reduced artifact under stats without the prefetcher and
    with a trace, re-tier from the trace, serve the re-tiered artifact with
    the predictor armed: the same tokens, no recompressed frame."""
    from repro_torch.core import TransitionPredictor, replan_from_trace, retier_artifact
    from repro_torch.serving import GenerationEngine, cold_start

    src = str(tmp_path / "artifact")
    model, result = _reduced_bf16(card, src)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1)).to(card)
    with cold_start(model, src, result, residency="stats", prefetch=False, trace=True, warm_shapes=((2, 16, 32),),
                    device=card) as server:
        want, before = GenerationEngine(server, max_seq=32).generate(prompt, 8)
        trace = server.tiered.trace
    plan, rep = replan_from_trace(result.plan, trace, result.reach)
    out_dir = str(tmp_path / "artifact-retier")
    meta = retier_artifact(src, plan, out_dir=out_dir, report=rep)
    assert meta["compaction"]["recompressed"] == 0 and rep.promoted_resident
    result.plan = plan
    with cold_start(model, out_dir, result, residency="stats", predictor=TransitionPredictor.from_trace(trace),
                    warm_shapes=((2, 16, 32),), device=card) as server:
        got, after = GenerationEngine(server, max_seq=32).generate(prompt, 8)
        assert server.prefetcher.drain(30.0)
    np.testing.assert_array_equal(got, want)
    print("faulted bytes before/after re-tiering:", before.faulted_bytes, after.faulted_bytes)


@pytest.mark.gpu
def test_daemon_apply_between_decode_replays_is_read_by_the_next(card, tmp_path):
    """Reduced Mixtral on the card, every unit resident, the online daemon
    attached. Between two replays of the decode graph on the same inputs an
    ``apply_plan`` demotes the whole hot set (evicted in place): the next
    replay equals the plain step on the emptied params and differs from the
    first. A second apply promotes it back (a synchronous preload): the
    replay after it equals the first bit for bit. Then, under strict with the
    daemon ticking after every step, ``generate`` gives the tokens of the
    same server without it."""
    import dataclasses

    from repro_torch.serving import GenerationEngine, RequestStats, cold_start
    from repro_torch.serving.engine import _graft_prefill_cache
    from repro_torch.utils.tree import flatten_with_paths, tree_map

    model, result = _reduced_bf16(card, str(tmp_path))
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(4)).to(card)
    with cold_start(model, str(tmp_path), result, residency="full", prefetch=False, retier_online=True,
                    retier_interval=10**9, warm_shapes=((2, 16, 32),), device=card) as server:
        tiered, daemon = server.tiered, server.retier_daemon
        tiered.ensure_all()

        def with_hot(plan, hot: bool):
            return dataclasses.replace(plan, decisions={
                p: dataclasses.replace(d, resident_units=tuple(u.key for u in d.units) if hot else ())
                if d.tier == 1 else d for p, d in plan.decisions.items()})

        tiered.plan = with_hot(tiered.plan, True)
        engine = GenerationEngine(server, max_seq=32)
        decode = server.compiled_decode(2, 32)
        logits, caches, _ = engine.prefill_step(prompt, RequestStats())
        _graft_prefill_cache(decode.caches, caches)
        saved = tree_map(torch.clone, decode.caches)
        dbatch = {"tokens": logits.argmax(-1)[:, None].long(), "pos": torch.full((2,), 16, device=card)}
        live = server.live_params()

        def replay():
            for (_, a), (_, b) in zip(flatten_with_paths(decode.caches), flatten_with_paths(saved)):
                a.copy_(b)
            out, _ = decode(live, decode.caches, dbatch)
            return out.float().clone()

        def plain():
            with torch.inference_mode():
                out, _ = model.decode_step(live, tree_map(torch.clone, saved), dbatch)
            return out.float()

        first = replay()
        assert daemon.apply_plan(with_hot(tiered.plan, False)) == {"promoted": 0, "demoted": len(tiered._all_units)}
        assert tiered.resident_bytes == 0
        emptied = replay()
        torch.testing.assert_close(emptied, plain(), atol=2e-2, rtol=2e-2)
        assert not torch.allclose(emptied, first, atol=1e-1)
        out = daemon.apply_plan(with_hot(tiered.plan, True), sync_preload=True)
        assert out["promoted"] == len(tiered._all_units) and tiered.resident_fraction() == 1.0
        assert torch.equal(replay(), first)
        assert daemon.stats.remote_applies == daemon.stats.invariant_checks == 2 and daemon.stats.errors == 0

    runs = {}
    for online in (False, True):
        with cold_start(model, str(tmp_path), result, residency="strict", retier_online=online, retier_interval=1,
                        warm_shapes=((2, 16, 32),), device=card) as server:
            runs[online], _ = GenerationEngine(server, max_seq=32).generate(prompt, 8)
            if online:
                s = server.retier_daemon.stats
                assert s.ticks == 8 and s.applies >= 1 and s.errors == 0 and s.invariant_checks == s.applies
                assert server.tiered.resident_bytes <= server.tiered.residency.budget_bytes
    np.testing.assert_array_equal(runs[True], runs[False])


@pytest.mark.gpu
def test_two_arbitered_tenants_serve_their_solo_tokens_on_card(card, tmp_path):
    """Two tenants cold-started from one reduced bf16 artifact under one
    HostArbiter whose budget is a single strict tenant's, each serving its
    own prompt from its own thread (b's request starts once a's prefill has
    returned, so b's pinned prefill must take a's unpinned units): both
    finish (joined with a timeout), each gives its solo strict tokens, the
    books audit, the budget holds at rest, the arbiter evicted across
    tenants, and close() unregisters both."""
    import threading

    from repro_torch.core import HostArbiter
    from repro_torch.serving import GenerationEngine, cold_start

    model, result = _reduced_bf16(card, str(tmp_path))
    prompts = [torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(10 + i))
               .to(card) for i in range(2)]
    solo = []
    for p in prompts:
        with cold_start(model, str(tmp_path), result, residency="strict", warm_shapes=((2, 16, 32),),
                        device=card) as server:
            budget = server.tiered.residency.budget_bytes
            solo.append(GenerationEngine(server, max_seq=32).generate(p, 8)[0])
    arb = HostArbiter(budget)
    servers = [cold_start(model, str(tmp_path), result, residency="strict", host_arbiter=arb, tenant_name=n,
                          warm_shapes=((2, 16, 32),), device=card) for n in "ab"]
    outs, errors = [None, None], []
    a_prefilled = threading.Event()

    def serve(i):
        try:
            eng = GenerationEngine(servers[i], max_seq=32)
            if i == 0:
                prefill = eng.prefill_step

                def prefill_then_signal(*args, **kw):
                    try:
                        return prefill(*args, **kw)
                    finally:
                        a_prefilled.set()
                eng.prefill_step = prefill_then_signal
            else:
                assert a_prefilled.wait(300), "tenant a's prefill never returned"
            outs[i] = eng.generate(prompts[i], 8)[0]
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)
        finally:
            a_prefilled.set()

    threads = [threading.Thread(target=serve, args=(i,), name=f"tenant-{i}") for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not [t.name for t in threads if t.is_alive()], "a tenant thread hung"
        assert not errors, errors
        for got, want in zip(outs, solo):
            np.testing.assert_array_equal(got, want)
        audit = arb.audit()
        assert audit["pinned_bytes"] == 0 and (audit["resident_bytes"] <= budget or arb.stats.overshoots > 0)
        assert audit["resident_bytes"] <= budget
        assert arb.stats.evictions > 0 and arb.stats.cross_evictions > 0
    finally:
        for s in servers:
            s.close()
    assert arb.tenants == {} and arb.stats.unregistered == 2


def _unit_rows(tiered, key):
    return tiered._unit_view(tiered._all_units[key])


@pytest.mark.gpu
def test_snapshot_restore_on_card(card, tmp_path):
    """A strict server warmed by one request writes its snapshot; a new one
    cold-starts with ``restore_from=``: every donor unit restored with the
    donor's stamps and LRU order, its rows on the card bit-equal to the
    donor's, the replayed bytes counted as upload, and the next request's
    tokens equal the donor's."""
    from repro_torch.core import snapshot as snap_mod
    from repro_torch.serving import GenerationEngine, cold_start

    art = str(tmp_path / "artifact")
    model, result = _reduced_bf16(card, art, policy="strict")
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(6)).to(card)
    kw = dict(residency="strict", warm_shapes=((2, 16, 32),), device=card)
    with cold_start(model, art, result, **kw) as donor:
        want, _ = GenerationEngine(donor, max_seq=32).generate(prompt, 8)
        snap = donor.snapshot()
        rows = {k: _unit_rows(donor.tiered, k).clone() for k, _ in snap["resident"]}
        stamps = dict(donor.tiered.residency._stamp)
    assert snap["resident"]
    path = str(tmp_path / "snap.json")  # outside the artifact
    snap_mod.save(snap, path)
    with cold_start(model, art, result, restore_from=path, **kw) as server:
        rr, tiered = server.restore_report, server.tiered
        assert rr["fingerprint_ok"] and rr["restored"] == rr["requested"] == len(snap["resident"])
        assert rr["moved_bytes"] == sum(tiered.unit_charge(k) for k in rows)
        assert server.report.bytes_uploaded == server.report.bytes_read + rr["moved_bytes"]
        assert list(tiered.residency._lru) == [k for k, _ in snap["resident"]]
        assert {k: tiered.residency._stamp[k] for k in rows} == {k: stamps[k] for k in rows}
        for k, r in rows.items():
            assert torch.equal(_unit_rows(tiered, k), r), k
        got, _ = GenerationEngine(server, max_seq=32).generate(prompt, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_fleet_late_joiner_bootstrap_on_card(card, tmp_path):
    """Two strict replicas with daemons in one ``FleetController``: replica-0
    serves, the fleet syncs, replica-1 cold-starts and is bootstrapped inside
    ``register`` (synchronous preload, reported as ``fleet_bootstrap``, not
    in its cold start's upload): it faults fewer
    units than replica-0 did, its bootstrapped rows equal replica-0's, and
    both give the tokens of a solo run."""
    from repro_torch.core import FleetController
    from repro_torch.serving import GenerationEngine, cold_start

    art = str(tmp_path / "artifact")
    model, result = _reduced_bf16(card, art, policy="strict")
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(7)).to(card)
    kw = dict(residency="strict", warm_shapes=((2, 16, 32),), device=card)
    with cold_start(model, art, result, **kw) as solo:
        want, _ = GenerationEngine(solo, max_seq=32).generate(prompt, 8)
    fc = FleetController()
    online = dict(retier_online=True, retier_interval=10**9, fleet=fc)
    with cold_start(model, art, result, replica_name="replica-0", **online, **kw) as r0:
        out0, st0 = GenerationEngine(r0, max_seq=32).generate(prompt, 8)
        summary = fc.sync()
        assert summary["replanned"] and summary["pushed"] == ["replica-0"] and not summary["failed"]
        with cold_start(model, art, result, **online, **kw) as r1:
            preloaded = [e.key for e in r1.tiered.stats.events]
            assert preloaded and all(e.source == "preload" for e in r1.tiered.stats.events)
            # the bootstrap is reported on its own; as in the reference, the
            # cold-start report leaves it out (strict has no hot set)
            assert r1.fleet_bootstrap["bytes"] == sum(e.nbytes for e in r1.tiered.stats.events)
            assert r1.fleet_bootstrap["seconds"] > 0 and r1.report.bytes_uploaded == r1.report.bytes_read
            for k in preloaded:
                if r0.tiered.is_resident(k) and r1.tiered.is_resident(k):
                    assert torch.equal(_unit_rows(r1.tiered, k), _unit_rows(r0.tiered, k)), k
            out1, st1 = GenerationEngine(r1, max_seq=32).generate(prompt, 8)
    assert fc.replicas == ["replica-0", "replica-1"]
    assert fc.stats.bootstraps == 1 and fc.stats.bootstrap_failures == 0 and not fc.last_errors
    assert st1.faulted_units < st0.faulted_units
    for out in (out0, out1):
        np.testing.assert_array_equal(out, want)


@pytest.mark.gpu
def test_decode_graph_replayed_after_a_fleet_push_reads_the_pushed_bytes(card, tmp_path):
    """Replica ``a`` captures its decode graph and takes replica ``b``'s
    prefill caches; ``b``'s prefill faults its units in; a fleet sync pushes
    them into ``a`` in place (a synchronous preload). The replay after the
    push equals the plain step on ``a``'s live params and differs from the
    replay before it; the pushed rows equal ``b``'s bit for bit; the decode
    entry is the one captured before (nothing captured again)."""
    from repro_torch.core import FleetController
    from repro_torch.serving import GenerationEngine, RequestStats, cold_start
    from repro_torch.serving.engine import _graft_prefill_cache
    from repro_torch.utils.tree import flatten_with_paths, tree_map

    art = str(tmp_path / "artifact")
    model, result = _reduced_bf16(card, art, policy="strict")
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(8)).to(card)
    fc = FleetController(sync_preload=True)
    kw = dict(residency="full", prefetch=False, retier_online=True, retier_interval=10**9, fleet=fc,
              warm_shapes=((2, 16, 32),), device=card)
    with cold_start(model, art, result, replica_name="a", **kw) as a, \
            cold_start(model, art, result, replica_name="b", **kw) as b:
        decode = a.compiled_decode(2, 32)
        entries = dict(a._compiled)
        logits, caches, _ = GenerationEngine(b, max_seq=32).prefill_step(prompt, RequestStats())
        _graft_prefill_cache(decode.caches, caches)
        saved = tree_map(torch.clone, decode.caches)
        dbatch = {"tokens": logits.argmax(-1)[:, None].long(), "pos": torch.full((2,), 16, device=card)}
        live = a.live_params()

        def replay():
            for (_, x), (_, y) in zip(flatten_with_paths(decode.caches), flatten_with_paths(saved)):
                x.copy_(y)
            out, _ = decode(live, decode.caches, dbatch)
            return out.float().clone()

        def plain():
            with torch.inference_mode():
                return model.decode_step(live, tree_map(torch.clone, saved), dbatch)[0].float()

        before_keys = a.tiered.resident_keys
        first = replay()
        summary = fc.sync()
        assert sorted(summary["pushed"]) == ["a", "b"] and not summary["failed"]
        installed = a.tiered.resident_keys - before_keys
        assert installed and a.retier_daemon.stats.remote_applies == 1
        for k in installed:
            assert torch.equal(_unit_rows(a.tiered, k), _unit_rows(b.tiered, k)), k
        pushed = replay()
        torch.testing.assert_close(pushed, plain(), atol=2e-2, rtol=2e-2)
        assert not torch.allclose(pushed, first, atol=1e-1)
        assert a._compiled == entries and a.compiled_decode(2, 32) is decode


# Gemma-3-27B's attention widths (H=32, Hkv=16: GQA group 2, hd 128):
# B, S, window — its local layers' prefill (window 1024 = S), its global
# layers' (no window), and a longer prompt where the window masks
GEMMA_CASES = [(2, 1024, 1024), (2, 1024, None), (1, 2048, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMMA_CASES, ids=str)
def test_kernel_matches_plain_at_gemma3_widths(card, case):
    B, S, window = case
    rs = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card, torch.bfloat16)
               for shape in ((B, S, 32, 128), (B, S, 16, 128), (B, S, 16, 128)))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    ref = fa_ops.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, window=window)
    assert ((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-2


def _zoo_server(arch, card, tmp, **kw):
    """``arch``'s reduced config as the launcher serves it on the card (bf16
    weights from a seeded generator, bf16 compute), on a strict artifact;
    ``kw`` goes to ``cold_start`` (default: strict residency)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import build_model
    from repro_torch.serving import cold_start

    cfg = get_reduced(arch)
    model = build_model(cfg.replace(collect_moe_usage=cfg.moe is not None), param_dtype=torch.bfloat16)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    result = analyze(model, profile, trace_B=1, trace_S=32)
    build_artifact(model.init(torch.Generator(card).manual_seed(0), device=card), result, tmp)
    kw.setdefault("residency", "strict")
    return model, cold_start(model, tmp, result, warm_shapes=((2, 16, 32),), device=card, **kw)


@pytest.mark.gpu
def test_reduced_gemma3_serves_the_plain_path_tokens_on_card(card, tmp_path):
    """Reduced Gemma-3 (head_dim 16 through the zero-padded hd-64 kernel,
    window 16) serves a 16-token prompt and 12 new tokens, so its local
    caches wrap: the tokens equal those of the same server with the plain
    attention, and every prefill run launched the kernel in all 6 layers."""
    from unittest import mock

    from repro_torch.models import attention as attn_mod
    from repro_torch.serving import GenerationEngine

    model, server = _zoo_server("gemma3-27b", card, str(tmp_path / "kernel"))
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(5)).to(card)
    with server:
        before = fa_ops.flash_attention.launches
        out, stats = GenerationEngine(server, max_seq=32).generate(prompt, 12)
        assert fa_ops.flash_attention.launches - before == 6 * stats.prefill_runs
    with mock.patch.object(attn_mod, "flash_attention", fa_ops.flash_attention_plain):
        model, server = _zoo_server("gemma3-27b", card, str(tmp_path / "plain"))
        with server:
            before = fa_ops.flash_attention.launches
            want, _ = GenerationEngine(server, max_seq=32).generate(prompt, 12)
            assert fa_ops.flash_attention.launches == before
    np.testing.assert_array_equal(out, want)


@pytest.mark.gpu
def test_deepseek_decode_graph_is_bit_equal_to_eager_and_writes_latents_in_place(card, tmp_path):
    """Reduced DeepSeek-V2-Lite on a full server: the decode graph replayed
    on grafted prefill caches gives the eager step's logits and caches bit
    for bit, writes ``ckv`` / ``kr`` of its own caches in place (the same
    storage before and after), and launches no kernel."""
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.serving import GenerationEngine, RequestStats
    from repro_torch.serving.engine import _graft_prefill_cache, commit_decode_caches
    from repro_torch.utils.tree import flatten_with_paths, tree_map

    model, server = _zoo_server("deepseek-v2-lite-16b", card, str(tmp_path), residency="full", prefetch=False)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(6)).to(card)
    with server:
        engine = GenerationEngine(server, max_seq=32)
        logits, caches, _ = engine.prefill_step(prompt, RequestStats())
        server.tiered.ensure_all()
        decode = server.compiled_decode(2, 32)
        _graft_prefill_cache(decode.caches, caches)
        latents = {p: t.data_ptr() for p, t in flatten_with_paths(decode.caches) if p.endswith((".ckv", ".kr"))}
        assert len(latents) == 2 * 2  # the lead layer's and the groups' stacked ckv and kr
        live = server.live_params()
        tok = logits.argmax(-1)[:, None].long()
        launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
        for step in range(3):
            batch = {"tokens": tok, "pos": torch.full((2,), 16 + step, device=card)}
            mine = tree_map(torch.clone, decode.caches)
            with torch.inference_mode():
                want_logits, want = model.decode_step(live, mine, batch)
            commit_decode_caches(mine, want)
            got_logits, got = decode(live, decode.caches, batch)
            commit_decode_caches(decode.caches, got)
            torch.cuda.synchronize()
            assert torch.equal(got_logits, want_logits)
            for (p, a), (_, b) in zip(flatten_with_paths(decode.caches), flatten_with_paths(mine)):
                assert torch.equal(a, b), p
            assert {p: t.data_ptr() for p, t in flatten_with_paths(decode.caches) if p in latents} == latents
            tok = got_logits.argmax(-1)[:, None].long()
        assert {name: fn.launches for name, fn in kernel_wrappers().items()} == launches


@pytest.mark.gpu
def test_xlstm_graphs_are_bit_equal_to_eager_and_launch_nothing(card, tmp_path):
    """Reduced xLSTM on a full server: the prefill graph at a chunkwise
    prompt (32 = two chunks) and the decode graph replayed on its grafted
    caches give the eager calls' logits and caches bit for bit; the state
    leaves stay fp32 through the graphs' static outputs and the commit, and
    no kernel launches."""
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.serving.engine import _graft_prefill_cache, commit_decode_caches
    from repro_torch.utils.tree import flatten_with_paths, tree_map

    model, server = _zoo_server("xlstm-125m", card, str(tmp_path), residency="full", prefetch=False)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(6)).to(card)
    with server:
        server.tiered.ensure_all()
        live = server.live_params()
        launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
        prefill = server.compiled_prefill(2, 32)
        logits, caches = prefill(live, {"tokens": prompt})
        with torch.inference_mode():
            want_logits, want_caches = model.prefill(live, {"tokens": prompt})
        torch.cuda.synchronize()
        assert torch.equal(logits, want_logits)
        for (p, a), (_, b) in zip(flatten_with_paths(caches), flatten_with_paths(want_caches)):
            assert torch.equal(a, b), p
        decode = server.compiled_decode(2, 48)
        _graft_prefill_cache(decode.caches, caches)
        dtypes = {p: t.dtype for p, t in flatten_with_paths(decode.caches)}
        assert {p for p, d in dtypes.items() if d != torch.float32} == {"groups.u0.conv"}
        tok = logits.argmax(-1)[:, None].long()
        for step in range(3):
            batch = {"tokens": tok, "pos": torch.full((2,), 32 + step, device=card)}
            mine = tree_map(torch.clone, decode.caches)
            with torch.inference_mode():
                want_logits, want = model.decode_step(live, mine, batch)
            commit_decode_caches(mine, want)
            got_logits, got = decode(live, decode.caches, batch)
            commit_decode_caches(decode.caches, got)
            torch.cuda.synchronize()
            assert torch.equal(got_logits, want_logits)
            for (p, a), (_, b) in zip(flatten_with_paths(decode.caches), flatten_with_paths(mine)):
                assert torch.equal(a, b) and a.dtype == dtypes[p], p
            tok = got_logits.argmax(-1)[:, None].long()
        assert {name: fn.launches for name, fn in kernel_wrappers().items()} == launches


def _grad_guard_call(name, card):
    """(wrapper call, its inputs) for one kernel at a small shape it takes."""
    g = torch.Generator(card).manual_seed(0)
    if name == "flash_attention":
        q, k, v = (torch.randn(1, 64, 4, 64, generator=g, device=card).to(torch.bfloat16) for _ in range(3))
        return (lambda: fa_ops.flash_attention(q, k, v)), (q, k, v)
    if name == "rglru_scan":
        a, b = (torch.rand(1, 64, 128, generator=g, device=card) for _ in range(2))
        return (lambda: lru_ops.rglru_scan(a, b)), (a, b)
    if name == "decode_attention":
        q = torch.randn(2, 4, 64, generator=g, device=card).to(torch.bfloat16)
        k, v = (torch.randn(2, 128, 2, 64, generator=g, device=card).to(torch.bfloat16) for _ in range(2))
        return (lambda: da_ops.decode_attention(q, k, v, 100)), (q, k, v)
    table = torch.randn(256, 64, generator=g, device=card).to(torch.bfloat16)
    ids = torch.randint(0, 256, (32,), generator=torch.Generator().manual_seed(1)).to(card)
    mask = torch.ones(4, dtype=torch.bool, device=card)
    if name == "tiered_gather":
        return (lambda: tg_ops.tiered_gather(table, ids, mask, group_size=64)), (table,)
    w = torch.randn(64, 128, generator=g, device=card).to(torch.bfloat16)
    return (lambda: tg_ops.tiered_gather_matmul(table, w, ids, mask, group_size=64)), (table, w)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan", "decode_attention", "tiered_gather",
                                  "tiered_gather_matmul"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(card, name):
    """No kernel has a backward: with grad mode on and an input that requires
    grad, the CUDA launch raises, naming the plain version, and counts
    nothing; under ``torch.no_grad()`` the same call launches."""
    from repro_torch.kernels import kernel_wrappers

    call, inputs = _grad_guard_call(name, card)
    wrapper = kernel_wrappers()[name]
    call()  # builds the kernel
    for t in inputs:
        t.requires_grad_(True)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match=f"{name}_plain"):
        call()
    assert wrapper.launches == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1


@pytest.mark.gpu
def test_training_on_card_launches_no_kernel_and_resumes(card, tmp_path):
    """Reduced Mixtral with head_dim 64 (a width the flash kernel takes)
    trains on the card: attention runs plain under autograd, so no kernel
    launches and the guard never trips; the loss is finite and falls over 6
    steps, and a run preempted at 3 and resumed by a fresh Trainer ends on
    the uninterrupted run's params."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.utils.tree import flatten_with_paths

    model = _reduced_card_model()
    data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 64, 4, seed=1))
    tc = TrainConfig(num_steps=6, save_every=3, warmup_steps=1, adamw=AdamWConfig(lr=1e-3))
    launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
    straight = Trainer(model, tc, data, str(tmp_path / "a"), device=card)
    r = straight.run()
    assert all(np.isfinite(r.losses)) and r.losses[-1] < r.losses[0]
    Trainer(model, tc, data, str(tmp_path / "b"), device=card).run(3)
    resumed = Trainer(model, tc, data, str(tmp_path / "b"), device=card)
    assert resumed.run().restored_from == 3
    assert {name: fn.launches for name, fn in kernel_wrappers().items()} == launches
    for (p, a), (_, b) in zip(flatten_with_paths(straight.params), flatten_with_paths(resumed.params)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=p)


@pytest.fixture
def world_of_one(card):
    """A one-rank NCCL world on an in-memory store, torn down after the test."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.gpu
def test_one_rank_mesh_cold_start_on_card(card, tmp_path, world_of_one):
    """Reduced Mixtral (strict, bf16) cold-started with a 1×1 mesh and with
    none: the same tokens, charged and loaded bytes, budget and flash
    launches; every divisor 1, and the warm set still captured as CUDA
    graphs (the gather of a mesh of 1s is the local tensor itself)."""
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serving import GenerationEngine, GraphEntry, cold_start

    model, result = _reduced_bf16(card, str(tmp_path), policy="strict")
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(8)).to(card)
    flash = kernel_wrappers()["flash_attention"]
    runs = {}
    for label, mesh in (("plain", None), ("mesh", make_debug_mesh(1, 1, device="cuda"))):
        before = flash.launches
        with cold_start(model, str(tmp_path), result, residency="strict", warm_shapes=((2, 16, 28),), mesh=mesh,
                        device=card) as server:
            out, _ = GenerationEngine(server, max_seq=28).generate(prompt, 4)
            t = server.tiered
            runs[label] = dict(out=out.tolist(), charged=t.residency.charged_bytes(),
                               loaded=t.stats.total_loaded_bytes, budget=t.residency.budget_bytes,
                               divs=set(t._shard_div.values()), kind=server.entry_kind,
                               graphs=all(isinstance(e, GraphEntry) for e in server._compiled.values()),
                               flash=flash.launches - before)
    assert runs["mesh"]["divs"] == {1} and runs["mesh"]["kind"] == "graph" and runs["mesh"]["graphs"]
    for k in ("out", "charged", "loaded", "budget", "flash", "kind"):
        assert runs["plain"][k] == runs["mesh"][k], k
    assert runs["mesh"]["flash"] > 0


@pytest.mark.gpu
def test_compressed_psum_over_a_one_rank_axis_on_card(card, world_of_one):
    """Over a 1-rank ``pod`` dim of a one-rank NCCL world: the mean is
    ``dequantize_int8(quantize_int8(g))`` and the residual ``g`` minus it,
    bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import world_size
    from repro_torch.optim import EFState, compressed_psum, dequantize_int8, quantize_int8
    from repro_torch.sharding import use_mesh

    assert world_size("cuda", 1) == 1
    g = torch.randn(257, 129, generator=torch.Generator(card).manual_seed(2), device=card)
    with use_mesh(init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))):
        avg, ef = compressed_psum({"g": g}, EFState({"g": torch.zeros_like(g)}), "pod")
    want = dequantize_int8(*quantize_int8(g))
    assert torch.equal(avg["g"], want) and torch.equal(ef.residual["g"], g - want)


@pytest.mark.gpu
def test_cost_counter_on_a_cuda_matmul(card):
    """``utils.hlocost.analyze`` on the card: a bf16 (256×512)·(512×128)
    matmul counts 2·256·512·128 dot FLOPs and its operands and result in
    bytes."""
    from repro_torch.utils.hlocost import analyze

    gen = torch.Generator(card).manual_seed(0)
    a = torch.randn(256, 512, generator=gen, device=card).to(torch.bfloat16)
    b = torch.randn(512, 128, generator=gen, device=card).to(torch.bfloat16)
    cost = analyze(torch.matmul, a, b)
    assert cost.dot_flops == cost.flops == 2 * 256 * 512 * 128
    assert cost.bytes == 2 * (256 * 512 + 512 * 128 + 256 * 128)
    assert cost.collective_bytes == 0


@pytest.mark.gpu
def test_dryrun_cells_on_card_allocate_nothing(card):
    """``launch.dryrun.run_cell`` with fake tensors on ``cuda``: reduced
    Mixtral at B=4, S=64 on a 2×2 fake world, each kind ``ok`` with its
    argument bytes equal to the closed form of its shardings, no card
    memory allocated and no kernel launched."""
    from dataclasses import fields

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.launch import dryrun

    cfg = get_reduced("mixtral-8x22b")
    extra = {f.name: getattr(cfg, f.name) for f in fields(cfg)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
    for kind in ("prefill", "decode", "train"):
        rec = dryrun.run_cell("mixtral-8x22b", ShapeSpec(f"{kind}_b4s64", 64, 4, kind), mesh_shape=(2, 2),
                              device="cuda", out_dir=None, verbose=False, extra_cfg=extra)
        assert rec["status"] == "ok" and rec["num_chips"] == 4 and rec["collective_bytes"] > 0, kind
        assert rec["memory"]["argument_size_in_bytes"] == rec["closed_form_argument_bytes"], kind
        assert rec["memory"]["peak_size_in_bytes"] >= rec["memory"]["argument_size_in_bytes"], kind
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) == before
    assert {name: fn.launches for name, fn in kernel_wrappers().items()} == launches


@pytest.mark.gpu
def test_thread_ranks_refuse_a_cuda_backward(card):
    """``ThreadComm`` raises, and nothing hangs, when a rank's backward
    reaches a collective on CUDA tensors (the autograd engine would run every
    rank's CUDA backward on one device thread); the forward alone runs."""
    from repro_torch.sharding.comm import run_ranks

    def rank(comm):
        x = torch.ones(4, device="cuda", requires_grad=True)
        y = comm.all_reduce(comm.enter(x, "model") * 2.0, "model")
        if comm.index("model") == 0:
            assert torch.equal(y, torch.full_like(y, 4.0))
        y.sum().backward()

    with pytest.raises(RuntimeError, match="ThreadComm cannot run a CUDA backward"):
        run_ranks({"data": 1, "model": 2}, rank)
