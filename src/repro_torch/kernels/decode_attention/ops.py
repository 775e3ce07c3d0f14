"""One-token decode attention over a dense or a paged KV cache: the
hand-written CUDA kernel, its plain PyTorch versions, and the wrappers that
pick between them by device.

``decode_attention`` has the contract of ``repro.kernels.decode_attention.
ops.decode_attention`` (q (B, H, hd), cache (B, Skv, Hkv, hd), GQA by
``kv_head = head // (H // Hkv)``, ``kv_len`` scalar or (B,), clamped to
Skv for linear and rolling caches alike, tanh ``softcap``);
``paged_decode_attention`` that of ``...ops.paged_decode_attention`` (pool
(P, ps, Hkv, hd), table (B, NP), kv_len clamped to NP·ps, the table's
logical tail clamped to the slot's last occupied page and every entry to
[0, P-1]). For a CPU tensor each runs its plain version after those clamps;
for a CUDA tensor it launches the kernel in ``csrc/decode_attention.cu``
(bf16, hd 64, 128 or 256, G = H / Hkv up to 16), which applies the same
clamps per slot, or raises. There is no fallback between the two. A slot
with kv_len 0 is held to nothing: the plain version returns the mean of V
there and the kernel 0 (every caller passes kv_len = pos + 1 >= 1).

The served decode (``models.attention.gqa_decode``) calls
``decode_attention_plain`` directly, as the reference's calls
``decode_attention_jnp``; only ``paged_gqa_decode`` reaches a kernel here.

The kernel is compiled with ``nvcc`` at first use, from the source in this
package, into ``<repo>/build/decode_attention/`` and loaded with ``ctypes``
(``kernels.nvcc``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.kernels import nvcc, refuse_grad

NEG_INF = -1.0e30

_SRC = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 16  # query heads per KV head: the rows of the kernel's mma tile
_TILE = 64  # keys per tile; a split's chunk is a multiple of it
# the splits of one (slot, KV head) form thread-block clusters of up to 8
# (the portable size); more than 8 splits come in clusters of 8, at most 128
_CLUSTER = 8
_MAX_SPLITS = 1024
# a split owns at least 2 tiles (when the cache has them), so its ring has
# the next tile's loads in flight while it multiplies one
_MIN_TILES = 2
# what a block costs beside its tiles (Q load, filling the ring, the two
# merges), in tile times: the plan's cost model charges it once per wave
_BLOCK_OVERHEAD_TILES = 1
# what the merge of several clusters adds (a partial through L2, a counter,
# the last cluster's pass over the others'), in tile times
_CLUSTER_MERGE_TILES = 2
# a block streams about 1/90 of what the card can: on an NVIDIA H100 80GB
# HBM3 (700 W) 64 blocks of one split each moved 34 GB/s apiece and 128
# blocks 3.05 TB/s in all (PERF.md; kernel_ab.py --splits), so a call
# whose work could keep 90 blocks busy is bound by the card's bytes, and
# then the fewest splits that reach it read best
_CARD_BLOCKS = 90
# a paged call's work list: `blocks` at most (the kernel's MAX_BLOCKS: one
# pair's items, at most `blocks`, have their merge weights in shared memory)
_MAX_BLOCKS = 1024
# the most bytes of fp32 partials that the last item of a pair may have to
# merge, G·hd·4 bytes an item, where one pair holds all the call's keys: a
# block's lone pass over them is serial work after the call's last item
_MERGE_BYTES = 1 << 20
_lib: Optional[ctypes.CDLL] = None
# the clusters' (dense) and work items' (paged) counters of a call that
# merges through device memory, per (device, stream): zero between calls
# (the kernel's last cluster or item of a pair resets its own)
_counters: dict[tuple[int, int], torch.Tensor] = {}

Lengths = Union[int, torch.Tensor]


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, hd), roped
    k_cache: torch.Tensor,  # (B, Skv, Hkv, hd)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) number of valid cache entries
    *,
    rolling: bool = False,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over a KV cache, in fp32 (``decode_attention_jnp``).
    For a rolling cache every slot is valid once kv_len >= Skv."""
    B, H, hd = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, hd).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    s = _softcap(s * hd**-0.5, softcap)
    idx = torch.arange(Skv, device=q.device)
    limit = torch.clamp(kv_len, max=Skv) if rolling else kv_len
    valid = idx[None, :] < limit[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, H, hd).to(q.dtype)


def densify_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, Hkv, hd) pool + (B, NP) table -> (B, NP·ps, Hkv, hd) dense
    cache in logical order (``repro.models.attention.densify_pages``)."""
    B, NP = page_table.shape
    _, ps, Hkv, hd = pages.shape
    return pages[page_table.long()].reshape(B, NP * ps, Hkv, hd)


def paged_decode_attention_plain(
    q: torch.Tensor,  # (B, H, hd), roped
    k_pages: torch.Tensor,  # (P, ps, Hkv, hd)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, NP), entries in [0, P)
    kv_len: torch.Tensor,  # (B,)
    *,
    rolling: bool = False,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Densify through the page table, then the dense plain version
    (``decode_attention_paged_jnp``)."""
    return decode_attention_plain(q, densify_pages(k_pages, page_table), densify_pages(v_pages, page_table),
                                  kv_len, rolling=rolling, softcap=softcap)


def _lengths(kv_len: Lengths, B: int, device: torch.device) -> torch.Tensor:
    kv_len = torch.as_tensor(kv_len, device=device).to(torch.int32)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(B)
    if kv_len.shape != (B,):
        raise ValueError(f"kv_len must be a scalar or ({B},), got {tuple(kv_len.shape)}")
    return kv_len.contiguous()


def clamp_page_table(page_table: torch.Tensor, kv_len: torch.Tensor, n_pages: int, ps: int) -> torch.Tensor:
    """The reference wrapper's table clamp: logical pages past the slot's
    last occupied one repeat it, and every entry is clipped to [0, P-1].
    ``kv_len`` is already clamped to NP·ps."""
    NP = page_table.shape[1]
    last = torch.clamp((kv_len.long() + ps - 1) // ps - 1, min=0)
    logical = torch.minimum(torch.arange(NP, device=page_table.device)[None, :], last[:, None])
    return torch.gather(page_table.long(), 1, logical).clamp(0, n_pages - 1)


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source version) and return the shared
    library's path and the compiler's register/shared-memory report."""
    return nvcc.build("decode_attention", _SRC)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = nvcc.load("decode_attention", _SRC)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, kv_len, o, ws, count | B, H, Hkv, hd, Skv, chunk, splits | softcap, scale, stream
        lib.decode_attention_bf16.argtypes = [ptr] * 7 + [i32] * 7 + [f32, f32, ptr]
        # q, k_pages, v_pages, page_table, kv_len, o, ws, count | B, H, Hkv, hd, P, ps, NP, blocks |
        # softcap, scale, stream
        lib.paged_decode_attention_bf16.argtypes = [ptr] * 8 + [i32] * 8 + [f32, f32, ptr]
        # hd, paged | blocks (out, 8 ints)
        lib.decode_attention_resident.argtypes = [i32, i32, ptr]
        lib.decode_attention_bf16.restype = lib.paged_decode_attention_bf16.restype = i32
        lib.decode_attention_resident.restype = i32
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def resident_blocks(device: torch.device, hd: int, paged: bool) -> tuple[int, ...]:
    """Blocks of the kernel that the card ``device`` holds at once when the
    splits of a (slot, KV head) form clusters of 1, ..., 8 blocks, as CUDA's
    cluster occupancy reports them. A cluster must fit one GPC, so from 3
    splits on this is less than the SMs times the blocks one SM holds."""
    blocks = (ctypes.c_int * _CLUSTER)()
    with torch.cuda.device(device):
        _raise_on(_library().decode_attention_resident(hd, int(paged), blocks), "decode-attention occupancy")
    return tuple(blocks)


def _split_candidates(tiles: int):
    """(tiles per split, splits) that cover ``tiles`` with no split past
    the end: one cluster of 1..8 splits, then whole clusters of 8."""
    for want in range(1, _CLUSTER + 1):
        per = -(-tiles // want)
        yield per, -(-tiles // per)
    for splits in range(2 * _CLUSTER, min(_MAX_SPLITS, tiles) + 1, _CLUSTER):
        per = -(-tiles // splits)
        if (splits - 1) * per < tiles:
            yield per, splits


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, Hkv: int, cap: int, resident: tuple[int, ...]) -> tuple[int, int]:
    """(chunk, splits) of a dense call: the KV positions each block owns and
    the blocks per (slot, KV head): one cluster of up to 8, or up to 128
    clusters of 8, for a card that holds ``resident[s - 1]`` blocks at once
    in clusters of s. The call reads B·Hkv·tiles 64-key tiles. The plan
    minimises, in tile times, the largest of the waves of full splits ×
    (tiles per split + a block's overhead + the clusters' merge where there
    are several), the waves of all the call's blocks × (that overhead and
    merge) and the work over the card's rate (_CARD_BLOCKS blocks): short
    caches get splits of at least 2 tiles (the last one too), long ones the
    fewest splits that keep the card's bytes busy in whole waves, so a few
    (slot, KV head) pairs over a long cache get several clusters each."""
    tiles = -(-cap // _TILE)
    work = B * Hkv * tiles
    best = None
    for per, splits in _split_candidates(tiles):
        csize = min(splits, _CLUSTER)
        if splits > 1 and (per < _MIN_TILES or tiles - (splits - 1) * per < _MIN_TILES):
            continue
        if resident[csize - 1] < csize:
            continue
        full = -(-work // per)  # blocks of a whole split that the work fills
        waves = -(-full // resident[csize - 1])
        waves_all = -(-B * Hkv * splits // resident[csize - 1])
        fixed = _BLOCK_OVERHEAD_TILES + (_CLUSTER_MERGE_TILES if splits > _CLUSTER else 0)
        cost = max(waves * (per + fixed), waves_all * fixed, work / _CARD_BLOCKS)
        if best is None or cost < best[0]:
            best = (cost, per * _TILE, splits)
    return (tiles * _TILE, 1) if best is None else best[1:]


def dense_plan(q: torch.Tensor, k_cache: torch.Tensor) -> tuple[int, int]:
    """``split_plan`` of a dense-cache launch on q's card."""
    B, _, hd = q.shape
    return split_plan(B, k_cache.shape[2], k_cache.shape[1], resident_blocks(q.device, hd, False))


def paged_work_items(kv_len: torch.Tensor, Hkv: int, cap: int, blocks: int) -> torch.Tensor:
    """The paged kernel's work list, as each of its blocks builds it from
    kv_len on the card (nothing on the card's path calls this mirror): slot
    b holds T_b = ceil(len_b / 64) tiles per KV head, len_b = kv_len[b]
    clamped to [0, cap]; of the call's total = Hkv·Σ T_b tiles an item takes
    at most per = max(ceil(total / blocks), 2); each (slot, KV head) gets
    ceil(T_b / per) items, item j of n covering tiles [j·T_b // n, (j + 1)·
    T_b // n). Returns (items, 4) int64 rows (slot, KV head, start, end) in
    the kernel's item order (slot by slot, KV head by KV head), end clipped
    to len_b; a slot with no admitted key has none."""
    lens = kv_len.long().clamp(0, cap)
    tiles = (lens + _TILE - 1) // _TILE
    total = Hkv * int(tiles.sum())
    per = max(-(-total // blocks), _MIN_TILES)
    n = (tiles + per - 1) // per  # items per (slot, KV head)
    slot = torch.repeat_interleave(torch.arange(len(lens), device=lens.device), n * Hkv)
    first = torch.cumsum(n * Hkv, 0) - n * Hkv
    within = torch.arange(len(slot), device=lens.device) - first[slot]
    kvh, j = within // n[slot], within % n[slot]
    start = j * tiles[slot] // n[slot] * _TILE
    end = torch.minimum((j + 1) * tiles[slot] // n[slot] * _TILE, lens[slot])
    return torch.stack([slot, kvh, start, end], 1)


@functools.lru_cache(maxsize=4096)
def paged_blocks(B: int, Hkv: int, G: int, hd: int, work: int, resident: int) -> int:
    """The ``blocks`` of a paged launch, from what the host knows: B·Hkv
    (slot, KV head) pairs, ``work`` tiles at most (the pool's), a card that
    holds ``resident`` blocks at once. The grid is blocks + B·Hkv, the most
    items the work list can have. The plan takes half the resident blocks
    (a block streams about 1/90 of the card, so that many keep its bytes
    busy, and larger items mean fewer merges through device memory; the
    sweeps in PERF.md, from kernel_ab.py --blocks), within the whole
    resident waves that hold the pairs and half a wave of items more, and
    no more blocks than give every item 2 tiles of the pool's work or let
    one pair's merge read more than _MERGE_BYTES of partials."""
    pairs = B * Hkv
    waves = max(1, -(-(pairs + resident // 2) // resident))
    blocks = min(waves * resident - pairs, max(resident // 2, (waves - 1) * resident))
    return max(1, min(blocks, work // _MIN_TILES, _MERGE_BYTES // (G * hd * 4), _MAX_BLOCKS))


def paged_plan(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor) -> int:
    """``paged_blocks`` of a paged launch on q's card. Its slots are as long
    as the table at most, and all of them together no longer than the pool:
    P·ps positions per KV head, and a partial tile per slot."""
    B, H, hd = q.shape
    P, ps, Hkv = k_pages.shape[:3]
    work = Hkv * (-(-P * ps // _TILE) + B)
    return paged_blocks(B, Hkv, H // Hkv, hd, work, resident_blocks(q.device, hd, True)[0])


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, softcap, *extra) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode attention wants q (B, H, hd) and k, v of one 4-d shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[3] != hd or B == 0 or Hkv == 0 or H % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache {tuple(k.shape)}")
    if H // Hkv > _MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes up to {_MAX_GROUP} query heads per KV head, got {H // Hkv}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel supports head_dim {_HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16, {name} is {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in extra:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _merge_buffers(device: torch.device, pairs: int, G: int, hd: int, partials: int):
    """(ws, count) of a launch whose (slot, KV head) pairs merge ``partials``
    fp32 outputs in all through device memory: fresh room for them and their
    log-sum-exps, and the current stream's counters, zero between calls."""
    ws = torch.empty(partials * G * (hd + 1), dtype=torch.float32, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    count = _counters.get(key)
    if count is None or count.numel() < pairs:
        count = _counters[key] = torch.zeros(pairs, dtype=torch.int32, device=device)
    return ws, count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def decode_attention(
    q: torch.Tensor,  # (B, H, hd)
    k_cache: torch.Tensor,  # (B, Skv, Hkv, hd)
    v_cache: torch.Tensor,
    kv_len: Lengths,  # scalar or (B,)
    *,
    rolling: bool = False,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Dense-cache decode: ``decode_attention_plain`` for CPU tensors, the
    CUDA kernel for CUDA tensors (``decode_attention.launches`` counts
    launches). ``rolling`` changes nothing once kv_len is clamped to Skv;
    it is kept for the reference's signature."""
    B, H, hd = q.shape
    Skv = k_cache.shape[1]
    if q.device.type == "cpu":
        kv_len = torch.clamp(_lengths(kv_len, B, q.device), max=Skv)
        return decode_attention_plain(q, k_cache, v_cache, kv_len, rolling=rolling, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k_cache, v_cache, softcap)
    refuse_grad("decode_attention_plain", q, k_cache, v_cache)
    if Skv == 0:
        raise ValueError("the cache holds no position")
    kv_len = _lengths(kv_len, B, q.device)
    Hkv = k_cache.shape[2]
    chunk, splits = dense_plan(q, k_cache)
    o = torch.empty_like(q)
    ws, count = None, None  # up to 8 splits a pair merge in their cluster
    if splits > _CLUSTER:
        ws, count = _merge_buffers(q.device, B * Hkv, H // Hkv, hd, B * Hkv * (splits // _CLUSTER))
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(), o.data_ptr(), _ptr(ws),
            _ptr(count), B, H, Hkv, hd, Skv, chunk, splits, float(softcap or 0.0), hd**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "decode-attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, hd)
    k_pages: torch.Tensor,  # (P, ps, Hkv, hd)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, NP)
    kv_len: Lengths,  # scalar or (B,)
    *,
    rolling: bool = False,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode: the clamps, then ``paged_decode_attention_plain`` for
    CPU tensors; the CUDA kernel for CUDA tensors
    (``paged_decode_attention.launches`` counts launches)."""
    B, H, hd = q.shape
    P, ps = k_pages.shape[:2]
    NP = page_table.shape[1]
    if q.device.type == "cpu":
        kv_len = torch.clamp(_lengths(kv_len, B, q.device), max=NP * ps)
        pt = clamp_page_table(page_table, kv_len, P, ps)
        return paged_decode_attention_plain(q, k_pages, v_pages, pt, kv_len, rolling=rolling, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not {q.device}")
    page_table = page_table.to(torch.int32)
    _check_cuda_inputs(q, k_pages, v_pages, softcap, ("page_table", page_table))
    refuse_grad("paged_decode_attention_plain", q, k_pages, v_pages)
    if page_table.dim() != 2 or page_table.shape[0] != B or NP == 0 or P == 0 or ps == 0:
        raise ValueError(f"bad pool or table: pool {tuple(k_pages.shape)}, table {tuple(page_table.shape)}")
    kv_len = _lengths(kv_len, B, q.device)
    Hkv = k_pages.shape[2]
    blocks = paged_plan(q, k_pages, page_table)
    o = torch.empty_like(q)
    ws, count = _merge_buffers(q.device, B * Hkv, H // Hkv, hd, blocks + B * Hkv)  # one partial an item
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(), kv_len.data_ptr(),
            o.data_ptr(), ws.data_ptr(), count.data_ptr(), B, H, Hkv, hd, P, ps, NP, blocks,
            float(softcap or 0.0), hd**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "paged decode-attention")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
