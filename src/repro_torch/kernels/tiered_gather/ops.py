"""Residency-masked row gather and gather-matmul: the hand-written CUDA
kernels, their plain PyTorch versions, and the wrappers that pick between
them by device.

``tiered_gather(table, ids, group_mask, group_size=)`` returns (rows (N, D),
zeros for misses; miss (N,) int32) and ``tiered_gather_matmul(table, w, ids,
group_mask, group_size=)`` returns (table[ids] @ w with zero rows for
misses, in the table's dtype; miss), the contracts of
``repro.kernels.tiered_gather.ops``: a row is a hit when its id lies in
[0, V) and its row group ``id // group_size`` has a nonzero mask entry. The
wrappers cast ids and group_mask to int32. For CPU tensors they run the
plain versions; for CUDA tensors they launch the kernels in
``csrc/tiered_gather.cu`` (gather: any 2- or 4-byte dtype; gather-matmul:
bf16 table and weight, D and F multiples of 8), or raise. There is no
fallback between the two.

The JAX package calls these kernels from its tests only, and so does the
port: they lie on no served path.

The kernels are compiled with ``nvcc`` at first use, from the source in
this package, into ``<repo>/build/tiered_gather/`` and loaded with
``ctypes`` (``kernels.nvcc``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc, refuse_grad

_SRC = Path(__file__).resolve().parent / "csrc" / "tiered_gather.cu"
_lib: Optional[ctypes.CDLL] = None


def tiered_gather_plain(
    table: torch.Tensor,  # (V, D)
    ids: torch.Tensor,  # (N,)
    group_mask: torch.Tensor,  # (G,), nonzero = resident
    *,
    group_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``tiered_gather_ref``: gather the clipped ids, zero the rows that are
    out of range or in a cold group, and flag them in ``miss``."""
    V = table.shape[0]
    in_range = (ids >= 0) & (ids < V)
    safe = ids.clamp(0, V - 1).long()
    ok = in_range & (group_mask[safe // group_size] > 0)
    rows = table[safe]
    out = torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))
    return out, (~ok).to(torch.int32)


def tiered_gather_matmul_plain(
    table: torch.Tensor,  # (V, D)
    w: torch.Tensor,  # (D, F)
    ids: torch.Tensor,
    group_mask: torch.Tensor,
    *,
    group_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``tiered_gather_matmul_ref``: the gather (zeros for misses), then the
    product at full width, accumulated in fp32 and cast to the table's
    dtype, so miss rows come out exactly zero."""
    rows, miss = tiered_gather_plain(table, ids, group_mask, group_size=group_size)
    out = (rows.to(torch.float32) @ w.to(torch.float32)).to(table.dtype)
    return out, miss


def build() -> tuple[Path, str]:
    """Compile both kernels (once per source version) and return the shared
    library's path and the compiler's register/shared-memory report."""
    return nvcc.build("tiered_gather", _SRC)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = nvcc.load("tiered_gather", _SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # table, ids, group_mask, out, miss | N, V, row_bytes, group_size | stream
        lib.tiered_gather.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        # table, w, ids, group_mask, out, miss, work | N, V, D, F, group_size | stream
        lib.tiered_gather_matmul_bf16.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.tiered_gather.restype = lib.tiered_gather_matmul_bf16.restype = i32
        _lib = lib
    return _lib


def _as_int32(ids: torch.Tensor, group_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ids.to(torch.int32), group_mask.to(torch.int32)


def _check_cuda_inputs(table: torch.Tensor, ids: torch.Tensor, group_mask: torch.Tensor, group_size: int) -> None:
    if table.dim() != 2 or ids.dim() != 1 or group_mask.dim() != 1:
        raise ValueError(f"want table (V, D), ids (N,), group_mask (G,); got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(group_mask.shape)}")
    V = table.shape[0]
    if V == 0 or ids.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError(f"empty table or ids: {tuple(table.shape)}, {tuple(ids.shape)}")
    if group_size <= 0 or group_mask.shape[0] < -(-V // group_size):
        raise ValueError(f"group_mask needs ceil(V / group_size) = {-(-V // group_size)} entries, "
                         f"has {group_mask.shape[0]}")
    for name, t in (("table", table), ("ids", ids), ("group_mask", group_mask)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tiered_gather(
    table: torch.Tensor,
    ids: torch.Tensor,
    group_mask: torch.Tensor,
    *,
    group_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather with residency check: ``tiered_gather_plain`` for CPU tensors,
    the CUDA kernel for CUDA tensors (``tiered_gather.launches`` counts
    launches)."""
    ids, group_mask = _as_int32(ids, group_mask)
    if table.device.type == "cpu":
        return tiered_gather_plain(table, ids, group_mask, group_size=group_size)
    if table.device.type != "cuda":
        raise ValueError(f"tiered_gather runs on cpu or cuda, not {table.device}")
    _check_cuda_inputs(table, ids, group_mask, group_size)
    refuse_grad("tiered_gather_plain", table)
    if table.element_size() not in (2, 4):
        raise TypeError(f"the CUDA kernel copies 2- or 4-byte elements, the table is {table.dtype}")
    N, (V, D) = ids.shape[0], table.shape
    out = torch.empty(N, D, dtype=table.dtype, device=table.device)
    miss = torch.empty(N, dtype=torch.int32, device=table.device)
    lib = _library()
    with torch.cuda.device(table.device):
        err = lib.tiered_gather(table.data_ptr(), ids.data_ptr(), group_mask.data_ptr(), out.data_ptr(),
                                miss.data_ptr(), N, V, D * table.element_size(), group_size,
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiered-gather kernel launch failed: cudaError {err}")
    tiered_gather.launches += 1
    return out, miss


tiered_gather.launches = 0


def tiered_gather_matmul(
    table: torch.Tensor,
    w: torch.Tensor,
    ids: torch.Tensor,
    group_mask: torch.Tensor,
    *,
    group_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused residency-masked gather → matmul: ``tiered_gather_matmul_plain``
    for CPU tensors, the CUDA kernel for CUDA tensors
    (``tiered_gather_matmul.launches`` counts launches)."""
    ids, group_mask = _as_int32(ids, group_mask)
    if table.device.type == "cpu":
        return tiered_gather_matmul_plain(table, w, ids, group_mask, group_size=group_size)
    if table.device.type != "cuda":
        raise ValueError(f"tiered_gather_matmul runs on cpu or cuda, not {table.device}")
    _check_cuda_inputs(table, ids, group_mask, group_size)
    refuse_grad("tiered_gather_matmul_plain", table, w)
    (V, D), N = table.shape, ids.shape[0]
    if w.dim() != 2 or w.shape[0] != D:
        raise ValueError(f"w must be (D, F) with D = {D}, got {tuple(w.shape)}")
    F = w.shape[1]
    for name, t in (("table", table), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16, {name} is {t.dtype}")
        if t.device != table.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {table.device}")
    if D % 8 or F % 8:
        raise ValueError(f"the CUDA kernel wants D and F multiples of 8, got D={D} F={F}")
    out = torch.empty(N, F, dtype=table.dtype, device=table.device)
    miss = torch.empty(N, dtype=torch.int32, device=table.device)
    work = torch.empty(2 * N + 1, dtype=torch.int32, device=table.device)  # row order, table rows, hit count
    lib = _library()
    with torch.cuda.device(table.device):
        err = lib.tiered_gather_matmul_bf16(table.data_ptr(), w.data_ptr(), ids.data_ptr(), group_mask.data_ptr(),
                                            out.data_ptr(), miss.data_ptr(), work.data_ptr(), N, V, D, F,
                                            group_size, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiered-gather-matmul kernel launch failed: cudaError {err}")
    tiered_gather_matmul.launches += 1
    return out, miss


tiered_gather_matmul.launches = 0
