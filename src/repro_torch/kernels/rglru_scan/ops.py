"""RG-LRU linear-recurrence scan: the hand-written CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

``rglru_scan(a, b)`` computes ``s_t = a_t ⊙ s_{t-1} + b_t`` with
``s_{-1} = 0`` over (B, S, W) fp32 inputs — the contract of
``repro.kernels.rglru_scan.ops.rglru_scan``, where the gate math stays
outside and the kernel owns only the serial dependency. For a CPU tensor it
runs ``rglru_scan_plain``; for a CUDA tensor it launches the kernel in
``csrc/rglru_scan.cu`` (fp32, contiguous) or raises. There is no fallback
between the two.

The kernel is compiled with ``nvcc`` at first use into
``<repo>/build/rglru_scan/`` and loaded with ``ctypes`` (``kernels.nvcc``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc, refuse_grad, sm_count

_SRC = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_PRODUCER_THREADS = 32  # each block has one producer warp beside its consumer warps
_lib: Optional[ctypes.CDLL] = None


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The recurrence step by step in fp32 (``rglru_scan_ref``'s semantics).
    The output is stacked rather than written in place, so a traced graph of
    it holds no mutation (the analyzer treats a mutated input as live). The
    inputs are unbound into their steps once, so under autograd (the
    training loss) the steps' gradients are stacked once, where indexing a
    step at a time would add S whole-size gradients."""
    s = torch.zeros_like(a[:, 0], dtype=torch.float32)
    steps = []
    for a_t, b_t in zip(a.to(torch.float32).unbind(1), b.to(torch.float32).unbind(1)):
        s = a_t * s + b_t
        steps.append(s)
    return torch.stack(steps, dim=1)


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source version) and return the shared
    library's path and the compiler's register report."""
    return nvcc.build("rglru_scan", _SRC)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = nvcc.load("rglru_scan", _SRC)
        fn = lib.rglru_scan_fwd_f32
        # a, b, s | B, S, W, lanes | stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def lane_plan(B: int, W: int, n_sms: int) -> tuple[int, int, int]:
    """(lanes, blocks, threads_per_block): the kernel gives each block 64
    lanes of one batch row when that still makes a block for every SM of a
    card of ``n_sms``, else 32, so that few lanes still cover the card."""
    lanes = 64 if B * -(-W // 64) >= n_sms else 32
    return lanes, B * -(-W // lanes), lanes + _PRODUCER_THREADS


def _check_cuda_inputs(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan wants a, b of one (B, S, W) shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.numel() == 0 or a.shape[0] > 65535:  # the batch is the grid's y extent
        raise ValueError(f"bad sizes for the kernel: {tuple(a.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``rglru_scan_plain`` for CPU tensors, the CUDA kernel for CUDA tensors
    (``rglru_scan.launches`` counts launches)."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    _check_cuda_inputs(a, b)
    refuse_grad("rglru_scan_plain", a, b)
    B, S, W = a.shape
    lanes = lane_plan(B, W, sm_count(a.device))[0]
    s = torch.empty_like(a)
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_fwd_f32(a.data_ptr(), b.data_ptr(), s.data_ptr(), B, S, W, lanes,
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru-scan kernel launch failed: cudaError {err}")
    rglru_scan.launches += 1
    return s


rglru_scan.launches = 0
