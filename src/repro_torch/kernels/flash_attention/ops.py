"""Prefill flash attention: the hand-written CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

``flash_attention`` has the contract of ``repro.kernels.flash_attention.ops.
flash_attention`` (q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd), GQA by
``kv_head = head // (H // Hkv)``, causal, sliding ``window``, tanh
``softcap``, ``q_offset``). For a CPU tensor it runs
``flash_attention_plain``; for a CUDA tensor it launches the kernel in
``csrc/flash_attention.cu`` (bf16, hd 64, 128 or 256) or raises. There is no
fallback between the two. The reduced configs' head_dim 8, 16 (and 32) go
through the hd-64 kernel: q, k and v are zero-padded to 64 columns, the
kernel is given the true head_dim's scale, and O's first hd columns are kept.
Zero columns add exact zeros to every q·k and give zero output columns, so
this is the same attention, at the hd-64 kernel's cost.

The kernel is compiled with ``nvcc`` at first use, from the source in this
package, into ``<repo>/build/flash_attention/`` and loaded with ``ctypes``
(``kernels.nvcc``). It loads through TMA, so its C entry builds tensor maps
with the CUDA driver's ``cuTensorMapEncodeTiled``, reached through the
runtime's driver entry point (no link against libcuda).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc, refuse_grad

NEG_INF = -1.0e30

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_HEAD_DIMS = (64, 128, 256)
# head dims the wrapper zero-pads to PADDED_HD for the kernel
_PADDED_HEAD_DIMS = (8, 16, 32)
PADDED_HD = 64
_lib: Optional[ctypes.CDLL] = None
# q rows per masked softmax in the plain version
PLAIN_CHUNK_Q = 512


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, hd), roped
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's semantics, in fp32.

    Each q chunk takes a masked softmax over the key span that the causal and
    window bounds admit (never the whole (Sq, Sk) matrix). Masked lanes
    contribute exactly 0 and a row with no admitted key outputs 0, as in
    ``repro.models.attention.flash_attention_jnp``."""
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    scale = hd**-0.5
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, G, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    chunks = []
    for qs in range(0, Sq, PLAIN_CHUNK_Q):
        qe = min(qs + PLAIN_CHUNK_Q, Sq)
        lo = max(0, qs + q_offset - window + 1) if window is not None else 0
        hi = min(Sk, qe + q_offset) if causal else Sk
        if hi <= lo:
            chunks.append(torch.zeros(B, qe - qs, Hkv, G, hd, dtype=torch.float32, device=q.device))
            continue
        s = torch.einsum("bqkgd,bskd->bqkgs", qf[:, qs:qe], kf[:, lo:hi]) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = torch.arange(qs, qe, device=q.device) + q_offset
        k_pos = torch.arange(lo, hi, device=q.device)
        mask = torch.ones(qe - qs, hi - lo, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        maskb = mask[None, :, None, None, :]
        s = torch.where(maskb, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * maskb
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bqkgs,bskd->bqkgd", p, vf[:, lo:hi]) / l.clamp_min(1e-30)
        chunks.append(o)
    o = torch.cat(chunks, dim=1).reshape(B, Sq, H, hd)
    return o.to(q.dtype)


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, heads, hd) with zero columns appended up to PADDED_HD."""
    return torch.nn.functional.pad(t, (0, PADDED_HD - t.shape[3])).contiguous()


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source version) and return the shared
    library's path and the compiler's register/shared-memory report."""
    return nvcc.build("flash_attention", _SRC)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = nvcc.load("flash_attention", _SRC)
        fn = lib.flash_attention_fwd_bf16
        # q, k, v, o | B, Sq, Sk, H, Hkv, hd, causal, window | softcap, q_offset, scale, stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda_inputs(q, k, v, window, softcap, q_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd)")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Sq == 0 or k.shape[1] == 0 or Hkv == 0 or H % Hkv:
        raise ValueError(f"bad sizes: Sq={Sq} Sk={k.shape[1]} H={H} Hkv={Hkv}")
    if hd not in _HEAD_DIMS + _PADDED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel supports head_dim {_HEAD_DIMS} (and {_PADDED_HEAD_DIMS} "
                         f"zero-padded to {PADDED_HD}), got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16 (fp32 attention runs on the CPU only), "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Prefill attention: ``flash_attention_plain`` for CPU tensors, the CUDA
    kernel for CUDA tensors (``flash_attention.launches`` counts launches);
    head_dim 8, 16 and 32 through the hd-64 kernel on zero-padded inputs."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v, window, softcap, q_offset)
    refuse_grad("flash_attention_plain", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = hd**-0.5
    if hd in _PADDED_HEAD_DIMS:
        q, k, v = (pad_head_dim(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, Sk, H, Hkv, q.shape[3], int(causal), window or 0, float(softcap or 0.0),
            q_offset, scale, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o[..., :hd].contiguous() if o.shape[3] != hd else o


flash_attention.launches = 0
