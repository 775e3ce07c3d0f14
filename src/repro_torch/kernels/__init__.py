"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage per TPU
kernel of ``repro.kernels``. Each ships its plain PyTorch version in the same
module; the wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors, and refuses a CUDA launch whose inputs require grad
(``refuse_grad``)."""

import functools
from typing import Callable

import torch


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (the kernels'
    launch plans size their grids from it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def refuse_grad(plain: str, *tensors: torch.Tensor) -> None:
    """Raise before a CUDA launch whose output autograd would need to
    differentiate: no kernel has a backward, so running it would silently cut
    the graph. The caller that needs gradients calls ``plain`` (the
    kernel's plain version) itself; under ``torch.no_grad()`` or
    ``torch.inference_mode()`` every launch goes ahead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the CUDA kernel has no backward and an input requires grad: "
                           f"call {plain} where gradients are needed")


def kernel_wrappers() -> dict[str, Callable]:
    """Every kernel wrapper by name. Each counts the launches it makes in its
    ``launches`` attribute; a replayed CUDA graph adds the launches it
    recorded (``serving.cold_start.GraphEntry``)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.tiered_gather import ops as tg_ops

    return {"flash_attention": fa_ops.flash_attention, "rglru_scan": lru_ops.rglru_scan,
            "decode_attention": da_ops.decode_attention, "paged_decode_attention": da_ops.paged_decode_attention,
            "tiered_gather": tg_ops.tiered_gather, "tiered_gather_matmul": tg_ops.tiered_gather_matmul}
