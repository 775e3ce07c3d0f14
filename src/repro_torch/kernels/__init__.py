"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage per TPU
kernel of ``repro.kernels``. Each ships its plain PyTorch version in the same
module; the wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors."""

import functools
from typing import Callable

import torch


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (the kernels'
    launch plans size their grids from it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
