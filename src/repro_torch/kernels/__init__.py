"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage per TPU
kernel of ``repro.kernels``. Each ships its plain PyTorch version in the same
module; the wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors."""

import functools

import torch


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (the kernels'
    launch plans size their grids from it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
