"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage per TPU
kernel of ``repro.kernels``. Each ships its plain PyTorch version in the same
module; the wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors."""
