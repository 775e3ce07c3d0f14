"""The hand-written CUDA kernels (flash attention, RG-LRU scan) against their
plain PyTorch versions, on the card. Needs an NVIDIA GPU and nvcc (the kernel has no CPU
mode); skips elsewhere. Imports no JAX (and ``--noconftest`` skips the
JAX fixtures of tests/conftest.py), so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops

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
def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 4, 128, device=card, dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa_ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros(1, 8, 4, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 37, 200), (1, 1000, 4096), (3, 5, 1)], ids=str)
def test_rglru_kernel_matches_plain_on_card(card, shape):
    rs = np.random.default_rng(1)
    a = torch.from_numpy(rs.uniform(0.5, 0.999, shape).astype(np.float32)).to(card)
    b = torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(card)
    before = lru_ops.rglru_scan.launches
    out = lru_ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert lru_ops.rglru_scan.launches == before + 1
    ref = lru_ops.rglru_scan_plain(a, b)
    # fp32 both: 1e-5 per unit of max(1, |s|)
    assert ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-5


@pytest.mark.gpu
def test_rglru_kernel_rejects_what_it_does_not_take(card):
    a = torch.zeros(1, 8, 16, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        lru_ops.rglru_scan(a, a)
    a = torch.zeros(1, 16, 8, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lru_ops.rglru_scan(a, a)
