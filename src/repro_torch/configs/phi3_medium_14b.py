"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
    head_dim=128,
    source="arXiv:2404.14219",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="phi3-medium-14b-reduced",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
    )
