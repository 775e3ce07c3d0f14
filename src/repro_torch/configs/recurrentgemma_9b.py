"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]
"""

from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    recurrent=RecurrentConfig(pattern=("rec", "rec", "attn"), lru_width=4096, conv_width=4, window=2048),
    tie_embeddings=True,
    source="arXiv:2402.19427",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-9b-reduced",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        recurrent=RecurrentConfig(pattern=("rec", "rec", "attn"), lru_width=64, conv_width=4, window=32),
    )
