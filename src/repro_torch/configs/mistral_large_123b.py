"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mistral-large-123b-reduced",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=8,
    )
