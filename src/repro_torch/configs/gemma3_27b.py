"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262_144,
    head_dim=128,
    rope_theta=1_000_000.0,
    sliding_window=1024,  # applies to the "local" layers
    local_global_pattern=(5, 1),
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (scaled per assignment)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-27b-reduced",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        sliding_window=16,
    )
