"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec
transformer backbone; conv/mel frontend is a STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    head_dim=64,
    encdec=EncDecConfig(num_encoder_layers=6, frontend="stub"),
    tie_embeddings=True,
    source="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-base-reduced",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        encdec=EncDecConfig(num_encoder_layers=2, frontend="stub"),
    )
