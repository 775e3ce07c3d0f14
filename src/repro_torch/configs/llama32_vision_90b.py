"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers every 5th layer; vision frontend is a
STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    vlm=VLMConfig(cross_attn_every=5, num_image_tokens=1601, vision_dim=7680),
    source="hf:meta-llama/Llama-3.2-11B-Vision (scaled per assignment)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama-3.2-vision-90b-reduced",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        vlm=VLMConfig(cross_attn_every=5, num_image_tokens=16, vision_dim=48),
    )
