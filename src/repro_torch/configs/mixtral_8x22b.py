"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    sliding_window=4096,  # SWA per assignment -> long_500k applicable
    moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=0, expert_d_ff=16384),
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mixtral-8x22b-reduced",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        sliding_window=32,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0, expert_d_ff=128),
    )
