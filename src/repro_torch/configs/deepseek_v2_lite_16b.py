"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (per-expert)
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed experts top-6, first
layer dense. [arXiv:2405.04434; hf]

Assignment note: the assignment line reads "MoE 64e top-6 ... 2 shared+160
routed top-6"; 64 routed experts matches both the primary spec ("64e") and
the HF config of DeepSeek-V2-Lite, so we use 64 routed + 2 shared, top-6.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: all heads share the latent cache
    d_ff=1408,  # per-expert intermediate
    vocab_size=102_400,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        expert_d_ff=1408,
        first_dense_layers=1,
        dense_d_ff=10944,
    ),
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-lite-16b-reduced",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=32,
        vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(
            num_experts=8, top_k=2, num_shared_experts=1, expert_d_ff=32, first_dense_layers=1, dense_d_ff=128
        ),
    )
