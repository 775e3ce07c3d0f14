"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (block-internal expansion, hence d_ff=0).
[arXiv:2405.04517; unverified]"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,  # blocks carry their own up/down projections
    vocab_size=50_304,
    head_dim=192,
    xlstm=XLSTMConfig(pattern=("m", "s"), proj_factor_m=2.0, proj_factor_s=1.333, chunk_size=128),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-125m-reduced",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        vocab_size=512,
        head_dim=32,
        xlstm=XLSTMConfig(pattern=("m", "s"), proj_factor_m=2.0, proj_factor_s=1.333, chunk_size=16),
    )
