"""Optimizer (``repro.optim`` counterpart): AdamW with global-norm clipping
and the warmup-cosine schedule, and int8 error-feedback compression."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    abstract_adamw,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    global_norm,
    init_adamw,
    warmup_cosine,
)
from repro_torch.optim.compression import (
    EFState,
    abstract_error_feedback,
    compressed_psum,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "abstract_adamw",
    "adamw_update",
    "adamw_update_",
    "clip_by_global_norm",
    "global_norm",
    "init_adamw",
    "warmup_cosine",
    "EFState",
    "abstract_error_feedback",
    "compressed_psum",
    "dequantize_int8",
    "init_error_feedback",
    "quantize_int8",
]
