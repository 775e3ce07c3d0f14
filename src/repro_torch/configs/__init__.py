"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The ten assigned architectures (see DESIGN.md §5) plus the paper-benchmark
reduced variants used by smoke tests and the cold-start benchmarks.
"""

from __future__ import annotations

from repro_torch.configs.base import (
    SHAPES,
    EncDecConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RecurrentConfig,
    ShapeSpec,
    VLMConfig,
    XLSTMConfig,
    shape_applicable,
)

from repro_torch.configs import (  # noqa: E402
    deepseek_v2_lite_16b,
    gemma3_27b,
    llama32_vision_90b,
    mistral_large_123b,
    mixtral_8x22b,
    phi3_medium_14b,
    recurrentgemma_9b,
    whisper_base,
    xlstm_125m,
    yi_34b,
)

_MODULES = {
    "recurrentgemma-9b": recurrentgemma_9b,
    "mistral-large-123b": mistral_large_123b,
    "gemma3-27b": gemma3_27b,
    "phi3-medium-14b": phi3_medium_14b,
    "yi-34b": yi_34b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "whisper-base": whisper_base,
    "xlstm-125m": xlstm_125m,
    "llama-3.2-vision-90b": llama32_vision_90b,
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    cfg = _MODULES[arch_id].CONFIG
    cfg.validate()
    return cfg


def get_reduced(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    cfg = _MODULES[arch_id].reduced()
    cfg.validate()
    return cfg


def grid_cells() -> list[tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells (40 assigned minus the
    long_500k exclusions, which are *noted*, not silently dropped)."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = shape_applicable(cfg, shape)
            if ok:
                cells.append((arch, shape.name))
    return cells


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "RecurrentConfig",
    "XLSTMConfig",
    "EncDecConfig",
    "VLMConfig",
    "ShapeSpec",
    "get_config",
    "get_reduced",
    "grid_cells",
    "shape_applicable",
]
