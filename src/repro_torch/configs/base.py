"""Architecture + shape configuration system.

Every assigned architecture is a ``ModelConfig`` (exact numbers from the
assignment) selectable via ``--arch <id>``; each also provides ``reduced()``
— a tiny same-family variant for CPU smoke tests. Input shapes are
``ShapeSpec``s; the (arch × shape) grid drives the multi-pod dry-run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# family sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int  # routed experts
    top_k: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0  # per-expert intermediate size
    first_dense_layers: int = 0  # leading layers that use a dense MLP
    dense_d_ff: int = 0  # intermediate size of those dense layers
    capacity_factor: float = 1.25  # einsum-dispatch capacity (train path)
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RecurrentConfig:
    """Griffin/RecurrentGemma: RG-LRU residual blocks mixed with local attn.

    ``pattern`` is the repeating block pattern; e.g. ("rec", "rec", "attn")
    is the paper's 2:1 recurrent:attention mix.
    """

    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: int = 0  # 0 = d_model
    conv_width: int = 4
    window: int = 2048  # local attention window


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: alternating mLSTM (matrix memory) and sLSTM blocks."""

    pattern: Tuple[str, ...] = ("m", "s")
    proj_factor_m: float = 2.0  # mLSTM up-projection
    proj_factor_s: float = 1.333  # sLSTM ffn factor (×2 gates)
    conv_width: int = 4
    chunk_size: int = 128  # chunkwise-parallel mLSTM scan


@dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 6
    # The conv/mel frontend is a STUB per assignment: input_specs() provides
    # precomputed frame embeddings of shape (B, frames, d_model).
    frontend: str = "stub"


@dataclass(frozen=True)
class VLMConfig:
    """Llama-3.2-Vision-style: text decoder with periodic cross-attn layers
    attending to precomputed image patch embeddings (frontend = stub)."""

    cross_attn_every: int = 5  # every 5th layer is cross-attn
    num_image_tokens: int = 1601
    vision_dim: int = 7680


# ---------------------------------------------------------------------------
# the model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 = d_model // num_heads
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA for *all* attn layers
    local_global_pattern: Optional[Tuple[int, int]] = None  # (n_local, n_global)
    attn_logit_softcap: Optional[float] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # engineering knobs (hillclimbable)
    scan_layers: bool = True
    layers_per_unit: int = 1  # uniform stacks: layers per scanned group
    remat: str = "full"  # none | full | dots_saveable
    use_pallas: bool = False  # kept for config parity; the port picks kernel vs plain by device
    collect_moe_usage: bool = False  # serving: emit per-layer expert-usage masks
    fsdp: bool = True  # shard params over the data axis too
    logits_chunk: int = 0  # 0 = whole-sequence logits; else chunked loss
    source: str = ""  # provenance note

    # -- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_subquadratic(self) -> bool:
        """True iff *no* layer does unbounded full attention — the gate for
        the long_500k shape (see DESIGN.md §Arch-applicability)."""
        if self.family == "ssm":
            return True
        if self.recurrent is not None:
            return True  # RG-LRU + windowed local attention only
        if self.local_global_pattern is not None:
            return False  # periodic *global* layers are full attention
        if self.encdec is not None or self.vlm is not None:
            return False
        if self.mla is not None:
            return False  # MLA is full attention over the latent cache
        return self.sliding_window is not None

    @property
    def attn_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention/mixer kinds, expanded over the full depth."""
        n = self.num_layers
        if self.recurrent is not None:
            pat = self.recurrent.pattern
            return tuple(pat[i % len(pat)] for i in range(n))
        if self.xlstm is not None:
            pat = self.xlstm.pattern
            return tuple(pat[i % len(pat)] for i in range(n))
        if self.local_global_pattern is not None:
            nl, ng = self.local_global_pattern
            pat = ("local",) * nl + ("global",) * ng
            return tuple(pat[i % len(pat)] for i in range(n))
        if self.vlm is not None:
            k = self.vlm.cross_attn_every
            return tuple("cross" if (i + 1) % k == 0 else "self" for i in range(n))
        return ("self",) * n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.d_model > 0 and self.num_layers > 0
        assert self.num_heads % max(self.num_kv_heads, 1) == 0 or self.mla or self.xlstm
        if self.moe:
            assert self.moe.top_k <= self.moe.num_experts


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        # tokens *processed per step*: decode steps process one new token
        # per sequence against a seq_len-deep cache.
        if self.kind == "decode":
            return self.global_batch
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(applicable, reason). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, (
            f"{cfg.name} has unbounded full-attention layers; a 512k dense KV "
            "decode is excluded by assignment rule (see DESIGN.md)"
        )
    return True, ""
