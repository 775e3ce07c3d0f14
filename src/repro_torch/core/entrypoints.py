"""② Application Entry Recognition (``repro.core.entrypoints`` counterpart).

``DeploymentProfile`` is the deployment's declared entry set (the FaaSLight
configuration file: a server declares ``prefill`` / ``decode``, a trainer
``train``); ``recognize_entries`` filters the model's registered
entries by their ``kind`` tag and the profile's modalities, and
``extra_entries`` is the explicit escape hatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.models.zoo import EntryPoint, Model


@dataclass(frozen=True)
class DeploymentProfile:
    """What this deployment serves.

    kinds              — entry kinds the service exposes.
    modalities         — modal params outside this set become tier-1.
    hot_vocab_fraction — fraction of vocab row-groups resident at cold start.
    resident_experts   — experts resident per MoE layer at cold start
                         (-1 = all; 0 = none).
    """

    name: str = "serving"
    kinds: tuple = ("prefill", "decode")
    modalities: tuple = ("text",)
    hot_vocab_fraction: float = 0.25
    resident_experts: int = 0
    min_tier1_bytes: int = 1 << 20  # leaves smaller than this stay tier-0
    vocab_row_group: int = 2048  # rows per on-demand vocab unit

    @property
    def is_training(self) -> bool:
        return "train" in self.kinds


TRAINING_PROFILE = DeploymentProfile(
    name="training", kinds=("train",), modalities=("text", "image", "audio"),
    hot_vocab_fraction=1.0, resident_experts=-1,
)
SERVING_PROFILE = DeploymentProfile(name="serving")
SERVING_MULTIMODAL_PROFILE = DeploymentProfile(name="serving-multimodal", modalities=("text", "image", "audio"))


def recognize_entries(
    model: Model,
    profile: DeploymentProfile,
    *,
    B: int = 1,
    S: int = 128,
    extra_entries: Sequence[EntryPoint] = (),
) -> list[EntryPoint]:
    """The model's entries whose kind the profile serves, plus ``extra_entries``.
    A text-only profile (no image or audio modality) drops each modal entry
    that has a ``_text_only`` twin, so the modal weights stay unreachable (the
    Whisper-encoder and VLM-cross case); a multimodal profile keeps both."""
    multimodal = any(m in profile.modalities for m in ("image", "audio"))
    entries = model.entries(B=B, S=S)
    names = {ep.name for ep in entries}
    out = [ep for ep in entries if ep.kind in profile.kinds
           and (multimodal or ep.name.endswith("_text_only") or ep.name + "_text_only" not in names)]
    out.extend(extra_entries)
    if not out:
        raise ValueError(
            f"no entries recognized for profile {profile.name!r} "
            f"(kinds={profile.kinds}); pass extra_entries explicitly"
        )
    return out
