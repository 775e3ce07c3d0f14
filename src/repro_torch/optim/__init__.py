"""Optimizer state (``repro.optim`` counterpart): only what serving's
monolithic baselines hold, the AdamW moments."""

from repro_torch.optim.adamw import AdamWState, init_adamw

__all__ = ["AdamWState", "init_adamw"]
