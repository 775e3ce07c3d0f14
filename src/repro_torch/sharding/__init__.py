"""Logical-axis sharding over a ``DeviceMesh`` (``repro.sharding``
counterpart)."""

from repro_torch.sharding.rules import (
    ACT_RULES,
    PARAM_RULES,
    constrain,
    current_mesh,
    param_shardings,
    resolve_pspec,
    set_rules,
    spec_shard_divisor,
    use_mesh,
)

__all__ = [
    "ACT_RULES",
    "PARAM_RULES",
    "constrain",
    "current_mesh",
    "param_shardings",
    "resolve_pspec",
    "set_rules",
    "spec_shard_divisor",
    "use_mesh",
]
