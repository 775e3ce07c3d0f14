"""AdamW optimizer state (``repro.optim.adamw`` counterpart, state only).

The moments are the canonical FaaSLight "optional collection": 2× the
param bytes in fp32 that no serving entry can reach. The paper's *before*
bundle holds them (``core.analyzer.write_monolithic``) and file
elimination drops them from *after1*. The update rule is not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import flatten_with_paths, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # fp32 tree
    v: Any  # fp32 tree


def init_adamw(params: Any) -> AdamWState:
    """Zero moments in fp32 (distinct buffers), on each param's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = flatten_with_paths(params)[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))
