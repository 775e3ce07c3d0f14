"""Weight carry-over from the JAX reference.

``params_from_numpy`` maps the reference's flat parameter dict (dotted path →
numpy array, as ``repro.utils.tree.flatten_with_paths`` yields it) to the
port's nested dict of tensors. Paths, shapes and layouts are identical in the
two packages (every weight is a (d_in, d_out) matrix, stacked groups lead),
so the mapping is a dtype-faithful copy; bf16 arrays (``ml_dtypes``) travel
as their ``uint16`` bit pattern, so this module needs no ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.utils.tree import tree_from_flat


def tensor_from_numpy(arr: np.ndarray, device="cuda") -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(flat: Mapping[str, np.ndarray], device="cuda") -> dict:
    """Reference flat params (path → array) → the port's nested param tree."""
    return tree_from_flat({p: tensor_from_numpy(a, device) for p, a in flat.items()})
