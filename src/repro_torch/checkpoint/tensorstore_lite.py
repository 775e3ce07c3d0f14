"""Raw-binary tensor bundle: dtype-faithful (bf16-safe), partially readable.

Same on-disk format as ``repro.checkpoint.tensorstore_lite``: one bundle is
``<prefix>.bin`` (concatenated raw buffers, 64-byte aligned) plus
``<prefix>.index.json`` ({path: {offset, nbytes, shape, dtype}}), so a
bundle written by either package opens in the other. bfloat16 travels as
its raw ``uint16`` bit pattern and is viewed back as ``torch.bfloat16`` —
numpy has no bf16, and the port does without ``ml_dtypes``.

Writes are atomic: ``.partial`` + rename, index last.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

_ALIGN = 64


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style dtype name the reference writes ("bfloat16", "float32")."""
    return str(dtype).removeprefix("torch.")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host bytes of a tensor as a numpy array (bf16 → its uint16 bits)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """Host tensor over raw little-endian bytes of the named dtype. Shares a
    writable buffer (``bytearray``, numpy array); copies a read-only one."""
    np_dt = np.uint16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = np.frombuffer(buf, np_dt).reshape(shape)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def write_bundle(prefix: str, arrays: Mapping[str, torch.Tensor]) -> dict:
    """Write all tensors; returns the index. Atomic (bin first, index last)."""
    bin_tmp = prefix + ".bin.partial"
    index: dict[str, dict] = {}
    offset = 0
    with open(bin_tmp, "wb") as f:
        for key, t in arrays.items():
            # as the reference's np.ascontiguousarray: a 0-d leaf (a step
            # counter) is stored with shape [1]
            arr = np.ascontiguousarray(to_numpy(t))
            pad = (-offset) % _ALIGN
            if pad:
                f.write(b"\0" * pad)
                offset += pad
            buf = arr.tobytes()
            f.write(buf)
            index[key] = {
                "offset": offset,
                "nbytes": len(buf),
                "shape": list(arr.shape),
                "dtype": dtype_name(t.dtype),
            }
            offset += len(buf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(bin_tmp, prefix + ".bin")
    idx_tmp = prefix + ".index.json.partial"
    with open(idx_tmp, "w") as f:
        json.dump(index, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(idx_tmp, prefix + ".index.json")
    return index


def read_index(prefix: str) -> dict:
    with open(prefix + ".index.json") as f:
        return json.load(f)


def read_bundle(prefix: str, keys: Optional[Iterable[str]] = None, *,
                mmap: bool = False) -> dict[str, torch.Tensor]:
    """Read (a subset of) a bundle into host tensors. By default each tensor
    is read into memory of its own, in file-offset order. With ``mmap`` each
    is a view of a copy-on-write map of the ``.bin`` file: no byte moves
    until it is touched, so streaming a whole bundle through (as
    ``core.retier.retier_artifact`` copies tier-0) holds one tensor's pages
    at a time, not the bundle."""
    index = read_index(prefix)
    sel = list(index) if keys is None else list(keys)
    out: dict[str, torch.Tensor] = {}
    if mmap:
        if os.path.getsize(prefix + ".bin") == 0:  # np.memmap cannot map an empty file
            return {k: from_bytes(bytearray(), index[k]["dtype"], index[k]["shape"]) for k in sel}
        raw = np.memmap(prefix + ".bin", dtype=np.uint8, mode="c")
        for k in sel:
            e = index[k]
            if e["offset"] + e["nbytes"] > raw.size:
                raise OSError(f"bundle {prefix}.bin is truncated at {k!r}")
            out[k] = from_bytes(raw[e["offset"]:e["offset"] + e["nbytes"]], e["dtype"], e["shape"])
        return out
    with open(prefix + ".bin", "rb") as f:
        for k in sorted(sel, key=lambda k: index[k]["offset"]):
            e = index[k]
            f.seek(e["offset"])
            buf = bytearray(e["nbytes"])
            if f.readinto(buf) != e["nbytes"]:
                raise OSError(f"bundle {prefix}.bin is truncated at {k!r}")
            out[k] = from_bytes(buf, e["dtype"], e["shape"])
    return {k: out[k] for k in sel}
