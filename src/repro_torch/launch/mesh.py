"""Mesh construction over ``torch.distributed`` (``repro.launch.mesh``
counterpart).

Functions, never module-level meshes: importing this module starts no
process group. Geometries, as in the reference:

  single-pod : (16, 16)      dims ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16)   dims ("pod", "data", "model")   = 512 ranks

A mesh needs one process per rank: ``torchrun --nproc-per-node N`` starts
them (each reads ``RANK`` / ``WORLD_SIZE`` and the rendezvous address from
its environment). A 1×1 mesh needs no launcher: without a process group,
``make_debug_mesh(1, 1)`` starts a world of one on an in-memory store
(``nccl`` on ``cuda``, ``gloo`` on ``cpu``), which opens no socket.
``production_mesh_shape`` gives the production geometries without any rank,
for rule resolution (``repro_torch.sharding.resolve_pspec``).
"""

from __future__ import annotations

import math
import os

from repro_torch.sharding.rules import MeshShape, mesh_sizes

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def world_size(device: str, need: int) -> int:
    """The ranks of this process's world, starting the process group if none
    exists: from torchrun's environment when it set one, else a world of one
    on an in-memory store when ``need`` is 1. Returns 1, with nothing
    started, when neither holds."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        # NCCL binds its communicator to this process's card
        kw = {"device_id": torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))} if device == "cuda" else {}
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(device), **kw)  # env:// from torchrun
        elif need == 1:
            dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1, **kw)
        else:
            return 1
    return dist.get_world_size()


def _device_mesh(device: str, shape: tuple, names: tuple):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return init_device_mesh(device, shape, mesh_dim_names=names)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    shape, names = PRODUCTION[multi_pod]
    return MeshShape(names, shape)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production geometry as a ``DeviceMesh``; the world must hold
    exactly its 256 or 512 ranks."""
    shape, names = PRODUCTION[multi_pod]
    need = math.prod(shape)
    have = world_size(device, need)
    if have != need:
        raise ValueError(f"production mesh {'x'.join(map(str, shape))} needs {need} ranks but the world holds "
                         f"{have}; launch {need} processes (torchrun --nproc-per-node ... --nnodes ...)")
    return _device_mesh(device, shape, names)


def make_debug_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A small ("data", "model") mesh over this process's world. Fails with
    an actionable message when the world does not hold ``data * model``
    ranks: launch that many processes with ``torchrun --nproc-per-node N``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    need = data * model
    have = world_size(device, need)
    if have != need:
        raise ValueError(f"debug mesh ({data}x{model}) needs {need} ranks but "
                         + (f"only {have} exist" if have < need else f"the world holds {have}")
                         + f"; launch one process per rank: torchrun --nproc-per-node {need} ...")
    return _device_mesh(device, (data, model), ("data", "model"))


def mesh_label(mesh) -> str:
    return "x".join(str(s) for s in mesh_sizes(mesh).values())
