"""The collectives of a sharded forward run, behind one small interface.

A sharded step (``models.transformer.prefill_sharded`` /
``decode_step_sharded``) computes on its rank's local blocks and meets the
other ranks only through a ``Comm``: ``all_gather``, ``all_reduce`` (sum or
max) over one mesh dim, read by name. Two implementations:

  * ``DistComm`` — over a ``DeviceMesh``, with ``torch.distributed``'s
    functional collectives on each mesh dim's process group (gloo on the
    CPU, NCCL on the card, the ``"fake"`` backend in the dry run, where
    ``utils.hlocost`` counts them);
  * ``ThreadComm`` — every rank of a mesh in this one process, one thread a
    rank (``run_ranks``): the ranks run one at a time, each until its next
    collective, and a collective reduces the deposited operands by hand in
    rank order. It needs no process group, so one card can run the 16
    ``model`` ranks of the production mesh one after another.

Every rank calls the same collectives in the same order (the step is SPMD).
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

MESH_DIMS = ("data", "model")  # the mesh dims a sharded step reads


class Comm:
    """A rank's place on a mesh: ``sizes`` (mesh dim -> size, in mesh
    order) and ``coord`` (mesh dim -> this rank's index). A dim the mesh
    lacks has size 1."""

    sizes: dict
    coord: dict
    moved_bytes: int = 0  # result bytes of this rank's collectives so far (``utils.hlocost``'s measure)

    def size(self, dim: str) -> int:
        return self.sizes.get(dim, 1)

    def index(self, dim: str) -> int:
        return self.coord.get(dim, 0)

    def all_gather(self, x: torch.Tensor, dim: str, axis: int) -> torch.Tensor:
        """The blocks of every rank along mesh dim ``dim``, concatenated on
        tensor axis ``axis`` in that dim's rank order."""
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor, dim: str, op: str = "sum") -> torch.Tensor:
        """Elementwise ``op`` ("sum" or "max") of every rank's ``x`` along
        mesh dim ``dim``."""
        raise NotImplementedError


class DistComm(Comm):
    """``Comm`` over a ``DeviceMesh`` this process is a rank of."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(names, (int(s) for s in mesh.shape)))
        self.coord = dict(zip(names, mesh.get_coordinate()))

    def all_gather(self, x, dim, axis):
        import torch.distributed._functional_collectives as fc

        if self.size(dim) == 1:
            return x
        gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
        out = fc.wait_tensor(gather(x.contiguous(), axis, self.mesh.get_group(dim)))
        self.moved_bytes += out.numel() * out.element_size()
        return out

    def all_reduce(self, x, dim, op="sum"):
        import torch.distributed._functional_collectives as fc

        if self.size(dim) == 1:
            return x
        out = fc.wait_tensor(fc.all_reduce(x.contiguous(), op, self.mesh.get_group(dim)))
        self.moved_bytes += out.numel() * out.element_size()
        return out


class _Board:
    """What the threads of one ``run_ranks`` share: the baton (only its
    holder computes), the barrier of each collective, and two buffers of
    deposited operands (a rank writes collective g + 1's while a slower one
    may still read g's)."""

    def __init__(self, n: int):
        self.baton = threading.Lock()
        self.barrier = threading.Barrier(n)
        self.slots = [[None] * n, [None] * n]


class ThreadComm(Comm):
    """Rank ``rank`` (row-major over ``sizes``) of an in-process mesh."""

    def __init__(self, board: _Board, sizes: dict, rank: int):
        self.board, self.sizes, self.rank = board, dict(sizes), rank
        self.coord, rest = {}, rank
        for name in reversed(list(sizes)):
            self.coord[name], rest = rest % sizes[name], rest // sizes[name]
        self.coord = {name: self.coord[name] for name in sizes}
        self._gen = 0

    def _group(self, dim: str) -> list:
        """The ranks that share every coordinate but ``dim``'s, in its order."""
        names = list(self.sizes)
        out = []
        for i in range(self.sizes[dim]):
            coord = dict(self.coord, **{dim: i})
            r = 0
            for name in names:
                r = r * self.sizes[name] + coord[name]
            out.append(r)
        return out

    def _exchange(self, x: torch.Tensor) -> list:
        b, g = self.board, self._gen % 2
        self._gen += 1
        b.slots[g][self.rank] = x
        b.baton.release()  # the next rank runs up to this collective
        try:
            b.barrier.wait()
        finally:
            b.baton.acquire()
        return b.slots[g]

    def all_gather(self, x, dim, axis):
        if self.size(dim) == 1:
            return x
        got = self._exchange(x)
        out = torch.cat([got[r] for r in self._group(dim)], dim=axis)
        self.moved_bytes += out.numel() * out.element_size()
        return out

    def all_reduce(self, x, dim, op="sum"):
        if self.size(dim) == 1:
            return x
        got = self._exchange(x)
        parts = [got[r] for r in self._group(dim)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        self.moved_bytes += out.numel() * out.element_size()
        return out


def run_ranks(sizes: dict, fn: Callable[[Comm], object]) -> list:
    """``fn(comm)`` for every rank of a mesh of ``sizes`` in this process,
    one thread a rank holding the baton in turn; returns the ranks' results
    in rank order. A rank that raises breaks the barrier for the others,
    and its error is raised here."""
    n = 1
    for s in sizes.values():
        n *= s
    board = _Board(n)
    results: list = [None] * n
    errors: list = []

    def one(rank: int) -> None:
        with board.baton:
            try:
                results[rank] = fn(ThreadComm(board, sizes, rank))
            except threading.BrokenBarrierError:
                pass  # another rank failed first
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                board.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,), name=f"rank-{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def mesh_dims_supported(names: Sequence[str]) -> bool:
    """True when a mesh has no dim but ``data`` and ``model``: the sharded
    step splits the batch over ``data`` alone (a ``pod`` dim keeps the
    gather-at-use path)."""
    return set(names) <= set(MESH_DIMS)
