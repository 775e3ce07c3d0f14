"""The collectives of a sharded step, behind one small interface.

A sharded step (``models.transformer.prefill_sharded`` /
``decode_step_sharded`` / ``loss_fn_sharded``) computes on its rank's local
blocks and meets the other ranks only through a ``Comm``: ``all_gather``,
``all_reduce`` (sum or max), ``reduce_scatter`` and ``enter`` over one mesh
dim, read by name. Two implementations:

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

Under autograd (the training loss, ``loss_fn_sharded``) the collectives are
differentiable, with the tensor-parallel conventions: a tensor that is the
same on every ``model`` rank (replicated) carries its whole gradient on each
of them, and the loss is the same on every ``model`` rank.

  * ``all_reduce`` (sum) of partial sums: the backward passes the gradient
    through (each rank's partial sum has the whole sum's gradient);
  * ``enter``: identity forward, all-reduce backward. A replicated tensor
    that each rank uses with its own block of a weight (a column-parallel
    input, the tokens a rank's experts take) gets only that rank's share of
    its gradient; ``enter`` sums the shares;
  * ``all_gather``: the backward is a reduce-scatter, for a gathered tensor
    that each rank uses in its own way (its rows, its heads), so each rank
    holds a partial gradient of the whole;
  * ``reduce_scatter``: the backward is an all-gather;
  * ``all_reduce(op="max")`` has no gradient (the softmax's max is a shift).

``ThreadComm`` runs a backward only on the CPU: PyTorch's autograd engine
runs every CUDA backward node of every thread on one device thread, so a
rank blocked in a backward collective would block the ranks it waits for.
A CUDA backward through ``ThreadComm`` raises instead of hanging.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

MESH_DIMS = ("data", "model")  # the mesh dims a sharded step reads


def _records(x: torch.Tensor) -> bool:
    """True when autograd records an op on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


class Comm:
    """A rank's place on a mesh: ``sizes`` (mesh dim -> size, in mesh
    order) and ``coord`` (mesh dim -> this rank's index). A dim the mesh
    lacks has size 1. Subclasses implement the raw collectives
    (``_all_gather``, ``_all_reduce``, ``_reduce_scatter``); the public ones
    add their backward (module docstring)."""

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
        if self.size(dim) == 1:
            return x
        return _AllGather.apply(x, self, dim, axis) if _records(x) else self._all_gather(x, dim, axis)

    def all_reduce(self, x: torch.Tensor, dim: str, op: str = "sum") -> torch.Tensor:
        """Elementwise ``op`` ("sum" or "max") of every rank's ``x`` along
        mesh dim ``dim``."""
        if self.size(dim) == 1:
            return x
        if op == "sum" and _records(x):
            return _AllReduce.apply(x, self, dim)
        return self._all_reduce(x.detach() if op == "max" else x, dim, op)

    def reduce_scatter(self, x: torch.Tensor, dim: str, axis: int) -> torch.Tensor:
        """This rank's block, along tensor ``axis``, of the sum of every
        rank's ``x`` along mesh dim ``dim`` (the blocks in that dim's rank
        order)."""
        if self.size(dim) == 1:
            return x
        return _ReduceScatter.apply(x, self, dim, axis) if _records(x) else self._reduce_scatter(x, dim, axis)

    def enter(self, x: torch.Tensor, dim: str = "model") -> torch.Tensor:
        """``x`` itself; its gradient is all-reduced over ``dim`` (the
        replicated input of work split over ``dim``)."""
        if self.size(dim) == 1 or not _records(x):
            return x
        return _Enter.apply(x, self, dim)

    def block(self, x: torch.Tensor, dim: str, axis: int) -> torch.Tensor:
        """This rank's block of ``x`` along tensor ``axis``, split over mesh
        dim ``dim`` (no collective)."""
        n = x.shape[axis] // self.size(dim)
        return x.narrow(axis, self.index(dim) * n, n)

    def backward_guard(self, grad: torch.Tensor) -> None:
        """Called by every collective's backward before it communicates."""

    def _all_gather(self, x: torch.Tensor, dim: str, axis: int) -> torch.Tensor:
        raise NotImplementedError

    def _all_reduce(self, x: torch.Tensor, dim: str, op: str = "sum") -> torch.Tensor:
        raise NotImplementedError

    def _reduce_scatter(self, x: torch.Tensor, dim: str, axis: int) -> torch.Tensor:
        raise NotImplementedError


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axis):
        ctx.comm, ctx.dim, ctx.axis = comm, dim, axis
        return comm._all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        ctx.comm.backward_guard(grad)
        return ctx.comm._reduce_scatter(grad, ctx.dim, ctx.axis), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axis):
        ctx.comm, ctx.dim, ctx.axis = comm, dim, axis
        return comm._reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        ctx.comm.backward_guard(grad)
        return ctx.comm._all_gather(grad, ctx.dim, ctx.axis), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        return comm._all_reduce(x, dim, "sum")

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.comm.backward_guard(grad)
        return ctx.comm._all_reduce(grad, ctx.dim, "sum"), None, None


class GatherAtUse(torch.autograd.Function):
    """FSDP's gather of one weight at its use, with its gradient routed to
    the weight's fp32 master block.

    ``forward(master, local, comm, steps, reduce_dims)``: ``local`` (the
    master's compute-dtype copy, cast once a step) all-gathered by
    ``steps``, ``(tensor axis, mesh dim, backward)`` in order. In the
    backward the gradient is cast to the master's dtype and each step undone
    in reverse: ``"sum"`` reduce-scatters (``data``: each data rank used the
    weight on its own rows), ``"slice"`` takes the rank's block (a ``model``
    gather whose result every ``model`` rank uses alike); then it is
    all-reduced over ``reduce_dims`` (a dim the leaf is not split over but
    whose ranks use it on their own rows). So the gradient lands in the
    rank's fp32 block."""

    @staticmethod
    def forward(ctx, master, local, comm, steps, reduce_dims):
        ctx.comm, ctx.steps, ctx.reduce_dims, ctx.dtype = comm, steps, reduce_dims, master.dtype
        x = local
        for axis, dim, _ in steps:
            x = comm._all_gather(x, dim, axis)
        return x

    @staticmethod
    def backward(ctx, grad):
        comm = ctx.comm
        g = grad.to(ctx.dtype)
        if ctx.steps or ctx.reduce_dims:
            comm.backward_guard(grad)
        for axis, dim, kind in reversed(ctx.steps):
            g = comm._reduce_scatter(g, dim, axis) if kind == "sum" else comm.block(g, dim, axis)
        for dim in ctx.reduce_dims:
            g = comm._all_reduce(g, dim, "sum")
        return g, None, None, None, None


class DistComm(Comm):
    """``Comm`` over a ``DeviceMesh`` this process is a rank of."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(names, (int(s) for s in mesh.shape)))
        self.coord = dict(zip(names, mesh.get_coordinate()))

    def _all_gather(self, x, dim, axis):
        import torch.distributed._functional_collectives as fc

        gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
        out = fc.wait_tensor(gather(x.contiguous(), axis, self.mesh.get_group(dim)))
        self.moved_bytes += out.numel() * out.element_size()
        return out

    def _all_reduce(self, x, dim, op="sum"):
        import torch.distributed._functional_collectives as fc

        out = fc.wait_tensor(fc.all_reduce(x.contiguous(), op, self.mesh.get_group(dim)))
        self.moved_bytes += out.numel() * out.element_size()
        return out

    def _reduce_scatter(self, x, dim, axis):
        import torch.distributed._functional_collectives as fc

        scatter = getattr(fc, "reduce_scatter_single", None) or fc.reduce_scatter_tensor
        out = fc.wait_tensor(scatter(x.contiguous(), "sum", axis, self.mesh.get_group(dim)))
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

    def backward_guard(self, grad):
        if grad.is_cuda:
            raise RuntimeError("ThreadComm cannot run a CUDA backward: the autograd engine runs every thread's CUDA "
                               "backward on one device thread, where a rank waiting in a collective blocks the "
                               "ranks it waits for. Train the ranks in processes of their own (DistComm) on the "
                               "card, or run ThreadComm's backward on the CPU")

    def _all_gather(self, x, dim, axis):
        got = self._exchange(x)
        out = torch.cat([got[r] for r in self._group(dim)], dim=axis)
        self.moved_bytes += out.numel() * out.element_size()
        return out

    def _all_reduce(self, x, dim, op="sum"):
        got = self._exchange(x)
        parts = [got[r] for r in self._group(dim)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        self.moved_bytes += out.numel() * out.element_size()
        return out

    def _reduce_scatter(self, x, dim, axis):
        got = self._exchange(x)
        parts = [self.block(got[r], dim, axis) for r in self._group(dim)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
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
