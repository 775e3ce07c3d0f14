"""GPipe-style pipeline parallelism over a ``stage`` mesh dim
(``repro.training.pipeline`` counterpart).

Each rank of the ``stage`` dim holds one stage's slice of the stacked
params (leading dim = stage) and runs the classic (n_micro + n_stages − 1)
-tick wavefront: stage 0 injects microbatch t, every other stage consumes
what its neighbour sent at the tick before, and the last stage commits
microbatch t − n_stages + 1. The activation moves to the next stage through
``_Shift``, a send/receive pair whose backward sends the gradient back the
other way (the reference's ``ppermute`` and its transpose), and the last
stage's outputs reach every rank through ``_SumToAll``, an all-reduce. So
the whole schedule is differentiable: training takes its gradients from
``torch.autograd`` through it, with no hand-written backward schedule.

Every rank runs the same ops in the same order (the first stage's input is
a ``torch.where`` on its neighbour's buffer, the other stages' outputs are
committed times 0), so each rank's backward reaches every ``_Shift`` of its
graph and the ranks' sends and receives pair up tick by tick.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_map


def _exchange(t: torch.Tensor, group, stage: int, n: int, step: int) -> torch.Tensor:
    """Send ``t`` to stage ``stage + step`` and receive from ``stage - step``
    (zeros where there is no such stage)."""
    out = torch.zeros_like(t)
    ops = []
    if 0 <= stage + step < n:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, stage + step), group))
    if 0 <= stage - step < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, stage - step), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage i's tensor arrives at stage i + 1; stage 0 gets zeros. The
    backward moves the gradient from stage i + 1 back to stage i."""

    @staticmethod
    def forward(ctx, y, group, stage, n):
        ctx.args = group, stage, n
        return _exchange(y, group, stage, n, +1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args, -1), None, None, None


class _SumToAll(torch.autograd.Function):
    """All-reduce (sum) of each rank's contribution, so every rank holds the
    result and computes the same loss on it. Each rank's cotangent is then
    the whole cotangent of its own contribution, so the backward is the
    identity (summing it over the ranks would count the loss once a rank)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe_forward(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh, axis: str = "stage") -> torch.Tensor:
    """``stage_fn(stage_params, h (mb, d)) -> (mb, d)`` chained over the
    stages of ``mesh``'s ``axis``; ``stacked_params`` leaves are (n_stages,
    ...), one slice per stage; ``x`` is (n_micro, mb, d). Returns the (n_micro,
    mb, d) outputs of the whole chain on every rank."""
    dim = mesh.mesh_dim_names.index(axis)
    n, stage, group = mesh.shape[dim], mesh.get_local_rank(axis), mesh.get_group(axis)
    local = tree_map(lambda p: p[stage], stacked_params)
    n_micro = x.shape[0]
    first = torch.tensor(stage == 0, device=x.device)
    commit = 1.0 if stage == n - 1 else 0.0  # only the last stage's outputs count
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(n_micro + n - 1):
        cur = torch.where(first, x[min(t, n_micro - 1)], buf)
        y = stage_fn(local, cur)
        if t >= n - 1:
            outs.append(y * commit)
        if t < n_micro + n - 2:  # the last tick's activation goes nowhere
            buf = _Shift.apply(y, group, stage, n)
    return _SumToAll.apply(torch.stack(outs), group)


def gpipe_loss_fn(stage_fn: Callable, readout_fn: Callable) -> Callable:
    """``loss(stacked_params, x, labels, mesh, axis="stage")`` =
    ``readout_fn(gpipe_forward(...), labels)``; differentiable through the
    whole schedule."""

    def loss(stacked_params, x, labels, mesh, axis="stage"):
        return readout_fn(gpipe_forward(stage_fn, stacked_params, x, mesh, axis), labels)

    return loss
