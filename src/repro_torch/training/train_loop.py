"""Training loop: train step, checkpointed resume, straggler watchdog,
elastic restart onto a mesh (``repro.training.train_loop`` counterpart).

  * restore-on-start from the latest committed checkpoint: a preempted job
    resumes with the same params, optimizer moments and data cursor
    (= step), so its numbers equal an uninterrupted run's;
  * async checkpointing every ``save_every`` steps and at the end;
  * the straggler watchdog on step wall times.

Params are fp32 masters; compute runs in ``cfg.dtype`` (the model casts each
weight at use), so gradients come back in fp32. The loss runs attention and
the RG-LRU scan through their plain versions on every device
(``models.transformer``): no kernel has a backward.

Gradient accumulation: ``micro_batches > 1`` runs the batch's row slices
one after another, adding each slice's grads into fp32 accumulators and
its loss into an fp32 sum, then divides both by the slice count, in the
reference's order.

Elastic restart: ``reshard_for_mesh`` places a restored host checkpoint
on any ("data", "model") mesh as DTensors by the param rules; checkpoints
are stored whole, so any mesh size restores them.

Under a mesh (``Trainer(mesh=)``) the step depends on the mesh's dims
(``on_shards``):

  * on a ("data", "model") mesh every family trains on shards
    (``make_train_step(comm=)``): the GQA stacks, dense or MoE, Gemma-3's
    5:1 local/global stack, DeepSeek-V2-Lite's MLA, RecurrentGemma's RG-LRU
    hybrid, xLSTM's mLSTM / sLSTM stack, Whisper's encoder-decoder and
    Llama-3.2-Vision's gated cross blocks. Each rank holds its fp32 blocks
    of the params and of both AdamW moments under ``param_shardings(...,
    fsdp=True)``, casts each block to its compute dtype once a step, and
    runs ``Model.loss_fn_sharded`` on its rows of the batch (``frames`` and
    ``image_embeds`` too): each weight is all-gathered over ``data`` at its
    use and its gradient reduce-scattered into the rank's fp32 block in the
    backward, every micro-batch (TP, EP and the vocab-parallel head and
    loss over ``model``). The rows are cut so that micro-batch i is the
    rank's block of the same global rows as the unsharded step's
    micro-batch i (``cut_batch``): the MoE's capacity sees the same tokens.
    ``global_norm`` and clipping see the whole gradient, each leaf counted
    once, and AdamW runs in place on the local blocks (``adamw_update_``).
    No rank holds a whole fp32 gradient tree or a whole compute-dtype param
    tree: the params are initialised block by block (``Model.init(blocks=)``,
    the encoder's and the cross blocks' leaves too), a restore reads each
    rank's blocks from the mapped files, and the moments are zeros of the
    blocks' shapes. For a checkpoint each leaf is gathered one stacked
    group at a time and rank 0 alone copies it to its host and writes the
    files, in the unsharded format. On a mesh of 1s no collective runs and
    a step is bit-equal to the step with no mesh;
  * a mesh with a ``pod`` dim keeps data parallelism with the whole tree on
    every rank: the steps run under ``use_mesh(mesh)``, each rank takes its
    block of the batch rows over the mesh dims that ``ACT_RULES["batch"]``
    resolves the batch to (all rows when those dims do not divide the
    batch), the gradients and the loss are averaged over those dims before
    the AdamW update, so every rank keeps the same replicated params, and
    only rank 0 writes checkpoints.

The GPipe forward is ``training.pipeline``.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models.transformer import master_compute_dtype
from repro_torch.models.zoo import Model
from repro_torch.optim import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    adamw_update_,
    global_norm,
    init_adamw,
    warmup_cosine,
)
from repro_torch.sharding import param_shardings, use_mesh
from repro_torch.sharding.comm import DistComm, mesh_dims_supported
from repro_torch.sharding.rules import (
    ACT_RULES,
    NamedSharding,
    PartitionSpec,
    Shard,
    act_specs,
    block_index,
    block_of,
    cut_tree,
    mesh_sizes,
    place,
    resolve_pspec,
    spec_dims,
)
from repro_torch.training.watchdog import StragglerWatchdog
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map


@dataclass
class TrainConfig:
    num_steps: int = 100
    save_every: int = 50
    log_every: int = 10
    micro_batches: int = 1
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    warmup_steps: int = 10
    seed: int = 0


def value_and_grad(loss_fn: Callable, params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
    """(loss, grads) of ``loss_fn(params, batch)`` with respect to every
    leaf of ``params``; a leaf the loss does not reach gets zero grads."""
    flat = flatten_with_paths(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad():
        loss = loss_fn(tree_from_flat({path: t for (path, _), t in zip(flat, leaves)}), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_from_flat({path: torch.zeros_like(t) if g is None else g
                                          for (path, _), t, g in zip(flat, leaves, grads)})


def accumulated_grads(loss_fn: Callable, params: Any, batch: dict, n_micro: int, *,
                      repeats: Optional[Callable] = None) -> tuple[torch.Tensor, Any]:
    """(loss, grads) over ``n_micro`` row slices of ``batch`` run one after
    another: fp32 grad accumulators and an fp32 loss sum, both divided by
    the slice count (module docstring); one slice is ``value_and_grad``.
    ``repeats`` (a cost counter's ``repeats``, for a traced step) runs the
    first slice only and has it counted as all ``n_micro``: the slices are
    alike in every shape."""
    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch)
    first = flatten_with_paths(params)[0][1]
    loss = torch.zeros((), dtype=torch.float32, device=first.device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    rows = next(iter(batch.values())).shape[0] // n_micro
    for i in range(n_micro if repeats is None else 1):
        with contextlib.nullcontext() if repeats is None else repeats(n_micro):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            l, g = value_and_grad(loss_fn, params, mb)
            flat_g = dict(flatten_with_paths(g))
            grads = tree_from_flat({p: a + flat_g[p].to(torch.float32) for p, a in flatten_with_paths(grads)})
            loss = loss + l
    return loss / n_micro, tree_map(lambda g: g / n_micro, grads)


def cut_batch(batch: dict, n_micro: int, comm) -> dict:
    """This rank's rows of a global batch (whole tensors) as ``Shard``
    leaves, ordered for ``sharded_grads``'s ``n_micro`` micro-batches: slice
    i of the rank's rows is its block of micro-batch i of the unsharded step
    (global rows [i·B/n, (i+1)·B/n), cut over the mesh dims that split the
    batch), so each micro-batch holds the unsharded step's rows in their
    order; ``frames`` and ``image_embeds`` are cut by the same rows as the
    tokens. Raises ValueError when a micro-batch's rows do not split evenly."""
    specs = act_specs(Model.batch_axes(batch, "train"), batch, comm)
    parts = math.prod(comm.size(ax) for ax in spec_dims(specs["tokens"], 0))
    rows = batch["tokens"].shape[0]
    if rows % (parts * n_micro):
        raise ValueError(f"{rows} rows do not split into {n_micro} micro-batches over {parts} batch shards")
    if n_micro > 1 and parts > 1:
        order = torch.arange(rows, device=batch["tokens"].device).view(n_micro, parts, -1).transpose(0, 1).reshape(-1)
        batch = {k: v[order] for k, v in batch.items()}
    return cut_tree(batch, specs, comm)


def _micro_rows(x: Shard, i: int, n: int) -> Shard:
    """Micro-batch ``i`` of ``n`` of a rank's rows: slice ``i`` of its own
    rows (``cut_batch`` orders them so)."""
    rows = x.local.shape[0] // n
    return Shard(x.local[i * rows:(i + 1) * rows], (x.shape[0] // n, *x.shape[1:]), x.spec)


def sharded_grads(model: Model, params: Any, batch: dict, n_micro: int, comm, *,
                  repeats: Optional[Callable] = None) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of the loss on shards (``Model.loss_fn_sharded``).

    ``params``: ``Shard`` leaves whose ``local`` is the rank's fp32 master
    block; ``batch``: ``Shard`` leaves of the rank's rows, as ``cut_batch``
    orders them. Each master block is cast once to the dtype the loss reads
    it in (``transformer.master_compute_dtype``); ``n_micro`` slices of the
    rank's rows run one after another, each backward reduce-scattering its
    gradients into the masters' fp32 ``.grad`` blocks, which sum the
    micro-batches in place; loss and grads are then divided by the slice
    count, as ``accumulated_grads`` does. ``grads`` maps each leaf's path to
    its fp32 block; the loss is the global mean, the same on every rank (the
    data ranks' shares summed). ``repeats``: ``accumulated_grads``'s. Raises
    ValueError when the rank's rows do not split into ``n_micro``."""
    rows = batch["tokens"].local.shape[0]
    if rows % n_micro:
        raise ValueError(f"a rank's {rows} rows do not split into {n_micro} micro-batches")
    flat = flatten_with_paths(params)
    masters = [x.local.detach().requires_grad_(True) for _, x in flat]
    tree = tree_from_flat({path: Shard(m.detach().to(master_compute_dtype(model.cfg, path)), x.shape, x.spec, m)
                           for (path, x), m in zip(flat, masters)})
    losses = []
    for i in range(n_micro if repeats is None else 1):
        with contextlib.nullcontext() if repeats is None else repeats(n_micro):
            mb = {k: _micro_rows(v, i, n_micro) for k, v in batch.items()} if n_micro > 1 else batch
            with torch.enable_grad():
                l = model.loss_fn_sharded(tree, mb, comm)
                l.backward()
            losses.append(l.detach())
    del tree
    grads = {path: torch.zeros_like(m) if m.grad is None else m.grad for (path, _), m in zip(flat, masters)}
    loss = losses[0]
    if n_micro > 1:
        loss = torch.zeros((), dtype=torch.float32, device=loss.device)
        for l in losses:
            loss = loss + l
        loss = loss / n_micro
        grads = {path: g.div_(n_micro) for path, g in grads.items()}
    return comm.all_reduce(loss, "data"), grads


def make_train_step(model: Model, tcfg: TrainConfig, *, reduce: Optional[Callable] = None, comm=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); metrics
    are fp32 scalars ``loss``, ``grad_norm`` (before clipping) and ``lr``.
    ``reduce(tensor)`` (data parallelism) averages the loss and every
    gradient over the ranks in place before the update.

    With ``comm`` (a ``sharding.comm.Comm``: the step on shards):
    ``params`` are ``Shard``
    leaves of the rank's fp32 master blocks, ``opt_state``'s moments trees
    of the rank's blocks and ``batch`` ``Shard`` leaves of its rows
    (``cut_batch``). The gradients come from ``sharded_grads``, the norm
    over blocks (``global_norm(specs=)``),
    and the update is written into the blocks in place (``adamw_update_``):
    ``params`` come back as the same ``Shard`` leaves."""
    sched = warmup_cosine(tcfg.adamw.lr, tcfg.warmup_steps, tcfg.num_steps)
    n_micro = tcfg.micro_batches

    if comm is not None:
        def sharded_step(params: Any, opt_state: AdamWState, batch: dict):
            loss, grads = sharded_grads(model, params, batch, n_micro, comm)
            with torch.no_grad():
                lr = sched(opt_state.step)
                specs = {path: x.spec for path, x in flatten_with_paths(params)}
                gnorm = global_norm(grads, specs=specs, comm=comm)
                masters = tree_from_flat({path: x.local for path, x in flatten_with_paths(params)})
                opt_state = adamw_update_(tcfg.adamw, tree_from_flat(grads), opt_state, masters, lr=lr,
                                          specs=specs, comm=comm)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

        return sharded_step

    def step_fn(params: Any, opt_state: AdamWState, batch: dict):
        loss, grads = accumulated_grads(model.loss_fn, params, batch, n_micro)
        if reduce is not None:
            tree_map(reduce, grads)
            reduce(loss)
        with torch.no_grad():
            lr = sched(opt_state.step)
            gnorm = global_norm(grads)
            params, opt_state = adamw_update(tcfg.adamw, grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step_fn


def reshard_for_mesh(host_collections: dict, mesh, model: Model, *, fsdp: bool = True) -> dict:
    """Elastic restart: place a restored host checkpoint (whole arrays) on a
    mesh of any size as DTensors. Params follow the param rules, the AdamW
    moments ``m.<p>`` / ``v.<p>`` their param's sharding; everything else
    (scalars, the (1,) step counters the bundle writer stores) replicates.
    Each rank copies only its own block to the mesh's device."""
    shardings = dict(flatten_with_paths(param_shardings(model.logical_axes(), model.abstract(), mesh, fsdp=fsdp)))
    replicated = NamedSharding(mesh, PartitionSpec())
    out = {}
    for cname, tree in host_collections.items():
        placed = {}
        for path, leaf in flatten_with_paths(tree):
            key = path[2:] if path.startswith(("m.", "v.")) else path
            sh = shardings.get(key)
            if sh is None or leaf.dim() == 0:
                sh = replicated
            placed[path] = place(leaf, mesh, sh, mesh.device_type)
        out[cname] = tree_from_flat(placed)
    return out


def data_parallel(mesh, rows: int) -> tuple[slice, Optional[Callable]]:
    """This rank's block of a batch of ``rows`` rows on ``mesh``, and the
    in-place mean over the ranks that split it (None when nothing splits)."""
    spec = resolve_pspec(("batch",), (rows,), mesh, ACT_RULES)
    dims = () if not spec else spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    sizes, coord = mesh_sizes(mesh), mesh.get_coordinate()
    names = list(sizes)
    n, index = 1, 0
    for dim in dims:  # mesh-dim order, the first outermost
        n, index = n * sizes[dim], index * sizes[dim] + coord[names.index(dim)]
    if n == 1:
        return slice(None), None
    groups = [mesh.get_group(dim) for dim in dims]

    def mean(t: torch.Tensor) -> None:
        for g in groups:
            dist.all_reduce(t, group=g)
        t.div_(n)

    block = rows // n
    return slice(index * block, (index + 1) * block), mean


@dataclass
class TrainResult:
    final_step: int
    losses: list
    flagged_steps: list
    restored_from: Optional[int]


def on_shards(mesh) -> bool:
    """True when ``Trainer(mesh=)`` (and the dry run's train cell) runs the
    step on shards: a mesh of no dims but ``data`` and ``model``, for every
    family. A mesh with a ``pod`` dim keeps data parallelism with the whole
    tree on every rank."""
    return mesh_dims_supported(tuple(mesh_sizes(mesh)))


def _whole_on_host(tree: Any, shapes: dict, specs: dict, comm, keep: bool) -> Optional[dict]:
    """Each leaf's blocks gathered to the whole leaf (every rank takes part),
    a stacked leaf one group at a time, so a device holds at most one group
    of one leaf whole; the rank that ``keep``s them copies them to its host
    (the others get None)."""
    out = {}
    for path, x in flatten_with_paths(tree):
        s = Shard(x, shapes[path], specs[path])
        host = torch.empty(shapes[path], dtype=x.dtype) if keep else None
        for i in range(x.shape[0]) if x.dim() > 1 and not s.split(0) else (None,):
            whole = (s if i is None else s[i]).gathered(comm)
            if keep:
                (host if i is None else host[i]).copy_(whole)
            del whole
        out[path] = host
    return tree_from_flat(out) if keep else None


class Trainer:
    """Checkpointed, watchdogged training loop on one device, or one rank of
    ``mesh`` (module docstring): on shards on a ("data", "model") mesh, for
    every family (``on_shards``), data parallel with the whole tree on every
    rank on a mesh with a ``pod`` dim. After ``run``
    the last params stay on the device as ``params``: the whole tree, or
    this rank's fp32 blocks when the step ran on shards."""

    def __init__(self, model: Model, tcfg: TrainConfig, data: SyntheticTokenPipeline, ckpt_dir: str, *,
                 mesh=None, keep_n: int = 3, device="cuda"):
        self.model = model
        self.tcfg = tcfg
        self.data = data
        self.mesh = mesh
        self.device = torch.device(device)
        self.mgr = CheckpointManager(ckpt_dir, keep_n=keep_n)
        self.watchdog = StragglerWatchdog()
        self.params: Optional[Any] = None

    def _init_state(self, specs: Optional[dict] = None, comm=None) -> tuple[int, Any, AdamWState]:
        """(step, params, AdamW state), restored from the latest checkpoint
        or initialised from the seed. With ``specs`` (path -> the leaf's
        spec on ``comm``'s mesh) each leaf is only this rank's block: a
        restore copies each block out of the mapped files, an init draws
        the blocks alone (``Model.init(blocks=)``)."""
        restored = self.mgr.restore()
        dev = self.device

        def load(path, t):  # a copy: the restored tensors may map the checkpoint's file
            return (t if specs is None else block_of(t, specs[path], comm)).to(dev, copy=True)

        def tree(t):
            return tree_from_flat({path: load(path, x) for path, x in flatten_with_paths(t)})

        if restored is not None:
            o = restored.collections["opt_state"]
            opt = AdamWState(step=o["step"].to(dev, copy=True), m=tree(o["m"]), v=tree(o["v"]))
            return restored.step, tree(restored.collections["params"]), opt
        gen = torch.Generator(device=dev).manual_seed(self.tcfg.seed)
        blocks = None if specs is None else {path: block_index(x.shape, specs[path], comm)
                                             for path, x in flatten_with_paths(self.model.abstract())}
        params = self.model.init(gen, device=dev, dtype=torch.float32, blocks=blocks)
        return 0, params, init_adamw(params)

    def run(self, num_steps: Optional[int] = None) -> TrainResult:
        tcfg = self.tcfg
        num_steps = num_steps or tcfg.num_steps
        if self.mesh is not None and on_shards(self.mesh):
            return self._run_on_shards(num_steps)
        start, params, opt = self._init_state()
        restored_from = start if start > 0 else None
        rank = dist.get_rank() if self.mesh is not None else 0
        losses = []
        mine, reduce = (slice(None), None) if self.mesh is None else data_parallel(self.mesh, self.data.local_batch)
        step_fn = make_train_step(self.model, tcfg, reduce=reduce)
        with use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext():
            for step, batch in zip(range(start, num_steps), self.data.iterate_from(start)):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v[mine]).to(self.device, torch.int64) for k, v in batch.items()}
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                self.watchdog.record(step, time.perf_counter() - t0)
                losses.append(loss)
                if rank == 0 and self._saves(step, num_steps):
                    self._save(step, params, opt)
        return self._finish(num_steps, losses, params, restored_from)

    def _saves(self, step: int, num_steps: int) -> bool:
        return (step + 1) % self.tcfg.save_every == 0 or step + 1 == num_steps

    def _save(self, step: int, params: Any, opt: AdamWState) -> None:
        self.mgr.save(step + 1, {
            "params": params,
            "opt_state": {"step": opt.step, "m": opt.m, "v": opt.v},
            "data_state": {"step": torch.tensor(step + 1, dtype=torch.int32)},
        }, meta={"arch": self.model.cfg.name})

    def _run_on_shards(self, num_steps: int) -> TrainResult:
        """``run`` with the step on shards (module docstring): this rank's
        blocks are restored or initialised, and no whole tree is placed."""
        comm = DistComm(self.mesh)
        abstract = flatten_with_paths(self.model.abstract())
        shapes = {path: tuple(x.shape) for path, x in abstract}
        specs = {path: sh.spec for path, sh in flatten_with_paths(
            param_shardings(self.model.logical_axes(), self.model.abstract(), self.mesh, fsdp=self.model.cfg.fsdp))}
        start, blocks, opt = self._init_state(specs, comm)
        shards = tree_from_flat({path: Shard(x, shapes[path], specs[path]) for path, x in flatten_with_paths(blocks)})
        del blocks
        step_fn = make_train_step(self.model, self.tcfg, comm=comm)
        rank, losses = dist.get_rank(), []
        for step, batch in zip(range(start, num_steps), self.data.iterate_from(start)):
            t0 = time.perf_counter()
            batch = cut_batch({k: torch.from_numpy(v).to(self.device, torch.int64) for k, v in batch.items()},
                              self.tcfg.micro_batches, comm)
            shards, opt, metrics = step_fn(shards, opt, batch)
            loss = float(metrics["loss"])
            self.watchdog.record(step, time.perf_counter() - t0)
            losses.append(loss)
            if self._saves(step, num_steps):
                local = tree_from_flat({path: x.local for path, x in flatten_with_paths(shards)})
                host = [_whole_on_host(t, shapes, specs, comm, rank == 0) for t in (local, opt.m, opt.v)]
                if rank == 0:
                    self._save(step, host[0], AdamWState(step=opt.step, m=host[1], v=host[2]))
                del host
        blocks = tree_from_flat({path: x.local for path, x in flatten_with_paths(shards)})
        return self._finish(num_steps, losses, blocks, start if start > 0 else None)

    def _finish(self, num_steps: int, losses: list, params: Any, restored_from: Optional[int]) -> TrainResult:
        self.mgr.wait()
        if self.mesh is not None:
            dist.barrier()  # rank 0's last checkpoint is committed before any rank returns
        self.params = params
        return TrainResult(final_step=num_steps, losses=losses, flagged_steps=list(self.watchdog.flagged),
                           restored_from=restored_from)
