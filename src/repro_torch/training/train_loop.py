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

Under a mesh (``Trainer(mesh=)``) the steps run under ``use_mesh(mesh)``
as data parallelism over the mesh dims that ``ACT_RULES["batch"]``
resolves the batch to: each rank takes its block of the batch rows (all
rows when those dims do not divide the batch), the gradients and the loss
are averaged over those dims before the AdamW update, so every rank keeps
the same replicated params, and only rank 0 writes checkpoints. Training
keeps the params whole on every rank and computes replicated but for its
batch rows, as the serving side's gather-at-use does for the families
without a sharded forward; the served entries of every family but xLSTM,
Whisper and the VLM compute on shards (``models.transformer.prefill_sharded``), and a sharded
training step (sharded gradients, the dry run's train cells) is not ported
yet. On a mesh whose
batch dims are all 1 nothing is split or reduced, and a step is bit-equal
to the step with no mesh. The GPipe forward is ``training.pipeline``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, AdamWState, adamw_update, global_norm, init_adamw, warmup_cosine
from repro_torch.sharding import param_shardings, use_mesh
from repro_torch.sharding.rules import ACT_RULES, NamedSharding, PartitionSpec, mesh_sizes, place, resolve_pspec
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


def make_train_step(model: Model, tcfg: TrainConfig, *, reduce: Optional[Callable] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); metrics
    are fp32 scalars ``loss``, ``grad_norm`` (before clipping) and ``lr``.
    ``reduce(tensor)`` (data parallelism) averages the loss and every
    gradient over the ranks in place before the update."""
    sched = warmup_cosine(tcfg.adamw.lr, tcfg.warmup_steps, tcfg.num_steps)
    n_micro = tcfg.micro_batches

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


class Trainer:
    """Checkpointed, watchdogged training loop on one device, or one rank of
    ``mesh`` (data parallel over its batch dims: module docstring). After
    ``run`` the last params stay on the device as ``params``."""

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

    def _init_state(self) -> tuple[int, Any, AdamWState]:
        restored = self.mgr.restore()
        dev = self.device

        def load(t):  # a copy: the restored tensors may map the checkpoint's file
            return t.to(dev, copy=True)

        if restored is not None:
            o = restored.collections["opt_state"]
            opt = AdamWState(step=load(o["step"]), m=tree_map(load, o["m"]), v=tree_map(load, o["v"]))
            return restored.step, tree_map(load, restored.collections["params"]), opt
        gen = torch.Generator(device=dev).manual_seed(self.tcfg.seed)
        params = self.model.init(gen, device=dev, dtype=torch.float32)
        return 0, params, init_adamw(params)

    def run(self, num_steps: Optional[int] = None) -> TrainResult:
        tcfg = self.tcfg
        num_steps = num_steps or tcfg.num_steps
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
                if rank == 0 and ((step + 1) % tcfg.save_every == 0 or step + 1 == num_steps):
                    self.mgr.save(step + 1, {
                        "params": params,
                        "opt_state": {"step": opt.step, "m": opt.m, "v": opt.v},
                        "data_state": {"step": torch.tensor(step + 1, dtype=torch.int32)},
                    }, meta={"arch": self.model.cfg.name})
        self.mgr.wait()
        if self.mesh is not None:
            dist.barrier()  # rank 0's last checkpoint is committed before any rank returns
        self.params = params
        return TrainResult(final_step=num_steps, losses=losses, flagged_steps=list(self.watchdog.flagged),
                           restored_from=restored_from)
