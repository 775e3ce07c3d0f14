"""Training loop: train step, checkpointed resume, straggler watchdog
(``repro.training.train_loop`` counterpart, one device).

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

Not ported here: the mesh (``reshard_for_mesh``, elastic restart onto
another mesh) and the GPipe forward; both come with the sharding slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, AdamWState, adamw_update, global_norm, init_adamw, warmup_cosine
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


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); metrics
    are fp32 scalars ``loss``, ``grad_norm`` (before clipping) and ``lr``."""
    sched = warmup_cosine(tcfg.adamw.lr, tcfg.warmup_steps, tcfg.num_steps)
    n_micro = tcfg.micro_batches

    def step_fn(params: Any, opt_state: AdamWState, batch: dict):
        if n_micro == 1:
            loss, grads = value_and_grad(model.loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=opt_state.step.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            rows = next(iter(batch.values())).shape[0] // n_micro
            for i in range(n_micro):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, g = value_and_grad(model.loss_fn, params, mb)
                flat_g = dict(flatten_with_paths(g))
                grads = tree_from_flat({p: a + flat_g[p].to(torch.float32) for p, a in flatten_with_paths(grads)})
                loss = loss + l
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)
        with torch.no_grad():
            lr = sched(opt_state.step)
            gnorm = global_norm(grads)
            params, opt_state = adamw_update(tcfg.adamw, grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step_fn


@dataclass
class TrainResult:
    final_step: int
    losses: list
    flagged_steps: list
    restored_from: Optional[int]


class Trainer:
    """Checkpointed, watchdogged training loop on one device. After
    ``run`` the last params stay on the device as ``params``."""

    def __init__(self, model: Model, tcfg: TrainConfig, data: SyntheticTokenPipeline, ckpt_dir: str, *,
                 keep_n: int = 3, device="cuda"):
        self.model = model
        self.tcfg = tcfg
        self.data = data
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
        step_fn = make_train_step(self.model, tcfg)
        losses = []
        for step, batch in zip(range(start, num_steps), self.data.iterate_from(start)):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device, torch.int64) for k, v in batch.items()}
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            self.watchdog.record(step, time.perf_counter() - t0)
            losses.append(loss)
            if (step + 1) % tcfg.save_every == 0 or step + 1 == num_steps:
                self.mgr.save(step + 1, {
                    "params": params,
                    "opt_state": {"step": opt.step, "m": opt.m, "v": opt.v},
                    "data_state": {"step": torch.tensor(step + 1, dtype=torch.int32)},
                }, meta={"arch": self.model.cfg.name})
        self.mgr.wait()
        self.params = params
        return TrainResult(final_step=num_steps, losses=losses, flagged_steps=list(self.watchdog.flagged),
                           restored_from=restored_from)
