"""Production-mesh dry run: trace every (arch × shape × mesh) cell without
the hardware (``repro.launch.dryrun`` counterpart).

The reference lowers and compiles each cell's step for 256 (or 512) forced
host devices. Here each cell runs in one process on a fake world of that
many ranks (``torch.distributed``'s ``"fake"`` backend, no process behind
any rank but this one, rank 0) under ``FakeTensorMode``, so a full-size
model is placed and stepped with no memory allocated:

  * the mesh is the port's ``DeviceMesh`` over that world
    (``production_mesh_shape`` geometries: 16×16 ``("data", "model")``, or
    2×16×16 with ``--multi-pod``);
  * parameters, optimizer state, caches and the batch are DTensors placed
    by the port's own rules (``param_shardings``; the activation rules for
    caches and batches), so each rank holds its local block;
  * the step runs as the port runs it under a mesh: a serving cell on a
    ("data", "model") mesh with a dim above 1 traces the sharded step on
    rank 0's blocks, for every family and with the cell's multimodal batch
    (``Model.prefill_sharded`` / ``decode_step_sharded``: DP rows,
    per-weight FSDP gathers over ``data``, TP / EP over ``model``,
    vocab-parallel embedding and head, the decode caches' slots, the
    RG-LRU's channels and the xLSTM's heads split over ``model``; see
    ``models.transformer.prefill_sharded``), as ``cold_start(mesh=)``
    serves them; a serving cell on a mesh with a ``pod`` dim gathers its
    params, caches and batch at use (``sharding.gather_tree``) and computes
    replicated;
  * a train cell runs the step as ``Trainer(mesh=)`` does, by mesh
    (``training.train_loop.on_shards``, the record's
    ``train_on_shards``): for every family on a ("data", "model") mesh, 1×1
    included, the step on shards on rank 0's fp32 master and moment
    blocks (``sharded_grads``: each block cast once,
    ``Model.loss_fn_sharded`` per micro-batch on the rank's rows of the
    batch, ``frames`` and ``image_embeds`` too, with each weight gathered
    over ``data`` at its use and its gradient reduce-scattered into the
    block, then the norm over blocks and AdamW in place on the blocks);
    on a mesh with a ``pod`` dim, the Trainer's data parallelism (each rank its block of the batch rows,
    gradients averaged over the batch's mesh dims) on params cast to bf16
    at their shards and gathered at use, with the AdamW update applied to
    each rank's local blocks;
  * everything runs under ``utils.hlocost``'s counter (FLOPs, bytes and
    collectives per device), ``FlopCounterMode`` (the raw total) and
    ``MemTracker`` (the per-device peak).

Each cell's record has the reference's keys; memory is per device
(``argument_size_in_bytes``: the local blocks of the arguments the step
reads, as the reference's compiled program drops an unused one, such as
the encoder's weights in an encoder-decoder's decode step;
``temp_size_in_bytes``: the tracked peak less every placed argument).
``fits`` compares arguments plus temporaries with the card's 80 GB.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all [--multi-pod] [--out build/dryrun]
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --device cpu --mesh 2x2 \\
      --override num_layers=2,d_model=64

Fake tensors carry ``--device`` (default ``cuda``) and no memory; on
``cuda`` the tracked sizes follow the caching allocator's 512-byte
rounding. Cells run with ``use_pallas=False`` as in the reference: no
kernel is launched.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, shape_applicable
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models.transformer import plain_versions
from repro_torch.models.zoo import Model, build_model
from repro_torch.optim import AdamWConfig, AdamWState, abstract_adamw, adamw_update, adamw_update_
from repro_torch.optim.adamw import clip_by_global_norm
from repro_torch.sharding import param_shardings, resolve_pspec, use_mesh
from repro_torch.sharding.comm import DistComm, mesh_dims_supported
from repro_torch.sharding.rules import (
    ACT_RULES,
    NamedSharding,
    PartitionSpec,
    _from_local,
    gather_tree,
    is_dtensor,
    local_box,
    mesh_sizes,
    shard_tree,
    spec_shard_divisor,
)
from repro_torch.training.train_loop import (
    accumulated_grads,
    data_parallel,
    on_shards,
    sharded_grads,
)
from repro_torch.utils import hlo as hlo_util
from repro_torch.utils import hlocost
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map

DEFAULT_OUT = "build/dryrun"


@dataclass
class Cell:
    """One built cell: ``fn(*args)`` on the placed arguments; ``args`` are
    meta-device trees and ``in_sh`` their shardings, tree for tree."""

    model: Model
    fn: Callable
    args: tuple
    in_sh: tuple
    micro_batches: int
    hooks: dict  # set while traced: ``repeats``, the counter's (``trace_cell``)
    train_on_shards: Optional[bool] = None  # a train cell's step: on shards, or gathered at use


def _tree_shardings(axes_tree, spec_tree, mesh) -> dict:
    flat_axes = dict(flatten_with_paths(axes_tree))
    return tree_from_flat({path: NamedSharding(mesh, resolve_pspec(flat_axes[path], leaf.shape, mesh, ACT_RULES))
                           for path, leaf in flatten_with_paths(spec_tree)})


def local_part(x):
    """This rank's block of a DTensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def _cast_shards(tree, dtype):
    """Each DTensor cast to ``dtype`` at its local block (no collective)."""
    def cast(x):
        if not is_dtensor(x):
            return x.to(dtype)
        return _from_local(x.to_local().to(dtype), x.shape, x.device_mesh, x.placements)
    return tree_map(cast, tree)


def _local_block(whole, like):
    """This rank's block of a whole tensor, cut as the DTensor ``like``."""
    box = local_box(whole.shape, like.device_mesh, like.placements)
    return whole[tuple(slice(a, b) for a, b in box)]


def _shape(shape) -> ShapeSpec:
    """A shape by its name in ``SHAPES``, or a ``ShapeSpec`` as it is."""
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def build_cell(arch: str, shape_name, mesh, *, logits_chunk: int = 512, remat: str = "full",
               fsdp: bool = True, micro_batches: int = 0, extra_cfg: Optional[dict] = None) -> Cell:
    """The cell's model, step and abstract arguments with their shardings.

    ``micro_batches``: gradient accumulation for the train step (0 = auto:
    scale with model size so activation memory fits; the global batch is
    unchanged, clamped so every micro-batch still covers the batch shards)."""
    shape = _shape(shape_name)
    cfg = get_config(arch)
    overrides: dict[str, Any] = dict(use_pallas=False, fsdp=fsdp, remat=remat)
    if shape.kind == "train" and cfg.vocab_size >= 64_000 and logits_chunk:
        overrides["logits_chunk"] = logits_chunk
    if extra_cfg:
        overrides.update(extra_cfg)
        micro_batches = int(overrides.pop("micro_batches", micro_batches))
    cfg = replace(cfg, **overrides)
    model = build_model(cfg)
    if micro_batches == 0:
        n = model.num_params()
        micro_batches = 16 if n > 40e9 else (8 if n > 8e9 else 4)
        sizes = mesh_sizes(mesh)
        batch_shards = math.prod(sizes.get(ax, 1) for ax in ("pod", "data"))
        if shape.kind == "train":
            micro_batches = max(1, min(micro_batches, shape.global_batch // batch_shards))
    if cfg.layers_per_unit == 1 and "layers_per_unit" not in (extra_cfg or {}):
        # group deep uniform stacks 4 (or 2) layers per scanned unit
        if cfg.num_layers >= 40 and cfg.recurrent is None and cfg.xlstm is None \
                and cfg.local_global_pattern is None and cfg.vlm is None:
            lead = cfg.moe.first_dense_layers if cfg.moe else 0
            for k in (4, 2):
                if (cfg.num_layers - lead) % k == 0:
                    cfg = replace(cfg, layers_per_unit=k)
                    model = build_model(cfg)
                    break

    entry = model.input_specs(shape)
    log_axes = model.logical_axes()
    if shape.kind == "train":
        abstract = model.abstract(dtype=torch.float32)  # fp32 masters
        p_sh = param_shardings(log_axes, abstract, mesh, fsdp=cfg.fsdp)
        (batch,), (batch_axes,) = entry.args, entry.arg_axes
        b_sh = _tree_shardings(batch_axes, batch, mesh)
        opt_abs = abstract_adamw(abstract)
        opt_sh = AdamWState(step=NamedSharding(mesh, PartitionSpec()), m=p_sh, v=p_sh)
        acfg = AdamWConfig()
        n_micro = micro_batches if shape.global_batch % max(micro_batches, 1) == 0 else 1
        compute = getattr(torch, cfg.dtype)

        hooks: dict = {}  # "repeats": the tracing counter's, so one micro-batch stands for all

        if on_shards(mesh):
            def train_step(params, opt_state, batch):
                comm = DistComm(mesh)  # at the trace: a cell may be built on a shape-only mesh
                shards = shard_tree(params)
                # the placed rows are the batch as ``cut_batch`` orders it:
                # each rank's micro-batch i is its block of global micro-batch i
                loss, grads = sharded_grads(model, shards, shard_tree(batch), n_micro, comm,
                                            repeats=hooks.get("repeats"))
                with torch.no_grad():
                    specs = {path: x.spec for path, x in flatten_with_paths(shards)}
                    state = adamw_update_(acfg, tree_from_flat(grads), AdamWState(*(_local_tree(t) for t in opt_state)),
                                          _local_tree(params), specs=specs, comm=comm)
                return params, opt_state._replace(step=_placed_like(state.step, opt_state.step)), loss

            return Cell(model, train_step, (abstract, opt_abs, batch), (p_sh, opt_sh, b_sh), n_micro, hooks, True)

        def train_step(params, opt_state, batch):
            _, mean = data_parallel(mesh, shape.global_batch)
            pb = gather_tree(_cast_shards(params, compute))  # bf16 compute copies, gathered at use
            rows = {k: local_part(v) for k, v in batch.items()}  # this rank's block of the rows
            micro = n_micro if next(iter(rows.values())).shape[0] % n_micro == 0 else 1
            loss, grads = accumulated_grads(model.loss_fn, pb, rows, micro, repeats=hooks.get("repeats"))
            grads = tree_map(lambda g: g.to(torch.float32), grads)
            if mean is not None:  # averaged over the ranks that split the batch
                tree_map(mean, grads)
                mean(loss)
            with torch.no_grad():
                grads, _ = clip_by_global_norm(grads, acfg.clip_norm)
                # each rank updates its blocks: the clipping above saw the whole gradients
                flat_p = dict(flatten_with_paths(params))
                local_g = tree_from_flat({k: _local_block(g, flat_p[k]) for k, g in flatten_with_paths(grads)})
                new_p, new_s = adamw_update(replace(acfg, clip_norm=0.0), local_g,
                                            AdamWState(*(_local_tree(t) for t in opt_state)), _local_tree(params))
            return _placed_like(new_p, params), _placed_like(new_s, opt_state), loss

        return Cell(model, train_step, (abstract, opt_abs, batch), (p_sh, opt_sh, b_sh), n_micro, hooks, False)

    abstract = model.abstract(dtype=torch.bfloat16)
    p_sh = param_shardings(log_axes, abstract, mesh, fsdp=cfg.fsdp)
    arg_sh = tuple(_tree_shardings(ax, a, mesh) for ax, a in zip(entry.arg_axes, entry.args))

    if sharded_cell(mesh):
        cache_specs = tree_map(lambda sh: sh.spec, arg_sh[0]) if shape.kind == "decode" else None

        def serve_step(params, *args):
            *caches, batch = args
            comm = DistComm(mesh)  # at the trace: a cell may be built on a shape-only mesh
            if cache_specs is None:
                return model.prefill_sharded(shard_tree(params), shard_tree(batch), comm)
            return model.decode_step_sharded(shard_tree(params), _local_tree(caches[0]), shard_tree(batch), comm,
                                             cache_specs)
    else:
        def serve_step(params, *args):
            return entry.fn(gather_tree(params), *(gather_tree(a) for a in args))

    return Cell(model, serve_step, (abstract, *entry.args), (p_sh, *arg_sh), 1, {})


def sharded_cell(mesh) -> bool:
    """True when a serving cell traces the sharded step: a ("data",
    "model") mesh with a dim above 1; the other cells gather at use."""
    sizes = mesh_sizes(mesh)
    return mesh_dims_supported(tuple(sizes)) and any(n > 1 for n in sizes.values())


def _local_tree(tree):
    return tree_map(local_part, tree)


def _placed_like(new, old):
    """Local blocks ``new`` as DTensors placed as ``old``'s, tree for tree."""
    if isinstance(new, dict):
        return {k: _placed_like(v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        return type(new)(*(_placed_like(n, o) for n, o in zip(new, old)))
    return _from_local(new, old.shape, old.device_mesh, old.placements)


def _place(tree, sh, mesh, device) -> Any:
    """Zero DTensors of an abstract tree's shapes, each rank its block (fake
    tensors under ``FakeTensorMode``)."""
    if isinstance(tree, dict):
        return {k: _place(v, sh[k], mesh, device) for k, v in tree.items()}
    if isinstance(tree, tuple):  # the arguments, or an AdamWState
        placed = [_place(t, s, mesh, device) for t, s in zip(tree, sh)]
        return type(tree)(*placed) if hasattr(tree, "_fields") else tuple(placed)
    placements = sh.placements()
    box = local_box(tree.shape, mesh, placements)
    local = torch.zeros([b - a for a, b in box], dtype=tree.dtype, device=device)
    return _from_local(local, tree.shape, mesh, placements)


def place_args(cell: Cell, mesh, device) -> tuple:
    return _place(cell.args, cell.in_sh, mesh, device)


def local_tensors(tree) -> list:
    """The local block of every tensor in a (nested) argument or output."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in local_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in local_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [local_part(tree)]
    return []


def local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in local_tensors(tree))


def closed_form_argument_bytes(cell: Cell, mesh, read: Optional[list] = None) -> int:
    """The arguments' bytes per device from the shardings alone: each leaf's
    bytes over its spec's shard divisor on ``mesh`` (a ``DeviceMesh`` or the
    shape-only ``MeshShape``), over the leaves ``read`` marks (a flag per
    leaf in ``local_tensors`` order, ``trace_cell``'s; default every leaf)."""
    flags = iter(read) if read is not None else None

    def one(tree, sh) -> int:
        if isinstance(tree, dict):
            return sum(one(v, sh[k]) for k, v in tree.items())
        if isinstance(tree, tuple):
            return sum(one(t, s) for t, s in zip(tree, sh))
        if flags is not None and not next(flags):
            return 0
        return tree.numel() * tree.element_size() // spec_shard_divisor(sh.spec, mesh)

    return one(cell.args, cell.in_sh)


def fake_world(ranks: int):
    """This process as rank 0 of a fake world of ``ranks`` (no process
    behind the others; collectives return at once). Destroy it with
    ``dist.destroy_process_group()``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)


def make_mesh(shape: tuple, names: tuple, device: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=names)


def trace_cell(cell: Cell, mesh, device: str, *, kernelized: bool = False) -> dict:
    """Place the cell's arguments as fake DTensors and run its step once
    under the cost counter, ``FlopCounterMode`` and ``MemTracker``. The
    arguments' bytes are those of the leaves the step reads (``read``, a
    flag per leaf): a leaf it never reads, as the encoder's weights in an
    encoder-decoder's decode step, is dropped from the reference's compiled
    program (``jax.jit`` keeps no unused argument) and counted here as
    temporaries' room only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
        args = place_args(cell, mesh, device)
        tracker = MemTracker()
        tracker.track_external(*local_tensors(args))
        counter = hlocost.CostCounter(kernelized=kernelized, weights=args[0])
        cell.hooks["repeats"] = counter.repeats
        t0 = time.perf_counter()
        try:
            with tracker, FlopCounterMode(display=False) as flops, counter, plain_versions():
                out = cell.fn(*args)
        finally:
            cell.hooks.pop("repeats")
        trace_s = time.perf_counter() - t0
        leaves = local_tensors(args)
        read = [counter.was_read(t) for t in leaves]
        mem = hlo_util.extract_memory(tracker, argument_bytes=sum(t.numel() * t.element_size()
                                                                  for t, r in zip(leaves, read) if r),
                                      placed_bytes=local_bytes(args), output_bytes=local_bytes(out))
    return {"cost": counter.cost, "raw_flops": float(flops.get_total_flops()), "memory": mem, "trace_s": trace_s,
            "read": read}


def model_flops(model: Model, shape) -> float:
    """6·N_active·D for train, 2·N_active·D for inference steps."""
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * model.active_params() * shape.tokens


def run_cell(arch: str, shape_name, *, multi_pod: bool = False, mesh_shape: Optional[tuple] = None,
             device: str = "cuda", out_dir: Optional[str] = DEFAULT_OUT, verbose: bool = True,
             extra_cfg: Optional[dict] = None, tag: str = "", kernelized: bool = False) -> dict:
    """One cell on a fake world of the production mesh's ranks (or of
    ``mesh_shape``, ``("data", "model")`` sizes); the process group lives
    for this cell only. Returns the record, also written under ``out_dir``."""
    shape_, names = (tuple(mesh_shape), ("data", "model")) if mesh_shape else PRODUCTION[multi_pod]
    label = "x".join(map(str, shape_))
    shape = _shape(shape_name)
    ok, reason = shape_applicable(get_config(arch), shape)
    if not ok:
        rec = {"arch": arch, "shape": shape.name, "mesh": label, "status": "skipped", "reason": reason}
        _save(rec, out_dir, tag)
        if verbose:
            print(f"[dryrun] {arch} × {shape.name} × {label}: skipped ({reason})")
        return rec
    fake_world(math.prod(shape_))
    try:
        mesh = make_mesh(shape_, names, device)
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh, extra_cfg=extra_cfg)
        res = trace_cell(cell, mesh, device, kernelized=kernelized)
        closed = closed_form_argument_bytes(cell, mesh, res["read"])
        lower_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    cost, mem = res["cost"], res["memory"]
    flops, nbytes = hlo_util.extract_cost(cost)
    coll = hlo_util.collective_stats(cost)
    n_chips = math.prod(shape_)
    per_dev = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": label,
        "status": "ok",
        "num_chips": n_chips,
        "hlo_flops": flops * n_chips,
        "hlo_dot_flops": cost.dot_flops * n_chips,
        "hlo_bytes": nbytes * n_chips,
        "collective_bytes": cost.collective_bytes,  # per device
        "collectives": {"bytes": coll.bytes_by_kind, "count": coll.count_by_kind},
        "raw_cost_analysis": {"flops": res["raw_flops"], "bytes": None},
        "memory": mem,
        "closed_form_argument_bytes": closed,
        "fits": per_dev <= hlo_util.HBM_BYTES,
        "model_flops": model_flops(cell.model, shape),
        "micro_batches": cell.micro_batches,
        "train_on_shards": cell.train_on_shards,
        "lower_s": lower_s,
        "compile_s": 0.0,
        "params": cell.model.num_params(),
        "active_params": cell.model.active_params(),
        "device": device,
        "tag": tag,
    }
    if verbose:
        on_shards = "" if cell.train_on_shards is None else f" train_on_shards={cell.train_on_shards}"
        print(f"[dryrun] {arch} × {shape.name} × {label}: OK flops/dev={cost.flops:.3e} bytes/dev={cost.bytes:.3e} "
              f"coll/dev={cost.collective_bytes:.3e} mem/dev={per_dev / 2**30:.2f}GiB "
              f"fits={'yes' if rec['fits'] else 'no'} lower={lower_s:.1f}s compile=0s{on_shards}")
        print("  memory:", {k: f"{v / 2**30:.3f}GiB" for k, v in mem.items()})
        print("  collectives:", {k: f"{v:.2e}B" for k, v in cost.collective_by_kind.items()})
    _save(rec, out_dir, tag)
    del cell, res
    gc.collect()
    return rec


def _save(rec: dict, out_dir: Optional[str], tag: str = "") -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    with open(os.path.join(out_dir, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def parse_overrides(text: str) -> dict:
    out: dict[str, Any] = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        out[k] = int(v) if v.lstrip("-").isdigit() else (v == "True") if v in ("True", "False") else v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="", help="DxM (data x model) instead of the production geometry")
    ap.add_argument("--device", default="cuda", help="the fake tensors' device (no memory is allocated)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="suffix for perf-iteration variants")
    ap.add_argument("--kernelized", action="store_true",
                    help="byte model with the attention scores on chip (flash kernels)")
    ap.add_argument("--override", default="", help="k=v,k=v config overrides")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    extra = parse_overrides(args.override)
    cells = [(arch, shape) for arch in archs for shape in shapes]
    kw = dict(multi_pod=args.multi_pod, mesh_shape=mesh_shape, device=args.device, out_dir=args.out,
              extra_cfg=extra or None, tag=args.tag, kernelized=args.kernelized)
    if args.jobs > 1:  # each cell in a process of its own, with its own fake world
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            runs = [ex.submit(_run_cell_or_report, arch, shape, kw) for arch, shape in cells]
            return 1 if sum(not r.result() for r in runs) else 0
    return 1 if sum(not _run_cell_or_report(arch, shape, kw) for arch, shape in cells) else 0


def _run_cell_or_report(arch: str, shape: str, kw: dict) -> bool:
    try:
        run_cell(arch, shape, **kw)
        sys.stdout.flush()
        return True
    except Exception:
        print(f"[dryrun] {arch} × {shape}: FAILED", file=sys.stderr)
        traceback.print_exc()
        return False


if __name__ == "__main__":
    sys.exit(main())
