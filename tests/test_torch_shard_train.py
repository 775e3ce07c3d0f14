"""The train step on shards (``Model.loss_fn_sharded``,
``training.train_loop.sharded_grads`` / ``make_train_step(comm=)``,
``Trainer(mesh=)``) against the reference's unsharded ``make_train_step``,
on the CPU.

Reduced Mixtral (MoE) and Yi (dense) at 1×2, 2×1 and 2×2, reduced Phi-3 and
Mistral-Large at 2×2, reduced Gemma-3 (5:1 local/global, tied table),
DeepSeek-V2-Lite (MLA, a dense lead, a MoE with a shared expert) and
RecurrentGemma (rec/rec/attn, MQA, tied table) at 1×2 and 2×2, all in fp32, on the reference's weights
(``jax.random.PRNGKey(0)``, as numpy) and one seeded B=4 × 16 batch. One gloo
spawn per world (``torch.multiprocessing``, a ``file://`` rendezvous) runs
every arch of the world, and on 2×2 ``Trainer(mesh=)`` too (Mixtral and
DeepSeek-V2-Lite); each rank saves
what the tests read. Held to the reference:

  * the loss, the grad norm and every leaf's gradient (each rank's blocks
    gathered to the whole leaf) of ``sharded_grads`` against
    ``jax.value_and_grad`` of the reference's loss, which its
    ``make_train_step`` runs;
  * two AdamW steps of ``make_train_step(comm=)`` at 2 micro-batches
    against two of the reference's jitted ``make_train_step`` on the same
    batch: the losses, grad norms and the params after them. The ranks'
    rows are cut by ``cut_batch``, so each micro-batch holds the
    reference's micro-batch's rows in its order, and the MoE's capacity
    drops the same tokens;
  * the MoE archs' expert ids of every layer (the router's top-k, caught at
    its dispatch) equal the reference's, before any gradient is compared: a
    near-tie broken apart would show here first, and no seed is chosen to
    avoid one;
  * each rank's gradient bytes equal the closed form of its shardings
    (each leaf's fp32 bytes over its spec's shard divisor): no rank holds
    a whole gradient tree.

Tolerances, absolute. ``GRAD_TOL`` = 1e-5 for the loss, the grad norm and
the gradients: the ranks add the data ranks' partial gradients in a
reduce-scatter and the ``model`` ranks' partial sums in all-reduces, and
JAX and PyTorch order their fp32 reductions differently (measured: ≤ 2.4e-7
on the gradients, ≤ 9.5e-7 on losses near 6.3). ``STEP_TOL`` = 1e-4, the
serving parity's limit (``tests/test_torch_shard_compute.py``), for the
params and moments after two AdamW steps: AdamW's first updates divide
each gradient component by its own size, so a component whose gradient is
near zero passes its rounding on whole (measured: ≤ 4.8e-5, on one element
of Mixtral's ``wo`` at 1×2; every other element ≤ 1e-5). A missing or
doubled reduction moves a gradient by its whole size, and an update by lr =
1e-3.

Besides: ``ThreadComm`` (``run_ranks``, one thread a rank) at 1×4 and 1×8 on
reduced Mixtral against the same reference (at 1×8 neither the heads nor
the experts divide ``model``); the chunked vocab-parallel cross-entropy of
Yi and Phi-3 (``cfg.logits_chunk``) at 2×2 on threads against the
reference's chunked loss; and on the 2×2 world ``Trainer(mesh=)`` on reduced
Mixtral and DeepSeek-V2-Lite at 2 micro-batches, two steps and then one more resumed from its
checkpoint, whose losses and rank 0's checkpoints (restored by the
reference's ``CheckpointManager``, and byte for byte by the port's) equal
the unsharded port ``Trainer``'s over three steps.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, global_norm, init_adamw
from repro_torch.sharding.comm import DistComm, run_ranks
from repro_torch.sharding.rules import MeshShape, Shard, cut_tree, param_shardings, spec_shard_divisor
from repro_torch.training import TrainConfig, Trainer, make_train_step
from repro_torch.training.train_loop import cut_batch, sharded_grads
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map

# The spawned ranks import this module; JAX and the reference package are
# imported inside the functions that run in the test process only.

PAIR = ("mixtral-8x22b", "yi-34b")
# Gemma-3's 5:1 stack with its tied table, DeepSeek-V2-Lite's MLA with a
# dense lead and a MoE with a shared expert, RecurrentGemma's rec/rec/attn
FAMILIES = ("gemma3-27b", "deepseek-v2-lite-16b", "recurrentgemma-9b")
# the encoder-decoder, the gated cross blocks and the mLSTM / sLSTM stack
# (their worlds: ``tests/test_torch_shard_train_modal.py``)
MODAL = ("whisper-base", "llama-3.2-vision-90b", "xlstm-125m")
WORLDS = {(1, 2): PAIR + FAMILIES, (2, 1): PAIR, (2, 2): PAIR + ("phi3-medium-14b", "mistral-large-123b") + FAMILIES}
B, S = 4, 16
MICRO = 2  # the two-step runs' micro-batches
GRAD_TOL = 1e-5  # loss, grad norm and gradients (module docstring)
STEP_TOL = 1e-4  # the params and moments after two AdamW steps
TRAINER_ARCHS = ("mixtral-8x22b", "deepseek-v2-lite-16b")  # Trainer(mesh=) on the 2×2 world
TRAINER_STEPS = 3  # two, a checkpoint, and one more resumed from it


def _tc(micro: int = MICRO, eps: float = 1e-8) -> TrainConfig:
    return TrainConfig(num_steps=4, warmup_steps=1, micro_batches=micro, adamw=AdamWConfig(lr=1e-3, eps=eps))


def _ref_tc(eps: float = 1e-8):
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.training import TrainConfig as RefTrainConfig

    return RefTrainConfig(num_steps=4, warmup_steps=1, micro_batches=MICRO, adamw=RefAdamWConfig(lr=1e-3, eps=eps))


def _batch() -> dict:
    rs = np.random.default_rng(11)
    return {k: rs.integers(0, 512, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


def _close(got, want, what: str, tol: float = GRAD_TOL) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0, err_msg=what)


class _Routing(TorchDispatchMode):
    """Catches the expert ids of every router top-k dispatched inside."""

    def __init__(self):
        super().__init__()
        self.ids = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.topk.default:
            self.ids.append(out[1].clone())
        return out


def _ref_routing(ref_model, params, batch) -> list:
    """The reference's expert ids of every MoE layer, in layer order, from its
    own forward (``moe_forward`` wrapped to pass its top-k ids to the host)."""
    import jax

    import repro.models.moe as ref_moe

    seen = []
    forward = ref_moe.moe_forward

    def recording(p, x, cfg, **kw):
        ids = jax.lax.top_k(ref_moe.router_probs(p, x.reshape(-1, x.shape[-1])), cfg.moe.top_k)[1]
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), ids, ordered=True)
        return forward(p, x, cfg, **kw)

    ref_moe.moe_forward = recording
    try:
        jax.block_until_ready(ref_model.loss_fn(params, batch))
        jax.effects_barrier()
    finally:
        ref_moe.moe_forward = forward
    return seen


def _ref_models() -> dict:
    """Each arch's reference model and its weights (``PRNGKey(0)``)."""
    import jax

    from repro.configs import get_reduced as ref_get_reduced
    from repro.models.zoo import build_model as ref_build_model

    out = {}
    for arch in sorted({a for v in WORLDS.values() for a in v}):
        ref_model = ref_build_model(ref_get_reduced(arch).replace(dtype="float32"))
        out[arch] = ref_model, ref_model.init(jax.random.PRNGKey(0))
    return out


def _reference(models: dict, batch: dict, eps: float = 1e-8) -> dict:
    """Per arch: the reference's loss, grad norm and gradients at one
    micro-batch, the expert ids (MoE), and two jitted ``make_train_step``
    steps at MICRO micro-batches (AdamW's ``eps``)."""
    import jax
    import jax.numpy as jnp

    from repro.optim import global_norm as ref_global_norm
    from repro.optim import init_adamw as ref_init_adamw
    from repro.training.train_loop import make_train_step as ref_make_train_step
    from repro.utils.tree import flatten_with_paths as ref_flatten

    out = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for arch, (ref_model, params) in models.items():
        loss, grads = jax.jit(jax.value_and_grad(ref_model.loss_fn))(params, jb)
        rec = dict(loss=float(loss), grad_norm=float(ref_global_norm(grads)),
                   grads={p: np.asarray(v) for p, v in ref_flatten(grads)})
        if ref_model.cfg.moe is not None:
            rec["ids"] = _ref_routing(ref_model, params, jb)
        step = jax.jit(ref_make_train_step(ref_model, _ref_tc(eps)))
        p, opt, metrics = params, ref_init_adamw(params), []
        for _ in range(2):
            p, opt, m = step(p, opt, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        rec["steps"] = dict(metrics=metrics, params={k: np.asarray(v) for k, v in ref_flatten(p)})
        out[arch] = rec
    return out


def _whole(blocks: dict, specs: dict, comm) -> dict:
    """Every leaf's blocks gathered to the whole leaf (every rank takes part)."""
    return {p: Shard(x, (), specs[p]).gathered(comm) for p, x in blocks.items()}


def _rank_run(model, params_np: dict, batch_np: dict, comm, eps: float = 1e-8) -> dict:
    """One arch on this rank: ``sharded_grads`` at one micro-batch (loss,
    norm, gathered gradients, this rank's gradient bytes, the expert ids of
    its rows), then two steps of ``make_train_step(comm=)`` at MICRO
    (AdamW's ``eps``)."""
    mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
    specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(), mesh))
    flat_specs = dict(flatten_with_paths(specs))
    whole = tree_from_flat({p: torch.from_numpy(np.array(v)) for p, v in params_np.items()})
    batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in batch_np.items()}
    rows = cut_batch(batch, 1, comm)

    def shards():
        return cut_tree(tree_map(lambda x: x.clone(), whole), specs, comm)

    p = shards()
    loss, grads = sharded_grads(model, p, rows, 1, comm)
    out = dict(loss=float(loss), grad_norm=float(global_norm(grads, specs=flat_specs, comm=comm)),
               grad_bytes=sum(g.numel() * g.element_size() for g in grads.values()),
               closed_bytes=sum(4 * int(np.prod(v.shape)) // spec_shard_divisor(flat_specs[k], mesh)
                                for k, v in params_np.items()),
               grads={k: v.numpy() for k, v in _whole(grads, flat_specs, comm).items()})
    if model.cfg.moe is not None:
        with torch.no_grad(), _Routing() as routing:
            model.loss_fn_sharded(tree_map(lambda s: Shard(s.local, s.shape, s.spec, s.local), p), rows, comm)
        out["ids"] = [t.numpy() for t in routing.ids]
    p = shards()
    opt = init_adamw(tree_map(lambda s: s.local, p))
    step_fn, metrics, micro_rows = make_train_step(model, _tc(eps=eps), comm=comm), [], cut_batch(batch, MICRO, comm)
    for _ in range(2):
        p, opt, m = step_fn(p, opt, micro_rows)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    local = {k: s.local for k, s in flatten_with_paths(p)}
    out["steps"] = dict(metrics=metrics, params={k: v.numpy() for k, v in _whole(local, flat_specs, comm).items()})
    return out


def _trainer_data(model) -> SyntheticTokenPipeline:
    return SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, S, B, seed=3))


def _trainer_tc() -> TrainConfig:
    return TrainConfig(num_steps=TRAINER_STEPS, save_every=2, warmup_steps=1, micro_batches=MICRO,
                       adamw=AdamWConfig(lr=1e-3))


def _train_rank(rank: int, world: tuple, init: str, ref_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)  # eight ranks share the host, at these widths threads only contend
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world[0] * world[1])
    try:
        mesh = make_debug_mesh(*world, device="cpu")
        comm = DistComm(mesh)
        ref = torch.load(ref_path, weights_only=False)
        rec = {arch: _rank_run(build_model(get_reduced(arch).replace(dtype="float32")), ref[arch], ref["batch"], comm)
               for arch in WORLDS[world]}
        rec["coord"] = (comm.index("data"), comm.index("model"))
        for arch in TRAINER_ARCHS if world == (2, 2) else ():
            # two steps, then a new Trainer resumes from the checkpoint for the third
            model = build_model(get_reduced(arch).replace(dtype="float32"))
            runs = []
            for num_steps in (2, TRAINER_STEPS):
                trainer = Trainer(model, _trainer_tc(), _trainer_data(model), os.path.join(out_dir, "ckpt", arch),
                                  mesh=mesh, device="cpu")
                r = trainer.run(num_steps)
                runs.append(dict(losses=r.losses, restored_from=r.restored_from,
                                 param_bytes=sum(x.numel() * x.element_size()
                                                 for _, x in flatten_with_paths(trainer.params))))
            rec[("trainer", arch)] = runs
        torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, worlds): the three worlds' spawns started together on the
    reference's weights, the reference computed in this process meanwhile
    (``_reference``); each world's ranks' records in rank order and its
    directory."""
    from repro.utils.tree import flatten_with_paths as ref_flatten

    tmp = tmp_path_factory.mktemp("shard_train")
    models, batch = _ref_models(), _batch()
    weights = {arch: {p: np.asarray(v) for p, v in ref_flatten(params)} for arch, (_, params) in models.items()}
    torch.save({**weights, "batch": batch}, tmp / "ref.pt")
    spawns = {}
    for world in WORLDS:
        where = tmp / "x".join(map(str, world))
        where.mkdir()
        spawns[world] = (where, mp.start_processes(_train_rank, args=(world, f"file://{where / 'rendezvous'}",
                                                                      str(tmp / "ref.pt"), str(where)),
                                                   nprocs=world[0] * world[1], join=False, start_method="spawn"))
    try:
        reference = _reference(models, batch)
    finally:
        for _, ctx in spawns.values():
            while not ctx.join():
                pass
    reference.update({arch: dict(reference[arch], params=weights[arch]) for arch in weights}, batch=batch)
    worlds = {world: dict(ranks=[torch.load(where / f"rank{r}.pt", weights_only=False)
                                 for r in range(world[0] * world[1])], dir=str(where))
              for world, (where, _) in spawns.items()}
    return reference, worlds


@pytest.fixture
def reference(runs):
    return runs[0]


@pytest.fixture
def world_result(runs):
    return runs[1].__getitem__


CASES = [(w, a) for w, archs in WORLDS.items() for a in archs]


def _ids(world, arch):
    return f"{'x'.join(map(str, world))}-{arch}"


@pytest.mark.parametrize("world,arch", CASES, ids=[_ids(*c) for c in CASES])
def test_sharded_gradients_match_the_reference(world, arch, reference, world_result):
    """Loss, grad norm and every leaf's gathered gradient against the
    reference's ``value_and_grad``, on every rank (the model ranks of a row
    block hold the same loss, and every rank the whole gradient once
    gathered); the MoE archs' expert ids equal the reference's first."""
    ref, ranks = reference[arch], world_result(world)["ranks"]
    for rank, rec in enumerate(ranks):
        got = rec[arch]
        if "ids" in ref:
            d = rec["coord"][0]
            rows = S * B // world[0]
            assert len(got["ids"]) == len(ref["ids"])
            for layer, (mine, want) in enumerate(zip(got["ids"], ref["ids"])):
                np.testing.assert_array_equal(mine, want[d * rows:(d + 1) * rows], err_msg=f"rank {rank} layer {layer}")
        _close(got["loss"], ref["loss"], f"rank {rank} loss")
        _close(got["grad_norm"], ref["grad_norm"], f"rank {rank} grad norm")
        assert set(got["grads"]) == set(ref["grads"])
        for path, want in ref["grads"].items():
            _close(got["grads"][path], want, f"rank {rank} {path}")


@pytest.mark.parametrize("world,arch", CASES, ids=[_ids(*c) for c in CASES])
def test_two_sharded_steps_match_the_reference(world, arch, reference, world_result):
    """Two AdamW steps at MICRO micro-batches: each step's loss and grad norm
    and the params after both against the reference's ``make_train_step``
    on the same batch (each rank's rows cut by ``cut_batch``)."""
    ref = reference[arch]["steps"]
    for rank, rec in enumerate(world_result(world)["ranks"]):
        got = rec[arch]["steps"]
        _close(got["metrics"], ref["metrics"], f"rank {rank} metrics")
        for path, want in ref["params"].items():
            _close(got["params"][path], want, f"rank {rank} {path}", STEP_TOL)


@pytest.mark.parametrize("world", list(WORLDS), ids=lambda w: "x".join(map(str, w)))
def test_each_rank_holds_only_its_gradient_blocks(world, world_result):
    """Each rank's fp32 gradient bytes are the closed form of its
    shardings: Σ leaf bytes / the leaf's shard divisor on the mesh."""
    for rec in world_result(world)["ranks"]:
        for arch in WORLDS[world]:
            assert rec[arch]["grad_bytes"] == rec[arch]["closed_bytes"], arch
            if world != (1, 1):
                assert rec[arch]["grad_bytes"] < sum(4 * g.size for g in rec[arch]["grads"].values()), arch


@pytest.mark.parametrize("model_ranks", [4, 8])
def test_thread_ranks_train_as_the_reference(model_ranks, reference):
    """``run_ranks`` at 1×4 and 1×8 (one thread a rank in this process, each
    rank's backward on its own thread, collectives by hand in rank order)
    on reduced Mixtral: loss, norm and gathered gradients, and the params
    after two steps, against the reference's, and its expert ids. At 1×8
    the 4 q heads and the 4 experts do not divide ``model``: every rank runs
    every head, its attention weights gathered over ``model`` (their
    gradient cut back to the rank's block), and each expert's ``ffn`` is
    split instead (TP within the experts)."""
    ref = reference["mixtral-8x22b"]
    model = build_model(get_reduced("mixtral-8x22b").replace(dtype="float32"))
    ranks = run_ranks({"data": 1, "model": model_ranks},
                      lambda comm: _rank_run(model, ref["params"], reference["batch"], comm))
    for rank, got in enumerate(ranks):
        for mine, want in zip(got["ids"], ref["ids"]):
            np.testing.assert_array_equal(mine, want)
        _close(got["loss"], ref["loss"], f"rank {rank} loss")
        _close(got["grad_norm"], ref["grad_norm"], f"rank {rank} grad norm")
        for path, want in ref["grads"].items():
            _close(got["grads"][path], want, f"rank {rank} {path}")
        assert got["grad_bytes"] == got["closed_bytes"]
        _close(got["steps"]["metrics"], ref["steps"]["metrics"], f"rank {rank} metrics")
        for path, want in ref["steps"]["params"].items():
            _close(got["steps"]["params"][path], want, f"rank {rank} {path}", STEP_TOL)


def test_trainer_on_a_2x2_mesh_matches_the_unsharded_trainer(tmp_path, world_result):
    """``Trainer(mesh=2×2)`` on reduced Mixtral at MICRO micro-batches, two
    steps on shards and a checkpoint, then a new ``Trainer`` that resumes
    from it for a third: the losses (the global mean on every rank) and
    rank 0's checkpoints after steps 2 and 3, whole arrays that the
    reference's ``CheckpointManager`` restores, against the unsharded port
    ``Trainer``'s three steps on the same data and seed (whose micro-batches
    are the global rows' slices, as the reference's); the port's
    ``CheckpointManager`` restores the same files byte for byte; each rank
    keeps only its blocks as ``params``."""
    _check_trainer("mixtral-8x22b", tmp_path, world_result((2, 2)))


def test_trainer_on_a_2x2_mesh_trains_mla_as_the_unsharded_trainer(tmp_path, world_result):
    """The same on reduced DeepSeek-V2-Lite: MLA, a dense lead layer and a
    MoE with a shared expert on shards."""
    _check_trainer("deepseek-v2-lite-16b", tmp_path, world_result((2, 2)))


def _check_trainer(arch: str, tmp_path, got: dict) -> None:
    model = build_model(get_reduced(arch).replace(dtype="float32"))
    plain = Trainer(model, _trainer_tc(), _trainer_data(model), str(tmp_path / "plain"), device="cpu")
    r = plain.run()
    whole_bytes = sum(x.numel() * x.element_size() for _, x in flatten_with_paths(plain.params))
    for rec in got["ranks"]:
        first, resumed = rec[("trainer", arch)]
        assert first["restored_from"] is None and resumed["restored_from"] == 2
        _close(first["losses"] + resumed["losses"], r.losses, "losses")
        assert first["param_bytes"] < whole_bytes and resumed["param_bytes"] < whole_bytes
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.utils.tree import flatten_with_paths as ref_flatten

    ckpt = os.path.join(got["dir"], "ckpt", arch)
    for step in (2, TRAINER_STEPS):
        mine = RefManager(ckpt).restore(step)
        want = RefManager(str(tmp_path / "plain")).restore(step)
        assert mine.step == want.step == step
        flat = dict(ref_flatten(mine.collections))
        assert set(flat) == {p for p, _ in ref_flatten(want.collections)}
        for path, a in ref_flatten(want.collections):
            assert np.shape(flat[path]) == np.shape(a), path
            _close(flat[path], a, f"step {step} {path}", STEP_TOL)
        ours = CheckpointManager(ckpt).restore(step)
        assert ours.step == mine.step
        ours_flat = dict(flatten_with_paths(ours.collections))
        assert set(ours_flat) == set(flat)
        for path, a in flat.items():
            b = ours_flat[path].numpy()
            assert b.dtype == np.asarray(a).dtype and b.tobytes() == np.asarray(a).tobytes(), path


@pytest.mark.parametrize("arch", ["yi-34b", "phi3-medium-14b"])
def test_chunked_vocab_parallel_loss_matches_the_reference(arch):
    """The cross-entropy per ``cfg.logits_chunk`` chunk (Yi's and Phi-3's
    train cells chunk by 512 at their 64,000+ vocab) with the vocab split
    over ``model``: at 2×2 on threads, loss and gathered gradients against
    the reference's ``value_and_grad`` of its chunked loss (chunk 8, two
    chunks a row)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as ref_get_reduced
    from repro.models.zoo import build_model as ref_build_model
    from repro.utils.tree import flatten_with_paths as ref_flatten

    ref_model = ref_build_model(ref_get_reduced(arch).replace(dtype="float32", logits_chunk=8))
    params = ref_model.init(jax.random.PRNGKey(0))
    batch = _batch()
    loss, grads = jax.jit(jax.value_and_grad(ref_model.loss_fn))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    weights = {p: np.asarray(v) for p, v in ref_flatten(params)}
    model = build_model(get_reduced(arch).replace(dtype="float32", logits_chunk=8))
    ranks = run_ranks({"data": 2, "model": 2}, lambda comm: _chunked_rank(model, weights, batch, comm))
    for rank, (got_loss, got_grads) in enumerate(ranks):
        _close(got_loss, float(loss), f"rank {rank} loss")
        for path, want in ref_flatten(grads):
            _close(got_grads[path], np.asarray(want), f"rank {rank} {path}")


def _chunked_rank(model, weights: dict, batch_np: dict, comm) -> tuple:
    mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
    specs = dict(flatten_with_paths(tree_map(lambda sh: sh.spec,
                                             param_shardings(model.logical_axes(), model.abstract(), mesh))))
    assert "model" in specs["head"][0]  # the vocab rows split over ``model``
    params = cut_tree(tree_from_flat({p: torch.from_numpy(np.array(v)) for p, v in weights.items()}),
                      tree_from_flat(specs), comm)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    rows = cut_batch(batch, 1, comm)
    loss, grads = sharded_grads(model, params, rows, 1, comm)
    return float(loss), {k: v.numpy() for k, v in _whole(grads, specs, comm).items()}



def test_collectives_carry_their_backward():
    """Each ``Comm`` collective's gradient, on 2 ``model`` ranks in threads,
    against its closed form: ``all_gather`` → the reduce-scatter of the
    gradient, ``reduce_scatter`` → its all-gather, ``enter`` → its
    all-reduce, ``all_reduce`` (sum) → the gradient as it is, the max → none."""
    def rank(comm):
        r = comm.index("model")
        x = torch.arange(4.0, requires_grad=True)
        w = torch.tensor([1.0, 2.0, 3.0, 4.0]) * (r + 1)  # the rank's weights on the gathered (4 · 2) values
        g_gather, = torch.autograd.grad((comm.all_gather(x, "model", 0) * torch.cat([w, w])).sum(), x)
        g_scatter, = torch.autograd.grad((comm.reduce_scatter(x, "model", 0) * w[:2]).sum(), x)
        g_enter, = torch.autograd.grad((comm.enter(x, "model") * w).sum(), x)
        g_reduce, = torch.autograd.grad((comm.all_reduce(x, "model") * w).sum(), x)
        top = comm.all_reduce(x * (r + 1), "model", "max")
        return r, g_gather, g_scatter, g_enter, g_reduce, top.requires_grad

    for r, g_gather, g_scatter, g_enter, g_reduce, top_grad in run_ranks({"model": 2}, rank):
        w = torch.tensor([1.0, 2.0, 3.0, 4.0])
        torch.testing.assert_close(g_gather, 3 * w, rtol=0, atol=0)  # Σ over ranks of each rank's (r + 1) · w
        torch.testing.assert_close(g_scatter, torch.cat([w[:2], 2 * w[:2]]), rtol=0, atol=0)
        torch.testing.assert_close(g_enter, 3 * w, rtol=0, atol=0)
        torch.testing.assert_close(g_reduce, (r + 1) * w, rtol=0, atol=0)
        assert not top_grad


@pytest.mark.parametrize("remat", ["none", "dots_saveable", "inner"])
def test_remat_policies_on_shards_keep_the_gradients(remat, reference):
    """``cfg.remat`` around each group on shards (non-reentrant checkpoints,
    whose recomputed forward issues its collectives again on every rank):
    at 2×2 on threads, reduced Mixtral's loss and gathered gradients under
    "none", "dots_saveable" and "inner" against the reference's (computed
    under its default "full"; remat changes no value)."""
    ref = reference["mixtral-8x22b"]
    model = build_model(get_reduced("mixtral-8x22b").replace(dtype="float32", remat=remat))
    for rank, got in enumerate(run_ranks({"data": 2, "model": 2},
                                         lambda comm: _rank_run(model, ref["params"], reference["batch"], comm))):
        _close(got["loss"], ref["loss"], f"rank {rank} loss")
        for path, want in ref["grads"].items():
            _close(got["grads"][path], want, f"rank {rank} {path}")


def test_cut_batch_gives_each_rank_its_block_of_every_micro_batch():
    """``cut_batch`` at 2×2 (the batch split over ``data``) and 2 micro-batches
    of 8 rows: slice i of data rank d's rows is rows [4i + 2d, 4i + 2d + 2)
    of the global batch, the ``model`` ranks of a row block alike; a batch
    whose micro-batches do not split over the data ranks raises, and so
    does ``sharded_grads`` on rows that do not split into its micro-batches."""
    rows = torch.arange(8)[:, None].expand(8, 3).contiguous()

    def rank(comm):
        got = cut_batch({"tokens": rows, "labels": rows}, 2, comm)
        with pytest.raises(ValueError):
            cut_batch({"tokens": rows[:6], "labels": rows[:6]}, 2, comm)
        with pytest.raises(ValueError):
            sharded_grads(None, {}, cut_batch({"tokens": rows, "labels": rows}, 1, comm), 3, comm)
        return comm.index("data"), got["tokens"].local[:, 0].tolist(), got["tokens"].shape

    for d, mine, shape in run_ranks({"data": 2, "model": 2}, rank):
        assert mine == [2 * d, 2 * d + 1, 4 + 2 * d, 5 + 2 * d] and shape == (8, 3)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "yi-34b", "recurrentgemma-9b", "gemma3-27b",
                                  "deepseek-v2-lite-16b", *MODAL])
def test_block_init_draws_the_whole_init_numbers(arch):
    """``Model.init(blocks=)`` (the ``Trainer``'s init on shards) at 2×2 on
    threads: each rank's blocks are bit-equal to its blocks of the whole
    init from the same seed, stacked leaves, zeros / ones and RecurrentGemma's
    ``lru_a`` included, and hold no more than the closed form's bytes."""
    from repro_torch.sharding.rules import block_index, block_of

    model = build_model(get_reduced(arch).replace(dtype="float32"))
    whole = dict(flatten_with_paths(model.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)))

    def rank(comm):
        mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
        specs = {p: sh.spec for p, sh in flatten_with_paths(param_shardings(model.logical_axes(), model.abstract(),
                                                                            mesh))}
        blocks = {p: block_index(x.shape, specs[p], comm) for p, x in flatten_with_paths(model.abstract())}
        got = dict(flatten_with_paths(model.init(torch.Generator().manual_seed(0), device="cpu",
                                                 dtype=torch.float32, blocks=blocks)))
        differ = [p for p in whole if not torch.equal(got[p], block_of(whole[p], specs[p], comm))]
        held = sum(x.numel() * 4 for x in got.values())
        closed = sum(x.numel() * 4 // spec_shard_divisor(specs[p], mesh) for p, x in whole.items())
        return differ, held, closed

    for differ, held, closed in run_ranks({"data": 2, "model": 2}, rank):
        assert not differ
        assert held == closed


def test_train_on_shards_covers_the_gqa_mla_and_rglru_stacks():
    """Every arch trains on shards on a ("data", "model") mesh, 1×1
    included (``train_loop.on_shards``: no per-family rule is left, and
    ``loss_fn_sharded`` refuses none: on 1×2 threads, with a multimodal
    batch where the arch takes one, each arch's loss is finite and the same
    on both ``model`` ranks), while a mesh with a ``pod`` dim keeps the
    whole tree on every rank (``data_parallel``)."""
    from repro_torch.training.train_loop import on_shards

    for names, sizes, sharded in ((("data", "model"), (1, 1), True), (("data", "model"), (2, 2), True),
                                  (("pod", "data", "model"), (2, 2, 2), False)):
        assert on_shards(MeshShape(names, sizes)) is sharded, names
    for arch in ARCH_IDS:
        model = build_model(get_reduced(arch).replace(dtype="float32"))
        params = model.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
        batch = _modal_batch(model.cfg, 2, 8, np.random.default_rng(5), torch.float32)

        def rank(comm):
            mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
            specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(), mesh))
            with torch.no_grad():
                return float(model.loss_fn_sharded(cut_tree(params, specs, comm), cut_batch(batch, 1, comm), comm))

        losses = run_ranks({"data": 1, "model": 2}, rank)
        assert np.isfinite(losses[0]) and losses[0] == losses[1], arch


def _modal_batch(cfg, rows: int, seq: int, rs, dtype) -> dict:
    """A seeded batch of ``rows`` × ``seq`` tokens and labels, plus the
    config's modal input: Whisper's ``frames`` (rows, seq, d_model), the
    VLM's ``image_embeds`` (rows, image tokens, vision_dim), in ``dtype``."""
    batch = {k: torch.from_numpy(rs.integers(0, 512, (rows, seq))).long() for k in ("tokens", "labels")}
    if cfg.encdec is not None:
        batch["frames"] = torch.from_numpy(rs.standard_normal((rows, seq, cfg.d_model), dtype=np.float32)).to(dtype)
    if cfg.vlm is not None:
        shape = (rows, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim)
        batch["image_embeds"] = torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)).to(dtype)
    return batch


@pytest.mark.parametrize("chunk", [0, 32], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES + ("yi-34b",) + MODAL)
def test_one_rank_step_is_the_unsharded_step_bit_for_bit(arch, chunk):
    """On a mesh of 1s in bf16 (the compute dtype of the card's train
    anchors), at one and two micro-batches, with the logits whole and per
    chunk of 32 (two a row, as the dry run's train cells chunk a large
    vocab): the loss and every gradient leaf of ``sharded_grads`` equal
    ``accumulated_grads`` of the unsharded loss bit for bit, Whisper's and
    the VLM's on a multimodal batch (bf16 ``frames`` / ``image_embeds``, the
    VLM's gates nonzero). Each fp32
    master block is cast once to the dtype the loss reads the leaf in
    (``master_compute_dtype``: the embedding table, the router, the
    RG-LRU's gate biases and decay, the mLSTM's gate bias, the xLSTM's
    group-norm scales and the sLSTM's recurrent weights stay fp32, and so
    does a head read once a chunk, whose chunks' gradients add in fp32)."""
    from repro_torch.training.train_loop import accumulated_grads

    model = build_model(get_reduced(arch).replace(logits_chunk=chunk))
    assert model.cfg.dtype == "bfloat16"
    params = model.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    params = tree_from_flat({p: x.fill_(0.8) if p.endswith(("cross.gate", "gate_ffn")) else x
                             for p, x in flatten_with_paths(params)})
    batch = _modal_batch(model.cfg, 2, 64, np.random.default_rng(1), torch.bfloat16)

    def rank(comm, n):
        mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
        specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(), mesh))
        return sharded_grads(model, cut_tree(tree_map(lambda x: x.clone(), params), specs, comm),
                             cut_batch(batch, n, comm), n, comm)

    for n in (1, 2):
        want_loss, want = accumulated_grads(model.loss_fn, params, batch, n)
        (loss, grads), = run_ranks({"data": 1, "model": 1}, lambda comm: rank(comm, n))
        assert torch.equal(loss, want_loss), n
        differ = [p for p, g in flatten_with_paths(want) if not torch.equal(grads[p], g)]
        assert not differ, (n, differ)
