"""The train step on shards for Whisper's encoder-decoder, Llama-3.2-Vision's
gated cross blocks and xLSTM's mLSTM / sLSTM stack (``Model.loss_fn_sharded``,
``training.train_loop.sharded_grads`` / ``make_train_step(comm=)``,
``Trainer(mesh=)``) against the reference's unsharded ``make_train_step``,
on the CPU.

The reduced configs in fp32 carry the reference's weights
(``jax.random.PRNGKey(0)``, as numpy), the VLM's ``gate`` and ``gate_ffn``
set nonzero in the numpy leaves both packages receive (zero gates would
leave its cross block out of the loss). Each arch trains on a seeded B=4 ×
16 batch, text-only and, for Whisper and the VLM, multimodal (``frames`` /
``image_embeds`` from numpy). One gloo spawn per world, 1×2 and 2×2
(``torch.multiprocessing``, a ``file://`` rendezvous), runs every arch and
batch of the world, and on 2×2 ``Trainer(mesh=)`` on reduced xLSTM too;
each rank saves what the tests read. Held to the reference, at the
tolerances of ``tests/test_torch_shard_train.py`` (``GRAD_TOL`` 1e-5 for
the loss, the grad norm and the gradients, ``STEP_TOL`` 1e-4 for the params
after two AdamW steps, here at AdamW's ``eps`` = ``STEP_EPS``):

  * the loss, the grad norm and every leaf's gradient (each rank's blocks
    gathered to the whole leaf) of ``sharded_grads`` against
    ``jax.value_and_grad`` of the reference's loss;
  * two AdamW steps of ``make_train_step(comm=)`` at 2 micro-batches
    against two of the reference's jitted ``make_train_step`` on the same
    batch (the ranks' rows, ``frames`` and ``image_embeds`` cut by
    ``cut_batch``);
  * each rank's gradient bytes equal the closed form of its shardings.

``STEP_EPS`` = 1e-6 where the other file's steps take AdamW's default 1e-8.
A first AdamW step moves each component by about lr · g / (|g| + eps), so a
component whose gradient is near eps passes the rounding of its gradient
into the update whole. On the VLM's multimodal batch one component of layer
0's ``wo`` has a gradient of 9.1e-9: at eps 1e-8 the unsharded port's two
steps (no mesh, no collective) land 1.36e-4 from the reference's there,
every other element within 1e-4, so the fp32 summation orders of the two
frameworks, not the sharding, decide that element. At 1e-6 a gradient
error of 1e-9 moves an update by at most lr · 1e-3.

Besides: ``ThreadComm`` (``run_ranks``, one thread a rank) where ``model``
does not divide the heads, so every rank runs every head: reduced xLSTM (2
heads) at 1×4 and reduced Whisper (4 heads) at 1×8, multimodal, against the
same reference; and ``Trainer(mesh=2×2)`` on reduced xLSTM, two steps and
then one more resumed from its checkpoint, against the unsharded port
``Trainer`` (``tests/test_torch_shard_train.py``'s ``_check_trainer``).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.sharding.comm import DistComm, run_ranks
from repro_torch.training import Trainer
from repro_torch.utils.tree import flatten_with_paths
from test_torch_shard_train import (
    B,
    S,
    STEP_TOL,
    TRAINER_STEPS,
    _check_trainer,
    _close,
    _rank_run,
    _reference,
    _trainer_data,
    _trainer_tc,
)

# The spawned ranks import this module; JAX and the reference package are
# imported inside the functions that run in the test process only.

ARCHS = ("whisper-base", "llama-3.2-vision-90b", "xlstm-125m")
WORLDS = ((1, 2), (2, 2))
GATE, GATE_FFN = 0.8, -0.6  # tanh ≈ 0.66 and -0.54: the VLM's cross block counts
TRAINER_ARCH = "xlstm-125m"  # Trainer(mesh=) on the 2×2 world
# in-process worlds where ``model`` does not divide the heads (every rank runs every head)
THREAD_WORLDS = {"xlstm-125m": 4, "whisper-base": 8}
STEP_EPS = 1e-6  # AdamW's eps in the two-step runs (module docstring)


def _kinds(arch: str) -> tuple:
    cfg = get_reduced(arch)
    return ("multimodal", "text") if cfg.encdec is not None or cfg.vlm is not None else ("text",)


def _batches(cfg) -> dict:
    """The seeded B × S batch, text-only and with the config's modal input:
    Whisper's ``frames`` (B, S, d_model), the VLM's ``image_embeds`` (B, T,
    vision_dim)."""
    rs = np.random.default_rng(11)
    text = {k: rs.integers(0, 512, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    modal = dict(text)
    if cfg.encdec is not None:
        modal["frames"] = rs.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    if cfg.vlm is not None:
        modal["image_embeds"] = rs.standard_normal((B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim), dtype=np.float32)
    return {"multimodal": modal, "text": text}


def _with_gates(flat: dict) -> dict:
    return {p: np.full_like(v, GATE) if p.endswith(".cross.gate") else
            np.full_like(v, GATE_FFN) if p.endswith(".gate_ffn") else v for p, v in flat.items()}


def _port_model(arch: str):
    return build_model(get_reduced(arch).replace(dtype="float32"))


def _train_rank(rank: int, world: tuple, init: str, ref_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)  # six ranks share the host, at these widths threads only contend
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world[0] * world[1])
    try:
        mesh = make_debug_mesh(*world, device="cpu")
        comm = DistComm(mesh)
        ref = torch.load(ref_path, weights_only=False)
        rec = {(arch, kind): _rank_run(_port_model(arch), ref[arch], ref["batches"][arch][kind], comm, STEP_EPS)
               for arch in ARCHS for kind in _kinds(arch)}
        if world == (2, 2):  # two steps, then a new Trainer resumes from the checkpoint for the third
            model, runs = _port_model(TRAINER_ARCH), []
            for num_steps in (2, TRAINER_STEPS):
                trainer = Trainer(model, _trainer_tc(), _trainer_data(model),
                                  os.path.join(out_dir, "ckpt", TRAINER_ARCH), mesh=mesh, device="cpu")
                r = trainer.run(num_steps)
                runs.append(dict(losses=r.losses, restored_from=r.restored_from,
                                 param_bytes=sum(x.numel() * x.element_size()
                                                 for _, x in flatten_with_paths(trainer.params))))
            rec[("trainer", TRAINER_ARCH)] = runs
        torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, worlds): both worlds' spawns started together on the
    reference's weights (gated), the reference computed in this process
    meanwhile, per arch and batch (``test_torch_shard_train._reference``);
    each world's ranks' records in rank order and its directory."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as ref_get_reduced
    from repro.models.zoo import build_model as ref_build_model
    from repro.utils.tree import flatten_with_paths as ref_flatten
    from repro.utils.tree import tree_from_flat as ref_tree_from_flat

    tmp = tmp_path_factory.mktemp("shard_train_modal")
    models, weights, batches = {}, {}, {}
    for arch in ARCHS:
        ref_model = ref_build_model(ref_get_reduced(arch).replace(dtype="float32"))
        weights[arch] = _with_gates({p: np.asarray(v) for p, v in ref_flatten(ref_model.init(jax.random.PRNGKey(0)))})
        models[arch] = ref_model, ref_tree_from_flat({p: jnp.asarray(v) for p, v in weights[arch].items()})
        batches[arch] = _batches(ref_model.cfg)
    torch.save({**weights, "batches": batches}, tmp / "ref.pt")
    spawns = {}
    for world in WORLDS:
        where = tmp / "x".join(map(str, world))
        where.mkdir()
        spawns[world] = (where, mp.start_processes(_train_rank, args=(world, f"file://{where / 'rendezvous'}",
                                                                      str(tmp / "ref.pt"), str(where)),
                                                   nprocs=world[0] * world[1], join=False, start_method="spawn"))
    try:
        reference = {(arch, kind): _reference({arch: models[arch]}, batches[arch][kind], STEP_EPS)[arch]
                     for arch in ARCHS for kind in _kinds(arch)}
    finally:
        for _, ctx in spawns.values():
            while not ctx.join():
                pass
    reference.update(weights=weights, batches=batches)
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


CASES = [(w, a, k) for w in WORLDS for a in ARCHS for k in _kinds(a)]


def _ids(world, arch, kind):
    return f"{'x'.join(map(str, world))}-{arch}-{kind}"


def _check_gradients(got: dict, ref: dict, what: str) -> None:
    _close(got["loss"], ref["loss"], f"{what} loss")
    _close(got["grad_norm"], ref["grad_norm"], f"{what} grad norm")
    assert set(got["grads"]) == set(ref["grads"])
    for path, want in ref["grads"].items():
        _close(got["grads"][path], want, f"{what} {path}")


def _check_steps(got: dict, ref: dict, what: str) -> None:
    _close(got["metrics"], ref["metrics"], f"{what} metrics")
    for path, want in ref["params"].items():
        _close(got["params"][path], want, f"{what} {path}", STEP_TOL)


@pytest.mark.parametrize("world,arch,kind", CASES, ids=[_ids(*c) for c in CASES])
def test_sharded_gradients_match_the_reference(world, arch, kind, reference, world_result):
    """Loss, grad norm and every leaf's gathered gradient against the
    reference's ``value_and_grad``, on every rank: the encoder's and the
    cross blocks' leaves get their gradients from a multimodal batch and
    zeros from a text-only one, as the reference's."""
    for rank, rec in enumerate(world_result(world)["ranks"]):
        _check_gradients(rec[(arch, kind)], reference[(arch, kind)], f"rank {rank}")


@pytest.mark.parametrize("world,arch,kind", CASES, ids=[_ids(*c) for c in CASES])
def test_two_sharded_steps_match_the_reference(world, arch, kind, reference, world_result):
    """Two AdamW steps at 2 micro-batches: each step's loss and grad norm
    and the params after both against the reference's ``make_train_step``
    on the same batch (each rank's rows cut by ``cut_batch``, ``frames`` and
    ``image_embeds`` with them)."""
    for rank, rec in enumerate(world_result(world)["ranks"]):
        _check_steps(rec[(arch, kind)]["steps"], reference[(arch, kind)]["steps"], f"rank {rank}")


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: "x".join(map(str, w)))
def test_each_rank_holds_only_its_gradient_blocks(world, world_result):
    """Each rank's fp32 gradient bytes are the closed form of its
    shardings (Σ leaf bytes / the leaf's shard divisor on the mesh), fewer
    than the whole tree's."""
    for rec in world_result(world)["ranks"]:
        for arch in ARCHS:
            for kind in _kinds(arch):
                got = rec[(arch, kind)]
                assert got["grad_bytes"] == got["closed_bytes"], (arch, kind)
                assert got["grad_bytes"] < sum(4 * g.size for g in got["grads"].values()), (arch, kind)


@pytest.mark.parametrize("arch", list(THREAD_WORLDS))
def test_thread_ranks_where_model_does_not_divide_the_heads(arch, reference):
    """``run_ranks`` at 1×4 (xLSTM, 2 heads) and 1×8 (Whisper, 4 heads, on
    the multimodal batch): every rank runs every head, so the sLSTM's
    pre-activation and the mLSTM's projections are whole on every rank and
    the recurrence's leaves are read whole; the loss, the norm, every
    gathered gradient and the params after two steps against the
    reference's, each rank's gradient bytes the closed form."""
    kind = _kinds(arch)[0]
    ref = reference[(arch, kind)]
    model = _port_model(arch)
    assert model.cfg.num_heads % THREAD_WORLDS[arch]
    ranks = run_ranks({"data": 1, "model": THREAD_WORLDS[arch]},
                      lambda comm: _rank_run(model, reference["weights"][arch], reference["batches"][arch][kind], comm,
                                             STEP_EPS))
    for rank, got in enumerate(ranks):
        _check_gradients(got, ref, f"rank {rank}")
        _check_steps(got["steps"], ref["steps"], f"rank {rank}")
        assert got["grad_bytes"] == got["closed_bytes"]


def test_trainer_on_a_2x2_mesh_trains_xlstm_as_the_unsharded_trainer(tmp_path, world_result):
    """``Trainer(mesh=2×2)`` on reduced xLSTM (its 2 heads split over
    ``model``) at 2 micro-batches, two steps on shards and a checkpoint, then
    a new ``Trainer`` that resumes from it for a third: the losses and rank
    0's checkpoints against the unsharded port ``Trainer``'s three steps,
    restored by the reference's ``CheckpointManager`` and byte for byte by
    the port's; each rank keeps only its blocks."""
    _check_trainer(TRAINER_ARCH, tmp_path, world_result((2, 2)))
