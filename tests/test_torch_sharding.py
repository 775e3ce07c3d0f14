"""The port's sharding rules and meshes (``repro_torch.sharding``,
``launch.mesh``) and elastic restart (``reshard_for_mesh``) against the
reference, on the CPU:

  * ``param_shardings`` / ``resolve_pspec`` / ``spec_shard_divisor``: the
    spec and the divisor of every param leaf of every reduced arch equal the
    reference's, at 1×1, 2×4, 1×4 (the kv_heads = 2 fallback), 16×16 and
    2×16×16, with FSDP on and off; ``ACT_RULES`` on batch, seq and KV
    shapes too. The reference resolves leaf by leaf on a shape-only mesh,
    as tests/test_substrates.py does; the port on a ``MeshShape``;
  * the DTensor form of a spec, the thread-local ambient mesh and rules,
    and ``constrain`` (the identity without a mesh and on a plain tensor);
  * ``make_debug_mesh`` refuses an oversized or zero geometry in both
    packages, and ``make_production_mesh`` a world without its ranks;
  * ``reshard_for_mesh`` of a checkpoint the reference wrote, onto 1×1 in
    this process and onto 2×2 over four gloo ranks: every leaf gathered is
    bit-equal to the checkpoint's and to the reference's 1×1 reshard, each
    rank holds its block, the moments follow their params and the (1,)
    step counters replicate; there, ``constrain`` redistributes a DTensor
    to the activation rules;
  * the launcher under ``torchrun --nproc-per-node 4 ... --mesh 2x2``
    serves the tokens and faulted units of the run with no mesh under a
    smaller budget (each unit charges its share), and only rank 0 prints.
"""

import functools
import json
import os
import re
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_reduced as ref_get_reduced
from repro.launch.mesh import make_debug_mesh as ref_make_debug_mesh
from repro.models.zoo import build_model as ref_build_model
from repro.optim import init_adamw as ref_init_adamw
from repro.sharding.rules import ACT_RULES as REF_ACT_RULES
from repro.sharding.rules import PARAM_RULES as REF_PARAM_RULES
from repro.sharding.rules import resolve_pspec as ref_resolve_pspec
from repro.sharding.rules import spec_shard_divisor as ref_divisor
from repro.training import reshard_for_mesh as ref_reshard
from repro.utils.tree import flatten_axes_tree as ref_flatten_axes
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, mesh_label, production_mesh_shape
from repro_torch.models import build_model
from repro_torch.sharding import (
    ACT_RULES,
    PARAM_RULES,
    constrain,
    current_mesh,
    param_shardings,
    resolve_pspec,
    set_rules,
    spec_shard_divisor,
    use_mesh,
)
from repro_torch.sharding.rules import MeshShape, NamedSharding, PartitionSpec, gather, place
from repro_torch.training import reshard_for_mesh
from repro_torch.utils.tree import flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "1x4": (("data", "model"), (1, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


def _ref_mesh(names, shape):
    return SimpleNamespace(axis_names=names, devices=np.zeros(shape))


@functools.lru_cache(maxsize=None)
def _models(arch):
    return ref_build_model(ref_get_reduced(arch)), build_model(get_reduced(arch))


def test_rules_and_exports_match_the_reference():
    import repro.sharding as ref_sharding
    import repro_torch.sharding as sharding

    assert PARAM_RULES == REF_PARAM_RULES and ACT_RULES == REF_ACT_RULES
    assert sorted(sharding.__all__) == sorted(ref_sharding.__all__)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_divisors_match_the_reference(arch, geometry, fsdp):
    ref_model, model = _models(arch)
    names, shape = GEOMETRIES[geometry]
    ref_mesh, mesh = _ref_mesh(names, shape), MeshShape(names, shape)
    rules = dict(REF_PARAM_RULES, **({} if fsdp else {"embed": ()}))
    axes = dict(ref_flatten_axes(ref_model.logical_axes()))
    want = {p: ref_resolve_pspec(axes[p], leaf.shape, ref_mesh, rules) for p, leaf in ref_flatten(ref_model.abstract())}
    got = dict(flatten_with_paths(param_shardings(model.logical_axes(), model.abstract(), mesh, fsdp=fsdp)))
    assert list(got) == list(want)
    for p, sh in got.items():
        assert sh.mesh is mesh and tuple(sh.spec) == tuple(want[p]), p
        assert spec_shard_divisor(sh.spec, mesh) == ref_divisor(want[p], ref_mesh), p
    if geometry != "1x1":
        assert any(spec_shard_divisor(sh.spec, mesh) > 1 for sh in got.values())


ACT_CASES = [
    (("batch", "seq", "embed"), (8, 32, 64)),
    (("batch", "seq", "embed"), (3, 32, 64)),
    (("batch", "seq", "vocab"), (32, 16, 512)),
    (("batch", "seq_shard", "embed"), (4, 4096, 64)),
    (("batch", "kv_seq", "kv_heads", "head"), (2, 1024, 8, 128)),
    (("batch", "seq", "heads", "head"), (512, 8, 48, 128)),
    (("experts", "moe_cap", "embed"), (8, 64, 16)),
]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_activation_specs_match_the_reference(geometry):
    names, shape = GEOMETRIES[geometry]
    for axes, dims in ACT_CASES:
        want = ref_resolve_pspec(axes, dims, _ref_mesh(names, shape), REF_ACT_RULES)
        assert tuple(resolve_pspec(axes, dims, MeshShape(names, shape), ACT_RULES)) == tuple(want), (axes, dims)


def test_spec_divisor_and_placements():
    """Divisor = product of the named dims' sizes (unknown dims and None add
    nothing); the DTensor form shards the tensor dim each mesh dim names."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("data", "model"), (2, 4))
    assert spec_shard_divisor(PartitionSpec(), mesh) == 1
    assert spec_shard_divisor(PartitionSpec(None, "model"), mesh) == 4
    assert spec_shard_divisor(PartitionSpec("data", "model"), mesh) == 8
    assert spec_shard_divisor(PartitionSpec(("data", "model"),), mesh) == 8
    assert spec_shard_divisor(PartitionSpec("nonexistent"), mesh) == 1
    assert NamedSharding(mesh, PartitionSpec(None, "model", "data")).placements() == (Shard(2), Shard(1))
    assert NamedSharding(mesh, PartitionSpec(("data", "model"))).placements() == (Shard(0), Shard(0))
    assert NamedSharding(mesh, PartitionSpec()).placements() == (Replicate(), Replicate())
    assert mesh_label(production_mesh_shape(multi_pod=True)) == "2x16x16"
    assert production_mesh_shape() == MeshShape(("data", "model"), (16, 16))


def test_ambient_mesh_and_rules_are_thread_local():
    mesh = MeshShape(("data", "model"), (2, 2))
    seen = {}
    x = torch.ones(4, 4)
    with use_mesh(mesh, act_rules={"batch": ()}):
        assert current_mesh() is mesh
        assert constrain(x, ("batch", "embed")) is x  # a plain tensor has no layout to set
        thread = threading.Thread(target=lambda: seen.update(mesh=current_mesh()))
        thread.start()
        thread.join()
    assert seen["mesh"] is None and current_mesh() is None
    assert constrain(x, ("batch", "embed")) is x
    set_rules(param_rules=dict(PARAM_RULES, embed=()))  # replaces the whole table
    try:
        spec = dict(flatten_with_paths(param_shardings({"w": ("embed", "ffn")}, {"w": torch.empty(4, 8)}, mesh)))
        assert tuple(spec["w"].spec) == (None, "model")
    finally:
        set_rules(param_rules=PARAM_RULES)


def test_meshes_refuse_geometries_the_world_does_not_hold():
    have = jax.device_count()
    for data, model in ((have + 1, 1), (2 * have, 2)):
        with pytest.raises(ValueError, match=rf"needs {data * model} devices but only {have}"):
            ref_make_debug_mesh(data, model)
        with pytest.raises(ValueError, match=rf"needs {data * model} ranks but only 1 exist; .*"
                                             rf"torchrun --nproc-per-node {data * model}"):
            make_debug_mesh(data, model, device="cpu")
    for pkg in (ref_make_debug_mesh, functools.partial(make_debug_mesh, device="cpu")):
        with pytest.raises(ValueError, match="must be >= 1"):
            pkg(0, 1)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    assert not dist.is_initialized()  # a refused geometry starts nothing


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Reduced Yi's params and AdamW moments, saved by the reference's
    manager (its step counter stored as shape (1,)), and the reference's own
    1×1 reshard of them."""
    ref_model = ref_build_model(ref_get_reduced("yi-34b"))
    params = ref_model.init(jax.random.PRNGKey(0))
    opt = ref_init_adamw(params)
    path = str(tmp_path_factory.mktemp("ckpt"))
    RefManager(path).save(5, {"params": params, "opt_state": {"step": opt.step, "m": opt.m, "v": opt.v}},
                          blocking=True)
    placed = ref_reshard(RefManager(path).restore().collections, ref_make_debug_mesh(1, 1), ref_model)
    return path, {p: np.asarray(v) for p, v in ref_flatten(placed)}


def _gathered(placed) -> dict:
    return {p: gather(v) for p, v in flatten_with_paths(placed)}


def _check_reshard(placed, host, model, mesh) -> None:
    """Each rank's block is its slice of the host leaf, with the param's
    placements for params and moments and all-replicated otherwise."""
    from torch.distributed.tensor import Replicate

    specs = dict(flatten_with_paths(param_shardings(model.logical_axes(), model.abstract(), mesh)))
    for path, leaf in flatten_with_paths(placed):
        cname, rest = path.split(".", 1)
        key = rest.split(".", 1)[1] if rest.startswith(("m.", "v.")) else rest
        want = specs[key].placements() if cname in ("params", "opt_state") and key in specs else None
        assert leaf.placements == (want or (Replicate(),) * mesh.ndim), path
        assert torch.equal(gather(leaf), host[path]), path


def test_reshard_onto_one_rank_matches_the_checkpoint_and_the_reference(checkpoint):
    path, ref_placed = checkpoint
    model = build_model(get_reduced("yi-34b"))
    restored = CheckpointManager(path).restore()
    host = dict(flatten_with_paths(restored.collections))
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        placed = reshard_for_mesh(restored.collections, mesh, model)
        _check_reshard(placed, host, model, mesh)
        got = _gathered(placed)
        assert list(got) == list(ref_placed) and tuple(got["opt_state.step"].shape) == (1,)
        for p, want in ref_placed.items():
            np.testing.assert_array_equal(got[p].numpy(), want, err_msg=p)
    finally:
        dist.destroy_process_group()


def _reshard_rank(rank: int, init: str, ckpt: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    try:
        model = build_model(get_reduced("yi-34b"))
        restored = CheckpointManager(ckpt).restore()
        mesh = make_debug_mesh(2, 2, device="cpu")
        placed = reshard_for_mesh(restored.collections, mesh, model)
        _check_reshard(placed, dict(flatten_with_paths(restored.collections)), model, mesh)
        sharded = sum(1 for _, v in flatten_with_paths(placed) if v.to_local().shape != v.shape)
        # constrain redistributes a DTensor to the activation rules: batch -> data
        from torch.distributed.tensor import Replicate, Shard

        x = torch.arange(64.0).reshape(4, 16)
        with use_mesh(mesh):
            y = constrain(place(x, mesh, NamedSharding(mesh, PartitionSpec()), "cpu"), ("batch", "embed"))
        assert y.placements == (Shard(0), Replicate()) and torch.equal(gather(y), x)
        gathered = _gathered(placed)
        if rank == 0:
            np.savez(out, **{p: v.numpy() for p, v in gathered.items()})
            with open(out + ".json", "w") as f:
                json.dump({"sharded": sharded}, f)
    finally:
        dist.destroy_process_group()


def test_reshard_onto_two_by_two_over_four_ranks(checkpoint, tmp_path):
    path, ref_placed = checkpoint
    out = str(tmp_path / "gathered.npz")
    mp.spawn(_reshard_rank, args=(f"file://{tmp_path / 'rendezvous'}", path, out), nprocs=4)
    got = np.load(out)
    assert sorted(got.files) == sorted(ref_placed)
    for p, want in ref_placed.items():
        np.testing.assert_array_equal(got[p], want, err_msg=p)
    assert json.load(open(out + ".json"))["sharded"] > 0


def _launcher_lines(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[serve] ")]
    pick = lambda prefix: next(ln[len(prefix):] for ln in lines if ln.startswith(prefix))  # noqa: E731
    return dict(lines=lines, tokens=json.loads(pick("[serve] tokens: ")),
                faults=json.loads(pick("[serve] faulted units: ")), request=json.loads(pick("[serve] request: ")))


def test_launcher_serves_a_two_by_two_mesh_under_torchrun(tmp_path):
    args = ["-m", "repro_torch.launch.serve", "--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--gen-steps", "4", "--policy", "strict"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    plain = subprocess.run([sys.executable, *args, "--artifact-dir", str(tmp_path / "plain")], env=env,
                           capture_output=True, text=True, timeout=300)
    assert plain.returncode == 0, plain.stderr
    meshed = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                             *args, "--mesh", "2x2", "--artifact-dir", str(tmp_path / "mesh")], env=env,
                            capture_output=True, text=True, timeout=300)
    assert meshed.returncode == 0, meshed.stderr[-3000:]
    got, want = _launcher_lines(meshed.stdout), _launcher_lines(plain.stdout)
    assert got["tokens"] == want["tokens"] and got["faults"] == want["faults"]
    # the budget holds more units when each charges its share: no more refaults
    assert got["request"]["faulted_bytes"] <= want["request"]["faulted_bytes"]
    mesh = json.loads(next(ln for ln in got["lines"] if ln.startswith("[serve] mesh: "))[len("[serve] mesh: "):])
    assert mesh["geometry"] == "2x2" and mesh["ranks"] == 4 and mesh["entries"] == "eager"
    assert "1" not in mesh["divisors"]  # every leaf is split on this geometry
    assert len([ln for ln in got["lines"] if ln.startswith("[serve] tokens: ")]) == 1  # rank 0 alone prints
    resident = re.search(r"resident ([\d,]+)B / budget ([\d,]+)B", meshed.stdout)
    plain_resident = re.search(r"resident ([\d,]+)B / budget ([\d,]+)B", plain.stdout)
    assert int(resident.group(2).replace(",", "")) < int(plain_resident.group(2).replace(",", ""))
