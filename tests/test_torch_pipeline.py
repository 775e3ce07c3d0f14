"""Training over a mesh in the port against the JAX reference, on the CPU:

  * ``gpipe_forward`` over four gloo ranks (``torch.multiprocessing``
    spawn, ``file://`` rendezvous) on the reference's weights against the
    reference's ``gpipe_forward`` on four forced CPU devices (a subprocess,
    as tests/test_training_ft.py runs it): the forward within 1e-5, the
    gradients of sum(out²) from ``torch.autograd`` within 1e-4; over one
    stage it is ``stage_fn`` itself;
  * ``compressed_psum`` over a 4-rank ``pod`` dim against the reference's
    under ``shard_map`` on the same forced devices: each rank's int8
    payload and residual exact, the mean within 1e-6, with and without
    ``denom``;
  * ``Trainer(mesh=)``: on a 1×1 mesh bit-equal to no mesh; on a 2×1 mesh
    (two ranks, the batch split over ``data``) it resumes the reference's
    checkpoint, and its losses and final params are within 1e-5 of the
    reference's unsharded Trainer resuming a copy.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_reduced as ref_get_reduced
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.models.zoo import build_model as ref_build_model
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.training import TrainConfig as RefTrainConfig
from repro.training import Trainer as RefTrainer
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, EFState, compressed_psum, quantize_int8
from repro_torch.sharding import use_mesh
from repro_torch.training import TrainConfig, Trainer, gpipe_forward
from repro_torch.utils.tree import flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = 4
DENOMS = (None, 2)
# resumed steps on a split batch: the two halves' mean loss and gradient
# sum in another order than the whole batch's (fp32 reduction ulps), which
# AdamW passes on at about the same size; the same margin as the port's
# resume tolerance against the reference (tests/test_torch_training.py)
RESUME_TOL = 1e-5

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.compression import EFState, compressed_psum, quantize_int8
from repro.training.pipeline import gpipe_forward

out = sys.argv[1]
assert jax.device_count() == 4
mesh = Mesh(np.array(jax.devices()).reshape(4), ("stage",))
key = jax.random.PRNGKey(0)
W = jax.random.normal(key, (4, 8, 8)) * 0.3
b = jax.random.normal(jax.random.fold_in(key, 1), (4, 8)) * 0.1
x = jax.random.normal(jax.random.fold_in(key, 2), (6, 2, 8))
stage_fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
y = gpipe_forward(stage_fn, {"w": W, "b": b}, x, mesh)
g = jax.grad(lambda p: jnp.sum(gpipe_forward(stage_fn, p, x, mesh) ** 2))({"w": W, "b": b})
np.savez(out + "/gpipe.npz", W=W, b=b, x=x, y=y, gW=g["w"], gb=g["b"])

pod = Mesh(np.array(jax.devices()).reshape(4), ("pod",))
rs = np.random.default_rng(3)
G = {"w": rs.standard_normal((4, 7, 9)).astype(np.float32), "b": rs.standard_normal((4, 5)).astype(np.float32)}
R = {k: (0.01 * rs.standard_normal(v.shape)).astype(np.float32) for k, v in G.items()}
res = dict(**{"G_" + k: v for k, v in G.items()}, **{"R_" + k: v for k, v in R.items()})
for denom in (None, 2):
    def body(g, r):
        g, r = {k: v[0] for k, v in g.items()}, {k: v[0] for k, v in r.items()}
        q = {k: quantize_int8(g[k] + r[k])[0][None] for k in g}
        avg, ef = compressed_psum(g, EFState(r), "pod", denom=denom)
        return avg, {k: v[None] for k, v in ef.residual.items()}, q
    fn = shard_map(body, mesh=pod, in_specs=(P("pod"), P("pod")), out_specs=(P(), P("pod"), P("pod")),
                   check_rep=False)
    avg, resid, q = fn({k: jnp.asarray(v) for k, v in G.items()}, {k: jnp.asarray(v) for k, v in R.items()})
    for k in G:
        res[f"avg_{denom}_{k}"], res[f"res_{denom}_{k}"], res[f"q_{denom}_{k}"] = avg[k], resid[k], q[k]
np.savez(out + "/psum.npz", **res)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's GPipe forward and gradients and its compressed psum,
    from one subprocess with four forced CPU devices."""
    out = tmp_path_factory.mktemp("ref")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out), os.path.join(REPO, "src")],
                       capture_output=True, text=True, timeout=300)
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    return np.load(out / "gpipe.npz"), np.load(out / "psum.npz")


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _init(rank: int, world: int, init: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _gpipe_rank(rank: int, init: str, ref_path: str, out_path: str) -> None:
    mesh = _init(rank, STAGES, init, (STAGES,), ("stage",))
    try:
        ref = np.load(ref_path)
        params = {"w": torch.from_numpy(ref["W"]).requires_grad_(True),
                  "b": torch.from_numpy(ref["b"]).requires_grad_(True)}
        y = gpipe_forward(_stage_fn, params, torch.from_numpy(ref["x"]), mesh)
        gw, gb = torch.autograd.grad(torch.sum(y ** 2), (params["w"], params["b"]))
        # each rank holds its own stage's gradient rows; the sum is the whole
        for g in (gw, gb):
            dist.all_reduce(g)
        np.savez(f"{out_path}.{rank}.npz", y=y.detach().numpy(), gW=gw.numpy(), gb=gb.numpy())
    finally:
        dist.destroy_process_group()


def test_gpipe_over_four_ranks_matches_the_reference(ref, tmp_path):
    ref_gpipe, _ = ref
    ref_path = str(tmp_path / "ref.npz")
    np.savez(ref_path, **{k: ref_gpipe[k] for k in ref_gpipe.files})
    out = str(tmp_path / "gpipe")
    mp.spawn(_gpipe_rank, args=(f"file://{tmp_path / 'rendezvous'}", ref_path, out), nprocs=STAGES)
    for rank in range(STAGES):  # every rank holds the whole output and gradient
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_allclose(got["y"], ref_gpipe["y"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["gW"], ref_gpipe["gW"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["gb"], ref_gpipe["gb"], atol=1e-4, rtol=0)


@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_gpipe_over_one_stage_is_the_stage_fn(world_of_one):
    """A world of one (gloo on an in-memory store) and a 1-stage mesh: the
    output is ``stage_fn``'s on each microbatch bit for bit, and so are the
    gradients but for the order autograd sums the microbatches' parts in."""
    from repro_torch.launch.mesh import world_size
    from torch.distributed.device_mesh import init_device_mesh

    assert world_size("cpu", 1) == 1
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
    rs = np.random.default_rng(0)
    w = torch.from_numpy(rs.standard_normal((1, 8, 8)).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rs.standard_normal((1, 8)).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rs.standard_normal((3, 2, 8)).astype(np.float32))
    y = gpipe_forward(_stage_fn, {"w": w, "b": b}, x, mesh)
    want = torch.stack([_stage_fn({"w": w[0], "b": b[0]}, h) for h in x])
    assert torch.equal(y, want)
    for a, c in zip(torch.autograd.grad((y ** 2).sum(), (w, b)), torch.autograd.grad((want ** 2).sum(), (w, b))):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0)


def _psum_rank(rank: int, init: str, ref_path: str, out_path: str) -> None:
    mesh = _init(rank, 4, init, (4,), ("pod",))
    try:
        ref = np.load(ref_path)
        grads = {k: torch.from_numpy(ref[f"G_{k}"][rank]) for k in ("w", "b")}
        ef = EFState({k: torch.from_numpy(ref[f"R_{k}"][rank]) for k in ("w", "b")})
        res = {}
        with use_mesh(mesh):
            for denom in DENOMS:
                avg, ef2 = compressed_psum(grads, ef, "pod", denom=denom)
                for k in grads:
                    res[f"avg_{denom}_{k}"] = avg[k].numpy()
                    res[f"res_{denom}_{k}"] = ef2.residual[k].numpy()
                    res[f"q_{denom}_{k}"] = quantize_int8(grads[k] + ef.residual[k])[0].numpy()
        np.savez(f"{out_path}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def test_compressed_psum_over_four_ranks_matches_the_reference(ref, tmp_path):
    _, ref_psum = ref
    ref_path = str(tmp_path / "ref.npz")
    np.savez(ref_path, **{k: ref_psum[k] for k in ref_psum.files})
    out = str(tmp_path / "psum")
    mp.spawn(_psum_rank, args=(f"file://{tmp_path / 'rendezvous'}", ref_path, out), nprocs=4)
    for rank in range(4):
        got = np.load(f"{out}.{rank}.npz")
        for denom in DENOMS:
            for k in ("w", "b"):
                np.testing.assert_array_equal(got[f"q_{denom}_{k}"], ref_psum[f"q_{denom}_{k}"][rank])
                np.testing.assert_array_equal(got[f"res_{denom}_{k}"], ref_psum[f"res_{denom}_{k}"][rank])
                np.testing.assert_allclose(got[f"avg_{denom}_{k}"], ref_psum[f"avg_{denom}_{k}"], atol=1e-6, rtol=0)


def _tc(cls, adamw_cls, k):
    return cls(num_steps=2 * k, save_every=k, warmup_steps=1, adamw=adamw_cls(lr=1e-3))


def test_trainer_on_a_one_rank_mesh_is_bit_equal_to_no_mesh(tmp_path, world_of_one):
    model = build_model(get_reduced("yi-34b").replace(dtype="float32"))
    data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 32, 4, seed=1))
    tc = _tc(TrainConfig, AdamWConfig, 2)
    Trainer(model, tc, data, str(tmp_path / "plain"), device="cpu").run(2)
    shutil.copytree(tmp_path / "plain", tmp_path / "mesh")
    plain = Trainer(model, tc, data, str(tmp_path / "plain"), device="cpu")
    r_plain = plain.run()
    meshed = Trainer(model, tc, data, str(tmp_path / "mesh"), mesh=make_debug_mesh(1, 1, device="cpu"), device="cpu")
    r_mesh = meshed.run()
    assert r_plain.restored_from == r_mesh.restored_from == 2
    assert r_plain.losses == r_mesh.losses
    for (p, a), (_, b) in zip(flatten_with_paths(plain.params), flatten_with_paths(meshed.params)):
        assert torch.equal(a, b), p


def _trainer_rank(rank: int, init: str, ckpt: str, out_path: str) -> None:
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        model = build_model(get_reduced("yi-34b").replace(dtype="float32"))
        data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 32, 4, seed=1))
        r = Trainer(model, _tc(TrainConfig, AdamWConfig, 2), data, ckpt, mesh=make_debug_mesh(2, 1, device="cpu"),
                    device="cpu").run()
        with open(f"{out_path}.{rank}.json", "w") as f:
            json.dump(dict(losses=r.losses, restored_from=r.restored_from), f)
    finally:
        dist.destroy_process_group()


def test_trainer_on_two_ranks_resumes_as_the_reference(tmp_path):
    """The reference trains k = 2 steps of reduced Yi (fp32, B=4) and
    commits; two ranks of a 2×1 mesh resume that directory to 2k, each on
    two of the four rows, while the reference resumes a copy unsharded."""
    k = 2
    ref_model = ref_build_model(ref_get_reduced("yi-34b").replace(dtype="float32"))
    ref_data = RefPipeline(RefDataConfig(ref_model.cfg.vocab_size, 32, 4, seed=1))
    ref_tc = _tc(RefTrainConfig, RefAdamWConfig, k)
    RefTrainer(ref_model, ref_tc, ref_data, str(tmp_path / "port")).run(k)
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ref = RefTrainer(ref_model, ref_tc, ref_data, str(tmp_path / "ref")).run()
    out = str(tmp_path / "losses")
    mp.spawn(_trainer_rank, args=(f"file://{tmp_path / 'rendezvous'}", str(tmp_path / "port"), out), nprocs=2)
    runs = [json.load(open(f"{out}.{r}.json")) for r in range(2)]
    assert runs[0] == runs[1]  # the reported loss is the global mean on every rank
    assert runs[0]["restored_from"] == ref.restored_from == k
    np.testing.assert_allclose(runs[0]["losses"], ref.losses, rtol=RESUME_TOL)
    got, want = RefManager(str(tmp_path / "port")).restore(), RefManager(str(tmp_path / "ref")).restore()
    assert got.step == want.step == 2 * k  # rank 0 wrote it
    got_flat = dict(ref_flatten(got.collections))
    for p, a in ref_flatten(want.collections):
        np.testing.assert_allclose(got_flat[p], a, atol=RESUME_TOL, rtol=RESUME_TOL, err_msg=p)
