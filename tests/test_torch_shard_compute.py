"""Compute on shards (``Model.prefill_sharded`` / ``decode_step_sharded``,
``cold_start(mesh=)`` on a multi-rank mesh, ``sharding.comm``) against the
reference's unsharded run and the port's unsharded run, on the CPU.

Reduced Mixtral (MoE) and Yi (dense) at fp32 carry the reference's weights
(``jax.random.PRNGKey(0)``) and its two-tier artifact. One gloo spawn per
world (1×2, 2×1, 2×2; ``torch.multiprocessing``, a ``file://``
rendezvous, no network) serves both archs under ``residency="full"``
without the prefetcher, so every fault is deterministic, and records on
rank 0:

  * greedy tokens and the prefill's whole logits (B=4 × 8, 4 new tokens),
    held to the reference's: logits within ``LOGIT_TOL`` (1e-4 absolute;
    the ranks' partial sums are added in another order than one matmul
    adds them), tokens equal up to the first step whose reference margin
    (top-1 minus top-2 logit) is within ``LOGIT_TOL``, where the two may
    rightly break a near-tie apart (DESIGN.md §15.1);
  * the faulted unit keys and raw bytes, equal to the unsharded port's,
    and the charge of every resident unit, ceil(raw bytes / its leaf's
    shard divisor), exactly;
  * one Mixtral prefill of B=4 × 320 (T = 1280 > 1024: the capacity path,
    ``C`` from the global T) after ``ensure_all``, whose greedy ids equal
    the reference's and the unsharded port's;
  * that no served run called ``DTensor.full_tensor`` (no whole-tree
    gather) and that the sharded runs' collectives moved bytes;
  * on 2×2, the sharded prefill over ``DistComm`` on the seeded weights cut
    to each rank's blocks, which the in-process rank loop
    (``sharding.comm.run_ranks``) must reproduce within ``LOGIT_TOL``.
"""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.models.zoo import build_model as ref_build_model
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start
from repro_torch.sharding.comm import DistComm, run_ranks
from repro_torch.sharding.rules import MeshShape, act_specs, cut_tree, param_shardings
from repro_torch.utils.tree import tree_map

ARCHS = ("mixtral-8x22b", "yi-34b")
WORLDS = ((1, 2), (2, 1), (2, 2))
PROFILE = dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1024, vocab_row_group=128)
PROMPT = np.random.default_rng(7).integers(0, 512, (4, 8))
LONG = np.random.default_rng(8).integers(0, 512, (4, 320))  # 1280 tokens: past the dropless 1024
NEW_TOKENS = 4
MAX_SEQ = 16
LOGIT_TOL = 1e-4


def _port_app(arch: str):
    cfg = get_reduced(arch).replace(collect_moe_usage=True, dtype="float32")
    model = build_model(cfg)
    return model, analyze(model, DeploymentProfile(**PROFILE), trace_B=1, trace_S=16)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Per arch: the reference's artifact (its weights), its tokens, its
    prefill logits for PROMPT and LONG, and the unsharded port's run."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_get_reduced(arch).replace(collect_moe_usage=True, dtype="float32")
        ref_model = ref_build_model(ref_cfg)
        ref_res = ref_analyze(ref_model, RefProfile(**PROFILE), trace_B=1, trace_S=16)
        params = ref_model.init(jax.random.PRNGKey(0))
        outdir = str(tmp_path_factory.mktemp(arch))
        ref_build_artifact(params, ref_res, outdir)
        with ref_cold_start(ref_model, outdir, ref_res, residency="full", prefetch=False,
                            warm_shapes=((4, 8),)) as server:
            toks, _ = RefEngine(server, max_seq=MAX_SEQ).generate(jnp.asarray(PROMPT), NEW_TOKENS)
        rec = dict(outdir=outdir, ref_tokens=np.asarray(toks),
                   ref_logits=np.asarray(ref_model.prefill(params, {"tokens": jnp.asarray(PROMPT)})[0]))
        if arch == "mixtral-8x22b":
            rec["ref_long"] = np.asarray(ref_model.prefill(params, {"tokens": jnp.asarray(LONG)})[0])
        rec.update(_unsharded_port(arch, outdir))
        out[arch] = rec
    return out


def _margins(model, params) -> np.ndarray:
    """(B, NEW_TOKENS) top-1 minus top-2 logit of each greedy step of the
    unsharded port (teacher-forced on its own tokens)."""
    from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage

    B, S = PROMPT.shape
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": torch.from_numpy(PROMPT)})
        caches = _graft_prefill_cache(model.init_cache(B, MAX_SEQ, multimodal=False, device="cpu"),
                                      _strip_usage(caches))
        steps = [logits]
        for t in range(NEW_TOKENS - 1):
            batch = {"tokens": steps[-1].argmax(-1)[:, None], "pos": torch.full((B,), S + t)}
            steps.append(model.decode_step(params, caches, batch)[0])
    top2 = torch.stack(steps, 1).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def _unsharded_port(arch: str, outdir: str) -> dict:
    model, res = _port_app(arch)
    with cold_start(model, outdir, res, residency="full", prefetch=False, warm_shapes=((4, 8, MAX_SEQ),),
                    device="cpu") as server:
        toks, st = GenerationEngine(server, max_seq=MAX_SEQ).generate(torch.from_numpy(PROMPT), NEW_TOKENS)
        t = server.tiered
        rec = dict(tokens=toks, keys=sorted({e.key for e in t.stats.events if e.source == "fault"}),
                   faulted_bytes=st.faulted_bytes, raw={k: t.unit_charge(k) for k in t._all_units})
        t.ensure_all()
        params = tree_map(lambda x: x.clone(), t.tree())
    rec["margins"] = _margins(model, params)
    if arch == "mixtral-8x22b":
        with torch.inference_mode():
            rec["long"] = model.prefill(params, {"tokens": torch.from_numpy(LONG)})[0].argmax(-1).numpy()
    return rec


def _serve_rank(rank: int, world: tuple, init: str, outdirs: dict, result_path: str) -> None:
    """One rank of a ``world`` (data, model) mesh: serve each arch from its
    artifact on the mesh and (rank 0) write what the tests check."""
    from torch.distributed.tensor import DTensor

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world[0] * world[1])
    full_calls = []
    full_tensor = DTensor.full_tensor
    DTensor.full_tensor = lambda self, *a, **k: full_calls.append(1) or full_tensor(self, *a, **k)
    try:
        mesh = make_debug_mesh(*world, device="cpu")
        rec = {}
        for arch, outdir in outdirs.items():
            model, res = _port_app(arch)
            with cold_start(model, outdir, res, residency="full", prefetch=False,
                            warm_shapes=((4, 8, MAX_SEQ),), mesh=mesh, device="cpu") as server:
                engine = GenerationEngine(server, max_seq=MAX_SEQ)
                toks, st = engine.generate(torch.from_numpy(PROMPT), NEW_TOKENS)
                t = server.tiered
                r = dict(sharded=server.sharded, tokens=toks.tolist(), faulted_bytes=st.faulted_bytes,
                         keys=sorted({e.key for e in t.stats.events if e.source == "fault"}),
                         resident=sorted(t.resident_keys), charged=t.residency.charged_bytes(),
                         divs=dict(t._shard_div), collective_bytes=server.collective_bytes)
                with torch.inference_mode():
                    entry = server.compiled_prefill(*PROMPT.shape)
                    logits, _ = entry(server.live_params(), {"tokens": torch.from_numpy(PROMPT)})
                    r["logits"] = server.whole_logits(logits, PROMPT.shape[0]).tolist()
                    if arch == "mixtral-8x22b":
                        t.ensure_all()
                        entry = server.compiled_prefill(*LONG.shape)
                        logits, _ = entry(server.live_params(), {"tokens": torch.from_numpy(LONG)})
                        r["long"] = server.next_tokens(logits, LONG.shape[0]).tolist()
                rec[arch] = r
        rec["full_tensor_calls"] = len(full_calls)
        if world == (2, 2):  # the sharded prefill over gloo on seeded weights, for the in-process loop
            rec["gloo_logits"] = _seeded_prefill(DistComm(mesh)).tolist()
        if rank == 0:
            with open(result_path, "w") as f:
                json.dump(rec, f)
    finally:
        DTensor.full_tensor = full_tensor
        dist.destroy_process_group()


def _seeded():
    cfg = replace(get_reduced("mixtral-8x22b"), dtype="float32", collect_moe_usage=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(3), device="cpu", dtype=torch.float32)


def _seeded_prefill(comm) -> torch.Tensor:
    """Rank (0, 0)'s logits block of the sharded prefill of PROMPT on the
    seeded reduced Mixtral, each rank's blocks cut from the whole tree."""
    model, params = _seeded()
    mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
    specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(), mesh))
    batch = {"tokens": torch.from_numpy(PROMPT)}
    rows = cut_tree(batch, act_specs({"tokens": ("batch", "seq")}, batch, comm), comm)
    with torch.inference_mode():
        return model.prefill_sharded(cut_tree(params, specs, comm), rows, comm)[0]


_RESULTS: dict = {}


@pytest.fixture
def world_result(apps, tmp_path_factory):
    """The spawn of one world, run once for every test that reads it."""
    def get(world):
        if world not in _RESULTS:
            tmp = tmp_path_factory.mktemp("x".join(map(str, world)))
            path = str(tmp / "rank0.json")
            mp.spawn(_serve_rank, args=(world, f"file://{tmp / 'rendezvous'}",
                                        {a: apps[a]["outdir"] for a in ARCHS}, path), nprocs=world[0] * world[1])
            with open(path) as f:
                _RESULTS[world] = json.load(f)
        return _RESULTS[world]
    return get


def _first_tie(margins: np.ndarray) -> int:
    """The first step at which some row's margin is within LOGIT_TOL (the
    steps' count when none is)."""
    ties = np.nonzero((margins <= LOGIT_TOL).any(axis=0))[0]
    return int(ties[0]) if len(ties) else margins.shape[1]


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: "x".join(map(str, w)))
def test_sharded_serving_matches_the_reference(world, apps, world_result):
    """Tokens and prefill logits against the reference's unsharded run;
    fault keys, raw bytes and per-shard charges against the unsharded
    port's; no whole-tree gather, and collectives on every sharded run."""
    got = world_result(world)
    assert got["full_tensor_calls"] == 0
    for arch in ARCHS:
        r, a = got[arch], apps[arch]
        assert r["sharded"]
        np.testing.assert_allclose(np.asarray(r["logits"]), a["ref_logits"], rtol=0, atol=LOGIT_TOL, err_msg=arch)
        n = _first_tie(a["margins"])
        np.testing.assert_array_equal(np.asarray(r["tokens"])[:, :n], a["ref_tokens"][:, :n], err_msg=arch)
        np.testing.assert_array_equal(a["tokens"][:, :n], a["ref_tokens"][:, :n], err_msg=arch)
        assert r["keys"] == a["keys"] and r["faulted_bytes"] == a["faulted_bytes"], arch
        want = sum(-(-a["raw"][k] // r["divs"].get(k.split("#")[0], 1)) for k in r["resident"])
        assert r["charged"] == want, arch
        assert all(b > 0 for runs in r["collective_bytes"].values() for b in runs), arch


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: "x".join(map(str, w)))
def test_capacity_path_prefill_keeps_global_routing(world, apps, world_result):
    """B=4 × 320 on reduced Mixtral (T = 1280, so ``C`` comes from the
    capacity rule over the global T): the sharded greedy ids equal the
    reference's and the unsharded port's."""
    got = world_result(world)["mixtral-8x22b"]["long"]
    a = apps["mixtral-8x22b"]
    np.testing.assert_array_equal(np.asarray(got), a["ref_long"].argmax(-1))
    np.testing.assert_array_equal(np.asarray(got), a["long"])


def test_in_process_ranks_match_the_gloo_world(world_result):
    """The in-process rank loop (``run_ranks``: four threads, reductions by
    hand in rank order) gives rank (0, 0)'s logits block of the 2×2 gloo
    world on the same seeded weights, within LOGIT_TOL."""
    gloo = np.asarray(world_result((2, 2))["gloo_logits"])
    blocks = run_ranks({"data": 2, "model": 2}, _seeded_prefill)
    np.testing.assert_allclose(blocks[0].numpy(), gloo, rtol=0, atol=LOGIT_TOL)
    model, params = _seeded()
    with torch.inference_mode():
        whole = model.prefill(params, {"tokens": torch.from_numpy(PROMPT)})[0]
    np.testing.assert_allclose(torch.cat([torch.cat(blocks[i:i + 2], 1) for i in (0, 2)]).numpy(), whole.numpy(),
                               rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mistral-large-123b"])
def test_other_gqa_stacks_trace_sharded(arch):
    """Phi-3 and Mistral-Large reduced: their 2×2 dry-run serving cells
    trace the sharded step, a quarter of the 1×1 cell's dot FLOPs per
    device, and collectives that move less than one whole-tree gather."""
    cfg = get_reduced(arch)
    extra = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    for kind in ("prefill", "decode"):
        shape = ShapeSpec(f"{kind}_b4s64", 64, 4, kind)
        one, four = (dryrun.run_cell(arch, shape, mesh_shape=m, device="cpu", out_dir=None, verbose=False,
                                     extra_cfg=extra) for m in ((1, 1), (2, 2)))
        # per device: a quarter of the one device's dot FLOPs
        assert four["hlo_dot_flops"] / four["num_chips"] == one["hlo_dot_flops"] / 4, kind
        assert 0 < four["collective_bytes"] < build_model(cfg).num_params() * 2, kind


def test_in_process_ranks_under_thread_churn():
    """16 ranks (more threads than the host's cores) with a 1 µs switch
    interval, 50 rounds of all-reduces (sum, max) and all-gathers over both
    mesh dims: every result equals its closed form, and a rank that raises
    ends every thread (the error is raised, nothing hangs)."""
    import sys
    import threading

    sizes = {"data": 4, "model": 4}

    def work(comm):
        d, m = comm.index("data"), comm.index("model")
        out = []
        for i in range(50):
            x = torch.full((3,), float(4 * d + m + i))
            out.append((comm.all_reduce(x, "model")[0].item(), comm.all_reduce(x, "data", "max")[0].item(),
                        comm.all_gather(x[:1], "model", 0).tolist()))
        return d, m, out

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = run_ranks(sizes, work)

        def fail(comm):
            if comm.rank == 5:
                raise RuntimeError("rank 5 fails")
            comm.all_reduce(torch.ones(1), "model")
            return comm.all_reduce(torch.ones(1), "data")

        with pytest.raises(RuntimeError, match="rank 5 fails"):
            run_ranks(sizes, fail)
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() < 16
    for d, m, out in got:
        for i, (total, top, row) in enumerate(out):
            assert total == sum(4 * d + j + i for j in range(4))
            assert top == 4 * 3 + m + i
            assert row == [float(4 * d + j + i) for j in range(4)]
