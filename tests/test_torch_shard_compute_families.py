"""Compute on shards for Gemma-3's 5:1 local/global stack, DeepSeek-V2-Lite's
MLA and RecurrentGemma's RG-LRU hybrid (``Model.prefill_sharded`` /
``decode_step_sharded``, ``cold_start(mesh=)`` on a multi-rank mesh) against
the reference's unsharded run and the port's unsharded run, on the CPU.

The reduced configs at fp32 with ``collect_moe_usage=True`` carry the
reference's weights (``jax.random.PRNGKey(0)``) and its two-tier artifact.
One gloo spawn per world (1×2, 2×1, 2×2; ``torch.multiprocessing``, a
``file://`` rendezvous, no network) serves all three archs under
``residency="full"`` without the prefetcher, so every fault is
deterministic, and records on rank 0:

  * greedy tokens (B=4 × 8, 12 new tokens: Gemma-3's reduced local window of
    16 rolls from rank 1's slot block into rank 0's on a ``model`` dim of 2)
    and the prefill's whole logits, held to the reference's: logits within
    ``LOGIT_TOL`` (1e-4 absolute), tokens equal up to the first step whose
    reference margin (top-1 minus top-2 logit) is within ``LOGIT_TOL``;
  * the faulted unit keys and raw bytes, equal to the unsharded port's, and
    the charge of every resident unit, ceil(raw bytes / its leaf's shard
    divisor), exactly;
  * that no served run called ``DTensor.full_tensor`` (no whole-tree
    gather) and that the sharded runs' collectives moved bytes;
  * on 2×2, each arch's sharded prefill over ``DistComm`` on seeded weights
    cut to each rank's blocks, which the in-process rank loop
    (``sharding.comm.run_ranks``) must reproduce within ``LOGIT_TOL``.

A unit test holds ``mla_decode_sharded``'s split-slot combine to
``mla_decode`` where one rank's slot block holds no valid slot and a row's
``kv_len`` ends inside another rank's block.
"""

import json
import math
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
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention as attn
from repro_torch.models import build_model, zoo
from repro_torch.serving import ColdStartReport, ColdStartServer, GenerationEngine, cold_start
from repro_torch.sharding.comm import DistComm, run_ranks
from repro_torch.sharding.rules import MeshShape, PartitionSpec, act_specs, block_of, cut_tree, param_shardings
from repro_torch.utils.tree import tree_map

ARCHS = ("gemma3-27b", "deepseek-v2-lite-16b", "recurrentgemma-9b")
WORLDS = ((1, 2), (2, 1), (2, 2))
PROFILE = dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1024, vocab_row_group=128)
PROMPT = np.random.default_rng(7).integers(0, 512, (4, 8))
NEW_TOKENS = 12  # decode positions 8..18: Gemma-3's local caches of 16 slots wrap at 16
MAX_SEQ = 24
LOGIT_TOL = 1e-4


def _port_model(arch: str):
    return build_model(get_reduced(arch).replace(collect_moe_usage=True, dtype="float32"))


def _port_app(arch: str):
    model = _port_model(arch)
    return model, analyze(model, DeploymentProfile(**PROFILE), trace_B=1, trace_S=16)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Per arch: the reference's artifact (its weights), its tokens and
    prefill logits for PROMPT, and the unsharded port's run."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_get_reduced(arch).replace(collect_moe_usage=True, dtype="float32")
        ref_model = ref_build_model(ref_cfg)
        ref_res = ref_analyze(ref_model, RefProfile(**PROFILE), trace_B=1, trace_S=16)
        params = jax.jit(ref_model.init)(jax.random.PRNGKey(0))
        outdir = str(tmp_path_factory.mktemp(arch))
        ref_build_artifact(params, ref_res, outdir)
        with ref_cold_start(ref_model, outdir, ref_res, residency="full", prefetch=False,
                            warm_shapes=((4, 8),)) as server:
            toks, _ = RefEngine(server, max_seq=MAX_SEQ).generate(jnp.asarray(PROMPT), NEW_TOKENS)
        rec = dict(outdir=outdir, ref_tokens=np.asarray(toks),
                   ref_logits=np.asarray(jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(PROMPT)})[0]))
        rec.update(_unsharded_port(arch, outdir))
        out[arch] = rec
    return out


def _margins(model, params) -> np.ndarray:
    """(B, NEW_TOKENS) top-1 minus top-2 logit of each greedy step of the
    unsharded port (teacher-forced on its own tokens)."""
    from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage, commit_decode_caches

    B, S = PROMPT.shape
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": torch.from_numpy(PROMPT)})
        caches = _graft_prefill_cache(model.init_cache(B, MAX_SEQ, multimodal=False, device="cpu"),
                                      _strip_usage(caches))
        steps = [logits]
        for t in range(NEW_TOKENS - 1):
            batch = {"tokens": steps[-1].argmax(-1)[:, None], "pos": torch.full((B,), S + t)}
            logits, new = model.decode_step(params, caches, batch)
            caches = commit_decode_caches(caches, _strip_usage(new))
            steps.append(logits)
    top2 = torch.stack(steps, 1).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def _unsharded_port(arch: str, outdir: str) -> dict:
    model, res = _port_app(arch)
    with cold_start(model, outdir, res, residency="full", prefetch=False, warm_shapes=((4, 8, MAX_SEQ),),
                    device="cpu") as server:
        toks, st = GenerationEngine(server, max_seq=MAX_SEQ).generate(torch.from_numpy(PROMPT), NEW_TOKENS)
        t = server.tiered
        rec = dict(tokens=toks, keys=sorted({e.key for e in t.stats.events if e.source == "fault"}),
                   faulted_bytes=st.faulted_bytes, raw={k: t.unit_charge(k) for k in t._all_units}, res=res)
        t.ensure_all()
        params = tree_map(lambda x: x.clone(), t.tree())
    rec["margins"] = _margins(model, params)
    return rec


def _serve_rank(rank: int, world: tuple, init: str, served: dict, result_path: str) -> None:
    """One rank of a ``world`` (data, model) mesh: serve each arch from its
    artifact directory with the unsharded port's analysis (``served``: arch
    -> (directory, analysis)) on the mesh and (rank 0) write what the tests
    check."""
    from torch.distributed.tensor import DTensor

    torch.set_num_threads(1)  # the ranks share the host's cores: one thread each, none spinning on another's
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world[0] * world[1])
    full_calls = []
    full_tensor = DTensor.full_tensor
    DTensor.full_tensor = lambda self, *a, **k: full_calls.append(1) or full_tensor(self, *a, **k)
    try:
        mesh = make_debug_mesh(*world, device="cpu")
        rec = {}
        for arch, (outdir, res) in served.items():
            model = _port_model(arch)
            with cold_start(model, outdir, res, residency="full", prefetch=False,
                            warm_shapes=((4, 8, MAX_SEQ),), mesh=mesh, device="cpu") as server:
                toks, st = GenerationEngine(server, max_seq=MAX_SEQ).generate(torch.from_numpy(PROMPT), NEW_TOKENS)
                t = server.tiered
                r = dict(sharded=server.sharded, tokens=toks.tolist(), faulted_bytes=st.faulted_bytes,
                         keys=sorted({e.key for e in t.stats.events if e.source == "fault"}),
                         resident=sorted(t.resident_keys), charged=t.residency.charged_bytes(),
                         divs=dict(t._shard_div), collective_bytes=server.collective_bytes)
                with torch.inference_mode():
                    entry = server.compiled_prefill(*PROMPT.shape)
                    logits, _ = entry(server.live_params(), {"tokens": torch.from_numpy(PROMPT)})
                    r["logits"] = server.whole_logits(logits, PROMPT.shape[0]).tolist()
                rec[arch] = r
        rec["full_tensor_calls"] = len(full_calls)
        if world == (2, 2):  # the sharded prefills over gloo on seeded weights, for the in-process loop
            rec["gloo_logits"] = {arch: _seeded_prefill(arch, DistComm(mesh)).tolist() for arch in ARCHS}
        if rank == 0:
            with open(result_path, "w") as f:
                json.dump(rec, f)
    finally:
        DTensor.full_tensor = full_tensor
        dist.destroy_process_group()


def _seeded(arch: str):
    cfg = replace(get_reduced(arch), dtype="float32", collect_moe_usage=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(3), device="cpu", dtype=torch.float32)


def _seeded_prefill(arch: str, comm) -> torch.Tensor:
    """This rank's logits block of the sharded prefill of PROMPT on the
    seeded reduced ``arch``, each rank's blocks cut from the whole tree."""
    model, params = _seeded(arch)
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
                                        {a: (apps[a]["outdir"], apps[a]["res"]) for a in ARCHS}, path), nprocs=world[0] * world[1])
            with open(path) as f:
                _RESULTS[world] = json.load(f)
        return _RESULTS[world]
    return get


def _first_tie(margins: np.ndarray) -> int:
    """The first step at which some row's margin is within LOGIT_TOL (the
    steps' count when none is)."""
    ties = np.nonzero((margins <= LOGIT_TOL).any(axis=0))[0]
    return int(ties[0]) if len(ties) else margins.shape[1]


def test_every_family_computes_on_shards():
    """On a fake world, every family of the zoo computes on shards on a 2×2
    ("data", "model") mesh (``ColdStartServer.sharded``, and the dry run's
    serving cells trace the sharded step), and gathers at use on a 2×2×2
    mesh with a ``pod`` dim; no per-family rule is left."""
    assert not hasattr(zoo, "sharded_forward")
    for shape, names, sharded in (((2, 2), ("data", "model"), True), ((2, 2, 2), ("pod", "data", "model"), False)):
        dryrun.fake_world(math.prod(shape))
        try:
            mesh = dryrun.make_mesh(shape, names, "cpu")
            for arch in ARCH_IDS:
                server = ColdStartServer(build_model(get_reduced(arch)), {}, ColdStartReport(mode="after2"), mesh=mesh,
                                         device="cpu")
                assert server.sharded is sharded and dryrun.sharded_cell(mesh) is sharded, (arch, names)
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: "x".join(map(str, w)))
def test_sharded_families_match_the_reference(world, arch, apps, world_result):
    """Tokens and prefill logits against the reference's unsharded run;
    fault keys, raw bytes and per-shard charges against the unsharded
    port's; no whole-tree gather, and collectives on every sharded run."""
    got = world_result(world)
    assert got["full_tensor_calls"] == 0
    r, a = got[arch], apps[arch]
    assert r["sharded"]
    np.testing.assert_allclose(np.asarray(r["logits"]), a["ref_logits"], rtol=0, atol=LOGIT_TOL)
    n = _first_tie(a["margins"])
    assert n > 1  # the held prefix reaches the decode steps
    np.testing.assert_array_equal(np.asarray(r["tokens"])[:, :n], a["ref_tokens"][:, :n])
    np.testing.assert_array_equal(a["tokens"][:, :n], a["ref_tokens"][:, :n])
    assert r["keys"] == a["keys"] and r["faulted_bytes"] == a["faulted_bytes"]
    want = sum(-(-a["raw"][k] // r["divs"].get(k.split("#")[0], 1)) for k in r["resident"])
    assert r["charged"] == want
    assert all(b > 0 for runs in r["collective_bytes"].values() for b in runs)


@pytest.mark.parametrize("arch", ARCHS)
def test_in_process_ranks_match_the_gloo_world(arch, world_result):
    """The in-process rank loop (``run_ranks``: four threads, reductions by
    hand in rank order) gives rank (0, 0)'s logits block of the 2×2 gloo
    world on the same seeded weights, and the four blocks the unsharded
    prefill, within LOGIT_TOL."""
    gloo = np.asarray(world_result((2, 2))["gloo_logits"][arch])
    blocks = run_ranks({"data": 2, "model": 2}, lambda comm: _seeded_prefill(arch, comm))
    np.testing.assert_allclose(blocks[0].numpy(), gloo, rtol=0, atol=LOGIT_TOL)
    model, params = _seeded(arch)
    with torch.inference_mode():
        whole = model.prefill(params, {"tokens": torch.from_numpy(PROMPT)})[0]
    np.testing.assert_allclose(torch.cat([torch.cat(blocks[i:i + 2], 1) for i in (0, 2)]).numpy(), whole.numpy(),
                               rtol=0, atol=LOGIT_TOL)


def test_mla_decode_combine_over_slot_blocks():
    """``mla_decode_sharded`` on 4 ``model`` ranks of 4 slots each (16 in
    all): row 0 decodes position 5 (its 6 valid slots end inside rank 1's
    block; ranks 2 and 3 hold no valid slot), row 1 position 9 (ending
    inside rank 2's; rank 3 holds none). The output equals ``mla_decode``'s
    within LOGIT_TOL on every rank, and the new latent rows land in their
    owners' blocks: the blocks put together equal the unsharded caches
    within LOGIT_TOL, every other row bit for bit."""
    model, params = _seeded("deepseek-v2-lite-16b")
    cfg = model.cfg
    p = params["lead"]["b0"]["attn"]
    sizes = {"data": 1, "model": 4}
    specs = param_shardings(model.logical_axes(), model.abstract(), MeshShape(tuple(sizes), tuple(sizes.values())))
    p_specs = tree_map(lambda sh: sh.spec, specs["lead"]["b0"]["attn"])
    g = torch.Generator().manual_seed(5)
    B, S, m = 2, 16, cfg.mla
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    pos = torch.tensor([5, 9])
    ckv = torch.randn(B, S, m.kv_lora_rank, generator=g) * (torch.arange(S)[None, :, None] < pos[:, None, None])
    kr = torch.randn(B, S, m.qk_rope_head_dim, generator=g) * (torch.arange(S)[None, :, None] < pos[:, None, None])
    with torch.inference_mode():
        want, want_ckv, want_kr = attn.mla_decode(p, x, pos, ckv.clone(), kr.clone(), cfg)
    slots = PartitionSpec(None, "model")
    valid_blocks = []

    def rank(comm):
        local = cut_tree(p, p_specs, comm)
        c, r = block_of(ckv, slots, comm).clone(), block_of(kr, slots, comm).clone()
        start = comm.index("model") * (S // 4)
        valid_blocks.append(bool(((start + torch.arange(S // 4))[None, :] <= pos[:, None]).any()))
        with torch.inference_mode():
            return attn.mla_decode_sharded(local, x, pos, c, r, cfg, comm, seq_dims=("model",))

    out = run_ranks(sizes, rank)
    assert valid_blocks.count(False) == 1  # rank 3: no row has a valid slot there
    for o, _, _ in out:
        np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=0, atol=LOGIT_TOL)
    # the new rows' latent sums its partial products over the ranks, in another order than one matmul
    np.testing.assert_allclose(torch.cat([o[1] for o in out], 1).numpy(), want_ckv.numpy(), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(torch.cat([o[2] for o in out], 1).numpy(), want_kr.numpy(), rtol=0, atol=LOGIT_TOL)
    untouched = torch.ones(B, S, dtype=torch.bool)
    untouched[torch.arange(B), pos] = False
    assert torch.equal(torch.cat([o[1] for o in out], 1)[untouched], ckv[untouched])


def _sixteen_rank_config(arch: str):
    """``arch`` at fp32, two or three layers, with the full configs' head
    and expert counts (so every head split, EP and the RG-LRU's channels
    divide 16 ``model`` ranks) and narrow widths."""
    from repro_torch.configs.base import MLAConfig, MoEConfig, RecurrentConfig

    base = dict(dtype="float32", d_model=256, vocab_size=1024)
    if arch == "gemma3-27b":
        return get_config(arch).replace(**base, num_layers=6, head_dim=16, d_ff=512, sliding_window=32)
    if arch == "deepseek-v2-lite-16b":
        return get_config(arch).replace(
            **base, num_layers=2, d_ff=32,
            mla=MLAConfig(kv_lora_rank=64, q_lora_rank=0, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
            moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2, expert_d_ff=32, first_dense_layers=1,
                          dense_d_ff=256))
    return get_config(arch).replace(**base, num_layers=3, head_dim=16, d_ff=512,
                                    recurrent=RecurrentConfig(pattern=("rec", "rec", "attn"), lru_width=256,
                                                              conv_width=4, window=32))


@pytest.mark.parametrize("arch", ARCHS)
def test_sixteen_model_ranks_match_the_unsharded_prefill(arch):
    """As chip_smoke's ``[mesh]`` (d) splits them, at narrow widths on the
    CPU in fp32: 16 ``model`` ranks in one process (``run_ranks``), each
    holding 2 of Gemma-3's 32 q heads and 1 of its 16 kv heads, 1 of
    DeepSeek's 16 MLA heads and 4 of its 64 experts, or 16 of
    RecurrentGemma's 256 LRU channels and 1 of its 16 q heads against the
    MQA head. The ranks' logits blocks put together equal the unsharded
    prefill's within LOGIT_TOL (fp32 rounding of the partial sums)."""
    cfg = _sixteen_rank_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)))}
    sizes = {"data": 1, "model": 16}
    specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(),
                                                         MeshShape(tuple(sizes), tuple(sizes.values()))))

    def rank(comm):
        rows = cut_tree(batch, act_specs({"tokens": ("batch", "seq")}, batch, comm), comm)
        with torch.inference_mode():
            return model.prefill_sharded(cut_tree(params, specs, comm), rows, comm)[0]

    blocks = run_ranks(sizes, rank)
    with torch.inference_mode():
        whole = model.prefill(params, batch)[0]
    np.testing.assert_allclose(torch.cat(blocks, 1).numpy(), whole.numpy(), rtol=0, atol=LOGIT_TOL)
