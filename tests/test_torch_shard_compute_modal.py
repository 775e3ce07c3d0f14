"""Compute on shards for Whisper's encoder-decoder, Llama-3.2-Vision's gated
cross blocks and xLSTM's mLSTM / sLSTM stack (``Model.prefill_sharded`` /
``decode_step_sharded``, ``cold_start(mesh=)`` on a multi-rank mesh)
against the reference's unsharded run and the port's unsharded run, on the
CPU.

The reduced configs at fp32 carry the reference's weights
(``jax.random.PRNGKey(0)``, the VLM's ``gate`` and ``gate_ffn`` set
nonzero in the numpy leaves both packages receive, so its cross block
counts) and its two-tier artifact. One gloo spawn per world (1×2, 2×1, 2×2;
``torch.multiprocessing``, a ``file://`` rendezvous, no network) serves all
three archs under ``residency="full"`` without the prefetcher, so every
fault is deterministic, and records on rank 0:

  * the text-only server's greedy tokens (B=4 × 32: xLSTM's reduced chunk of
    16 takes the chunkwise mLSTM) and its prefill's whole logits, held to the
    reference's: logits within ``LOGIT_TOL`` (1e-4 absolute), tokens equal
    up to the first step whose reference margin (top-1 minus top-2 logit) is
    within ``LOGIT_TOL``;
  * the faulted unit keys and raw bytes, equal to the unsharded port's, and
    the charge of every resident unit, ceil(raw bytes / its leaf's shard
    divisor), exactly;
  * that no served run called ``DTensor.full_tensor`` (no whole-tree
    gather) and that the sharded runs' collectives moved bytes;
  * a multimodal prefill over ``DistComm`` (Whisper's ``frames``, the VLM's
    ``image_embeds``, seeded with numpy) on the reference's weights cut to
    each rank's blocks, its caches grafted into the decode caches' blocks
    (cross K/V too) and three decode steps fed the reference's tokens: the
    logits of every step within ``LOGIT_TOL`` of the reference's
    ``prefill`` / ``decode_step``.

An in-process world (``sharding.comm.run_ranks``) where ``model`` does not
divide the heads, reduced xLSTM (2 heads) on 1×4 and reduced Whisper (4
heads) on 1×8, the full-width 16-rank layout in small, holds the same
multimodal run to the unsharded port within ``LOGIT_TOL``.
"""

import json
import os

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
from repro.serving.engine import _graft_prefill_cache as ref_graft
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro.utils.tree import tree_from_flat as ref_tree_from_flat
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start
from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage, commit_decode_caches
from repro_torch.sharding.comm import DistComm, run_ranks
from repro_torch.sharding.rules import (
    MeshShape,
    act_specs,
    block_of,
    cut_tree,
    gather_axis,
    global_shape,
    graft_block,
    param_shardings,
)
from repro_torch.utils.tree import flatten_with_paths, tree_map

ARCHS = ("whisper-base", "llama-3.2-vision-90b", "xlstm-125m")
WORLDS = ((1, 2), (2, 1), (2, 2))
PROFILE = dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1024, vocab_row_group=128)
PROMPT = np.random.default_rng(7).integers(0, 512, (4, 32))  # 32 = 2 × xLSTM's reduced chunk
NEW_TOKENS = 4
DECODE_STEPS = 3
MAX_SEQ = 40
LOGIT_TOL = 1e-4
GATE, GATE_FFN = 0.8, -0.6  # tanh ≈ 0.66 and -0.54: the VLM's cross block counts


def _port_model(arch: str):
    return build_model(get_reduced(arch).replace(dtype="float32"))


def _modal_batch(cfg) -> dict:
    """PROMPT with the config's modal input, seeded with numpy: Whisper's
    ``frames`` (B, S, d_model), the VLM's ``image_embeds`` (B, T, vision_dim)."""
    rs = np.random.default_rng(11)
    B, S = PROMPT.shape
    batch = {"tokens": PROMPT}
    if cfg.encdec is not None:
        batch["frames"] = rs.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    if cfg.vlm is not None:
        batch["image_embeds"] = rs.standard_normal((B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim),
                                                   dtype=np.float32)
    return batch


def _with_gates(flat: dict) -> dict:
    return {p: np.full_like(v, GATE) if p.endswith(".cross.gate") else
            np.full_like(v, GATE_FFN) if p.endswith(".gate_ffn") else v for p, v in flat.items()}


def _reference_multimodal(ref_model, params, batch: dict) -> tuple:
    """The reference's multimodal prefill and DECODE_STEPS greedy decode
    steps: (the logits of each step, the tokens each decode step was fed)."""
    B, S = batch["tokens"].shape
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32) for k, v in batch.items()}
    logits, caches = jax.jit(ref_model.prefill)(params, jb)
    caches = ref_graft(ref_model.init_cache(B, MAX_SEQ, multimodal=True), caches)
    decode = jax.jit(ref_model.decode_step)
    out, fed = [np.asarray(logits)], []
    for t in range(DECODE_STEPS):
        fed.append(np.argmax(out[-1], -1))
        logits, caches = decode(params, caches, {"tokens": jnp.asarray(fed[-1][:, None], jnp.int32),
                                                 "pos": jnp.full((B,), S + t, jnp.int32)})
        out.append(np.asarray(logits))
    return out, fed


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Per arch: the reference's artifact and numpy leaves (its weights), its
    text-only tokens and prefill logits for PROMPT, its multimodal run, and
    the unsharded port's text-only run."""
    out = {}
    for arch in ARCHS:
        ref_model = ref_build_model(ref_get_reduced(arch).replace(dtype="float32"))
        flat = _with_gates({p: np.asarray(v) for p, v in ref_flatten(ref_model.init(jax.random.PRNGKey(0)))})
        params = ref_tree_from_flat({p: jnp.asarray(v) for p, v in flat.items()})
        ref_res = ref_analyze(ref_model, RefProfile(**PROFILE), trace_B=1, trace_S=16)
        outdir = str(tmp_path_factory.mktemp(arch))
        ref_build_artifact(params, ref_res, outdir)
        np.savez(os.path.join(outdir, "leaves.npz"), **flat)
        with ref_cold_start(ref_model, outdir, ref_res, residency="full", prefetch=False,
                            warm_shapes=(PROMPT.shape,)) as server:
            toks, _ = RefEngine(server, max_seq=MAX_SEQ).generate(jnp.asarray(PROMPT), NEW_TOKENS)
        batch = _modal_batch(ref_model.cfg)
        mm_logits, fed = _reference_multimodal(ref_model, params, batch)
        rec = dict(outdir=outdir, ref_tokens=np.asarray(toks), batch=batch, fed=fed, ref_mm_logits=mm_logits,
                   ref_logits=np.asarray(jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(PROMPT)})[0]))
        rec.update(_unsharded_port(arch, outdir))
        out[arch] = rec
    return out


def _margins(model, params) -> np.ndarray:
    """(B, NEW_TOKENS) top-1 minus top-2 logit of each greedy step of the
    unsharded port (teacher-forced on its own tokens)."""
    B, S = PROMPT.shape
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": torch.from_numpy(PROMPT)})
        caches = _graft_prefill_cache(model.init_cache(B, MAX_SEQ, multimodal=False, device="cpu"),
                                      _strip_usage(caches))
        steps = [logits]
        for t in range(NEW_TOKENS - 1):
            batch = {"tokens": steps[-1].argmax(-1)[:, None], "pos": torch.full((B,), S + t)}
            logits, new = model.decode_step(params, caches, batch)
            caches = commit_decode_caches(caches, new)
            steps.append(logits)
    top2 = torch.stack(steps, 1).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def _unsharded_port(arch: str, outdir: str) -> dict:
    model = _port_model(arch)
    res = analyze(model, DeploymentProfile(**PROFILE), trace_B=1, trace_S=16)
    with cold_start(model, outdir, res, residency="full", prefetch=False, warm_shapes=((*PROMPT.shape, MAX_SEQ),),
                    device="cpu") as server:
        toks, st = GenerationEngine(server, max_seq=MAX_SEQ).generate(torch.from_numpy(PROMPT), NEW_TOKENS)
        t = server.tiered
        rec = dict(tokens=toks, keys=sorted({e.key for e in t.stats.events if e.source == "fault"}),
                   faulted_bytes=st.faulted_bytes, raw={k: t.unit_charge(k) for k in t._all_units}, res=res)
        t.ensure_all()
        params = tree_map(lambda x: x.clone(), t.tree())
    rec["margins"] = _margins(model, params)
    return rec


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _multimodal_sharded(model, params: dict, batch: dict, fed: list, comm) -> list:
    """The multimodal prefill on this rank's blocks of ``params`` (whole
    arrays) and ``batch``, its caches grafted as prefixes into the rank's
    blocks of zero decode caches of MAX_SEQ (``graft_block``, cross K/V
    included), then a decode step for each of ``fed``'s (B,) tokens. Returns
    each step's whole (B, V) logits."""
    B, S = batch["tokens"].shape
    mesh = MeshShape(tuple(comm.sizes), tuple(comm.sizes.values()))
    specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(), mesh))
    p = cut_tree(params, specs, comm)
    rows = cut_tree(batch, act_specs(model.batch_axes(batch, "prefill"), batch, comm), comm)
    head = model.logits_table(p).split(0)

    def whole(logits, dims):
        return gather_axis(gather_axis(logits, 1, head, comm), 0, dims, comm)

    def layout(S_: int):
        return act_specs(model.cache_axes(B, S_, multimodal=True), model.abstract_cache(B, S_, multimodal=True), comm)

    with torch.inference_mode():
        logits, small = model.prefill_sharded(p, rows, comm)
        out = [whole(logits, rows["tokens"].split(0))]
        big_specs, big_abs = layout(MAX_SEQ), model.abstract_cache(B, MAX_SEQ, multimodal=True)
        caches = _zip_map(lambda leaf, spec: torch.zeros(block_of(leaf, spec, comm).shape, dtype=leaf.dtype),
                          big_abs, big_specs)
        fs, fb = dict(flatten_with_paths(layout(S))), dict(flatten_with_paths(big_specs))
        fa, fc = dict(flatten_with_paths(big_abs)), dict(flatten_with_paths(caches))
        for path, blk in flatten_with_paths(small):
            graft_block(fc[path], fb[path], fa[path].shape, blk, fs[path], global_shape(blk.shape, fs[path], comm),
                        comm)
        for t, tok in enumerate(fed):
            step = {"tokens": torch.as_tensor(tok)[:, None], "pos": torch.full((B,), S + t)}
            drows = cut_tree(step, act_specs(model.batch_axes(step, "decode"), step, comm), comm)
            logits, new = model.decode_step_sharded(p, caches, drows, comm, big_specs)
            caches = commit_decode_caches(caches, new)
            out.append(whole(logits, drows["tokens"].split(0)))
    return out


def _serve_rank(rank: int, world: tuple, init: str, served: dict, result_path: str) -> None:
    """One rank of a ``world`` (data, model) mesh: serve each arch text-only
    from its artifact directory with the unsharded port's analysis and run
    its multimodal prefill and decode steps (``served``: arch -> (directory,
    analysis, modal batch, fed tokens)); rank 0 writes what the tests
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
        for arch, (outdir, res, batch, fed) in served.items():
            model = _port_model(arch)
            with cold_start(model, outdir, res, residency="full", prefetch=False,
                            warm_shapes=((*PROMPT.shape, MAX_SEQ),), mesh=mesh, device="cpu") as server:
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
            leaves = dict(np.load(os.path.join(outdir, "leaves.npz")))
            r["mm_logits"] = [lg.tolist() for lg in _multimodal_sharded(
                model, params_from_numpy(leaves, "cpu"), {k: torch.from_numpy(v) for k, v in batch.items()}, fed,
                DistComm(mesh))]
            rec[arch] = r
        rec["full_tensor_calls"] = len(full_calls)
        if rank == 0:
            with open(result_path, "w") as f:
                json.dump(rec, f)
    finally:
        DTensor.full_tensor = full_tensor
        dist.destroy_process_group()


_RESULTS: dict = {}


@pytest.fixture
def world_result(apps, tmp_path_factory):
    """The spawn of one world, run once for every test that reads it."""
    def get(world):
        if world not in _RESULTS:
            tmp = tmp_path_factory.mktemp("x".join(map(str, world)))
            path = str(tmp / "rank0.json")
            served = {a: (apps[a]["outdir"], apps[a]["res"], apps[a]["batch"], apps[a]["fed"]) for a in ARCHS}
            mp.spawn(_serve_rank, args=(world, f"file://{tmp / 'rendezvous'}", served, path),
                     nprocs=world[0] * world[1])
            with open(path) as f:
                _RESULTS[world] = json.load(f)
        return _RESULTS[world]
    return get


def _first_tie(margins: np.ndarray) -> int:
    """The first step at which some row's margin is within LOGIT_TOL (the
    steps' count when none is)."""
    ties = np.nonzero((margins <= LOGIT_TOL).any(axis=0))[0]
    return int(ties[0]) if len(ties) else margins.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: "x".join(map(str, w)))
def test_sharded_modal_families_match_the_reference(world, arch, apps, world_result):
    """Text-only serving: tokens and prefill logits against the reference's
    unsharded run; fault keys, raw bytes and per-shard charges against the
    unsharded port's; no whole-tree gather, and collectives on every
    sharded run. Multimodal: the sharded prefill and each decode step's
    logits against the reference's."""
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
    assert len(r["mm_logits"]) == DECODE_STEPS + 1
    for step, (got_l, ref_l) in enumerate(zip(r["mm_logits"], a["ref_mm_logits"])):
        np.testing.assert_allclose(np.asarray(got_l), ref_l, rtol=0, atol=LOGIT_TOL, err_msg=f"step {step}")


@pytest.mark.parametrize("arch,model_ranks", [("xlstm-125m", 4), ("whisper-base", 8)])
def test_heads_model_does_not_divide_match_the_unsharded_port(arch, model_ranks):
    """``model`` ranks that do not divide the heads, in one process
    (``run_ranks``, one thread a rank): reduced xLSTM's 2 heads on 4 ranks
    (every rank runs both heads of the mLSTM and sLSTM recurrences, its
    channels of the projections), reduced Whisper's 4 on 8 (the attention
    weights gathered over ``model``, every rank runs every head). The
    multimodal prefill and three decode steps of every rank, put together,
    equal the unsharded port's within LOGIT_TOL."""
    model = _port_model(arch)
    params = model.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _modal_batch(model.cfg).items()}
    B, S = PROMPT.shape
    with torch.inference_mode():
        logits, caches = model.prefill(params, batch)
        caches = _graft_prefill_cache(model.init_cache(B, MAX_SEQ, multimodal=True, device="cpu"), caches)
        want, fed = [logits], []
        for t in range(DECODE_STEPS):
            fed.append(want[-1].argmax(-1))
            logits, new = model.decode_step(params, caches, {"tokens": fed[-1][:, None], "pos": torch.full((B,), S + t)})
            caches = commit_decode_caches(caches, new)
            want.append(logits)
    assert model.cfg.num_heads % model_ranks
    ranks = run_ranks({"data": 1, "model": model_ranks}, lambda comm: _multimodal_sharded(model, params, batch, fed, comm))
    for out in ranks:  # every rank holds the whole logits
        for step, (got, ref) in enumerate(zip(out, want)):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=LOGIT_TOL, err_msg=f"step {step}")
