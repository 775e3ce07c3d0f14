"""Mesh-sharded tiered serving in the port (``cold_start(mesh=)``,
``TieredParams(shard_divisors=)``) against the reference's contract
(tests/test_scaleout.py, DESIGN.md §15.1), on the CPU:

  * per-shard charges without a model: with a divisor attached, a faulted
    unit charges ceil(nbytes / divisor) to the budget and the arbiter while
    every IO statistic keeps raw host bytes; each number equals the
    reference's on a store the reference wrote;
  * a 1×1 mesh through ``cold_start`` is indistinguishable from no mesh:
    tokens, charged and loaded bytes, budget, and every divisor 1;
  * a 2×2 mesh over four gloo ranks (``torch.multiprocessing`` spawn, a
    ``file://`` rendezvous, no network) on an artifact the reference wrote:
    every leaf after ``ensure_all``, gathered, is bit-identical to the
    reference's unsharded tree; ``before`` and ``after2`` give the same
    tokens; the sharded replica charges less than an unsharded one; the
    divisors equal the reference's rules on the same geometry.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import HostArbiter as RefArbiter
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.core import write_monolithic as ref_write_monolithic
from repro.core.entrypoints import SERVING_PROFILE as REF_SERVING
from repro.core.on_demand import TieredParams as RefTiered
from repro.core.optional_store import OptionalStore as RefStore
from repro.core.optional_store import write_store as ref_write_store
from repro.core.partition import TierDecision as RefDecision
from repro.core.partition import TierPlan as RefPlan
from repro.core.partition import Unit as RefUnit
from repro.models.zoo import build_model as ref_build_model
from repro.optim import init_adamw as ref_init_adamw
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.sharding.rules import PARAM_RULES as REF_PARAM_RULES
from repro.sharding.rules import resolve_pspec as ref_resolve_pspec
from repro.sharding.rules import spec_shard_divisor as ref_divisor
from repro.utils.tree import flatten_axes_tree as ref_flatten_axes
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_reduced
from repro_torch.core import DeploymentProfile, HostArbiter, analyze
from repro_torch.core.on_demand import TieredParams
from repro_torch.core.optional_store import OptionalStore
from repro_torch.core.partition import TierDecision, TierPlan, Unit
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start
from repro_torch.sharding.rules import gather
from repro_torch.utils.tree import flatten_with_paths

ROWS, COLS, N_UNITS = 16, 32, 8
UNIT_BYTES = ROWS * COLS * 4
DIV = 4
CHARGE = -(-UNIT_BYTES // DIV)  # 512: the per-device share of one unit
PROFILE = dict(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1024, vocab_row_group=128)
PROMPT = np.random.default_rng(7).integers(0, 512, (1, 6))
NEW_TOKENS = 4


@pytest.fixture
def pair(tmp_path):
    """Makes the one-leaf tiered tree in both packages over one store the
    reference wrote, with an optional shard divisor on the leaf."""
    stores = []

    def make(divisor=None, budget=None, name="mini"):
        data = np.random.default_rng(0).standard_normal((N_UNITS * ROWS, COLS)).astype(np.float32)
        path = str(tmp_path / f"{name}.blob")
        keys = [(f"emb#rg{g}", (g * ROWS, (g + 1) * ROWS)) for g in range(N_UNITS)]
        ref_write_store(path, [(k, data[a:b]) for k, (a, b) in keys])
        div = None if divisor is None else {"emb": divisor}
        ref_units = tuple(RefUnit(k, "emb", rows=r, nbytes=UNIT_BYTES) for k, r in keys)
        units = tuple(Unit(k, "emb", rows=r, nbytes=UNIT_BYTES) for k, r in keys)
        ref_plan = RefPlan({"emb": RefDecision("emb", 1, "rows", "test", data.nbytes, units=ref_units)},
                           REF_SERVING, [])
        plan = TierPlan({"emb": TierDecision("emb", 1, "rows", "test", data.nbytes, units=units)},
                        DeploymentProfile(), [])
        stores.extend([RefStore(path), OptionalStore(path)])
        ref = RefTiered({"emb": jnp.zeros(data.shape, jnp.float32)}, ref_plan, stores[-2],
                        device_budget_bytes=budget, shard_divisors=div)
        mine = TieredParams({"emb": torch.zeros(data.shape)}, plan, stores[-1], device_budget_bytes=budget,
                            shard_divisors=div)
        return mine, ref, data, [u.key for u in units]

    yield make
    for st in stores:
        st.close()


def test_unit_charge_is_per_shard_bytes(pair):
    tp, ref, _, keys = pair(DIV)
    plain, ref_plain, _, _ = pair(name="plain")
    cases = [(keys[0], None), (keys[0], UNIT_BYTES), (keys[0], 1)]
    got = [tp.unit_charge(k, nbytes=n) for k, n in cases] + [plain.unit_charge(keys[0])]
    want = [ref.unit_charge(k, nbytes=n) for k, n in cases] + [ref_plain.unit_charge(keys[0])]
    assert got == want == [CHARGE, CHARGE, 1, UNIT_BYTES]  # ceil: never rounded down to free


def test_fault_charges_shard_but_reports_raw_bytes(pair):
    tp, ref, data, keys = pair(DIV)
    got = [tp.ensure(keys[:2]), ref.ensure(keys[:2])]
    assert got == [2 * UNIT_BYTES] * 2  # IO statistics stay raw host bytes...
    for t in (tp, ref):
        assert t.stats.request_fault_bytes == 2 * UNIT_BYTES
        assert [e.nbytes for e in t.stats.events] == [UNIT_BYTES] * 2
        # ...while the residency ledger holds per-device charges
        assert t.residency.resident_bytes == t.residency.charged_bytes() == 2 * CHARGE
    np.testing.assert_array_equal(tp.leaf("emb")[:ROWS].numpy(), data[:ROWS])


def test_budget_counts_shard_charges(pair):
    """A budget of 3 shares holds 3 units whose raw bytes would blow a
    raw-byte budget of the same size three times over; a fourth evicts one."""
    tp, ref, _, keys = pair(DIV, budget=3 * CHARGE)
    for batch in (keys[:3], keys[3:4]):
        tp.ensure(batch)
        ref.ensure(batch)
        assert tp.resident_keys == ref.resident_keys and len(tp.resident_keys) == 3
        assert tp.residency.resident_bytes == ref.residency.resident_bytes == 3 * CHARGE
        assert tp.stats.evictions == ref.stats.evictions


def test_arbiter_pools_shard_charges_across_tenants(pair):
    """A sharded tenant's make-room requests are in charge units, so it
    packs divisor-times more units per host byte, in both packages."""
    audits = []
    for pkg in ("port", "ref"):
        mine, ref, _, keys = pair(DIV, name=f"s-{pkg}")
        pmine, pref, _, _ = pair(name=f"p-{pkg}")
        sharded, plain = (mine, pmine) if pkg == "port" else (ref, pref)
        arb = (HostArbiter if pkg == "port" else RefArbiter)(4 * UNIT_BYTES)
        arb.register("sharded", sharded, share=0.5)
        arb.register("plain", plain, share=0.5)
        plain.ensure(keys[:2])    # 2 * 2048 raw
        sharded.ensure(keys[:6])  # 6 * 512 charged
        audits.append(arb.audit())
    a = audits[0]
    assert a["tenants"]["plain"]["resident_bytes"] == 2 * UNIT_BYTES
    assert a["tenants"]["sharded"]["resident_bytes"] == 6 * CHARGE
    assert a["resident_bytes"] == 2 * UNIT_BYTES + 6 * CHARGE and a["over_budget"] == 0
    for k in ("resident_bytes", "over_budget", "budget_bytes"):
        assert audits[0][k] == audits[1][k], k
    for t in ("plain", "sharded"):
        assert audits[0]["tenants"][t]["resident_bytes"] == audits[1]["tenants"][t]["resident_bytes"]


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    """Reduced Mixtral at fp32 with the reference's weights: its monolithic
    bundle and its two-tier artifact, as the reference wrote them."""
    ref_cfg = ref_get_reduced("mixtral-8x22b").replace(collect_moe_usage=True, dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    ref_res = ref_analyze(ref_model, RefProfile(**PROFILE), trace_B=1, trace_S=16)
    params = ref_model.init(jax.random.PRNGKey(0))
    outdir = str(tmp_path_factory.mktemp("scaleout"))
    opt = ref_init_adamw(params)
    ref_write_monolithic({"params": params, "opt_state": {"m": opt.m, "v": opt.v}}, outdir)
    ref_build_artifact(params, ref_res, outdir)
    return ref_model, ref_res, outdir


def _port_app():
    cfg = get_reduced("mixtral-8x22b").replace(collect_moe_usage=True, dtype="float32")
    model = build_model(cfg)
    return model, analyze(model, DeploymentProfile(**PROFILE), trace_B=1, trace_S=16)


@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_mesh_is_indistinguishable_from_no_mesh(app, world_of_one):
    """1×1 through ``cold_start`` (strict): the tokens, charged bytes, loaded
    bytes and preset budget of the run with no mesh (and of the
    reference's), every divisor 1."""
    ref_model, ref_res, outdir = app
    model, res = _port_app()
    runs = {}
    for label, mesh in (("plain", None), ("mesh", make_debug_mesh(1, 1, device="cpu"))):
        with cold_start(model, outdir, res, residency="strict", warm_shapes=((1, 6),), mesh=mesh,
                        device="cpu") as server:
            out, _ = GenerationEngine(server, max_seq=16).generate(torch.from_numpy(PROMPT), NEW_TOKENS)
            t = server.tiered
            runs[label] = dict(out=out.tolist(), charged=t.residency.charged_bytes(),
                               loaded=t.stats.total_loaded_bytes, budget=t.residency.budget_bytes,
                               divs=dict(t._shard_div), kind=server.entry_kind)
    with ref_cold_start(ref_model, outdir, ref_res, residency="strict", warm_shapes=((1, 6),)) as server:
        out, _ = RefEngine(server, max_seq=16).generate(jnp.asarray(PROMPT), NEW_TOKENS)
        t = server.tiered
        ref = dict(out=np.asarray(out).tolist(), charged=t.residency.charged_bytes(),
                   loaded=t.stats.total_loaded_bytes, budget=t.residency.budget_bytes)
    assert runs["plain"]["divs"] == {} and runs["mesh"]["divs"]
    assert set(runs["mesh"]["divs"].values()) == {1}
    for k in ("out", "charged", "loaded", "budget"):
        assert runs["plain"][k] == runs["mesh"][k] == ref[k], k
    assert runs["plain"]["kind"] == runs["mesh"]["kind"] == "eager"  # the CPU's entries


def _two_by_two_rank(rank: int, init: str, outdir: str, result_path: str) -> None:
    """One of four ranks: serve the reference's artifact on a 2×2 mesh in
    before and after2, resolve every unit, and (rank 0) write the gathered
    tree, tokens, charges and divisors."""
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    try:
        mesh = make_debug_mesh(2, 2, device="cpu")
        model, res = _port_app()
        rec = {}
        for label, mode in (("mesh-full", "before"), ("mesh", "after2")):
            with cold_start(model, outdir, res if mode == "after2" else None, mode=mode, warm_shapes=((1, 6),),
                            mesh=mesh, device="cpu") as server:
                out, _ = GenerationEngine(server, max_seq=16).generate(torch.from_numpy(PROMPT), NEW_TOKENS)
                rec[label] = out.tolist()
                if server.tiered is not None:
                    server.tiered.ensure_all()
                    rec["charged"] = server.tiered.residency.charged_bytes()
                    rec["divs"] = dict(server.tiered._shard_div)
                    rec["kind"] = server.entry_kind
                    tree = {p: gather(v).numpy() for p, v in flatten_with_paths(server.tiered.tree())}
        if rank == 0:
            np.savez(result_path + ".npz", **tree)
            with open(result_path + ".json", "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def test_two_by_two_mesh_keeps_bytes_and_tokens(app, tmp_path):
    ref_model, ref_res, outdir = app
    # the reference's unsharded tree, every unit resolved
    with ref_cold_start(ref_model, outdir, ref_res, warm_shapes=((1, 6),)) as server:
        server.tiered.ensure_all()
        ref_tree = {p: np.asarray(v) for p, v in ref_flatten(server.tiered.tree())}
    # the port unsharded: what one replica is charged without a mesh
    model, res = _port_app()
    with cold_start(model, outdir, res, warm_shapes=((1, 6),), device="cpu") as server:
        server.tiered.ensure_all()
        plain_charged = server.tiered.residency.charged_bytes()
    # the reference's rules on the same geometry, leaf by leaf
    geometry = SimpleNamespace(axis_names=("data", "model"), devices=np.zeros((2, 2)))
    axes = dict(ref_flatten_axes(ref_model.logical_axes()))
    ref_divs = {p: ref_divisor(ref_resolve_pspec(axes[p], leaf.shape, geometry, REF_PARAM_RULES), geometry)
                for p, leaf in ref_flatten(ref_model.abstract())}

    result = str(tmp_path / "rank0")
    mp.spawn(_two_by_two_rank, args=(f"file://{tmp_path / 'rendezvous'}", outdir, result), nprocs=4)
    with open(result + ".json") as f:
        rec = json.load(f)
    tree = np.load(result + ".npz")
    assert rec["divs"] == ref_divs and all(d > 1 for d in rec["divs"].values()), rec["divs"]
    assert sorted(tree.files) == sorted(ref_tree)
    for p, want in ref_tree.items():  # sharded load and faults are lossless
        np.testing.assert_array_equal(tree[p], want, err_msg=p)
    assert rec["mesh-full"] == rec["mesh"]  # mode parity within the geometry
    assert rec["charged"] < plain_charged  # the sharded replica charges its share
    assert rec["kind"] == "eager"
