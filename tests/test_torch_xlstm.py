"""xLSTM in the PyTorch port against the JAX reference, on the CPU at
float32 with the reduced config (d_model 64, chunk 16) and reference weights
carried over by ``convert.params_from_numpy``:

  * ``mlstm_scan``, ``mlstm_chunkwise`` and ``slstm_cell`` on seeded inputs,
    with and without an incoming state;
  * the port's chunkwise stabilizer ``m`` bit for bit against its own scan's;
  * each block's forward and decode, caches included;
  * the model's prefill and decode at a scan prompt (19; the chunkwise
    prompt, 32, is in tests/test_torch_models.py);
  * serving: the reduced launcher under strict gives the reference engine's
    tokens and faults on the same weights, at a chunkwise and a scan prompt,
    with the reference launcher's plan; one arrival script through both
    schedulers gives the same tokens, ``RequestStats`` and
    ``SchedulerStats``; the decode state (fp32) survives the engine's graft
    and commit whole;
  * ``params_from_numpy`` carries the reference's xLSTM tree unchanged.

Tolerance: 256 float32 eps (absolute and relative), the models' parity
tolerance: the two frameworks' reduction orders differ by O(10) ulps."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import DeploymentProfile as RefProfile
from repro.core import analyze as ref_analyze
from repro.core import build_artifact as ref_build_artifact
from repro.models import xlstm as ref_xlstm
from repro.models.zoo import build_model as ref_build_model
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import GenerationEngine as RefEngine
from repro.serving import cold_start as ref_cold_start
from repro.serving.engine import _graft_prefill_cache as ref_graft
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro.utils.tree import tree_from_flat as ref_tree_from_flat
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.models import build_model
from repro_torch.models import xlstm
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine, cold_start
from repro_torch.serving.engine import _graft_prefill_cache, commit_decode_caches
from repro_torch.utils.tree import flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm-125m"
TOL = 256 * float(np.finfo(np.float32).eps)
REQ_STATS = ("steps", "prefill_retries", "decode_retries", "faulted_units", "faulted_bytes")
SCHED_STATS = ("admitted", "completed", "rejected", "steps", "max_active", "kv_tokens_dense",
               "kv_tokens_paged", "kv_pages_high_water")


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL, err_msg=what)


@pytest.fixture(scope="module")
def models():
    """The reference's reduced xLSTM at fp32 with its seeded weights, and the
    port's model on the same weights."""
    ref_model = ref_build_model(ref_get_reduced(ARCH).replace(dtype="float32"))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {p: np.asarray(v) for p, v in ref_flatten(ref_params)}
    return ref_model, ref_params, build_model(get_reduced(ARCH).replace(dtype="float32")), \
        params_from_numpy(flat, "cpu"), flat


def _cell_inputs(B=2, S=48, H=2, hd=16, seed=0, with_state=False):
    rs = np.random.default_rng(seed)
    q, k, v = (rs.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    k = k / np.float32(np.sqrt(hd))
    log_i = rs.standard_normal((B, S, H)).astype(np.float32)
    log_f = -np.log1p(np.exp(-rs.standard_normal((B, S, H)) - 2.0)).astype(np.float32)
    state = None
    if with_state:
        state = (rs.standard_normal((B, H, hd, hd)).astype(np.float32),
                 rs.standard_normal((B, H, hd)).astype(np.float32),
                 rs.standard_normal((B, H)).astype(np.float32))
    return (q, k, v, log_i, log_f), state


def _t(tree):
    return None if tree is None else tuple(torch.from_numpy(a) for a in tree)


def _j(tree):
    return None if tree is None else tuple(jnp.asarray(a) for a in tree)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("cell", ["mlstm_scan", "mlstm_chunkwise"])
def test_mlstm_cells_match_reference(cell, with_state):
    xs, state = _cell_inputs(with_state=with_state)
    kw = {"chunk": 16} if cell == "mlstm_chunkwise" else {}
    ref_h, ref_state = getattr(ref_xlstm, cell)(*_j(xs), state=_j(state), **kw)
    h, got_state = getattr(xlstm, cell)(*_t(xs), state=_t(state), **kw)
    _close(h, ref_h, "h")
    for name, a, b in zip("Cnm", got_state, ref_state):
        _close(a, b, name)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
def test_chunkwise_stabilizer_is_the_scans_bit_for_bit(with_state):
    """The chunkwise form's ``m`` equals the scan's exactly (it is state that
    crosses chunk and request boundaries); its h and C, n agree within the
    tolerance (a different order of the same sums)."""
    xs, state = _cell_inputs(S=64, seed=3, with_state=with_state)
    h_scan, (C_s, n_s, m_s) = xlstm.mlstm_scan(*_t(xs), state=_t(state))
    h_chunk, (C_c, n_c, m_c) = xlstm.mlstm_chunkwise(*_t(xs), chunk=16, state=_t(state))
    assert torch.equal(m_c, m_s)
    _close(h_chunk, h_scan, "h")
    _close(C_c, C_s, "C")
    _close(n_c, n_s, "n")


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
def test_slstm_cell_matches_reference(models, with_state):
    ref_model, _, model, params, flat = models
    cfg = model.cfg
    p = params["groups"]["u1"]["slstm"]
    p0 = {k: v[0] for k, v in p.items()}
    ref_p0 = {k: jnp.asarray(flat[f"groups.u1.slstm.{k}"][0]) for k in p}
    rs = np.random.default_rng(5)
    x_pre = rs.standard_normal((2, 24, 4 * cfg.d_model)).astype(np.float32)
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    state = None
    if with_state:
        state = tuple(rs.standard_normal((2, H, hd)).astype(np.float32) for _ in range(4))
        state = state[:1] + (np.abs(state[1]) + 1.0,) + state[2:]  # a normalizer stays positive
    ref_h, ref_state = ref_xlstm.slstm_cell(ref_p0, jnp.asarray(x_pre), ref_model.cfg, state=_j(state))
    h, got_state = xlstm.slstm_cell(p0, torch.from_numpy(x_pre), cfg, state=_t(state))
    _close(h, ref_h, "h")
    for name, a, b in zip("cnhm", got_state, ref_state):
        _close(a, b, name)


@pytest.mark.parametrize("S", [32, 19], ids=["chunkwise", "scan"])
@pytest.mark.parametrize("kind", ["m", "s"])
def test_block_forward_and_decode_match_reference(models, kind, S):
    """One block (the reference's weights of group 0) on a seeded input:
    prefill output and cache, then three decode steps from that cache."""
    ref_model, _, model, params, flat = models
    name = "mlstm" if kind == "m" else "slstm"
    u = "u0" if kind == "m" else "u1"
    p0 = {k: v[0] for k, v in params["groups"][u][name].items()}
    ref_p0 = {k: jnp.asarray(flat[f"groups.{u}.{name}.{k}"][0]) for k in p0}
    fwd, dec = f"{name}_block_forward", f"{name}_block_decode"
    x = np.random.default_rng(11).standard_normal((2, S, model.cfg.d_model)).astype(np.float32)
    ref_y, ref_c = getattr(ref_xlstm, fwd)(ref_p0, jnp.asarray(x), ref_model.cfg)
    y, c = getattr(xlstm, fwd)(p0, torch.from_numpy(x), model.cfg)
    _close(y, ref_y, "y")
    assert set(c) == set(ref_c)
    for k in c:
        assert c[k].dtype == torch.float32 and c[k].shape == ref_c[k].shape
        _close(c[k], ref_c[k], k)
    for step in range(3):
        xt = np.random.default_rng(20 + step).standard_normal((2, 1, model.cfg.d_model)).astype(np.float32)
        ref_y, ref_c = getattr(ref_xlstm, dec)(ref_p0, jnp.asarray(xt), ref_c, ref_model.cfg)
        before = {k: v.clone() for k, v in c.items()}
        y, new = getattr(xlstm, dec)(p0, torch.from_numpy(xt), c, model.cfg)
        assert all(torch.equal(c[k], before[k]) for k in c)  # the cache given is only read
        c = new
        _close(y, ref_y, f"y step {step}")
        for k in c:
            _close(c[k], ref_c[k], f"{k} step {step}")


def test_prefill_and_decode_match_reference_at_a_scan_prompt(models):
    """The whole stack at a prompt the chunk does not divide (the scan path):
    logits and every cache leaf, then decode steps through the engine's
    graft and commit (every state leaf a new tensor, copied whole)."""
    ref_model, ref_params, model, params, _ = models
    B, S, S_max = 2, 19, 40
    tokens = np.random.default_rng(7).integers(0, 512, (B, S))
    ref_logits, ref_c = jax.jit(ref_model.prefill)(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits, c = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(logits, ref_logits)
    ref_caches = ref_graft(ref_model.init_cache(B, S_max, multimodal=False), ref_c)
    caches = _graft_prefill_cache(model.init_cache(B, S_max, multimodal=False, device="cpu"), c)
    leaves = dict(flatten_with_paths(caches))
    ref_decode = jax.jit(ref_model.decode_step)
    tok = np.argmax(np.asarray(ref_logits), -1)
    for step in range(4):
        ref_logits, ref_caches = ref_decode(ref_params, ref_caches, {
            "tokens": jnp.asarray(tok[:, None], jnp.int32), "pos": jnp.full((B,), S + step, jnp.int32)})
        logits, new = model.decode_step(params, caches, {"tokens": torch.from_numpy(tok[:, None]),
                                                        "pos": torch.full((B,), S + step)})
        assert not any(t is leaves[p] for p, t in flatten_with_paths(new))  # all carry state
        commit_decode_caches(caches, new)
        _close(logits, ref_logits)
        ref_flat = dict(ref_flatten(ref_caches))
        for p, t in flatten_with_paths(caches):
            _close(t, ref_flat[p], p)
        tok = np.argmax(np.asarray(ref_logits), -1)


def test_bf16_cache_keeps_fp32_state():
    """At the config's bf16 the state leaves stay fp32 and only the conv
    state is bf16, as the reference's abstract cache says; a bf16 prefill's
    caches graft into them with their dtypes."""
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    ref_model = ref_build_model(ref_get_reduced(ARCH))
    mine = {p: str(t.dtype).removeprefix("torch.") for p, t in
            flatten_with_paths(model.abstract_cache(2, 40, multimodal=False))}
    ref = {p: np.dtype(t.dtype).name for p, t in ref_flatten(ref_model.abstract_cache(2, 40, multimodal=False))}
    assert mine == ref
    assert {p for p, d in mine.items() if d == "bfloat16"} == {"groups.u0.conv"}
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    _, c = model.prefill(params, {"tokens": torch.randint(0, 512, (2, 32), generator=torch.Generator().manual_seed(1))})
    caches = _graft_prefill_cache(model.init_cache(2, 40, multimodal=False, device="cpu"), c)
    assert {p: str(t.dtype).removeprefix("torch.") for p, t in flatten_with_paths(caches)} == mine


def test_params_from_numpy_carries_the_reference_tree(models):
    ref_model, _, model, params, flat = models
    assert [(p, tuple(v.shape), str(v.dtype).removeprefix("torch.")) for p, v in flatten_with_paths(params)] == \
        [(p, a.shape, a.dtype.name) for p, a in flat.items()]
    for p, v in flatten_with_paths(params):
        np.testing.assert_array_equal(v.numpy(), flat[p], err_msg=p)
    assert [p for p, _ in flatten_with_paths(model.abstract())] == list(flat)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve(module, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], env=env, capture_output=True, text=True,
                          timeout=300)


def _strict(cfg):
    return dict(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                vocab_row_group=max(64, cfg.vocab_size // 16))


@pytest.mark.parametrize("S", [32, 19], ids=["chunkwise", "scan"])
def test_launcher_serves_xlstm_as_the_reference(tmp_path, S):
    """``--reduced`` xLSTM under strict at a chunkwise and a scan prompt: both
    launchers exit 0 with the same plan (20 leaves, 596,752 B of tier-0, an
    empty tier-1), and the port launcher's tokens and faults (none) are the
    reference engine's serving the port launcher's seeded weights and prompts
    (the two launchers seed their weights with different generators)."""
    B, steps = 2, 4
    argv = ["--arch", ARCH, "--reduced", "--batch", str(B), "--prompt-len", str(S), "--policy", "strict",
            "--gen-steps", str(steps)]
    res = _serve("repro_torch.launch.serve", *argv, "--device", "cpu", "--artifact-dir", str(tmp_path / "port"))
    ref = _serve("repro.launch.serve", *argv, "--artifact-dir", str(tmp_path / "ref"))
    assert res.returncode == 0, res.stderr
    assert ref.returncode == 0, ref.stderr

    def plan(out):
        return re.search(r"^\[serve\] plan: (.*)$", out, re.M).group(1)

    assert plan(res.stdout) == plan(ref.stdout)
    summary = json.loads(plan(res.stdout))
    assert (summary["leaves"], summary["tier1_leaves"], summary["tier0_bytes"]) == (20, 0, 596752)

    cfg = get_reduced(ARCH)
    params = build_model(cfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    ref_params = ref_tree_from_flat({p: v.numpy() for p, v in flatten_with_paths(params)})
    ref_model = ref_build_model(ref_get_reduced(ARCH))
    result = ref_analyze(ref_model, RefProfile(**_strict(cfg)), trace_B=1, trace_S=32)
    ref_build_artifact(ref_params, result, str(tmp_path / "same"))
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    server = ref_cold_start(ref_model, str(tmp_path / "same"), result, mode="after2", residency="strict",
                            compile_warm_set=False)
    try:
        want, stats = RefEngine(server, max_seq=S + steps + 8).generate(prompts.numpy().astype(np.int32), steps)
        ts = server.tiered.stats
        ref_faults = (stats.faulted_units, stats.faulted_bytes, ts.evictions, ts.refaults,
                      sorted({e.key for e in ts.events if e.source == "fault"}))
    finally:
        server.close()
    (line,) = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve] tokens: ")]
    assert json.loads(line[len("[serve] tokens: "):]) == np.asarray(want).tolist()
    req = json.loads(re.search(r"^\[serve\] request: (.*)$", res.stdout, re.M).group(1))
    evictions, refaults = map(int, re.search(r"; evictions (\d+); refaults (\d+);", res.stdout).groups())
    keys = json.loads(re.search(r"^\[serve\] faulted units: (.*)$", res.stdout, re.M).group(1))
    assert (req["faulted_units"], req["faulted_bytes"], evictions, refaults, keys) == ref_faults == (0, 0, 0, 0, [])


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, models):
    """The reference's strict artifact of the fp32 reduced xLSTM, and the
    port's plan for it."""
    ref_model, ref_params, model, _, _ = models
    ref_result = ref_analyze(ref_model, RefProfile(**_strict(model.cfg)), trace_B=1, trace_S=32)
    outdir = str(tmp_path_factory.mktemp("xlstm_artifact"))
    ref_build_artifact(ref_params, ref_result, outdir)
    result = analyze(model, DeploymentProfile(**_strict(model.cfg)), trace_B=1, trace_S=32)
    assert result.summary() == ref_result.summary()
    return ref_result, result, outdir


def _drive(sched) -> list:
    """Prompts of 6, 9, 16 and 32 (the last one chunkwise) and an
    over-length one, then a second wave after two loop steps."""
    rs = np.random.default_rng(4)
    first = [(6, 5), (9, 3), (32, 4), (44, 4)]
    second = [(16, 2), (9, 4)]
    reqs = [sched.submit(rs.integers(0, 512, S).astype(np.int32), n) for S, n in first]
    sched.run(max_steps=2)
    reqs += [sched.submit(rs.integers(0, 512, S).astype(np.int32), n) for S, n in second]
    sched.run()
    return reqs


@pytest.mark.parametrize("max_batch", [2, 3])
def test_scheduler_matches_reference_scheduler(models, artifact, max_batch):
    """One arrival script through both schedulers under strict: equal tokens,
    errors, per-request ``RequestStats`` and ``SchedulerStats``; the slot
    graft copies each carry-state row whole."""
    ref_model, _, model, _, _ = models
    ref_result, result, outdir = artifact
    ref_server = ref_cold_start(ref_model, outdir, ref_result, mode="after2", residency="strict",
                                compile_warm_set=False)
    try:
        ref_sched = RefScheduler(RefEngine(ref_server, max_seq=40), max_batch=max_batch)
        ref_reqs = _drive(ref_sched)
    finally:
        ref_server.close()
    with cold_start(model, outdir, result, residency="strict", compile_warm_set=False, device="cpu") as server:
        sched = ContinuousBatchingScheduler(GenerationEngine(server, max_seq=40), max_batch=max_batch)
        reqs = _drive(sched)
    assert sched.stats.rejected == 1 and sched.stats.completed == len(reqs) - 1
    for r, ref in zip(reqs, ref_reqs):
        assert r.done and r.error == ref.error
        np.testing.assert_array_equal(r.output, ref.output)
        assert [getattr(r.stats, f) for f in REQ_STATS] == [getattr(ref.stats, f) for f in REQ_STATS]
    assert [getattr(sched.stats, f) for f in SCHED_STATS] == [getattr(ref_sched.stats, f) for f in SCHED_STATS]
