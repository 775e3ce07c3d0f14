"""The port's serve launcher (``python -m repro_torch.launch.serve``) on the
CPU. One-shot, under each policy and each cold-start mode: it exits 0, prints
the reference's ``[serve]`` lines and the same greedy tokens in every run
(same seeded weights and prompt). Traffic mode (``--concurrency``): every
request finishes with the tokens of its own ``generate()`` on the artifact
the launcher wrote. argparse refuses a bogus policy and bad traffic flags,
refuses the host-arbiter, online re-tiering, snapshot, fleet and mesh flags
where the reference refuses them (a mesh of more than one rank in one
process, a malformed geometry), and ``--mesh 1x1`` serves as no mesh does. With
``--retier-online --host-budget-bytes`` both launchers print the reference's
``[serve] host arbiter:`` and ``[serve] online retier:`` lines, with the same
tick counts. Its stats profile reads the synthetic token pipeline, which
gives the reference's tokens and row-group stats. Reduced Gemma-3,
DeepSeek-V2-Lite, Whisper and Llama-3.2-Vision: both launchers print the
same plan, and the port's tokens and fault counts are the reference engine's
on the same weights."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro_torch.configs import get_reduced
from repro_torch.core import DeploymentProfile, analyze
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.serve import traffic_prompts
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The one greedy tie of the launcher parity test: reduced Llama-3.2-Vision's
# second token of row 1 (step 1). There the reference's bf16 logits put 416
# at 1.1484375, one bf16 step (2^-7) above 330's 1.140625; the port, which
# rounds each layer's bf16 outputs in its own order, gives both 1.140625 and
# picks 330. Its sequences part from the reference's there: (row, step).
GREEDY_TIES = {"llama-3.2-vision-90b": (1, 1)}
ARGS = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
        "--gen-steps", "4"]


def _serve(*argv, cwd=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _tokens(stdout: str) -> list:
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("[serve] tokens: ")]
    return json.loads(line[len("[serve] tokens: "):])


@pytest.fixture(scope="module")
def before_tokens(tmp_path_factory):
    res = _serve(*ARGS, "--mode", "before", "--artifact-dir", str(tmp_path_factory.mktemp("before")))
    assert res.returncode == 0, res.stderr
    return _tokens(res.stdout)


@pytest.mark.parametrize("extra", [
    ["--policy", "strict"],
    ["--policy", "stats"],
    ["--policy", "full"],
    ["--policy", "stats", "--no-prefetch", "--device-budget-bytes", "200000"],
    ["--mode", "after1"],
    ["--mode", "before", "--policy", "strict"],
])
def test_launcher_serves_every_policy_and_mode(tmp_path, before_tokens, extra):
    res = _serve(*ARGS, "--artifact-dir", str(tmp_path), *extra)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    mode = extra[extra.index("--mode") + 1] if "--mode" in extra else "after2"
    report = json.loads(re.search(rf"^\[serve\] cold start \({mode}\): (.*)$", out, re.M).group(1))
    assert report["bytes_read"] > 0 and report["total_s"] > 0
    assert "[serve] generated (2, 4);" in out
    assert _tokens(out) == before_tokens  # same seeded weights and prompt in every run
    if mode == "after2":
        assert re.search(r"^\[serve\] resident fraction: ", out, re.M)
        assert re.search(r"^\[serve\] prefetch hit rate [\d.]+; evictions \d+; refaults \d+; "
                         r"stall p99 [\d.]+ms$", out, re.M)
        assert sorted(os.listdir(tmp_path / "mixtral-8x22b-reduced")) == [
            "artifact.json", "optional.blob", "optional.blob.manifest.json", "tier0.bin", "tier0.index.json"]
    else:
        assert "resident fraction" not in out
        assert sorted(os.listdir(tmp_path / "mixtral-8x22b-reduced")) == [f"{mode}.bin", f"{mode}.index.json"]


def test_launcher_cuts_depth(tmp_path):
    res = _serve(*ARGS, "--layers", "1", "--param-dtype", "bfloat16", "--artifact-dir", str(tmp_path))
    assert res.returncode == 0, res.stderr
    plan = json.loads(re.search(r"^\[serve\] plan: (.*)$", res.stdout, re.M).group(1))
    assert plan["units"] == 20  # one layer: 4 experts x 3 tables, and 8 row groups of 64


@pytest.mark.parametrize("argv", [
    ["--policy", "bogus"],
    ["--mode", "after3"],
    ["--profile-out", "t.json", "--mode", "before"],  # re-tiering needs the two-tier runtime
    ["--host-budget-bytes", "-5"],
    ["--fleet", "1"],  # a fleet federates at least 2 replicas
    ["--retier-from", "t.json", "--no-prefetch"],  # the predictor needs a prefetcher
    ["--retier-from", "t.json", "--policy", "strict"],
    ["--retier-from", "t.json", "--mode", "after1"],
])
def test_launcher_refuses_bad_and_unported_flags(argv):
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert res.returncode == 2
    assert "error:" in res.stderr


def _ref_serve(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("argv,want", [
    (["--host-budget-bytes", "-5"], "--host-budget-bytes must be >= 0"),
    (["--retier-decay", "2"], "--retier-decay must be in [0, 1]"),
    (["--retier-interval", "0"], "--retier-interval must be >= 1"),
    (["--retier-online", "--mode", "before"], "need the two-tier runtime"),
    (["--host-budget-bytes", "1024", "--mode", "after1"], "--mode after2 only"),
])
def test_launcher_refuses_arbiter_and_online_flags_as_the_reference_does(argv, want):
    ref = _ref_serve("--arch", "mixtral-8x22b", "--reduced", *argv)
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert ref.returncode == res.returncode == 2
    assert want in ref.stderr and want in res.stderr


@pytest.mark.parametrize("argv", [
    ["--profile-out", "t.json", "--mode", "after1"],
    ["--retier-from", "t.json", "--no-prefetch"],
    ["--retier-from", "t.json", "--policy", "strict"],
])
def test_launcher_refuses_retier_flags_as_the_reference_does(argv):
    """The re-tiering refusals are the reference launcher's: the same flags
    make both exit 2 with the same complaint."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", "--arch", "mixtral-8x22b", "--reduced", *argv],
                         env=env, capture_output=True, text=True, timeout=300)
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert ref.returncode == res.returncode == 2
    want = "two-tier runtime" if "--mode" in argv else "drives the predictive prefetcher"
    assert want in ref.stderr and want in res.stderr


ONLINE_RE = (r"^\[serve\] online retier: (\d+) ticks, (\d+) applies \(\+(\d+)/-(\d+) units, ([\d,]+)B evicted, "
             r"(\d+) predictor refreshes, (\d+) compactions\); zero restarts$")
ARBITER_RE = (r"^\[serve\] host arbiter: ([\d,]+)B resident / ([\d,]+)B host budget \(([\d,]+)B pinned\); "
              r"(\d+) evictions \(([\d,]+)B\), (\d+) overshoots, (\d+) prefetch headroom denials$")


def test_launcher_online_retier_under_host_arbiter(tmp_path, before_tokens):
    """Strict with ``--retier-online --retier-interval 1 --host-budget-bytes``
    in both launchers: exit 0, both new lines in each, the daemon ticked
    after the prefill and after each decode step in both with the same
    counts, resident bytes within the host budget at rest; the port's tokens
    equal those of its runs without the flags, and ``--profile-out`` saves
    the daemon's merged trace (which the reference's AccessTrace loads)."""
    from repro.core import AccessTrace as RefTrace

    flags = ["--policy", "strict", "--retier-online", "--retier-interval", "1", "--host-budget-bytes", "200000"]
    trace = str(tmp_path / "t.json")
    res = _serve(*ARGS, "--artifact-dir", str(tmp_path / "port"), *flags, "--profile-out", trace)
    assert res.returncode == 0, res.stderr
    ref = _ref_serve(*[a for a in ARGS if a not in ("--device", "cpu")], "--artifact-dir", str(tmp_path / "ref"),
                     *flags)
    assert ref.returncode == 0, ref.stderr
    assert _tokens(res.stdout) == before_tokens
    lines = {}
    for who, out in (("port", res.stdout), ("ref", ref.stdout)):
        online = re.search(ONLINE_RE, out, re.M)
        arbiter = re.search(ARBITER_RE, out, re.M)
        assert online and arbiter, (who, out)
        resident, budget = (int(arbiter.group(i).replace(",", "")) for i in (1, 2))
        assert budget == 200000 and resident <= budget and int(arbiter.group(6)) > 0  # strict overshoots mid-step
        lines[who] = [int(g) for g in online.groups()[:3]]
    assert lines["port"] == lines["ref"] and lines["port"][:2] == [4, 4]  # 4 steps: 4 ticks, 4 applies
    stats = json.loads(re.search(r"^\[serve\] online retier stats: (.*)$", res.stdout, re.M).group(1))
    assert stats["errors"] == stats["compact_errors"] == 0 and stats["invariant_checks"] == stats["applies"]
    doc = RefTrace.load(trace).to_dict()
    assert doc["version"] == 3 and doc["faults"] and doc["batches"] >= 4


def test_profile_then_retier_cycle(tmp_path):
    """``--profile-out`` under stats without the prefetcher, then
    ``--retier-from`` under stats: the trace loads in the reference's
    AccessTrace, the re-tiered artifact copies every tier-1 frame raw and is
    served with the predictor armed and its promoted hot set preloaded, and
    the tokens equal the profiling run's. An orphaned staging directory is
    removed at start."""
    from repro.core import AccessTrace as RefTrace

    trace = str(tmp_path / "t.json")
    args = [*ARGS, "--policy", "stats", "--artifact-dir", str(tmp_path)]
    prof = _serve(*args, "--no-prefetch", "--profile-out", trace)
    assert prof.returncode == 0, prof.stderr
    assert re.search(r"^\[serve\] wrote access trace to .* \(\d+ batches, \d+ faulted units", prof.stdout, re.M)
    doc = RefTrace.load(trace).to_dict()
    assert doc["version"] == 3 and doc["faults"] and doc["phase_transitions"]
    orphan = tmp_path / "mixtral-8x22b-reduced" / "crashed.partial"
    orphan.mkdir()
    res = _serve(*args, "--retier-from", trace)
    assert res.returncode == 0, res.stderr
    assert "[serve] removed 1 orphaned partial(s): crashed.partial" in res.stdout and not orphan.exists()
    summary = json.loads(re.search(r"^\[serve\] re-tiered from .* -> .*-retier: (.*)$", res.stdout, re.M).group(1))
    assert summary["promoted_resident"] > 0
    art = json.loads(re.search(r"^\[serve\] retier artifact: (.*)$", res.stdout, re.M).group(1))
    assert art["recompressed"] == 0 and art["raw_copied"] > 0
    assert re.search(r"^\[serve\] predictor: observed \d+ keys", res.stdout, re.M)
    assert sorted(os.listdir(tmp_path)) == ["mixtral-8x22b-reduced", "mixtral-8x22b-reduced-retier", "t.json"]
    assert _tokens(res.stdout) == _tokens(prof.stdout)
    # the promoted hot set is preloaded at cold start; how many bytes then
    # fault on demand depends on the prefetcher's timing (the deterministic
    # fault-byte drop is tests/test_torch_retier.py's, without a prefetcher)
    uploaded = [json.loads(re.search(r"^\[serve\] cold start \(after2\): (.*)$", r.stdout, re.M).group(1))
                ["bytes_uploaded"] for r in (prof, res)]
    assert uploaded[1] > uploaded[0]
    assert all(json.loads(re.search(r"^\[serve\] request: (.*)$", r.stdout, re.M).group(1))["faulted_bytes"] > 0
               for r in (prof, res))


def test_retier_from_a_bad_trace_fails(tmp_path):
    """A trace that does not load is an error, not an empty trace."""
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 99}')
    res = _serve(*ARGS, "--policy", "stats", "--artifact-dir", str(tmp_path), "--retier-from", str(bad))
    assert res.returncode != 0 and "[serve] tokens:" not in res.stdout
    assert "unsupported AccessTrace version 99" in res.stderr


@pytest.mark.parametrize("extra", [[], ["--admission", "slo", "--deadline-ms", "600000", "--arrival-rate", "50"]],
                         ids=["fifo", "slo"])
def test_launcher_traffic_mode_matches_solo_runs(tmp_path, extra):
    """Five requests of mixed arrival through three slots: exit 0, the
    traffic report, all five done, and each request's tokens equal its own
    generate() on the artifact the launcher wrote (same plan, same weights)."""
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--prompt-len", "8",
                 "--gen-steps", "4", "--policy", "strict", "--concurrency", "3", "--requests", "5",
                 "--artifact-dir", str(tmp_path), *extra)
    assert res.returncode == 0, res.stderr
    assert re.search(r"^\[serve\] traffic: 5/5 ok in [\d.]+s \([\d.]+ req/s over \d+ batched steps, "
                     r"max_active=3\)$", res.stdout, re.M), res.stdout
    assert re.search(r"^\[serve\] latency p50=\d+ms p99=\d+ms; ttft p50=\d+ms; step faults=\d+", res.stdout, re.M)
    stats = json.loads(re.search(r"^\[serve\] scheduler: (.*)$", res.stdout, re.M).group(1))
    assert stats["completed"] == 5 and stats["failed"] == stats["rejected"] == stats["shed"] == 0
    tokens = _tokens(res.stdout)
    cfg = get_reduced("mixtral-8x22b").replace(collect_moe_usage=True)
    model = build_model(cfg)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    result = analyze(model, profile, trace_B=1, trace_S=32)
    with cold_start(model, str(tmp_path / cfg.name), result, residency="strict", compile_warm_set=False,
                    device="cpu") as server:
        eng = GenerationEngine(server, max_seq=8 + 4 + 8)
        for got, p in zip(tokens, traffic_prompts(cfg, 5, 8)):
            solo, _ = eng.generate(torch.from_numpy(p[None]), 4)
            assert got == solo[0].tolist()


@pytest.mark.parametrize("argv", [
    ["--concurrency", "2", "--deadline-ms", "5"],  # FIFO never sheds
    ["--concurrency", "2", "--admission", "slo", "--deadline-ms", "-1"],
    ["--concurrency", "2", "--requests", "0"],
    ["--concurrency", "2", "--retier-online", "--retier-interval", "0"],
    ["--concurrency", "2", "--fleet", "2"],  # the fleet drives the one-shot path
    ["--mesh", "2x4"],  # one process holds only a 1x1 mesh
    ["--mesh", "2by4"],
])
def test_launcher_refuses_bad_traffic_and_unported_flags(argv):
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert res.returncode == 2
    assert "error:" in res.stderr


@pytest.mark.parametrize("argv,want", [
    (["--mesh", "2x4"], "needs 8"),
    (["--mesh", "2by4"], "--mesh wants DATAxMODEL (e.g. 2x4), got '2by4'"),
])
def test_launcher_refuses_mesh_geometries_as_the_reference_does(argv, want):
    ref = _ref_serve("--arch", "mixtral-8x22b", "--reduced", *argv)
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert ref.returncode == res.returncode == 2
    assert want in ref.stderr and want in res.stderr


def test_launcher_serves_a_one_rank_mesh_as_no_mesh(tmp_path):
    """``--mesh 1x1`` in one process (a world of one on an in-memory store):
    the tokens, faulted units and request line of the run with no mesh,
    every leaf's divisor 1 on the ``[serve] mesh:`` line."""
    args = [*ARGS, "--policy", "strict", "--no-prefetch"]
    plain = _serve(*args, "--artifact-dir", str(tmp_path / "plain"))
    res = _serve(*args, "--artifact-dir", str(tmp_path / "mesh"), "--mesh", "1x1")
    assert plain.returncode == res.returncode == 0, res.stderr
    assert _tokens(res.stdout) == _tokens(plain.stdout)
    for prefix in ("[serve] faulted units: ", "[serve] request: "):
        got, want = (json.loads(re.search(rf"^{re.escape(prefix)}(.*)$", r.stdout, re.M).group(1))
                     for r in (res, plain))
        if prefix == "[serve] request: ":
            got.pop("fault_s"), want.pop("fault_s")
        assert got == want, prefix
    mesh = json.loads(re.search(r"^\[serve\] mesh: (.*)$", res.stdout, re.M).group(1))
    assert mesh == {"geometry": "1x1", "ranks": 1, "divisors": {"1": mesh["divisors"]["1"]}, "entries": "eager",
                    "compute": "gathered", "collective_bytes_per_step": {"prefill": 0, "decode": 0}}
    assert "[serve] mesh:" not in plain.stdout


@pytest.mark.parametrize("argv,want", [
    (["--fleet", "1"], "at least 2 replicas"),
    (["--fleet", "2", "--mode", "after1"], "two-tier runtime"),
    (["--fleet", "2", "--concurrency", "2"], "drop --concurrency"),
    (["--fleet", "2", "--host-budget-bytes", "1024"], "composes with none of"),
    (["--fleet", "2", "--profile-out", "t.json"], "composes with none of"),
    (["--fleet", "2", "--retier-from", "t.json"], "composes with none of"),
    (["--snapshot-out", "s.json", "--mode", "before"], "--mode after2 only"),
    (["--restore-from", "s.json", "--mode", "after1"], "--mode after2 only"),
])
def test_launcher_refuses_fleet_and_snapshot_flags_as_the_reference_does(argv, want):
    ref = _ref_serve("--arch", "mixtral-8x22b", "--reduced", *argv)
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert ref.returncode == res.returncode == 2
    assert want in ref.stderr and want in res.stderr


def test_launcher_snapshot_then_restore(tmp_path, before_tokens):
    """``--snapshot-out`` after an online run (its daemon refreshes the
    predictor, so the snapshot carries one), then ``--restore-from`` on the
    artifact the second run rebuilds in the same place: both exit 0, the
    restore replays the snapshot's units with the predictor armed, and the
    tokens equal those of the runs without the flags. A snapshot of another
    artifact makes the restore run fail."""
    snap = str(tmp_path / "snap.json")  # outside the artifact directory
    art = ["--artifact-dir", str(tmp_path / "art")]
    first = _serve(*ARGS, *art, "--retier-online", "--retier-interval", "1", "--snapshot-out", snap)
    assert first.returncode == 0, first.stderr
    m = re.search(r"^\[serve\] wrote server snapshot to .*snap\.json \((\d+) resident units, predictor included\)$",
                  first.stdout, re.M)
    assert m and int(m.group(1)) > 0, first.stdout
    with open(snap) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and len(doc["resident"]) == int(m.group(1)) and doc["predictor"]
    res = _serve(*ARGS, *art, "--restore-from", snap)
    assert res.returncode == 0, res.stderr
    line = re.search(r"^\[serve\] warm restore: (\d+)/(\d+) units resident \(([\d,]+)B replayed, "
                     r"predictor armed\)$", res.stdout, re.M)
    assert line and int(line.group(1)) >= 1 and int(line.group(2)) == len(doc["resident"]), res.stdout
    report = json.loads(re.search(r"^\[serve\] restore report: (.*)$", res.stdout, re.M).group(1))
    assert report["fingerprint_ok"] is True and report["moved_bytes"] == int(line.group(3).replace(",", ""))
    cold = json.loads(re.search(r"^\[serve\] cold start \(after2\): (.*)$", res.stdout, re.M).group(1))
    assert cold["bytes_uploaded"] >= cold["bytes_read"] + report["moved_bytes"]
    assert _tokens(first.stdout) == _tokens(res.stdout) == before_tokens
    # the strict policy writes another artifact: its fingerprint differs
    other = _serve(*ARGS, "--artifact-dir", str(tmp_path / "other"), "--policy", "strict", "--restore-from", snap)
    assert other.returncode != 0 and "fingerprint mismatch" in other.stderr
    assert "[serve] tokens:" not in other.stdout


def test_launcher_fleet(tmp_path, before_tokens):
    """``--fleet 2``: exit 0; both replicas' cold start, request and tokens
    lines, a sync after each, each daemon's stats, the totals with the warm
    bootstraps' bytes (some exactly when a replica was bootstrapped); every
    replica's tokens equal the one-shot run's."""
    res = _serve(*ARGS, "--artifact-dir", str(tmp_path), "--fleet", "2")
    assert res.returncode == 0, res.stderr
    out = res.stdout
    for i in range(2):
        assert re.search(rf"^\[serve\] replica-{i} cold start: ", out, re.M)
        assert re.search(rf"^\[serve\] replica-{i} request: ", out, re.M)
        tokens = json.loads(re.search(rf"^\[serve\] replica-{i} tokens: (.*)$", out, re.M).group(1))
        assert tokens == before_tokens
        stats = json.loads(re.search(rf"^\[serve\] replica-{i} retier stats: (.*)$", out, re.M).group(1))
        assert stats["pulls"] == 2 and stats["remote_applies"] >= 1 and stats["errors"] == 0
    syncs = re.findall(r"^\[serve\] fleet sync: (\d+)/2 windows, pushed to (\d+) replicas", out, re.M)
    assert syncs == [("1", "2"), ("1", "2")]
    fleet_line = re.search(r"^\[serve\] fleet: 2 syncs, 2 replans, 4 pushes \(0 failed\), (\d+) warm bootstraps "
                           r"\(([\d,]+)B in [\d.]+s\)$", out, re.M)
    assert fleet_line and (int(fleet_line.group(2).replace(",", "")) > 0) == (int(fleet_line.group(1)) > 0)
    fs = json.loads(re.search(r"^\[serve\] fleet stats: (.*)$", out, re.M).group(1))
    assert fs["push_failures"] == fs["pull_failures"] == fs["bootstrap_failures"] == 0
    assert "[serve] cold start (after2)" not in out and "[serve] tokens:" not in out


@pytest.mark.parametrize("cfg", [(512, 16, 4, 0), (32768, 128, 8, 0), (1000, 600, 6, 3)])
def test_token_pipeline_matches_reference(cfg):
    vocab, seq, batch, seed = cfg
    ref = RefPipeline(RefDataConfig(vocab, seq, batch, seed=seed), shard=1, num_shards=2)
    port = SyntheticTokenPipeline(DataConfig(vocab, seq, batch, seed=seed), shard=1, num_shards=2)
    for step in (0, 5):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for rg in (64, 2048):
        assert port.vocab_row_stats(row_group=rg) == ref.vocab_row_stats(row_group=rg)
    with pytest.raises(ValueError, match="does not split"):
        SyntheticTokenPipeline(DataConfig(vocab, seq, batch), num_shards=5)


def _launcher_faults(stdout: str) -> tuple:
    """(faults, faulted bytes, evictions, refaults, sorted faulted unit keys)
    from a port launcher's one-shot output."""
    req = json.loads(re.search(r"^\[serve\] request: (.*)$", stdout, re.M).group(1))
    evictions, refaults = map(int, re.search(r"; evictions (\d+); refaults (\d+);", stdout).groups())
    keys = json.loads(re.search(r"^\[serve\] faulted units: (.*)$", stdout, re.M).group(1))
    return req["faulted_units"], req["faulted_bytes"], evictions, refaults, keys


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-v2-lite-16b", "whisper-base", "llama-3.2-vision-90b"])
def test_launcher_serves_gemma3_and_deepseek_as_the_reference(tmp_path, arch):
    """``--reduced`` Gemma-3, DeepSeek-V2-Lite, Whisper and Llama-3.2-Vision
    under strict: both launchers exit 0 with the same plan line (the modal
    families' text-only entries), and the port's tokens, faults, faulted
    bytes and unit keys, evictions and refaults are those of the reference's
    engine serving the port launcher's seeded weights and prompts (the two
    launchers seed their weights with different generators). No faulted key
    is the encoder's or a cross-attention's. Where the greedy sequences part
    at a bf16 tie (``GREEDY_TIES``), they must part at that step and no
    earlier, the port's token must be within one bf16 step of the reference's
    best logit there, and a launcher run cut to the steps before it must
    match the reference's engine run of as many steps exactly."""
    import jax.numpy as jnp

    from repro.configs import get_reduced as ref_get_reduced
    from repro.core import DeploymentProfile as RefProfile
    from repro.core import analyze as ref_analyze
    from repro.core import build_artifact as ref_build_artifact
    from repro.models.zoo import build_model as ref_build_model
    from repro.serving import GenerationEngine as RefEngine
    from repro.serving import cold_start as ref_cold_start
    from repro.utils.tree import tree_from_flat
    from repro_torch.utils.tree import flatten_with_paths

    B, S, steps = 2, 8, 4
    argv = ["--arch", arch, "--reduced", "--batch", str(B), "--prompt-len", str(S), "--policy", "strict"]
    res = _serve(*argv, "--gen-steps", str(steps), "--device", "cpu", "--artifact-dir", str(tmp_path / "port"))
    ref = _ref_serve(*argv, "--gen-steps", str(steps), "--artifact-dir", str(tmp_path / "ref"))
    assert res.returncode == 0, res.stderr
    assert ref.returncode == 0, ref.stderr

    def plan(out):
        return re.search(r"^\[serve\] plan: (.*)$", out, re.M).group(1)

    assert plan(res.stdout) == plan(ref.stdout)

    cfg = get_reduced(arch).replace(collect_moe_usage=get_reduced(arch).moe is not None)
    params = build_model(cfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    ref_params = tree_from_flat({p: v.numpy() for p, v in flatten_with_paths(params)})
    ref_model = ref_build_model(ref_get_reduced(arch).replace(collect_moe_usage=cfg.moe is not None))
    result = ref_analyze(ref_model, RefProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                               vocab_row_group=max(64, cfg.vocab_size // 16)), trace_B=1, trace_S=32)
    ref_build_artifact(ref_params, result, str(tmp_path / "same"))
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))

    def ref_run(n: int) -> tuple:
        """The reference engine's tokens and fault record over ``n`` steps."""
        server = ref_cold_start(ref_model, str(tmp_path / "same"), result, mode="after2", residency="strict",
                                compile_warm_set=False)
        try:
            out, stats = RefEngine(server, max_seq=S + steps + 8).generate(prompts.numpy().astype(np.int32), n)
            ts = server.tiered.stats
            keys = sorted({e.key for e in ts.events if e.source == "fault"})
            return np.asarray(out), (stats.faulted_units, stats.faulted_bytes, ts.evictions, ts.refaults, keys)
        finally:
            server.close()

    got, port_faults = np.asarray(_tokens(res.stdout)), _launcher_faults(res.stdout)
    want, ref_faults = ref_run(steps)
    assert not any(k.startswith("encoder.") or ".cross." in k for k in port_faults[4])
    # a tied table is tier-0 (Gemma-3, Whisper): nothing of their tier-1 is served
    assert (port_faults[0] > 0) == (not cfg.tie_embeddings)
    if arch not in GREEDY_TIES:
        assert got.tolist() == want.tolist()
        assert port_faults == ref_faults
        return
    row, split = GREEDY_TIES[arch]
    parted = np.argwhere(got != want)
    assert parted.size and parted[:, 1].min() == split and [row, split] in parted.tolist(), parted
    seq = np.concatenate([prompts.numpy(), got[:, :split]], axis=1).astype(np.int32)
    logits, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(seq)})
    logits = np.asarray(logits, np.float32)[row]
    best, picked = logits.max(), logits[got[row, split]]
    assert best - picked <= 2.0**-7 * abs(best), (best, picked)  # one bf16 step
    cut = _serve(*argv, "--gen-steps", str(split), "--device", "cpu", "--artifact-dir", str(tmp_path / "cut"))
    assert cut.returncode == 0, cut.stderr
    want, ref_faults = ref_run(split)
    assert _tokens(cut.stdout) == want.tolist() == got[:, :split].tolist()
    assert _launcher_faults(cut.stdout) == ref_faults
