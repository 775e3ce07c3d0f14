"""The port's one-shot serve launcher (``python -m repro_torch.launch.serve``)
on the CPU under each policy and each cold-start mode: it exits 0, prints the
reference's ``[serve]`` lines and the same greedy tokens in every run (same
seeded weights and prompt), and argparse refuses a bogus policy and the
reference's unported flags. Its stats profile reads the synthetic token
pipeline, which gives the reference's tokens and row-group stats."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro_torch.data import DataConfig, SyntheticTokenPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    ["--concurrency", "4"],          # traffic mode is not ported
    ["--host-budget-bytes", "1024"],  # nor the host arbiter
    ["--fleet", "2"],
])
def test_launcher_refuses_bad_and_unported_flags(argv):
    res = _serve("--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", *argv)
    assert res.returncode == 2
    assert "error:" in res.stderr


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
