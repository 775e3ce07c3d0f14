"""Quickstart on the PyTorch port: the FaaSLight pipeline on one model.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a reduced Mixtral, runs the Program Analyzer (entry recognition →
reachability → tier plan), writes the two-tier artifact, cold-starts a
server in after2 mode under the stats policy (half of tier-1 on the device,
the prefetcher on), and serves a request that faults experts in on demand.
The reduced config's head_dim is widened from 16 to 64, the smallest that
the CUDA flash-attention kernel takes, so the script runs on the card (the
default) and on the CPU alike.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_reduced
from repro_torch.core import DeploymentProfile, analyze, build_artifact
from repro_torch.models import build_model
from repro_torch.serving import GenerationEngine, cold_start
from repro_torch.utils.tree import flatten_with_paths

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
device = ap.parse_args().device

# 1. the application: a MoE FaaS-style model service
cfg = get_reduced("mixtral-8x22b").replace(head_dim=64, collect_moe_usage=True)
model = build_model(cfg)
print(f"model: {cfg.name}, {sum(t.numel() for _, t in flatten_with_paths(model.abstract())):,} params")

# 2. Program Analyzer: what does this deployment actually need at cold start?
profile = DeploymentProfile(resident_experts=1, hot_vocab_fraction=0.25,
                            min_tier1_bytes=1024, vocab_row_group=128)
result = analyze(model, profile)
s = result.plan.summary()
total = s["tier0_bytes"] + s["tier1_bytes"]
print(f"tier plan: {s['tier1_leaves']}/{s['leaves']} leaves deferred, "
      f"cold-resident {s['cold_resident_bytes']:,} / {total:,} bytes "
      f"({100 * s['cold_resident_bytes'] / total:.0f}%)")

# 3. Code Generator: write the two-tier deployment package
params = model.init(torch.Generator(device).manual_seed(0), device=device)
outdir = tempfile.mkdtemp(prefix="faaslight_quickstart_torch_")
build_artifact(params, result, outdir)
print("artifact:", sorted(os.listdir(outdir)))

# 4. cold start: tier-0 eager, tier-1 placeholders + the hot set, prefetcher on
with cold_start(model, outdir, result, residency="stats", warm_shapes=((2, 8, 32),), device=device) as server:
    r = server.report
    print(f"cold start: read {r.read_s * 1e3:.1f}ms, upload {r.upload_s * 1e3:.1f}ms, "
          f"compile {r.compile_s * 1e3:.1f}ms")

    # 5. serve: misses fault in on demand (rewrite_template semantics)
    engine = GenerationEngine(server, max_seq=32)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1)).to(device)
    tokens, stats = engine.generate(prompt, 6)
    print(f"generated {tokens.shape}; faulted {stats.faulted_units} units "
          f"({stats.faulted_bytes / 2**20:.2f} MiB) in {stats.fault_s * 1e3:.1f}ms; "
          f"{stats.prefetch_hits} prefetch hits; "
          f"resident fraction now {server.tiered.resident_fraction():.2f}")
    print("tokens:", tokens.tolist())
