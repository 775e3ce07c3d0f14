"""Before / after1 / after2 cold starts side by side on the PyTorch port
(paper Table 2 in miniature), on a MoE and a dense model.

    PYTHONPATH=src python examples/cold_start_comparison_torch.py [--device cpu]

Each reduced config's head_dim is widened to 64, the smallest that the CUDA
flash-attention kernel takes, so the script runs on the card (the default)
and on the CPU alike. Every mode serves the same weights, so the greedy
tokens agree across the three.
"""

import argparse
import tempfile

import torch

from repro_torch.configs import get_reduced
from repro_torch.core import DeploymentProfile, analyze, build_artifact, write_monolithic
from repro_torch.models import build_model
from repro_torch.optim import init_adamw
from repro_torch.serving import GenerationEngine, cold_start

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
device = ap.parse_args().device

for arch in ("mixtral-8x22b", "yi-34b"):
    cfg = get_reduced(arch)
    cfg = cfg.replace(head_dim=64, collect_moe_usage=cfg.moe is not None)
    model = build_model(cfg)
    profile = DeploymentProfile(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1 << 12,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    result = analyze(model, profile)
    params = model.init(torch.Generator(device).manual_seed(0), device=device)
    opt = init_adamw(params)
    outdir = tempfile.mkdtemp(prefix=f"faaslight_torch_{arch}_")
    coll = {"params": params, "opt_state": {"m": opt.m, "v": opt.v}}
    write_monolithic(coll, outdir)
    write_monolithic(coll, outdir, pruned=True)
    build_artifact(params, result, outdir)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1)).to(device)

    print(f"\n=== {arch} ===")
    base = None
    for mode in ("before", "after1", "after2"):
        with cold_start(model, outdir, result if mode == "after2" else None, mode=mode,
                        warm_shapes=((2, 8, 24),), device=device) as s:
            r = s.report
            base = base or r.total_s
            tokens, _ = GenerationEngine(s, max_seq=24).generate(prompt, 4)
        print(f"  {mode:7s} read={r.read_s * 1e3:7.1f}ms upload={r.upload_s * 1e3:7.1f}ms "
              f"compile={r.compile_s * 1e3:7.1f}ms total={r.total_s * 1e3:8.1f}ms "
              f"({100 * (1 - r.total_s / base):+5.1f}%) bytes_read={r.bytes_read:,} "
              f"tokens={tokens.tolist()}")
