#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build — print the card's name and power limit, compile the flash-attention
   kernel from ``src/repro_torch/kernels/flash_attention/csrc`` with nvcc.
2. kernel — the kernel against its plain PyTorch version on the card, bf16,
   Mixtral-8x22B attention widths (H=48, Hkv=8, hd=128), at the served
   prefill's shape and at two longer ones; max abs error ≤ 1e-2 (bf16 output
   rounding of unit-scale values). Times with CUDA events: kernel, plain
   version, and ``F.scaled_dot_product_attention`` on the same function
   (``is_causal``, or a boolean mask where the window cuts; the port never
   calls it).
3. serve — Mixtral-8x22B at full width, depth cut from 56 to 2 layers, bf16
   weights from a seeded ``torch.Generator``: analyze → build_artifact →
   cold_start(after2, strict) → generate (B=2, prompt 1024, 16 new tokens).
   Launch counts are zeroed just before and read just after; every prefill
   of the run must have gone through the kernel in both layers. One more
   prefill of the same live weights through the plain attention checks the
   kernel path's logits.

The last lines: ``nvidia-smi`` name and power limit, a JSON line with the
kernels' numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent

# published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# bf16 keeps 8 significant bits, so rounding an output of magnitude m costs
# up to m·2^-9 (P·V from bf16 P adds about as much): the limit is 1e-2 per
# unit of max(1, |plain output|), i.e. 1e-2 absolute at unit-scale values
KERNEL_TOL = 1e-2
# served prefill: bf16 logits of O(1) after two layers whose attention
# outputs differ by bf16 rounding (kernel: P·V from bf16 P; plain: fp32)
LOGITS_TOL = 5e-2

H, HKV, HD = 48, 8, 128  # Mixtral-8x22B attention widths
PROMPT, NEW_TOKENS, BATCH, LAYERS = 1024, 16, 2, 2


def _gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one (batch, head)."""
    total = 0
    for q in range(Sq):
        hi = min(Sk - 1, q) if causal else Sk - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def kernel_phase(fa_ops) -> list[dict]:
    import torch
    import torch.nn.functional as F

    shapes = [  # (B, S, window) — the served prefill first
        (BATCH, PROMPT, 4096),
        (1, 8192, 4096),
        (2, 2048, None),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for B, S, window in shapes:
        q = torch.randn(B, S, H, HD, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(B, S, HKV, HD, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(B, S, HKV, HD, generator=gen, device="cuda").to(torch.bfloat16)
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = fa_ops.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, window=window)
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        scaled = (diff / ref.abs().clamp_min(1.0)).max().item()
        del ref, diff
        if not scaled <= KERNEL_TOL:
            raise AssertionError(f"kernel vs plain at B={B} S={S} window={window}: max abs err {err}, "
                                 f"{scaled} per unit of output magnitude")
        ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True, window=window), iters=20)
        qf, kf, vf = q.float(), k.float(), v.float()
        plain_ms = _time_ms(lambda: fa_ops.flash_attention_plain(qf, kf, vf, causal=True, window=window),
                            iters=3, warmup=1)
        del qf, kf, vf
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None or window >= S:  # the window cuts nothing: plain causal attention
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
        else:  # causal sliding window as a boolean mask, built outside the timed calls
            pos = torch.arange(S, device="cuda")
            rel = pos[:, None] - pos[None, :]
            mask = (rel >= 0) & (rel < window)
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5, warmup=1)
            del pos, rel, mask
        del qt, kt, vt
        flops = 4 * B * H * HD * _pairs(S, S, True, window)
        nbytes = 2 * (2 * B * S * H * HD + 2 * B * S * HKV * HD)  # q, o, k, v once each
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        rows.append(dict(B=B, S=S, window=window, max_abs_err=err, max_scaled_err=scaled, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes"))
        print(f"[kernel] B={B} S={S} window={window}: max_abs_err={err:.3g} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms} ms, bound {rows[-1]['bound_ms']:.4f} ms "
              f"({rows[-1]['bound_by']})", flush=True)
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def serve_phase(fa_ops, workdir: Path) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.serving import GenerationEngine, cold_start

    cfg = get_config("mixtral-8x22b").replace(num_layers=LAYERS, collect_moe_usage=True)
    model = build_model(cfg, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} at full width, {LAYERS} of 56 layers, bf16 weights made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    artifact = workdir / "artifact"
    shutil.rmtree(artifact, ignore_errors=True)
    warm_shapes = ((BATCH, PROMPT),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(7)).cuda()

    fa_ops.flash_attention.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    result = analyze(model, profile, trace_B=1, trace_S=32)
    t1 = time.perf_counter()
    meta = build_artifact(params, result, str(artifact), compress_level=1)
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = cold_start(model, str(artifact), result, residency="strict", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=PROMPT + NEW_TOKENS + 8)
    t3 = time.perf_counter()
    out, stats = engine.generate(tokens, NEW_TOKENS)
    t4 = time.perf_counter()
    launches = fa_ops.flash_attention.launches  # the main path ends here
    peak = torch.cuda.max_memory_allocated()

    tiered = server.tiered
    prefill_runs = len(warm_shapes) + stats.prefill_runs
    by_phase = {}  # loads per request phase; fetch_s sums overlap across decode threads
    for e in tiered.stats.events:
        ph = by_phase.setdefault(e.phase, dict(loads=0, bytes=0, fetch_s=0.0, install_s=0.0))
        ph["loads"] += 1
        ph["bytes"] += e.nbytes
        ph["fetch_s"] += e.fetch_s
        ph["install_s"] += e.upload_s
    summary = dict(
        analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3,
        plan=result.summary(), tier1_compressed_bytes=meta["tier1_compressed_bytes"],
        cold_start=server.report.to_dict(),
        budget_bytes=tiered.residency.budget_bytes,
        faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes,
        fault_s=stats.fault_s, prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        prefill_retries=stats.prefill_retries, decode_retries=stats.decode_retries,
        loads=len(tiered.stats.events), evictions=tiered.stats.evictions,
        evicted_bytes=tiered.stats.evicted_bytes, refaults=tiered.stats.refaults,
        overshoots=tiered.residency.overshoot_events,
        max_resident_bytes=tiered.residency.max_resident_bytes,
        peak_device_bytes=peak, flash_launches=launches, prefill_runs=prefill_runs,
        loads_by_phase=by_phase,
    )
    print("[serve] " + json.dumps(summary, default=str), flush=True)
    if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generated ids: shape {out.shape}, range [{out.min()}, {out.max()}]")
    if stats.faulted_units <= 0:
        raise AssertionError("the strict cold start faulted nothing")
    if launches < LAYERS * prefill_runs:
        raise AssertionError(f"flash kernel launched {launches} times for {prefill_runs} prefill runs "
                             f"of {LAYERS} layers")

    # the same weights through the plain attention: every unit this prompt
    # can touch is faulted in and pinned, so neither run sees placeholders
    keys = engine.row_keys_for(tokens.cpu().numpy()) + [
        u.key for d in result.plan.decisions.values() if d.granularity == "expert" for u in d.units]
    tiered.ensure(keys, pin=True)
    live = server.live_params()
    try:
        with torch.inference_mode():
            logits_kernel = model.prefill(live, {"tokens": tokens})[0].float()
            with mock.patch.object(attn_mod, "flash_attention", fa_ops.flash_attention_plain):
                logits_plain = model.prefill(live, {"tokens": tokens})[0].float()
    finally:
        tiered.release(keys)
    if not torch.isfinite(logits_kernel).all():
        raise AssertionError("non-finite logits on the kernel path")
    diff = (logits_kernel - logits_plain).abs().max().item()
    scale = logits_plain.abs().max().item()
    agree = (logits_kernel.argmax(-1) == logits_plain.argmax(-1)).float().mean().item()
    print(f"[serve] prefill logits kernel vs plain attention: max abs diff {diff:.4g} "
          f"(max |logit| {scale:.4g}), argmax agreement {agree:.2f}", flush=True)
    if not diff <= LOGITS_TOL:
        raise AssertionError(f"kernel-path logits differ from the plain path by {diff}")
    server.close()
    shutil.rmtree(artifact, ignore_errors=True)
    summary["logits_max_abs_diff"] = diff
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        from repro_torch.kernels.flash_attention import ops as fa_ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})", file=sys.stderr)
        return 2

    gpu = _gpu_line()
    print(f"[build] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    path, log = fa_ops.build()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)

    rows = kernel_phase(fa_ops)
    workdir = REPO / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    summary = serve_phase(fa_ops, workdir)

    main_row = rows[0]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": summary["flash_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
