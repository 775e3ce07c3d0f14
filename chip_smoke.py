#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build — print the card's name and power limit, compile the flash-attention
   and RG-LRU scan kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc
   (one nvcc per source, started together), print ptxas's register and
   spill lines.
2. kernel — each kernel against its plain PyTorch version on the card, at the
   shapes the served prefills give it and at a longer one:
   flash attention in bf16 at Mixtral-8x22B widths (H=48, Hkv=8, hd=128) and
   at RecurrentGemma-9B's (H=16, Hkv=1, hd=256); error ≤ 1e-2 per unit of
   max(1, |output|) (bf16 output rounding). The RG-LRU scan in fp32 at
   (B, S, W) = (2, 1024, 4096) and (1, 8192, 4096); error ≤ 1e-5 per unit of
   max(1, |s|). Times with CUDA events: kernel, plain version, and for
   attention ``F.scaled_dot_product_attention`` on the same function
   (``is_causal``, or a boolean mask where the window cuts; the port never
   calls it). No single PyTorch call computes the scan.
3. serve — Mixtral-8x22B at full width, depth cut from 56 to 2 layers, bf16
   weights from a seeded ``torch.Generator``: analyze → build_artifact →
   cold_start(after2, strict) → generate (B=2, prompt 1024, 16 new tokens).
   Launch counts are zeroed just before and read just after; every prefill
   of the run must have gone through the kernel in both layers. One more
   prefill of the same live weights through the plain attention checks the
   kernel path's logits.
4. serve — RecurrentGemma-9B at full width and full depth (38 layers: 12
   rec/rec/attn groups and a rec/rec tail), the same path and request. Its
   tier-1 is empty (tied embeddings, dense MLPs), so nothing faults. Every
   prefill run must launch the scan once per rec layer (26) and flash
   attention once per attention layer (12). One more prefill through both
   plain versions checks the kernel path's logits.

The last lines: ``nvidia-smi`` name and power limit, a JSON line with the
kernels' numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent

# published H100 SXM peaks (dense bf16 tensor-core rate, fp32 outside the
# tensor cores, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# bf16 keeps 8 significant bits, so rounding an output of magnitude m costs
# up to m·2^-9 (P·V from bf16 P adds about as much): the limit is 1e-2 per
# unit of max(1, |plain output|), i.e. 1e-2 absolute at unit-scale values
KERNEL_TOL = 1e-2
# served prefill: bf16 logits of O(1) after two layers whose attention
# outputs differ by bf16 rounding (kernel: P·V from bf16 P; plain: fp32)
LOGITS_TOL = 5e-2
# fp32 scan, kernel and plain both: the error grows with the carried
# magnitude, so 1e-5 per unit of max(1, |s|)
SCAN_TOL = 1e-5
# RecurrentGemma's served prefill, kernel vs plain path, as a fraction of the
# plain path's max |logit|. The scan agrees exactly (same fp32 roundings);
# the 12 attention layers differ by bf16 rounding (≤ 2^-8 relative), which
# walks through 38 residual blocks: a CPU rehearsal at full depth and
# d_model 512 / 1024 (bf16 weights, P rounded to bf16 as the kernel does)
# moved the final hidden state by 3.8% and the logits by 3.5-4.3% of their
# max, so 10% leaves a 2x margin and still catches a wrong kernel
RG_LOGITS_REL_TOL = 0.1

H, HKV, HD = 48, 8, 128  # Mixtral-8x22B attention widths
PROMPT, NEW_TOKENS, BATCH, LAYERS = 1024, 16, 2, 2
RG_H, RG_HKV, RG_HD, RG_WINDOW, RG_WIDTH = 16, 1, 256, 2048, 4096  # RecurrentGemma-9B


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


def flash_phase(fa_ops, widths: tuple, shapes: list) -> list[dict]:
    """Kernel vs plain flash attention at (H, Hkv, hd) = ``widths`` for each
    (B, S, window) of ``shapes`` (the served prefill first)."""
    import torch
    import torch.nn.functional as F

    H, HKV, HD = widths
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
        rows.append(dict(B=B, S=S, H=H, Hkv=HKV, hd=HD, window=window, max_abs_err=err, max_scaled_err=scaled,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes"))
        print(f"[kernel] flash hd={HD} H={H} Hkv={HKV} B={B} S={S} window={window}: max_abs_err={err:.3g} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms} ms, bound {rows[-1]['bound_ms']:.4f} ms "
              f"({rows[-1]['bound_by']})", flush=True)
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def scan_phase(lru_ops) -> list[dict]:
    """Kernel vs plain RG-LRU scan at the served prefill's (B, S, W) and at a
    longer one, fp32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for B, S, W in ((BATCH, PROMPT, RG_WIDTH), (1, 8192, RG_WIDTH)):
        # decays in RecurrentGemma's band (a = sigmoid(Λ)^(c·r) ∈ (0, 1))
        a = torch.rand(B, S, W, generator=gen, device="cuda") * 0.5 + 0.499
        b = torch.randn(B, S, W, generator=gen, device="cuda")
        out = lru_ops.rglru_scan(a, b)
        torch.cuda.synchronize()
        ref = lru_ops.rglru_scan_plain(a, b)
        diff = (out - ref).abs()
        err = diff.max().item()
        scaled = (diff / ref.abs().clamp_min(1.0)).max().item()
        del ref, diff, out
        if not scaled <= SCAN_TOL:
            raise AssertionError(f"scan kernel vs plain at B={B} S={S} W={W}: max abs err {err}, "
                                 f"{scaled} per unit of state magnitude")
        ms = _time_ms(lambda: lru_ops.rglru_scan(a, b), iters=20)
        plain_ms = _time_ms(lambda: lru_ops.rglru_scan_plain(a, b), iters=3, warmup=1)
        n = B * S * W
        t_bytes = 3 * n * 4 / PEAK_HBM_BYTES * 1e3  # a, b read once, s written once
        t_ops = 2 * n / PEAK_FP32_FLOPS * 1e3  # one multiply and one add per element
        lanes = B * W
        rows.append(dict(B=B, S=S, W=W, max_abs_err=err, max_scaled_err=scaled, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         lanes=lanes, blocks=(W + 63) // 64 * B, threads_per_block=64))
        print(f"[kernel] rglru_scan B={B} S={S} W={W}: max_abs_err={err:.3g} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
              f"{lanes} lanes in {rows[-1]['blocks']} blocks of 64 threads", flush=True)
        del a, b
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


def recurrentgemma_phase(fa_ops, lru_ops, workdir: Path) -> dict:
    """RecurrentGemma-9B at full width and depth through the after2 path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.models import recurrent as rec_mod
    from repro_torch.serving import GenerationEngine, cold_start
    from repro_torch.utils.tree import flatten_with_paths

    cfg = get_config("recurrentgemma-9b")
    if PROMPT > cfg.recurrent.window:
        raise AssertionError("the prompt must stay inside the local window to graft the prefill cache")
    model = build_model(cfg, param_dtype=torch.bfloat16)
    kinds = cfg.attn_kinds
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten_with_paths(params))
    print(f"[serve] {cfg.name} at full width and depth ({cfg.num_layers} layers: {n_rec} rec, {n_attn} attn; "
          f"{n_params / 1e9:.2f} B params), bf16 weights made in {time.perf_counter() - t0:.1f} s", flush=True)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    artifact = workdir / "artifact_rg"
    shutil.rmtree(artifact, ignore_errors=True)
    warm_shapes = ((BATCH, PROMPT),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(7)).cuda()

    fa_ops.flash_attention.launches = 0  # the main path starts here
    lru_ops.rglru_scan.launches = 0
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
    flash_launches = fa_ops.flash_attention.launches  # the main path ends here
    scan_launches = lru_ops.rglru_scan.launches
    peak = torch.cuda.max_memory_allocated()

    prefill_runs = len(warm_shapes) + stats.prefill_runs
    summary = dict(
        analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3,
        plan=result.summary(), tier1_compressed_bytes=meta["tier1_compressed_bytes"],
        cold_start=server.report.to_dict(),
        faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes,
        fault_s=stats.fault_s, prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        loads=len(server.tiered.stats.events), peak_device_bytes=peak, n_params=n_params,
        flash_launches=flash_launches, scan_launches=scan_launches, prefill_runs=prefill_runs,
    )
    print("[serve] " + json.dumps(summary, default=str), flush=True)
    if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generated ids: shape {out.shape}, range [{out.min()}, {out.max()}]")
    if result.plan.summary()["units"] != 0 or stats.faulted_units != 0 or summary["loads"] != 0:
        raise AssertionError("RecurrentGemma's tier-1 should be empty and nothing should fault")
    if scan_launches != n_rec * prefill_runs or flash_launches != n_attn * prefill_runs:
        raise AssertionError(f"{scan_launches} scan and {flash_launches} flash launches for {prefill_runs} "
                             f"prefill runs of {n_rec} rec and {n_attn} attention layers")

    # the same weights (all tier-0, all resident) through both plain versions
    live = server.live_params()
    with torch.inference_mode():
        logits_kernel = model.prefill(live, {"tokens": tokens})[0].float()
        with mock.patch.object(attn_mod, "flash_attention", fa_ops.flash_attention_plain), \
                mock.patch.object(rec_mod, "rglru_scan", lru_ops.rglru_scan_plain):
            logits_plain = model.prefill(live, {"tokens": tokens})[0].float()
    if not torch.isfinite(logits_kernel).all():
        raise AssertionError("non-finite logits on the kernel path")
    diff = (logits_kernel - logits_plain).abs().max().item()
    scale = logits_plain.abs().max().item()
    agree = (logits_kernel.argmax(-1) == logits_plain.argmax(-1)).float().mean().item()
    print(f"[serve] {cfg.name} prefill logits kernel vs plain path: max abs diff {diff:.4g} "
          f"(max |logit| {scale:.4g}, {diff / scale:.4g} of it), argmax agreement {agree:.2f}", flush=True)
    if not diff <= RG_LOGITS_REL_TOL * scale:
        raise AssertionError(f"kernel-path logits differ from the plain path by {diff} (max |logit| {scale})")
    server.close()
    shutil.rmtree(artifact, ignore_errors=True)
    summary["logits_max_abs_diff"] = diff
    summary["logits_max_abs"] = scale
    return summary


def _print_ptxas(name: str, log: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {name} ptxas: {line.strip()}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.rglru_scan import ops as lru_ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})", file=sys.stderr)
        return 2

    gpu = _gpu_line()
    print(f"[build] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # one nvcc per source, started together
        builds = {name: ex.submit(ops.build) for name, ops in (("flash_attention", fa_ops), ("rglru_scan", lru_ops))}
        for name, fut in builds.items():
            path, log = fut.result()
            print(f"[build] {path.name} ready {time.perf_counter() - t0:.1f} s after the start", flush=True)
            _print_ptxas(name, log)

    rows = flash_phase(fa_ops, (H, HKV, HD), [  # (B, S, window) — the served prefill first
        (BATCH, PROMPT, 4096),
        (1, 8192, 4096),
        (2, 2048, None),
    ])
    rows_256 = flash_phase(fa_ops, (RG_H, RG_HKV, RG_HD), [(BATCH, PROMPT, RG_WINDOW), (1, 8192, RG_WINDOW)])
    scan_rows = scan_phase(lru_ops)
    workdir = REPO / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    summary = serve_phase(fa_ops, workdir)
    rg_summary = recurrentgemma_phase(fa_ops, lru_ops, workdir)

    main_row, scan_row = rows[0], scan_rows[0]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": summary["flash_launches"] + rg_summary["flash_launches"],
        "launches_by_path": {"mixtral-8x22b": summary["flash_launches"],
                             "recurrentgemma-9b": rg_summary["flash_launches"]},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows + rows_256,
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:50",
        "launches": rg_summary["scan_launches"],
        "max_abs_err": scan_row["max_abs_err"],
        "ms": scan_row["ms"],
        "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"],
        "bound_by": scan_row["bound_by"],
        "library_ms": None,
        "shapes": scan_rows,
    }]
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
