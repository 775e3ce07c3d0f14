"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(``repro.launch.serve`` counterpart).

The FaaSLight pipeline end to end: analyze → write the artifact of the
chosen mode (the monolithic before/after1 bundle, or the two-tier after2
artifact) → timed cold start (its compile phase captures the warm set as
CUDA graphs on the card) → serve, with the reference's ``[serve]`` lines
(cold start, resident fraction, prefetch hit rate, evictions, refaults,
stall p99), the keys of the units the requests faulted in (a line of the
port's own) and the generated tokens. Two request modes:

  * one-shot (default): one batched ``GenerationEngine.generate()`` of
    ``--batch`` prompts; ``[serve] tokens:`` prints its (B, gen-steps) ids;
  * traffic (``--concurrency N``): N continuous-batching slots served by the
    scheduler on its own thread, with ``--requests`` prompts arriving
    open-loop at ``--arrival-rate`` req/s (Poisson from a seeded generator;
    0 = all at once), admitted by ``--admission fifo|slo`` (``--deadline-ms``
    with slo). It reports throughput and per-request latency, prints each
    request's ids in order on ``[serve] tokens:``, and exits non-zero if a
    request failed or never finished (an SLO shed is not a failure).

Weights come from ``model.init(torch.Generator(device).manual_seed(0))``;
the one-shot prompts from a CPU ``torch.Generator`` seeded with 1, request i
of the traffic mode from one seeded with 100 + i, so a run is the same on
every machine with the same device type.

Profile → re-tier → re-serve (after2 only): ``--profile-out t.json`` writes
this run's demand-access trace at the end of the run (profile with
``--no-prefetch``, so the trace sees every fault); a later run with
``--retier-from t.json`` replans the tier split from the trace
(``core.retier.replan_from_trace``), writes the re-tiered artifact beside the
original (``<artifact-dir>/<arch>-retier``, staged in a ``.partial``
directory and published by rename), and serves from it with the prefetcher
armed with the trace's ``TransitionPredictor``. At start the launcher removes
``.partial`` directories a crashed rewrite left in the artifact directory.

Online re-tiering (after2 only): ``--retier-online`` attaches a
``RetierDaemon`` that the engine or the scheduler ticks between steps every
``--retier-interval`` steps, folding each trace window into a history decayed
by ``--retier-decay`` and applying the replanned hot set in place (and with
``--retier-compact-every N`` rewriting the artifact every N applications);
it prints ``[serve] online retier:``, and ``--profile-out`` then saves the
daemon's merged trace. ``--host-budget-bytes N`` governs residency through
a ``HostArbiter`` with an N-byte budget (the single-tenant form of the
multi-model pool; the policy's budget fraction becomes the tenant's share)
and prints ``[serve] host arbiter:``.

Warm snapshots (after2 only): ``--snapshot-out s.json`` writes the warmed
server's resident set, LRU stamps, predictor and artifact fingerprint at the
end of the run; ``--restore-from s.json`` faults that set in again and arms
the predictor before the first request (``[serve] warm restore:``). The
fingerprint covers every file of the artifact directory, so write the
snapshot outside it; a restore against another artifact raises.

Fleet (``--fleet N``, after2, one-shot): N in-process replicas, each with its
own daemon (``--fleet`` implies ``--retier-online``) registered to one
``FleetController(decay=--retier-decay)``. All N cold-start first; then each
serves the one-shot request, and the controller syncs after each, so by the
time replica k serves it carries the hot set replicas 0..k-1 learned. It
prints each replica's request, tokens and daemon stats, each sync and the
``[serve] fleet:`` totals (with the joiners' warm-bootstrap bytes and
seconds, which their cold-start reports leave out, as the reference's do),
and exits 1 if a replica's output is short.

Every family of the reference serves, xLSTM (``--arch xlstm-125m``) among
them. Whisper (``--arch whisper-base``) and
Llama-3.2-Vision (``--arch llama-3.2-vision-90b``) serve text-only, as the
reference's launcher does: the analyzer sees only their ``_text_only``
entries, so the encoder and the image cross-attention blocks go to tier-1
(or stay tier-0 under ``min_tier1_bytes``) and no request faults them in.

Runs on ``--device cuda`` unless told ``--device cpu``. Every config serves
on the card, the reduced ones (``--reduced``: head_dim 8 or 16, which the
flash kernel's wrapper pads to 64) included; a published config can have its
depth cut (``--layers``) and its weights stored in bf16 (``--param-dtype
bfloat16``) to fit. Compute runs in the config's dtype, bf16 for every
config, which the flash kernel takes; attention in fp32 (the parity tests'
``cfg.replace(dtype="float32")``) runs on the CPU only, and the kernel's
wrapper refuses it on the card.

Mesh (``--mesh DATAxMODEL``): the params are sharded over a ("data",
"model") ``DeviceMesh`` by the param rules (``cold_start(mesh=)``), each
unit charged its bytes per shard; it prints ``[serve] mesh:`` (geometry,
ranks, the leaves' shard divisors, the entries' kind). One process serves
1x1; a larger mesh needs one process per rank,
``torchrun --nproc-per-node N -m repro_torch.launch.serve ... --mesh DxM``,
and a geometry the world does not hold is a usage error. Every rank runs the
same request on its own device. Every family computes on each rank's
shards: the batch rows split over ``data``, each weight's ``embed`` dim
gathered over ``data`` at its use, heads, ``ffn`` (the RG-LRU's channels),
experts and vocab over ``model``, the decode caches' slots (the recurrent
states' channels or heads) over ``model``
(``models.transformer.prefill_sharded``). Resident bytes are per shard; rank 0 writes the
artifact and every file and prints every line, the mesh line after the
request (with the bytes each run's collectives moved). A multi-rank mesh serves the
one-shot path only (the scheduler admits on each rank's own clock), and the
fleet's replicas, as in the reference, serve without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import clean_partials
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import (
    AccessTrace,
    DeploymentProfile,
    FleetController,
    HostArbiter,
    TransitionPredictor,
    analyze,
    build_artifact,
    replan_from_trace,
    retier_artifact,
    write_monolithic,
)
from repro_torch.core import snapshot as server_snapshot
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.kernels import kernel_wrappers
from repro_torch.launch.mesh import make_debug_mesh, mesh_label
from repro_torch.models import build_model
from repro_torch.optim import init_adamw
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine, SLOAdmission, cold_start
from repro_torch.sharding import param_shardings, spec_shard_divisor
from repro_torch.utils.tree import flatten_with_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers at full width (0 = the config's)")
    ap.add_argument("--param-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="stored weight dtype (float32, as the reference stores them)")
    ap.add_argument("--mode", default="after2", choices=["before", "after1", "after2"])
    ap.add_argument("--artifact-dir", default="artifacts")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-steps", type=int, default=8)
    ap.add_argument("--resident-experts", type=int, default=1)
    ap.add_argument("--hot-vocab", type=float, default=0.25)
    ap.add_argument("--policy", default="stats", choices=["strict", "stats", "full"],
                    help="residency budget preset; also shapes the deployment profile")
    ap.add_argument("--device-budget-bytes", type=int, default=0,
                    help="override the preset's tier-1 device budget (0 = preset default)")
    ap.add_argument("--host-budget-bytes", type=int, default=0,
                    help="govern residency through a HostArbiter with this host-wide device budget "
                         "instead of a private per-model budget (after2 only; 0 = off)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the prefetcher even where the preset enables it")
    ap.add_argument("--concurrency", type=int, default=0,
                    help="traffic mode: serve through N continuous-batching slots (0 = one-shot)")
    ap.add_argument("--requests", type=int, default=8,
                    help="traffic mode: number of requests to submit")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="traffic mode: open-loop Poisson arrivals, req/s (0 = all at once)")
    ap.add_argument("--admission", default="fifo", choices=["fifo", "slo"],
                    help="scheduler admission policy: fifo = strict arrival order (default), "
                         "slo = deadline-aware shed/re-order (traffic mode)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="SLO admission: per-request latency deadline in ms "
                         "(0 = none; requests projected to miss it are shed)")
    ap.add_argument("--profile-out", default="",
                    help="write this run's demand-access trace (AccessTrace JSON) here at the end of "
                         "the run; profile with --no-prefetch so the trace sees every fault (after2 only)")
    ap.add_argument("--retier-from", default="",
                    help="re-tier the artifact from a prior --profile-out trace before cold start "
                         "(promote demand-faulted units, demote untouched residents) and drive the "
                         "prefetcher from its transition tables (after2 only)")
    ap.add_argument("--retier-online", action="store_true",
                    help="attach the online re-tiering daemon: adapt the hot set in place from the live "
                         "access trace (promote = preload, demote = eviction), no restart (after2 only)")
    ap.add_argument("--retier-interval", type=int, default=16,
                    help="online re-tier cadence in serving steps (default 16)")
    ap.add_argument("--retier-decay", type=float, default=0.5,
                    help="per-tick decay of the merged trace history in [0, 1]: "
                         "1 = lifetime counts, 0 = newest window only")
    ap.add_argument("--retier-compact-every", type=int, default=0,
                    help="online mode: rewrite the artifact (out of place, rename-committed) every N "
                         "plan applications so the next cold start boots the adapted hot set (0 = never)")
    ap.add_argument("--snapshot-out", default="",
                    help="write the warmed server's snapshot (resident set and LRU stamps, predictor, artifact "
                         "fingerprint) here at the end of the run (after2 only); keep it outside the artifact")
    ap.add_argument("--restore-from", default="",
                    help="restore a --snapshot-out document before the first request: the replica starts "
                         "RESIDENT-warm instead of faulting its hot set in again (after2 only)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve through N in-process replicas federated by a FleetController: each replica "
                         "runs the one-shot request, the controller syncs traces and pushes the learned hot set "
                         "to all of them (implies --retier-online; after2 one-shot only)")
    ap.add_argument("--mesh", default="",
                    help="shard serving over a DATAxMODEL mesh (e.g. 2x4): tier-0 leaves and tier-1 placeholders "
                         "are placed as shards, the residency budget charges bytes per shard; a mesh of more than "
                         "one rank needs that many processes (torchrun --nproc-per-node N)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if (args.profile_out or args.retier_from or args.retier_online) and args.mode != "after2":
        ap.error("--profile-out/--retier-from/--retier-online need the two-tier runtime (--mode after2)")
    if args.host_budget_bytes and args.mode != "after2":
        ap.error("--host-budget-bytes governs the tier-1 residency layer (--mode after2 only)")
    if (args.snapshot_out or args.restore_from) and args.mode != "after2":
        ap.error("--snapshot-out/--restore-from serialize the tier-1 residency set (--mode after2 only)")
    if args.retier_from and (args.no_prefetch or args.policy == "strict"):
        # without a prefetcher the trained predictor would be dropped silently
        ap.error("--retier-from drives the predictive prefetcher; drop --no-prefetch / use "
                 "--policy stats|full (profiling runs want --no-prefetch, re-serve runs don't)")
    if args.admission == "fifo" and args.deadline_ms:
        ap.error("--deadline-ms needs --admission slo (FIFO never sheds)")
    if args.deadline_ms < 0:
        ap.error("--deadline-ms must be >= 0")
    if args.concurrency < 0 or args.requests < 1 or args.arrival_rate < 0:
        ap.error("--concurrency, --arrival-rate must be >= 0 and --requests >= 1")
    if args.layers < 0:
        ap.error("--layers must be >= 0")
    if args.batch < 1 or args.prompt_len < 1 or args.gen_steps < 1:
        ap.error("--batch, --prompt-len and --gen-steps must be >= 1")
    if args.device_budget_bytes < 0:
        ap.error("--device-budget-bytes must be >= 0")
    if args.host_budget_bytes < 0:
        ap.error("--host-budget-bytes must be >= 0")
    if not 0.0 <= args.retier_decay <= 1.0:
        ap.error("--retier-decay must be in [0, 1]")
    if args.retier_interval < 1:
        # a usage error now, not a traceback after the whole cold start
        ap.error("--retier-interval must be >= 1")
    if args.fleet:
        if args.fleet < 2:
            ap.error("--fleet needs at least 2 replicas to federate")
        if args.mode != "after2":
            ap.error("--fleet needs the two-tier runtime (--mode after2)")
        if args.concurrency > 0:
            ap.error("--fleet drives the one-shot path; drop --concurrency")
        if args.host_budget_bytes or args.profile_out or args.retier_from:
            ap.error("--fleet composes with none of --host-budget-bytes/--profile-out/--retier-from (yet)")
        args.retier_online = True  # the fleet federates RetierDaemons
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is visible (pass --device cpu)")
    mesh = None
    if args.mesh:
        try:
            data_ax, model_ax = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            ap.error(f"--mesh wants DATAxMODEL (e.g. 2x4), got {args.mesh!r}")
        try:
            mesh = make_debug_mesh(data_ax, model_ax, device=args.device)
        except ValueError as e:  # the world does not hold the geometry: name the launcher
            ap.error(str(e))
        if mesh.size() > 1 and args.concurrency > 0:
            ap.error("--concurrency with a mesh of more than one rank: the scheduler admits on each rank's own "
                     "clock, so the ranks' forward runs (and their gathers) would differ")
    rank = torch.distributed.get_rank() if mesh is not None else 0
    try:
        with contextlib.ExitStack() as stack:
            if rank:  # rank 0 prints every line
                stack.enter_context(contextlib.redirect_stdout(stack.enter_context(open(os.devnull, "w"))))
            return _serve(args, mesh, rank)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _serve(args, mesh, rank: int) -> int:
    """The launcher's run after its flags are checked; ``mesh`` is None or
    the ``DeviceMesh`` this process is rank ``rank`` of."""

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    cfg = cfg.replace(collect_moe_usage=cfg.moe is not None)
    model = build_model(cfg, param_dtype=getattr(torch, args.param_dtype))
    outdir = os.path.join(args.artifact_dir, cfg.name)

    if args.policy == "strict":
        profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0,
                                    min_tier1_bytes=1 << 14, vocab_row_group=max(64, cfg.vocab_size // 16))
        stats = None
    elif args.policy == "full":
        profile = DeploymentProfile(resident_experts=-1, hot_vocab_fraction=1.0)
        stats = None
    else:  # stats
        profile = DeploymentProfile(
            resident_experts=args.resident_experts,
            hot_vocab_fraction=args.hot_vocab,
            min_tier1_bytes=1 << 14,
            vocab_row_group=max(64, cfg.vocab_size // 16),
        )
        pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 128, 8))
        stats = pipe.vocab_row_stats(row_group=profile.vocab_row_group)

    print(f"[serve] analyzing {cfg.name} under profile {profile.name}/{args.policy}", flush=True)
    result = analyze(model, profile, hot_units_stats=stats, trace_B=1, trace_S=32)
    print("[serve] plan:", json.dumps(result.summary(), default=str)[:400], flush=True)

    if rank == 0:  # one writer of the artifact; the other ranks wait for it below
        params = model.init(torch.Generator(args.device).manual_seed(0), device=args.device)
        os.makedirs(outdir, exist_ok=True)
        # crash recovery before any writer exists: staging directories of a
        # rewrite that never reached its rename are never committed, safe to drop
        removed = clean_partials(outdir)
        if removed:
            print(f"[serve] removed {len(removed)} orphaned partial(s): "
                  + ", ".join(os.path.basename(p) for p in removed))
        if args.mode in ("before", "after1"):
            opt = init_adamw(params)
            write_monolithic({"params": params, "opt_state": {"m": opt.m, "v": opt.v}},
                             outdir, pruned=args.mode == "after1")
            del opt
        else:
            build_artifact(params, result, outdir)
        del params  # the server reads its weights from the artifact

    predictor = None
    if args.retier_from:
        # one profile → re-tier cycle: replan from the trace, rewrite the
        # artifact beside the original, serve it with the predictor armed
        prof_trace = AccessTrace.load(args.retier_from)
        result.plan, rep = replan_from_trace(result.plan, prof_trace, result.reach)
        retier_dir = outdir.rstrip("/") + "-retier"
        t0 = time.perf_counter()
        if rank == 0:
            meta = retier_artifact(outdir, result.plan, out_dir=retier_dir, report=rep)
            print(f"[serve] re-tiered from {args.retier_from} -> {retier_dir}:", json.dumps(rep.summary()))
            print("[serve] retier artifact: " + json.dumps(dict(
                rewrite_s=time.perf_counter() - t0, tier0_bytes=meta["tier0_bytes"],
                tier1_compressed_bytes=meta["tier1_compressed_bytes"], **meta["compaction"])), flush=True)
        outdir = retier_dir
        predictor = TransitionPredictor.from_trace(prof_trace)
    if mesh is not None:
        torch.distributed.barrier()  # the artifact is whole before any rank reads it

    max_seq = args.prompt_len + args.gen_steps + 8
    if args.fleet:
        return _serve_fleet(model, result, outdir, args, cfg, max_seq)
    warm_B = 1 if args.concurrency > 0 else args.batch
    failed = 0
    arbiter = HostArbiter(args.host_budget_bytes) if args.host_budget_bytes else None
    admission = None
    if args.admission == "slo":
        admission = SLOAdmission(default_deadline_s=(args.deadline_ms / 1e3) if args.deadline_ms else None)
    with cold_start(model, outdir, result if args.mode == "after2" else None,
                    mode=args.mode, warm_shapes=((warm_B, args.prompt_len, max_seq),),
                    residency=args.policy if args.mode == "after2" else None,
                    device_budget_bytes=args.device_budget_bytes or None,
                    host_arbiter=arbiter,
                    prefetch=False if args.no_prefetch else None,
                    trace=bool(args.profile_out), predictor=predictor,
                    retier_online=args.retier_online, retier_interval=args.retier_interval,
                    retier_decay=args.retier_decay,
                    retier_compact_every=args.retier_compact_every if rank == 0 else 0,
                    admission=admission, restore_from=args.restore_from or None, mesh=mesh,
                    device=args.device) as server:
        print(f"[serve] cold start ({args.mode}):", json.dumps(server.report.to_dict(), default=float), flush=True)
        if server.restore_report is not None:
            rr = server.restore_report
            print(f"[serve] warm restore: {rr['restored']}/{rr['requested']} units resident "
                  f"({rr['moved_bytes']:,}B replayed, predictor {'armed' if rr['predictor_armed'] else 'absent'})")
            print("[serve] restore report: " + json.dumps(rr))
        engine = GenerationEngine(server, max_seq=max_seq)
        if args.concurrency > 0:
            failed = _serve_traffic(engine, args, cfg)
        else:
            _serve_one_shot(engine, args, cfg)
        if mesh is not None:
            print("[serve] mesh: " + json.dumps(_mesh_summary(server, mesh)), flush=True)
        # every kernel launch of this process (the warm set's and the request's)
        print("[serve] kernel launches: " + json.dumps({name: f.launches for name, f in kernel_wrappers().items()}))
        if server.tiered is not None:
            ts = server.tiered.stats
            budget = server.tiered.residency.budget_bytes
            print(f"[serve] resident fraction: {server.tiered.resident_fraction():.3f}; "
                  f"resident {server.tiered.resident_bytes:,}B"
                  + (f" / budget {budget:,}B" if budget else " (no budget)"))
            print(f"[serve] prefetch hit rate {ts.prefetch_hit_rate:.2f}; "
                  f"evictions {ts.evictions}; refaults {ts.refaults}; "
                  f"stall p99 {ts.stall_percentile(99)*1e3:.2f}ms", flush=True)
            print("[serve] faulted units: " + json.dumps(sorted({e.key for e in ts.events if e.source == "fault"})))
            if server.prefetcher is not None and server.prefetcher.predictor is not None:
                ps = server.prefetcher.stats
                print(f"[serve] predictor: observed {ps.observed} keys, "
                      f"predicted {ps.predicted} ahead-of-schedule loads")
        if arbiter is not None:
            audit = arbiter.audit()
            hs = arbiter.stats
            print(f"[serve] host arbiter: {audit['resident_bytes']:,}B resident "
                  f"/ {audit['budget_bytes']:,}B host budget "
                  f"({audit['pinned_bytes']:,}B pinned); "
                  f"{hs.evictions} evictions ({hs.evicted_bytes:,}B), "
                  f"{hs.overshoots} overshoots, "
                  f"{hs.headroom_denials} prefetch headroom denials")
        if server.retier_daemon is not None:
            _print_daemon_stats(server)
        if args.profile_out and rank == 0 and server.tiered is not None and server.tiered.trace is not None:
            # with the daemon on, the live trace is only the newest window:
            # save the decayed merge of everything the run observed instead
            t = (server.retier_daemon.trace_snapshot()
                 if server.retier_daemon is not None else server.tiered.trace)
            t.save(args.profile_out)
            print(f"[serve] wrote access trace to {args.profile_out} "
                  f"({t.batches} batches, {len(t.faults)} faulted units, "
                  f"{len(t.transitions)} transition sources)", flush=True)
        if args.snapshot_out and rank == 0 and server.tiered is not None:
            snap = server.snapshot()
            server_snapshot.save(snap, args.snapshot_out)
            print(f"[serve] wrote server snapshot to {args.snapshot_out} "
                  f"({len(snap['resident'])} resident units, "
                  f"predictor {'included' if snap['predictor'] else 'absent'})", flush=True)
    if failed:
        print(f"[serve] FAILED: {failed} request(s) failed or never finished")
    return 1 if failed else 0


def _mesh_summary(server, mesh) -> dict:
    """The ``[serve] mesh:`` line, printed after the request: geometry,
    ranks, how many leaves have each shard divisor, the server's entries'
    kind (CUDA graphs need a mesh of 1s on the card), whether they compute
    on shards (``compute``: "sharded", or "gathered" at use), and the bytes
    this rank's collectives moved in the request's last prefill and decode
    run (0 where no sharded run was made)."""
    model = server.model
    shardings = param_shardings(model.logical_axes(), model.abstract(), mesh, fsdp=bool(model.cfg.fsdp))
    divisors: dict = {}
    for _, sh in flatten_with_paths(shardings):
        d = str(spec_shard_divisor(sh.spec, mesh))
        divisors[d] = divisors.get(d, 0) + 1
    per_step = {kind: runs[-1] if runs else 0 for kind, runs in server.collective_bytes.items()}
    return dict(geometry=mesh_label(mesh), ranks=mesh.size(), divisors=dict(sorted(divisors.items())),
                entries=server.entry_kind, compute="sharded" if server.sharded else "gathered",
                collective_bytes_per_step=per_step)


def _serve_one_shot(engine: GenerationEngine, args, cfg, label: str = ""):
    """One ``generate()`` of ``--batch`` prompts from a CPU generator seeded
    with 1; prints its ``[serve]{label}`` generated, request and tokens lines
    and returns ``(ids, RequestStats)``."""
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(args.device)
    out, st = engine.generate(prompts, args.gen_steps)
    print(f"[serve]{label} generated {out.shape}; prefill={st.prefill_s*1e3:.1f}ms "
          f"decode={st.decode_s*1e3:.1f}ms faults={st.faulted_units} "
          f"({st.faulted_bytes/2**20:.1f}MiB, {st.fault_s*1e3:.1f}ms)")
    print(f"[serve]{label} request: " + json.dumps(dict(
        faulted_units=st.faulted_units, faulted_bytes=st.faulted_bytes, fault_s=st.fault_s,
        prefill_runs=st.prefill_runs, prefill_retries=st.prefill_retries, decode_retries=st.decode_retries)))
    print(f"[serve]{label} tokens: {json.dumps(out.tolist())}", flush=True)
    return out, st


def _serve_fleet(model, result, outdir: str, args, cfg, max_seq: int) -> int:
    """``--fleet N``: the one-shot request through N in-process replicas
    federated by one ``FleetController``. Every replica cold-starts with its
    own daemon registered to the fleet; then each serves the request, and
    the controller syncs after each. Returns 1 if a replica's output is short."""
    fleet = FleetController(decay=args.retier_decay)
    servers, failed = [], 0
    try:
        for i in range(args.fleet):
            s = cold_start(model, outdir, result, mode="after2",
                           warm_shapes=((args.batch, args.prompt_len, max_seq),), residency=args.policy,
                           device_budget_bytes=args.device_budget_bytes or None,
                           prefetch=False if args.no_prefetch else None, retier_online=True,
                           retier_interval=args.retier_interval, retier_decay=args.retier_decay,
                           retier_compact_every=args.retier_compact_every, fleet=fleet,
                           replica_name=f"replica-{i}", device=args.device)
            servers.append(s)
            print(f"[serve] replica-{i} cold start:", json.dumps(s.report.to_dict(), default=float), flush=True)
        for i, s in enumerate(servers):
            out, _ = _serve_one_shot(GenerationEngine(s, max_seq=max_seq), args, cfg, label=f" replica-{i}")
            if tuple(out.shape) != (args.batch, args.gen_steps):
                failed += 1
            rep = fleet.sync()
            print(f"[serve] fleet sync: {rep['windows']}/{rep['pulled']} windows, "
                  f"pushed to {len(rep['pushed'])} replicas (+{rep['promoted']}/-{rep['demoted']} units)"
                  + (f", FAILED {sorted(rep['failed'])}" if rep["failed"] else ""), flush=True)
        for i, s in enumerate(servers):
            _print_daemon_stats(s, label=f"replica-{i} retier")
        fs = fleet.stats
        # the joiners' warm bootstraps, which their cold-start reports leave out
        boot_bytes = sum(s.fleet_bootstrap["bytes"] for s in servers)
        boot_s = sum(s.fleet_bootstrap["seconds"] for s in servers)
        print(f"[serve] fleet: {fs.syncs} syncs, {fs.replans} replans, {fs.pushes} pushes "
              f"({fs.push_failures} failed), {fs.bootstraps} warm bootstraps ({boot_bytes:,}B in {boot_s:.3f}s)")
        print(f"[serve] fleet stats: {json.dumps(fs.to_dict())}")
        print("[serve] kernel launches: " + json.dumps({name: f.launches for name, f in kernel_wrappers().items()}))
    finally:
        for s in servers:
            s.close()
    if failed:
        print(f"[serve] FAILED: {failed} replica run(s) produced short output")
    return 1 if failed else 0


def _print_daemon_stats(server, label: str = "online retier") -> None:
    """One line of daemon accounting and the predictor counters its refresh
    feeds; then the stats in full as JSON (``[serve] <label> stats:``)."""
    ds = server.retier_daemon.stats
    pred = ""
    if server.tiered is not None and server.prefetcher is not None:
        ts, ps = server.tiered.stats, server.prefetcher.stats
        pred = (f", predictor hit rate {ts.prefetch_hit_rate:.2f} "
                f"({ps.observed} observed, {ps.predicted} predicted)")
    print(f"[serve] {label}: {ds.ticks} ticks, {ds.applies} applies "
          f"(+{ds.promoted_units}/-{ds.demoted_units} units, "
          f"{ds.evicted_bytes:,}B evicted, "
          f"{ds.predictor_refreshes} predictor refreshes, "
          f"{ds.compactions} compactions{pred}); zero restarts")
    print(f"[serve] {label} stats: {json.dumps(ds.to_dict())}")


def traffic_prompts(cfg, n: int, prompt_len: int) -> list[np.ndarray]:
    """Request i's prompt: ``prompt_len`` ids from a CPU generator seeded with 100 + i."""
    return [torch.randint(0, cfg.vocab_size, (prompt_len,), generator=torch.Generator().manual_seed(100 + i))
            .numpy() for i in range(n)]


def _serve_traffic(engine: GenerationEngine, args, cfg) -> int:
    """Open-loop traffic through the continuous-batching scheduler. Returns
    the number of failed or unfinished requests (SLO sheds excluded)."""
    # the admission policy is the server's (cold_start(admission=...))
    sched = ContinuousBatchingScheduler(engine, max_batch=args.concurrency)
    sched.warm_compile()  # the first step should serve, not capture
    rng = np.random.default_rng(0)
    prompts = traffic_prompts(cfg, args.requests, args.prompt_len)
    deadline_s = (args.deadline_ms / 1e3) if args.deadline_ms else None
    stop = threading.Event()
    loop = threading.Thread(target=sched.serve_forever, args=(stop,), name="sched-loop")
    loop.start()
    t0 = time.perf_counter()
    reqs = []
    try:
        for p in prompts:
            reqs.append(sched.queue.submit(p, args.gen_steps, deadline_s=deadline_s))
            if args.arrival_rate > 0:
                time.sleep(rng.exponential(1.0 / args.arrival_rate))
        # give up early if the loop thread dies instead of waiting out the limit
        limit = time.perf_counter() + 600.0
        pending = list(reqs)
        while pending and loop.is_alive() and time.perf_counter() < limit:
            if pending[0].wait(1.0):
                pending.pop(0)
        pending = [r for r in pending if not r.done]
        if pending:
            print(f"[serve] WARNING: {len(pending)}/{len(reqs)} requests unfinished "
                  f"(loop alive={loop.is_alive()})")
    finally:
        stop.set()
        loop.join()
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.done and r.error is None]
    shed = [r for r in reqs if r.shed]
    lat = np.array([r.latency_s for r in done]) if done else np.zeros(1)
    ttft = np.array([r.ttft_s for r in done]) if done else np.zeros(1)
    print(f"[serve] traffic: {len(done)}/{len(reqs)} ok in {wall:.2f}s "
          f"({len(done) / wall:.2f} req/s over {sched.stats.steps} batched steps, "
          f"max_active={sched.stats.max_active}" + (f", shed={len(shed)}" if shed else "") + ")")
    print(f"[serve] latency p50={np.percentile(lat, 50) * 1e3:.0f}ms "
          f"p99={np.percentile(lat, 99) * 1e3:.0f}ms; "
          f"ttft p50={np.percentile(ttft, 50) * 1e3:.0f}ms; "
          f"step faults={sched.stats.faulted_units} ({sched.stats.fault_s * 1e3:.1f}ms)")
    print(f"[serve] scheduler: {json.dumps(sched.stats.to_dict())}")
    print(f"[serve] tokens: {json.dumps([r.out for r in reqs])}")
    for r in reqs:
        if r.error and not r.shed:
            print(f"[serve] request {r.rid} failed: {r.error}")
    return sum(1 for r in reqs if (r.error is not None and not r.shed) or not r.done)


if __name__ == "__main__":
    raise SystemExit(main())
