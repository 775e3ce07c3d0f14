#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build — print the card's name and power limit, compile the flash-attention,
   RG-LRU scan, decode-attention and tiered-gather kernels from
   ``src/repro_torch/kernels/*/csrc`` with nvcc (one nvcc per source, all
   started together), print when each is ready and ptxas's register, spill
   and wgmma-serialisation lines for every kernel instantiation, and the
   decode kernel's resident blocks per cluster size (its split plan's input).
2. kernel — each kernel against its plain PyTorch version on the card, at the
   shapes the served prefills give it and at a longer one:
   flash attention in bf16 at Mixtral-8x22B widths (H=48, Hkv=8, hd=128:
   causal rows and one full-width row that is not causal and has a softcap,
   so the unmasked tiles and the softcap kernel are held too), at
   RecurrentGemma-9B's (H=16, Hkv=1, hd=256), at Gemma-3-27B's (H=32,
   Hkv=16, hd=128: B=2 × 1024 with window 1024 and with none, B=1 × 4096
   with window 1024), at Whisper's decoder widths (H=Hkv=8, hd 64: G = 1,
   B=2 × 448), at Llama-3.2-Vision's self layers' (H=64, Hkv=8, hd 128,
   B=2 × 1024), at one of 16 ``model`` ranks of the sharded prefills of
   [mesh] (d) (B=2 × 1024: Mixtral's H=3, Hkv=1, hd 128, window 4096;
   Gemma-3's H=2, Hkv=1, hd 128, window 1024 and none; RecurrentGemma's
   H=1, Hkv=1, hd 256, window 2048; Llama-3.2-Vision's H=4, Hkv=1, hd 128,
   no window; Whisper's ranks run all 8 heads, its row above), and at the
   reduced configs' head dims, which the wrapper
   zero-pads to 64 (reduced Mixtral H=4, Hkv=2,
   hd 16, window 32; reduced Yi H=8, Hkv=2, hd 8); error ≤ 1e-2 per unit of
   max(1, |output|) (bf16 output rounding); each row prints its TFLOP/s and
   its share of the bound. The RG-LRU scan in fp32 at
   (B, S, W) = (2, 1024, 4096), (1, 8192, 4096) and one of 16 ranks'
   channels, (2, 1024, 256): bit for bit (and so
   within 1e-5 per unit of max(1, |s|)), with the lane plan's blocks.
   Times with CUDA events: kernel, plain version, and for attention
   ``F.scaled_dot_product_attention`` on the same function (``is_causal``,
   or a boolean mask where the window cuts; none for the softcap row, which
   no single call computes; the port never calls it). No single PyTorch
   call computes the scan.
   Then the four kernels that no served path reaches: dense decode attention
   (Mixtral widths at B=2 × 1040 and B=8 × 32768, RecurrentGemma widths
   rolling at B=2 × 2048, and B=1 × 32768 at Mixtral widths and at hd 256
   MQA: long caches that few (slot, KV head) pairs read, so their splits
   come in several clusters a pair), paged decode attention (page size 16, 8 slots
   of ragged length through a ``PagePool`` table whose pages are out of
   order, hd 128 and hd 256, each at lengths up to 4096 and at 8x them,
   whose 409 MB and 102 MB of K/V lie past the L2; the work list's blocks
   beside each row), the tiered gather (Mixtral's 32768 × 6144
   bf16 table, row groups of 2048, N = 2048 and 2, all / half / none of the
   groups resident, ids -1 and V included) bit for bit, and the tiered
   gather-matmul (the same table times a 6144 × 16384 expert weight, N=512)
   within 1e-2 per unit of max(1, |plain|); miss masks exact, miss rows
   zero. Decode outputs (dense and paged) sit well below 1, so they are
   held within 1e-2 of max |plain output| instead.
   Every kernel's and library call's time is a device time: 20 calls (5
   for masked SDPA) captured in a CUDA graph and replayed; an eager loop of
   µs-sized calls would time the host, and it is kept as ``eager_ms``.
   Plain versions are timed by an eager loop. Yardsticks: SDPA with a kv_len mask (dense),
   densify + SDPA (paged, two calls; no single call reads a page table),
   ``index_select`` (gather, all resident, ids in range), ``index_select``
   + ``matmul`` (gather-matmul, all resident; two calls).
3. paged decode — one Mixtral-8x22B attention layer at full width (bf16
   weights from a seeded ``torch.Generator``), 8 slots with ragged prefixes
   written into both a dense cache and the pages a ``PagePool`` granted,
   then 16 decode steps each through ``paged_gqa_decode`` (the paged kernel)
   and ``gqa_decode`` (the plain dense decode) on the same input: outputs
   within the kernel tolerance, densified pages equal to the dense cache
   bit for bit after every write, exactly one paged launch per step. Once
   with a linear cache and once rolling, with the pages holding exactly the
   4096-token window.
4. serve — Mixtral-8x22B at full width, depth cut from 56 to 1 layer, bf16
   weights from a seeded ``torch.Generator``: analyze → build_artifact →
   cold_start(after2, strict) → generate (B=2, prompt 1024, 3 new tokens).
   Launch counts are zeroed just before and read just after; every prefill
   of the run must have gone through the kernel in its layer. Then the
   same artifact under ``full`` (no budget, the prefetcher on) serves the
   same request: the same tokens, 0 evictions, flash attention in every
   prefill run and no other kernel; it prints loads by source, the
   prefetcher's counters and hit rate. On that server, every unit now
   resident, after [graph], [sched] and [entries] below, one more prefill
   of the same live weights through the plain attention checks the kernel
   path's logits.
   Every served forward run replays a CUDA graph: the warm set (prefill
   (2, 1024), decode (2, 1035)) is captured at cold start, and each replay
   adds the launches its graph recorded to the wrappers' counts.
   [snapshot] The strict server's ``snapshot()`` (taken after its request)
   saved outside the artifact, then a strict cold start with
   ``restore_from=`` it on the same artifact: fingerprint matched, restored
   == requested == the donor's resident count, the donor's keys and stamps,
   the replayed bytes those units' bytes, and a capture of the restored
   server lists the same keys in the same order; closed without serving.
   [graph] With every unit resident, the same request replayed from the
   graphs and run eagerly (the entries made as plain calls): tokens equal,
   logits within LOGITS_TOL (bit equality printed), capture seconds,
   decode s/step and prefill s/run of each, launch counts in both.
   [sched] The continuous-batching scheduler on that server: 4 slots, 8
   requests submitted at once, prompts of 256 and 512 tokens in turn, 8, 12
   and 16 new tokens in turn, from the graphs and again eagerly: the same
   tokens, 0 rejected or failed, every admission group within 1024 tokens;
   each request against its solo ``generate()`` (same first token, prefill
   logits within LOGITS_TOL; a later divergence printed with its step and
   top-2 logit gap); ``SchedulerStats``, decode s/step and requests/s.
   [entries] On that server, B=2 prompts of 7 lengths (1000 down to 400
   tokens, N + 3 for the server's bound of N = 4 prefill entries), twice:
   never more than N entries beyond the warm set, memory_allocated never
   past its value at the N-th length, tokens after an eviction equal the
   first ones; allocated and reserved bytes printed after each.
   [online] The strict artifact and request again (3 new tokens), with
   the online re-tiering daemon ticking after the prefill and after every
   decode step (``retier_interval=1``; no prefetcher, so promotions are
   synchronous preloads trimmed to the budget's headroom): tokens equal
   strict's, applies ≥ 1 with as many invariant checks, no
   tick or compaction error absorbed, resident bytes within the budget at
   rest, and at least one tick changed residency with a decode replay after
   it. Prints the daemon's stats, each tick's installs and evictions, and
   the request's faults beside strict's after as many steps.
   [arbiter] Two tenants cold-started from the same artifact under one
   ``HostArbiter`` with the strict budget, each serving the request cut to
   2 new tokens from its own thread at once: both join within 600 s (a
   deadlock fails the phase), each gives strict's first 2 columns, the
   audit holds, the budget holds at rest, victims were taken across
   tenants, and ``close()`` unregisters both.
   [fleet] Two replicas on the strict artifact with daemons registered to
   one ``FleetController`` through ``cold_start(fleet=, replica_name=)``,
   each with a budget of the whole tier-1: ``replica-0`` serves the request
   cut to 1 new token, the fleet syncs, ``replica-1`` cold-starts
   bootstrapped from the fleet's overlay (a synchronous preload inside
   ``register``, reported apart from its cold start's upload, which leaves
   it out as the reference's does) and serves the same request. Both give
   strict's first column, ``replica-1`` faults no unit, the fleet records one
   bootstrap and no failure, no daemon absorbed an error; peak device
   memory printed.
5. serve, stats — the same weights and request under the reference
   launcher's stats profile (one resident expert a layer, a quarter of the
   row groups hot by the synthetic pipeline's stats) with its own artifact,
   ``cold_start(residency="stats")``: half of tier-1 on the device, the
   prefetcher on. The tokens must equal phase 4's, the prefetcher must
   install a unit, resident bytes stay within the budget or each overshoot
   is counted, flash attention runs in every prefill run and no other
   kernel does, and no prefetch thread outlives ``close()``.
6. serve — RecurrentGemma-9B at full width, depth cut from 38 to 5 layers
   (one rec/rec/attn group and a rec/rec tail: every layout section of the
   full stack), the same path, 16 new tokens. Its tier-1 is empty (tied
   embeddings, dense MLPs), so nothing faults. Every prefill run must launch
   the scan once per rec layer (4) and flash attention once per attention
   layer (1). One more prefill through both plain versions checks the
   kernel path's logits. [graph] as for Mixtral, logits within
   RG_LOGITS_REL_TOL of the max |logit|.
   [gemma3] Gemma-3-27B at full width, depth cut from 62 to 6 layers (one
   5:1 unit: five local layers of window 1024, one global), the same path
   under strict, B=2 × 1024 + 3: tier-1 empty, nothing faults, flash
   attention once a layer (6) in every prefill run and no other kernel; the
   kernel path's prefill logits against the plain attention's on the same
   server within ZOO_LOGITS_REL_TOL of the max |logit|; [graph] with
   bit-equal logits. The prompt is as long as the window: the decode
   writes positions 1024 and 1025 into slots 0 and 1 of the rolling caches.
   [deepseek] DeepSeek-V2-Lite at full width, depth cut from 27 to 3 layers
   (the dense lead layer and two groups of 64 experts top-6 plus 2 shared,
   MLA with a 512-wide latent cache), the same path under strict, B=2 ×
   1024 + 3: expert and row-group units fault (loads, bytes, evictions and
   refaults printed) and no kernel launches (MLA's attention is plain, as
   the reference's); then a ``full`` server of the same artifact serves the
   request (the strict tokens) and runs [graph] with bit-equal logits.
   Every wrapper's count is read on every serve path: none may launch
   the decode or gather kernels (the served decode is the plain dense one,
   as in the reference), and Mixtral's may not launch the scan.
7. modes — the paper's Table 2 through the launcher as a user runs it:
   ``python -m repro_torch.launch.serve`` in after2, before and after1
   (its default stats policy, without the prefetcher and with
   ``--profile-out``: [retier]'s profiling run) on Mixtral-8x22B at full
   width cut to 1 layer, bf16 weights (a ≈29 GB before bundle with the
   fp32 AdamW moments), B=2 × 1024 + 4. Each must exit 0 and print its ``[serve]``
   lines; bytes read must shrink strictly and the tokens agree. Free disk
   and host RAM are printed first.
   Beside it, in this process (the launchers' card idles while they write
   and read their bundles), the two modal families, served text-only as the
   reference serves them: [whisper] whisper-base (arXiv:2212.04356) at full
   width and depth (d_model 512, 8 / 8 heads of 64, 6 decoder and 6 encoder
   layers, tied 51865-row table), B=2 × 448 + 3; [llama-vision]
   Llama-3.2-Vision at full width (d_model 8192, 64 / 8 heads of 128, d_ff
   28672, vision_dim 7680, 1601 image tokens), depth cut from 100 to 5 (four
   self layers and one gated cross layer), B=2 × 1024 + 3. Each first runs
   one multimodal prefill on its seeded weights (audio frames (2, 448, 512);
   image embeddings (2, 1601, 7680), the VLM's text-only logits held equal
   to its multimodal ones with the gates at zero, then both gates set to
   0.5): flash once per decoder self layer (the encoder and every cross-
   attention are plain, as in the reference), logits against the plain
   attention within ZOO_LOGITS_REL_TOL of the max |logit|. Then analyze
   (the ``_text_only`` entries) → build_artifact → cold_start(strict) →
   generate: flash once per self layer in every prefill run and no other
   kernel; tier-1 is the encoder and the decoder's cross-attention
   (Whisper: 0 faults) or the cross block and the vocab row groups (the
   VLM: row groups fault, never the cross block); then [graph] on the
   strict server, bit-equal.
8. traffic — the launcher's traffic mode once: Mixtral-8x22B at full width
   cut to 1 layer, bf16, ``full``, ``--concurrency 4 --requests 8
   --prompt-len 256 --gen-steps 8``; exit 0 with 8/8 requests done.
9. reduced — the reference's main-path command on the card, five launcher
   processes run four at a time:
   ``python -m repro_torch.launch.serve --arch mixtral-8x22b --reduced
   --param-dtype bfloat16`` (head_dim 16 through the padded kernel), B=2 ×
   16 + 8, the same command with the plain attention in the kernel's
   place, the same command with ``--retier-online --retier-interval 1
   --host-budget-bytes 200000 --snapshot-out``, then with ``--restore-from``
   that snapshot, then with ``--fleet 2``: exit 0, flash launches > 0 (none
   in the plain run), equal tokens (each fleet replica's too); the online
   run prints its ``[serve] host arbiter:`` and ``[serve] online retier:``
   lines and absorbed no error; the restore run replays at least one unit
   with the predictor armed; the fleet's pushes and pulls all held.
10. retier — its own process, mostly host zlib, started as soon as the
   modes phase's after2 run (which goes first) has ended, beside that
   phase's before and after1 runs and phases 8 and 9:
   profile → re-tier → re-serve through the launcher, Mixtral at
   full width cut to 1 layer, bf16, stats, B=2 × 1024 + 4: the modes
   phase's after2 run profiled (``--no-prefetch --profile-out``), then
   ``--retier-from``. Prints each run's fault bytes and
   count, cold-start read/upload, tier-0 bytes, the re-tier report and the
   raw-copied / recompressed frame counts; the tokens must be equal.
11. mesh — the device mesh on a world of one (``launch.mesh``: NCCL on an
   in-memory store). (a) Started with [retier] once the modes phase's
   after2 run has ended, the launcher as that run with ``--mesh 1x1`` on its own
   artifact directory: the same tokens, cold-start bytes read, faulted units
   and bytes, and flash launches (> 0) as that run, every leaf's shard
   divisor 1, its entries' kind printed (a mesh of 1s gathers with no
   collective, so the warm set is still captured as CUDA graphs). (b) On the
   in-process thread after [train]: ``reshard_for_mesh`` of [train]'s last
   checkpoint onto a 1×1 mesh on the card, every leaf bit-equal to the host
   arrays; one resumed ``Trainer(mesh=1×1)`` step (xLSTM's step on shards,
   ``Trainer._run_on_shards``) beside the same step with no mesh, loss and
   params bit-equal, no kernel launched. (c) Then
   ``gpipe_forward`` over a 1-stage mesh equals ``stage_fn`` on each
   microbatch and ``compressed_psum`` over a 1-rank ``pod`` dim equals
   ``dequantize_int8(quantize_int8(g))``, bit for bit. (d) In the serial
   section before [dryrun] (b), compute on shards at full width, B=2 ×
   1024, each family of MESH_FAMILIES as the 16 ``model`` ranks of the
   production mesh run one after another in this process
   (``sharding.comm.run_ranks``), each from its own copies of its blocks:
   Mixtral-8x22B's first layer, Gemma-3-27B's first 5:1 unit (6 layers),
   DeepSeek-V2-Lite's dense lead and one MoE layer, RecurrentGemma-9B's
   rec, rec, attn, whisper-base at full depth over (2, 1500, 512) audio
   frames (B=2 × 448), Llama-3.2-Vision's four self and one gated cross
   layer over (2, 1601, 7680) image embeddings (both gates set to
   GATE_CHECK) and xlstm-125m's m and s blocks. Each: logits within
   MESH_LOGITS_REL_TOL of max |logit| of the unsharded layers, greedy ids
   across ranks equal where no near-tie, its collective bytes a rank, and
   its launches: flash 16 / 96 / 0 / 16 / 96 / 64 / 0 (one a rank a
   decoder self-attention layer, at its own heads or, where 16 does not
   divide them, at all of them; the encoder and cross-attention are plain),
   scan 32 for RecurrentGemma only (one a rank a rec layer, at its 256
   channels). DeepSeek's bf16
   run is printed and its fp32-compute run held, within MESH_FP32_REL_TOL
   (its router flips experts at near-ties under bf16 rounding).
12. dryrun — the production-mesh dry run (``launch.dryrun``), no kernel
   launched (its cells run the plain versions, as the reference lowers with
   ``use_pallas=False``). (b) In the serial section after [deepseek], with
   nothing else on the card: the 1×1 anchor, Mixtral-8x22B's decode_32k
   cell (B=128 against a 32768-token cache) cut to 1 layer, traced on a
   one-rank fake world with fake tensors on the card, then the same step
   run for real on seeded bf16 weights and caches: the measured arguments
   (``memory_allocated`` before the step) equal the traced ones up to the
   allocator's rounding (under ALLOC_ROUND bytes a tensor); the measured peak
   (``max_memory_allocated`` after ``reset_peak_memory_stats``, over a
   warmed step) is within DRYRUN_PEAK_REL_TOL of the traced peak plus
   DRYRUN_PEAK_ABS_TOL; the logits are finite of the cell's shape; the
   median of DRYRUN_STEP_REPS steps (CUDA events) is not below the cell's
   roofline bound (``utils.hlo.Roofline`` at the H100's datasheet peaks: a
   step that beats it means the counter missed work); its traced peak stays
   under 30 GB and its wall under 30 s; no kernel launched. Its fake world
   is destroyed before the thread's [mesh] starts one. (a) Beside the modes
   block, in its own process (the fake world of 256 ranks and [mesh]'s
   one-rank NCCL world are both a process's default group): ``python -m
   repro_torch.launch.dryrun --arch mixtral-8x22b --shape all`` on the
   16×16 fake world (DRYRUN_JOBS cells at once, each in its own process;
   the serving cells trace the sharded step, and so does train_4k, B=256
   × 4096: ``Trainer(mesh=)``'s step on shards, each weight gathered over
   ``data`` at its use and its gradient reduce-scattered into the rank's
   fp32 block), host only, within DRYRUN_TIMEOUT_S: exit 0, every
   record ``ok`` or ``skipped``, each cell's line printed, and each
   ``argument_size_in_bytes`` equal to the closed form from
   ``param_shardings`` and the activation rules over
   ``production_mesh_shape()``; each cell's arguments, peak, ``fits``, dot
   FLOPs and collective bytes by kind printed, and the train cell on shards
   (``train_on_shards``), with a reduce-scatter among its collectives and
   ``fits`` true. (c) In the serial section after (b): the 1×1 train
   anchors of DRYRUN_TRAIN_ANCHORS one after another, each at full width
   cut in depth, B=1 × 1024, fp32 masters and AdamW moments (Mixtral-8x22B
   at 1 layer, Gemma-3-27B at 1, DeepSeek-V2-Lite at 2: its dense lead and
   one MoE layer, RecurrentGemma-9B at 3: rec, rec, attn, whisper-base whole
   over (1, 1024, 512) frames, Llama-3.2-Vision-90B at one gated cross
   block over (1, 1601, 7680) image embeddings, xlstm-125m at 2: m, s, at
   B=1 × 256): each train cell
   traced on a one-rank fake world, then run on a one-rank NCCL world on
   seeded weights: arguments and peak traced against measured as in (b); the loss
   and every gradient leaf of the step on shards (``sharded_grads``) bit-equal
   to the unsharded ``accumulated_grads`` of ``Model.loss_fn``, which
   ``make_train_step`` runs; the median step beside its roofline bound; no
   kernel launched.
Each phase's wall time is printed on the ``[time]`` line.

The last lines: ``nvidia-smi`` name and power limit, a JSON line with the
kernels' numbers, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --modal-alone | --dryrun-alone

builds the kernels, then runs only [whisper] and [llama-vision], one after
the other with nothing beside them (their host times without the modes
phase's contention), and prints their lines and the ``[time]`` line but no
kernels or result line; ``--dryrun-alone`` does the same for [dryrun] (b),
(c), then (a).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
# decode (dense and paged): one query over many keys averages V, so outputs
# sit well below 1 (≈ sqrt(e / kv_len) for random inputs) and a limit per
# unit of max(1, |plain|) would be as large as a typical value. Both versions
# round to bf16, so they differ by up to one bf16 ulp of the largest output,
# m·2^-7 ≈ 0.0078·m (P rounded to bf16 in the kernel moves the fp32 value by
# far less): the limit is 1e-2 of max |plain output|
DECODE_TOL = 1e-2
# served prefill: bf16 logits of O(1) after layers whose attention
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
# Gemma-3's served prefill (6 layers, tied 262144-row table), kernel vs plain
# attention, as a fraction of the plain path's max |logit|: the same bf16
# rounding of the attention outputs walking through fewer residual blocks
# than RecurrentGemma's, so RecurrentGemma's limit holds with room to spare
ZOO_LOGITS_REL_TOL = RG_LOGITS_REL_TOL

# paged KV: the scheduler's default page size, and 8 slots of ragged length
PAGE_SIZE = 16
PAGED_LENS = (4096, 3000, 2048, 1500, 1024, 700, 100, 17)
# the same slots at 8x the lengths: 409 MB of K/V at Mixtral's widths, 102 MB
# at hd 256, past the card's 50 MB of L2
PAGED_LENS_HBM = tuple(8 * n for n in PAGED_LENS)
# the rolling paged path: slot 0 starts past the 4096 window, slot 1 wraps
ROLLING_PREFIXES = (5000, 4090, 2048, 1500, 1024, 700, 100, 17)
VOCAB, D_MODEL, D_FF, ROW_GROUP = 32768, 6144, 16384, 2048  # Mixtral's table, expert and vocab_row_group

H, HKV, HD = 48, 8, 128  # Mixtral-8x22B attention widths
# the serve and stats phases' Mixtral depth: 1 of 56 layers keeps the whole
# run, the [mesh] launcher beside the modes block included, well inside its
# 1200 s (2 layers took it past 1000 s)
PROMPT, NEW_TOKENS, BATCH, LAYERS = 1024, 16, 2, 1
# Mixtral's served request is B=2 × 1024 + 3: its strict budget is below one
# decode step's working set, so every step faults gigabytes (PERF.md §5); cut
# from 8 new tokens to keep the run well inside its time limit
MIXTRAL_NEW_TOKENS = 3
MODES_NEW_TOKENS = 4  # the modes phase's request: B=2 × 1024 + 4
# [online]: the strict request, B=2 × 1024 + 3, with the daemon ticking after
# every step; [arbiter]: two tenants, each B=2 × 1024 + 2, on one budget
ONLINE_NEW_TOKENS, ARBITER_NEW_TOKENS = 3, 2
ARBITER_JOIN_S = 600.0  # a tenant thread still running then is a hang: the phase fails
# [fleet]: two replicas on the strict artifact, each serving B=2 × 1024 + 1
FLEET_NEW_TOKENS = 1
# the scheduler phase: 4 slots, 8 requests of alternating prompt lengths and
# new-token counts, so slots free at different steps; an admission round of
# 4 consecutive requests holds at most 2 of either length, so no group passes
# 2 × 512 = 1024 tokens, where serving MoE stops being dropless
SCHED_BATCH, SCHED_REQUESTS, SCHED_PROMPTS, SCHED_STEPS = 4, 8, (256, 512), (8, 12, 16)
# [entries]: prompt lengths served on Mixtral's full server, longest first,
# so each one past the bound replaces a larger entry: N + 3 of them, N the
# server's max_prefill_entries
ENTRY_PROMPTS = (1000, 900, 800, 700, 600, 500, 400)
# [reduced]: the launcher's reduced Mixtral request, B=2 × 16 + 8, and the host
# budget of its online run (under reduced bf16's 0.46 MB of tier-1)
REDUCED_PROMPT, REDUCED_NEW_TOKENS, REDUCED_HOST_BUDGET = 16, 8, 200000
REDUCED_TRAIN_STEPS = 4  # [reduced]'s training launcher run
RG_H, RG_HKV, RG_HD, RG_WINDOW, RG_WIDTH = 16, 1, 256, 2048, 4096  # RecurrentGemma-9B
# RecurrentGemma's served depth: one (rec, rec, attn) group and a (rec, rec)
# tail, every layout section and both kernels of the 38-layer stack (cut from
# 38 to fit the new phases in the time limit)
RG_LAYERS = 5
GEMMA_H, GEMMA_HKV, GEMMA_HD, GEMMA_WINDOW = 32, 16, 128, 1024  # Gemma-3-27B
# [gemma3]: one 5:1 unit of Gemma-3-27B; [deepseek]: DeepSeek-V2-Lite's dense
# lead layer and two MoE groups; each B=2 × 1024 + 3, the prompt as long as
# Gemma's window (the longest the prefill graft of both packages takes)
GEMMA_LAYERS, DEEPSEEK_LAYERS, ZOO_NEW_TOKENS = 6, 3, 3
# [whisper]: whisper-base at full depth (6 decoder and 6 encoder layers),
# B=2 × 448 + 3, 448 its decoder context; [llama-vision]: one 4-self:1-cross
# unit of Llama-3.2-Vision, B=2 × 1024 + 3
WHISPER_LAYERS, WHISPER_PROMPT, LLAMA_VISION_LAYERS = 6, 448, 5
# [xlstm]: xlstm-125m at full width and depth (no cut: 134 M params), B=2 ×
# 1024 + 3; 1024 is 8 chunks of 128, so the prefill takes the chunkwise
# mLSTM. The analyzer traces it at S = XLSTM_TRACE_S (the plan does not
# depend on S; the sLSTM's step loop makes a long trace slow)
XLSTM_TRACE_S = 8
# [train]: the same model trained at B = TRAIN_BATCH × S = TRAIN_SEQ (4
# chunks: the chunkwise mLSTM) for TRAIN_STEPS steps straight, beside a run
# stopped at half and resumed by a fresh Trainer; the restored server's
# request is B=2 × TRAIN_PROMPT + ZOO_NEW_TOKENS
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROMPT = 8, 512, 6, 64
WHISPER_H, WHISPER_HKV, WHISPER_HD = 8, 8, 64
LLAMA_H, LLAMA_HKV, LLAMA_HD = 64, 8, 128
# the VLM's gates in the multimodal prefill check: tanh(0.5) ≈ 0.46, so the
# image path moves the logits (at their init, zero, it would not)
GATE_CHECK = 0.5
# the VLM with zero gates: text-only logits against multimodal ones, the
# reference's test_vlm_text_only_matches_zero_image limit (an image adds
# tanh(0) · y = 0 to the residual, so they should be bit-equal)
ZERO_GATE_TOL = 1e-4
# [dryrun] (a): the dry run of Mixtral's four shapes on the 16×16 fake world,
# a host-only subprocess beside the modes block, killed after this many seconds
DRYRUN_TIMEOUT_S = 300
# its cells traced two at a time, each in a process of its own: on the H100
# machine's host prefill_32k took 92.7 s of the four cells' 189.4 s in one
DRYRUN_JOBS = 2
# [dryrun] (b): the 1×1 anchor, Mixtral-8x22B's decode_32k cell (B=128
# against a 32768-token cache, the 4096-row SWA window) cut to 1 layer: traced
# with fake tensors on the card, then run for real with seeded bf16 weights
DRYRUN_ANCHOR = ("mixtral-8x22b", "decode_32k", 1)
# the caching allocator rounds each block up to a multiple of 512 B, so the
# measured arguments may exceed their bytes by under 512 B a tensor
ALLOC_ROUND = 512
# and a request of 1 MiB or more keeps in its block a rest of its segment
# or of a cached block of no more than 1 MiB (it splits off only a larger
# one): Gemma-3's 441 MiB fp32 MLP blocks take 442 MiB, and a rank's 1-10 MiB
# tensors may fill the end of a 20 MiB segment. The train anchors read each
# block's size from the allocator's snapshot (``_block_rests``)
# measured peak (arguments + the step's temporaries) against the traced peak:
# within 2% of the traced peak plus 64 MiB (a cached block reused for a
# smaller request keeps up to 1 MiB unsplit, and library workspaces)
DRYRUN_PEAK_REL_TOL, DRYRUN_PEAK_ABS_TOL = 0.02, 64 * 2**20
# the anchor's limits: its traced peak, and its whole wall time
DRYRUN_ANCHOR_MAX_BYTES, DRYRUN_ANCHOR_MAX_S = 30e9, 30.0
DRYRUN_STEP_REPS = 7  # timed steps (the median is kept)
# [dryrun] (c): the 1×1 train anchors, (arch, B, S, layers), each at full
# width and B=1 × 1024: Mixtral-8x22B cut to 1 layer (2.91e9 params: 34.9 GB
# of fp32 masters and moments, 11.6 GB of fp32 gradients beside them);
# Gemma-3-27B cut to 1 layer, its fewest (a local one; 1.82e9 params, 1.41e9
# of them the tied 262,144-row table: 21.9 GB of fp32 state); DeepSeek-V2-Lite
# cut to 2 layers, the dense lead and one MoE layer (1.1e9 params);
# RecurrentGemma-9B cut to 3 layers, rec, rec, attn (1.7e9 params);
# whisper-base whole, 6 encoder and 6 decoder layers, its batch with
# (1, 1024, 512) frames; Llama-3.2-Vision-90B cut to one gated cross block
# (a fifth field: ``vlm.cross_attn_every`` 1, so its one layer is the cross
# kind; 2.95e9 params, a 1.05e9 embedding, a 1.05e9 head and a 0.85e9 cross
# block), its batch with (1, 1601, 7680) image embeddings; xlstm-125m cut to
# 2 layers, m and s, at B=1 × 256 (its plain sLSTM loop is launch-bound)
DRYRUN_TRAIN_ANCHORS = (("mixtral-8x22b", 1, 1024, 1), ("gemma3-27b", 1, 1024, 1),
                        ("deepseek-v2-lite-16b", 1, 1024, 2), ("recurrentgemma-9b", 1, 1024, 3),
                        ("whisper-base", 1, 1024, 6), ("llama-3.2-vision-90b", 1, 1024, 1, 1),
                        ("xlstm-125m", 1, 256, 2))
# each anchor's traced peak, and its whole wall time (trace, placement, both
# gradients' comparison, the timed steps)
DRYRUN_TRAIN_MAX_BYTES, DRYRUN_TRAIN_MAX_S = 78e9, 90.0
# [mesh] (d): Mixtral-8x22B's first layer at full width as the 16 "model"
# ranks of the production mesh, run one after another in this process
# (``sharding.comm.run_ranks``), held to the unsharded layer. Each rank's
# attention output and expert output are partial sums rounded to bf16 and
# added over 16 ranks; a CPU rehearsal in bf16 (d_model 1024, 48 / 8 heads of
# 128, 8 experts of d_ff 2048, B=1 ... 2 × 256) moved the logits by 1.06% of
# their max |logit|, so 5% leaves a 5x margin and still catches a missing or
# doubled reduction (a whole rank's share, ~1/16 of the output or more)
MESH_SHARD_RANKS = 16
MESH_LOGITS_REL_TOL = 0.05
# DeepSeek-V2-Lite's top-6-of-64 router turns a bf16 rounding difference
# into another expert wherever two choices nearly tie, and one such flip on
# a compared row moves its logits by a share no tolerance separates from a
# missing reduction (8.69% of max |logit| on the card, no row clear of a
# near-tie). Its layers are held in fp32 compute instead (bf16 weights cast
# at use; MLA and the MoE launch no kernel), where the ranks' partial sums
# differ only by fp32 rounding (3e-6 of max |logit| on the card); the bf16
# run is printed, not held
MESH_FP32_REL_TOL = 1e-3
# [mesh] (d)'s families: (arch, depth, compute dtype, limit as a share of
# max |logit|, None for a run printed and not held). Mixtral's first layer,
# one 5:1 unit of Gemma-3, DeepSeek's dense lead layer and one MoE layer,
# RecurrentGemma's rec, rec, attn, Whisper at full depth (6 encoder and 6
# decoder layers), one 4-self:1-cross unit of the VLM and xLSTM's m, s
# (every block kind of each stack once); the modal two with their
# multimodal batch (MESH_MODAL_INPUTS)
MESH_FAMILIES = (("mixtral-8x22b", 1, "bfloat16", MESH_LOGITS_REL_TOL),
                 ("gemma3-27b", 6, "bfloat16", MESH_LOGITS_REL_TOL),
                 ("deepseek-v2-lite-16b", 2, "bfloat16", None),
                 ("deepseek-v2-lite-16b", 2, "float32", MESH_FP32_REL_TOL),
                 ("recurrentgemma-9b", 3, "bfloat16", MESH_LOGITS_REL_TOL),
                 ("whisper-base", WHISPER_LAYERS, "bfloat16", MESH_LOGITS_REL_TOL),
                 ("llama-3.2-vision-90b", LLAMA_VISION_LAYERS, "bfloat16", MESH_LOGITS_REL_TOL),
                 ("xlstm-125m", 2, "bfloat16", MESH_LOGITS_REL_TOL))
# the modal families' [mesh] (d) prefill: Whisper's B=2 × 448 tokens over 30 s
# of audio frames (the 1500 its decode caches hold), the VLM's B=2 × 1024
# over its 1601 image tokens; both gates of the VLM's cross block set to
# GATE_CHECK after init, so the image path moves the logits
MESH_MODAL_INPUTS = {"whisper-base": (WHISPER_PROMPT, "frames", (1500, 512)),
                     "llama-3.2-vision-90b": (PROMPT, "image_embeds", (1601, 7680))}
# flash attention: (H, Hkv, hd) and its (B, S, window, causal, softcap) rows, the served prefill first
FLASH_ROWS = (
    ((H, HKV, HD), [(BATCH, PROMPT, 4096, True, None),
                    (1, 8192, 4096, True, None),
                    (2, 2048, None, True, None),
                    (1, 2048, None, False, 50.0)]),  # every key tile unmasked, the softcap on
    ((RG_H, RG_HKV, RG_HD), [(BATCH, PROMPT, RG_WINDOW, True, None),
                             (1, 8192, RG_WINDOW, True, None)]),
    # Gemma-3's GQA group 2: its local layers' prefill (window 1024 = S, so
    # it cuts nothing), its global layers' (no window), and a longer prompt
    # where the window masks
    ((GEMMA_H, GEMMA_HKV, GEMMA_HD), [(BATCH, PROMPT, GEMMA_WINDOW, True, None),
                                      (BATCH, PROMPT, None, True, None),
                                      (1, 4096, GEMMA_WINDOW, True, None)]),
    # the reduced configs' head dims, zero-padded to 64 by the wrapper:
    # reduced Mixtral (H=4, Hkv=2, hd 16, window 32) at the [reduced] phase's
    # prefill and at 1024 tokens, reduced Yi (H=8, Hkv=2, hd 8, no window)
    ((4, 2, 16), [(BATCH, REDUCED_PROMPT, 32, True, None), (BATCH, PROMPT, 32, True, None)]),
    ((8, 2, 8), [(BATCH, PROMPT, None, True, None)]),
    # Whisper's decoder (hd 64, G = 1) at its served prefill, and
    # Llama-3.2-Vision's self layers (G = 8)
    ((WHISPER_H, WHISPER_HKV, WHISPER_HD), [(BATCH, WHISPER_PROMPT, None, True, None)]),
    ((LLAMA_H, LLAMA_HKV, LLAMA_HD), [(BATCH, PROMPT, None, True, None)]),
    # one of the 16 "model" ranks of Mixtral's sharded prefill ([mesh] (d)):
    # its 3 local q heads read one kv head (G = 6 does not divide 16 ranks)
    ((H // MESH_SHARD_RANKS, 1, HD), [(BATCH, PROMPT, 4096, True, None)]),
    # one of the 16 ranks of Gemma-3's sharded prefill: 2 q heads, 1 kv head,
    # its local layers' window and its global layers' none
    ((GEMMA_H // MESH_SHARD_RANKS, GEMMA_HKV // MESH_SHARD_RANKS, GEMMA_HD),
     [(BATCH, PROMPT, GEMMA_WINDOW, True, None), (BATCH, PROMPT, None, True, None)]),
    # one of the 16 ranks of RecurrentGemma's: 1 q head against the MQA head
    ((RG_H // MESH_SHARD_RANKS, RG_HKV, RG_HD), [(BATCH, PROMPT, RG_WINDOW, True, None)]),
    # one of the 16 ranks of Llama-3.2-Vision's self layers: 4 q heads in one
    # GQA group read one kv head (8 kv heads do not divide 16 ranks).
    # Whisper's ranks run all 8 of its heads (8 do not divide 16): its row above
    ((LLAMA_H // MESH_SHARD_RANKS, 1, LLAMA_HD), [(BATCH, PROMPT, None, True, None)]),
)


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


def _time_graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times between CUDA events, so no host work (argument
    checks, allocation, the ctypes call) sits in the timed region."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _errors(out, ref) -> tuple[float, float]:
    """Max abs error and max error per unit of max(1, |ref|)."""
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), (diff / ref.float().abs().clamp_min(1.0)).max().item()


def _check_decode(what: str, out, ref) -> tuple[float, float]:
    """Max abs error and max |ref|; raises past DECODE_TOL of max |ref|."""
    err, scale = (out.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    if not err <= DECODE_TOL * scale:
        raise AssertionError(f"{what}: max abs err {err} past {DECODE_TOL} of max |plain| {scale}")
    return err, scale


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def _print_row(kind: str, label: str, row: dict) -> None:
    lib = row.get("library_ms", row.get("yardstick_ms"))
    scale = f" (max |plain| {row['max_abs_plain']:.3g})" if "max_abs_plain" in row else ""
    print(f"[kernel] {kind} {label}: max_abs_err={row['max_abs_err']:.3g}{scale} kernel {row['ms']:.4f} ms "
          f"(eager {row['eager_ms']:.4f}), plain {row['plain_ms']:.4f} ms, library {lib} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)


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
    (B, S, window, causal, softcap) of ``shapes`` (the served prefill first)."""
    import torch
    import torch.nn.functional as F

    H, HKV, HD = widths
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for B, S, window, causal, softcap in shapes:
        opts = dict(causal=causal, window=window, softcap=softcap)
        q = torch.randn(B, S, H, HD, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(B, S, HKV, HD, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(B, S, HKV, HD, generator=gen, device="cuda").to(torch.bfloat16)
        out = fa_ops.flash_attention(q, k, v, **opts)
        torch.cuda.synchronize()
        ref = fa_ops.flash_attention_plain(q.float(), k.float(), v.float(), **opts)
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        scaled = (diff / ref.abs().clamp_min(1.0)).max().item()
        del ref, diff
        if not scaled <= KERNEL_TOL:
            raise AssertionError(f"kernel vs plain at B={B} S={S} {opts}: max abs err {err}, "
                                 f"{scaled} per unit of output magnitude")
        def kernel():
            return fa_ops.flash_attention(q, k, v, **opts)

        ms, eager_ms = _time_graph_ms(kernel), _time_ms(kernel, iters=20)
        qf, kf, vf = q.float(), k.float(), v.float()
        plain_ms = _time_ms(lambda: fa_ops.flash_attention_plain(qf, kf, vf, **opts), iters=3, warmup=1)
        del qf, kf, vf
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if softcap is not None:  # no single PyTorch call applies a logit softcap
            library_ms = None
        elif window is None or window >= S:  # the window cuts nothing: plain (causal) attention
            library_ms = _time_graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        else:  # sliding window as a boolean mask, built outside the timed calls
            pos = torch.arange(S, device="cuda")
            rel = pos[:, None] - pos[None, :]
            mask = (rel < window) & (rel >= 0 if causal else True)
            library_ms = _time_graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5, reps=2)
            del pos, rel, mask
        del qt, kt, vt
        flops = 4 * B * H * HD * _pairs(S, S, causal, window)
        nbytes = 2 * (2 * B * S * H * HD + 2 * B * S * HKV * HD)  # q, o, k, v once each
        rows.append(dict(B=B, S=S, H=H, Hkv=HKV, hd=HD, window=window, causal=causal, softcap=softcap,
                         max_abs_err=err, max_scaled_err=scaled, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                         library_ms=library_ms, tflops=flops / ms / 1e9, **_bound(flops, nbytes)))
        r = rows[-1]
        print(f"[kernel] flash hd={HD} H={H} Hkv={HKV} B={B} S={S} window={window} causal={causal} "
              f"softcap={softcap}: max_abs_err={err:.3g} kernel {ms:.4f} ms (eager {eager_ms:.4f}), "
              f"{r['tflops']:.1f} TFLOP/s, {100 * r['bound_ms'] / ms:.1f}% of bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); plain {plain_ms:.4f} ms, sdpa {library_ms} ms", flush=True)
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def scan_phase(lru_ops, plans: bool = True) -> list[dict]:
    """Kernel vs plain RG-LRU scan at the served prefill's (B, S, W) and at a
    longer one, fp32. ``plans``: report the lane plan (kernel_ab.py compares
    versions through their wrappers only and passes False)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    # the served prefill, a longer one, and one of 16 "model" ranks' channels ([mesh] (d))
    for B, S, W in ((BATCH, PROMPT, RG_WIDTH), (1, 8192, RG_WIDTH), (BATCH, PROMPT, RG_WIDTH // MESH_SHARD_RANKS)):
        # decays in RecurrentGemma's band (a = sigmoid(Λ)^(c·r) ∈ (0, 1))
        a = torch.rand(B, S, W, generator=gen, device="cuda") * 0.5 + 0.499
        b = torch.randn(B, S, W, generator=gen, device="cuda")
        out = lru_ops.rglru_scan(a, b)
        torch.cuda.synchronize()
        ref = lru_ops.rglru_scan_plain(a, b)
        diff = (out - ref).abs()
        err = diff.max().item()
        scaled = (diff / ref.abs().clamp_min(1.0)).max().item()
        bit_equal = torch.equal(out, ref)
        del ref, diff, out
        if not (scaled <= SCAN_TOL and bit_equal):
            raise AssertionError(f"scan kernel vs plain at B={B} S={S} W={W}: max abs err {err}, "
                                 f"{scaled} per unit of state magnitude, bit-equal {bit_equal}")
        def kernel():
            return lru_ops.rglru_scan(a, b)

        ms, eager_ms = _time_graph_ms(kernel), _time_ms(kernel, iters=20)
        plain_ms = _time_ms(lambda: lru_ops.rglru_scan_plain(a, b), iters=3, warmup=1)
        n = B * S * W
        t_bytes = 3 * n * 4 / PEAK_HBM_BYTES * 1e3  # a, b read once, s written once
        t_ops = 2 * n / PEAK_FP32_FLOPS * 1e3  # one multiply and one add per element
        plan = {}
        if plans:
            plan = dict(zip(("lanes_per_block", "blocks", "threads_per_block"),
                            lru_ops.lane_plan(B, W, lru_ops.sm_count(a.device))))
        rows.append(dict(B=B, S=S, W=W, max_abs_err=err, max_scaled_err=scaled, bit_equal=bit_equal, ms=ms,
                         eager_ms=eager_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes", lanes=B * W, **plan))
        r = rows[-1]
        where = (f"; {B * W} lanes in {plan['blocks']} blocks of {plan['lanes_per_block']} lanes, "
                 f"{plan['threads_per_block']} threads" if plan else "")
        print(f"[kernel] rglru_scan B={B} S={S} W={W}: max_abs_err={err:.3g} (bit-equal) kernel {ms:.4f} ms "
              f"(eager {eager_ms:.4f}), plain {plain_ms:.4f} ms, {100 * r['bound_ms'] / ms:.1f}% of bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){where}", flush=True)
        del a, b
    torch.cuda.empty_cache()
    return rows


def decode_phase(da_ops, plans: bool = True) -> list[dict]:
    """Dense decode kernel vs plain at the served decode's last step (Mixtral
    widths, B=2, 1024 + 16 positions), at a long cache (B=8 × 32768), at
    RecurrentGemma's rolling window (hd 256, MQA), and at a long cache read
    by few (slot, KV head) pairs (B=1 × 32768: Mixtral widths, 8 pairs, and
    hd 256 MQA, one pair), where one cluster of splits a pair would leave
    most of the card idle. ``plans``: report the split plan."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2468)
    rows = []
    shapes = ((H, HKV, HD, BATCH, PROMPT + NEW_TOKENS, False, PROMPT + NEW_TOKENS),
              (H, HKV, HD, 8, 32768, False, 32768),
              (RG_H, RG_HKV, RG_HD, BATCH, RG_WINDOW, True, RG_WINDOW + 100),
              (H, HKV, HD, 1, 32768, False, 32768),
              (RG_H, RG_HKV, RG_HD, 1, 32768, False, 32768))
    for h, hkv, hd, B, Skv, rolling, kv in shapes:
        q = torch.randn(B, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(B, Skv, hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(B, Skv, hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
        kv_len = torch.full((B,), kv, dtype=torch.int32, device="cuda")
        n = min(kv, Skv)

        def kernel():
            return da_ops.decode_attention(q, k, v, kv_len, rolling=rolling)

        def plain():
            return da_ops.decode_attention_plain(q, k, v, kv_len.clamp(max=Skv), rolling=rolling)

        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err, scale = _check_decode(f"decode kernel vs plain at B={B} Skv={Skv} hd={hd}", out, ref)
        qt, kt, vt = q[:, :, None, :], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(Skv, device="cuda") < n)[None, None, None, :].expand(B, 1, 1, Skv)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        _, lib_scaled = _errors(sdpa()[:, :, 0], ref)
        row = dict(B=B, Skv=Skv, kv_len=kv, H=h, Hkv=hkv, hd=hd, rolling=rolling,
                   splits=da_ops.dense_plan(q, k)[1] if plans else None,
                   max_abs_err=err, max_abs_plain=scale, ms=_time_graph_ms(kernel),
                   eager_ms=_time_ms(kernel, iters=20), plain_ms=_time_ms(plain, iters=3, warmup=1),
                   library_ms=_time_graph_ms(sdpa), library_max_scaled_err=lib_scaled,
                   **_bound(4 * B * h * hd * n, 2 * (2 * B * hkv * n * hd + 2 * B * h * hd)))
        rows.append(row)
        _print_row("decode", f"hd={hd} H={h} Hkv={hkv} B={B} Skv={Skv} kv_len={kv} splits={row['splits']}", row)
        del q, k, v, qt, kt, vt, mask, out, ref
    torch.cuda.empty_cache()
    return rows


def _granted_table(tokens, ps: int):
    """A ``PagePool`` grant of ``tokens[b]`` positions to each slot b, made so
    that the physical pages are out of order: slots are granted last to
    first, and before each grant a spacer slot takes the page after the
    free list's top one and keeps it until all grants are done, so each slot
    of two pages or more skips a page. Returns the pool and its table."""
    from repro_torch.serving import PagePool

    B = len(tokens)
    pool = PagePool(sum(-(-n // ps) for n in tokens) + 2 * B, ps, 3 * B)
    for b in reversed(range(B)):
        pool.alloc(B + b, 1)  # the page this slot's grant starts with
        pool.alloc(2 * B + b, 1)  # the page it must skip
        pool.free(B + b)
        assert pool.alloc(b, tokens[b])
    for b in range(B):
        pool.free(2 * B + b)
    pool.assert_consistent()
    owned = [pool.owned(b) for b in range(B)]
    if all(p == list(range(p[0], p[0] + len(p))) for p in owned):
        raise AssertionError("the grants came out as contiguous runs: the table tests nothing")
    return pool, pool.page_table(np_max=max(len(p) for p in owned))[:B]


def paged_phase(da_ops, plans: bool = True) -> list[dict]:
    """Paged decode kernel vs plain: 8 slots of ragged length in pages of 16
    at Mixtral widths and at hd 256 / G 16, each at chip_smoke's lengths and
    at 8x them (K/V past the L2). ``plans``: report the work list's blocks."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1357)
    rows = []
    for (h, hkv, hd), lens in [(w, n) for w in ((H, HKV, HD), (RG_H, RG_HKV, RG_HD))
                               for n in (PAGED_LENS, PAGED_LENS_HBM)]:
        pool, pt_np = _granted_table(lens, PAGE_SIZE)
        B, NP = pt_np.shape
        P = pool.n_pages
        pt = torch.from_numpy(pt_np).cuda()
        q = torch.randn(B, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(P, PAGE_SIZE, hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(P, PAGE_SIZE, hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ptc = da_ops.clamp_page_table(pt, kv_len, P, PAGE_SIZE)

        def kernel():
            return da_ops.paged_decode_attention(q, k, v, pt, kv_len)

        def plain():
            return da_ops.paged_decode_attention_plain(q, k, v, ptc, kv_len)

        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err, scale = _check_decode(f"paged decode kernel vs plain at hd={hd}", out, ref)
        S = NP * PAGE_SIZE
        mask = (torch.arange(S, device="cuda")[None, :] < kv_len[:, None].long())[:, None, None, :]

        def densify_sdpa():
            kd, vd = da_ops.densify_pages(k, ptc), da_ops.densify_pages(v, ptc)
            return F.scaled_dot_product_attention(q[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
                                                  attn_mask=mask, enable_gqa=True)

        pages = sum(-(-n // PAGE_SIZE) for n in lens)  # whole pages move
        row = dict(B=B, H=h, Hkv=hkv, hd=hd, page_size=PAGE_SIZE, kv_len=list(lens), pool_pages=P,
                   table_pages=NP, blocks=da_ops.paged_plan(q, k, pt) if plans else None,
                   max_abs_err=err, max_abs_plain=scale, ms=_time_graph_ms(kernel),
                   eager_ms=_time_ms(kernel, iters=20), plain_ms=_time_ms(plain, iters=3, warmup=1),
                   library_ms=None, yardstick="densify + SDPA (two calls)", yardstick_ms=_time_graph_ms(densify_sdpa),
                   **_bound(4 * h * hd * sum(lens), 2 * (2 * pages * PAGE_SIZE * hkv * hd + 2 * B * h * hd)))
        rows.append(row)
        _print_row("paged_decode", f"hd={hd} H={h} Hkv={hkv} B={B} ps={PAGE_SIZE} NP={NP} max kv_len={max(lens)} "
                                   f"blocks={row['blocks']}", row)
        del q, k, v, out, ref, mask
    torch.cuda.empty_cache()
    return rows


def gather_phase(tg_ops) -> list[dict]:
    """Tiered gather vs plain (bit for bit) on Mixtral's embedding table."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8642)
    table = torch.randn(VOCAB, D_MODEL, generator=gen, device="cuda").to(torch.bfloat16)
    G = VOCAB // ROW_GROUP
    masks = {"all": torch.ones(G, dtype=torch.int32, device="cuda"),
             "half": (torch.arange(G, device="cuda") % 2 == 0).to(torch.int32),
             "none": torch.zeros(G, dtype=torch.int32, device="cuda")}
    rows = []
    # N = 2048 is one B=2 × 1024 prefill, N = 2 one decode step; the first row is the main one
    for N, resident, edge in ((2048, "all", False), (2048, "all", True), (2048, "half", True),
                              (2048, "none", True), (2, "all", False), (2, "half", True)):
        ids = torch.randint(0, VOCAB, (N,), generator=gen, device="cuda", dtype=torch.int32)
        if edge:
            ids[:2] = torch.tensor([-1, VOCAB], device="cuda")
        mask = masks[resident]

        def kernel():
            return tg_ops.tiered_gather(table, ids, mask, group_size=ROW_GROUP)

        def plain():
            return tg_ops.tiered_gather_plain(table, ids, mask, group_size=ROW_GROUP)

        (out, miss), (ref, ref_miss) = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(miss, ref_miss) and bool((out[miss == 1] == 0).all())):
            raise AssertionError(f"gather kernel differs from plain at N={N} {resident} edge={edge}")
        n_ok = int((miss == 0).sum())
        library_ms = None
        if resident == "all" and not edge:  # only then does index_select compute the same function
            library_ms = _time_graph_ms(lambda: torch.index_select(table, 0, ids))
        row = dict(N=N, V=VOCAB, D=D_MODEL, group_size=ROW_GROUP, resident=resident, edge_ids=edge, hits=n_ok,
                   max_abs_err=(out.float() - ref.float()).abs().max().item(), ms=_time_graph_ms(kernel),
                   eager_ms=_time_ms(kernel, iters=20), plain_ms=_time_ms(plain, iters=20), library_ms=library_ms,
                   **_bound(0, (n_ok + N) * D_MODEL * 2 + 8 * N))
        rows.append(row)
        _print_row("tiered_gather", f"N={N} resident={resident} edge_ids={edge} hits={n_ok}", row)
    del table
    torch.cuda.empty_cache()
    return rows


def gather_matmul_phase(tg_ops) -> list[dict]:
    """Tiered gather-matmul vs plain: Mixtral's table times one expert's
    (6144, 16384) weight, N=512, half the row groups resident (with ids -1
    and V), then all resident with ids in range (the two-call yardstick)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9753)
    table = torch.randn(VOCAB, D_MODEL, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(D_MODEL, D_FF, generator=gen, device="cuda") * D_MODEL**-0.5).to(torch.bfloat16)
    G = VOCAB // ROW_GROUP
    N = 512
    rows = []
    for resident in ("half", "all"):
        ids = torch.randint(0, VOCAB, (N,), generator=gen, device="cuda", dtype=torch.int32)
        if resident == "half":
            mask = (torch.arange(G, device="cuda") % 2 == 0).to(torch.int32)
            ids[:2] = torch.tensor([-1, VOCAB], device="cuda")
        else:
            mask = torch.ones(G, dtype=torch.int32, device="cuda")

        def kernel():
            return tg_ops.tiered_gather_matmul(table, w, ids, mask, group_size=ROW_GROUP)

        def plain():
            return tg_ops.tiered_gather_matmul_plain(table, w, ids, mask, group_size=ROW_GROUP)

        (out, miss), (ref, ref_miss) = kernel(), plain()
        torch.cuda.synchronize()
        err, scaled = _errors(out, ref)
        if not (torch.equal(miss, ref_miss) and bool((out[miss == 1] == 0).all()) and scaled <= KERNEL_TOL):
            raise AssertionError(f"gather-matmul kernel vs plain ({resident} resident): miss masks equal "
                                 f"{torch.equal(miss, ref_miss)}, max abs err {err} ({scaled} per unit)")
        n_ok = int((miss == 0).sum())
        row = dict(N=N, V=VOCAB, D=D_MODEL, F=D_FF, group_size=ROW_GROUP, resident=resident, hits=n_ok,
                   max_abs_err=err, max_scaled_err=scaled, ms=_time_graph_ms(kernel),
                   eager_ms=_time_ms(kernel, iters=20), plain_ms=_time_ms(plain, iters=3, warmup=1),
                   library_ms=None,
                   **_bound(2 * n_ok * D_MODEL * D_FF, (D_MODEL * D_FF + n_ok * D_MODEL + N * D_FF) * 2 + 8 * N))
        if resident == "all":
            row["yardstick"] = "index_select + matmul (two calls)"
            row["yardstick_ms"] = _time_graph_ms(lambda: torch.index_select(table, 0, ids) @ w)
        rows.append(row)
        _print_row("tiered_gather_matmul", f"N={N} resident={resident} hits={n_ok}", row)
        del out, ref
    del table, w
    torch.cuda.empty_cache()
    return rows


def paged_path_phase(wrappers: dict, rolling: bool) -> dict:
    """One Mixtral-8x22B attention layer at full width, 8 slots with ragged
    prefixes: 16 decode steps through ``paged_gqa_decode`` (kernel) and
    ``gqa_decode`` (plain dense) on the same inputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import densify_pages
    from repro_torch.models.attention import gqa_decode, paged_gqa_decode

    cfg = get_config("mixtral-8x22b")
    D, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(4242 + rolling)

    def weight(shape):
        return (torch.randn(shape, generator=gen, device="cuda") * shape[0] ** -0.5).to(torch.bfloat16)

    params = {"wq": weight((D, h * hd)), "wk": weight((D, hkv * hd)), "wv": weight((D, hkv * hd)),
              "wo": weight((h * hd, D))}
    window = cfg.sliding_window if rolling else None
    prefixes = ROLLING_PREFIXES if rolling else PAGED_LENS
    B, ps = len(prefixes), PAGE_SIZE
    # rolling: every slot's pages hold exactly the window (NP·ps = window)
    Skv = window if rolling else max(prefixes) + NEW_TOKENS
    pool, pt_np = _granted_table([window] * B if rolling else [n + NEW_TOKENS for n in prefixes], ps)
    if rolling and pt_np.shape[1] * ps != window:
        raise AssertionError("the rolling pages must hold exactly the window")
    pt = torch.from_numpy(pt_np).cuda()
    k_pages = torch.zeros(pool.n_pages, ps, hkv, hd, dtype=torch.bfloat16, device="cuda")
    v_pages = torch.zeros_like(k_pages)
    k_cache = torch.zeros(B, Skv, hkv, hd, dtype=torch.bfloat16, device="cuda")
    v_cache = torch.zeros_like(k_cache)
    for b, n in enumerate(prefixes):  # the prefix's K/V (its last `window` positions when rolling)
        positions = torch.arange(max(0, n - Skv) if rolling else 0, n, device="cuda")
        slots = positions % window if rolling else positions
        kb = torch.randn(len(positions), hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
        vb = torch.randn(len(positions), hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
        k_cache[b, slots], v_cache[b, slots] = kb, vb
        phys, off = pt[b, slots // ps].long(), slots % ps
        k_pages[phys, off], v_pages[phys, off] = kb, vb
    caps = [min(Skv, len(pool.owned(b)) * ps) for b in range(B)]

    def check_pages(when: str) -> None:
        kd, vd = densify_pages(k_pages, pt), densify_pages(v_pages, pt)
        for b, cap in enumerate(caps):
            if not (torch.equal(kd[b, :cap], k_cache[b, :cap]) and torch.equal(vd[b, :cap], v_cache[b, :cap])):
                raise AssertionError(f"densified pages differ from the dense cache for slot {b} {when}")

    check_pages("after the prefix")
    pos0 = torch.tensor(prefixes, device="cuda")
    xs = [torch.randn(B, 1, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(NEW_TOKENS)]
    for fn in wrappers.values():
        fn.launches = 0  # the paged-decode path starts here
    errs, scales, paged_ms, dense_ms = [], [], [], []
    with torch.inference_mode():
        for t in range(NEW_TOKENS):
            pos = pos0 + t
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p, k_pages, v_pages = paged_gqa_decode(params, xs[t], pos, k_pages, v_pages, pt, cfg,
                                                       rolling_window=window)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out_d, k_cache, v_cache = gqa_decode(params, xs[t], pos, k_cache, v_cache, cfg, rolling_window=window)
            torch.cuda.synchronize()
            paged_ms.append((t1 - t0) * 1e3)
            dense_ms.append((time.perf_counter() - t1) * 1e3)
            if not torch.isfinite(out_p).all():
                raise AssertionError(f"non-finite paged output at step {t}")
            err, scaled = _errors(out_p, out_d)
            if not scaled <= KERNEL_TOL:
                raise AssertionError(f"paged vs dense decode at step {t}: max abs err {err} ({scaled} per unit)")
            errs.append(err)
            scales.append(out_d.float().abs().max().item())
            check_pages(f"after step {t}")
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the paged-decode path ends here
    expected = {name: NEW_TOKENS if name == "paged_decode_attention" else 0 for name in wrappers}
    if counts != expected:
        raise AssertionError(f"paged-decode path launches {counts}, expected {expected}")
    summary = dict(mode="rolling" if rolling else "linear", window=window, B=B, prefixes=list(prefixes),
                   steps=NEW_TOKENS, pool_pages=pool.n_pages, table_pages=int(pt_np.shape[1]), launches=counts,
                   max_abs_err=max(errs), max_abs_out=max(scales),
                   paged_step_ms_median=sorted(paged_ms)[NEW_TOKENS // 2],
                   dense_step_ms_median=sorted(dense_ms)[NEW_TOKENS // 2])
    print("[paged] " + json.dumps(summary), flush=True)
    return summary


def serve_phase(wrappers: dict, workdir: Path) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
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
    warm_shapes = ((BATCH, PROMPT, PROMPT + MIXTRAL_NEW_TOKENS + 8),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(7)).cuda()

    for fn in wrappers.values():
        fn.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    result = analyze(model, profile, trace_B=1, trace_S=32)
    t1 = time.perf_counter()
    meta = build_artifact(params, result, str(artifact), compress_level=1)
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = cold_start(model, str(artifact), result, residency="strict", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8)
    per_step = _record_per_step(engine)  # [online] reads the request's faults after its 4th step
    t3 = time.perf_counter()
    out, stats = engine.generate(tokens, MIXTRAL_NEW_TOKENS)
    t4 = time.perf_counter()
    _unwrap(engine, "prefill_step", "decode_once")
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the main path ends here
    launches = counts["flash_attention"]
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
        peak_device_bytes=peak, flash_launches=launches, launches=counts, prefill_runs=prefill_runs,
        loads_by_phase=by_phase,
    )
    print("[serve] " + json.dumps(summary, default=str), flush=True)
    if out.shape != (BATCH, MIXTRAL_NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generated ids: shape {out.shape}, range [{out.min()}, {out.max()}]")
    if stats.faulted_units <= 0:
        raise AssertionError("the strict cold start faulted nothing")
    if launches < LAYERS * prefill_runs:
        raise AssertionError(f"flash kernel launched {launches} times for {prefill_runs} prefill runs "
                             f"of {LAYERS} layers")

    donor = dict(snapshot=server.snapshot(),
                 stamps={k: tiered.residency._stamp[k] for k in tiered.residency._lru},
                 unit_bytes={k: tiered.unit_charge(k) for k in tiered.residency._lru})
    server.close()
    del server, engine, tiered
    torch.cuda.empty_cache()
    summary["tokens"] = out.tolist()
    t0 = time.perf_counter()
    summary["snapshot"] = snapshot_phase(model, result, artifact, donor, wrappers, warm_shapes, workdir)
    summary["snapshot"]["wall_s"] = time.perf_counter() - t0
    summary["full"] = full_phase(model, result, artifact, tokens, out, wrappers, warm_shapes)
    summary["logits_max_abs_diff"] = summary["full"]["logits_max_abs_diff"]
    t0 = time.perf_counter()
    summary["online"] = online_phase(model, result, artifact, tokens, out, per_step, wrappers, warm_shapes)
    summary["online"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["arbiter"] = arbiter_phase(model, result, artifact, tokens, out, summary["budget_bytes"], wrappers,
                                       warm_shapes)
    summary["arbiter"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["fleet"] = fleet_phase(model, result, artifact, tokens, out, wrappers, warm_shapes)
    summary["fleet"]["wall_s"] = time.perf_counter() - t0
    shutil.rmtree(artifact, ignore_errors=True)
    return summary


def snapshot_phase(model, result, artifact: Path, donor: dict, wrappers: dict, warm_shapes, workdir: Path) -> dict:
    """[snapshot] The strict server's snapshot (taken after its request,
    before it closed) saved outside the artifact, then a strict cold start
    on the same artifact with ``restore_from=`` that path. The restore must
    match the artifact's fingerprint and bring back exactly the donor's
    resident set: restored == requested == the donor's resident count, the
    same keys with the donor's stamps, the replayed bytes those units' bytes,
    and a capture of the restored server lists the same keys in the same
    order. The server is closed without serving; its warm set's capture
    launches flash attention only."""
    import torch

    from repro_torch.core import capture_server_snapshot
    from repro_torch.core import snapshot as snap_mod
    from repro_torch.serving import cold_start

    snap, path = donor["snapshot"], workdir / "strict_snapshot.json"
    snap_mod.save(snap, str(path))
    size = path.stat().st_size
    for fn in wrappers.values():
        fn.launches = 0  # the restore path starts here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = cold_start(model, str(artifact), result, residency="strict", restore_from=str(path),
                        warm_shapes=warm_shapes)
    cold_s = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the restore path ends here
    rr, tiered = server.restore_report, server.tiered
    res = tiered.residency
    stamps = {k: res._stamp[k] for k in res._lru}
    again = capture_server_snapshot(tiered)["resident"]
    summary = dict(snapshot_bytes=size, restore=rr, cold_start=server.report.to_dict(), cold_start_wall_s=cold_s,
                   resident_units=len(stamps), resident_bytes=res.resident_bytes, budget_bytes=res.budget_bytes,
                   donor_resident_units=len(donor["stamps"]), peak_device_bytes=torch.cuda.max_memory_allocated(),
                   launches=counts, prefill_runs=len(warm_shapes))
    server.close()
    path.unlink()
    print("[snapshot] " + json.dumps(summary, default=str), flush=True)
    want_bytes = sum(donor["unit_bytes"].values())
    if not (rr["fingerprint_ok"] is True and rr["restored"] == rr["requested"] == len(donor["stamps"]) > 0
            and rr["skipped_foreign"] == 0):
        raise AssertionError(f"[snapshot] restore report {rr} against {len(donor['stamps'])} donor units")
    if stamps != donor["stamps"] or rr["moved_bytes"] != want_bytes:
        raise AssertionError(f"[snapshot] restored stamps {stamps} != donor's {donor['stamps']}, or moved "
                             f"{rr['moved_bytes']} B != {want_bytes} B")
    if again != snap["resident"]:
        raise AssertionError(f"[snapshot] the restored server captures {again}, the donor {snap['resident']}")
    _check_served_launches("mixtral-8x22b restore", counts, summary["prefill_runs"])
    del server, tiered
    torch.cuda.empty_cache()
    return summary


def fleet_phase(model, result, artifact: Path, tokens, strict_out, wrappers: dict, warm_shapes) -> dict:
    """[fleet] Two replicas on the strict artifact, each with a daemon (no
    ticks) registered through ``cold_start(fleet=, replica_name=)`` to one
    ``FleetController``, each with a budget of the whole tier-1, so what the
    phase shows is federation rather than LRU churn. ``replica-0`` cold-starts
    and serves the strict request cut to FLEET_NEW_TOKENS; the fleet syncs;
    ``replica-1`` cold-starts, is bootstrapped from the fleet's overlay
    inside ``register`` (a synchronous preload; its seconds and bytes are
    ``server.fleet_bootstrap``, which the cold-start report leaves out, as
    the reference's does) and serves the same request. Both give strict's first column;
    ``replica-1`` faults no unit; the fleet records one bootstrap and no
    failure; no daemon absorbed an error; each prefill launches flash
    attention only. Both replicas stay up until the end (two trees)."""
    import numpy as np
    import torch

    from repro_torch.core import FleetController
    from repro_torch.serving import GenerationEngine, cold_start

    fc = FleetController()
    kw = dict(residency="strict", device_budget_bytes=result.plan.tier1_bytes, retier_online=True,
              retier_interval=10**9, fleet=fc, warm_shapes=warm_shapes)
    for fn in wrappers.values():
        fn.launches = 0  # the fleet path starts here
    torch.cuda.reset_peak_memory_stats()
    servers, replicas, sync = [], {}, None
    try:
        for i in range(2):
            name = f"replica-{i}"
            t0 = time.perf_counter()
            servers.append(cold_start(model, str(artifact), result, replica_name=name, **kw))
            cold_wall = time.perf_counter() - t0
            s = servers[-1]
            preloaded = _loads_by_source(s.tiered.stats.events)
            t1 = time.perf_counter()
            out, st = GenerationEngine(s, max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8).generate(tokens, FLEET_NEW_TOKENS)
            replicas[name] = dict(
                cold_start=s.report.to_dict(), bootstrap=s.fleet_bootstrap, cold_start_wall_s=cold_wall,
                loads_at_cold_start=preloaded,
                generate_s=time.perf_counter() - t1, faulted_units=st.faulted_units, faulted_bytes=st.faulted_bytes,
                fault_s=st.fault_s, prefill_runs=st.prefill_runs, prefill_retries=st.prefill_retries,
                resident_bytes=s.tiered.resident_bytes, tokens=out.tolist())
            if i == 0:
                t2 = time.perf_counter()
                sync = fc.sync()
                sync["wall_s"] = time.perf_counter() - t2
        counts = {name: fn.launches for name, fn in wrappers.items()}  # the fleet path ends here
        for name, s in zip(replicas, servers):
            replicas[name].update(daemon=s.retier_daemon.stats.to_dict(), last_error=s.retier_daemon.last_error)
        summary = dict(replicas=replicas, sync=sync, fleet=fc.stats.to_dict(), last_errors=dict(fc.last_errors),
                       overlay_units=sum(len(ks) for ks in (fc.overlay or {}).values()),
                       budget_bytes=result.plan.tier1_bytes, peak_device_bytes=torch.cuda.max_memory_allocated(),
                       launches=counts,
                       prefill_runs=2 * len(warm_shapes) + sum(r["prefill_runs"] for r in replicas.values()))
    finally:
        for s in servers:
            s.close()
    print("[fleet] " + json.dumps(summary, default=str), flush=True)
    for name, r in replicas.items():
        if not np.array_equal(r["tokens"], strict_out[:, :FLEET_NEW_TOKENS]):
            raise AssertionError(f"[fleet] {name} tokens {r['tokens']} differ from strict's first "
                                 f"{FLEET_NEW_TOKENS} column(s)")
        if r["daemon"]["errors"] or r["last_error"]:
            raise AssertionError(f"[fleet] {name}'s daemon absorbed an error: {r['last_error']!r}")
    late = replicas["replica-1"]
    print(f"[fleet] replica-1's warm bootstrap: {late['bootstrap']['bytes']:,}B in "
          f"{late['bootstrap']['seconds']:.3f} s; its cold-start upload {late['cold_start']['upload_s']:.3f} s "
          f"({late['cold_start']['bytes_uploaded']:,}B)", flush=True)
    if late["cold_start"]["bytes_uploaded"] != late["cold_start"]["bytes_read"] or not late["bootstrap"]["bytes"] > 0:
        raise AssertionError(f"[fleet] replica-1's upload {late['cold_start']} should leave out its bootstrap "
                             f"{late['bootstrap']}")
    if late["faulted_units"] != 0 or replicas["replica-0"]["faulted_units"] <= 0:
        raise AssertionError(f"[fleet] replica-1 faulted {late['faulted_units']} units after its bootstrap "
                             f"(replica-0 {replicas['replica-0']['faulted_units']})")
    fs = summary["fleet"]
    if fs["bootstraps"] != 1 or fs["bootstrap_failures"] or fs["push_failures"] or fs["pull_failures"] \
            or summary["last_errors"] or not sync["replanned"]:
        raise AssertionError(f"[fleet] {fs}, errors {summary['last_errors']}, sync {sync}")
    _check_served_launches("mixtral-8x22b fleet", counts, summary["prefill_runs"])
    del servers
    torch.cuda.empty_cache()
    return summary


def _unwrap(obj, *names) -> None:
    """Drop the instance attributes that shadowed ``obj``'s methods: a wrapper
    holding a bound method makes a reference cycle, which would keep a
    server's device tree alive after ``del`` until the next garbage
    collection."""
    for name in names:
        vars(obj).pop(name, None)


def _record_per_step(engine) -> list:
    """Wrap the engine's step primitives to record the request's cumulative
    (faulted units, faulted bytes, fault seconds) after each step (undo with
    ``_unwrap(engine, "prefill_step", "decode_once")``)."""
    rows = []

    def wrap(fn, stats_at):
        def step(*args, **kw):
            res = fn(*args, **kw)
            st = args[stats_at]
            rows.append(dict(faulted_units=st.faulted_units, faulted_bytes=st.faulted_bytes, fault_s=st.fault_s))
            return res
        return step

    engine.prefill_step = wrap(engine.prefill_step, 1)  # (tokens, stats)
    engine.decode_once = wrap(engine.decode_once, 3)    # (decode_fn, caches, dbatch, stats)
    return rows


def online_phase(model, result, artifact: Path, tokens, strict_out, strict_steps: list, wrappers: dict,
                 warm_shapes) -> dict:
    """[online] The strict artifact and request again, with the online
    re-tiering daemon ticking after the prefill and after every decode step
    (``retier_interval=1``) and ONLINE_NEW_TOKENS new tokens. Strict has no
    prefetcher, so every promotion is a synchronous preload between steps,
    trimmed to the budget's headroom. The decode graphs have the strict
    phase's shapes; the tokens must equal strict's first columns. Prints the
    daemon's stats, each tick's residency change and the decode replays
    before it, and the request's faults beside strict's after as many steps."""
    import numpy as np
    import torch

    from repro_torch.serving import GenerationEngine, cold_start

    for fn in wrappers.values():
        fn.launches = 0  # the online path starts here
    server = cold_start(model, str(artifact), result, residency="strict", retier_online=True, retier_interval=1,
                        warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8)
    tiered, daemon = server.tiered, server.retier_daemon
    replays, ticks = [0], []
    decode_once, tick_retier = engine.decode_once, engine.tick_retier

    def counted_decode(*args, **kw):
        replays[0] += 1
        return decode_once(*args, **kw)

    def watched_tick(steps=1):
        keys = tiered.resident_keys
        tick_retier(steps)
        now = tiered.resident_keys
        ticks.append(dict(decode_replays_before=replays[0], installed=len(now - keys), evicted=len(keys - now),
                          resident_bytes=tiered.resident_bytes))

    engine.decode_once, engine.tick_retier = counted_decode, watched_tick
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, stats = engine.generate(tokens, ONLINE_NEW_TOKENS)
    wall = time.perf_counter() - t0
    _unwrap(engine, "decode_once", "tick_retier")
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the online path ends here
    ds, res = daemon.stats, tiered.residency
    # a tick that moved units and had a decode replay after it: that replay
    # read what the daemon installed or evicted
    changed = [t for t in ticks if (t["installed"] or t["evicted"]) and t["decode_replays_before"] < replays[0]]
    strict_at = strict_steps[ONLINE_NEW_TOKENS - 1]
    summary = dict(
        generate_s=wall, daemon=ds.to_dict(), last_error=daemon.last_error, ticks=ticks,
        residency_changed_before_a_replay=changed, decode_replays=replays[0],
        request=dict(faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes, fault_s=stats.fault_s,
                     prefill_retries=stats.prefill_retries, decode_retries=stats.decode_retries),
        strict_after_as_many_steps=strict_at, budget_bytes=res.budget_bytes,
        resident_bytes_at_rest=res.resident_bytes, max_resident_bytes=res.max_resident_bytes,
        overshoots=res.overshoot_events, evictions=tiered.stats.evictions, refaults=tiered.stats.refaults,
        loads_by_source=_loads_by_source(tiered.stats.events), peak_device_bytes=torch.cuda.max_memory_allocated(),
        launches=counts, prefill_runs=len(warm_shapes) + stats.prefill_runs, tokens=out.tolist())
    joined = daemon.join_compaction(60.0)
    server.close()
    print("[online] " + json.dumps(summary, default=str), flush=True)
    if not np.array_equal(out, strict_out[:, :ONLINE_NEW_TOKENS]):
        raise AssertionError(f"[online] tokens {out.tolist()} differ from strict's first {ONLINE_NEW_TOKENS} "
                             f"columns {strict_out[:, :ONLINE_NEW_TOKENS].tolist()}")
    if ds.applies < 1 or ds.invariant_checks != ds.applies:
        raise AssertionError(f"[online] {ds.applies} applies, {ds.invariant_checks} invariant checks")
    if ds.errors or ds.compact_errors or not joined:
        raise AssertionError(f"[online] the daemon absorbed {ds.errors} tick errors ({daemon.last_error!r}) and "
                             f"{ds.compact_errors} compaction errors; compaction joined {joined}")
    if res.resident_bytes > res.budget_bytes:
        raise AssertionError(f"[online] {res.resident_bytes} resident bytes at rest past the budget {res.budget_bytes}")
    if not changed:
        raise AssertionError(f"[online] no apply changed residency before a decode replay: {ticks}")
    _check_served_launches("mixtral-8x22b online", counts, summary["prefill_runs"])
    del server, engine
    torch.cuda.empty_cache()
    return summary


def arbiter_phase(model, result, artifact: Path, tokens, strict_out, budget: int, wrappers: dict,
                  warm_shapes) -> dict:
    """[arbiter] Two tenants, ``a`` and ``b``, cold-started one after the
    other from the strict artifact under one ``HostArbiter`` whose budget is
    one strict tenant's (``budget``), then each serving the strict request cut to
    ARBITER_NEW_TOKENS new tokens from its own thread, concurrently: ``b``'s
    request starts once ``a``'s prefill has returned, so ``b``'s prefill (all
    of its units pinned as they are claimed) overlaps ``a``'s decode and must
    make room from ``a``'s unpinned units. With both starting at once, each
    prefill pins the whole budget, and whether any victim is the other
    tenant's depends on how the two threads interleave. Both threads
    must finish within ARBITER_JOIN_S (a deadlock fails the phase), each with
    strict's first columns; the books audit, the host budget holds at rest
    (or overshoots were counted), the arbiter evicted, some victims across
    tenants, and ``close()`` unregisters both."""
    import threading

    import numpy as np
    import torch

    from repro_torch.core import HostArbiter
    from repro_torch.serving import GenerationEngine, cold_start

    arb = HostArbiter(budget)
    for fn in wrappers.values():
        fn.launches = 0  # the arbiter path starts here
    torch.cuda.reset_peak_memory_stats()
    servers, t0, hung = [], time.perf_counter(), []
    try:
        for name in "ab":
            servers.append(cold_start(model, str(artifact), result, residency="strict", host_arbiter=arb,
                                      tenant_name=name, warm_shapes=warm_shapes))
        cold_s = time.perf_counter() - t0
        if servers[0].tiered.residency.budget_bytes is not None:
            raise AssertionError("[arbiter] a tenant kept its private budget")
        outs, stats, errors = [None, None], [None, None], []
        a_prefilled = threading.Event()
        victims = {}  # (victim tenant, evicting thread) -> units; every evict() here is the arbiter's
        for name, s in zip("ab", servers):
            def evict(keys, _inner=s.tiered.evict, _name=name):
                got = _inner(keys)
                if got:
                    key = f"{_name} by {threading.current_thread().name}"
                    victims[key] = victims.get(key, 0) + 1
                return got
            s.tiered.evict = evict

        def serve(i):
            try:
                eng = GenerationEngine(servers[i], max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8)
                if i == 0:
                    prefill = eng.prefill_step

                    def prefill_then_signal(*args, **kw):
                        try:
                            return prefill(*args, **kw)
                        finally:
                            a_prefilled.set()
                    eng.prefill_step = prefill_then_signal
                elif not a_prefilled.wait(ARBITER_JOIN_S):
                    raise TimeoutError("tenant a's prefill never returned")
                outs[i], stats[i] = eng.generate(tokens, ARBITER_NEW_TOKENS)
                _unwrap(eng, "prefill_step")
            except Exception as e:
                errors.append(f"tenant {'ab'[i]}: {e!r}")
            finally:
                a_prefilled.set()

        threads = [threading.Thread(target=serve, args=(i,), name=f"tenant-{'ab'[i]}", daemon=True) for i in range(2)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, ARBITER_JOIN_S - (time.perf_counter() - t1)))
        hung = [t.name for t in threads if t.is_alive()]
        if hung:
            raise AssertionError(f"[arbiter] {hung} still running after {ARBITER_JOIN_S} s: a deadlock")
        wall = time.perf_counter() - t1
        counts = {name: fn.launches for name, fn in wrappers.items()}  # the arbiter path ends here
        for s in servers:
            _unwrap(s.tiered, "evict")
        if errors:
            raise AssertionError(f"[arbiter] {errors}")
        audit = arb.audit()  # raises if a tenant's charged bytes disagree with its counter
        hs = arb.stats
        summary = dict(
            budget_bytes=budget, cold_start_s=cold_s, serve_wall_s=wall, audit=audit, shares=arb.shares(),
            arbiter=hs.to_dict(), victims_by_thread=victims, peak_device_bytes=torch.cuda.max_memory_allocated(),
            tenants={n: dict(faulted_units=st.faulted_units, faulted_bytes=st.faulted_bytes, fault_s=st.fault_s,
                             prefill_retries=st.prefill_retries, decode_retries=st.decode_retries,
                             evictions=s.tiered.stats.evictions, refaults=s.tiered.stats.refaults,
                             tokens=o.tolist())
                     for n, s, st, o in zip("ab", servers, stats, outs)},
            launches=counts, prefill_runs=2 * len(warm_shapes) + sum(st.prefill_runs for st in stats))
    finally:
        if not hung:  # a hung tenant may hold the arbiter's lock, which close() takes
            for s in servers:
                s.close()
    summary["registered_after_close"] = sorted(arb.tenants)
    print("[arbiter] " + json.dumps(summary, default=str), flush=True)
    for n, o in zip("ab", outs):
        if not np.array_equal(o, strict_out[:, :ARBITER_NEW_TOKENS]):
            raise AssertionError(f"[arbiter] tenant {n} tokens {o.tolist()} differ from strict's first "
                                 f"{ARBITER_NEW_TOKENS} columns")
    if audit["pinned_bytes"] or not (audit["resident_bytes"] <= budget or hs.overshoots > 0):
        raise AssertionError(f"[arbiter] at rest: {audit}, {hs.overshoots} overshoots")
    if hs.evictions <= 0 or hs.cross_evictions <= 0:
        raise AssertionError(f"[arbiter] {hs.evictions} evictions, {hs.cross_evictions} across tenants")
    if summary["registered_after_close"] or hs.unregistered != 2:
        raise AssertionError(f"[arbiter] still registered after close(): {summary['registered_after_close']}")
    _check_served_launches("mixtral-8x22b arbiter", counts, summary["prefill_runs"])
    del servers
    torch.cuda.empty_cache()
    return summary


def _loads_by_source(events) -> dict:
    by = {}
    for e in events:
        src = by.setdefault(e.source, dict(loads=0, bytes=0))
        src["loads"] += 1
        src["bytes"] += e.nbytes
    return by


def _prefetch_summary(server, stats, counts: dict, prefill_runs: int) -> dict:
    """What a served run under a prefetching policy reports: loads by
    source, the prefetcher's counters, hit rate, stalls, faults, evictions."""
    tiered, ts = server.tiered, server.tiered.stats
    res = tiered.residency
    return dict(
        cold_start=server.report.to_dict(), budget_bytes=res.budget_bytes,
        max_resident_bytes=res.max_resident_bytes, resident_bytes_at_rest=res.resident_bytes,
        overshoots=res.overshoot_events, loads_by_source=_loads_by_source(ts.events),
        prefetch=server.prefetcher.stats.to_dict(), prefetch_hit_rate=ts.prefetch_hit_rate,
        prefetch_hits=ts.prefetch_hits, prefetch_waits=ts.prefetch_waits, misses=ts.misses,
        stall_p50_s=ts.stall_percentile(50), stall_p99_s=ts.stall_percentile(99), evictions=ts.evictions,
        refaults=ts.refaults, resident_fraction=tiered.resident_fraction(), faulted_units=stats.faulted_units,
        faulted_bytes=stats.faulted_bytes, fault_s=stats.fault_s, prefill_s=stats.prefill_s,
        decode_s=stats.decode_s, prefill_retries=stats.prefill_retries, decode_retries=stats.decode_retries,
        launches=counts, prefill_runs=prefill_runs,
    )


def _prefetch_threads() -> set:
    import threading

    return {t for t in threading.enumerate() if t.name.startswith("prefetch-")}


def _check_served_launches(path: str, counts: dict, prefill_runs: int) -> None:
    """Mixtral's served paths launch flash attention in each prefill run's
    LAYERS attention layers and no other kernel."""
    want = {name: LAYERS * prefill_runs if name == "flash_attention" else 0 for name in counts}
    if counts != want:
        raise AssertionError(f"the {path} path launched {counts}, expected {want} for {prefill_runs} prefill runs")


def _prefill_logits_check(model, server, engine, result, tokens) -> float:
    """The served prefill's logits through the kernel and through the plain
    attention on the same live weights, every unit the prompt can touch
    resident and pinned (on the ``full`` server, after its request, nothing
    moves), eagerly: within LOGITS_TOL. Returns the max abs difference."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn_mod

    tiered = server.tiered
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
    return diff


def full_phase(model, result, artifact: Path, tokens, strict_out, wrappers: dict, warm_shapes) -> dict:
    """The strict artifact again under ``full``: no budget, the prefetcher
    on. The same request must give the strict run's tokens, with 0 evictions.
    On its server, every unit resident, the prefill logits check."""
    import numpy as np
    import torch

    from repro_torch.serving import GenerationEngine, cold_start

    before = _prefetch_threads()
    for fn in wrappers.values():
        fn.launches = 0  # the full path starts here
    server = cold_start(model, str(artifact), result, residency="full", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8)
    t0 = time.perf_counter()
    out, stats = engine.generate(tokens, MIXTRAL_NEW_TOKENS)
    t1 = time.perf_counter()
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the full path ends here
    drained = server.prefetcher.drain(120.0)
    summary = dict(generate_s=t1 - t0, drained=drained,
                   **_prefetch_summary(server, stats, counts, len(warm_shapes) + stats.prefill_runs))
    evictions = server.tiered.stats.evictions
    # every tier-1 unit is resident now: the graph and scheduler phases run on it
    summary["graph"] = graph_phase("mixtral-8x22b", server, tokens, MIXTRAL_NEW_TOKENS, wrappers,
                                   {"flash_attention": LAYERS}, LOGITS_TOL)
    summary["sched"] = sched_phase(server, wrappers)
    summary["entries"] = entries_phase(server)
    # last, so its eager fp32 scores do not sit in the allocator while the
    # phases above capture graphs and read memory
    summary["logits_max_abs_diff"] = _prefill_logits_check(model, server, engine, result, tokens)
    server.close()
    summary["prefetch_threads_alive_after_close"] = len(_prefetch_threads() - before)
    print("[serve] full: " + json.dumps(summary, default=str), flush=True)
    if not np.array_equal(out, strict_out):
        raise AssertionError(f"full tokens {out.tolist()} differ from strict's {strict_out.tolist()}")
    if evictions or not drained or summary["prefetch_threads_alive_after_close"]:
        raise AssertionError(f"full: {evictions} evictions, drained {drained}, "
                             f"{summary['prefetch_threads_alive_after_close']} prefetch threads left")
    _check_served_launches("mixtral-8x22b full", counts, summary["prefill_runs"])
    del server, engine
    torch.cuda.empty_cache()
    return summary


def entries_phase(server) -> dict:
    """[entries] On Mixtral's full server (every unit resident), B=2 prompts
    of ENTRY_PROMPTS lengths, longest first, each its own prefill entry, then
    the same lengths again: the entries outside the warm set never pass the
    server's bound, memory_allocated never passes its value at the bound's
    N-th length, and each length's tokens after its entry was evicted and
    captured again equal its first tokens. Prints allocated and reserved
    bytes after each request."""
    import numpy as np
    import torch

    from repro_torch.serving import GenerationEngine

    t0 = time.perf_counter()
    N = server.max_prefill_entries
    engine = GenerationEngine(server, max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8)  # the warm decode entry
    prompt = torch.randint(0, server.model.cfg.vocab_size, (BATCH, max(ENTRY_PROMPTS)),
                           generator=torch.Generator().manual_seed(9)).to(server.device)
    rows, first = [], {}
    for rnd in (0, 1):
        for S in ENTRY_PROMPTS:
            out, _ = engine.generate(prompt[:, :S], 2)
            torch.cuda.synchronize()
            held = [k for k in server.prefill_entries() if k not in server._kept]
            row = dict(round=rnd, S=S, entries=len(held), evicted=server.evicted_prefill_entries,
                       allocated=torch.cuda.memory_allocated(), reserved=torch.cuda.memory_reserved())
            rows.append(row)
            print("[entries] " + json.dumps(row), flush=True)
            if len(held) > N:
                raise AssertionError(f"[entries] {len(held)} prefill entries held, bound {N}")
            if rnd == 0:
                first[S] = out
            elif not np.array_equal(out, first[S]):
                raise AssertionError(f"[entries] S={S}: tokens {out.tolist()} after eviction, {first[S].tolist()} before")
    at_bound = rows[N - 1]["allocated"]
    later = max(r["allocated"] for r in rows[N:])
    summary = dict(bound=N, lengths=len(ENTRY_PROMPTS), allocated_at_bound=at_bound, allocated_max_after=later,
                   reserved_at_bound=rows[N - 1]["reserved"], reserved_max_after=max(r["reserved"] for r in rows[N:]),
                   evicted=server.evicted_prefill_entries, wall_s=time.perf_counter() - t0)
    print("[entries] " + json.dumps(summary), flush=True)
    if later > at_bound:
        raise AssertionError(f"[entries] memory_allocated grew past the bound: {later} > {at_bound}")
    return summary


def stats_phase(wrappers: dict, workdir: Path, strict_tokens: list) -> dict:
    """Mixtral-8x22B at full width, 1 of 56 layers, under the reference
    launcher's stats profile (one resident expert per layer, a quarter of
    the vocab's row groups hot by the synthetic pipeline's stats) with its
    own artifact: half of tier-1 on the device and the prefetcher on. The
    same weights and request as phase 4 must give its tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import build_model
    from repro_torch.serving import GenerationEngine, cold_start

    cfg = get_config("mixtral-8x22b").replace(num_layers=LAYERS, collect_moe_usage=True)
    model = build_model(cfg, param_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    profile = DeploymentProfile(resident_experts=1, hot_vocab_fraction=0.25, min_tier1_bytes=1 << 14,
                                vocab_row_group=ROW_GROUP)
    hot = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 128, 8)).vocab_row_stats(row_group=ROW_GROUP)
    artifact = workdir / "artifact_stats"
    shutil.rmtree(artifact, ignore_errors=True)
    warm_shapes = ((BATCH, PROMPT, PROMPT + MIXTRAL_NEW_TOKENS + 8),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(7)).cuda()
    before = _prefetch_threads()

    for fn in wrappers.values():
        fn.launches = 0  # the stats path starts here
    t0 = time.perf_counter()
    result = analyze(model, profile, hot_units_stats=hot, trace_B=1, trace_S=32)
    t1 = time.perf_counter()
    meta = build_artifact(params, result, str(artifact), compress_level=1)
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = cold_start(model, str(artifact), result, residency="stats", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=PROMPT + MIXTRAL_NEW_TOKENS + 8)
    t3 = time.perf_counter()
    out, stats = engine.generate(tokens, MIXTRAL_NEW_TOKENS)
    t4 = time.perf_counter()
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the stats path ends here
    peak = torch.cuda.max_memory_allocated()
    drained = server.prefetcher.drain(120.0)
    pstats, res = server.prefetcher.stats, server.tiered.residency
    summary = dict(analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3, plan=result.summary(),
                   tier1_compressed_bytes=meta["tier1_compressed_bytes"], peak_device_bytes=peak, drained=drained,
                   **_prefetch_summary(server, stats, counts, len(warm_shapes) + stats.prefill_runs))
    server.close()
    summary["prefetch_threads_alive_after_close"] = len(_prefetch_threads() - before)
    print("[serve] stats: " + json.dumps(summary, default=str), flush=True)
    if not np.array_equal(out, np.asarray(strict_tokens, dtype=out.dtype)):
        raise AssertionError(f"stats tokens {out.tolist()} differ from strict's {strict_tokens}")
    if pstats.loaded_units < 1 or not drained:
        raise AssertionError(f"stats: the prefetcher installed {pstats.loaded_units} units, drained {drained}")
    if not (res.max_resident_bytes <= res.budget_bytes or res.overshoot_events > 0):
        raise AssertionError(f"stats: {res.max_resident_bytes} resident bytes past the budget "
                             f"{res.budget_bytes} with no overshoot counted")
    if res.resident_bytes > res.budget_bytes:
        raise AssertionError(f"stats: {res.resident_bytes} resident bytes at rest past the budget {res.budget_bytes}")
    if summary["prefetch_threads_alive_after_close"]:
        raise AssertionError("stats: prefetch threads alive after close()")
    _check_served_launches("mixtral-8x22b stats", counts, summary["prefill_runs"])
    del server, engine
    torch.cuda.empty_cache()
    shutil.rmtree(artifact, ignore_errors=True)
    return summary


@contextlib.contextmanager
def _eager_entries(server):
    """The server's compiled entries made as plain model calls on the card,
    for comparison with its graphs (the port never does this itself); the
    graphs are back when the block ends."""
    import importlib

    import torch

    cs_mod = importlib.import_module("repro_torch.serving.cold_start")
    saved, server._compiled = server._compiled, type(server._compiled)()
    try:
        with mock.patch.object(cs_mod, "GraphEntry", cs_mod.EagerEntry):
            yield
    finally:
        server._compiled = saved
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _record_logits(engine):
    """Keep a float copy of the logits of each ``prefill_step`` and
    ``decode_once`` of ``engine`` (a graph's are rewritten by the next
    replay), with the prefill's tokens and forward runs."""
    rec = {"prefill": [], "decode": []}
    prefill_step, decode_once = engine.prefill_step, engine.decode_once

    def prefill(tokens, stats, **kw):
        runs = stats.prefill_runs
        out = prefill_step(tokens, stats, **kw)
        rec["prefill"].append(dict(tokens=tokens.cpu().numpy(), logits=out[0].float().clone(),
                                   runs=stats.prefill_runs - runs))
        return out

    def decode(*args, **kw):
        out = decode_once(*args, **kw)
        rec["decode"].append(out[0].float().clone())
        return out

    engine.prefill_step, engine.decode_once = prefill, decode
    try:
        yield rec
    finally:
        del engine.prefill_step, engine.decode_once


def _new_prefill_entries(server, before: set) -> int:
    return sum(1 for key in server._compiled if key[0] == "prefill" and key not in before)


def graph_phase(label: str, server, tokens, n_steps: int, wrappers: dict, per_prefill: dict,
                limit: float) -> dict:
    """The same request replayed from the server's CUDA graphs and run
    eagerly (the entries made as plain calls), all units resident: tokens
    equal, logits within ``limit`` (bit equality printed), and decode s/step
    and prefill s/run of each. Launch counts in both runs are
    ``per_prefill`` × forward prefill runs (with the warm-up run of each
    graph made in the run): a replay adds the launches its graph recorded."""
    import numpy as np
    import torch

    from repro_torch.serving import GenerationEngine

    runs = {}
    for how in ("graph", "eager"):
        engine = GenerationEngine(server, max_seq=tokens.shape[1] + n_steps + 8)
        with (_eager_entries(server) if how == "eager" else contextlib.nullcontext()), \
                _record_logits(engine) as rec:
            before = set(server._compiled)
            for fn in wrappers.values():
                fn.launches = 0  # this run starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, stats = engine.generate(tokens, n_steps)
            wall = time.perf_counter() - t0
            counts = {name: fn.launches for name, fn in wrappers.items()}  # and ends here
            made = _new_prefill_entries(server, before)
            entries = {"%s%s" % (k[0], k[1:]): e.make_s for k, e in server._compiled.items()}
        warm_ups = made if how == "graph" else 0  # an eager entry runs nothing when made
        want = {name: per_prefill.get(name, 0) * (stats.prefill_runs + warm_ups) for name in wrappers}
        if counts != want:
            raise AssertionError(f"[graph] {label} {how}: launches {counts}, expected {want}")
        runs[how] = dict(out=out, rec=rec, summary=dict(
            generate_s=wall, prefill_s_per_run=stats.prefill_s / stats.prefill_runs,
            decode_s_per_step=stats.decode_s / (n_steps - 1), prefill_runs=stats.prefill_runs,
            entries_made_s=entries, launches=counts))
    g, e = runs["graph"], runs["eager"]
    pairs = [(g["rec"]["prefill"][-1]["logits"], e["rec"]["prefill"][-1]["logits"])] + list(
        zip(g["rec"]["decode"], e["rec"]["decode"]))
    diff = max((a - b).abs().max().item() for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    summary = dict(label=label, B=tokens.shape[0], S=tokens.shape[1], new_tokens=n_steps,
                   compile_s=server.report.compile_s, tokens_equal=bool(np.array_equal(g["out"], e["out"])),
                   logits_max_abs_diff=diff, logits_bit_equal=bit_equal, limit=limit,
                   decode_speedup=e["summary"]["decode_s_per_step"] / g["summary"]["decode_s_per_step"],
                   graph=g["summary"], eager=e["summary"])
    print(f"[graph] {label}: " + json.dumps(summary, default=str), flush=True)
    if not summary["tokens_equal"]:
        raise AssertionError(f"[graph] {label}: graph tokens {g['out'].tolist()} != eager {e['out'].tolist()}")
    if not diff <= limit:
        raise AssertionError(f"[graph] {label}: graph and eager logits differ by {diff} (limit {limit})")
    return summary


def sched_phase(server, wrappers: dict) -> dict:
    """The continuous-batching scheduler on Mixtral's ``full`` server (every
    unit resident): SCHED_BATCH slots, SCHED_REQUESTS requests submitted at
    once (FIFO), prompts alternating SCHED_PROMPTS tokens, SCHED_STEPS new
    tokens in turn, so slots free at different steps and admission happens
    between decode steps. Served from the graphs and again eagerly: the same
    tokens, 0 rejected, 0 failed, every admission group within the 1024
    tokens a serving MoE keeps dropless. Each request against its solo
    ``generate()``: the same first token, prefill logits within
    LOGITS_TOL; a later divergence is printed with its step and the solo
    run's top-2 logit gap there."""
    import numpy as np
    import torch

    from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine

    vocab = server.model.cfg.vocab_size
    max_seq = max(SCHED_PROMPTS) + max(SCHED_STEPS) + 8
    prompts = [torch.randint(0, vocab, (SCHED_PROMPTS[i % len(SCHED_PROMPTS)],),
                             generator=torch.Generator().manual_seed(200 + i)).numpy() for i in range(SCHED_REQUESTS)]
    steps = [SCHED_STEPS[i % len(SCHED_STEPS)] for i in range(SCHED_REQUESTS)]

    def rows_of(rec, prompt):
        for call in rec["prefill"]:
            for i, row in enumerate(call["tokens"]):
                if row.shape == prompt.shape and np.array_equal(row, prompt):
                    return call["logits"][i]
        raise AssertionError("a request's prefill was not recorded")

    runs = {}
    for how in ("graph", "eager"):
        engine = GenerationEngine(server, max_seq=max_seq)
        with (_eager_entries(server) if how == "eager" else contextlib.nullcontext()), \
                _record_logits(engine) as rec:
            sched = ContinuousBatchingScheduler(engine, max_batch=SCHED_BATCH)
            t0 = time.perf_counter()
            sched.warm_compile()
            warm_s = time.perf_counter() - t0
            before = set(server._compiled)
            for fn in wrappers.values():
                fn.launches = 0  # the scheduler path starts here
            reqs = [sched.submit(p, n) for p, n in zip(prompts, steps)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched.run()
            wall = time.perf_counter() - t0
            counts = {name: fn.launches for name, fn in wrappers.items()}  # and ends here
            made = _new_prefill_entries(server, before)
        st = sched.stats
        groups = [tuple(c["tokens"].shape) for c in rec["prefill"]]
        runs_total = sum(c["runs"] for c in rec["prefill"])
        warm_ups = made if how == "graph" else 0  # an eager entry runs nothing when made
        want = {name: LAYERS * (runs_total + warm_ups) if name == "flash_attention" else 0 for name in wrappers}
        summary = dict(stats=st.to_dict(), wall_s=wall, warm_compile_s=warm_s, requests_per_s=len(reqs) / wall,
                       decode_s_per_step=st.decode_s / max(st.steps, 1), admission_groups=groups,
                       prefill_runs=runs_total, prefill_entries_made=made, launches=counts)
        print(f"[sched] {how}: " + json.dumps(summary, default=str), flush=True)
        if st.rejected or st.failed or st.completed != len(reqs) or any(r.error for r in reqs):
            raise AssertionError(f"[sched] {how}: {st.rejected} rejected, {st.failed} failed, "
                                 f"{st.completed} of {len(reqs)} completed")
        if any(b * s > 1024 for b, s in groups):
            raise AssertionError(f"[sched] {how}: an admission group past 1024 tokens: {groups}")
        if counts != want:
            raise AssertionError(f"[sched] {how}: launches {counts}, expected {want}")
        runs[how] = dict(out=[r.out for r in reqs], rec=rec, summary=summary)
    if runs["graph"]["out"] != runs["eager"]["out"]:
        raise AssertionError(f"[sched] graph tokens {runs['graph']['out']} != eager {runs['eager']['out']}")

    engine = GenerationEngine(server, max_seq=max_seq)
    solo = []
    for i, (p, n) in enumerate(zip(prompts, steps)):
        with _record_logits(engine) as rec:
            out, _ = engine.generate(torch.from_numpy(p[None].astype(np.int64)).to(server.device), n)
        got = runs["graph"]["out"][i]
        diff = (rows_of(runs["graph"]["rec"], p) - rec["prefill"][-1]["logits"][0]).abs().max().item()
        first_diff = next((t for t in range(n) if got[t] != int(out[0, t])), None)
        row = dict(rid=i, prompt=len(p), new_tokens=n, prefill_logits_max_abs_diff=diff,
                   first_token_equal=got[0] == int(out[0, 0]), diverges_at=first_diff)
        if first_diff is not None:
            lg = rec["prefill"][-1]["logits"][0] if first_diff == 0 else rec["decode"][first_diff - 1][0]
            top2 = torch.topk(lg, 2).values
            row["top2_gap_at_divergence"] = (top2[0] - top2[1]).item()
        solo.append(row)
        print(f"[sched] solo {json.dumps(row)}", flush=True)
        if not row["first_token_equal"] or not diff <= LOGITS_TOL:
            raise AssertionError(f"[sched] request {i} against its solo generate(): {row}")
    return dict(graph=runs["graph"]["summary"], eager=runs["eager"]["summary"], solo=solo,
                tokens_equal_graph_eager=True)


def traffic_phase(workdir: Path) -> dict:
    """The launcher's traffic mode once, as a user runs it: Mixtral-8x22B at
    full width cut to 1 layer, bf16, ``full`` policy, 4 slots, 8 requests of
    256 + 8 tokens submitted at once. It must exit 0 with 8/8 ok."""
    outdir = workdir / "traffic"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mixtral-8x22b", "--layers", "1",
            "--param-dtype", "bfloat16", "--policy", "full", "--concurrency", "4", "--requests", "8",
            "--prompt-len", "256", "--gen-steps", "8", "--artifact-dir", str(outdir)]
    t0 = time.perf_counter()
    res = subprocess.run(argv, capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO))
    wall = time.perf_counter() - t0
    shutil.rmtree(outdir, ignore_errors=True)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve] ")]
    for ln in lines:
        print(f"[traffic] {ln}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"the launcher's traffic mode exited {res.returncode}: {res.stderr[-3000:]}")
    if not any(ln.startswith("[serve] traffic: 8/8 ok") for ln in lines):
        raise AssertionError("the launcher's traffic mode did not finish 8/8 requests")
    stats = json.loads(next(ln for ln in lines if ln.startswith("[serve] scheduler: ")).split(": ", 1)[1])
    tokens = json.loads(next(ln for ln in lines if ln.startswith("[serve] tokens: ")).split(": ", 1)[1])
    if stats["completed"] != 8 or stats["failed"] or [len(t) for t in tokens] != [8] * 8:
        raise AssertionError(f"the launcher's traffic mode: {stats}, tokens {tokens}")
    print(f"[traffic] launcher wall {wall:.1f} s", flush=True)
    return dict(wall_s=wall, stats=stats)


# the launcher with the attention kernel's wrapper replaced by its plain version
PLAIN_LAUNCHER = ("import sys\n"
                  "from repro_torch.kernels.flash_attention import ops\n"
                  "from repro_torch.models import attention\n"
                  "attention.flash_attention = ops.flash_attention_plain\n"
                  "from repro_torch.launch.serve import main\n"
                  "sys.exit(main(sys.argv[1:]))\n")


def _launch(tag: str, args: list, plain: bool = False, timeout: int = 600) -> dict:
    """One launcher run in a subprocess; prints its ``[serve]`` lines under
    ``tag`` and returns them parsed: wall, cold start report, request stats,
    tokens, kernel launches, plan and re-tiering lines where present."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    argv = [sys.executable] + (["-c", PLAIN_LAUNCHER] if plain else ["-m", "repro_torch.launch.serve"]) + args
    t0 = time.perf_counter()
    res = subprocess.run(argv, capture_output=True, text=True, timeout=timeout, env=env, cwd=str(REPO))
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve] ")]
    for ln in lines:
        print(f"{tag} {ln}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"{tag} the launcher exited {res.returncode}: {res.stderr[-3000:]}")

    def field(prefix: str):
        ln = next((ln for ln in lines if ln.startswith(prefix)), None)
        return None if ln is None else json.loads(ln[len(prefix):])

    retiered = next((ln for ln in lines if ln.startswith("[serve] re-tiered from ")), None)
    cold = next((ln for ln in lines if ln.startswith("[serve] cold start (")), None)  # none under --fleet
    arbiter = next((ln for ln in lines if ln.startswith("[serve] host arbiter: ")), None)
    replicas = {}  # --fleet: each replica's request, tokens and daemon stats
    for i in range(sum(ln.startswith("[serve] replica-") and " cold start: " in ln for ln in lines)):
        replicas[f"replica-{i}"] = {k: field(f"[serve] replica-{i} {k}: ")
                                    for k in ("cold start", "request", "tokens", "retier stats")}
    out = dict(wall_s=wall, serve_lines=len(lines), cold_start=None if cold is None else json.loads(cold.split("): ", 1)[1]),
               request=field("[serve] request: "),
               tokens=field("[serve] tokens: "), launches=field("[serve] kernel launches: "),
               retier=None if retiered is None else json.loads(retiered.split(": ", 1)[1]),
               retier_artifact=field("[serve] retier artifact: "),
               online=field("[serve] online retier stats: "),
               arbiter=None if arbiter is None else arbiter[len("[serve] host arbiter: "):],
               restore=field("[serve] restore report: "),
               snapshot=next((ln for ln in lines if ln.startswith("[serve] wrote server snapshot to ")), None),
               replicas=replicas, fleet=field("[serve] fleet stats: "),
               syncs=[ln for ln in lines if ln.startswith("[serve] fleet sync: ")],
               mesh=field("[serve] mesh: "), faulted=field("[serve] faulted units: "))
    print(f"{tag} launcher wall {wall:.1f} s", flush=True)
    return out


def _train_launch(tag: str, args: list, timeout: int = 600) -> dict:
    """One training launcher run on the card in a subprocess; prints its
    ``[train]`` lines under ``tag`` and returns its first and last loss and
    its kernel launches."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args, "--device", "cuda"],
                         capture_output=True, text=True, timeout=timeout, env=env, cwd=str(REPO))
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[train] ")]
    for ln in lines:
        print(f"{tag} {ln}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"{tag} the training launcher exited {res.returncode}: {res.stderr[-3000:]}")
    done = next(ln for ln in lines if ln.startswith("[train] done @ step "))
    first, last = (float(x) for x in done.split("; loss ", 1)[1].split(";", 1)[0].split(" -> "))
    launches = json.loads(next(ln for ln in lines if ln.startswith("[train] kernel launches: "))
                          [len("[train] kernel launches: "):])
    print(f"{tag} launcher wall {wall:.1f} s", flush=True)
    return dict(wall_s=wall, loss_first=first, loss_last=last, launches=launches)


def reduced_phase(workdir: Path) -> dict:
    """[reduced] The reference's main-path command on the card, five launcher
    processes, four at a time: reduced Mixtral (head_dim 16, through the
    zero-padded hd-64 kernel) via
    ``python -m repro_torch.launch.serve --reduced --param-dtype bfloat16``,
    B=2 × REDUCED_PROMPT + REDUCED_NEW_TOKENS, the same command with the
    attention's plain version in the kernel's place, the same command
    with ``--retier-online --retier-interval 1 --host-budget-bytes
    REDUCED_HOST_BUDGET --snapshot-out`` (the online daemon and the host
    arbiter through the launcher's flags, and the warmed server's snapshot
    written outside the artifact), the same command with ``--restore-from``
    that snapshot (it rebuilds the online run's artifact in the same place,
    so its fingerprint holds), and the same command with ``--fleet 2``; beside
    them, a sixth process trains the same config on the card
    (``python -m repro_torch.launch.train --arch mixtral-8x22b --reduced
    --steps REDUCED_TRAIN_STEPS``: plain attention under autograd, so the
    kernels' grad guard never trips). All exit 0; every serve run but the
    plain one launches flash attention (and no other kernel), the plain run
    none; the tokens are equal (each fleet replica's too); the online run's
    daemon absorbed no error; the restore replays at least one unit with the
    predictor armed; the fleet's pushes all held; the training loss falls."""
    outdir = workdir / "reduced"
    shutil.rmtree(outdir, ignore_errors=True)
    snap = outdir / "snapshot.json"  # beside the artifact directories, not in one
    args = ["--arch", "mixtral-8x22b", "--reduced", "--param-dtype", "bfloat16", "--batch", str(BATCH),
            "--prompt-len", str(REDUCED_PROMPT), "--gen-steps", str(REDUCED_NEW_TOKENS)]
    # each run has its artifact directory but the restore, which rebuilds
    # the online run's in the same place, so its fingerprint holds
    extra = {"kernel": [], "plain": [], "restore": ["--restore-from", str(snap)], "fleet": ["--fleet", "2"],
             "online": ["--retier-online", "--retier-interval", "1", "--host-budget-bytes", str(REDUCED_HOST_BUDGET),
                        "--snapshot-out", str(snap)]}

    def run(how: str) -> dict:
        where = outdir / ("online" if how == "restore" else how)
        return _launch(f"[reduced] {how}:", args + ["--artifact-dir", str(where)] + extra[how], plain=how == "plain")

    # four processes at once (the card and the host's cores are mostly idle
    # under one), the restore after the online run it restores
    with ThreadPoolExecutor(5) as ex:
        train = ex.submit(_train_launch, "[reduced] train:", ["--arch", "mixtral-8x22b", "--reduced", "--steps",
                                                               str(REDUCED_TRAIN_STEPS), "--ckpt-dir",
                                                               str(outdir / "checkpoints")])
        futs = {how: ex.submit(run, how) for how in ("kernel", "plain", "fleet")}
        futs["online"] = ex.submit(lambda: (run("online"), run("restore")))
        runs = {how: f.result() for how, f in futs.items()}
        train = train.result()
    runs["online"], runs["restore"] = runs["online"]
    shutil.rmtree(outdir, ignore_errors=True)
    k, p, o, r, f = (runs[h] for h in ("kernel", "plain", "online", "restore", "fleet"))
    fleet_tokens = [rep["tokens"] for rep in f["replicas"].values()]
    summary = dict(tokens=k["tokens"], tokens_equal=k["tokens"] == p["tokens"] == o["tokens"] == r["tokens"],
                   fleet_tokens_equal=len(fleet_tokens) == 2 and all(t == k["tokens"] for t in fleet_tokens),
                   launches=k["launches"], plain_launches=p["launches"], online_launches=o["launches"],
                   restore_launches=r["launches"], fleet_launches=f["launches"], request=k["request"],
                   online_request=o["request"], online=o["online"], arbiter=o["arbiter"], snapshot=o["snapshot"],
                   restore=r["restore"], restore_request=r["request"], restore_cold_start=r["cold_start"],
                   fleet=f["fleet"], fleet_syncs=f["syncs"], train=train, train_launches=train["launches"],
                   fleet_replicas={n: dict(request=rep["request"], cold_start=rep["cold start"],
                                           daemon=rep["retier stats"]) for n, rep in f["replicas"].items()},
                   wall_s={h: run["wall_s"] for h, run in runs.items()})
    print("[reduced] " + json.dumps(summary), flush=True)
    for run in (k, o, r, f):
        if not run["launches"]["flash_attention"] > 0 or any(n for name, n in run["launches"].items()
                                                            if name != "flash_attention"):
            raise AssertionError(f"[reduced] kernel launches {run['launches']}")
    if o["online"] is None or o["arbiter"] is None or o["online"]["applies"] < 1 or o["online"]["errors"] \
            or o["online"]["compact_errors"]:
        raise AssertionError(f"[reduced] online run: daemon {o['online']}, arbiter {o['arbiter']}")
    if any(p["launches"].values()):
        raise AssertionError(f"[reduced] the plain run launched {p['launches']}")
    if not train["loss_last"] < train["loss_first"]:
        raise AssertionError(f"[reduced] the training launcher's loss did not fall: {train}")
    if not summary["tokens_equal"]:
        raise AssertionError(f"[reduced] kernel tokens {k['tokens']} != plain {p['tokens']}, online {o['tokens']} "
                             f"or restore {r['tokens']}")
    if o["snapshot"] is None or "predictor included" not in o["snapshot"]:
        raise AssertionError(f"[reduced] the online run's snapshot line: {o['snapshot']!r}")
    rr = r["restore"]
    if rr is None or rr["restored"] < 1 or not rr["predictor_armed"] or rr["fingerprint_ok"] is not True:
        raise AssertionError(f"[reduced] restore report {rr}")
    fs = f["fleet"]
    if not summary["fleet_tokens_equal"] or fs is None or fs["syncs"] != 2 or fs["push_failures"] \
            or fs["pull_failures"] or fs["bootstrap_failures"] or any(
                rep["retier stats"]["errors"] for rep in f["replicas"].values()):
        raise AssertionError(f"[reduced] fleet run: tokens {fleet_tokens} vs {k['tokens']}, stats {fs}")
    return summary


def retier_phase(workdir: Path, profile: dict, trace: Path) -> dict:
    """[retier] One profile → re-tier → re-serve cycle through the launcher,
    Mixtral-8x22B at full width cut to 1 layer, bf16, B=2 × 1024 +
    MODES_NEW_TOKENS, stats policy. ``profile`` is the modes phase's after2
    run, the profiling run (no prefetcher, ``--profile-out trace``); this
    phase runs the second: ``--retier-from trace`` re-tiers the artifact
    and serves from it with the trace's predictor armed. Prints each run's
    fault bytes and count, cold-start read/upload, tier-0 bytes, and the
    re-tier report and compaction counts; the tokens must be equal."""
    outdir = workdir / "retier"
    shutil.rmtree(outdir, ignore_errors=True)
    args = ["--arch", "mixtral-8x22b", "--layers", "1", "--param-dtype", "bfloat16", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen-steps", str(MODES_NEW_TOKENS), "--policy", "stats",
            "--artifact-dir", str(outdir), "--retier-from", str(trace)]
    runs = {"profile": profile, "retier": _launch("[retier] retier:", args)}
    shutil.rmtree(outdir, ignore_errors=True)
    trace.unlink()
    summary = {}
    for name, r in runs.items():
        cs = r["cold_start"]
        summary[name] = dict(
            faulted_bytes=r["request"]["faulted_bytes"], faulted_units=r["request"]["faulted_units"],
            fault_s=r["request"]["fault_s"], read_s=cs["read_s"], upload_s=cs["upload_s"],
            compile_s=cs["compile_s"], tier0_bytes_read=cs["bytes_read"], bytes_uploaded=cs["bytes_uploaded"],
            launches=r["launches"], wall_s=r["wall_s"])
    summary["retier"].update(report=runs["retier"]["retier"], compaction=runs["retier"]["retier_artifact"])
    summary["tokens_equal"] = runs["profile"]["tokens"] == runs["retier"]["tokens"]
    print("[retier] " + json.dumps(summary), flush=True)
    print(f"[retier] fault bytes {summary['profile']['faulted_bytes']:,} before, "
          f"{summary['retier']['faulted_bytes']:,} after re-tiering; faults {summary['profile']['faulted_units']} "
          f"→ {summary['retier']['faulted_units']}; cold-start bytes uploaded {summary['profile']['bytes_uploaded']:,} "
          f"→ {summary['retier']['bytes_uploaded']:,}", flush=True)
    if not summary["tokens_equal"]:
        raise AssertionError(f"[retier] tokens {runs['retier']['tokens']} != the profiling run's "
                             f"{runs['profile']['tokens']}")
    if not summary["retier"]["compaction"]["raw_copied"] > 0:
        raise AssertionError(f"[retier] no tier-1 frame was copied raw: {summary['retier']['compaction']}")
    return summary


def mesh_launch_phase(workdir: Path) -> dict:
    """[mesh] (a) The launcher under a 1×1 mesh at full width, as the modes
    phase's after2 run: Mixtral-8x22B cut to 1 layer, bf16, B=2 × PROMPT +
    MODES_NEW_TOKENS, its default stats policy without the prefetcher, with
    ``--mesh 1x1`` (a world of one on an in-memory store, NCCL) and its own
    artifact directory. ``check_mesh_launch`` holds it to that run."""
    outdir = workdir / "mesh_launcher"
    shutil.rmtree(outdir, ignore_errors=True)
    args = ["--arch", "mixtral-8x22b", "--layers", "1", "--param-dtype", "bfloat16", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen-steps", str(MODES_NEW_TOKENS), "--mode", "after2", "--no-prefetch",
            "--mesh", "1x1", "--artifact-dir", str(outdir)]
    try:
        return _launch("[mesh] launcher 1x1:", args)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def check_mesh_launch(run: dict, after2: dict) -> dict:
    """The 1×1 launcher run against the modes phase's after2 run: the same
    tokens, cold-start bytes read, faulted units and bytes, and flash
    launches (> 0); every leaf's divisor 1; its entries' kind printed."""
    mesh = run["mesh"]
    summary = dict(mesh=mesh, tokens_equal=run["tokens"] == after2["tokens"],
                   bytes_read=(run["cold_start"]["bytes_read"], after2["cold_start"]["bytes_read"]),
                   faulted_units=(run["request"]["faulted_units"], after2["request"]["faulted_units"]),
                   faulted_bytes=(run["request"]["faulted_bytes"], after2["request"]["faulted_bytes"]),
                   flash=(run["launches"]["flash_attention"], after2["launches"]["flash_attention"]),
                   cold_start=run["cold_start"], wall_s=run["wall_s"], launches=run["launches"])
    print("[mesh] " + json.dumps(summary), flush=True)
    print(f"[mesh] launcher 1x1 against modes after2: tokens {'equal' if summary['tokens_equal'] else 'DIFFER'}; "
          f"bytes read {summary['bytes_read']}; faults {summary['faulted_units']} units, "
          f"{summary['faulted_bytes']} B; flash launches {summary['flash']}; divisors {mesh and mesh['divisors']}; "
          f"entries {mesh and mesh['entries']}", flush=True)
    if mesh is None or mesh["geometry"] != "1x1" or set(mesh["divisors"]) != {"1"}:
        raise AssertionError(f"[mesh] the 1x1 run's mesh line: {mesh}")
    if not summary["tokens_equal"] or run["faulted"] != after2["faulted"] or any(
            a != b for a, b in (summary["bytes_read"], summary["faulted_units"], summary["faulted_bytes"])):
        raise AssertionError(f"[mesh] the 1x1 launcher run differs from the modes after2 run: {summary}")
    if not summary["flash"][0] == summary["flash"][1] > 0:
        raise AssertionError(f"[mesh] flash launches {summary['flash']}")
    return summary


def _mesh_shard_family(arch: str, layers: int, dtype: str, tol, wrappers: dict) -> dict:
    """One family of [mesh] (d): ``arch`` at full width cut to ``layers``
    layers (seeded bf16 weights, ``dtype`` compute), one prefill of B=2 ×
    1024 (a modal family's batch of MESH_MODAL_INPUTS), unsharded and
    then as the 16 ``model`` ranks of the production mesh (data 1 × model
    16) run one after another on the card (``sharding.comm.run_ranks``),
    each from its own copies of its blocks (``cut_tree`` by the param
    rules), with every reduction done in this process. The ranks' logits
    blocks, put together, are held to the unsharded prefill's within
    ``tol`` of its max |logit| (printed only where ``tol`` is None), and
    their greedy ids
    (``greedy_sharded`` over the head's table, a tied model's embedding; the
    same on every rank) to its argmax on every row whose top-2 margin is
    over twice the measured error. Each rank launches the flash kernel once
    a decoder self-attention layer at its own q heads (every head where
    ``model`` does not divide them; none for MLA, whose prefill is plain as
    the reference's, nor for the Whisper encoder, a cross-attention or an
    xLSTM block) and the scan once a rec layer at its own channels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import greedy_sharded
    from repro_torch.models.zoo import build_model
    from repro_torch.sharding.comm import run_ranks
    from repro_torch.sharding.rules import MeshShape, Shard, act_specs, cut_tree, param_shardings
    from repro_torch.utils.tree import flatten_with_paths, tree_map

    t0 = time.perf_counter()
    cfg = get_config(arch).replace(num_layers=layers, dtype=dtype)
    model = build_model(cfg, param_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    for path, leaf in flatten_with_paths(params):
        if path.endswith((".cross.gate", ".gate_ffn")):
            leaf.fill_(GATE_CHECK)
    prompt, modal_key, modal_shape = MESH_MODAL_INPUTS.get(arch, (PROMPT, None, None))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=gen).cuda()}
    if modal_key is not None:
        batch[modal_key] = torch.randn((BATCH, *modal_shape), generator=gen).to("cuda", getattr(torch, dtype))
    sizes = {"data": 1, "model": MESH_SHARD_RANKS}
    specs = tree_map(lambda sh: sh.spec, param_shardings(model.logical_axes(), model.abstract(),
                                                         MeshShape(tuple(sizes), tuple(sizes.values()))))
    kinds = cfg.attn_kinds
    n_rec, n_self = sum(k == "rec" for k in kinds), sum(k in ("self", "local", "global", "attn") for k in kinds)
    want = {"flash_attention": 0 if cfg.mla is not None else n_self * MESH_SHARD_RANKS,
            "rglru_scan": n_rec * MESH_SHARD_RANKS}
    with torch.inference_mode():
        whole = model.prefill(params, batch)[0].float()
        torch.cuda.synchronize()
        shards = {}

        def cut(comm):  # each rank's own copies of its blocks
            shards[comm.coord["model"]] = tree_map(lambda sh: Shard(sh.local.clone(), sh.shape, sh.spec),
                                                   cut_tree(params, specs, comm))

        run_ranks(sizes, cut)
        del params
        torch.cuda.empty_cache()
        launches0 = {name: f.launches for name, f in wrappers.items()}
        t1 = time.perf_counter()

        def rank(comm):
            rows = cut_tree(batch, act_specs(model.batch_axes(batch, "prefill"), batch, comm), comm)
            p = shards[comm.coord["model"]]
            logits = model.prefill_sharded(p, rows, comm)[0]
            table = model.logits_table(p)
            ids = greedy_sharded(logits, table.start(0, comm), table.split(0), (), comm)
            return logits, ids, comm.moved_bytes

        out = run_ranks(sizes, rank)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t1
        launches = {name: f.launches - launches0[name] for name, f in wrappers.items()}
        # each rank's vocab rows, or the whole table's where 16 does not divide it (Whisper's 51865)
        got = (torch.cat([o[0] for o in out], dim=1) if out[0][0].shape[1] < cfg.vocab_size else out[0][0]).float()
    err = (got - whole).abs().max().item()
    scale = whole.abs().max().item()
    top2 = whole.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err  # no error this size can move such a row's argmax
    ids_equal = bool(torch.equal(out[0][1][clear], whole.argmax(-1)[clear]))
    same_ids = all(torch.equal(o[1], out[0][1]) for o in out)
    summary = dict(arch=arch, layers=layers, dtype=dtype, limit=tol, kinds=list(kinds), ranks=MESH_SHARD_RANKS,
                   batch={k: list(v.shape) for k, v in batch.items()}, max_abs_err=err,
                   max_abs_logit=scale, rel_err=err / scale, ids_equal_where_clear=ids_equal,
                   rows_clear=int(clear.sum()), ids_same_on_every_rank=same_ids, sharded_s=sharded_s,
                   collective_bytes_per_rank=out[0][2], launches=launches, wall_s=time.perf_counter() - t0)
    print("[mesh] (d) " + json.dumps(summary), flush=True)
    limit = "printed, not held" if tol is None else f"limit {tol:.1%}"
    print(f"[mesh] (d) {arch} {layers} of {get_config(arch).num_layers} layers at full width, {dtype} compute, "
          f"B={BATCH} × {prompt}{f' with {modal_key} {tuple(batch[modal_key].shape)}' if modal_key else ''}, as "
          f"{MESH_SHARD_RANKS} model ranks one after another: logits max |Δ| {err:.4g} "
          f"against the unsharded layers ({err / scale:.4%} of max |logit| {scale:.4g}; {limit}), greedy ids "
          f"{'equal' if ids_equal else 'DIFFER'} on {int(clear.sum())} of {BATCH} rows clear of a near-tie; "
          f"{out[0][2]} B of collectives a rank; flash launches {launches['flash_attention']}, scan launches "
          f"{launches['rglru_scan']}", flush=True)
    del shards, out, got, whole
    torch.cuda.empty_cache()
    if tol is not None and not (err <= tol * scale and ids_equal) or not same_ids:
        raise AssertionError(f"[mesh] (d) the sharded {arch} differs from the unsharded one: {summary}")
    if {name: launches[name] for name in want} != want:
        raise AssertionError(f"[mesh] (d) {arch} launches {launches}: want {want}")
    return summary


def mesh_shard_phase(wrappers: dict) -> dict:
    """[mesh] (d) Compute on shards at full width, each of MESH_FAMILIES as
    16 ``model`` ranks against its unsharded layers (``_mesh_shard_family``):
    Mixtral-8x22B's first layer (3 q heads a rank against one kv head: 16
    flash launches), Gemma-3-27B's first 5:1 unit (2 q heads and 1 kv head a
    rank, window 1024 and none: 96), DeepSeek-V2-Lite's dense lead layer and
    one MoE layer (4 of 64 experts a rank, MLA plain: none),
    RecurrentGemma-9B's rec, rec, attn (256 of 4096 channels a rank through
    the scan: 32; one q head against the MQA head: 16), whisper-base at full
    depth over 1500 audio frames (8 heads on 16 ranks: every rank runs all
    of them, flash in the 6 decoder self layers: 96; encoder and cross-
    attention plain), Llama-3.2-Vision's 4 self + 1 gated cross layers over
    1601 image tokens (4 q heads a rank against one kv head: 64) and
    xlstm-125m's m and s blocks (4 heads on 16 ranks: every rank runs the
    recurrences, its 96 of 1536 channels of the projections: none). DeepSeek runs twice:
    in bf16, printed, and in fp32 compute, held (MESH_FP32_REL_TOL). Returns
    each run's summary by "arch" (bf16) or "arch-fp32"."""
    return {arch if dtype == "bfloat16" else f"{arch}-fp32": _mesh_shard_family(arch, layers, dtype, tol, wrappers)
            for arch, layers, dtype, tol in MESH_FAMILIES}


def mesh_train_phase(model, tc, data, ckpt: Path, workdir: Path, wrappers: dict) -> dict:
    """[mesh] (b) and (c), on the in-process thread after [train], on a world
    of one (NCCL on an in-memory store). (b) ``reshard_for_mesh`` of
    [train]'s last checkpoint onto a 1×1 mesh on the card: every leaf
    bit-equal to the host arrays; one resumed ``Trainer(mesh=1×1)`` step
    (on shards) from that checkpoint beside the same step with no mesh: loss and params
    bit-equal, no kernel launched. (c) ``gpipe_forward`` over a 1-stage mesh
    equals ``stage_fn`` on each microbatch, and ``compressed_psum`` over a
    1-rank ``pod`` dim equals ``dequantize_int8(quantize_int8(g))``, bit for
    bit."""
    import torch
    import torch.distributed
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import EFState, compressed_psum, dequantize_int8, quantize_int8
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.rules import gather
    from repro_torch.training import TrainConfig, Trainer, gpipe_forward, reshard_for_mesh
    from repro_torch.utils.tree import flatten_with_paths

    tag = "[mesh]"
    t0 = time.perf_counter()
    mesh = make_debug_mesh(1, 1, device="cuda")
    mesh_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    restored = CheckpointManager(str(ckpt)).restore()
    placed = reshard_for_mesh(restored.collections, mesh, model)
    host = dict(flatten_with_paths(restored.collections))
    leaves = list(flatten_with_paths(placed))
    reshard_equal = all(torch.equal(gather(v).cpu(), host[p]) for p, v in leaves)
    on_card = all(gather(v).is_cuda for _, v in leaves)
    del placed, restored
    reshard_s = time.perf_counter() - t1

    # one more step from the checkpoint, with and without the mesh
    step = tc.num_steps + 1
    tc1 = TrainConfig(num_steps=step, save_every=step, warmup_steps=tc.warmup_steps, adamw=tc.adamw)
    runs = {}
    for fn in wrappers.values():
        fn.launches = 0
    for label in ("plain", "mesh"):
        where = workdir / f"mesh_train_{label}"
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(ckpt, where)
        trainer = Trainer(model, tc1, data, str(where), keep_n=1, mesh=mesh if label == "mesh" else None,
                          device="cuda")
        runs[label] = trainer.run(), trainer.params
        shutil.rmtree(where, ignore_errors=True)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    (r_plain, p_plain), (r_mesh, p_mesh) = runs["plain"], runs["mesh"]
    params_equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten_with_paths(p_plain),
                                                                     flatten_with_paths(p_mesh)))
    del runs, p_plain, p_mesh

    # (c) the collectives on a world of one
    gen = torch.Generator(device="cuda").manual_seed(11)
    stage = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    w = torch.randn(1, 64, 64, generator=gen, device="cuda") * 0.1
    b = torch.randn(1, 64, generator=gen, device="cuda") * 0.1
    x = torch.randn(6, 4, 64, generator=gen, device="cuda")
    stage_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    y = gpipe_forward(stage_fn, {"w": w, "b": b}, x, stage)
    gpipe_equal = torch.equal(y, torch.stack([stage_fn({"w": w[0], "b": b[0]}, h) for h in x]))
    g = torch.randn(4096, 1024, generator=gen, device="cuda")
    with use_mesh(init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))):
        avg, ef = compressed_psum({"g": g}, EFState({"g": torch.zeros_like(g)}), "pod")
    q, scale = quantize_int8(g)
    psum_equal = torch.equal(avg["g"], dequantize_int8(q, scale))
    residual_equal = torch.equal(ef.residual["g"], g - dequantize_int8(q, scale))
    torch.distributed.destroy_process_group()
    summary = dict(mesh_s=mesh_s, reshard_leaves=len(leaves), reshard_bit_equal=reshard_equal,
                   reshard_on_card=on_card, reshard_s=reshard_s, losses=(r_plain.losses, r_mesh.losses),
                   restored_from=(r_plain.restored_from, r_mesh.restored_from), params_bit_equal=params_equal,
                   launches=launches, gpipe_equal=gpipe_equal, psum_equal=psum_equal,
                   residual_equal=residual_equal, wall_s=time.perf_counter() - t0)
    print(f"{tag} " + json.dumps(summary), flush=True)
    print(f"{tag} world of one in {mesh_s:.2f} s; reshard_for_mesh 1x1 on the card: {len(leaves)} leaves "
          f"{'bit-equal' if reshard_equal else 'DIFFER'} in {reshard_s:.2f} s (restore and checks included); "
          f"resumed step {step} with a 1x1 mesh "
          f"loss {r_mesh.losses} vs {r_plain.losses} without, params {'bit-equal' if params_equal else 'DIFFER'}; "
          f"gpipe 1 stage {'= stage_fn' if gpipe_equal else 'DIFFERS'}; compressed_psum 1 rank "
          f"{'= dequantize(quantize(g))' if psum_equal and residual_equal else 'DIFFERS'}", flush=True)
    if not (reshard_equal and on_card and params_equal and gpipe_equal and psum_equal and residual_equal):
        raise AssertionError(f"{tag} {summary}")
    if r_plain.losses != r_mesh.losses or r_mesh.restored_from != tc.num_steps or len(r_mesh.losses) != 1:
        raise AssertionError(f"{tag} resumed step: {summary}")
    if any(launches.values()):
        raise AssertionError(f"{tag} launched {launches} under training")
    torch.cuda.empty_cache()
    return summary


def _host_resources(path: Path) -> str:
    disk = shutil.disk_usage(path)
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            mem[k] = int(v.split()[0]) * 1024
    return (f"free disk {disk.free / 1e9:.1f} of {disk.total / 1e9:.1f} GB, host RAM available "
            f"{mem['MemAvailable'] / 1e9:.1f} of {mem['MemTotal'] / 1e9:.1f} GB")


def dryrun_grid_phase(workdir: Path) -> dict:
    """[dryrun] (a) The production geometry, host only: ``python -m
    repro_torch.launch.dryrun --arch mixtral-8x22b --shape all --jobs
    DRYRUN_JOBS`` on the 16×16 fake world (no card memory: fake tensors). It must exit 0 within
    DRYRUN_TIMEOUT_S; every record is ``ok`` or ``skipped``, and each ok
    record's argument bytes (its placed fake blocks) equal the closed form of
    its shardings over ``production_mesh_shape()``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.utils import hlo

    out = workdir / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mixtral-8x22b",
                          "--shape", "all", "--jobs", str(DRYRUN_JOBS), "--out", str(out)], capture_output=True, text=True,
                         timeout=DRYRUN_TIMEOUT_S, env=env, cwd=str(REPO))
    wall = time.perf_counter() - t0
    for ln in res.stdout.splitlines():
        print(f"[dryrun] (a) {ln.removeprefix('[dryrun] ')}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"[dryrun] (a) the dry run exited {res.returncode}: {res.stderr[-3000:]}")
    records = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
    if len(records) != 4 or any(r["status"] not in ("ok", "skipped") for r in records):
        raise AssertionError(f"[dryrun] (a) records: {[(r['shape'], r['status']) for r in records]}")
    for r in records:
        if r["status"] != "ok":
            continue
        mesh = production_mesh_shape()  # the rules' arithmetic, with no rank behind it
        closed = dryrun.closed_form_argument_bytes(dryrun.build_cell(r["arch"], r["shape"], mesh), mesh)
        args = r["memory"]["argument_size_in_bytes"]
        roof = hlo.roofline_of(r)
        print(f"[dryrun] (a) {r['shape']}: arguments {args} B per device = closed form {closed}; peak "
              f"{r['memory']['peak_size_in_bytes']} B; fits {r['fits']}; flops/dev {r['hlo_flops'] / r['num_chips']:.6e}; "
              f"dot flops/dev {r['hlo_dot_flops'] / r['num_chips']:.6e}; "
              f"coll/dev {r['collective_bytes']:.6e} B {json.dumps(r['collectives']['bytes'])}; "
              f"train_on_shards {r['train_on_shards']}; roofline {roof.dominant} (compute {roof.compute_s:.6e}, "
              f"memory {roof.memory_s:.6e}, collective {roof.collective_s:.6e} s); traced in {r['lower_s']:.1f} s",
              flush=True)
        if args != closed:
            raise AssertionError(f"[dryrun] (a) {r['shape']}: arguments {args} B against the closed form {closed}")
        if r["shape"] == "train_4k" and not (r["train_on_shards"] and r["fits"]
                                             and "reduce-scatter" in r["collectives"]["bytes"]):
            raise AssertionError(f"[dryrun] (a) train_4k: on shards {r['train_on_shards']}, fits {r['fits']}, "
                                 f"collectives {r['collectives']['bytes']}")
    print(f"[dryrun] (a) wall {wall:.1f} s", flush=True)
    return {"records": records, "wall_s": wall}


def dryrun_anchor_phase(wrappers: dict) -> dict:
    """[dryrun] (b) The 1×1 anchor on the card (module docstring)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import plain_versions

    arch, shape, layers = DRYRUN_ANCHOR
    t0 = time.perf_counter()
    dryrun.fake_world(1)
    try:
        mesh = dryrun.make_mesh((1, 1), ("data", "model"), "cuda")
        cell = dryrun.build_cell(arch, shape, mesh, extra_cfg={"num_layers": layers})
        traced = dryrun.trace_cell(cell, mesh, "cuda")
        mem, cost = traced["memory"], traced["cost"]
        print(f"[dryrun] (b) {arch} × {shape} × 1x1 at {layers} layer traced in {traced['trace_s']:.1f} s: "
              f"arguments {mem['argument_size_in_bytes']} B, peak {mem['peak_size_in_bytes']} B, "
              f"flops {cost.flops:.6e}, bytes {cost.bytes:.6e}", flush=True)
        if mem["peak_size_in_bytes"] > DRYRUN_ANCHOR_MAX_BYTES:
            raise AssertionError(f"[dryrun] (b) traced peak {mem['peak_size_in_bytes']} B is over its limit")
        cfg = cell.model.cfg
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = dryrun.place_args(cell, mesh, "cuda")  # zeros, then seeded values in place
        gen = torch.Generator(device="cuda").manual_seed(0)
        for t in dryrun.local_tensors(args[:2]):  # the bf16 weights and the caches
            t.normal_(0.0, 0.02, generator=gen)
        batch = {k: dryrun.local_part(v) for k, v in args[2].items()}
        batch["tokens"].random_(0, cfg.vocab_size, generator=gen)
        batch["pos"].fill_(dryrun.SHAPES[shape].seq_len - 1)  # the cache's last position
        torch.cuda.synchronize()
        measured_args = torch.cuda.memory_allocated() - base
        n_tensors = len(dryrun.local_tensors(args))
        over = measured_args - mem["argument_size_in_bytes"]
        print(f"[dryrun] (b) arguments traced {mem['argument_size_in_bytes']} B, measured {measured_args} B "
              f"({n_tensors} tensors, {over} B of rounding, limit {ALLOC_ROUND} B a tensor)", flush=True)
        if not 0 <= over < ALLOC_ROUND * n_tensors:
            raise AssertionError("[dryrun] (b) measured arguments differ from the traced ones by more than rounding")
        for fn in wrappers.values():
            fn.launches = 0  # the anchor's path starts here
        with torch.no_grad(), plain_versions():
            out = cell.fn(*args)  # warm: library workspaces are made here
            logits = out[0].float()
            if tuple(logits.shape) != (dryrun.SHAPES[shape].global_batch, cfg.vocab_size) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"[dryrun] (b) logits {tuple(logits.shape)} are not finite of the cell's shape")
            del out, logits
            peak, times = _peak_and_times(lambda: cell.fn(*args))
        measured_peak = peak + measured_args
        counts = {name: fn.launches for name, fn in wrappers.items()}  # the anchor's path ends here
        del args, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return _anchor_verdict("[dryrun] (b)", cell, dryrun.SHAPES[shape], mem, cost, measured_peak, times, counts, t0,
                           DRYRUN_ANCHOR_MAX_S)


def _peak_and_times(step) -> tuple:
    """After a warm call of ``step``: the card's peak over one more call
    above what was allocated before it, and DRYRUN_STEP_REPS calls' times
    in ms (CUDA events around each)."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    del out
    times = []
    for _ in range(DRYRUN_STEP_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return peak, times


def _anchor_verdict(tag: str, cell, shape, mem: dict, cost, measured_peak: int, times: list, counts: dict,
                    t0: float, max_s: float) -> dict:
    """A 1×1 anchor's checks after its run: the measured peak within
    DRYRUN_PEAK_REL_TOL of the traced one plus DRYRUN_PEAK_ABS_TOL, the
    median step not below the cell's roofline bound, the wall under
    ``max_s``; each printed."""
    import statistics

    from repro_torch.launch import dryrun
    from repro_torch.utils import hlo

    traced_peak = mem["peak_size_in_bytes"]
    tol = DRYRUN_PEAK_REL_TOL * traced_peak + DRYRUN_PEAK_ABS_TOL
    print(f"{tag} peak traced {traced_peak} B, measured {measured_peak} B (|Δ| {abs(measured_peak - traced_peak)} B,"
          f" limit {tol:.0f} B)", flush=True)
    if abs(measured_peak - traced_peak) > tol:
        raise AssertionError(f"{tag} measured peak is outside its limit of the traced one")
    roof = hlo.Roofline(cell.model.cfg.name, shape.name, "1x1", 1, cost.flops, cost.bytes, cost.collective_bytes,
                        dryrun.model_flops(cell.model, shape))
    step_ms = statistics.median(times)
    print(f"{tag} step {step_ms:.4f} ms (median of {len(times)}: {[round(t, 4) for t in times]}), roofline "
          f"bound {roof.bound_s * 1e3:.4f} ms ({roof.dominant}: compute {roof.compute_s * 1e3:.4f}, memory "
          f"{roof.memory_s * 1e3:.4f} ms), {roof.bound_s * 1e3 / step_ms:.1%} of the bound; launches {counts}",
          flush=True)
    if step_ms < roof.bound_s * 1e3:
        raise AssertionError(f"{tag} the step beat its roofline bound: the counter misses work")
    wall = time.perf_counter() - t0
    print(f"{tag} wall {wall:.1f} s", flush=True)
    if wall > max_s:
        raise AssertionError(f"{tag} took {wall:.1f} s, over its {max_s} s")
    return {"launches": counts, "wall_s": wall, "step_ms": step_ms, "bound_ms": roof.bound_s * 1e3}


def _block_rests(tensors: list) -> int:
    """The bytes past their 512-B rounding that the caching allocator books
    for ``tensors`` (each the start of its own block): each block's size in
    ``torch.cuda.memory_snapshot()`` less its tensor's rounded bytes, the
    unsplit rest of a segment or of a reused cached block. Which rests a
    block keeps depends on what earlier phases left cached."""
    import torch

    rounded = {t.data_ptr(): -(-t.numel() * t.element_size() // ALLOC_ROUND) * ALLOC_ROUND for t in tensors}
    return sum(b["size"] - rounded[b["address"]] for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
               if b["state"] == "active_allocated" and b["address"] in rounded)


def dryrun_train_anchors_phase(wrappers: dict) -> dict:
    """[dryrun] (c) The 1×1 train anchors on the card, one after another
    (module docstring): {arch: the anchor's summary}."""
    return {anchor[0]: dryrun_train_anchor(wrappers, *anchor) for anchor in DRYRUN_TRAIN_ANCHORS}


def dryrun_train_anchor(wrappers: dict, arch: str, B: int, S: int, layers: int, cross_every: int = 0) -> dict:
    """[dryrun] (c) One 1×1 train anchor on the card (module docstring);
    ``cross_every`` (a VLM's) overrides ``vlm.cross_attn_every``."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.sharding.comm import DistComm
    from repro_torch.sharding.rules import shard_tree
    from repro_torch.training.train_loop import accumulated_grads, sharded_grads
    from repro_torch.utils.tree import flatten_with_paths

    shape = ShapeSpec(f"train_b{B}s{S}", S, B, "train")
    tag = f"[dryrun] (c) {arch}"
    t0 = time.perf_counter()
    dryrun.fake_world(1)
    try:
        mesh = dryrun.make_mesh((1, 1), ("data", "model"), "cuda")
        extra = {"num_layers": layers}
        if cross_every:
            extra["vlm"] = replace(get_config(arch).vlm, cross_attn_every=cross_every)
        cell = dryrun.build_cell(arch, shape, mesh, extra_cfg=extra)
        traced = dryrun.trace_cell(cell, mesh, "cuda")
    finally:
        dist.destroy_process_group()
    mem, cost = traced["memory"], traced["cost"]
    print(f"{tag} × {shape.name} × 1x1 at {layers} layer{'s' if layers > 1 else ''}, on shards "
          f"{cell.train_on_shards}, {cell.micro_batches} micro-batch, traced in {traced['trace_s']:.1f} s: arguments "
          f"{mem['argument_size_in_bytes']} B, peak {mem['peak_size_in_bytes']} B, flops {cost.flops:.6e} "
          f"(dot {cost.dot_flops:.6e}), bytes {cost.bytes:.6e}, collectives {cost.collective_bytes}", flush=True)
    if not cell.train_on_shards or mem["peak_size_in_bytes"] > DRYRUN_TRAIN_MAX_BYTES:
        raise AssertionError(f"{tag} on shards {cell.train_on_shards}, traced peak {mem['peak_size_in_bytes']} B")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = dryrun.make_mesh((1, 1), ("data", "model"), "cuda")
        cfg, model = cell.model.cfg, cell.model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = dryrun.place_args(cell, mesh, "cuda")  # masters and moments zero, step 0
        gen = torch.Generator(device="cuda").manual_seed(0)
        for t in dryrun.local_tensors(args[0]):
            t.normal_(0.0, 0.02, generator=gen)
        batch = {k: dryrun.local_part(v) for k, v in args[2].items()}
        for t in batch.values():  # token ids and labels; frames and image embeddings from a normal
            if t.is_floating_point():
                t.normal_(0.0, 1.0, generator=gen)
            else:
                t.random_(0, cfg.vocab_size, generator=gen)
        torch.cuda.synchronize()
        measured_args = torch.cuda.memory_allocated() - base
        tensors = dryrun.local_tensors(args)
        kept = _block_rests(tensors)
        over = measured_args - mem["argument_size_in_bytes"] - kept
        print(f"{tag} arguments traced {mem['argument_size_in_bytes']} B, measured {measured_args} B "
              f"({len(tensors)} tensors, {kept} B of unsplit block rests, {over} B of rounding, limit "
              f"{ALLOC_ROUND} B a tensor)", flush=True)
        if not 0 <= over < ALLOC_ROUND * len(tensors):
            raise AssertionError(f"{tag} measured arguments differ from the traced ones by more than rounding")
        for fn in wrappers.values():
            fn.launches = 0  # the anchor's path starts here
        # the step on shards' gradients against the unsharded step's, bit for bit
        comm, params = DistComm(mesh), shard_tree(args[0])
        rows = {k: v if v.is_floating_point() else v.long() for k, v in batch.items()}
        loss, grads = sharded_grads(model, params, shard_tree(args[2]), cell.micro_batches, comm)
        whole = {p: x.local for p, x in flatten_with_paths(params)}
        ref_loss, ref_grads = accumulated_grads(model.loss_fn, whole, rows, cell.micro_batches)
        ref_flat = dict(flatten_with_paths(ref_grads))
        differ = [p for p, g in grads.items() if not torch.equal(g, ref_flat[p])]
        loss_equal = torch.equal(loss, ref_loss)
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values())
        print(f"{tag} loss {float(loss):.6f} on shards, {float(ref_loss):.6f} unsharded "
              f"({'bit-equal' if loss_equal else 'DIFFER'}); {len(grads) - len(differ)} of {len(grads)} gradient "
              f"leaves bit-equal{'' if not differ else f', differ: {differ}'}", flush=True)
        if not (loss_equal and finite and not differ):
            raise AssertionError(f"{tag} the step on shards differs from the unsharded step")
        del grads, ref_grads, ref_flat, whole, params, loss, ref_loss
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out = cell.fn(*args)  # warm: library workspaces are made here
        del out
        peak, times = _peak_and_times(lambda: cell.fn(*args))
        measured_peak = peak + measured_args
        counts = {name: fn.launches for name, fn in wrappers.items()}  # the anchor's path ends here
        del args, batch, rows
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return _anchor_verdict(tag, cell, shape, mem, cost, measured_peak, times, counts, t0, DRYRUN_TRAIN_MAX_S)


def modes_phase(workdir: Path, trace: Path, on_profile=None) -> dict:
    """The paper's Table 2 on the card through the launcher, as a user runs
    it: ``python -m repro_torch.launch.serve`` in each of after2, before and
    after1 on Mixtral-8x22B at full width, depth cut to 1 layer, bf16
    weights from the launcher's seeded generator, B=2 × prompt 1024 + 4 new
    tokens. The after2 run, under the launcher's default stats policy, is
    also ``[retier]``'s profiling run: no prefetcher, its access trace
    written to ``trace``; it runs first, and ``on_profile(run)`` is called
    as soon as it has, so ``[retier]`` can start beside the other two. Each
    run writes its own bundle or artifact. Bytes read must shrink strictly
    from before to after1 to after2, and the greedy tokens must agree."""
    outdir = workdir / "launcher"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    print(f"[modes] {_host_resources(outdir)}", flush=True)
    runs = {}
    for mode in ("after2", "before", "after1"):
        args = ["--arch", "mixtral-8x22b", "--layers", "1", "--param-dtype", "bfloat16", "--batch", str(BATCH),
                "--prompt-len", str(PROMPT), "--gen-steps", str(MODES_NEW_TOKENS), "--mode", mode,
                "--artifact-dir", str(outdir)]
        if mode == "after2":
            args += ["--no-prefetch", "--profile-out", str(trace)]
        runs[mode] = run = _launch(f"[modes] {mode}:", args)
        report = run["cold_start"]
        print(f"[modes] {mode}: read {report['read_s']:.3f} s, upload {report['upload_s']:.3f} s, compile "
              f"{report['compile_s']:.3f} s; read {report['bytes_read']:,} B, uploaded {report['bytes_uploaded']:,} B",
              flush=True)
        for name in os.listdir(outdir / "mixtral-8x22b"):  # each bundle or artifact is read once
            path = outdir / "mixtral-8x22b" / name
            shutil.rmtree(path) if path.is_dir() else path.unlink()
        if mode == "after2" and on_profile is not None:
            on_profile(run)
    shutil.rmtree(outdir, ignore_errors=True)
    read = [runs[m]["cold_start"]["bytes_read"] for m in ("before", "after1", "after2")]
    if not read[0] > read[1] > read[2]:
        raise AssertionError(f"bytes read do not shrink strictly before > after1 > after2: {read}")
    if not runs["before"]["tokens"] == runs["after1"]["tokens"] == runs["after2"]["tokens"]:
        raise AssertionError(f"tokens differ across modes: { {m: r['tokens'] for m, r in runs.items()} }")
    if not all(r["serve_lines"] >= 4 for r in runs.values()) or runs["after2"]["serve_lines"] < 6:
        raise AssertionError("a launcher run printed fewer [serve] lines than the one-shot path prints")
    return runs


def recurrentgemma_phase(fa_ops, lru_ops, wrappers: dict, workdir: Path) -> dict:
    """RecurrentGemma-9B at full width, depth cut to RG_LAYERS, through the after2 path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.models import recurrent as rec_mod
    from repro_torch.serving import GenerationEngine, cold_start
    from repro_torch.utils.tree import flatten_with_paths

    cfg = get_config("recurrentgemma-9b").replace(num_layers=RG_LAYERS)
    if PROMPT > cfg.recurrent.window:
        raise AssertionError("the prompt must stay inside the local window to graft the prefill cache")
    model = build_model(cfg, param_dtype=torch.bfloat16)
    kinds = cfg.attn_kinds
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten_with_paths(params))
    print(f"[serve] {cfg.name} at full width, {cfg.num_layers} of 38 layers ({n_rec} rec, {n_attn} attn; "
          f"{n_params / 1e9:.2f} B params), bf16 weights made in {time.perf_counter() - t0:.1f} s", flush=True)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    artifact = workdir / "artifact_rg"
    shutil.rmtree(artifact, ignore_errors=True)
    warm_shapes = ((BATCH, PROMPT, PROMPT + NEW_TOKENS + 8),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(7)).cuda()

    for fn in wrappers.values():
        fn.launches = 0  # the main path starts here
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
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the main path ends here
    flash_launches, scan_launches = counts["flash_attention"], counts["rglru_scan"]
    peak = torch.cuda.max_memory_allocated()

    prefill_runs = len(warm_shapes) + stats.prefill_runs
    summary = dict(
        analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3,
        plan=result.summary(), tier1_compressed_bytes=meta["tier1_compressed_bytes"],
        cold_start=server.report.to_dict(),
        faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes,
        fault_s=stats.fault_s, prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        loads=len(server.tiered.stats.events), peak_device_bytes=peak, n_params=n_params,
        flash_launches=flash_launches, scan_launches=scan_launches, launches=counts, prefill_runs=prefill_runs,
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
    summary["graph"] = graph_phase(cfg.name, server, tokens, NEW_TOKENS, wrappers,
                                   {"flash_attention": n_attn, "rglru_scan": n_rec}, RG_LOGITS_REL_TOL * scale)
    server.close()
    shutil.rmtree(artifact, ignore_errors=True)
    summary["logits_max_abs_diff"] = diff
    summary["logits_max_abs"] = scale
    return summary


def zoo_phase(arch: str, layers: int, fa_ops, wrappers: dict, workdir: Path) -> dict:
    """[gemma3] / [deepseek] One of the text-only zoo configs at full width,
    depth cut to ``layers``, bf16 weights from a seeded generator, through
    the after2 path under strict: analyze → build_artifact → cold_start →
    generate (B=2 × 1024 + ZOO_NEW_TOKENS). Gemma-3 (one 5:1 unit: five local
    layers of window 1024 and a global one) has an empty tier-1 and must
    launch flash attention once a layer in every prefill run, and no other
    kernel; its kernel-path logits are checked against the plain attention
    on the same server, then its ``[graph]``. DeepSeek-V2-Lite (a dense lead
    layer, two groups of 64 experts top-6 plus 2 shared, MLA) must fault
    expert and row-group units and launch no kernel (its prefill attention
    is plain, as the reference's); its ``[graph]`` runs on a ``full`` server
    of the same artifact once the request has faulted what it routes to.
    The decode graphs must give eager's tokens with bit-equal logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.serving import GenerationEngine, cold_start
    from repro_torch.utils.tree import flatten_with_paths

    tag = "[gemma3]" if arch.startswith("gemma3") else "[deepseek]"
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=layers, collect_moe_usage=cfg.moe is not None)
    if cfg.sliding_window is not None and PROMPT > cfg.sliding_window:
        raise AssertionError("the prompt must stay inside the local window to graft the prefill cache")
    model = build_model(cfg, param_dtype=torch.bfloat16)
    per_prefill = {"flash_attention": layers} if cfg.mla is None else {}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten_with_paths(params))
    print(f"{tag} {cfg.name} at full width, {layers} of {get_config(arch).num_layers} layers "
          f"({n_params / 1e9:.2f} B params), bf16 weights made in {time.perf_counter() - t0:.1f} s", flush=True)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    artifact = workdir / f"artifact_{arch}"
    shutil.rmtree(artifact, ignore_errors=True)
    max_seq = PROMPT + ZOO_NEW_TOKENS + 8
    warm_shapes = ((BATCH, PROMPT, max_seq),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=torch.Generator().manual_seed(7)).cuda()

    for fn in wrappers.values():
        fn.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    result = analyze(model, profile, trace_B=1, trace_S=32)
    t1 = time.perf_counter()
    meta = build_artifact(params, result, str(artifact), compress_level=1)
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = cold_start(model, str(artifact), result, residency="strict", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=max_seq)
    t3 = time.perf_counter()
    out, stats = engine.generate(tokens, ZOO_NEW_TOKENS)
    t4 = time.perf_counter()
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    tiered = server.tiered
    prefill_runs = len(warm_shapes) + stats.prefill_runs
    fault_bytes = sum(e.nbytes for e in tiered.stats.events)
    summary = dict(
        analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3, n_params=n_params,
        plan=result.summary(), tier1_compressed_bytes=meta["tier1_compressed_bytes"],
        cold_start=server.report.to_dict(), budget_bytes=tiered.residency.budget_bytes,
        faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes, fault_s=stats.fault_s,
        fault_rate_gb_s=fault_bytes / stats.fault_s / 1e9 if stats.fault_s else None,
        prefill_s=stats.prefill_s, decode_s=stats.decode_s, prefill_retries=stats.prefill_retries,
        decode_retries=stats.decode_retries, loads=len(tiered.stats.events), load_bytes=fault_bytes,
        evictions=tiered.stats.evictions, refaults=tiered.stats.refaults,
        overshoots=tiered.residency.overshoot_events, peak_device_bytes=peak, launches=counts,
        prefill_runs=prefill_runs, tokens=out.tolist(),
    )
    print(f"{tag} " + json.dumps(summary, default=str), flush=True)
    if out.shape != (BATCH, ZOO_NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} bad generated ids: shape {out.shape}, range [{out.min()}, {out.max()}]")
    want = {name: per_prefill.get(name, 0) * prefill_runs for name in wrappers}
    if counts != want:
        raise AssertionError(f"{tag} launched {counts}, expected {want} for {prefill_runs} prefill runs")
    if (result.plan.summary()["units"] > 0) != (cfg.moe is not None) or (stats.faulted_units > 0) != (
            cfg.moe is not None):
        raise AssertionError(f"{tag} {result.plan.summary()['units']} units, {stats.faulted_units} faulted: "
                             "only the MoE config has tier-1 units to fault")

    if cfg.mla is None:
        # the same live weights (all tier-0, all resident) through the plain attention
        live = server.live_params()
        with torch.inference_mode():
            logits_kernel = model.prefill(live, {"tokens": tokens})[0].float()
            with mock.patch.object(attn_mod, "flash_attention", fa_ops.flash_attention_plain):
                logits_plain = model.prefill(live, {"tokens": tokens})[0].float()
        if not torch.isfinite(logits_kernel).all():
            raise AssertionError(f"{tag} non-finite logits on the kernel path")
        diff = (logits_kernel - logits_plain).abs().max().item()
        scale = logits_plain.abs().max().item()
        agree = (logits_kernel.argmax(-1) == logits_plain.argmax(-1)).float().mean().item()
        print(f"{tag} prefill logits kernel vs plain attention: max abs diff {diff:.4g} (max |logit| "
              f"{scale:.4g}, {diff / scale:.4g} of it), argmax agreement {agree:.2f}", flush=True)
        if not diff <= ZOO_LOGITS_REL_TOL * scale:
            raise AssertionError(f"{tag} kernel-path logits differ from the plain path by {diff} (max |logit| {scale})")
        summary.update(logits_max_abs_diff=diff, logits_max_abs=scale)
        summary["graph"] = graph_phase(cfg.name, server, tokens, ZOO_NEW_TOKENS, wrappers, per_prefill, 0.0)
        server.close()
    else:
        server.close()
        del server, engine, tiered
        torch.cuda.empty_cache()
        server = cold_start(model, str(artifact), result, residency="full", warm_shapes=warm_shapes)
        full_out, _ = GenerationEngine(server, max_seq=max_seq).generate(tokens, ZOO_NEW_TOKENS)
        if not server.prefetcher.drain(120.0) or full_out.tolist() != out.tolist():
            raise AssertionError(f"{tag} full tokens {full_out.tolist()} differ from strict's {out.tolist()}")
        summary["graph"] = graph_phase(cfg.name, server, tokens, ZOO_NEW_TOKENS, wrappers, per_prefill, 0.0)
        server.close()
    del server
    shutil.rmtree(artifact, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


def _modal_prefill_check(tag: str, model, params, fa_ops, wrappers: dict, tokens, self_layers: int) -> dict:
    """[whisper] / [llama-vision] One multimodal prefill on the seeded weights
    (Whisper: audio frames as long as the prompt; the VLM: its 1601 image
    embeddings) through the kernel and through the plain attention: the
    kernel runs once per decoder self layer (the encoder and every cross-
    attention are plain, as in the reference), the logits agree within
    ZOO_LOGITS_REL_TOL of the plain path's max |logit|. The VLM first with
    its gates at zero (their init), where the text-only logits must equal the
    multimodal ones (the reference's ``test_vlm_text_only_matches_zero_image``),
    then with both gates at GATE_CHECK, so the cross path counts."""
    import torch

    from repro_torch.models import attention as attn_mod

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(11)
    if cfg.vlm is not None:
        memory = {"image_embeds": torch.randn(BATCH, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim, generator=gen,
                                              device="cuda").to(torch.bfloat16)}
        cross_units = [f"u{j}" for j, kind in enumerate(model.layout.unit_kinds) if kind == "cross"]
        gates = [t for u in cross_units
                 for t in (params["groups"][u]["cross"]["gate"], params["groups"][u]["gate_ffn"])]
    else:
        memory = {"frames": torch.randn(BATCH, tokens.shape[1], cfg.d_model, generator=gen,
                                        device="cuda").to(torch.bfloat16)}
        gates = []
    out = {}
    with torch.inference_mode():
        if gates:
            text = model.prefill(params, {"tokens": tokens})[0].float()
            zero = model.prefill(params, {"tokens": tokens, **memory})[0].float()
            out.update(zero_gate_max_abs_diff=(text - zero).abs().max().item(),
                       zero_gate_bit_equal=torch.equal(text, zero))
            del text, zero
            for t in gates:
                t.fill_(GATE_CHECK)
        for fn in wrappers.values():
            fn.launches = 0
        kernel = model.prefill(params, {"tokens": tokens, **memory})[0].float()
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        with mock.patch.object(attn_mod, "flash_attention", fa_ops.flash_attention_plain):
            plain = model.prefill(params, {"tokens": tokens, **memory})[0].float()
        for t in gates:
            t.zero_()
    diff, scale = (kernel - plain).abs().max().item(), plain.abs().max().item()
    out.update(launches=launches, logits_max_abs_diff=diff, logits_max_abs=scale,
               argmax_agreement=(kernel.argmax(-1) == plain.argmax(-1)).float().mean().item())
    print(f"{tag} multimodal prefill ({', '.join(f'{k} {tuple(v.shape)}' for k, v in memory.items())}): "
          + json.dumps(out), flush=True)
    if not torch.isfinite(kernel).all():
        raise AssertionError(f"{tag} non-finite multimodal logits on the kernel path")
    if launches != {name: self_layers if name == "flash_attention" else 0 for name in wrappers}:
        raise AssertionError(f"{tag} the multimodal prefill launched {launches}, expected flash {self_layers} "
                             "(the decoder's self layers) and nothing else")
    if not diff <= ZOO_LOGITS_REL_TOL * scale:
        raise AssertionError(f"{tag} multimodal kernel-path logits differ from the plain path by {diff} "
                             f"(max |logit| {scale})")
    if gates and not out["zero_gate_max_abs_diff"] <= ZERO_GATE_TOL:
        raise AssertionError(f"{tag} with zero gates the text-only logits differ from the multimodal ones by "
                             f"{out['zero_gate_max_abs_diff']}")
    return out


def modal_phase(arch: str, layers: int, prompt: int, fa_ops, wrappers: dict, workdir: Path) -> dict:
    """[whisper] / [llama-vision] A modal config at full width (Whisper at full
    depth, Llama-3.2-Vision cut to ``layers``), bf16 weights from a seeded
    generator: the multimodal prefill check (``_modal_prefill_check``), then
    text-only serving through the after2 path under strict, as the
    reference serves these families: analyze (the ``_text_only`` entries) →
    build_artifact → cold_start → generate (B=2 × ``prompt`` +
    ZOO_NEW_TOKENS). Flash attention runs once per decoder self layer in
    every prefill run and no other kernel does; no faulted unit belongs to
    the encoder or a cross block (Whisper's tier-1 is only those: 0 faults;
    the VLM faults vocab row groups only); then ``[graph]`` on the strict
    server, logits bit-equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import build_model
    from repro_torch.serving import GenerationEngine, cold_start
    from repro_torch.utils.tree import flatten_with_paths

    tag = "[whisper]" if arch.startswith("whisper") else "[llama-vision]"
    cfg = get_config(arch).replace(num_layers=layers)
    model = build_model(cfg, param_dtype=torch.bfloat16)
    self_layers = cfg.attn_kinds.count("self")
    per_prefill = {"flash_attention": self_layers}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten_with_paths(params))
    print(f"{tag} {cfg.name} at full width, {layers} of {get_config(arch).num_layers} decoder layers "
          f"({self_layers} self; {n_params / 1e9:.3f} B params), bf16 weights made in "
          f"{time.perf_counter() - t0:.1f} s; {_host_resources(workdir)}", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=torch.Generator().manual_seed(7)).cuda()
    t0 = time.perf_counter()
    check = _modal_prefill_check(tag, model, params, fa_ops, wrappers, tokens, self_layers)
    check["wall_s"] = time.perf_counter() - t0
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    artifact = workdir / f"artifact_{arch}"
    shutil.rmtree(artifact, ignore_errors=True)
    max_seq = prompt + ZOO_NEW_TOKENS + 8
    warm_shapes = ((BATCH, prompt, max_seq),)

    for fn in wrappers.values():
        fn.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    result = analyze(model, profile, trace_B=1, trace_S=32)
    t1 = time.perf_counter()
    meta = build_artifact(params, result, str(artifact), compress_level=1)
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = cold_start(model, str(artifact), result, residency="strict", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=max_seq)
    t3 = time.perf_counter()
    out, stats = engine.generate(tokens, ZOO_NEW_TOKENS)
    t4 = time.perf_counter()
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    tiered = server.tiered
    prefill_runs = len(warm_shapes) + stats.prefill_runs
    decisions = result.plan.decisions
    # the leaves a text request never reads: the encoder, the decoder's cross-
    # attention, and every leaf of the VLM's cross blocks
    cross_units = tuple(f"groups.u{j}." for j, kind in enumerate(model.layout.unit_kinds) if kind == "cross")
    modal = {p for p in decisions if p.startswith(("encoder.",) + cross_units) or ".cross." in p
             or p.endswith(".norm_x")}
    faulted = sorted({e.key for e in tiered.stats.events})
    fault_bytes = sum(e.nbytes for e in tiered.stats.events)
    summary = dict(
        analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3, n_params=n_params, prefill_check=check,
        plan=result.summary(), tier1_compressed_bytes=meta["tier1_compressed_bytes"],
        tier1_leaves=sorted(p for p, d in decisions.items() if d.tier == 1),
        modal_tier1_bytes=sum(decisions[p].nbytes for p in modal if decisions[p].tier == 1),
        cold_start=server.report.to_dict(), budget_bytes=tiered.residency.budget_bytes,
        faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes, fault_s=stats.fault_s,
        fault_rate_gb_s=fault_bytes / stats.fault_s / 1e9 if stats.fault_s else None,
        prefill_s=stats.prefill_s, decode_s=stats.decode_s, prefill_retries=stats.prefill_retries,
        decode_retries=stats.decode_retries, loads=len(tiered.stats.events), load_bytes=fault_bytes,
        faulted_keys=faulted, evictions=tiered.stats.evictions, refaults=tiered.stats.refaults,
        overshoots=tiered.residency.overshoot_events, peak_device_bytes=peak, launches=counts,
        prefill_runs=prefill_runs, tokens=out.tolist(),
    )
    print(f"{tag} " + json.dumps(summary, default=str), flush=True)
    if out.shape != (BATCH, ZOO_NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} bad generated ids: shape {out.shape}, range [{out.min()}, {out.max()}]")
    want = {name: per_prefill.get(name, 0) * prefill_runs for name in wrappers}
    if counts != want:
        raise AssertionError(f"{tag} launched {counts}, expected {want} for {prefill_runs} prefill runs")
    if not {p for p in modal if decisions[p].tier == 1} or any(decisions[p].tier == 1 for p in decisions
                                                               if p not in modal and p != "embed"):
        raise AssertionError(f"{tag} tier-1 should be the modal leaves (and the VLM's row groups): "
                             f"{summary['tier1_leaves']}")
    bad = [k for k in faulted if k.split("#")[0] in modal]
    if bad or (stats.faulted_units > 0) != (not cfg.tie_embeddings):
        raise AssertionError(f"{tag} faulted {faulted}: modal units {bad}; only an untied table's rows may fault")
    summary["graph"] = graph_phase(cfg.name, server, tokens, ZOO_NEW_TOKENS, wrappers, per_prefill, 0.0)
    if any(e.key.split("#")[0] in modal for e in tiered.stats.events):
        raise AssertionError(f"{tag} [graph] faulted a modal unit")
    server.close()
    del server, engine, tiered
    shutil.rmtree(artifact, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


def xlstm_phase(wrappers: dict, workdir: Path) -> dict:
    """[xlstm] xlstm-125m (arXiv:2405.04517) at full width and full depth
    (d_model 768, 4 heads, six m/s units, a tied 50304-row table), bf16
    weights from a seeded generator, through the after2 path under strict:
    analyze → build_artifact → cold_start → generate (B=2 × 1024 +
    ZOO_NEW_TOKENS; the prefill runs the chunkwise mLSTM). The plan's tier-1
    is empty (the tied table is read whole by the logits), so nothing
    faults; no kernel launches (the reference runs xLSTM in jnp); then
    ``[graph]`` on the same server, tokens equal and logits bit-equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact
    from repro_torch.models import build_model
    from repro_torch.serving import GenerationEngine, cold_start
    from repro_torch.utils.tree import flatten_with_paths

    tag = "[xlstm]"
    cfg = get_config("xlstm-125m")
    model = build_model(cfg, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten_with_paths(params))
    print(f"{tag} {cfg.name} at full width and depth ({cfg.num_layers} layers, {n_params:,} params), bf16 "
          f"weights made in {time.perf_counter() - t0:.1f} s; {_host_resources(workdir)}", flush=True)
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    artifact = workdir / "artifact_xlstm"
    shutil.rmtree(artifact, ignore_errors=True)
    max_seq = PROMPT + ZOO_NEW_TOKENS + 8
    warm_shapes = ((BATCH, PROMPT, max_seq),)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=torch.Generator().manual_seed(7)).cuda()

    for fn in wrappers.values():
        fn.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    result = analyze(model, profile, trace_B=1, trace_S=XLSTM_TRACE_S)
    t1 = time.perf_counter()
    build_artifact(params, result, str(artifact), compress_level=1)
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = cold_start(model, str(artifact), result, residency="strict", warm_shapes=warm_shapes)
    engine = GenerationEngine(server, max_seq=max_seq)
    t3 = time.perf_counter()
    out, stats = engine.generate(tokens, ZOO_NEW_TOKENS)
    t4 = time.perf_counter()
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    summary = dict(
        analyze_s=t1 - t0, build_s=t2 - t1, generate_s=t4 - t3, n_params=n_params, plan=result.summary(),
        cold_start=server.report.to_dict(), faulted_units=stats.faulted_units, faulted_bytes=stats.faulted_bytes,
        prefill_s=stats.prefill_s, decode_s=stats.decode_s, decode_s_per_step=stats.decode_s / (ZOO_NEW_TOKENS - 1),
        loads=len(server.tiered.stats.events), peak_device_bytes=peak, launches=counts, tokens=out.tolist(),
    )
    print(f"{tag} " + json.dumps(summary, default=str), flush=True)
    if out.shape != (BATCH, ZOO_NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} bad generated ids: shape {out.shape}, range [{out.min()}, {out.max()}]")
    if any(counts.values()):
        raise AssertionError(f"{tag} launched {counts}: xLSTM reaches no kernel")
    if result.plan.summary()["tier1_leaves"] or stats.faulted_units or summary["loads"]:
        raise AssertionError(f"{tag} tier-1 {result.plan.summary()}, {stats.faulted_units} faults: the plan's "
                             "tier-1 is empty")
    summary["graph"] = graph_phase(cfg.name, server, tokens, ZOO_NEW_TOKENS, wrappers, {}, 0.0)
    g = summary["graph"]
    print(f"{tag} prefill {stats.prefill_s:.3f} s, decode {summary['decode_s_per_step'] * 1e3:.3f} ms/step; "
          f"[graph] replayed decode {g['graph']['decode_s_per_step'] * 1e3:.3f} ms/step against eager "
          f"{g['eager']['decode_s_per_step'] * 1e3:.3f}; peak {peak / 1e9:.2f} GB", flush=True)
    if not g["logits_bit_equal"]:
        raise AssertionError(f"{tag} [graph] logits are not bit-equal to eager's")
    server.close()
    del server, engine
    shutil.rmtree(artifact, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


def _max_param_diff(a, b) -> tuple[float, bool]:
    """Max |a - b| over two param trees, and whether every leaf is bit-equal."""
    import torch

    from repro_torch.utils.tree import flatten_with_paths

    pairs = list(zip(flatten_with_paths(a), flatten_with_paths(b)))
    if [p for (p, _), _ in pairs] != [p for _, (p, _) in pairs]:
        raise AssertionError("the two runs' param trees differ in their paths")
    return (max((x.float() - y.float()).abs().max().item() for (_, x), (_, y) in pairs),
            all(torch.equal(x, y) for (_, x), (_, y) in pairs))


def train_phase(wrappers: dict, workdir: Path) -> dict:
    """[train] The training round trip on xlstm-125m at full width and depth:
    ``Trainer`` with AdamW (fp32 masters, bf16 compute) on the synthetic
    token pipeline at B = TRAIN_BATCH × S = TRAIN_SEQ for TRAIN_STEPS steps,
    beside a run stopped at half and resumed by a fresh Trainer on its
    directory (the max |Δ| of the params at the end, and whether they are
    bit-equal, printed). No kernel may launch under training. Then the last
    committed step: ``CheckpointManager.restore`` → analyze under strict
    (file elimination drops ``opt_state`` and ``data_state``) → the before
    and after1 bundles and the after2 artifact → cold_start in all three
    modes: before reads more than after1, which reads what after2 does
    (tier-1 is empty). The after2 server's tokens (B=2 × TRAIN_PROMPT +
    ZOO_NEW_TOKENS) must equal an engine's on the trainer's in-memory
    params, and its prefill logits theirs bit for bit."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import DeploymentProfile, analyze, build_artifact, write_monolithic
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.serving import ColdStartReport, ColdStartServer, GenerationEngine, cold_start
    from repro_torch.training import TrainConfig, Trainer

    tag = "[train]"
    cfg = get_config("xlstm-125m")
    model = build_model(cfg)  # fp32 masters; compute in the config's bf16
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    tc = TrainConfig(num_steps=TRAIN_STEPS, save_every=TRAIN_STEPS // 2, warmup_steps=2,
                     adamw=AdamWConfig(lr=1e-3))
    outdir = workdir / "train"
    shutil.rmtree(outdir, ignore_errors=True)
    print(f"{tag} {cfg.name} at full width and depth: {model.num_params():,} params, B={TRAIN_BATCH} × "
          f"S={TRAIN_SEQ}, {TRAIN_STEPS} steps; {_host_resources(workdir)}", flush=True)

    for fn in wrappers.values():
        fn.launches = 0  # the main path starts here
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    t0 = time.perf_counter()
    # keep_n=1: each directory holds its newest step only (2.15 GB a step)
    straight = Trainer(model, tc, data, str(outdir / "straight"), keep_n=1, device="cuda")
    r_straight = straight.run()
    walls["straight"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    r_first = Trainer(model, tc, data, str(outdir / "resumed"), keep_n=1, device="cuda").run(TRAIN_STEPS // 2)
    resumed = Trainer(model, tc, data, str(outdir / "resumed"), keep_n=1, device="cuda")
    r_second = resumed.run()
    walls["preempted + resumed"] = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}  # the main path ends here
    diff, bitwise = _max_param_diff(straight.params, resumed.params)
    losses_resumed = r_first.losses + r_second.losses
    summary = dict(losses=r_straight.losses, losses_resumed=losses_resumed, restored_from=r_second.restored_from,
                   param_max_abs_diff=diff, params_bit_equal=bitwise, launches=counts, peak_device_bytes=peak,
                   wall_s=walls, step_s=walls["straight"] / TRAIN_STEPS,
                   mean_step_s=straight.watchdog.mean_step_s, stragglers=r_straight.flagged_steps)
    print(f"{tag} loss per step, straight: {[round(x, 4) for x in r_straight.losses]}; stopped at "
          f"{TRAIN_STEPS // 2} and resumed: {[round(x, 4) for x in losses_resumed]}", flush=True)
    print(f"{tag} resumed vs straight at step {TRAIN_STEPS}: params max |Δ| {diff:.3g} "
          f"({'bit-equal' if bitwise else 'not bit-equal'}); {summary['step_s']:.3f} s/step "
          f"(checkpoint copies included); peak {peak / 1e9:.2f} GB; launches {counts}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"{tag} launched {counts} under training: the loss must run the plain versions")
    if r_second.restored_from != TRAIN_STEPS // 2 or not all(map(math.isfinite, r_straight.losses + losses_resumed)):
        raise AssertionError(f"{tag} resumed from {r_second.restored_from}, losses {summary['losses']} / "
                             f"{losses_resumed}")

    # the last committed step through FaaSLight
    t0 = time.perf_counter()
    restored = CheckpointManager(str(outdir / "straight")).restore()
    profile = DeploymentProfile(resident_experts=0, hot_vocab_fraction=0.0, min_tier1_bytes=1 << 14,
                                vocab_row_group=max(64, cfg.vocab_size // 16))
    result = analyze(model, profile, collections=restored.collections, trace_B=1, trace_S=XLSTM_TRACE_S)
    artifact = outdir / "artifact"
    build_artifact(restored.collections["params"], result, str(artifact), compress_level=1)
    for pruned in (False, True):
        write_monolithic(restored.collections, str(artifact), pruned=pruned)
    walls["restore + analyze + write"] = time.perf_counter() - t0
    del restored
    max_seq = TRAIN_PROMPT + ZOO_NEW_TOKENS + 8
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, TRAIN_PROMPT), generator=torch.Generator().manual_seed(7)).cuda()
    read = {}
    for mode in ("before", "after1", "after2"):
        t0 = time.perf_counter()
        server = cold_start(model, str(artifact), result, mode=mode, residency="strict" if mode == "after2" else None,
                            warm_shapes=((BATCH, TRAIN_PROMPT, max_seq),), compile_warm_set=mode == "after2")
        read[mode] = server.report.to_dict()
        walls[f"cold start {mode}"] = time.perf_counter() - t0
        if mode == "after2":
            out, stats = GenerationEngine(server, max_seq=max_seq).generate(tokens, ZOO_NEW_TOKENS)
            with torch.inference_mode():
                logits = model.prefill(server.live_params(), {"tokens": tokens})[0]
        server.close()
        del server
    torch.cuda.empty_cache()
    memory = ColdStartServer(model, straight.params, ColdStartReport(mode="before"), device="cuda")
    want, _ = GenerationEngine(memory, max_seq=max_seq).generate(tokens, ZOO_NEW_TOKENS)
    with torch.inference_mode():
        want_logits = model.prefill(straight.params, {"tokens": tokens})[0]
    memory.close()
    del memory, straight, resumed
    logits_equal = torch.equal(logits, want_logits)
    nbytes = {m: r["bytes_read"] for m, r in read.items()}
    summary.update(plan=result.summary(), cold_start=read, bytes_read=nbytes, tokens=out.tolist(),
                   memory_tokens=want.tolist(), prefill_logits_bit_equal=logits_equal,
                   faulted_units=stats.faulted_units)
    print(f"{tag} " + json.dumps({k: v for k, v in summary.items() if k not in ("losses", "losses_resumed")},
                                 default=str), flush=True)
    print(f"{tag} dropped collections {result.summary()['dropped_collections_bytes']:,} B; bytes read before "
          f"{nbytes['before']:,}, after1 {nbytes['after1']:,}, after2 {nbytes['after2']:,} (tier-1 empty: after1 "
          f"= after2); restored after2 tokens {out.tolist()}, in-memory params' {want.tolist()}; their prefill "
          f"logits {'bit-equal' if logits_equal else 'differ'}", flush=True)
    if not nbytes["before"] > nbytes["after1"] == nbytes["after2"]:
        raise AssertionError(f"{tag} bytes read {nbytes}: expected before > after1 = after2")
    if result.summary()["dropped_collections_bytes"] <= 0 or stats.faulted_units:
        raise AssertionError(f"{tag} plan {result.summary()}, {stats.faulted_units} faults")
    if out.tolist() != want.tolist() or not logits_equal:
        raise AssertionError(f"{tag} restored server tokens {out.tolist()} vs the in-memory params' "
                             f"{want.tolist()}; prefill logits bit-equal: {logits_equal}")
    summary["mesh"] = mesh_train_phase(model, tc, data, outdir / "straight", workdir, wrappers)
    shutil.rmtree(outdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


def _print_ptxas(name: str, log: str) -> None:
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance Loss", "setmaxnreg")):
            print(f"[build] {name} ptxas: {line.strip()}", flush=True)


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one NVIDIA card.")
    ap.add_argument("--modal-alone", action="store_true",
                    help="build the kernels, run only [whisper], [llama-vision], [xlstm] and [train], one after "
                         "the other with no other phase beside them, and stop without the result line")
    ap.add_argument("--dryrun-alone", action="store_true",
                    help="build the kernels, run only [dryrun] (b), (c) and then (a), and stop without the result line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        from repro_torch.kernels.decode_attention import ops as da_ops
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.rglru_scan import ops as lru_ops
        from repro_torch.kernels.tiered_gather import ops as tg_ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    from repro_torch.kernels import kernel_wrappers

    wrappers = kernel_wrappers()

    gpu = _gpu_line()
    print(f"[build] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    sources = (("flash_attention", fa_ops), ("rglru_scan", lru_ops), ("decode_attention", da_ops),
               ("tiered_gather", tg_ops))
    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc per source, started together
        builds = {name: ex.submit(ops.build) for name, ops in sources}
        for name, fut in builds.items():
            path, log = fut.result()
            print(f"[build] {path.name} ready {time.perf_counter() - t0:.1f} s after the start", flush=True)
            _print_ptxas(name, log)
    # what the decode split plan reads: the blocks the card holds in clusters of 1..8
    for hd in (128, 256):
        print(f"[build] decode kernel at hd {hd}: resident blocks in clusters of 1..8 splits: dense "
              f"{da_ops.resident_blocks(torch.device('cuda'), hd, False)}, paged "
              f"{da_ops.resident_blocks(torch.device('cuda'), hd, True)}", flush=True)

    phase_s = {"build": time.perf_counter() - t0}  # wall seconds of each phase
    workdir = REPO / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)

    def modal(label: str) -> dict:
        """[whisper], [llama-vision], [xlstm] and [train], one after the other."""
        out = {}
        t_thread = time.perf_counter()
        for arch, layers, prompt in (("whisper-base", WHISPER_LAYERS, WHISPER_PROMPT),
                                     ("llama-3.2-vision-90b", LLAMA_VISION_LAYERS, PROMPT)):
            t0 = time.perf_counter()
            out[arch] = modal_phase(arch, layers, prompt, fa_ops, wrappers, workdir)["launches"]
            phase_s[f"serve {arch}{label}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["xlstm-125m"] = xlstm_phase(wrappers, workdir)["launches"]
        phase_s[f"serve xlstm-125m{label}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = train_phase(wrappers, workdir)
        out["xlstm-125m-train"], out["xlstm-125m-train-mesh"] = train["launches"], train["mesh"]["launches"]
        phase_s[f"train xlstm-125m{label}"] = time.perf_counter() - t0
        phase_s[f"(mesh: reshard, trainer, collectives, inside train{label})"] = train["mesh"]["wall_s"]
        phase_s[f"whisper + llama-vision + xlstm + train{label}"] = time.perf_counter() - t_thread
        return out  # each phase holds its own path's launches

    if args.dryrun_alone:
        dryrun_anchor_phase(wrappers)
        dryrun_train_anchors_phase(wrappers)
        dryrun_grid_phase(workdir)
        phase_s["total"] = time.perf_counter() - t_start
        print("[time] " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}), flush=True)
        print(_gpu_line())
        return 0
    if args.modal_alone:
        modal(" (alone)")
        phase_s["total"] = time.perf_counter() - t_start
        print("[time] " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}), flush=True)
        print(_gpu_line())
        return 0
    t_phase = time.perf_counter()
    rows, rows_256, rows_gemma, rows_16, rows_8, rows_whisper, rows_llama, rows_local, rows_gemma_local, \
        rows_rg_local, rows_llama_local = [
        flash_phase(fa_ops, widths, shapes) for widths, shapes in FLASH_ROWS]
    scan_rows = scan_phase(lru_ops)
    decode_rows = decode_phase(da_ops)
    paged_rows = paged_phase(da_ops)
    gather_rows = gather_phase(tg_ops)
    gm_rows = gather_matmul_phase(tg_ops)
    phase_s["kernel"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    paths = {f"paged-decode-{mode}": paged_path_phase(wrappers, rolling=mode == "rolling")["launches"]
             for mode in ("linear", "rolling")}
    phase_s["paged decode"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    strict = serve_phase(wrappers, workdir)
    paths["mixtral-8x22b"] = strict["launches"]
    paths["mixtral-8x22b-full"] = strict["full"]["launches"]
    paths["mixtral-8x22b-online"] = strict["online"]["launches"]
    paths["mixtral-8x22b-arbiter"] = strict["arbiter"]["launches"]
    paths["mixtral-8x22b-restore"] = strict["snapshot"]["launches"]
    paths["mixtral-8x22b-fleet"] = strict["fleet"]["launches"]
    phase_s["serve strict + snapshot + full + online + arbiter + fleet"] = time.perf_counter() - t_phase
    phase_s["(snapshot, inside serve)"] = strict["snapshot"]["wall_s"]
    phase_s["(entries, inside serve full)"] = strict["full"]["entries"]["wall_s"]
    phase_s["(online, inside serve)"] = strict["online"]["wall_s"]
    phase_s["(arbiter, inside serve)"] = strict["arbiter"]["wall_s"]
    phase_s["(fleet, inside serve)"] = strict["fleet"]["wall_s"]
    t_phase = time.perf_counter()
    paths["mixtral-8x22b-stats"] = stats_phase(wrappers, workdir, strict["tokens"])["launches"]
    phase_s["serve stats"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    paths["recurrentgemma-9b"] = recurrentgemma_phase(fa_ops, lru_ops, wrappers, workdir)["launches"]
    phase_s["serve recurrentgemma"] = time.perf_counter() - t_phase
    for arch, layers in (("gemma3-27b", GEMMA_LAYERS), ("deepseek-v2-lite-16b", DEEPSEEK_LAYERS)):
        t_phase = time.perf_counter()
        paths[arch] = zoo_phase(arch, layers, fa_ops, wrappers, workdir)["launches"]
        phase_s[f"serve {arch}"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    for arch, summary in mesh_shard_phase(wrappers).items():
        paths[f"mesh-16-ranks-{arch}"] = summary["launches"]
    phase_s["mesh (d) 16 model ranks, seven families"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    paths["dryrun-1x1-anchor"] = dryrun_anchor_phase(wrappers)["launches"]  # its fake world ends here
    phase_s["dryrun (b) 1x1 anchor"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    for arch, summary in dryrun_train_anchors_phase(wrappers).items():  # their worlds end here
        paths[f"dryrun-1x1-train-{arch}"] = summary["launches"]
    phase_s["dryrun (c) 1x1 train anchors"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    trace = workdir / "retier_trace.json"  # the modes phase's after2 run profiles for [retier]

    def retier(profile: dict) -> dict:
        t0 = time.perf_counter()
        out = retier_phase(workdir, profile, trace)
        phase_s["retier (launcher, beside modes before / after1, traffic and reduced)"] = time.perf_counter() - t0
        return out

    # [whisper], [llama-vision], [xlstm] and [train] run on a thread of this
    # process beside the modes, traffic and [reduced] launcher processes,
    # whose card idles while they write and read their bundles; the
    # in-process launch counts are theirs alone, and the thread is waited
    # for after [reduced]. The modes phase's after2 run goes first: it is
    # [retier]'s profiling run, and [retier]'s launcher process and [mesh]'s
    # 1x1 launcher (mostly their host zlib builds; two at once beside the
    # after2 run would slow it, and [retier] with it) then run beside the
    # before and after1 runs, traffic and [reduced]
    after2_runs = {}
    t_modes = t_phase

    def mesh_launch() -> dict:
        t0 = time.perf_counter()
        out = mesh_launch_phase(workdir)
        phase_s["mesh launcher 1x1 (beside modes before / after1, traffic and reduced)"] = time.perf_counter() - t0
        return out

    def after_profile(run: dict) -> None:
        after2_runs.update(retier=ex.submit(retier, run), mesh=ex.submit(mesh_launch))

    def dryrun_grid() -> dict:
        t0 = time.perf_counter()
        out = dryrun_grid_phase(workdir)
        phase_s["dryrun (a) 16x16, host only (beside modes)"] = time.perf_counter() - t0
        return out

    with ThreadPoolExecutor(4) as ex:
        modal_run = ex.submit(modal, " (beside modes)")
        grid_run = ex.submit(dryrun_grid)
        modes = modes_phase(workdir, trace, on_profile=after_profile)
        phase_s["modes (launcher)"] = time.perf_counter() - t_phase
        paths["modes-after2 (retier profile)"] = modes["after2"]["launches"]
        t_phase = time.perf_counter()
        traffic_phase(workdir)
        phase_s["traffic (launcher)"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        reduced = reduced_phase(workdir)
        paths["reduced"], paths["reduced-online"] = reduced["launches"], reduced["online_launches"]
        paths["reduced-train"] = reduced["train_launches"]
        paths["reduced-restore"], paths["reduced-fleet"] = reduced["restore_launches"], reduced["fleet_launches"]
        phase_s["reduced (launcher)"] = time.perf_counter() - t_phase
        paths["retier-serve"] = after2_runs["retier"].result()["retier"]["launches"]
        paths["mesh-1x1-launcher"] = check_mesh_launch(after2_runs["mesh"].result(), modes["after2"])["launches"]
        paths.update(modal_run.result())
        grid_run.result()
        phase_s["modes + traffic + reduced, the in-process thread beside them"] = time.perf_counter() - t_modes
    phase_s["total"] = time.perf_counter() - t_start
    print("[time] " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}), flush=True)
    # the served decode is the plain dense one, as in the reference, and Mixtral has no recurrent layer
    for path, served in (("mixtral-8x22b", {"flash_attention"}), ("mixtral-8x22b-full", {"flash_attention"}),
                         ("mixtral-8x22b-stats", {"flash_attention"}),
                         ("mixtral-8x22b-online", {"flash_attention"}), ("mixtral-8x22b-arbiter", {"flash_attention"}),
                         ("mixtral-8x22b-restore", {"flash_attention"}), ("mixtral-8x22b-fleet", {"flash_attention"}),
                         ("reduced-online", {"flash_attention"}), ("reduced-restore", {"flash_attention"}),
                         ("reduced-fleet", {"flash_attention"}),
                         ("recurrentgemma-9b", {"flash_attention", "rglru_scan"}),
                         ("gemma3-27b", {"flash_attention"}), ("deepseek-v2-lite-16b", set()),
                         ("whisper-base", {"flash_attention"}), ("llama-3.2-vision-90b", {"flash_attention"}),
                         ("xlstm-125m", set()), ("xlstm-125m-train", set()), ("reduced-train", set()),
                         ("reduced", {"flash_attention"}), ("modes-after2 (retier profile)", {"flash_attention"}),
                         ("retier-serve", {"flash_attention"}), ("mesh-1x1-launcher", {"flash_attention"}),
                         ("xlstm-125m-train-mesh", set()), ("dryrun-1x1-anchor", set()),
                         *((f"dryrun-1x1-train-{a[0]}", set()) for a in DRYRUN_TRAIN_ANCHORS),
                         ("mesh-16-ranks-mixtral-8x22b", {"flash_attention"}),
                         ("mesh-16-ranks-gemma3-27b", {"flash_attention"}), ("mesh-16-ranks-deepseek-v2-lite-16b", set()),
                         ("mesh-16-ranks-deepseek-v2-lite-16b-fp32", set()),
                         ("mesh-16-ranks-recurrentgemma-9b", {"flash_attention", "rglru_scan"}),
                         ("mesh-16-ranks-whisper-base", {"flash_attention"}),
                         ("mesh-16-ranks-llama-3.2-vision-90b", {"flash_attention"}),
                         ("mesh-16-ranks-xlstm-125m", set())):
        stray = {name: n for name, n in paths[path].items() if n and name not in served}
        if stray:
            raise AssertionError(f"the {path} serve path launched {stray}")

    def entry(name: str, source: str, replaces: str, shapes: list, main_row: dict, **extra) -> dict:
        by_path = {path: counts[name] for path, counts in paths.items()}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
                "replaces": f"src/repro/kernels/{replaces}", "launches": sum(by_path.values()),
                "launches_by_path": by_path, **{k: main_row[k] for k in keys}, **extra, "shapes": shapes}

    kernels = [
        entry("flash_attention", "flash_attention/csrc/flash_attention.cu", "flash_attention/kernel.py:103",
              rows + rows_256 + rows_gemma + rows_16 + rows_8 + rows_whisper + rows_llama + rows_local
              + rows_gemma_local + rows_rg_local + rows_llama_local, rows[0]),
        entry("rglru_scan", "rglru_scan/csrc/rglru_scan.cu", "rglru_scan/kernel.py:50", scan_rows, scan_rows[0]),
        entry("decode_attention", "decode_attention/csrc/decode_attention.cu", "decode_attention/kernel.py:201",
              decode_rows, decode_rows[0]),
        entry("paged_decode_attention", "decode_attention/csrc/decode_attention.cu",
              "decode_attention/kernel.py:141", paged_rows, paged_rows[0],
              yardstick=paged_rows[0]["yardstick"], yardstick_ms=paged_rows[0]["yardstick_ms"]),
        entry("tiered_gather_matmul", "tiered_gather/csrc/tiered_gather.cu", "tiered_gather/kernel.py:86",
              gm_rows, gm_rows[0], yardstick=gm_rows[1]["yardstick"], yardstick_ms=gm_rows[1]["yardstick_ms"]),
        entry("tiered_gather", "tiered_gather/csrc/tiered_gather.cu", "tiered_gather/kernel.py:154",
              gather_rows, gather_rows[0]),
    ]
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
