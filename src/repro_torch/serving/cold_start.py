"""Cold-start manager: artifact → serving-ready state, with the paper's three
variants measured end to end (``repro.serving.cold_start`` counterpart).

Phases, as in the reference:

  read    — storage → host RAM (the monolithic bundle, or the tier-0 bundle
            and the optional store opened)
  upload  — host → device: leaves copied up, tier-1 leaves allocated as
            full-shape zeros on the device, the hot set preloaded
  compile — the warm set's entries (``compiled_prefill`` and
            ``compiled_decode`` per warm shape): on a CUDA device each is run
            once and captured as a CUDA graph, the analogue of the
            reference's XLA compile of its ``jax.jit`` entries; on the CPU
            each is the plain model call, with nothing to make

Modes:
  before — monolithic bundle: every collection read, the params uploaded
  after1 — collection-pruned bundle (① Optional File Elimination applied)
  after2 — two-tier artifact: tier-0 read and uploaded, tier-1 placeholders,
           hot units preloaded; misses fault in at request time

Residency policies (``RESIDENCY_PRESETS``, after2 only) — tier-1 device
budget as a fraction of tier-1 bytes, and whether the prefetcher runs:
  strict — 25%, no prefetch
  stats  — 50%, prefetch driven by the engine's hints
  full   — unlimited, prefetch
An explicit ``device_budget_bytes`` overrides the preset's budget, and
``prefetch=`` its prefetch default. Under a ``host_arbiter`` the preset's
fraction becomes the tenant's share of the arbiter's budget instead, and the
tenant registers before the hot-set preload, so even cold-start bytes are
admitted by the arbiter's make-room path. ``retier_online=True`` attaches a
``RetierDaemon`` (and a live trace), which the engine and the scheduler tick
between steps; ``fleet=`` registers that daemon with a ``FleetController``
before the server exists, so a late joiner is warm-bootstrapped before its
warm set is captured; as in the reference, the report does not count the
bootstrap, whose seconds and bytes are ``ColdStartServer.fleet_bootstrap``.
``restore_from=`` (a snapshot dict or a JSON path)
faults a warmed server's resident set in again and arms its predictor, after
the server is built and before its warm set is captured; its seconds and
bytes count as upload. ``ColdStartServer.snapshot()`` writes that state.
``admission=``, ``kv_page_size=`` and ``kv_pages=`` are kept on the server as
the defaults of a scheduler built on it.

Compiled entries. ``ColdStartServer.compiled_prefill(B, S)``,
``compiled_decode(B, S_max)`` and ``compiled_decode_masked(B, S_max)`` are
made once per shape; a shape outside the warm set is made on first use, as
``jax.jit`` compiles on first use. Decode entries and the warm set's are kept
for the server's life. Prefill entries of other shapes are kept up to
``max_prefill_entries``, least recently used first out: each holds its
prefill's logits and B × S K/V caches, so under traffic whose prompt lengths
vary, keeping them all would grow device memory without bound (``jax.jit``'s
cache keeps executables only). An evicted entry's graph and outputs are
freed, and the shared pool reuses their memory for the next capture.
The entry is chosen by device, as the kernel wrappers are: a ``GraphEntry``
(one captured CUDA graph) on a CUDA device, an ``EagerEntry`` (the plain
call) on the CPU. A capture that
fails raises; nothing runs eagerly on the card instead. A decode entry owns
its (B, S_max) caches: callers pass ``entry.caches`` and the step writes them
in place. A graph reads the live params at the addresses it was captured
with, which holds because ``TieredParams`` installs and evicts in place
(``_install`` / ``_evict_one``): a unit faulted in or evicted after the
capture is what the next replay reads. A graph's outputs are its own static
tensors, rewritten by the next replay of any graph of the server (all share
one memory pool), so callers read them before the next call.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.core.analyzer import AnalysisResult
from repro_torch.core import snapshot as server_snapshot
from repro_torch.core.arbiter import HostArbiter
from repro_torch.core.on_demand import TieredParams
from repro_torch.core.optional_store import OptionalStore
from repro_torch.core.prefetch import Prefetcher, TransitionPredictor
from repro_torch.core.retier_daemon import RetierDaemon
from repro_torch.kernels import kernel_wrappers
from repro_torch.models.layers import greedy_sharded
from repro_torch.models.zoo import Model
from repro_torch.sharding.comm import DistComm, mesh_dims_supported
from repro_torch.sharding.rules import (
    ACT_RULES,
    Shard,
    act_specs,
    block_of,
    comm_mesh,
    gather_axis,
    gather_tree,
    graft_block,
    param_shardings,
    place,
    place_zeros,
    resolve_pspec,
    shard_tree,
    spec_dims,
    spec_of,
    spec_shard_divisor,
)
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map

# prefill entries outside the warm set a server keeps (least recently used out)
MAX_PREFILL_ENTRIES = 4

# residency policy -> (tier-1 budget fraction or None = unlimited, prefetch enabled)
RESIDENCY_PRESETS: dict = {
    "strict": (0.25, False),
    "stats": (0.5, True),
    "full": (None, True),
}


@dataclass
class ColdStartReport:
    mode: str
    read_s: float = 0.0
    upload_s: float = 0.0
    compile_s: float = 0.0
    bytes_read: int = 0
    bytes_uploaded: int = 0

    @property
    def total_s(self) -> float:
        return self.read_s + self.upload_s + self.compile_s

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "read_s": self.read_s,
            "upload_s": self.upload_s,
            "compile_s": self.compile_s,
            "total_s": self.total_s,
            "bytes_read": self.bytes_read,
            "bytes_uploaded": self.bytes_uploaded,
        }


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EagerEntry:
    """A compiled entry's plain form, used on the CPU: ``fn(params, [caches,]
    batch)`` called as it is; nothing runs when it is made. A decode entry
    owns ``caches`` (the decode caches it reads and writes); every call must
    pass exactly those and the params it was made with, as a ``GraphEntry``
    requires. ``gate`` and ``pool`` are a ``GraphEntry``'s."""

    def __init__(self, fn: Callable, params: Any, batch: dict, caches: Optional[dict] = None, *,
                 gate: Optional[threading.Lock] = None, pool=None):
        self.fn, self.params, self.caches = fn, params, caches
        self._batch = batch  # the shapes and dtypes every call must match
        self.make_s = 0.0  # seconds its making took (a graph's: warm-up run and capture)

    def _run(self, batch: dict):
        return self.fn(self.params, *([self.caches] if self.caches is not None else []), batch)

    def _check(self, params: Any, args: tuple) -> dict:
        *caches, batch = args
        if params is not self.params:
            raise ValueError("a compiled entry reads the params it was made with")
        if (self.caches is not None) != bool(caches) or (caches and caches[0] is not self.caches):
            raise ValueError("a compiled decode entry reads and writes its own caches: pass entry.caches")
        for k, t in self._batch.items():
            if tuple(batch[k].shape) != tuple(t.shape):
                raise ValueError(f"batch[{k!r}] has shape {tuple(batch[k].shape)}, the entry {tuple(t.shape)}")
        return batch

    def __call__(self, params: Any, *args):
        batch = self._check(params, args)
        with torch.inference_mode():
            return self._run(batch)


@functools.lru_cache(maxsize=None)
def _warmup_stream(device: int) -> torch.cuda.Stream:
    """The side stream every capture's warm-up runs on: one per device for
    the process. A stream that runs a matmul gets a cuBLAS workspace of its
    own (32 MiB on an H100) that lives as long as the process, so a new
    stream per capture would grow device memory with every new shape."""
    return torch.cuda.Stream(device)


class GraphEntry(EagerEntry):
    """``fn(params, [caches,] batch)`` captured as one CUDA graph at fixed
    shapes. Static inputs: the batch tensors (the call's values are copied in)
    and the decode caches it owns; static outputs: whatever ``fn`` returned at
    capture (logits, the usage masks, a prefill's caches, a decode's new
    carry state), rewritten by every replay.

    Made under ``gate`` (the tiered params' lock), so no install or eviction
    from the prefetcher's thread lands inside the capture. The warm-up run
    goes on a side stream before the capture, so first-use work (a kernel's
    nvcc build, the lookup of ``cuTensorMapEncodeTiled``, cuBLAS's setup) happens
    outside the graph. Kernel wrappers count launches when they run, so the
    capture's own counts are taken back and each replay adds the launches
    the graph recorded (``launches``)."""

    def __init__(self, fn: Callable, params: Any, batch: dict, caches: Optional[dict] = None, *,
                 gate: Optional[threading.Lock] = None, pool=None):
        t0 = time.perf_counter()
        self.fn, self.params, self.caches = fn, params, caches
        self._batch = batch
        self._counters = counters = kernel_wrappers()
        with gate or contextlib.nullcontext(), torch.inference_mode():
            side = _warmup_stream(torch.cuda.current_device())
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._run(batch)
            torch.cuda.current_stream().wait_stream(side)
            before = {name: f.launches for name, f in counters.items()}
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, pool=pool):
                    self.out = self._run(batch)
            finally:
                self.launches = {name: f.launches - before[name] for name, f in counters.items()}
                for name, f in counters.items():
                    f.launches = before[name]  # recorded, not run: each replay counts them
            if caches is not None:  # the warm-up wrote them
                tree_map(torch.Tensor.zero_, caches)
        torch.cuda.synchronize()
        self.make_s = time.perf_counter() - t0

    def __call__(self, params: Any, *args):
        batch = self._check(params, args)
        for k, t in self._batch.items():
            t.copy_(batch[k])
        self.graph.replay()
        for name, n in self.launches.items():
            self._counters[name].launches += n
        return self.out


class ColdStartServer:
    """A cold-started model server: the live params (tiered in after2), the
    optional store, the prefetcher, the online re-tiering daemon, the
    compiled entries, and the defaults of a scheduler built on it
    (``admission``, ``kv_page_size``, ``kv_pages``; None = the scheduler's
    own)."""

    def __init__(self, model: Model, params: Any, report: ColdStartReport, *,
                 tiered: Optional[TieredParams] = None, store: Optional[OptionalStore] = None,
                 prefetcher: Optional[Prefetcher] = None, retier_daemon: Optional[RetierDaemon] = None,
                 artifact_dir: Optional[str] = None, device="cuda",
                 max_prefill_entries: int = MAX_PREFILL_ENTRIES, admission: Any = None,
                 kv_page_size: Optional[int] = None, kv_pages: Optional[int] = None, mesh=None):
        if max_prefill_entries < 1:
            raise ValueError(f"max_prefill_entries must be >= 1, got {max_prefill_entries}")
        self.model = model
        self.params = params
        self.report = report
        self.tiered = tiered
        self.store = store
        self.prefetcher = prefetcher
        self.retier_daemon = retier_daemon
        self.artifact_dir = artifact_dir
        self.device = torch.device(device)
        self.max_prefill_entries = max_prefill_entries
        self.admission = admission
        self.kv_page_size = kv_page_size
        self.kv_pages = kv_pages
        self.mesh = mesh  # the params are DTensors on it
        # a multi-rank ("data", "model") mesh: the entries compute on each
        # rank's shards (``comm``); a mesh with another dim gathers at use
        self.comm = None
        if mesh is not None and mesh.size() > 1 and mesh_dims_supported(mesh.mesh_dim_names):
            self.comm = DistComm(mesh)
        # collective bytes of each sharded forward run, per entry kind
        self.collective_bytes: dict = {"prefill": [], "decode": []}
        self.restore_report: Optional[dict] = None  # set by cold_start(restore_from=)
        # a fleet joiner's warm bootstrap, {"seconds", "bytes"}: set by cold_start(fleet=)
        self.fleet_bootstrap: Optional[dict] = None
        self._compiled: OrderedDict[tuple, EagerEntry] = OrderedDict()
        self._kept: set = set()  # keys never evicted: the warm set's (``keep_entries``)
        self.evicted_prefill_entries = 0
        self._pool = None  # the graphs' shared memory pool (replays never overlap)

    def close(self) -> None:
        """Free the compiled entries, stop the prefetcher's threads, wait for
        an in-flight compaction, leave the host pool (if arbitered) and close
        the store, in the reference's order. The store is closed even if an
        earlier step raises."""
        self._compiled.clear()
        self._kept.clear()
        try:
            if self.prefetcher is not None:
                self.prefetcher.stop()
                self.prefetcher = None
            if self.retier_daemon is not None:
                # a periodic compaction may still be rewriting the artifact on
                # its worker thread (it reads the store through its own handle)
                self.retier_daemon.join_compaction(timeout=60.0)
            if self.tiered is not None and self.tiered.arbiter is not None:
                self.tiered.arbiter.unregister(self.tiered.tenant_name)
        finally:
            if self.store is not None:
                self.store.close()
                self.store = None

    def __enter__(self) -> "ColdStartServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def sharded(self) -> bool:
        """True when the entries compute on this rank's shards."""
        return self.comm is not None

    @property
    def entry_kind(self) -> str:
        """"graph" (``GraphEntry``) on a CUDA device, "eager" (``EagerEntry``)
        on the CPU and under a mesh with a dim above 1, whose gathers are
        collectives that no capture holds."""
        if self.device.type != "cuda":
            return "eager"
        return "graph" if self.mesh is None or all(n == 1 for n in self.mesh.shape) else "eager"

    def live_params(self) -> Any:
        return self.tiered.tree() if self.tiered is not None else self.params

    def snapshot(self) -> dict:
        """This server's warm state (resident set and LRU stamps, the
        predictor's tables, the artifact's identity) as a plain-JSON dict
        that a new replica restores from (``cold_start(restore_from=...)``)."""
        if self.tiered is None:
            raise ValueError("snapshot() needs a tiered (after2) server")
        return server_snapshot.capture(self.tiered, prefetcher=self.prefetcher, artifact_dir=self.artifact_dir)

    # -- warm-set / on-demand compilation ------------------------------------
    def keep_entries(self) -> None:
        """Mark every entry made so far as kept for the server's life (the
        cold start calls it after making the warm set)."""
        self._kept.update(self._compiled)

    def prefill_entries(self) -> list:
        """The keys of the prefill entries held now, least recently used first."""
        return [k for k in self._compiled if k[0] == "prefill"]

    def _evict_prefill(self) -> None:
        """Drop least recently used prefill entries outside the kept set until
        one more fits under ``max_prefill_entries``. The dropped entry's graph,
        static inputs and outputs go with it; nothing else refers to an entry
        (the engine and the scheduler hold one only within a step)."""
        evictable = [k for k in self.prefill_entries() if k not in self._kept]
        for key in evictable[:max(0, len(evictable) - self.max_prefill_entries + 1)]:
            del self._compiled[key]
            self.evicted_prefill_entries += 1

    def _entry(self, key: tuple, fn: Callable, batch_spec: dict, cache_shape: Optional[tuple] = None):
        if key in self._compiled:
            if key[0] == "prefill":
                self._compiled.move_to_end(key)  # most recently used
        else:
            if key[0] == "prefill":
                self._evict_prefill()
            # ordinary tensors even when made inside inference mode, so that
            # callers may write them in place outside it (a scheduler's graft)
            with torch.inference_mode(False):
                batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=self.device)
                         for k, v in batch_spec.items()}
                caches = None
                if cache_shape is not None:
                    if self.sharded:  # this rank's blocks in the cache_axes layout
                        caches = tree_map(lambda b: torch.zeros(b.shape, dtype=b.dtype, device=self.device),
                                          self._cache_blocks(*cache_shape))
                    else:
                        caches = self.model.init_cache(*cache_shape, multimodal=False, device=self.device)
            cls = EagerEntry
            if self.entry_kind == "graph":
                cls = GraphEntry
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
            if self.sharded:
                fn = self._sharded(key[0], batch_spec, cache_shape)
            elif self.mesh is not None:
                fn = _gathered(fn)
            gate = self.tiered.gate if self.tiered is not None else None
            self._compiled[key] = cls(fn, self.live_params(), batch, caches, gate=gate, pool=self._pool)
        return self._compiled[key]

    # -- the sharded entries ---------------------------------------------------
    def _cache_specs(self, B: int, S: int) -> dict:
        """The ``cache_axes`` spec of every cache leaf at (B, S) on the mesh."""
        return act_specs(self.model.cache_axes(B, S, multimodal=False),
                         self.model.abstract_cache(B, S, multimodal=False), self.comm)

    def _cache_blocks(self, B: int, S: int) -> dict:
        """Meta tensors of this rank's cache blocks at (B, S)."""
        return _zip_map(lambda leaf, spec: block_of(leaf, spec, self.comm),
                        self.model.abstract_cache(B, S, multimodal=False), self._cache_specs(B, S))

    def _sharded(self, kind: str, batch_spec: dict, cache_shape: Optional[tuple]) -> Callable:
        """The entry's function on this rank's shards: the whole batch (every
        rank holds it) cut to the rank's rows by the activation rules, the
        params' local blocks, the decode caches' blocks; it logs the bytes
        its collectives moved."""
        comm, model = self.comm, self.model
        entry_kind = "prefill" if kind == "prefill" else "decode"
        axes = model.batch_axes(batch_spec, entry_kind)
        specs = act_specs(axes, batch_spec, comm)
        cache_specs = self._cache_specs(*cache_shape) if cache_shape is not None else None

        def run(params, *args):
            *caches, batch = args
            rows = {k: Shard(block_of(batch[k], specs[k], comm), tuple(batch[k].shape), specs[k]) for k in batch}
            before = comm.moved_bytes
            if cache_specs is None:
                out = model.prefill_sharded(shard_tree(params), rows, comm)
            else:
                out = model.decode_step_sharded(shard_tree(params), caches[0], rows, comm, cache_specs)
            self.collective_bytes[entry_kind].append(comm.moved_bytes - before)
            return out
        return run

    def _rows_of(self, B: int) -> tuple:
        """The mesh dims a batch of B rows is split over."""
        return spec_dims(resolve_pspec(("batch",), (B,), comm_mesh(self.comm), ACT_RULES), 0)

    def _head(self) -> Shard:
        """The head's table (a tied model's embedding) as this rank's block."""
        h = self.model.logits_table(self.live_params())
        return Shard(h.to_local(), tuple(h.shape), spec_of(h))

    def next_tokens(self, logits: torch.Tensor, B: int) -> torch.Tensor:
        """Greedy ids (B,) of an entry's logits: ``torch.argmax``, or on the
        sharded server the argmax across the ranks' vocab blocks (every rank
        gets every row's id)."""
        if not self.sharded:
            return torch.argmax(logits, dim=-1)
        head = self._head()
        return greedy_sharded(logits, head.start(0, self.comm), head.split(0), self._rows_of(B), self.comm)

    def whole_logits(self, logits: torch.Tensor, B: int) -> torch.Tensor:
        """An entry's logits as the whole (B, V) array (all-gathered over the
        vocab's and the rows' mesh dims on the sharded server)."""
        if not self.sharded:
            return logits
        logits = gather_axis(logits, 1, self._head().split(0), self.comm)
        return gather_axis(logits, 0, self._rows_of(B), self.comm)

    def graft_prefill(self, decode: EagerEntry, caches: Any, B: int, S: int, S_max: int) -> Any:
        """``engine._graft_prefill_cache`` on the sharded server: a (B, S)
        prefill's cache blocks written into the (B, S_max) decode entry's own
        blocks as prefixes, each rank its block of the decode layout
        (``sharding.rules.graft_block``). Returns the decode entry's caches."""
        small_specs, big_specs = self._cache_specs(B, S), self._cache_specs(B, S_max)
        small_abs = dict(flatten_with_paths(self.model.abstract_cache(B, S, multimodal=False)))
        big_abs = dict(flatten_with_paths(self.model.abstract_cache(B, S_max, multimodal=False)))
        fs, fb, big = dict(flatten_with_paths(small_specs)), dict(flatten_with_paths(big_specs)), \
            dict(flatten_with_paths(decode.caches))
        for path, small in flatten_with_paths(caches):
            graft_block(big[path], fb[path], big_abs[path].shape, small, fs[path], small_abs[path].shape, self.comm)
        return decode.caches

    def compiled_prefill(self, B: int, S: int) -> EagerEntry:
        """The prefill entry at (B, S): ``entry(params, batch)``. Serving is
        text-only, as the reference's: a modal family's batch carries no
        ``frames`` or ``image_embeds`` and its caches no cross K/V."""
        return self._entry(("prefill", B, S), self.model.prefill, self.model.prefill_batch_spec(B, S, multimodal=False))

    def compiled_decode(self, B: int, S_max: int) -> EagerEntry:
        """The decode entry over (B, S_max) caches: ``entry(params,
        entry.caches, batch)``."""
        return self._entry(("decode", B, S_max), self.model.decode_step, self.model.decode_batch_spec(B),
                           (B, S_max))

    def compiled_decode_masked(self, B: int, S_max: int) -> EagerEntry:
        """The masked decode over ``B`` scheduler slots, the continuous-
        batching scheduler's one decode shape: inactive rows never reach the
        usage masks, so a free slot never faults a unit in."""
        return self._entry(("decode_masked", B, S_max), self.model.decode_step_masked,
                           self.model.decode_masked_batch_spec(B), (B, S_max))


def _zip_map(fn: Callable, tree: Any, other: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _gathered(fn: Callable) -> Callable:
    """``fn`` on the whole arrays of a DTensor param tree: each leaf is
    gathered when the entry runs (``sharding.gather``: a view on a mesh of
    1s, an all-gather otherwise), and the copies live for that run only."""
    @functools.wraps(fn)
    def run(params, *args):
        return fn(gather_tree(params), *args)
    return run


def cold_start(
    model: Model,
    artifact_dir: str,
    result: Optional[AnalysisResult] = None,
    *,
    mode: str = "after2",
    residency: Optional[str] = None,  # RESIDENCY_PRESETS name (after2 only)
    device_budget_bytes: Optional[int] = None,  # overrides the preset budget
    prefetch: Optional[bool] = None,  # overrides the preset's prefetch default
    prefetch_batch_units: int = 8,
    predictor: Optional[TransitionPredictor] = None,  # profile-trained prefetch
    host_arbiter: Optional[HostArbiter] = None,  # one device budget shared by N tenants
    tenant_name: Optional[str] = None,  # arbiter registration name (default: the config's name)
    tenant_share: Optional[float] = None,  # overrides the preset-derived share
    tenant_floor_bytes: int = 0,  # the arbiter never evicts this tenant below it
    retier_online: bool = False,  # attach a RetierDaemon (implies a live trace)
    retier_interval: int = 32,  # daemon cadence, serving steps per tick
    retier_interval_s: Optional[float] = None,  # or wall-clock seconds
    retier_decay: float = 0.5,  # trace-window merge decay per tick
    retier_compact_every: int = 0,  # artifact rewrite every N applies (0 = never)
    fleet=None,  # FleetController the daemon joins (needs retier_online)
    replica_name: Optional[str] = None,  # fleet registration name (default: replica-<n>)
    restore_from=None,  # server snapshot dict or JSON path: warm restore (after2 only)
    admission=None,  # default AdmissionPolicy of schedulers built on the server
    kv_page_size: Optional[int] = None,  # their default page size
    kv_pages: Optional[int] = None,  # their default page-pool size
    warm_shapes: tuple = ((1, 64),),  # (B, S) or (B, S, S_max): prefill (B, S), decode (B, S_max or S)
    compile_warm_set: bool = True,
    trace: bool = False,  # attach an AccessTrace to the tiered params
    mesh=None,  # DeviceMesh: shard the params over it (launch.mesh)
    device="cuda",
) -> ColdStartServer:
    """Run one timed cold start from ``artifact_dir``. ``result`` (the plan)
    is required for after2; before/after1 read ``<artifact_dir>/<mode>``, as
    ``core.analyzer.write_monolithic`` writes it. The arbiter, re-tiering and
    fleet arguments are after2-only and ignored by the monolithic modes;
    ``restore_from`` outside after2 raises.

    ``mesh=`` places every leaf as a ``DTensor`` on the mesh, resolved by the
    param rules (``sharding.param_shardings``): each rank keeps its own block
    of each tier-0 leaf (cut from the bundle every rank reads, no collective)
    and of each tier-1 placeholder. The residency budget and the arbiter
    charge each unit its bytes per shard (``TieredParams(shard_divisors=)``),
    and a preset's budget is its fraction of the charged tier-1 bytes. On a
    ("data", "model") mesh with a dim above 1, every family computes on
    each rank's shards (``ColdStartServer.sharded``): each entry cuts the
    batch to the rank's rows and runs ``Model.prefill_sharded`` /
    ``decode_step_sharded`` on the params' local blocks, gathering one
    weight's ``embed`` dim over ``data`` at its use, with TP / EP over
    ``model``; a decode entry's caches are the rank's blocks in the
    ``cache_axes`` layout (K/V and latent slots over ``model``, the RG-LRU's
    state with its channels and the xLSTM's with its heads over ``model``).
    Its logits are the
    rank's (rows, vocab rows) block: ``next_tokens`` takes the argmax across
    ranks, ``whole_logits`` gathers them, ``graft_prefill`` moves a
    prefill's cache blocks into the decode layout. A mesh with a ``pod`` dim
    gathers the leaves when the entries run and computes replicated; the
    gathered copies last one forward run. On a mesh of 1s nothing is sharded
    or gathered (the local tensor is the leaf), and the warm set is still
    captured as CUDA graphs; on a larger mesh the entries run eagerly
    (``ColdStartServer.entry_kind``)."""
    if residency is not None and residency not in RESIDENCY_PRESETS:
        raise ValueError(f"unknown residency policy {residency!r}; want one of {sorted(RESIDENCY_PRESETS)}")
    if restore_from is not None and mode != "after2":
        raise ValueError("restore_from= is after2-only (the monolithic modes have no residency set)")
    if fleet is not None and not retier_online and mode == "after2":
        raise ValueError("fleet= needs retier_online=True (the fleet federates RetierDaemons, not bare loaders)")
    device = torch.device(device)
    report = ColdStartReport(mode=mode)
    shardings = None
    if mesh is not None:
        shardings = dict(flatten_with_paths(param_shardings(model.logical_axes(), model.abstract(), mesh,
                                                            fsdp=bool(getattr(model.cfg, "fsdp", True)))))

    def put(path: str, host: torch.Tensor):
        return host.to(device) if shardings is None else place(host, mesh, shardings[path], device)

    if mode in ("before", "after1"):
        t0 = time.perf_counter()
        flat = tsl.read_bundle(os.path.join(artifact_dir, mode))  # every byte moves
        report.bytes_read = sum(t.numel() * t.element_size() for t in flat.values())
        t1 = time.perf_counter()
        # upload the params collection only (the others have no device-side
        # consumer at serving time, but their bytes were read)
        pflat = {p[len("params."):]: t for p, t in flat.items() if p.startswith("params.")}
        del flat
        report.bytes_uploaded = sum(t.numel() * t.element_size() for t in pflat.values())
        params = tree_from_flat({p: put(p, t) for p, t in pflat.items()})
        del pflat
        _synchronize(device)
        t2 = time.perf_counter()
        report.read_s, report.upload_s = t1 - t0, t2 - t1
        server = ColdStartServer(model, params, report, artifact_dir=artifact_dir, device=device,
                                 admission=admission, kv_page_size=kv_page_size, kv_pages=kv_pages, mesh=mesh)
    elif mode == "after2":
        if result is None:
            raise ValueError("after2 cold start needs the AnalysisResult (plan)")
        plan = result.plan
        t0 = time.perf_counter()
        tier0 = tsl.read_bundle(os.path.join(artifact_dir, "tier0"))
        store = OptionalStore(os.path.join(artifact_dir, "optional.blob"))
        report.bytes_read = sum(t.numel() * t.element_size() for t in tier0.values())
        t1 = time.perf_counter()
        live_flat = {}
        abstract = dict(flatten_with_paths(model.abstract()))
        for path, leaf in abstract.items():
            if plan.decisions[path].tier == 0:
                live_flat[path] = put(path, tier0.pop(path))
            elif shardings is None:
                # the rewritten stub: zeros of the full shape, on the device
                live_flat[path] = torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
            else:
                live_flat[path] = place_zeros(leaf.shape, leaf.dtype, mesh, shardings[path], device)
        tree = tree_from_flat(live_flat)
        _synchronize(device)
        # a unit of a leaf split D ways costs its bytes / D on each device
        divisors = None if shardings is None else {p: spec_shard_divisor(sh.spec, mesh)
                                                    for p, sh in shardings.items()}

        budget, want_prefetch, share = device_budget_bytes, prefetch, tenant_share
        if residency is not None:
            frac, preset_prefetch = RESIDENCY_PRESETS[residency]
            if host_arbiter is not None:
                if share is None:
                    share = frac if frac is not None else 1.0
            elif budget is None and frac is not None:
                # a fraction of the tier-1 bytes each device is charged
                tier1 = plan.tier1_bytes
                if divisors is not None:
                    tier1 = sum(-(-math.prod(leaf.shape) * leaf.element_size() // divisors[p])
                                for p, leaf in abstract.items() if plan.decisions[p].tier != 0)
                budget = int(frac * tier1)
                # never below two of the largest units (one incoming + one pinned)
                max_unit = max((e.rsize for e in store.entries.values()), default=0)
                budget = max(budget, 2 * max_unit)
            if want_prefetch is None:
                want_prefetch = preset_prefetch
        tiered = TieredParams(tree, plan, store, device_budget_bytes=budget, shard_divisors=divisors)
        if host_arbiter is not None:
            # join the host pool before the hot-set preload
            name = tenant_name or model.cfg.name or f"tenant-{id(tiered):x}"
            host_arbiter.register(name, tiered, share=share if share is not None else 1.0,
                                  floor_bytes=tenant_floor_bytes)
        if trace or retier_online:  # the daemon watches a live trace
            tiered.start_trace()
        # preload the hot set (the paper's offline-profiled module-init list)
        hot = [k for d in plan.decisions.values() for k in d.resident_units]
        moved = tiered.ensure(hot, source="preload") if hot else 0
        _synchronize(device)
        t2 = time.perf_counter()
        report.read_s, report.upload_s = t1 - t0, t2 - t1
        report.bytes_uploaded = report.bytes_read + moved
        prefetcher = (Prefetcher(tiered, batch_units=prefetch_batch_units, predictor=predictor)
                      if want_prefetch else None)
        daemon, bootstrap = None, None
        if retier_online:
            daemon = RetierDaemon(tiered, result.reach, prefetcher=prefetcher, interval_steps=retier_interval,
                                  interval_s=retier_interval_s, decay=retier_decay,
                                  compact_every=retier_compact_every, artifact_dir=artifact_dir)
            if fleet is not None:
                # join before any traffic: a controller with learned state
                # warm-bootstraps this replica here, synchronously; the report
                # leaves it out, as the reference's does
                t_f, n_events = time.perf_counter(), len(tiered.stats.events)
                fleet.register(replica_name or f"replica-{len(fleet.replicas)}", daemon)
                _synchronize(device)
                bootstrap = {"seconds": time.perf_counter() - t_f,
                             "bytes": sum(e.nbytes for e in tiered.stats.events[n_events:])}
        server = ColdStartServer(model, tree, report, tiered=tiered, store=store, prefetcher=prefetcher,
                                 retier_daemon=daemon, artifact_dir=artifact_dir, device=device,
                                 admission=admission, kv_page_size=kv_page_size, kv_pages=kv_pages, mesh=mesh)
        server.fleet_bootstrap = bootstrap
        if restore_from is not None:
            # warm restore: the donor's resident set faulted in again (LRU
            # order, through the arbiter's make-room path) and its predictor
            # armed before the server admits traffic; counted as upload
            t_r = time.perf_counter()
            try:
                snap = server_snapshot.load(restore_from) if isinstance(restore_from, str) else restore_from
                server.restore_report = server_snapshot.restore(tiered, snap, prefetcher=prefetcher,
                                                                artifact_dir=artifact_dir)
            except BaseException:
                server.close()  # the prefetcher's threads and the store go with it
                raise
            _synchronize(device)
            report.upload_s += time.perf_counter() - t_r
            report.bytes_uploaded += server.restore_report["moved_bytes"]
    else:
        raise ValueError(f"unknown mode {mode!r}; want before, after1 or after2")

    if compile_warm_set:
        t3 = time.perf_counter()
        for B, S, *S_max in warm_shapes:
            server.compiled_prefill(B, S)
            server.compiled_decode(B, S_max[0] if S_max else S)
        server.keep_entries()
        _synchronize(device)
        report.compile_s = time.perf_counter() - t3
    return server
