"""Checkpoint manager: atomic, async, keep-N, validated restore
(``repro.checkpoint.manager`` counterpart), and the repo-wide commit rule
for rewritten directories.

Layout (the reference's, so a directory written by either package restores
in the other)::

    <dir>/
      manifest.json            # {"latest": 300, "steps": [100, 200, 300]}
      step_00000300/
        params.bin  params.index.json
        opt_state.bin ...
        meta.json              # step, wall time, arch

  * a step directory becomes visible only by rename (commit point 1), and
    the manifest names it only after that (commit point 2), so a reader
    never sees a torn checkpoint and a crash mid-save leaves the previous
    manifest intact;
  * ``restore`` can validate every leaf's shape and dtype against an
    abstract tree before anything reaches a device;
  * async save: the host copy is taken on the calling thread, the disk
    write runs on one worker thread, and its error surfaces on the next
    ``wait()`` or ``save()``;
  * keep-N GC never deletes the newest committed step.

A rewritten directory is staged as ``<final>.partial`` and published by one
rename. A ``.partial`` that still exists was never renamed into place, so
deleting it can never touch a committed directory.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.checkpoint import tensorstore_lite as tsl
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat


def _host_snapshot(tree: Any) -> dict[str, torch.Tensor]:
    """Flatten a collection tree into host copies of its leaves (the
    synchronous part of a save): later in-place updates of the live
    tensors cannot reach the bytes being written."""
    return {p: v.detach().to("cpu", copy=True) for p, v in flatten_with_paths(tree)}


def commit_dir(tmp: str, final: str) -> None:
    """Publish the fully written directory ``tmp`` as ``final`` by rename.
    An existing ``final`` is removed first, so a crash between the removal
    and the rename leaves ``final`` absent (detectably missing, never torn);
    a caller whose source must survive that window keeps its own commit
    record (the checkpoint manifest) or writes to a new ``final`` (the
    re-tiered artifact goes beside its source)."""
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def orphaned_partials(root: str) -> list[str]:
    """Staging directories a crash left behind: every ``*.partial``
    directory directly under ``root`` (files with the suffix are not
    staging directories)."""
    try:
        names = sorted(os.listdir(root))
    except FileNotFoundError:
        return []
    return [os.path.join(root, n) for n in names
            if n.endswith(".partial") and os.path.isdir(os.path.join(root, n))]


def clean_partials(root: str) -> list[str]:
    """Remove every orphaned staging directory under ``root``; returns the
    paths removed. Run it at start-up, before any writer exists."""
    removed = []
    for p in orphaned_partials(root):
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    return removed


@dataclass
class RestoreResult:
    step: int
    collections: dict
    path: str


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- manifest -----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"latest": None, "steps": []}

    def _write_manifest(self, man: dict) -> None:
        tmp = self._manifest_path() + ".partial"
        with open(tmp, "w") as f:
            json.dump(man, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    def latest_step(self) -> Optional[int]:
        return self._read_manifest()["latest"]

    def all_steps(self) -> list[int]:
        return list(self._read_manifest()["steps"])

    # -- save ---------------------------------------------------------------
    def save(self, step: int, collections: dict, *, meta: Optional[dict] = None,
             blocking: Optional[bool] = None) -> None:
        """Copy to the host now; write now (blocking) or on the worker thread."""
        self.wait()  # one save in flight at a time
        host = {name: _host_snapshot(tree) for name, tree in collections.items()}
        blocking = (not self.async_save) if blocking is None else blocking
        if blocking:
            self._write(step, host, meta or {})
        else:
            self._thread = threading.Thread(target=self._write_guarded, args=(step, host, meta or {}),
                                            daemon=True)
            self._thread.start()

    def _write_guarded(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:  # surfaced on the next wait()/save()
            self._error = e

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, host: dict, meta: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".partial"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, arrays in host.items():
            tsl.write_bundle(os.path.join(tmp, name), arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time(), **meta}, f)
        commit_dir(tmp, final)  # commit point 1: the directory is visible
        man = self._read_manifest()
        steps = sorted(set(man["steps"]) | {step})
        self._write_manifest({"latest": max(steps), "steps": steps})  # commit point 2
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    def _gc(self) -> None:
        man = self._read_manifest()
        steps = man["steps"]
        if len(steps) <= self.keep_n:
            return
        drop, keep = steps[: -self.keep_n], steps[-self.keep_n:]
        self._write_manifest({"latest": man["latest"], "steps": keep})
        for s in drop:
            d = self._step_dir(s)
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, step: Optional[int] = None, *, abstract: Optional[dict] = None,
                mmap: bool = True) -> Optional[RestoreResult]:
        """Host tensors of every collection of ``step`` (default: the latest
        committed); None when nothing is committed (a fresh start).
        ``abstract`` ({collection: tree of shape/dtype stand-ins}) is checked
        leaf by leaf first."""
        man = self._read_manifest()
        if step is None:
            step = man["latest"]
        if step is None:
            return None
        if step not in man["steps"]:
            raise FileNotFoundError(f"step {step} not in manifest {man['steps']}")
        d = self._step_dir(step)
        collections = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".index.json"):
                cname = name[: -len(".index.json")]
                collections[cname] = tree_from_flat(tsl.read_bundle(os.path.join(d, cname), mmap=mmap))
        if abstract is not None:
            _validate(collections, abstract)
        return RestoreResult(step=step, collections=collections, path=d)


def _validate(collections: dict, abstract: dict) -> None:
    for cname, atree in abstract.items():
        if cname not in collections:
            raise ValueError(f"checkpoint missing collection {cname!r}")
        got = dict(flatten_with_paths(collections[cname]))
        for path, leaf in flatten_with_paths(atree):
            if path not in got:
                raise ValueError(f"{cname}: missing leaf {path}")
            g = got[path]
            if tuple(g.shape) != tuple(leaf.shape):
                raise ValueError(f"{cname}.{path}: shape {tuple(g.shape)} != expected {tuple(leaf.shape)}")
            if g.dtype != leaf.dtype:
                raise ValueError(f"{cname}.{path}: dtype {tsl.dtype_name(g.dtype)} != expected "
                                 f"{tsl.dtype_name(leaf.dtype)}")
