"""The checkpoint layer's commit rule (``repro.checkpoint.manager`` counterpart:
``commit_dir``, ``orphaned_partials`` and ``clean_partials``; the
``CheckpointManager`` class is not ported yet).

A rewritten directory is staged as ``<final>.partial`` and published by one
rename, so a reader never sees a half-written ``<final>``. A ``.partial``
that still exists was never renamed into place, so deleting it can never
touch a committed directory.
"""

from __future__ import annotations

import os
import shutil


def commit_dir(tmp: str, final: str) -> None:
    """Publish the fully written directory ``tmp`` as ``final`` by rename.
    An existing ``final`` is removed first, so a crash between the removal
    and the rename leaves ``final`` absent (detectably missing, never torn);
    a caller whose source must survive that window writes to a new
    ``final`` (the re-tiered artifact goes beside its source)."""
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
