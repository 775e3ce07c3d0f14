"""Checkpointing: the atomic, async, keep-N ``CheckpointManager`` over the
bf16-safe raw-binary tensor bundle (``tensorstore_lite``), and the rename
commit of rewritten directories."""

from repro_torch.checkpoint.manager import (
    CheckpointManager,
    RestoreResult,
    clean_partials,
    commit_dir,
    orphaned_partials,
)

__all__ = ["CheckpointManager", "RestoreResult", "commit_dir", "orphaned_partials", "clean_partials"]
