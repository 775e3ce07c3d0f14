"""Checkpointing: the bf16-safe raw-binary tensor bundle (``tensorstore_lite``)
and the rename commit of rewritten directories (``manager``)."""

from repro_torch.checkpoint.manager import clean_partials, commit_dir, orphaned_partials

__all__ = ["commit_dir", "orphaned_partials", "clean_partials"]
