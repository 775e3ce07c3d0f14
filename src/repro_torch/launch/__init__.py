"""Command-line launchers (``repro.launch`` counterpart)."""
