"""Command-line tools of the port (``tools/`` of the repository root)."""
