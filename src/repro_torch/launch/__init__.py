"""Training entry points of the port (``repro.launch`` counterpart)."""
