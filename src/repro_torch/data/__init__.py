"""Synthetic training data of the port (``repro.data`` counterpart)."""

from .synthetic import SyntheticCorpus, make_batch, pack_documents

__all__ = ["SyntheticCorpus", "make_batch", "pack_documents"]
