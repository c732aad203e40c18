"""Synthetic training data and the work-stealing loader of the port
(``repro.data`` counterpart)."""

from .loader import WorkStealingLoader
from .synthetic import SyntheticCorpus, make_batch, pack_documents

__all__ = ["SyntheticCorpus", "WorkStealingLoader", "make_batch", "pack_documents"]
