"""Host-side fence-free work-stealing queues (``repro.core`` counterpart)."""

from .backend import BOTTOM, EMPTY, UNINIT, ThreadBackend
from .storage import InfiniteStore, LinkedStore, make_store
from .ws_wmult import WSWMult

__all__ = ["BOTTOM", "EMPTY", "UNINIT", "InfiniteStore", "LinkedStore",
           "ThreadBackend", "WSWMult", "make_store"]
