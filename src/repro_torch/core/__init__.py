"""repro_torch.core — the paper's contribution: fence-free work-stealing with
multiplicity (the port's copy of ``repro.core``).

The shared-memory algorithms (WS-MULT, WS-WMULT, the bounded variants, the
MaxRegister / RangeMaxRegister objects they reduce to, and the THE Cilk /
Chase-Lev / idempotent baselines), runnable on real threads
(:class:`ThreadBackend`) or under the deterministic interleaving simulator
(:class:`SimBackend`, :func:`.simulator.run_program`).  The device form of
the same queues is :mod:`repro_torch.pallas_ws`; its host shim is
registered here as ``"pallas-ws"``.
"""

from .backend import (
    BOTTOM,
    EMPTY,
    UNINIT,
    SimBackend,
    SimController,
    ThreadBackend,
    set_sim_pid,
)
from .baselines import ChaseLev, IdempotentDeque, IdempotentFIFO, IdempotentLIFO, TheCilk
from .bounded import BWSMult, BWSWMult, ExactWS
from .max_register import AtomicMaxRegister, RangeMaxRegister, TreeMaxRegister
from .storage import GrowableStore, InfiniteStore, LinkedStore, make_store
from .ws_mult import WSMult
from .ws_wmult import WSWMult


def _pallas_ws_host(backend=None, **kw):
    """Lazy factory for the device-layout shim (the pure algorithms load
    without the scheduler's modules)."""
    from repro_torch.pallas_ws.host import PallasWSHost

    return PallasWSHost(backend=backend, **kw)


def _moe_ws_host(backend=None, **kw):
    """Lazy factory for the MoE expert-dispatch queue (the pallas-ws slot
    arithmetic with expert-tile payloads)."""
    from repro_torch.moe_ws.dispatch import MoEDispatchHost

    return MoEDispatchHost(backend=backend, **kw)


# Registry of queue factories; each takes (backend=None, **kw).
ALGORITHMS = {
    "ws-mult": WSMult,
    "ws-wmult": WSWMult,
    "pallas-ws": _pallas_ws_host,
    "moe-ws": _moe_ws_host,
    "b-ws-mult": BWSMult,
    "b-ws-wmult": BWSWMult,
    "exact-ws": ExactWS,
    "chase-lev": ChaseLev,
    "the-cilk": TheCilk,
    "idempotent-fifo": IdempotentFIFO,
    "idempotent-lifo": IdempotentLIFO,
    "idempotent-deque": IdempotentDeque,
}

# Each process extracts a task at most once (the paper's multiplicity
# family; "pallas-ws" and "moe-ws" run the WS-WMULT protocol on the device
# layout, so they give the same guarantees).
MULTIPLICITY_FAMILY = (
    "ws-mult", "ws-wmult", "b-ws-mult", "b-ws-wmult", "pallas-ws", "moe-ws"
)
# Exactly once overall.
EXACT_FAMILY = ("exact-ws", "chase-lev", "the-cilk")
# At least once, with unbounded duplicates (the idempotent relaxation).
IDEMPOTENT_FAMILY = ("idempotent-fifo", "idempotent-lifo", "idempotent-deque")

__all__ = [
    "ALGORITHMS",
    "MULTIPLICITY_FAMILY",
    "EXACT_FAMILY",
    "IDEMPOTENT_FAMILY",
    "AtomicMaxRegister",
    "BOTTOM",
    "BWSMult",
    "BWSWMult",
    "ChaseLev",
    "EMPTY",
    "ExactWS",
    "GrowableStore",
    "IdempotentDeque",
    "IdempotentFIFO",
    "IdempotentLIFO",
    "InfiniteStore",
    "LinkedStore",
    "RangeMaxRegister",
    "SimBackend",
    "SimController",
    "TheCilk",
    "ThreadBackend",
    "TreeMaxRegister",
    "UNINIT",
    "WSMult",
    "WSWMult",
    "make_store",
    "set_sim_pid",
]
