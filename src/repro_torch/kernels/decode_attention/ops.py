"""Decode attention entry points (port of
``repro/kernels/decode_attention/ops.py``): inference only, as in the
reference (decode never backprops)."""

from __future__ import annotations

from .kernel import decode_attention as _kernel


def decode_attention(q, k, v, pos, *, window: int = 0, bk: int = 512):
    """q: [B, H, hd]; k, v: [B, Hkv, S, hd]; pos scalar -> [B, H, hd]."""
    return _kernel(q, k, v, pos, window=window, bk=bk)


def ragged_decode_attention(q, k, v, lengths, *, schedule: str = "ws", n_programs: int = 8,
                            bk: int = 64, return_stats: bool = False):
    """Decode attention over ragged KV caches (per-sequence lengths).

    ``schedule="ws"`` dispatches one task per live (batch, head) through the
    fence-free work-stealing megakernel (:mod:`repro_torch.pallas_ws`) so
    long caches do not serialize one program; ``schedule="static"`` is the
    no-steal baseline.
    """
    from repro_torch.pallas_ws.ragged import ragged_decode_attention as _impl

    return _impl(q, k, v, lengths, schedule=schedule, n_programs=n_programs, bk=bk,
                 return_stats=return_stats)
