"""Model configuration for the port (the dense and MoE subset of
``repro/models/config.py``).

A frozen dataclass with the fields and derived properties the GQA decoder
reads, dense or with MoE FFNs.  Field names and defaults match the
reference, so a config prints and compares the same way in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # the port builds "dense" and "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    attn_kind: str = "gqa"
    window: int = 0                 # sliding-window size; 0 = full attention
    locals_per_global: int = 0

    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden
    first_k_dense: int = 0          # leading dense layers (counted only, as the reference)
    capacity_factor: float = 1.25
    # "dense" = capacity-dropping dispatch/combine einsums; "ws" = dropless
    # expert tiles through the work-stealing expert megakernel; "mesh-ws" is
    # the reference's cross-device dispatch, not ported (it raises).
    moe_dispatch: str = "dense"
    # backward evaluation of the ws dispatch; the port is forward only
    moe_grad_dispatch: str = "dense"

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    depth_scaled_residual: bool = False
    dtype: str = "float32"          # compute/param dtype
    pad_heads: bool = False

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; pad columns are masked."""
        return -(-self.vocab_size // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def eff_heads(self) -> Tuple[int, int]:
        """(n_heads, n_kv_heads) actually allocated (>= config when pad_heads)."""
        H, Hkv = self.n_heads, self.n_kv_heads
        if not self.pad_heads:
            return H, Hkv
        pad16 = lambda x: -(-x // 16) * 16  # noqa: E731
        if H == Hkv:
            return pad16(H), pad16(Hkv)
        if H % 16 == 0:
            return H, Hkv
        G = H // Hkv
        while (Hkv * G) % 16:
            G += 1
        return Hkv * G, Hkv

    @property
    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer window (0 = full attention)."""
        n = self.n_layers
        if self.locals_per_global > 0:
            k = self.locals_per_global
            return tuple(self.window if (i % (k + 1)) < k else 0 for i in range(n))
        return tuple(self.window for _ in range(n))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
