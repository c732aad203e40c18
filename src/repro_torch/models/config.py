"""Model configuration for the port (``repro/models/config.py``'s
``ModelConfig`` and ``ShapeConfig``).

A frozen dataclass with the fields and derived properties the decoders
read: GQA or MLA attention, dense or MoE FFNs, the Mamba-2 (SSD) layer of
the ``ssm`` family and the ``hybrid`` family's shared attention blocks, the
encoder of the ``encdec`` family (whisper) and the patch prefix of the
``vlm`` family (pixtral), and the analytic ``param_count`` the trainer's
policy reads.  Field names and defaults
match the reference, so a config prints and compares the same way in both
packages.  :class:`ShapeConfig` is one input-shape cell (sequence length
and batch rows), as the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    attn_kind: str = "gqa"          # gqa | mla
    window: int = 0                 # sliding-window size; 0 = full attention
    locals_per_global: int = 0

    # -- MLA (deepseek-v2) ----------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0             # defaults to head_dim

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
    # backward evaluation of the ws dispatch's custom VJP: "dense" = the
    # closed-form transpose over the routed pairs; "ws" = its per-row tiles
    # through the expert backward megakernel
    moe_grad_dispatch: str = "dense"

    # -- SSM (mamba2 / zamba2) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # -- hybrid (zamba2): shared attention block applied every k ssm layers --
    hybrid_attn_every: int = 0

    # -- encoder-decoder (whisper) ---------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_seq_len: int = 1500         # whisper 30 s at 50 Hz after the conv stub

    # -- modality frontend stub ------------------------------------------------
    # "none" | "patch" (vlm: precomputed patch embeddings prepended)
    #        | "frames" (audio: precomputed frame embeddings into the encoder)
    frontend: str = "none"
    n_patches: int = 0              # vlm: patches an image, before the text

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
    def v_hd(self) -> int:
        return self.v_head_dim if self.v_head_dim else self.hd

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

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

    def param_count(self) -> int:
        """Analytic parameter count, embedding and LM head included (the
        reference's terms: attention decoders, dense or MoE, the vlm
        backbone among them; the encdec family's encoder layers and its
        decoder layers with their cross-attention; the ssm family; the
        hybrid's two shared attention + MLP blocks counted once each)."""
        d, V = self.d_model, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        if self.attn_kind == "mla":
            hd, rhd, H = self.hd, self.rope_head_dim, self.n_heads
            attn = (d * self.q_lora_rank + self.q_lora_rank * H * (hd + rhd)
                    if self.q_lora_rank else d * H * (hd + rhd))
            attn += d * (self.kv_lora_rank + rhd)
            attn += self.kv_lora_rank * H * (hd + self.v_hd)
            attn += H * self.v_hd * d
        else:
            attn = 2 * d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd

        def dense_ffn(dff: int) -> int:
            return 3 * d * dff  # SwiGLU

        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + dense_ffn(self.d_ff))
            return total + enc + self.n_dec_layers * (2 * attn + dense_ffn(self.d_ff))
        if self.is_ssm:
            di, ds, H = self.d_inner, self.ssm_state, self.ssm_heads
            ssm_block = (d * (2 * di + 2 * ds + H)      # in-projections x, z, B, C, dt
                         + di * self.ssm_conv_width    # conv
                         + H + H + di                  # A, D, dt_bias-ish
                         + di * d)                     # out-projection
            total += self.n_layers * ssm_block
            if self.family == "hybrid":
                total += 2 * (attn + dense_ffn(self.d_ff))
            return total
        if self.is_moe:
            moe = d * self.n_experts + (self.n_experts + self.n_shared_experts) * dense_ffn(
                self.moe_d_ff)
            dense_layers = self.first_k_dense
            return (total + self.n_layers * attn
                    + dense_layers * dense_ffn(self.d_ff if self.d_ff else self.moe_d_ff * 4)
                    + (self.n_layers - dense_layers) * moe)
        return total + self.n_layers * (attn + dense_ffn(self.d_ff))


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k | custom
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
