"""PyTorch + CUDA port of the fence-free work-stealing serving and training
stack.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``pallas_ws``, ``moe_ws``, ``models``, ``serving``, ``optim``,
``data``, ``launch``, ``core``, ``wstrace``) so each port sits beside its
counterpart.  It imports ``torch`` and numpy only — never ``jax`` and
nothing of ``repro``.

The work-stealing megakernels are hand-written CUDA C++ for Hopper around
one fence-free scheduler (``csrc/ws_sched.cuh``, dense or shared-pool
queues): attention tiles (``csrc/ws_attention.cu``), MoE expert tiles
(``csrc/ws_expert.cu``), their transpose for the backward
(``csrc/ws_expert_grad.cu``) and the one-launch unified engine step
(``csrc/ws_unified.cu``), built with ``nvcc`` at first use
(:mod:`repro_torch._build`).  Each kernel
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
