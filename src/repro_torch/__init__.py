"""PyTorch + CUDA port of the fence-free work-stealing serving stack.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``pallas_ws``, ``models``, ``serving``, ``core``, ``wstrace``) so each
port sits beside its counterpart.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro``.

The work-stealing attention megakernel is hand-written CUDA C++ for Hopper
(``csrc/ws_attention.cu``), built with ``nvcc`` at first use
(:mod:`repro_torch._build`).  Each kernel wrapper launches it for CUDA
tensors and runs its plain PyTorch version for CPU tensors.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
