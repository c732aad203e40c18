"""Hand-written CUDA kernels for the model stack's hot spots (port of
``repro.kernels``): fused attention forward (``csrc/flash_fwd.cu``), the
Mamba-2 SSD scan (``csrc/ssd_scan.cu``) and split-K decode attention
(``csrc/decode_attention.cu``).  Each has a dense oracle in ``ref.py`` and a
plain PyTorch version beside its wrapper, which the wrapper runs for CPU
tensors; CUDA tensors launch the kernel.  Like the reference's, no model of
the package calls them.
"""

from ._launch import launches, reset_launches
from .decode_attention.ops import decode_attention
from .flash_attention.ops import flash_attention
from .ssd_scan.ops import ssd_scan

__all__ = ["decode_attention", "flash_attention", "launches", "reset_launches", "ssd_scan"]
