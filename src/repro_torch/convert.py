"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the reference's parameter tree with every leaf
already turned into a numpy array (the caller does ``np.asarray``; this
module imports no JAX) and returns the same nested dict of torch tensors,
layouts unchanged, so both packages compute the same function: GQA and MLA
layers (``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wdq``/``wuq``, ``wo``), routed
and shared experts, Mamba-2 layers (``mamba``, stacked over L, its fp32
``A_log``, ``D`` and ``dt_bias`` beside weights of the model's type), the
hybrid's ``shared_attn`` (stacked over its 2 sets) and the encdec model's
``enc_layers``, ``enc_norm`` and decoder ``cross`` / ``cross_norm`` alike,
since the port keeps the reference's parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._device import DeviceLike, resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev)

    return walk(tree)
