"""What the three standalone kernels share: their launch counts, the
device rule of their wrappers, and the ctypes call of their C entry points.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel for CUDA tensors; any other device, or CPU and CUDA tensors
mixed, raises.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of each kernel: a wrapper adds one where it launches its kernel,
# and nowhere else.
launches = {"flash_fwd": 0, "decode_attention": 0, "ssd_scan": 0}

DTYPES = (torch.float32, torch.bfloat16)
# dynamic shared memory one CTA may use on an H100 (227 KB)
SMEM_LIMIT = 232448
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def runs_plain(*tensors) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors on
    one device (the kernel); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda (plain version on cpu), not {dev}")
    return dev.type == "cpu"


def check_contiguous(name: str, *tensors) -> None:
    """The CUDA kernels index their tensors densely: raise on any other layout."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def check_smem(name: str, nbytes: int) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: this shape needs {nbytes} B of shared memory a CTA, more "
                         f"than the {SMEM_LIMIT} an H100 CTA may use")


def entry_point(lib: str, fn: str, argtypes):
    """The C function ``fn`` of ``csrc/<lib>.cu`` (built at first use)."""
    from .. import _build

    f = getattr(_build.load(lib), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = INT
    return f


def launch(name: str, fn, *args) -> None:
    """Call a kernel's C entry point, count the launch and raise on the CUDA
    error it returns (a refused launch never runs)."""
    err = fn(*args)
    launches[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
