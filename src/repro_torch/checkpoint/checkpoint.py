"""Atomic, resumable checkpoints (port of ``repro/checkpoint/checkpoint.py``).

Layout, the reference's on disk: ``<dir>/step_<N:08d>/`` holding
  manifest.json — the step, the tree's structure, each leaf's path, shape and
                  dtype, and the caller's metadata;
  arrays-0.npz  — the leaves keyed by path in ``jax.tree_util.keystr`` form
                  (``"['params']['embed']"``, ``"['opt'].m['embed']"``), so the
                  two packages read each other's fp32 trees.

* Atomicity: a step is written to ``step_<N>.tmp-<nonce>`` and published by
  ``os.rename``; a crash mid-save never damages the latest step, and
  :func:`latest_step` ignores ``.tmp-`` directories.
* bf16 leaves: numpy has no bfloat16, so such a leaf is stored as its 16-bit
  payload in a two-byte void dtype (``|V2``, the bytes and npz descriptor
  the reference writes) with ``"bfloat16"`` as its manifest dtype, and
  viewed back on restore; an ``int16`` payload (what earlier versions of
  the port wrote) restores alike.
* Async: :class:`AsyncCheckpointer` copies every leaf to host memory before
  its writer thread starts (a tensor that training later updates in place
  never reaches the file) and writes in the background; ``wait()`` joins and
  raises the writer's error.

Trees are nested dicts, lists, tuples and NamedTuples of tensors, numpy
arrays or Python scalars; dict keys are walked in sorted order, as JAX
flattens them.  :func:`restore` places tensors on ``device`` (``cuda``
unless given); the reference's elastic ``shardings`` are not ported.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _treedef(tree) -> str:
    """The structure in the form of JAX's ``str(treedef)``, ``*`` a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        inner = ", ".join(_treedef(getattr(tree, f)) for f in tree._fields)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array stored for it, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _snapshot(leaf):
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf) if isinstance(leaf, np.ndarray) else leaf


def save(directory: str, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
    """Atomically write ``tree`` as step ``step``; returns its directory."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    arrays, leaves = {}, []
    for path, leaf in flat:
        a, dtype = _host(leaf)
        arrays[path] = a
        leaves.append({"path": path, "shape": list(a.shape), "dtype": dtype})
    manifest = {"step": int(step), "treedef": f"PyTreeDef({_treedef(tree)})",
                "leaves": leaves, "metadata": metadata or {}}
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    try:
        np.savez(os.path.join(tmp, "arrays-0.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _steps(directory: str) -> List[int]:
    return [int(n.split("_")[1]) for n in os.listdir(directory)
            if n.startswith("step_") and ".tmp-" not in n]


def latest_step(directory: str) -> Optional[int]:
    """The largest published step under ``directory`` (None if there is none)."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory)
             if os.path.exists(os.path.join(directory, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, stored: str, like, dev: torch.device):
    """A stored array (freshly read, so its memory is ours) as ``like``'s
    kind of leaf: a tensor of its dtype on ``dev`` (numpy and tensor leaves
    alike), or a Python scalar."""
    arr = np.ascontiguousarray(arr)
    if stored == "bfloat16":  # a |V2 or int16 payload
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif isinstance(like, np.ndarray):
        t = torch.from_numpy(arr.astype(like.dtype, copy=False))
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=dev, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return t.to(dev)
    return type(like)(t.item())


def restore(directory: str, like: Any, step: Optional[int] = None,
            device: DeviceLike = None):
    """Restore step ``step`` (the latest by default) into the structure of
    ``like``; returns ``(tree, step)``.  Tensor and numpy leaves come back as
    tensors of ``like``'s dtypes on ``device`` (``cuda`` unless given),
    Python scalars as scalars."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        stored = {leaf["path"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    out = []
    with np.load(os.path.join(d, "arrays-0.npz")) as z:
        files = set(z.files)
        for path, lk in _flatten(like):
            if path not in files:
                raise KeyError(f"checkpoint missing leaf {path}")
            arr = z[path]  # one leaf in host memory at a time
            want = tuple(lk.shape) if hasattr(lk, "shape") else ()
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch at {path}: ckpt {arr.shape} vs model {want}")
            out.append(_leaf(arr, stored.get(path, str(arr.dtype)), lk, dev))
    return _unflatten(like, iter(out)), step


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background thread;
    keep the newest ``keep`` steps.  ``records`` holds one dict a finished
    save: its step, the seconds of the snapshot (the caller's stall) and of
    the background write, and the bytes of its arrays file."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.records: List[dict] = []

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        flat = iter([_snapshot(leaf) for _, leaf in _flatten(tree)])  # snapshot now
        host_tree = _unflatten(tree, flat)
        snapshot_s = time.perf_counter() - t0

        def _write():
            try:
                t1 = time.perf_counter()
                path = save(self.directory, step, host_tree, metadata)
                self.records.append(dict(
                    step=step, snapshot_s=snapshot_s, write_s=time.perf_counter() - t1,
                    bytes=os.path.getsize(os.path.join(path, "arrays-0.npz"))))
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
