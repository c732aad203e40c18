"""Meshes of ranks on ``torch.distributed`` (port of ``repro/launch/mesh.py``).

In the reference a mesh is a grid of accelerator devices and an
``axis_name`` is bound by ``shard_map``.  Here the "devices" of a mesh are
the ranks of the initialised default process group, one process each.
Several ranks may share one card: on a one-GPU machine every rank runs on
``cuda:0`` and the card time-slices their kernels, so a mesh there shows
the protocol and its traffic, not the speed of a mesh of cards.  The ranks
talk over gloo: NCCL refuses two ranks on one GPU, and gloo reduces CUDA
tensors (``all_reduce``, ``broadcast``) but sends only CPU ones, so a ring
hop stages through the host (:func:`repro_torch.mesh_ws.ring_allgather`).

An axis resolves to a process group in one place, :func:`resolve_axis`: an
:class:`Axis` (from :meth:`Mesh.axis`) is used as it is; a plain ``str``
names the default group (every rank), which is the one axis of
:func:`make_expert_mesh`.  Without a process group a ``str`` axis raises:
nothing quietly runs one rank where a mesh was asked for.

:func:`run_ranks` spawns the ranks of a mesh on this host (gloo, a file
init in a temporary directory) and returns each rank's result.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group (``None`` on a
    one-rank axis, which needs no collective), its size and this rank's
    index along it; ``lanes``, more groups of the same ranks, over which a
    large collective may be split to run its parts at once (gloo moves one
    group's bytes on its own connections and threads)."""

    name: str
    group: Any
    size: int
    index: int
    lanes: Tuple[Any, ...] = ()

    def global_rank(self, index: int) -> int:
        """The default-group rank of the axis member at ``index``."""
        if self.group is None:
            return dist.get_rank() if dist.is_initialized() else 0
        return dist.get_global_rank(self.group, index)


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes (``mesh.shape[name]``, as a JAX mesh has them)
    and, for a mesh that runs, this rank's :class:`Axis` of each name."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    axes: Dict[str, Axis] = field(default_factory=dict)

    def axis(self, name: str) -> Axis:
        if name not in self.axes:
            raise ValueError(f"mesh {self.shape} has no process group for axis {name!r} "
                             "(a mesh that only describes its shape runs nothing)")
        return self.axes[name]


def resolve_axis(axis) -> Axis:
    """The :class:`Axis` an ``axis_name`` names: an :class:`Axis` as it is, a
    ``str`` the default process group (every rank).  Raises without an
    initialised process group."""
    if isinstance(axis, Axis):
        return axis
    if not isinstance(axis, str):
        raise TypeError(f"axis_name must be a str or an Axis: {axis!r}")
    if not dist.is_initialized():
        raise RuntimeError(f"axis_name {axis!r} needs an initialised process group "
                           "(torch.distributed.init_process_group); none is")
    return Axis(axis, dist.group.WORLD, dist.get_world_size(), dist.get_rank())


def _world() -> Tuple[int, int]:
    """``(size, rank)`` of the default process group, ``(1, 0)`` without one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, described only: 16 x 16
    ("data", "model") = 256 chips, or 2 x 16 x 16 ("pod", "data", "model").
    No process group of that size is made here, so the mesh runs nothing
    (:meth:`Mesh.axis` raises)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, dict(zip(axes, shape)))


# process groups an axis of more than one rank gets (its own and LANES - 1
# more of the same ranks): gloo moves one group's bytes on one set of
# connections, so a large collective goes in LANES parts at once.  Chosen
# with gloo_lanes_probe.py on an NVIDIA H100 80GB HBM3 (700 W) machine:
# between 2 ranks on the card, bf16 all-gathers of a 512 MiB tensor went
# from 1.24 GB/s on 1 group to 2.45 on 4 and 2.70 on 8, reduce-scatters
# from 1.01 to 2.72 and 2.83 (fp32: 8 groups slower than 4).
LANES = 4


def make_host_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` over the ranks of the default process group, laid
    out row-major as the reference's devices are.  Each axis gets a process
    group of the ranks that differ along it alone and, for an axis of more
    than one rank, ``LANES - 1`` more groups of the same ranks
    (:attr:`Axis.lanes`); every rank makes every group, in one order, as
    ``new_group`` requires.  ``prod(shape)`` must be the world size (1
    without a process group)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world, rank = _world()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks; the process "
                         f"group has {world}")
    coords = torch.arange(n).reshape(shape)
    me = [int(i) for i in (coords == rank).nonzero()[0]] if n > 1 else [0] * len(shape)
    built = {}
    for a, name in enumerate(axes):
        if not dist.is_initialized():
            built[name] = Axis(name, None, shape[a], 0)
            continue
        # every line of ranks along axis a, each made into a group by every rank
        lines = coords.movedim(a, -1).reshape(-1, shape[a]).tolist()
        mine = []
        for _ in range(LANES if shape[a] > 1 else 1):
            for ranks in lines:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine.append(g)
        built[name] = Axis(name, mine[0], shape[a], me[a], tuple(mine[1:]))
    return Mesh(axes, dict(zip(axes, shape)), built)


def make_expert_mesh(n_experts: int, n_devices: Optional[int] = None) -> Mesh:
    """1-D ``("model",)`` mesh for expert-parallel dispatch
    (``moe_dispatch="mesh-ws"``) over the ranks of the default process
    group.  Its size is the largest divisor of ``n_experts`` that the ranks
    allow, so the expert partition is even; pass ``n_devices`` to pin it.
    Raises, as the reference does, when ``n_devices`` is more than the ranks
    available or does not divide ``n_experts``, and also when a mesh of
    more than 1 is not the whole group (a group of other ranks would need
    every rank to make it).  With no process group the mesh is 1 device: the
    mesh_ws code path with no remote victims and no collective.  Several
    ranks may share one card (see the module docstring)."""
    avail, rank = _world()
    if n_devices is None:
        n_devices = max(d for d in range(1, min(avail, n_experts) + 1) if n_experts % d == 0)
    if n_devices < 1:
        raise ValueError(f"mesh size must be >= 1, got {n_devices}")
    if n_devices > avail:
        raise ValueError(f"mesh size {n_devices} > {avail} available devices (ranks of the "
                         "default process group)")
    if n_experts % n_devices:
        raise ValueError(f"mesh size {n_devices} does not divide n_experts={n_experts}")
    if n_devices == 1:
        return Mesh(("model",), {"model": 1}, {"model": Axis("model", None, 1, 0)})
    if n_devices != avail:
        raise ValueError(f"mesh size {n_devices} is not the process group's {avail} ranks")
    return Mesh(("model",), {"model": n_devices},
                {"model": Axis("model", dist.group.WORLD, n_devices, rank)})


# ---------------------------------------------------------------------------
# spawning the ranks of a mesh on this host


def _rank_main(rank: int, n_ranks: int, init_file: str, device: str, fn, args, results):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: device 'cuda' asked for and "
                                   "torch.cuda.is_available() is False")
            torch.cuda.set_device(0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=n_ranks, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n_ranks: int, *args, device=None,
              timeout: float = 600.0) -> List[Any]:
    """Spawn ``n_ranks`` processes, each a rank of one gloo process group
    (file init in a fresh temporary directory), call ``fn(rank, *args)`` in
    each and return the results in rank order.  ``fn`` and ``args`` are
    pickled (``fn`` by import path) and each result must be picklable
    without a device (numpy, not a CUDA tensor).  ``device`` is resolved
    as every entry point's (``None`` is ``"cuda"``, which raises here
    without a GPU): on ``cuda`` every rank is set on ``cuda:0`` and raises
    if it finds no GPU; ``"cpu"`` must be asked for.  A
    rank that raises, or a run past ``timeout`` seconds, raises here with
    the rank's traceback; every process is stopped before this returns."""
    from repro_torch._device import resolve_device

    device = resolve_device(device).type
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="mesh_init_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_ranks, os.path.join(tmp, "init"), device, fn, args,
                                   results), daemon=True)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            # drain the queue before joining: a writer blocks until it is read
            deadline = time.monotonic() + timeout
            while len(got) < n_ranks:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None}
                    if dead:
                        raise RuntimeError(f"run_ranks: ranks {dead} (rank: exit code) "
                                           "exited without a result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"run_ranks: no result within {timeout} s from "
                                           f"ranks {sorted(set(range(n_ranks)) - set(got))}"
                                           ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
    return [got[r] for r in range(n_ranks)]
