"""The port stands alone: it imports neither JAX nor the JAX package (nor
``ml_dtypes``, which the machine with the card lacks), runs on CUDA unless
told otherwise, and never falls back to the CPU by itself.  The
kernel checks at the bottom need a CUDA card and skip without one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module(path):
    parts = path.relative_to(PORT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module(p) for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path}: imports {n}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import runpy; runpy.run_path(sys.argv[1], run_name='not_main')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


TRACE_AND_CHAOS = ("repro_torch.wstrace.ring", "repro_torch.wstrace.trace",
                   "repro_torch.wstrace.perfetto", "repro_torch.chaos.plan",
                   "repro_torch.chaos.inject", "repro_torch.chaos.checker",
                   "repro_torch.chaos.serving", "repro_torch.checkpoint.checkpoint",
                   "repro_torch.serving.engine", "repro_torch.models.ssm",
                   "repro_torch.launch.train", "repro_torch.sched.accumulate",
                   "repro_torch.sched.simulator", "repro_torch.data.loader",
                   "repro_torch.optim.compress", "repro_torch.configs.whisper_base",
                   "repro_torch.configs.pixtral_12b", "repro_torch.launch.serve",
                   "repro_torch.core", "repro_torch.core.backend", "repro_torch.core.storage",
                   "repro_torch.core.max_register", "repro_torch.core.ws_mult",
                   "repro_torch.core.bounded", "repro_torch.core.baselines",
                   "repro_torch.core.simulator", "repro_torch.pallas_ws.host",
                   "repro_torch.moe_ws.dispatch", "repro_torch.models.attention")


@pytest.mark.parametrize("module", TRACE_AND_CHAOS)
def test_trace_and_chaos_modules_pull_in_no_jax(module):
    """The ported trace, chaos, checkpoint, serving, SSM, training,
    scheduler, loader, compression and config modules, the serve entry
    point, the shared-memory algorithms of ``repro_torch.core``, the host
    shims and the attention module with its banded path (the reference's trace,
    chaos, checkpoint and simulator modules are numpy-only too, but live in
    ``repro``) load neither jax, ``ml_dtypes`` nor any ``repro`` module,
    even where all are installed; nor does chip_smoke.py."""
    assert module in MODULES
    code = (
        "import sys, importlib, runpy\n"
        f"importlib.import_module({module!r})\n"
        "runpy.run_path(sys.argv[1], run_name='not_main')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


def test_port_configs_cover_every_reference_arch():
    """``ARCH_MODULES`` holds exactly the reference's ``ARCH_IDS``."""
    pytest.importorskip("jax")
    from repro.configs import ARCH_IDS
    from repro_torch.configs import ARCH_MODULES

    assert sorted(ARCH_MODULES) == sorted(ARCH_IDS)


def test_param_count_matches_the_reference_for_every_arch():
    """``param_count`` of every arch's full and smoke config equals the
    reference's (encdec counts its encoder and cross-attention, vlm its
    backbone)."""
    pytest.importorskip("jax")
    from repro.configs import ARCH_IDS
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert get_config(arch, smoke).param_count() == \
                j_get_config(arch, smoke).param_count(), (arch, smoke)


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs.llama3_2_3b import SMOKE
    from repro_torch.convert import params_from_jax
    from repro_torch.models import init_caches, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(SMOKE)
    with pytest.raises(RuntimeError, match="cuda"):
        init_caches(SMOKE, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    assert init_params(SMOKE, device="cpu")["embed"].device.type == "cpu"


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    from repro_torch.pallas_ws import emit_decode_tasks, launches, make_queue_state, run_ws_schedule

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 2, 1, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 1, 16, 8)).astype(np.float32))
    before = launches["ws_attention"]
    res = run_ws_schedule(make_queue_state(emit_decode_tasks([16, 3], 2, 8), 2), q, k, k,
                          causal=False, bq=1, bk=8)
    assert launches["ws_attention"] == before
    assert (res.mult == 1).all() and res.mode == "free"


@pytest.mark.parametrize("kw", [dict(steal_run_cap=2), dict(steal_run_cap=2, trace=True),
                                dict(steal_run_cap=4, fault_plan="FaultPlan")])
def test_unported_knobs_raise(kw):
    """Half-run steals (once refused here as not ported) now hold the port's
    lockstep decode launch to the reference's, plain, traced and under a
    fault plan: integer arrays and event rings bit-equal, ``out`` within
    1e-5 (fp32 sums in another order).  The reference needs JAX; where it
    is not installed the cases skip."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.chaos import FaultPlan as JFaultPlan
    from repro.pallas_ws import emit_decode_tasks as j_emit
    from repro.pallas_ws import make_queue_state as j_state
    from repro.pallas_ws import run_ws_schedule as j_run
    from repro_torch.chaos import FaultPlan
    from repro_torch.pallas_ws import emit_decode_tasks, make_queue_state, run_ws_schedule

    jkw = dict(kw)
    if kw.get("fault_plan") == "FaultPlan":
        kw = dict(kw, fault_plan=FaultPlan(seed=1, stalls=(1,)))
        jkw = dict(jkw, fault_plan=JFaultPlan(seed=1, stalls=(1,)))
    lengths, H, P = [40, 8, 0, 24, 64], 2, 4   # one long row: the thieves' victim
    rng = np.random.default_rng(7)
    q = rng.standard_normal((5, H, 1, 8)).astype(np.float32)
    k = rng.standard_normal((5, 1, 64, 8)).astype(np.float32)
    v = rng.standard_normal((5, 1, 64, 8)).astype(np.float32)
    rt = run_ws_schedule(make_queue_state(emit_decode_tasks(lengths, H, 8), P),
                         torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         causal=False, bq=1, bk=8, mode="lockstep", **kw)
    rj = j_run(j_state(j_emit(lengths, H, 8), P), jnp.asarray(q), jnp.asarray(k),
               jnp.asarray(v), causal=False, bq=1, bk=8, **jkw)
    names = ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
             "scanned", "mult") + (("events", "ev_cursor") if kw.get("trace") else ())
    for n in names:
        np.testing.assert_array_equal(getattr(rt, n).numpy(), np.asarray(getattr(rj, n)),
                                      err_msg=n)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=1e-5)


def test_kernel_wrapper_marshals_every_argument(monkeypatch):
    """The CUDA launch cannot run here, so drive the wrapper's argument
    marshalling against a stand-in for the C entry point that converts every
    argument through its declared ctypes type and counts the launch."""
    import ctypes
    import types

    from repro_torch import _build
    from repro_torch.pallas_ws import emit_decode_tasks, kernel, make_queue_state

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int
        status = 0

        def __call__(self, *args):
            assert len(args) == len(self.argtypes)
            for t, a in zip(self.argtypes, args):
                t.from_param(a)
            return self.status

    entry = EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_attention_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    state = make_queue_state(emit_decode_tasks([16, 3], 2, 8), 2)
    q = torch.zeros((2, 2, 1, 8))
    k = torch.zeros((2, 16, 1, 8)).permute(0, 2, 1, 3)  # a strided cache view
    arrs = {n: torch.as_tensor(getattr(state, n)) for n in
            ("tasks", "tail", "head", "local_head", "taken", "remaining")}
    for n in ("clock", "work", "steals", "scanned"):
        arrs[n] = torch.zeros(2, dtype=torch.int32)
    arrs["mult"] = torch.zeros((2, state.n_tasks), dtype=torch.int32)
    out = torch.zeros((2, 2, 1, 8))
    kw = dict(mode="free", rounds=0, steal=True, policy="cost", compress=False,
              causal=False, bq=1, bk=8, scale=8 ** -0.5, g=2, n_tasks=state.n_tasks)
    before = kernel.launches["ws_attention"]
    kernel._launch_cuda(arrs, q, k, k, out, **kw)
    assert kernel.launches["ws_attention"] == before + 1
    entry.status = 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kernel._launch_cuda(arrs, q, k, k, out, **kw)


def test_expert_kernel_wrapper_marshals_every_argument(monkeypatch):
    """The expert counterpart: drive ``ws_expert_launch``'s ctypes
    marshalling against a stand-in entry point that converts every argument
    through its declared type, and count the launch."""
    import ctypes
    import types

    from repro_torch import _build
    from repro_torch.moe_ws import expert_kernel, route_to_tasks

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int
        status = 0

        def __call__(self, *args):
            assert len(args) == len(self.argtypes) == 39
            for t, a in zip(self.argtypes, args):
                t.from_param(a)
            return self.status

    entry = EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_expert_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    from repro_torch.pallas_ws import make_queue_state

    tasks, routed = route_to_tasks(np.array([[0, 1], [1, 2], [2, 0]]),
                                   np.full((3, 2), 0.5, np.float32), 4, bt=8)
    state = make_queue_state(tasks, 2, n_queues=4, partition="owner")
    arrs = {n: torch.as_tensor(getattr(state, n)) for n in
            ("tasks", "tail", "head", "local_head", "taken", "remaining")}
    for n in ("clock", "work", "steals", "scanned"):
        arrs[n] = torch.zeros(2, dtype=torch.int32)
    arrs["mult"] = torch.zeros((2, state.n_tasks), dtype=torch.int32)
    x = torch.zeros((3, 16))
    tok = torch.from_numpy(routed.tok_idx)
    wg = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    wd = torch.zeros((4, 8, 16), dtype=torch.bfloat16)
    out = torch.zeros((routed.n_rows, 16))
    kw = dict(mode="free", rounds=0, steal=True, policy="cost", compress=False, bt=8,
              n_tasks=state.n_tasks)
    before = expert_kernel.launches["ws_expert"]
    expert_kernel._launch_cuda(arrs, x, tok, wg, wg, wd, out, **kw)
    assert expert_kernel.launches["ws_expert"] == before + 1
    entry.status = 2  # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        expert_kernel._launch_cuda(arrs, x, tok, wg, wg, wd, out, **kw)


def test_expert_grad_kernel_wrapper_marshals_every_argument(monkeypatch):
    """The backward counterpart, on the shared-pool layout: drive
    ``ws_expert_grad_launch``'s ctypes marshalling (``pool_off`` a real
    pointer here, null on the dense layout) against a stand-in entry point
    that converts every argument through its declared type, and count the
    launch."""
    import ctypes
    import types

    from repro_torch import _build
    from repro_torch.moe_ws import expert_kernel, grad_out_width, route_to_tasks_pool
    from repro_torch.pallas_ws import make_pool_queue_state

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int
        status = 0
        pool_off = None

        def __call__(self, *args):
            assert len(args) == len(self.argtypes) == 41
            for t, a in zip(self.argtypes, args):
                t.from_param(a)
            self.pool_off = args[3]
            return self.status

    entry = EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_expert_grad_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    records, tail, pool_off, routed = route_to_tasks_pool(
        np.array([[0, 1], [1, 2], [2, 2]]), np.full((3, 2), 0.5, np.float32), 4, bt=8)
    state = make_pool_queue_state(records, tail, pool_off, routed.loads, 2,
                                  n_tasks=records.shape[0])
    arrs = {n: torch.as_tensor(getattr(state, n)) for n in
            ("tasks", "pool_off", "tail", "head", "local_head", "taken", "remaining")}
    for n in ("clock", "work", "steals", "scanned"):
        arrs[n] = torch.zeros(2, dtype=torch.int32)
    arrs["mult"] = torch.zeros((2, state.n_tasks), dtype=torch.int32)
    assert expert_kernel.queue_dims(arrs) == (4, records.shape[0], 2)
    x = torch.zeros((3, 16))
    tok = torch.from_numpy(routed.tok_idx)
    gates = torch.from_numpy(routed.gates)
    wg = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    wd = torch.zeros((4, 8, 16), dtype=torch.bfloat16)
    out = torch.zeros((routed.n_rows, grad_out_width(16, 8)))
    kw = dict(mode="free", rounds=0, steal=True, policy="cost", compress=False, bt=8,
              n_tasks=state.n_tasks)
    before = expert_kernel.launches["ws_expert_grad"]
    expert_kernel._launch_grad_cuda(arrs, x, x, tok, gates, wg, wg, wd, out, **kw)
    assert expert_kernel.launches["ws_expert_grad"] == before + 1
    assert entry.pool_off == arrs["pool_off"].data_ptr()
    entry.status = 2  # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        expert_kernel._launch_grad_cuda(arrs, x, x, tok, gates, wg, wg, wd, out, **kw)


def test_build_key_covers_included_headers(tmp_path):
    """Editing the shared scheduler header changes the cached library's key
    of every kernel that includes it; editing one kernel changes its own.
    dtype_io.cuh (NEG_INF, to_f) belongs to every kernel, attn_mma.cuh to
    ws_attention, flash_fwd, decode_attention (its cp.async helpers) and
    the expert kernels (through ws_expert_mma.cuh, their tiles), and
    ws_attn_body.cuh (the CUDA-core attention bodies) to ws_attention and
    ws_unified."""
    import shutil

    from repro_torch import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    keys = {n: _build.source_key(n, csrc) for n in _build.KERNELS}
    assert keys == {n: _build.source_key(n) for n in _build.KERNELS}
    with open(csrc / "ws_sched.cuh", "a") as fh:
        fh.write("// edited\n")
    edited = {n: _build.source_key(n, csrc) for n in _build.KERNELS}
    # the megakernels include the scheduler; the standalone kernels do not
    assert all(edited[n] != keys[n] for n in _build.WS_KERNELS)
    assert all(edited[n] == keys[n] for n in _build.KERNELS if n not in _build.WS_KERNELS)
    assert set(_build.KERNELS) - set(_build.WS_KERNELS) == {"flash_fwd", "decode_attention",
                                                           "ssd_scan"}
    with open(csrc / "dtype_io.cuh", "a") as fh:   # every kernel's NEG_INF
        fh.write("// edited\n")
    again = {n: _build.source_key(n, csrc) for n in _build.KERNELS}
    assert all(again[n] != edited[n] for n in _build.KERNELS)
    # the tensor-core blocks and cp.async helpers: the attention, expert and
    # SSD scan kernels built on them, and not the unified step (whose build
    # must not move)
    with open(csrc / "attn_mma.cuh", "a") as fh:
        fh.write("// edited\n")
    third = {n: _build.source_key(n, csrc) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if third[n] != again[n]} == {
        "ws_attention", "flash_fwd", "decode_attention", "ws_expert", "ws_expert_grad",
        "ssd_scan"}
    with open(csrc / "ws_expert_mma.cuh", "a") as fh:
        fh.write("// edited\n")
    fourth = {n: _build.source_key(n, csrc) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if fourth[n] != third[n]} == {"ws_expert", "ws_expert_grad"}
    with open(csrc / "ws_attn_body.cuh", "a") as fh:
        fh.write("// edited\n")
    third = {n: _build.source_key(n, csrc) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if third[n] != fourth[n]} == {"ws_attention", "ws_unified"}
    assert not any((csrc / h).exists() for h in ("ws_attn_tile.cuh", "ws_expert_tile.cuh",
                                                  "ws_load8.cuh"))
    with open(csrc / "ws_expert.cu", "a") as fh:
        fh.write("// edited\n")
    assert _build.source_key("ws_expert", csrc) != third["ws_expert"]
    assert _build.source_key("ws_attention", csrc) == third["ws_attention"]
    # one definition of NEG_INF in csrc/
    defs = [p.name for p in csrc.rglob("*.cu*") if "#define NEG_INF" in p.read_text()]
    assert defs == ["dtype_io.cuh"]


def test_nvcc_flags_target_hopper():
    from repro_torch import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"
    assert (ROOT / ".gitignore").read_text().count("build/repro_torch/") == 1


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steal,policy", [(True, "cost"), (True, "scan"), (False, "cost")])
def test_kernel_lockstep_matches_plain_on_card(cuda_device, steal, policy):
    from repro_torch.pallas_ws import emit_flash_tasks, make_queue_state, run_ws_schedule, to_device

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 40, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 40, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 40, 16)).astype(np.float32))
    state = make_queue_state(emit_flash_tasks([40, 9], 4, 8, 8), 4)
    kw = dict(causal=True, bq=8, bk=8, steal=steal, steal_policy=policy, mode="lockstep")
    got = run_ws_schedule(to_device(state, cuda_device), q.to(cuda_device),
                          k.to(cuda_device), v.to(cuda_device), **kw)
    want = run_ws_schedule(state, q, k, v, **kw)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_free_mode_runs_every_task_on_card(cuda_device):
    from repro_torch.pallas_ws import emit_decode_tasks, make_queue_state, run_ws_schedule, to_device

    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((4, 8, 1, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 2, 200, 32)).astype(np.float32))
    state = make_queue_state(emit_decode_tasks([200, 3, 77, 0], 8, 16), 8)
    got = run_ws_schedule(to_device(state, cuda_device), q.to(cuda_device),
                          k.to(cuda_device), k.to(cuda_device), causal=False, bq=1, bk=16)
    want = run_ws_schedule(state, q, k, k, causal=False, bq=1, bk=16)
    assert (got.mult[: state.n_tasks] >= 1).all()
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-5)


def _expert_inputs(seed, T=16, d=64, f=32, E=8, k=2, bt=8, P=8, steal=True):
    from repro_torch.moe_ws import route_to_tasks
    from repro_torch.pallas_ws import make_queue_state

    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    w = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32))
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    tasks, routed = route_to_tasks(idx, gates, E, bt=bt)
    state = make_queue_state(tasks, P, n_queues=E if steal else P, partition="owner")
    return idx, gates, x, w, tasks, routed, state


@pytest.mark.cuda
@pytest.mark.parametrize("steal,policy", [(True, "cost"), (True, "scan"), (False, "cost")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_kernel_lockstep_matches_plain_on_card(cuda_device, steal, policy, dtype):
    from repro_torch.moe_ws import run_moe_schedule
    from repro_torch.pallas_ws import to_device

    _, _, x, w, _, routed, state = _expert_inputs(8, steal=steal)
    w = [a.to(dtype) for a in w]
    kw = dict(bt=8, steal=steal, steal_policy=policy, mode="lockstep")
    got = run_moe_schedule(to_device(state, cuda_device), x.to(cuda_device), routed.tok_idx,
                           *[a.to(cuda_device) for a in w], **kw)
    want = run_moe_schedule(state, x, routed.tok_idx, *w, **kw)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_expert_kernel_free_mode_runs_every_tile_on_card(cuda_device):
    from repro_torch.moe_ws import combine_routed, expert_ffn_nodrop_ref, run_moe_schedule

    idx, gates, x, w, tasks, routed, state = _expert_inputs(9)
    got = run_moe_schedule(state, x.to(cuda_device), routed.tok_idx,
                           *[a.to(cuda_device) for a in w], bt=8, mode="free")
    assert (got.mult[: state.n_tasks] >= 1).all()
    torch.testing.assert_close(combine_routed(routed, tasks, got).cpu(),
                               expert_ffn_nodrop_ref(idx, gates, x, *w), rtol=0, atol=1e-5)


def _pool_inputs(seed, T=16, d=64, f=32, E=8, k=2, bt=8, P=8, kind="uniform"):
    """A shared-pool Put of a seeded routing (``repeat-expert``: every token
    names one expert k times), its activations, cotangents and weights."""
    from repro_torch.moe_ws import route_to_tasks_pool
    from repro_torch.pallas_ws import make_pool_queue_state

    rng = np.random.default_rng(seed)
    if kind == "repeat-expert":
        idx = np.repeat(rng.integers(0, E, (T, 1)), k, axis=1)
    else:
        idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    w = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32))
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    records, tail, pool_off, routed = route_to_tasks_pool(idx, gates, E, bt=bt)
    state = make_pool_queue_state(records, tail, pool_off, routed.loads, P,
                                  n_tasks=records.shape[0])
    return x, gy, w, routed, state


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "repeat-expert"])
@pytest.mark.parametrize("policy", ["cost", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_grad_kernel_lockstep_matches_plain_on_card(cuda_device, kind, policy, dtype):
    from repro_torch.moe_ws import expert_rounds_bound, run_moe_grad_schedule
    from repro_torch.pallas_ws import to_device

    x, gy, w, routed, state = _pool_inputs(10, kind=kind)
    w = [a.to(dtype) for a in w]
    kw = dict(bt=8, steal_policy=policy, mode="lockstep",
              rounds=expert_rounds_bound(32, 8, 8, 8, True))
    got = run_moe_grad_schedule(to_device(state, cuda_device), x.to(cuda_device),
                                gy.to(cuda_device), routed.tok_idx, routed.gates,
                                *[a.to(cuda_device) for a in w], **kw)
    want = run_moe_grad_schedule(state, x, gy, routed.tok_idx, routed.gates, *w, **kw)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_expert_grad_kernel_free_mode_runs_every_tile_on_card(cuda_device):
    from repro_torch.moe_ws import run_moe_grad_schedule

    x, gy, w, routed, state = _pool_inputs(11)
    got = run_moe_grad_schedule(state, x.to(cuda_device), gy.to(cuda_device),
                                routed.tok_idx, routed.gates,
                                *[a.to(cuda_device) for a in w], bt=8, mode="free")
    want = run_moe_grad_schedule(state, x, gy, routed.tok_idx, routed.gates, *w, bt=8,
                                 mode="free")
    n_live = int(state.tail.sum())
    assert (got.mult[:n_live] >= 1).all() and (got.mult[n_live:] == 0).all()
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "repeat-expert"])
def test_expert_kernel_pool_layout_matches_plain_on_card(cuda_device, kind):
    from repro_torch.moe_ws import expert_rounds_bound, run_moe_schedule
    from repro_torch.pallas_ws import to_device

    x, _, w, routed, state = _pool_inputs(12, kind=kind)
    kw = dict(bt=8, mode="lockstep", rounds=expert_rounds_bound(32, 8, 8, 8, True))
    got = run_moe_schedule(to_device(state, cuda_device), x.to(cuda_device), routed.tok_idx,
                           *[a.to(cuda_device) for a in w], **kw)
    want = run_moe_schedule(state, x, routed.tok_idx, *w, **kw)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_expert_grad_kernel_launches_at_kimi_hidden_width(cuda_device):
    """Shared memory grows with f: at kimi-k2's f 2048 the grad tile holds
    t/du and dv [8, 2048] and shallower cp.async rings (232,192 bytes with
    the rings, within the 227 KB a CTA can have); the launch must be
    accepted and agree."""
    from repro_torch.moe_ws import run_moe_grad_schedule

    x, gy, w, routed, state = _pool_inputs(13, T=4, d=64, f=2048, E=2, k=1)
    w = [a.to(torch.bfloat16) for a in w]
    got = run_moe_grad_schedule(state, x.to(cuda_device), gy.to(cuda_device), routed.tok_idx,
                                routed.gates, *[a.to(cuda_device) for a in w], bt=8)
    want = run_moe_grad_schedule(state, x, gy, routed.tok_idx, routed.gates, *w, bt=8)
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-4)


def _unified_inputs(fold):
    """A 3-layer fp32 GQA decoder at d 256 (8 heads over 2), its caches after
    a ragged prefill, the next tokens and (``fold``) a 31-token prompt."""
    from repro_torch.configs.llama3_2_3b import SMOKE
    from repro_torch.models import init_params, prefill

    cfg = SMOKE.replace(d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=1000,
                        n_layers=3)
    params = init_params(cfg, seed=0, device="cpu")
    _, caches = prefill(params, cfg, {"tokens": torch.tensor([[5, 6, 7, 8, 9, 10, 11],
                                                              [9, 8, 7, 6, 5, 4, 3]])},
                        capacity=96)
    kw = dict(prefill_tokens=torch.arange(11, 42).reshape(1, 31), bq=8, bk=16) if fold else {}
    return cfg, params, caches, torch.tensor([[3], [4]]), np.array([7, 5]), kw


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_unified_kernel_wrapper_marshals_every_argument(monkeypatch):
    """The unified kernel's wrapper, driven against a stand-in for its C entry
    point on CPU tensors: every argument passes its ctypes type, the launch is
    counted, and a CUDA error status raises."""
    import ctypes
    import types

    from repro_torch import _build
    from repro_torch.models.unified import plan_step, run_step
    from repro_torch.pallas_ws import launches

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int
        status = 0

        def __call__(self, *args):
            assert len(args) == len(self.argtypes)
            for t, a in zip(self.argtypes, args):
                t.from_param(a)
            return self.status

    entry = EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_unified_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    cfg, params, caches, tok, pos, kw = _unified_inputs(fold=True)
    plan = plan_step(params, cfg, caches, tok, pos, **kw)
    run = dict(steal=True, steal_policy="cost", n_programs=8, plain=False)
    before = launches["ws_unified"]
    run_step(params, cfg, plan, mode="lockstep", **run)
    _, n = run_step(params, cfg, plan, mode="free", **run)
    assert launches["ws_unified"] == before + 1 + n and n == 2 + 3 * cfg.n_layers
    entry.status = 2  # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="ws_unified"):
        run_step(params, cfg, plan, mode="lockstep", **run)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cost", "scan"])
@pytest.mark.parametrize("fold", [False, True])
def test_unified_kernel_lockstep_matches_plain_on_card(cuda_device, policy, fold):
    from repro_torch.models import Caches, KVCache, decode_step_unified

    cfg, params, caches, tok, pos, kw = _unified_inputs(fold)
    p_dev = _to(params, cuda_device)
    c_dev = Caches(kv=KVCache(caches.kv.k.to(cuda_device), caches.kv.v.to(cuda_device)))
    got = decode_step_unified(p_dev, cfg, c_dev, tok.to(cuda_device), pos,
                              steal_policy=policy, **kw)
    want = decode_step_unified(params, cfg, caches, tok, pos, steal_policy=policy, **kw)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult"):
        assert torch.equal(getattr(got[2].res, f).cpu(), getattr(want[2].res, f)), f
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1].kv.k.cpu(), want[1].kv.k, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1].kv.v.cpu(), want[1].kv.v, rtol=0, atol=1e-4)
    if fold:
        torch.testing.assert_close(got[2].prefill_logits.cpu(), want[2].prefill_logits,
                                   rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2].prefill_kv.k.cpu(), want[2].prefill_kv.k,
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_unified_kernel_free_mode_runs_every_task_on_card(cuda_device):
    from repro_torch.models import Caches, KVCache, decode_step_unified
    from repro_torch.pallas_ws import launches

    cfg, params, caches, tok, pos, kw = _unified_inputs(fold=True)
    p_dev = _to(params, cuda_device)
    c_dev = Caches(kv=KVCache(caches.kv.k.to(cuda_device), caches.kv.v.to(cuda_device)))
    before = launches["ws_unified"]
    logits, _, rep = decode_step_unified(p_dev, cfg, c_dev, tok.to(cuda_device), pos,
                                         mode="free", **kw)
    assert launches["ws_unified"] - before == rep.launches == 2 + 3 * cfg.n_layers
    assert bool((rep.res.mult[:rep.n_tasks] >= 1).all())
    want = decode_step_unified(params, cfg, caches, tok, pos, **kw)
    torch.testing.assert_close(logits.cpu(), want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(rep.prefill_logits.cpu(), want[2].prefill_logits, rtol=0,
                               atol=1e-4)


def _unified_moe_inputs(fold):
    """A 2-layer fp32 MoE decoder at d 128 (4 heads over 2, 16 experts top-4,
    one shared expert, ws dispatch), its caches after a ragged prefill, the
    next tokens and (``fold``) a 13-token prompt."""
    from repro_torch.configs.kimi_k2_1t_a32b import SMOKE
    from repro_torch.models import init_params, prefill

    cfg = SMOKE.replace(d_model=128, n_experts=16, top_k=4, moe_d_ff=64, d_ff=64,
                        vocab_size=512, dtype="float32", moe_dispatch="ws")
    params = init_params(cfg, seed=0, device="cpu")
    _, caches = prefill(params, cfg, {"tokens": torch.tensor([[5, 6, 7, 8, 9, 10, 11],
                                                              [9, 8, 7, 6, 5, 4, 3]])},
                        capacity=48)
    kw = dict(prefill_tokens=torch.arange(11, 24).reshape(1, 13), bq=8, bk=16) if fold else {}
    return cfg, params, caches, torch.tensor([[3], [4]]), np.array([7, 5]), kw


def test_unified_moe_kernel_wrapper_marshals_every_argument(monkeypatch):
    """The unified kernel's wrapper on a MoE model, against a stand-in for its
    C entry point: the expert weights go in place (their own pointers, no
    copy), the routing buffers and the router's scratch are passed, and the
    launches are counted (free mode: 2 + 5L)."""
    import ctypes
    import types

    from repro_torch import _build
    from repro_torch.models.unified import plan_step, run_step
    from repro_torch.pallas_ws import launches

    seen = {}

    def entry(*args):
        for t, a in zip(entry.argtypes, args):
            t.from_param(a)
        seen["ptrs"] = list(ctypes.cast(args[13], ctypes.POINTER(ctypes.c_void_p))[:49])
        seen["dims"] = list(ctypes.cast(args[14], ctypes.POINTER(ctypes.c_int))[:27])
        return 0

    entry.argtypes = None
    entry.restype = ctypes.c_int
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_unified_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    cfg, params, caches, tok, pos, kw = _unified_moe_inputs(fold=True)
    plan = plan_step(params, cfg, caches, tok, pos, **kw)
    run = dict(steal=True, steal_policy="cost", n_programs=8, plain=False)
    before = launches["ws_unified"]
    run_step(params, cfg, plan, mode="lockstep", **run)
    moe, g = params["layers"]["moe"], plan.g
    # the 49 pointers: 6 inputs, 13 weights (the shared experts in the MLP's slots,
    # then the router and the experts), 10 step buffers, 6 routing buffers, 14 scratch
    assert seen["ptrs"][12:19] == [moe[n].data_ptr() for n in ("ws_g", "ws_u", "ws_d", "router",
                                                                "we_g", "we_u", "we_d")]
    assert seen["ptrs"][29:35] == [plan.bufs[n].data_ptr()
                                   for n in ("xf", "tok", "gate", "e", "rl", "yr")]
    assert all(seen["ptrs"][35:49])
    assert seen["dims"][19:] == [16, 4, 64, g.bt, g.pool_dec, g.pool_pre, g.exp_dec_base,
                                 g.exp_pre_base]
    _, n = run_step(params, cfg, plan, mode="free", **run)
    assert launches["ws_unified"] == before + 1 + n and n == 2 + 5 * cfg.n_layers


def _moe_plans(cuda_device, fold, policy="cost", mode="lockstep"):
    """The same MoE step planned on the card and on the CPU, and run: the
    kernel there, the plain version here."""
    from repro_torch.models import Caches, KVCache
    from repro_torch.models.unified import plan_step, run_step

    cfg, params, caches, tok, pos, kw = _unified_moe_inputs(fold)
    p_dev = _to(params, cuda_device)
    c_dev = Caches(kv=KVCache(caches.kv.k.to(cuda_device), caches.kv.v.to(cuda_device)))
    run = dict(mode=mode, steal=True, steal_policy=policy, n_programs=8)
    got = plan_step(p_dev, cfg, c_dev, tok.to(cuda_device), pos, **kw)
    res_got, n = run_step(p_dev, cfg, got, **run)
    want = plan_step(params, cfg, caches, tok, pos, **kw)
    res_want, _ = run_step(params, cfg, want, **run)
    return got, want, res_got, res_want, n


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cost", "scan"])
@pytest.mark.parametrize("fold", [False, True])
def test_unified_moe_kernel_lockstep_matches_plain_on_card(cuda_device, policy, fold):
    """The router, pool Put, expert tiles and combine in the kernel against
    the plain version: integer arrays and routing bit for bit, outputs
    within 1e-4 (the same fp32 math summed in another order)."""
    got, want, res_got, res_want, _ = _moe_plans(cuda_device, fold, policy)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult"):
        assert torch.equal(getattr(res_got, f).cpu(), getattr(res_want, f)), f
    for name in ("tok", "e", "rl"):
        assert torch.equal(got.bufs[name].cpu(), want.bufs[name]), name
    torch.testing.assert_close(got.bufs["gate"].cpu(), want.bufs["gate"], rtol=0, atol=1e-5)
    for name in ("logits", "kc", "vc", "yr") + (("logp", "kp", "vp") if fold else ()):
        torch.testing.assert_close(got.bufs[name].cpu(), want.bufs[name], rtol=0, atol=1e-4,
                                   msg=name)


@pytest.mark.cuda
def test_unified_moe_kernel_free_mode_runs_every_task_on_card(cuda_device):
    got, want, res_got, _, n = _moe_plans(cuda_device, True, mode="free")
    assert n == 2 + 5 * got.g.L
    assert bool((res_got.mult[:got.g.n_tasks] >= 1).all())
    for name in ("logits", "logp"):
        torch.testing.assert_close(got.bufs[name].cpu(), want.bufs[name], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cost", "scan"])
def test_traced_lockstep_rings_match_plain_on_card(cuda_device, policy):
    """The traced instantiation: rings and arrays bit-equal to the plain walk."""
    from repro_torch.moe_ws import run_moe_schedule
    from repro_torch.pallas_ws import to_device

    _, _, x, w, _, routed, state = _expert_inputs(10)
    kw = dict(bt=8, steal_policy=policy, mode="lockstep", trace=True)
    got = run_moe_schedule(to_device(state, cuda_device), x.to(cuda_device), routed.tok_idx,
                           *[a.to(cuda_device) for a in w], **kw)
    want = run_moe_schedule(state, x, routed.tok_idx, *w, **kw)
    for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult", "events", "ev_cursor"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_traced_free_launch_is_clean_on_card(cuda_device):
    """A traced free launch under a stall-and-kill plan: every task runs,
    and the free-mode reading of the contract holds."""
    from repro_torch.chaos import FaultPlan, SafetyChecker, run_with_faults
    from repro_torch.moe_ws import run_moe_schedule
    from repro_torch.pallas_ws import default_rounds

    _, _, x, w, _, routed, state = _expert_inputs(11)
    xd, wd_ = x.to(cuda_device), [a.to(cuda_device) for a in w]

    def launch(st, *, rounds, out, mult, fault_plan):
        return run_moe_schedule(st, xd, routed.tok_idx, *wd_, bt=8, rounds=rounds, out=out,
                                mult=mult, trace=True, fault_plan=fault_plan, mode="free")

    clean = launch(state, rounds=0, out=None, mult=None, fault_plan=None)
    plan = FaultPlan(seed=2, stalls=(0, 3, 1), kills=(2,), storms=1, full_first_storm=True)
    chaos = run_with_faults(state, launch, plan, rounds=default_rounds(state, True),
                            mode="free")
    rep = SafetyChecker().check(chaos, n_tasks=state.n_tasks, normalized=chaos.res.out,
                                oracle_normalized=clean.out)
    assert rep.ok and rep.normalized_parity == "bitwise", rep.summary()


# ---------------------------------------------------------------------------
# the standalone kernels (repro_torch.kernels): marshalling and refusals on the
# CPU, each kernel against its plain version on the card


def _standalone_inputs(name, dtype=torch.float32, seed=0):
    """Small inputs of one standalone kernel: (module, args, kwargs) of its
    wrapper."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK

    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    if name == "flash_fwd":
        return FK, (randn(1, 4, 48, 16), randn(1, 2, 48, 16), randn(1, 2, 48, 16)), \
            dict(causal=True, window=20, bq=16, bk=16)
    if name == "decode_attention":
        return DK, (randn(2, 4, 16), randn(2, 2, 64, 16), randn(2, 2, 64, 16), 40), \
            dict(window=24, bk=16)
    dt = torch.nn.functional.softplus(torch.randn((1, 32, 3), generator=g)).to(dtype)
    A = -torch.exp(torch.randn((3,), generator=g))
    return SK, (randn(1, 32, 3, 8), dt, A, randn(1, 32, 4), randn(1, 32, 4)), dict(chunk=8)


STANDALONE = ("flash_fwd", "decode_attention", "ssd_scan")
ENTRY = {"flash_fwd": "flash_fwd_launch", "decode_attention": "decode_attention_launch",
         "ssd_scan": "ssd_scan_launch"}
WRAPPER = {"flash_fwd": "flash_attention_fwd", "decode_attention": "decode_attention",
           "ssd_scan": "ssd_scan"}


@pytest.mark.parametrize("name", STANDALONE)
def test_standalone_kernel_wrapper_marshals_every_argument(monkeypatch, name):
    """Each standalone wrapper's CUDA branch, driven on CPU tensors against a
    stand-in for its C entry point: every argument passes its ctypes type,
    the launch is counted, and a CUDA error status raises."""
    import ctypes
    import types

    from repro_torch import _build
    from repro_torch.kernels import launches

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int
        status = 0
        calls = 0

        def __call__(self, *args):
            assert len(args) == len(self.argtypes)
            for t, a in zip(self.argtypes, args):
                t.from_param(a)
            self.calls += 1
            return self.status

    entry = EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda lib: types.SimpleNamespace(**{ENTRY[lib]: entry}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    mod, args, kw = _standalone_inputs(name)
    monkeypatch.setattr(mod, "runs_plain", lambda *t: False)
    before = launches[name]
    out = getattr(mod, WRAPPER[name])(*args, **kw)
    assert launches[name] == before + 1 and entry.calls == 1
    n_args = {"flash_fwd": 16, "decode_attention": 16, "ssd_scan": 17}[name]
    assert len(entry.argtypes) == n_args
    first = out[0] if isinstance(out, tuple) else out
    assert first.shape == args[0].shape and first.dtype == args[0].dtype
    entry.status = 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match=f"{name} launch failed with CUDA error 1"):
        getattr(mod, WRAPPER[name])(*args, **kw)
    assert launches[name] == before + 2


@pytest.mark.parametrize("name", STANDALONE)
def test_standalone_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, name):
    """Types, shapes and devices are refused on every path; layouts, head
    dims and shared memory past the kernel's reach on the CUDA path, before
    any launch (the C entry point is never loaded)."""
    from repro_torch import _build
    from repro_torch.kernels import launches

    mod, args, kw = _standalone_inputs(name)
    fn = getattr(mod, WRAPPER[name])
    f16 = [a.half() if torch.is_tensor(a) and a.dtype == torch.float32 and a.dim() > 1 else a
           for a in args]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fn(*f16, **kw)
    with pytest.raises(ValueError):
        fn(args[0][:, :-1], *args[1:], **kw)   # a shape that does not fit
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="cuda"):
        fn(*meta, **kw)
    mixed = [args[0].to("meta"), *args[1:]]
    with pytest.raises(ValueError, match="several devices"):
        fn(*mixed, **kw)
    monkeypatch.setattr(_build, "load", lambda lib: pytest.fail("loaded the C library"))
    monkeypatch.setattr(mod, "runs_plain", lambda *t: False)
    before = dict(launches)
    strided = [args[0].transpose(-1, -2).contiguous().transpose(-1, -2), *args[1:]]
    with pytest.raises(ValueError, match="contiguous"):
        fn(*strided, **kw)
    if name == "ssd_scan":  # every chunk and N fit (a shorter chunk, tiles of N); b
        # past the grid's second dimension does not
        big = [torch.zeros((65536, 1, 1, 1)), torch.zeros((65536, 1, 1)), torch.zeros(1),
               torch.zeros((65536, 1, 1)), torch.zeros((65536, 1, 1))]
        with pytest.raises(ValueError, match="grid takes b up to 65535"):
            fn(*big, chunk=1)
    else:
        wide = [a.repeat_interleave(20, dim=-1) if torch.is_tensor(a) and a.dim() > 1 else a
                for a in args]   # head dim 320
        with pytest.raises(ValueError, match="head dims up to 256"):
            fn(*wide, **kw)
    assert launches == before


def test_standalone_cpu_tensors_run_the_plain_version_and_launch_nothing(monkeypatch):
    """CPU tensors take the plain versions through every public entry point,
    the autograd Functions' backward included, and build or launch nothing."""
    from repro_torch import _build
    from repro_torch.kernels import decode_attention, flash_attention, launches, ssd_scan

    monkeypatch.setattr(_build, "load", lambda lib: pytest.fail("loaded the C library"))
    before = dict(launches)
    _, (q, k, v), kw = _standalone_inputs("flash_fwd")
    xs = [t.requires_grad_(True) for t in (q, k, v)]
    flash_attention(*xs, **kw).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in xs)
    _, args, kw = _standalone_inputs("decode_attention")
    assert torch.isfinite(decode_attention(*args, **kw)).all()
    _, args, kw = _standalone_inputs("ssd_scan")
    xs = [t.requires_grad_(True) for t in args]
    ssd_scan(*xs, **kw).square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in xs)
    assert launches == before


# Kernel against plain version on the card: fp32 within 1e-5 abs + 1e-5 rel
# (the same fp32 arithmetic summed in another order), bf16 within the
# reference's 2e-2 (both round fp32 results to bf16 at the end).  The SSD
# scan's fp32 y and final state get 1e-3 abs: its cumulative sum cs of dt * A runs in another
# order than torch.cumsum, and at chunk 128 |cs| reaches ~200, whose ulp
# (1.5e-5) moves every exp(cs_i - cs_j) by up to that much relative, in terms
# of magnitude ~20 (|C . B| ~ sqrt(N) times |x dt|).
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_ATOL_FP32 = 1e-3
FLASH_CASES = [  # B, H, Hkv, S, hd, bq, bk, causal, window
    (1, 2, 2, 32, 8, 16, 16, True, 0), (2, 4, 1, 64, 16, 32, 16, False, 0),
    (1, 8, 4, 128, 32, 32, 32, True, 24), (1, 2, 2, 48, 8, 16, 16, True, 16),
    (1, 2, 1, 96, 256, 32, 32, True, 40), (1, 3, 3, 80, 128, 16, 16, False, 30),
]
DECODE_CASES = [  # B, H, Hkv, S, hd, bk, pos, window
    (1, 2, 1, 32, 8, 8, 31, 0), (2, 4, 2, 64, 16, 16, 30, 0), (2, 4, 2, 64, 16, 16, 63, 16),
    (1, 8, 8, 128, 32, 32, 5, 0), (2, 4, 2, 1024, 256, 512, 700, 100),
    (1, 3, 1, 96, 96, 32, 95, 0),
]
SSD_CASES = [  # b, S, H, P, N, chunk
    (1, 16, 2, 4, 4, 8), (2, 32, 3, 8, 4, 8), (1, 64, 2, 16, 8, 16), (2, 24, 1, 8, 8, 8),
    (1, 256, 2, 64, 128, 128),
]


def _close(got, want, dtype, atol=None):
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol if atol is None else atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fwd_kernel_matches_plain_on_card(cuda_device, case, dtype):
    from repro_torch.kernels import launches
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd

    B, H, Hkv, S, hd, bq, bk, causal, window = case
    g = torch.Generator().manual_seed(S + hd)
    q, k, v = (torch.randn(s, generator=g).to(dtype)
               for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    want, want_lse = flash_attention_fwd(q, k, v, **kw)
    before = launches["flash_fwd"]
    got, lse = flash_attention_fwd(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] == before + 1 and got.dtype == dtype
    _close(got, want, dtype)
    _close(lse, want_lse, dtype)


@pytest.mark.cuda
def test_flash_attention_grad_on_card(cuda_device):
    """The autograd Function over the kernel against the same Function over
    the plain forward on the CPU: gradients within 1e-4."""
    from repro_torch.kernels import flash_attention

    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(s, generator=g) for s in ((2, 4, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16))]
    for causal, window in [(True, 0), (True, 8), (False, 0)]:
        res = []
        for dev in ("cpu", cuda_device):
            ts = [t.detach().to(dev).requires_grad_(True) for t in xs]
            (flash_attention(*ts, causal, window, 16, 16) ** 2).sum().backward()
            res.append([t.grad.cpu() for t in ts])
        for a, b in zip(*res):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_kernel_matches_plain_on_card(cuda_device, case, dtype):
    from repro_torch.kernels import decode_attention, launches

    B, H, Hkv, S, hd, bk, pos, window = case
    g = torch.Generator().manual_seed(S + hd + pos)
    q = torch.randn((B, H, hd), generator=g).to(dtype)
    k, v = (torch.randn((B, Hkv, S, hd), generator=g).to(dtype) for _ in range(2))
    want = decode_attention(q, k, v, pos, window=window, bk=bk)
    before = launches["decode_attention"]
    qd, kd, vd = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    for p in (pos, torch.tensor(pos, dtype=torch.int64, device=cuda_device)):
        got = decode_attention(qd, kd, vd, p, window=window, bk=bk)
        torch.cuda.synchronize()
        _close(got, want, dtype)
    assert launches["decode_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain_on_card(cuda_device, case, dtype):
    from repro_torch.kernels import launches
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    b, S, H, P, N, chunk = case
    g = torch.Generator().manual_seed(S + P + N)
    x = torch.randn((b, S, H, P), generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, S, H), generator=g)).to(dtype)
    A = -torch.exp(torch.randn((H,), generator=g))
    B, C = (torch.randn((b, S, N), generator=g).to(dtype) for _ in range(2))
    want, want_fin = ssd_scan(x, dt, A, B, C, chunk=chunk)
    before = launches["ssd_scan"]
    got, fin = ssd_scan(*(t.to(cuda_device) for t in (x, dt, A, B, C)), chunk=chunk)
    torch.cuda.synchronize()
    assert launches["ssd_scan"] == before + 1 and got.dtype == dtype
    atol = SSD_ATOL_FP32 if dtype == torch.float32 else None
    _close(got, want, dtype, atol=atol)
    _close(fin, want_fin, dtype, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path, dtype):
    """A train state on the card (llama smoke, one AdamW step) saved and
    restored onto the card: every leaf bit-equal, bf16 ones too."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs.llama3_2_3b import SMOKE
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import init_params

    cfg = SMOKE.replace(dtype=dtype)
    opt = make_optimizer(cfg, total_steps=4)
    params = init_params(cfg, seed=0, device=cuda_device)
    state = {"params": params, "opt": opt.init(params)}
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda_device)
    state, _ = make_train_step(cfg, opt)(state, {"tokens": tokens})
    save(str(tmp_path), 1, state)
    like = {"params": init_params(cfg, seed=1, device=cuda_device)}
    like["opt"] = opt.init(like["params"])
    got, step = restore(str(tmp_path), like, device=cuda_device)
    assert step == 1 and got["opt"].step == state["opt"].step
    for (path, g), (_, w) in zip(_flatten(got), _flatten(state)):
        if isinstance(w, torch.Tensor):
            assert g.device.type == "cuda" and g.dtype == w.dtype, path
            bits = torch.int16 if w.dtype == torch.bfloat16 else w.dtype
            assert torch.equal(g.view(bits), w.detach().view(bits)), path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_decode_step_on_card(cuda_device, arch):
    """The ssm and hybrid smoke models' prefill and 8 dense decode steps on
    the card against the same on the CPU (fp32, within 1e-4 of the logits'
    scale: cuBLAS and the CPU sum the products in other orders), and
    against a longer prefill on the card (the reference's 2e-3).  The
    prompts are multiples of the smoke chunk (8), as a prompt past the chunk
    must be."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.model import cache_tensors

    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    out = {}
    def to(tree, dev):
        return ({k: to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.to(dev))

    for dev in ("cpu", cuda_device):
        p = to(params, dev)
        t = toks.to(dev)
        _, caches = prefill(p, cfg, {"tokens": t[:, :8]}, capacity=16)
        logits = []
        for i in range(8, 16):
            lg, caches = decode_step(p, cfg, caches, t[:, i:i + 1], i)
            logits.append(lg)
        full, _ = prefill(p, cfg, {"tokens": t}, capacity=16)
        out[str(dev)] = (torch.stack(logits).cpu(), full.cpu(),
                         [c.cpu() for c in cache_tensors(caches)])
    (cl, cf, cc), (gl, gf, gc) = out["cpu"], out[str(cuda_device)]
    scale = max(1.0, float(cl.abs().max()))
    assert float((gl - cl).abs().max()) <= 1e-4 * scale
    for a, b in zip(gc, cc):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))
    torch.testing.assert_close(gl[-1], gf, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_banded_flash_matches_masked_on_card(cuda_device):
    """The banded path against the masked one on the card (no JAX): fp32
    within 1e-5 of the scale, forward and gradients; bf16 forward and dq
    bit-equal (a window of one chunk: the band's chunk is the masked path's,
    so both run the same blocks in the same order, the masked ones adding
    exact zeros)."""
    from repro_torch.models import attention as A

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    S, H, hd, w, chunk = 256, 4, 32, 64, 64
    assert A._pick_chunk(S, min(chunk, max(w, 16))) == chunk
    base = [torch.randn((1, S, H, hd), generator=gen, device=cuda_device) for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        res = {}
        for path in ("banded", "masked"):
            q, k, v = (t.to(dtype, copy=True).requires_grad_(True) for t in base[:3])
            if path == "banded":
                out = A.flash_ref(q, k, v, causal=True, window=w, chunk=chunk)
            else:
                out = A._Flash.apply(q, k, v, w, 0, True, chunk)
            out.backward(base[3].to(dtype))
            res[path] = [out.detach(), q.grad, k.grad, v.grad]
        for name, got, want in zip(("out", "dq", "dk", "dv"), res["banded"], res["masked"]):
            if dtype == torch.float32:
                scale = max(1.0, float(want.abs().max()))
                assert float((got - want).abs().max()) <= 1e-5 * scale, name
            elif name in ("out", "dq"):
                assert torch.equal(got, want), name


@pytest.mark.cuda
def test_host_shim_layout_matches_device_put_on_card(cuda_device):
    """chip_smoke.core_layout on the card: the llama decode Put built by the
    device Put, queue by queue, equals the host shim's layout."""
    import importlib

    sys.path.insert(0, str(ROOT))
    out = importlib.import_module("chip_smoke").core_layout(cuda_device)
    assert all(all(q["equal"].values()) for q in out["queues"])
