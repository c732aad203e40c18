"""The redesigned expert kernels (``csrc/ws_expert.cu``, ``ws_expert_grad.cu``
over ``csrc/ws_expert_mma.cuh``): one CTA a program streaming the weights
through a cp.async ring onto mma.sync, activations in three bf16 parts, the
backward's dgate reordered, and free-mode victim ties in each program's
rotation.

On the CPU: torch mirrors of the tiles' arithmetic (each fp32 activation
in bf16 parts, each part's product summed in fp32, the parts summed in
order; the backward's t = ct wd^T, dh = gr t and dgate = sum_j h t) held against the JAX package's ``_expert_execute`` and
``_expert_grad_execute`` through ``launch_ws_grid`` in interpret mode, at
the widths and seeds of the card tests in ``tests/test_torch_isolation.py``
(d 64, f 32), within their 1e-5; two parts miss it.  The rotated tie-break
of the plain free walk; lockstep bit-equal to the reference at every
``steal_run_cap``; the host's shared-memory choice and its refusal before
a launch.  The ``cuda`` cases at the bottom hold both kernels to their
plain versions on the card at kimi-k2's and deepseek-v2's widths, in
lockstep and free mode; they need no JAX.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.moe_ws import expert_kernel as X
from repro_torch.moe_ws import (
    grad_out_width,
    route_to_tasks,
    route_to_tasks_pool,
    run_moe_grad_schedule,
    run_moe_schedule,
)
from repro_torch.pallas_ws import make_pool_queue_state, make_queue_state
from repro_torch.pallas_ws.kernel import _PlainWalk

try:
    import jax.numpy as jnp

    from repro.moe_ws import route_to_tasks as j_route
    from repro.moe_ws import run_moe_grad_schedule as j_run_grad
    from repro.moe_ws import run_moe_schedule as j_run
    from repro.pallas_ws import make_queue_state as j_make_state

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

# the card tests' tolerance (tests/test_torch_isolation.py): fp32 sums of
# the same products in another order, |out| <~ 15 (dgate)
ATOL = 1e-5
NP = 3        # bf16 parts of an fp32 activation (csrc/ws_expert_mma.cuh)
INT_FIELDS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult")


def _weights(rng, E, d, f, dtype):
    w = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32))
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return [a.to(dtype) for a in w]


def _routing(rng, T, E, k):
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    return idx, gates / gates.sum(1, keepdims=True)


def _inputs(seed, T=16, d=64, f=32, E=8, k=2, dtype=torch.bfloat16):
    """The card tests' generator (``_pool_inputs``): routing, x, gy, weights."""
    rng = np.random.default_rng(seed)
    idx, gates = _routing(rng, T, E, k)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    return idx, gates, x, gy, _weights(rng, E, d, f, dtype)


# ---------------------------------------------------------------------------
# torch mirrors of the tiles' arithmetic


def parts(a, n=NP):
    """a = p_0 + p_1 + ... + rest: each part the bf16 rounding of what is
    left (split_parts in csrc/ws_expert_mma.cuh)."""
    out, rest = [], a.clone()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def product(a, w, n):
    """a [rows, K] fp32 times w [K, M] (bf16 values in fp32): one fp32 sum
    per part, the parts added in order."""
    ps = [p @ w for p in parts(a, n)]
    acc = ps[0]
    for p in ps[1:]:
        acc = acc + p
    return acc


def forward_rows(xt, wg, wu, wd, n=NP):
    """The forward tile: h = silu(xt wg) * (xt wu), y = h wd."""
    u, v = product(xt, wg, n), product(xt, wu, n)
    h = u / (1.0 + torch.exp(-u)) * v
    return product(h, wd, n)


def backward_rows(xt, ct, gr, wg, wu, wd, n=NP):
    """The backward tile's block [dx | du | dv | h | dgate]: t = ct wd^T
    (wd read once), dh = gr t, dgate = sum_j h t in fp64."""
    t = product(ct, wd.T, n)
    u, v = product(xt, wg, n), product(xt, wu, n)
    sig = 1.0 / (1.0 + torch.exp(-u))
    s = u * sig
    h = s * v
    dh = gr[:, None] * t
    dv = dh * s
    du = dh * v * (sig * (1.0 + u * (1.0 - sig)))
    dgate = (h.double() * t.double()).sum(-1, keepdim=True).float()  # summed in fp64
    dx = product(du, wg.T, n) + product(dv, wu.T, n)
    return torch.cat([dx, du, dv, h, dgate], dim=1)


def _tiles(tasks):
    """(e, rs, rl) of every live record of a queue state's tasks."""
    live = tasks[tasks[..., 0] >= 0]
    return [(int(r[1]), int(r[2]), int(r[3])) for r in live]


def _mirror_out(tasks, routed, fn, n_rows, width, bt=8):
    out = torch.zeros((n_rows, width))
    for e, rs, rl in _tiles(tasks):
        block = fn(e, routed.tok_idx[rs:rs + bt], rs)
        block[rl:] = 0.0
        out[rs:rs + bt] = block
    return out


def _reference_forward(seed, dtype):
    idx, gates, x, _, w = _inputs(seed, dtype=dtype)
    jt, jr = j_route(idx, gates, 8, bt=8)
    js = j_make_state(jt, 8, n_queues=8, partition="owner")
    jw = [jnp.asarray(a.float().numpy()) for a in w]
    rj = j_run(js, jnp.asarray(x.numpy()), jr.tok_idx, *jw, bt=8)
    return x, [a.float() for a in w], np.asarray(js.tasks), jr, np.array(rj.out), np.asarray(rj.mult)


@needs_jax
@pytest.mark.parametrize("seed", [8, 9])
def test_forward_tile_mirror_matches_reference(seed):
    """Three bf16 parts of x and h: within 1e-5 of the reference's fp32
    tile (one execution per tile in its lockstep walk)."""
    x, (wg, wu, wd), jt, jr, want, mult = _reference_forward(seed, torch.bfloat16)
    assert (mult[: len(_tiles(jt))] == 1).all()
    got = _mirror_out(jt, jr, lambda e, tok, rs: forward_rows(
        x[torch.from_numpy(np.asarray(tok)).long()], wg[e], wu[e], wd[e]),
        want.shape[0], want.shape[1])
    err = float((got - torch.from_numpy(want)).abs().max())
    assert err <= ATOL, err


@needs_jax
def test_two_parts_miss_the_card_tolerance():
    """The control: x and h in two bf16 parts (hi + lo) err ~4x more than in
    three, and the backward's dgate (a sum of f products of O(1) terms)
    misses 1e-5 in two parts on every seed, while three hold it."""
    fwd = {2: [], 3: []}
    for seed in (8, 9, 10, 11):
        x, (wg, wu, wd), jt, jr, want, _ = _reference_forward(seed, torch.bfloat16)
        for n in (2, 3):
            got = _mirror_out(jt, jr, lambda e, tok, rs: forward_rows(
                x[torch.from_numpy(np.asarray(tok)).long()], wg[e], wu[e], wd[e], n=n),
                want.shape[0], want.shape[1])
            fwd[n].append(float((got - torch.from_numpy(want)).abs().max()))
    assert max(fwd[3]) <= ATOL and max(fwd[2]) > 2 * max(fwd[3]), fwd
    for seed in (10, 11, 12, 13):
        errs = {n: _grad_errors(seed, n) for n in (2, 3)}
        assert errs[3]["dgate"] <= ATOL < errs[2]["dgate"], errs


def _reference_grad(seed, dtype=torch.bfloat16):
    idx, gates, x, gy, w = _inputs(seed, dtype=dtype)
    jt, jr = j_route(idx, gates, 8, bt=8)
    js = j_make_state(jt, 8, n_queues=8, partition="owner")
    jw = [jnp.asarray(a.float().numpy()) for a in w]
    rj = j_run_grad(js, jnp.asarray(x.numpy()), jnp.asarray(gy.numpy()), jr.tok_idx, jr.gates,
                    *jw, bt=8)
    assert (np.asarray(rj.mult)[: js.n_tasks] == 1).all()
    return x, gy, [a.float() for a in w], np.asarray(js.tasks), jr, np.array(rj.out)


def _grad_errors(seed, n=NP):
    x, gy, (wg, wu, wd), records, routed, want = _reference_grad(seed)
    d, f = x.shape[1], wg.shape[2]
    gr = torch.from_numpy(np.asarray(routed.gates))

    def block(e, tok, rs):
        t = torch.from_numpy(np.asarray(tok)).long()
        return backward_rows(x[t], gy[t], gr[rs:rs + 8], wg[e], wu[e], wd[e], n=n)

    got = _mirror_out(records, routed, block, want.shape[0], grad_out_width(d, f))
    diff = (got - torch.from_numpy(want)).abs()
    groups = {"dx": slice(0, d), "du": slice(d, d + f), "dv": slice(d + f, d + 2 * f),
              "h": slice(d + 2 * f, d + 3 * f), "dgate": slice(d + 3 * f, d + 3 * f + 1)}
    return {k: float(diff[:, sl].max()) for k, sl in groups.items()}


@needs_jax
@pytest.mark.parametrize("seed", [10, 11])
def test_backward_tile_mirror_matches_reference(seed):
    """t = ct wd^T, dh = gr t and dgate = sum_j h t (the reference's sum_c
    ct (h wd), reordered so wd is read once), three bf16 parts: every
    column group within 1e-5."""
    errs = _grad_errors(seed)
    assert max(errs.values()) <= ATOL, errs


# ---------------------------------------------------------------------------
# the rotated tie-break of the plain free walk


class _Walk(_PlainWalk):
    def execute(self, fq, fs, *, store):
        pass


def _one_tile_queues(n_queues, live, P):
    """A decode-time Put: queue v holds one tile (remaining 1) when v is in
    ``live``; the programs' own queues (0..P-1) are empty."""
    tasks = np.full((n_queues, 2, 8), -1, np.int32)
    for i, v in enumerate(live):
        tasks[v, 0] = (2, v, 8 * i, 1, 0, 0, i, 1)  # OP_EXPERT_TILE (e, rs, rl), tid, cost
    tail = np.array([1 if v in live else 0 for v in range(n_queues)], np.int32)
    arrs = dict(tasks=tasks, tail=tail, head=np.zeros(n_queues, np.int32),
                local_head=np.zeros((P, n_queues), np.int32),
                taken=np.full((n_queues, 2), -1, np.int32), remaining=tail.copy(),
                clock=np.zeros(P, np.int32), work=np.zeros(P, np.int32),
                steals=np.zeros(P, np.int32), scanned=np.zeros(P, np.int32),
                mult=np.zeros((P, len(live)), np.int32))
    return _Walk(arrs, steal=True, policy="cost")


def test_rotated_ties_send_thieves_to_different_victims():
    """Every score 1: the reference's first-index order sends each idle
    program to the first live queue; the rotation sends program p to the
    first live queue from p * n_queues // P on (wrapping)."""
    P, n = 8, 64
    live = [9, 13, 20, 21, 40, 47, 50, 63]
    for p in range(P):
        plain = _one_tile_queues(n, live, P).cost_extract(p, 0, 0, n)
        assert plain[:3] == (True, 9, 0)
        found, v, s, _, run = _one_tile_queues(n, live, P).cost_extract(p, 0, 0, n, rotate=True)
        v0 = p * n // P
        want = next((u for u in live if u >= v0), live[0])
        assert (found, v, s, run) == (True, want, 0, 1), (p, v, want)
    # a strictly larger score still wins from anywhere in the rotation
    w = _one_tile_queues(n, live, P)
    w.remaining[13] = 2
    assert w.cost_extract(7, 0, 0, n, rotate=True)[1] == 13


def test_rotation_refuses_a_stage_gate():
    """The rotated argmax tests no stage_open (the kernels' ROT walks are
    free walks, which have no stage gate): a gated walk asking for it is
    refused rather than ranked past its gate."""
    w = _one_tile_queues(64, [9, 13], 8)
    w.stage_open = [0] * 64
    with pytest.raises(ValueError, match="stage gate"):
        w.cost_extract(0, 0, 0, 64, rotate=True)
    assert w.cost_extract(0, 0, 0, 64)[:3] == (True, 9, 0)


def test_rotated_free_walk_spreads_the_first_claims():
    """The round-robin free walk at a decode-like Put: with rotation the
    first steals of the 8 programs are 8 different tiles; without it the
    queues drain in index order.  Each tile runs exactly once either way."""
    P, n = 8, 64
    live = [9, 13, 20, 21, 40, 47, 50, 63]
    firsts = {}
    for rotate in (False, True):
        w = _one_tile_queues(n, live, P)
        w.enable_trace(np.full((P, 8, 11), -1, np.int32), np.zeros(P, np.int32), 1,
                       np.zeros(len(live), np.int32))
        w.free(P, rotate=rotate)
        assert np.asarray(w.mult).sum(0).tolist() == [1] * len(live)
        firsts[rotate] = [int(w.events[p, 0, 2]) for p in range(P)]
    assert firsts[False] == live
    assert sorted(firsts[True]) == live and firsts[True] != live


@needs_jax
@pytest.mark.parametrize("cap", [1, 2, 4])
def test_lockstep_is_the_reference_at_every_cap(cap):
    """The rotation is free mode's alone: the expert walk's lockstep (which
    passes through the same launch_grid) stays bit-equal to the reference
    at steal_run_cap 1, 2 and 4, on the decode-like dense Put."""
    idx, gates, x, _, w = _inputs(20, T=4, E=16, k=4, dtype=torch.float32)
    jt, jr = j_route(idx, gates, 16, bt=8)
    tt, tr = route_to_tasks(idx, gates, 16, bt=8)
    js = j_make_state(jt, 8, n_queues=16, partition="owner")
    ts = make_queue_state(tt, 8, n_queues=16, partition="owner")
    rj = j_run(js, jnp.asarray(x.numpy()), jr.tok_idx, *[jnp.asarray(a.numpy()) for a in w],
               bt=8, steal_run_cap=cap)
    rt = run_moe_schedule(ts, x, tr.tok_idx, *w, bt=8, steal_run_cap=cap, mode="lockstep")
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=ATOL)


def test_free_mode_with_rotation_is_complete_and_normalised():
    """The expert free walk (rotated) runs every live tile once and stores
    the lockstep walk's rows, forward and backward, pool and dense."""
    idx, gates, x, gy, w = _inputs(21, dtype=torch.float32)
    records, tail, pool_off, routed = route_to_tasks_pool(idx, gates, 8, bt=8)
    ps = make_pool_queue_state(records, tail, pool_off, routed.loads, 8,
                               n_tasks=records.shape[0])
    n_live = int(ps.tail.sum())
    for run, args in ((run_moe_schedule, (x, routed.tok_idx, *w)),
                      (run_moe_grad_schedule, (x, gy, routed.tok_idx, routed.gates, *w))):
        free = run(ps, *args, bt=8, mode="free")
        lock = run(ps, *args, bt=8, mode="lockstep")
        assert (free.mult[:n_live] == 1).all() and (free.mult[n_live:] == 0).all()
        torch.testing.assert_close(free.out, lock.out, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the host's shared memory and its refusal


@pytest.mark.parametrize("f,grad,smem,ring_w", [
    (2048, False, 230656, 20480),   # kimi-k2 forward: u/h [8, 2048 + 8] fp32 + 8 rings
    (1536, False, 214272, 20480),   # deepseek-v2 forward
    (1536, True, 232192, 16544),    # deepseek-v2 backward: t/du, u/dv
    (2048, True, 232192, 12448),    # kimi-k2 backward: shallower rings
    (2320, True, 232192, 10272),    # the widest backward tile
    (32, False, 166144, 20480),
    (2608, False, 232192, 18432),   # the widest forward tile: its 4-stage rings
])
def test_tile_smem_matches_the_layout(f, grad, smem, ring_w):
    """One CTA a program: the header, one or two [8, f] fp32 tiles and a
    cp.async ring a warp, within 232,448 B beside the kernels' 256 bytes of
    static shared memory."""
    assert X.tile_smem(f, grad=grad) == (smem, ring_w)
    assert smem + 256 <= X.SMEM_LIMIT


@pytest.mark.parametrize("f,grad", [(8192, False), (2624, False), (2336, True), (4096, True)])
def test_a_tile_past_the_limit_is_refused_before_any_launch(monkeypatch, f, grad):
    """Where the tiles pass 232,448 B, the wrapper raises before it loads or
    calls the kernel."""
    from repro_torch import _build

    with pytest.raises(ValueError, match="232448"):
        X.tile_smem(f, grad=grad)
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    d = 16
    x = torch.zeros((2, d))
    w = [torch.zeros((1, d, f), dtype=torch.bfloat16), torch.zeros((1, f, d), dtype=torch.bfloat16)]
    kw = dict(mode="free", rounds=0, steal=True, policy="cost", compress=False, bt=8, n_tasks=1)
    before = dict(X.launches)
    with pytest.raises(ValueError, match="232448"):
        if grad:
            X._launch_grad_cuda({}, x, x, None, None, w[0], w[0], w[1], None, **kw)
        else:
            X._launch_cuda({}, x, None, w[0], w[0], w[1], None, **kw)
    assert calls == [] and X.launches == before


# ---------------------------------------------------------------------------
# on the card (no JAX)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# kimi-k2 and deepseek-v2 expert widths, a handful of experts, decode-like
# (T 4) and training-like (T 64) routings
CARD_WIDTHS = {"kimi-k2": dict(d=7168, f=2048), "deepseek-v2": dict(d=5120, f=1536)}


def _card_problem(seed, name, T, E=6, k=2):
    rng = np.random.default_rng(seed)
    d, f = CARD_WIDTHS[name]["d"], CARD_WIDTHS[name]["f"]
    idx, gates = _routing(rng, T, E, k)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    w = _weights(rng, E, d, f, torch.bfloat16)
    records, tail, pool_off, routed = route_to_tasks_pool(idx, gates, E, bt=8)
    state = make_pool_queue_state(records, tail, pool_off, routed.loads, 8,
                                  n_tasks=records.shape[0])
    return x, gy, w, routed, state


def _on(dev, *ts):
    return [t.to(dev) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lockstep", "free"])
@pytest.mark.parametrize("name,T", [("kimi-k2", 4), ("deepseek-v2", 64)])
def test_forward_kernel_matches_plain_at_full_width(cuda_device, name, T, mode):
    """Lockstep: integer arrays bit-equal, out within 1e-4 (sums over
    d = 5120-7168 and f; chip_smoke.py's ATOL); free: every live tile run,
    the stored rows within 1e-4 of the plain version's."""
    from repro_torch.pallas_ws import to_device

    x, _, w, routed, state = _card_problem(30, name, T)
    got = run_moe_schedule(to_device(state, cuda_device), *_on(cuda_device, x), routed.tok_idx,
                           *_on(cuda_device, *w), bt=8, mode=mode)
    want = run_moe_schedule(state, x, routed.tok_idx, *w, bt=8, mode=mode)
    n_live = int(state.tail.sum())
    if mode == "lockstep":
        for f in INT_FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    else:
        assert (got.mult[:n_live].cpu() >= 1).all()
    torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lockstep", "free"])
@pytest.mark.parametrize("name,T", [("kimi-k2", 4), ("deepseek-v2", 64)])
def test_backward_kernel_matches_plain_at_full_width(cuda_device, name, T, mode):
    """Each column group of the block within 1e-4 of its own scale
    (chip_smoke.py's GRAD_RTOL); lockstep integer arrays bit-equal."""
    from repro_torch.pallas_ws import to_device

    x, gy, w, routed, state = _card_problem(31, name, T)
    got = run_moe_grad_schedule(to_device(state, cuda_device), *_on(cuda_device, x, gy),
                                routed.tok_idx, routed.gates, *_on(cuda_device, *w), bt=8,
                                mode=mode)
    want = run_moe_grad_schedule(state, x, gy, routed.tok_idx, routed.gates, *w, bt=8,
                                 mode=mode)
    if mode == "lockstep":
        for f in INT_FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    d, f = x.shape[1], w[0].shape[2]
    a, b = got.out.cpu(), want.out
    for sl in (slice(0, d), slice(d, d + f), slice(d + f, d + 2 * f),
               slice(d + 2 * f, d + 3 * f), slice(d + 3 * f, d + 3 * f + 1)):
        scale = float(b[:, sl].abs().max())
        assert float((a[:, sl] - b[:, sl]).abs().max()) <= 1e-4 * scale, sl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_card_holds_every_program_at_once(cuda_device, dtype, grad):
    """At kimi-k2's and deepseek-v2's f, with the tile's shared memory, the
    card holds every program of a P 8 launch at once."""
    for f in (2048, 1536):
        assert X.resident_programs(dtype, f, grad=grad) >= 8, f
