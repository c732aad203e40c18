"""Half-run Steal (``steal_run_cap > 1``) in the port against the JAX
reference in Pallas interpret mode, on the same numpy inputs, plus the
ragged prefill entry point and its oracle.

A half-run steal claims ``min(ceil(rem/2), cap)`` contiguous victim slots
with one plain write to each bound and runs them back to back, each
accounted and traced on its own (``EV_RUN`` = the run's length), with one
clamped advisory write for the run.  In lockstep (the reference's
semantics, the port's plain walk) every integer array and event ring must
be the reference's bit for bit at cap 2 and 4: attention decode and flash,
the expert kernel on the host Put and the shared pool, and the ws backward.
Float outputs are held to 1e-5: the same fp32 tile math summed by XLA and
by ATen (|out| <= ~3 here).  Free mode has no reference: its plain walk is
held to the reference's normalised output and to ``SafetyChecker``'s
free-mode reading.  Seeded slices, no sweeps.  The ``cuda`` cases at the
bottom hold each kernel's half-run instantiation to its plain walk and skip
without a card; they need no JAX, so only the reference cases skip where
JAX is missing.
"""

import dataclasses as dc
import random

import numpy as np
import pytest
import torch

import repro_torch.pallas_ws as T_ws
from repro_torch.chaos import FaultPlan, SafetyChecker, run_with_faults, single_launch
from repro_torch.moe_ws import (
    combine_routed,
    expert_ffn_nodrop_ref,
    expert_rounds_bound,
    route_to_tasks,
    route_to_tasks_pool,
    row_divisor,
    run_moe_grad_schedule,
    run_moe_schedule,
)
from repro_torch.pallas_ws import (
    copy_state,
    decode_rounds_bound,
    default_rounds,
    emit_decode_tasks,
    emit_flash_tasks,
    make_pool_queue_state,
    make_queue_state,
    multiplicity_divisor,
    ragged_attention_ref,
    ragged_decode_attention,
    ragged_flash_attention,
    run_ws_schedule,
)
from repro_torch.wstrace import EV_KIND, EV_RUN, EV_TID, STEAL_KINDS, decode_rings
from repro_torch.wstrace.ring import KIND_TAKE

try:
    import jax.numpy as jnp

    import repro.chaos as J_chaos
    import repro.moe_ws as J_moe
    import repro.pallas_ws as J_ws
    from conftest import apply_rewind, drawn_rewind, resume_state
    from repro.pallas_ws.queues import copy_state as j_copy_state
    from repro.pallas_ws.ragged import decode_rounds_bound as j_decode_rounds_bound

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

CAPS = (2, 4)
ATOL = 1e-5
P = 3  # programs: fewer than the queues, so thieves roam
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
RINGS = ("events", "ev_cursor")


def _cdiv(a, b):
    return -(-a // b)


def _same(rj, rt, names=INTS, out_atol=ATOL):
    for n in names:
        np.testing.assert_array_equal(getattr(rt, n).numpy(), np.asarray(getattr(rj, n)),
                                      err_msg=n)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=out_atol)


def _stream(res):
    return decode_rings(res.events, res.ev_cursor)[0]


# ---------------------------------------------------------------------------
# attention: decode and flash launches


LENGTHS = np.array([56, 8, 0, 24, 40])


def _attention(kind, seed=0, H=2, Hkv=1, S=56, hd=8):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    Sq = S if kind == "flash" else 1
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    bq = 8 if kind == "flash" else 1
    emit = ((lambda m: m.emit_flash_tasks(LENGTHS, H, bq, 8)) if kind == "flash"
            else (lambda m: m.emit_decode_tasks(LENGTHS, H, 8)))
    return q, k, v, bq, emit


@needs_jax
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_attention_lockstep_halfrun_matches_reference(kind, cap):
    """Traced lockstep launches at cap 2 and 4: integer arrays and rings
    bit-equal, runs longer than one slot among the steals, Takes at 1."""
    q, k, v, bq, emit = _attention(kind)
    kw = dict(causal=kind == "flash", bq=bq, bk=8, steal_run_cap=cap, trace=True)
    rj = J_ws.run_ws_schedule(J_ws.make_queue_state(emit(J_ws), P), jnp.asarray(q),
                              jnp.asarray(k), jnp.asarray(v), **kw)
    rt = run_ws_schedule(make_queue_state(emit(T_ws), P), torch.from_numpy(q),
                         torch.from_numpy(k), torch.from_numpy(v), mode="lockstep", **kw)
    _same(rj, rt, INTS + RINGS)
    s = _stream(rt)
    assert (s[np.isin(s[:, EV_KIND], STEAL_KINDS), EV_RUN] > 1).any()
    assert (s[s[:, EV_KIND] == KIND_TAKE, EV_RUN] == 1).all()


# ---------------------------------------------------------------------------
# experts: the host Put, the shared pool, the ws backward


def _routing(seed, T=12, E=4, k=2, skew=False):
    rng = np.random.RandomState(seed)
    if skew:  # one hot expert: its queue is every thief's victim
        idx = np.stack([[0] + list(rng.choice(np.arange(1, E), k - 1, replace=False))
                        for _ in range(T)]).astype(np.int32)
    else:
        idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    return idx, gates / gates.sum(1, keepdims=True)


def _weights(seed, T, E, d=4, f=8):
    r = np.random.default_rng(100 + seed)
    x = r.standard_normal((T, d)).astype(np.float32)
    gy = r.standard_normal((T, d)).astype(np.float32)
    w = [(r.standard_normal(s) / 2).astype(np.float32) for s in ((E, d, f), (E, d, f), (E, f, d))]
    return x, gy, w


def _pool_states(idx, gates, E, bt):
    jr = J_moe.route_to_tasks_pool_jax(jnp.asarray(idx), jnp.asarray(gates), E, bt=bt)
    tr = route_to_tasks_pool(idx, gates, E, bt=bt)
    js = J_ws.make_pool_queue_state_jax(*jr[:3], jr[3].loads, P, n_tasks=jr[0].shape[0])
    ts = make_pool_queue_state(*tr[:3], tr[3].loads, P, n_tasks=tr[0].shape[0])
    return js, jr[3], ts, tr[3]


def _dense_states(idx, gates, E, bt):
    jt, jr = J_moe.route_to_tasks(idx, gates, E, bt=bt)
    tt, tr = route_to_tasks(idx, gates, E, bt=bt)
    return (J_ws.make_queue_state(jt, P, n_queues=E, partition="owner"), jr,
            make_queue_state(tt, P, n_queues=E, partition="owner"), tr)


@needs_jax
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("layout", ["dense", "pool"])
def test_expert_lockstep_halfrun_matches_reference(layout, cap):
    E, bt = 4, 2
    idx, gates = _routing(3, skew=True)
    x, _, w = _weights(3, idx.shape[0], E)
    js, jr, ts, tr = (_pool_states if layout == "pool" else _dense_states)(idx, gates, E, bt)
    rounds = expert_rounds_bound(idx.size, bt, E, P, True, steal_run_cap=cap)
    kw = dict(bt=bt, steal_run_cap=cap, trace=True, rounds=rounds)
    rj = J_moe.run_moe_schedule(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), **kw)
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          mode="lockstep", **kw)
    _same(rj, rt, INTS + RINGS)
    assert (_stream(rt)[:, EV_RUN] > 1).any()


@needs_jax
@pytest.mark.parametrize("cap", CAPS)
def test_grad_lockstep_halfrun_matches_reference(cap):
    """The ws backward's launch on the shared pool, with the layer's rounds
    bound at the same cap."""
    E, bt = 4, 2
    idx, gates = _routing(5, skew=True)
    x, gy, w = _weights(5, idx.shape[0], E)
    js, jr, ts, tr = _pool_states(idx, gates, E, bt)
    rounds = expert_rounds_bound(idx.size, bt, E, P, True, steal_run_cap=cap)
    assert rounds == J_moe.expert_rounds_bound(idx.size, bt, E, P, True, steal_run_cap=cap)
    kw = dict(bt=bt, steal_run_cap=cap, rounds=rounds, trace=True)
    rj = J_moe.run_moe_grad_schedule(js, jnp.asarray(x), jnp.asarray(gy), jr.tok_idx, jr.gates,
                                     *map(jnp.asarray, w), **kw)
    rt = run_moe_grad_schedule(ts, torch.from_numpy(x), torch.from_numpy(gy), tr.tok_idx,
                               tr.gates, *map(torch.from_numpy, w), mode="lockstep", **kw)
    _same(rj, rt, INTS + RINGS)
    assert (_stream(rt)[:, EV_RUN] > 1).any()


# ---------------------------------------------------------------------------
# tests/test_steal_policy.py's half-run section on the port


def _steal_setup(idx, gates, E, bt, seed):
    x, _, w = _weights(seed, idx.shape[0], E)
    js, jr, ts, tr = _dense_states(idx, gates, E, bt)
    return x, w, js, jr, ts, tr


def _moe_both(js, jr, ts, tr, x, w, bt, *, jout=None, tout=None, jmult=None, tmult=None,
              **kw):
    rj = J_moe.run_moe_schedule(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), bt=bt,
                                out=jout, mult=jmult, **kw)
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          bt=bt, mode="lockstep", out=tout, mult=tmult, **kw)
    _same(rj, rt)
    return rj, rt


def _routing_from(draw_int):
    """tests/test_steal_policy.py's drawn routing."""
    E = draw_int(2, 5)
    T = draw_int(1, 10)
    k = draw_int(1, min(2, E))
    bt = (2, 4)[draw_int(0, 1)]
    seed = draw_int(0, 2**16)
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    return E, T, k, bt, seed, idx, gates


def _rng_draws(seed):
    rng = random.Random(seed)
    return (lambda lo, hi: rng.randint(lo, hi)), (lambda: rng.random() < 0.5)


@needs_jax
@pytest.mark.parametrize("n_tiles", [1, 2, 3])
def test_halfrun_tiny_victim_runs(n_tiles):
    """Victim ``rem`` in {1, 2, 3}: the claim clips to >= 1, never walks past
    the live prefix, and rem = 2 takes one slot (the victim keeps its half)."""
    T, E, k, bt = n_tiles * 4, 6, 1, 4
    idx = np.zeros((T, k), dtype=np.int32)
    gates = np.ones((T, k), dtype=np.float32)
    x, w, js, jr, ts, tr = _steal_setup(idx, gates, E, bt, 0)
    rounds = default_rounds(ts, steal=True, steal_run_cap=4)
    assert rounds == J_ws.default_rounds(js, steal=True, steal_run_cap=4)
    _, rt = _moe_both(js, jr, ts, tr, x, w, bt, steal_policy="cost", rounds=rounds,
                      steal_run_cap=4)
    assert (rt.mult[: ts.n_tasks] == 1).all()
    drained = (rt.taken.numpy() >= 0).sum(axis=1)
    assert drained[0] == n_tiles and drained[1:].sum() == 0
    y = combine_routed(tr, ts.task_list, rt)
    ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@needs_jax
def test_halfrun_amortizes_probe_traffic():
    """On a deep one-queue skew the cap-8 launch issues at least 2x fewer slot
    probes than per-slot claims at the same round budget, as the
    reference's does."""
    T, E, k, bt = 96, 8, 1, 1
    idx = np.zeros((T, k), dtype=np.int32)
    gates = np.ones((T, k), dtype=np.float32)
    scans = {}
    for cap in (1, 8):
        x, w, js, jr, ts, tr = _steal_setup(idx, gates, E, bt, 5)
        rounds = default_rounds(ts, steal=True, steal_run_cap=8)
        _, rt = _moe_both(js, jr, ts, tr, x, w, bt, steal_policy="cost", rounds=rounds,
                          steal_run_cap=cap)
        assert (rt.mult[: ts.n_tasks] == 1).all()
        assert int(rt.head[0]) == T
        scans[cap] = rt.slots_scanned
    assert scans[8] * 2 <= scans[1], scans


@needs_jax
@pytest.mark.parametrize("seed", range(4))
def test_halfrun_invariance_seeded(seed):
    """Raising the cap never changes results: fresh launches run every tile
    once within the cap's Graham bound, outputs bit-identical to cap 1, probe
    traffic never grows; every launch bit-equal to the reference's."""
    draw_int, _ = _rng_draws(500 + seed)
    E, T, k, bt, wseed, idx, gates = _routing_from(draw_int)
    cap = (2, 3, 4)[draw_int(0, 2)]
    outs = {}
    for c in (1, cap):
        x, w, js, jr, ts, tr = _steal_setup(idx, gates, E, bt, wseed)
        rounds = default_rounds(ts, steal=True, steal_run_cap=cap)
        assert rounds == _cdiv(sum(t.cost for t in ts.task_list), P) + cap * max(
            t.cost for t in ts.task_list)
        _, rt = _moe_both(js, jr, ts, tr, x, w, bt, steal_policy="cost", rounds=rounds,
                          steal_run_cap=c)
        assert (rt.mult[: ts.n_tasks] == 1).all()
        y = combine_routed(tr, ts.task_list, rt)
        ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
        outs[c] = (rt.out.numpy(), rt.slots_scanned)
    np.testing.assert_array_equal(outs[cap][0], outs[1][0])
    assert outs[cap][1] <= outs[1][1]


@needs_jax
@pytest.mark.parametrize("seed", range(4))
def test_halfrun_rewind_drills_seeded(seed):
    """Head rewinds and wiped local bounds re-arm whole claimed runs: the
    relaunches (some under-provisioned) stay bit-equal to the reference's,
    no task is lost and the combine matches the oracle."""
    draw_int, draw_bool = _rng_draws(600 + seed)
    E, T, k, bt, wseed, idx, gates = _routing_from(draw_int)
    cap = (2, 4)[draw_int(0, 1)]
    x, w, js, jr, ts, tr = _steal_setup(idx, gates, E, bt, wseed)
    rounds = default_rounds(ts, steal=True, steal_run_cap=cap)
    kw = dict(steal_policy="cost", steal_run_cap=cap)
    rj, rt = _moe_both(js, jr, ts, tr, x, w, bt, rounds=rounds, **kw)
    assert (rt.mult[: ts.n_tasks] >= 1).all()
    for _ in range(draw_int(1, 2)):
        drawn_rewind(js, rj, draw_int, draw_bool, advisory_modes=("zeros", "reversed", "random"))
        for f in ("head", "local_head", "taken", "remaining"):  # the same stale snapshot
            setattr(ts, f, np.array(getattr(js, f)))
        rj, rt = _moe_both(js, jr, ts, tr, x, w, bt, rounds=draw_int(1, rounds), jout=rj.out,
                           tout=rt.out, jmult=jnp.asarray(rj.mult), tmult=rt.mult, **kw)
    assert (rt.mult[: ts.n_tasks] >= 1).all()
    y = combine_routed(tr, ts.task_list, rt)
    ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@needs_jax
def test_halfrun_trace_stream_balances_counters():
    """Runs amortise probes, not records: every slot of a run emits its own
    event (EV_RUN > 1 on steals, 1 on Takes), the stream balances the
    counters at cap 4 and cap 1, both bit-equal to the reference's, and
    the scanned counter, not the stream, shrinks."""
    T, E, k, bt = 24, 6, 1, 4
    idx = np.zeros((T, k), np.int32)
    gates = np.ones((T, k), np.float32)
    rounds = default_rounds(_steal_setup(idx, gates, E, bt, 0)[4], steal=True,
                            steal_run_cap=4)
    runs = {}
    for cap in (4, 1):
        x, w, js, jr, ts, tr = _steal_setup(idx, gates, E, bt, 0)
        rj = J_moe.run_moe_schedule(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w),
                                    bt=bt, rounds=rounds, steal_run_cap=cap, trace=True)
        rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                              bt=bt, rounds=rounds, steal_run_cap=cap, trace=True,
                              mode="lockstep")
        _same(rj, rt, INTS + RINGS)
        s = _stream(rt)
        claims = np.bincount(s[:, EV_TID], minlength=ts.n_tasks)
        np.testing.assert_array_equal(claims, rt.mult.numpy()[: ts.n_tasks])
        runs[cap] = (s, rt)
    s4, r4 = runs[4]
    assert (s4[np.isin(s4[:, EV_KIND], STEAL_KINDS), EV_RUN] > 1).any()
    assert (s4[s4[:, EV_KIND] == KIND_TAKE, EV_RUN] == 1).all()
    s1, r1 = runs[1]
    assert (s1[:, EV_RUN] == 1).all()
    assert r4.extractions == r1.extractions == s1.shape[0]
    assert r4.slots_scanned <= r1.slots_scanned


# ---------------------------------------------------------------------------
# chaos: tests/test_chaos.py's half-run plans, segment streams bit for bit


def _chaos_problem(seed):
    rng = np.random.RandomState(seed % 2**31)
    E, T, k, bt = 4, int(rng.randint(6, 12)), 1, 2
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    x, _, w = _weights(seed, T, E)
    js, jr, ts, tr = _dense_states(idx, gates, E, bt)
    return x, w, bt, js, jr, ts, tr


def _chaos_both(seed, plan_kw=None):
    x, w, bt, js, jr, ts, tr = _chaos_problem(seed)
    if plan_kw is None:
        plan = FaultPlan.from_seed(seed, n_programs=P)
        jplan = J_chaos.FaultPlan.from_seed(seed, n_programs=P)
    else:
        plan, jplan = FaultPlan(**plan_kw), J_chaos.FaultPlan(**plan_kw)
    assert dc.asdict(plan) == dc.asdict(jplan)
    rounds = default_rounds(ts, steal=True, steal_run_cap=4)

    def j_launch(state, *, rounds, out, mult, fault_plan):
        return J_moe.run_moe_schedule(
            state, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), bt=bt, rounds=rounds,
            out=out, mult=None if mult is None else jnp.asarray(mult), steal_run_cap=4,
            trace=True, fault_plan=fault_plan)

    def t_launch(state, *, rounds, out, mult, fault_plan, steal_run_cap):
        return run_moe_schedule(
            state, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w), bt=bt,
            rounds=rounds, out=out, mult=mult, steal_run_cap=steal_run_cap, trace=True,
            fault_plan=fault_plan, mode="lockstep")

    oj = J_moe.run_moe_schedule(j_copy_state(js), jnp.asarray(x), jr.tok_idx,
                                *map(jnp.asarray, w), bt=bt, rounds=rounds, steal_run_cap=4)
    ot = run_moe_schedule(copy_state(ts), torch.from_numpy(x), tr.tok_idx,
                          *map(torch.from_numpy, w), bt=bt, rounds=rounds, steal_run_cap=4,
                          mode="lockstep")
    cj = J_chaos.run_with_faults(js, j_launch, jplan, rounds=rounds)
    ct = run_with_faults(ts, t_launch, plan, rounds=rounds, steal_run_cap=4)
    assert [(s.kind, s.budget) for s in ct.segments] == [(s.kind, s.budget) for s in cj.segments]
    for sj, st in zip(cj.segments, ct.segments):
        np.testing.assert_array_equal(st.start_head, np.asarray(sj.start_head))
        np.testing.assert_array_equal(st.start_local, np.asarray(sj.start_local))
        np.testing.assert_array_equal(st.stream, np.asarray(sj.stream))
        _same(sj.res, st.res)
    n_rows = tr.n_rows
    rep_j = J_chaos.SafetyChecker().check(
        cj, n_tasks=js.n_tasks, oracle_accumulated=np.asarray(oj.out),
        row_mult=J_moe.row_divisor(js.task_list, cj.res.mult, n_rows))
    rep_t = SafetyChecker().check(
        ct, n_tasks=ts.n_tasks, oracle_accumulated=ot.out,
        row_mult=row_divisor(ts.task_list, ct.res.mult.numpy(), n_rows))
    assert rep_t.summary() == rep_j.summary()
    assert rep_t.ok and rep_t.normalized_parity == "bitwise", rep_t.summary()
    return rep_t


@needs_jax
@pytest.mark.parametrize("seed", range(2))
def test_moe_chaos_halfrun_seeded(seed):
    """Kills mid-run, rewinds that re-arm whole runs, garbage advisories:
    the segments equal the reference's and the checker is clean."""
    _chaos_both(seed)


@needs_jax
def test_storm_halfrun_produces_real_duplication():
    """A full head-rewind storm against run claims duplicates real work
    (max_mult >= 2), and normalisation still recovers the fault-free answer
    bitwise."""
    rep = _chaos_both(3, dict(seed=3, kills=(1,), storms=1, full_first_storm=True))
    assert rep.max_mult >= 2


# ---------------------------------------------------------------------------
# tests/test_dispatch_conformance.py's half-run schedules on the pool layout


@needs_jax
@pytest.mark.parametrize("seed", range(2))
def test_adversarial_schedules_halfrun_pool_seeded(seed):
    """The pool layout under cap 4 through drawn head-rewind relaunches
    (some under-provisioned): every launch bit-equal to the reference's, the
    host Put's launches slot for slot the same schedule, normalised rows
    bit-identical between the layouts and the combine at the oracle."""
    draw_int, draw_bool = _rng_draws(900 + seed)
    E, T, k, bt, wseed, idx, gates = _routing_from(draw_int)
    x, _, w = _weights(wseed, T, E)
    jd, jrd, td, trd = _dense_states(idx, gates, E, bt)
    jp, jrp, tp, trp = _pool_states(idx, gates, E, bt)
    rounds = expert_rounds_bound(T * k, bt, E, P, True, steal_run_cap=4)
    kw = dict(steal_policy="cost", steal_run_cap=4)
    rd = _moe_both(jd, jrd, td, trd, x, w, bt, rounds=rounds, **kw)
    rp = _moe_both(jp, jrp, tp, trp, x, w, bt, rounds=rounds, **kw)
    for _ in range(draw_int(1, 2)):
        np.testing.assert_array_equal(rd[1].head.numpy(), rp[1].head.numpy())
        spec = drawn_rewind(jd, rd[0], draw_int, draw_bool, heads=np.asarray(rd[0].head))
        resume_state(jp, rp[0])
        apply_rewind(jp, spec)
        for js_, ts_ in ((jd, td), (jp, tp)):
            for f in ("head", "local_head", "taken", "remaining"):
                setattr(ts_, f, np.array(getattr(js_, f)))
        r = draw_int(1, rounds)
        rd = _moe_both(jd, jrd, td, trd, x, w, bt, rounds=r, jout=rd[0].out, tout=rd[1].out,
                       jmult=jnp.asarray(rd[0].mult), tmult=rd[1].mult, **kw)
        rp = _moe_both(jp, jrp, tp, trp, x, w, bt, rounds=r, jout=rp[0].out, tout=rp[1].out,
                       jmult=jnp.asarray(rp[0].mult), tmult=rp[1].mult, **kw)
    th, tpl = rd[1], rp[1]
    for f in ("head", "clock", "work", "steals"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), getattr(tpl, f).numpy(), err_msg=f)
    assert (th.mult[: td.n_tasks] >= 1).all()
    yh = combine_routed(trd, td.task_list, th)
    yp = combine_routed(trp, None, tpl, bt=bt)
    np.testing.assert_array_equal(yh.numpy(), yp.numpy())
    ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
    np.testing.assert_allclose(yh.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# free mode: no reference, the normalised output and the checker


@needs_jax
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kind", ["flash", "expert"])
def test_free_mode_halfrun_is_clean(kind, cap):
    """The plain free walk with runs: every task runs, the stored output is
    the reference's normalised one, and a traced launch is clean under the
    checker's free-mode reading (each program claims a slot at most once:
    its local bound grows by the run)."""
    if kind == "flash":
        q, k, v, bq, emit = _attention("flash", seed=4)
        rj = J_ws.run_ws_schedule(J_ws.make_queue_state(emit(J_ws), P), jnp.asarray(q),
                                  jnp.asarray(k), jnp.asarray(v), causal=True, bq=bq, bk=8)
        tasks = emit_flash_tasks(LENGTHS, q.shape[1], bq, 8)
        want = np.asarray(rj.out) / multiplicity_divisor(
            tasks, np.asarray(rj.mult), tuple(rj.out.shape[:3]))[..., None]
        state = make_queue_state(tasks, P)
        rt = run_ws_schedule(copy_state(state), torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, bq=bq, bk=8, steal_run_cap=cap,
                             trace=True)
    else:
        E, bt = 4, 2
        idx, gates = _routing(7, skew=True)
        x, _, w = _weights(7, idx.shape[0], E)
        js, jr, state, tr = _dense_states(idx, gates, E, bt)
        rj = J_moe.run_moe_schedule(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w),
                                    bt=bt)
        want = np.asarray(rj.out)
        rt = run_moe_schedule(copy_state(state), torch.from_numpy(x), tr.tok_idx,
                              *map(torch.from_numpy, w), bt=bt, steal_run_cap=cap, trace=True)
    assert rt.mode == "free" and (rt.mult[: state.n_tasks] >= 1).all()
    np.testing.assert_allclose(rt.out.numpy(), want, rtol=0, atol=ATOL)
    rep = SafetyChecker().check(single_launch(state, rt), n_tasks=state.n_tasks,
                                normalized=rt.out, oracle_normalized=torch.from_numpy(want),
                                rtol=0, atol=ATOL)
    assert rep.ok, rep.summary()


# ---------------------------------------------------------------------------
# the ragged entry points and the decode rounds bound


@needs_jax
def test_decode_rounds_bound_matches_reference():
    for B, H, S, bk, nq, Pn, steal, cap in [
            (1, 1, 1, 1, 1, 1, True, 1), (4, 24, 1024, 64, 8, 8, True, 1),
            (4, 24, 1024, 64, 8, 8, True, 4), (3, 2, 100, 32, 2, 5, True, 2),
            (4, 24, 1024, 64, 8, 8, False, 1), (2, 3, 7, 8, 3, 3, False, 4),
            (5, 8, 333, 16, 4, 6, True, 8)]:
        want = j_decode_rounds_bound(B, H, S, bk, nq, Pn, steal, steal_run_cap=cap)
        assert decode_rounds_bound(B, H, S, bk, nq, Pn, steal, steal_run_cap=cap) == want


RAGGED = np.array([48, 17, 0, 33])


def _ragged_inputs(seed=0, H=4, Hkv=2, S=48, hd=8):
    rng = np.random.default_rng(seed)
    B = len(RAGGED)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v


@needs_jax
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("schedule,cap", [("ws", 1), ("ws", 4), ("static", 1)])
def test_ragged_flash_attention_matches_reference(schedule, cap, causal):
    """The ragged prefill entry point, lockstep (the reference's order):
    output within 1e-5 and every ``return_stats`` field equal."""
    q, k, v = _ragged_inputs()
    kw = dict(causal=causal, schedule=schedule, steal_run_cap=cap, n_programs=P, bq=8, bk=8,
              return_stats=True)
    oj, sj = J_ws.ragged_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         RAGGED, **kw)
    ot, st = ragged_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), RAGGED, mode="lockstep", **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    for f in ("schedule", "steal_policy", "n_tasks", "makespan", "total_work", "wasted_slots",
              "steals", "mult_max", "slots_scanned", "extractions", "scan_per_extraction",
              "queue_loads"):
        assert getattr(st, f) == getattr(sj, f), f
    # free mode (the default) stores normalised tiles: the same output
    of = ragged_flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                RAGGED, **{**kw, "return_stats": False})
    np.testing.assert_allclose(of.numpy(), np.asarray(oj), rtol=0, atol=ATOL)


@needs_jax
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_attention_ref_matches_reference(causal):
    q, k, v = _ragged_inputs(seed=1)
    want = J_ws.ragged_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), RAGGED,
                                     causal=causal)
    got = ragged_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               RAGGED, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # and the entry point against the oracle, through the cap-4 steal path
    out = ragged_flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 RAGGED, causal=causal, steal_run_cap=4, n_programs=P, bq=8,
                                 bk=8)
    np.testing.assert_allclose(out.numpy(), got.numpy(), rtol=0, atol=ATOL)


@needs_jax
def test_ragged_decode_attention_halfrun_matches_reference():
    rng = np.random.default_rng(2)
    lengths = np.array([64, 5, 0, 30])
    q = rng.standard_normal((4, 4, 8)).astype(np.float32)
    k = rng.standard_normal((4, 2, 64, 8)).astype(np.float32)
    kw = dict(steal_run_cap=4, n_programs=P, bk=8, return_stats=True)
    oj, sj = J_ws.ragged_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                          lengths, **kw)
    ot, st = ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(k), lengths, mode="lockstep", **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    assert (st.makespan, st.steals, st.slots_scanned) == (sj.makespan, sj.steals,
                                                           sj.slots_scanned)


# ---------------------------------------------------------------------------
# refusals


@pytest.mark.parametrize("kw", [dict(steal_run_cap=0),
                                dict(steal_run_cap=2, steal_policy="scan"),
                                dict(steal_run_cap=2, steal=False),
                                dict(steal_run_cap=2, stage_open=np.zeros(1, np.int32),
                                     mode="lockstep")])
def test_halfrun_refusals(kw):
    """The reference's three refusals: a cap below 1; a cap above 1 without
    stealing or under the scan policy; a cap above 1 with ``stage_open``."""
    from repro_torch.pallas_ws import launch_ws_grid

    state = make_queue_state(emit_decode_tasks([8], 1, 8), 1)
    q, k = torch.zeros((1, 1, 1, 8)), torch.zeros((1, 1, 8, 8))
    with pytest.raises(ValueError, match="steal_run_cap"):
        launch_ws_grid(state, q, k, k, torch.zeros((1, 1, 1, 8)), bq=1, bk=8, causal=False,
                       scale=1.0, **kw)


# ---------------------------------------------------------------------------
# the kernels' half-run instantiations on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ints_equal(rk, rp):
    for n in INTS + RINGS:
        a, b = getattr(rk, n), getattr(rp, n)
        if a is not None or b is not None:
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_attention_kernel_halfrun_matches_plain_on_card(cuda_device, kind):
    from repro_torch.pallas_ws import to_device

    rng = np.random.default_rng(0)
    B, H, S, hd = len(LENGTHS), 2, 56, 8
    Sq = S if kind == "flash" else 1
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, 1, S, hd)).astype(np.float32))
    bq = 8 if kind == "flash" else 1
    tasks = (emit_flash_tasks(LENGTHS, H, bq, 8) if kind == "flash"
             else emit_decode_tasks(LENGTHS, H, 8))
    state = make_queue_state(tasks, P)
    kw = dict(causal=kind == "flash", bq=bq, bk=8, steal_run_cap=4, trace=True)
    rk = run_ws_schedule(to_device(state, cuda_device), q.to(cuda_device), k.to(cuda_device),
                         k.to(cuda_device), mode="lockstep", **kw)
    rp = run_ws_schedule(state, q, k, k, mode="lockstep", **kw)
    _ints_equal(rk, rp)
    np.testing.assert_allclose(rk.out.cpu().numpy(), rp.out.numpy(), rtol=0, atol=1e-4)
    rf = run_ws_schedule(to_device(state, cuda_device), q.to(cuda_device), k.to(cuda_device),
                         k.to(cuda_device), steal_run_cap=4, causal=kind == "flash", bq=bq,
                         bk=8)
    div = multiplicity_divisor(tasks, rp.mult.numpy(), rp.out.shape[:3])
    want = rp.out.numpy() / div[..., None]
    assert (rf.mult.cpu().numpy() >= 1).all()
    np.testing.assert_allclose(rf.out.cpu().numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "pool", "grad"])
def test_expert_kernels_halfrun_match_plain_on_card(cuda_device, layout):
    from repro_torch.pallas_ws import to_device

    E, bt = 4, 8
    idx, gates = _routing(3, T=24, skew=True)
    x, gy, w = _weights(3, idx.shape[0], E, d=16, f=16)
    if layout == "dense":
        tt, tr = route_to_tasks(idx, gates, E, bt=bt)
        state = make_queue_state(tt, P, n_queues=E, partition="owner")
    else:
        tr = route_to_tasks_pool(idx, gates, E, bt=bt)
        state = make_pool_queue_state(*tr[:3], tr[3].loads, P, n_tasks=tr[0].shape[0])
        tr = tr[3]
    rounds = expert_rounds_bound(idx.size, bt, E, P, True, steal_run_cap=4)
    kw = dict(bt=bt, steal_run_cap=4, rounds=rounds, trace=True, mode="lockstep")

    def go(st, dev):
        args = [torch.from_numpy(a).to(dev) for a in w]
        if layout == "grad":
            return run_moe_grad_schedule(st, torch.from_numpy(x).to(dev),
                                         torch.from_numpy(gy).to(dev), tr.tok_idx, tr.gates,
                                         *args, **kw)
        return run_moe_schedule(st, torch.from_numpy(x).to(dev), tr.tok_idx, *args, **kw)

    rk = go(to_device(state, cuda_device), cuda_device)
    rp = go(state, torch.device("cpu"))
    _ints_equal(rk, rp)
    np.testing.assert_allclose(rk.out.cpu().numpy(), rp.out.numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(policy="scan"), dict(steal=False)])
def test_kernel_entry_point_refuses_halfrun_outside_cost_steals_on_card(cuda_device, kw):
    """The C entry point keeps the reference's refusals itself: a cap above 1
    without cost-policy stealing launches nothing and returns
    cudaErrorInvalidValue, which the wrapper raises."""
    from repro_torch.pallas_ws import kernel as K
    from repro_torch.pallas_ws import to_device

    state = to_device(make_queue_state(emit_decode_tasks(LENGTHS, 2, 8), P), cuda_device)
    arrs = {n: getattr(state, n).clone() for n in ("head", "local_head", "taken", "remaining")}
    arrs.update(tasks=state.tasks, tail=state.tail)
    for n in ("clock", "work", "steals", "scanned"):
        arrs[n] = torch.zeros(P, dtype=torch.int32, device=cuda_device)
    arrs["mult"] = torch.zeros((P, state.n_tasks), dtype=torch.int32, device=cuda_device)
    q = torch.zeros((len(LENGTHS), 2, 1, 8), device=cuda_device)
    k = torch.zeros((len(LENGTHS), 1, 56, 8), device=cuda_device)
    args = dict(mode="free", rounds=0, steal=True, policy="cost", compress=False, causal=False,
                bq=1, bk=8, scale=1.0, g=2, n_tasks=state.n_tasks, run_cap=2)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K._launch_cuda(arrs, q, k, k, torch.zeros_like(q), **{**args, **kw})
