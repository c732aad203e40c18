"""The port's fault injection and safety checker (``repro_torch.chaos``)
against the JAX package's ``repro.chaos``, on the same numpy inputs.

In lockstep (the reference's semantics, the port's plain walk) the segment
sequence of a seeded :class:`FaultPlan` must be the reference's bit for bit:
segment kinds, budgets, start snapshots, decoded streams, the final integer
arrays, and each side's ``SafetyChecker`` summary.  ``out`` is held to 1e-5:
the same fp32 tile math summed by XLA and by ATen.  Free mode has no
reference: the plain walk's runs are held to the checker's free-mode
reading, and the checker to the violations it must catch.  Seeded slices,
no sweeps."""

import dataclasses as dc

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.chaos import FaultPlan as JFaultPlan  # noqa: E402
from repro.chaos import SafetyChecker as JSafetyChecker  # noqa: E402
from repro.chaos import run_with_faults as j_run_with_faults  # noqa: E402
from repro.moe_ws.dispatch import route_to_tasks as j_route  # noqa: E402
from repro.moe_ws.dispatch import row_divisor as j_row_divisor  # noqa: E402
from repro.moe_ws.expert_kernel import run_moe_grad_schedule as j_run_grad  # noqa: E402
from repro.moe_ws.expert_kernel import run_moe_schedule as j_run_moe  # noqa: E402
from repro.pallas_ws import ragged_attention_ref as j_attention_ref  # noqa: E402
from repro.pallas_ws.kernel import default_rounds as j_default_rounds  # noqa: E402
from repro.pallas_ws.kernel import run_ws_schedule as j_run_ws  # noqa: E402
from repro.pallas_ws.queues import copy_state as j_copy_state  # noqa: E402
from repro.pallas_ws.queues import make_queue_state as j_make_state  # noqa: E402
from repro.pallas_ws.tasks import emit_flash_tasks as j_emit_flash  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    FaultPlan,
    RewindSpec,
    SafetyChecker,
    apply_rewind,
    resume_state,
    run_with_faults,
    single_launch,
)
from repro_torch.moe_ws import (  # noqa: E402
    route_to_tasks,
    row_divisor,
    run_moe_grad_schedule,
    run_moe_schedule,
)
from repro_torch.pallas_ws import (  # noqa: E402
    copy_state,
    default_rounds,
    emit_flash_tasks,
    make_queue_state,
    multiplicity_divisor,
    run_ws_schedule,
)
from repro_torch.wstrace import EV_PROG, EV_ROUND, decode_rings  # noqa: E402

P = 3  # programs: fewer than the expert count, so thieves roam
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
ATOL = 1e-5


# ---------------------------------------------------------------------------
# problems: tests/test_chaos.py's, drawn with numpy for both sides


def _moe_problem(seed):
    rng = np.random.RandomState(seed % 2**31)
    E, T, k, bt = 4, int(rng.randint(6, 12)), 1, 2
    d, f = 4, 8
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    r = np.random.default_rng(seed)
    x = r.standard_normal((T, d)).astype(np.float32)
    gy = r.standard_normal((T, d)).astype(np.float32)
    w = [(r.standard_normal(s) / 2).astype(np.float32) for s in ((E, d, f), (E, d, f), (E, f, d))]
    jt, jr = j_route(idx, gates, E, bt=bt)
    tt, tr = route_to_tasks(idx, gates, E, bt=bt)
    return dict(x=x, gy=gy, w=w, bt=bt, jtasks=jt, jr=jr, tasks=tt, tr=tr,
                js=j_make_state(jt, P, n_queues=E, partition="owner"),
                ts=make_queue_state(tt, P, n_queues=E, partition="owner"))


def _moe_launches(m, *, grad=False, mode="lockstep"):
    """The reference's and the port's ``launch(state, *, rounds, out, mult,
    fault_plan)``: traced moe (or grad) schedules on the problem ``m``."""
    jw, tw = list(map(jnp.asarray, m["w"])), list(map(torch.from_numpy, m["w"]))
    x, gy = m["x"], m["gy"]

    def j_launch(state, *, rounds, out, mult, fault_plan):
        kw = dict(bt=m["bt"], steal=True, rounds=rounds, out=out,
                  mult=None if mult is None else jnp.asarray(mult), trace=True)
        if grad:  # no launch faults: the grad schedule takes no fault_plan
            assert fault_plan is None or not (fault_plan.max_stall
                                              or fault_plan.advisory != "exact")
            return j_run_grad(state, jnp.asarray(x), jnp.asarray(gy), m["jr"].tok_idx,
                              m["jr"].gates, *jw, **kw)
        return j_run_moe(state, jnp.asarray(x), m["jr"].tok_idx, *jw, fault_plan=fault_plan,
                         **kw)

    def t_launch(state, *, rounds, out, mult, fault_plan):
        kw = dict(bt=m["bt"], steal=True, rounds=rounds, out=out, mult=mult, trace=True,
                  mode=mode)
        if grad:
            return run_moe_grad_schedule(state, torch.from_numpy(x), torch.from_numpy(gy),
                                         m["tr"].tok_idx, m["tr"].gates, *tw, **kw)
        return run_moe_schedule(state, torch.from_numpy(x), m["tr"].tok_idx, *tw,
                                fault_plan=fault_plan, **kw)

    return j_launch, t_launch


def _assert_same_chaos(cj, ct):
    assert [s.kind for s in ct.segments] == [s.kind for s in cj.segments]
    assert [s.budget for s in ct.segments] == [s.budget for s in cj.segments]
    for sj, st in zip(cj.segments, ct.segments):
        np.testing.assert_array_equal(st.start_head, np.asarray(sj.start_head))
        np.testing.assert_array_equal(st.start_local, np.asarray(sj.start_local))
        np.testing.assert_array_equal(st.stream, np.asarray(sj.stream))
        assert st.dropped == sj.dropped
        for n in INTS:
            np.testing.assert_array_equal(getattr(st.res, n).numpy(),
                                          np.asarray(getattr(sj.res, n)), err_msg=n)
    np.testing.assert_array_equal(ct.tails, np.asarray(cj.tails))
    np.testing.assert_allclose(ct.res.out.numpy(), np.asarray(cj.res.out), rtol=0, atol=ATOL)


def _moe_chaos_both(seed, *, grad=False):
    m = _moe_problem(seed)
    plan = FaultPlan.from_seed(seed, n_programs=P)
    jplan = JFaultPlan.from_seed(seed, n_programs=P)
    if grad:
        plan, jplan = plan.without_launch_faults(), jplan.without_launch_faults()
    assert dc.asdict(plan) == dc.asdict(jplan)
    rounds = default_rounds(m["ts"], steal=True)
    assert rounds == j_default_rounds(m["js"], steal=True)
    j_launch, t_launch = _moe_launches(m, grad=grad)
    oj = j_launch(j_copy_state(m["js"]), rounds=rounds, out=None, mult=None, fault_plan=None)
    ot = t_launch(copy_state(m["ts"]), rounds=rounds, out=None, mult=None, fault_plan=None)
    cj = j_run_with_faults(m["js"], j_launch, jplan, rounds=rounds)
    ct = run_with_faults(m["ts"], t_launch, plan, rounds=rounds)
    _assert_same_chaos(cj, ct)
    n_rows = m["tr"].n_rows
    rep_j = JSafetyChecker().check(
        cj, n_tasks=m["js"].n_tasks, oracle_accumulated=np.asarray(oj.out),
        row_mult=j_row_divisor(m["jtasks"], cj.res.mult, n_rows))
    rep_t = SafetyChecker().check(
        ct, n_tasks=m["ts"].n_tasks, oracle_accumulated=ot.out,
        row_mult=row_divisor(m["tasks"], ct.res.mult.numpy(), n_rows))
    assert rep_t.summary() == rep_j.summary()
    assert rep_t.ok and rep_t.normalized_parity == "bitwise", rep_t.summary()
    return plan, ct, rep_t


# ---------------------------------------------------------------------------
# lockstep: the reference's segment streams, bit for bit


@pytest.mark.parametrize("seed", range(4))
def test_moe_chaos_matches_reference(seed):
    plan, ct, _ = _moe_chaos_both(seed)
    assert [s.kind for s in ct.segments] == (
        ["kill"] * len(plan.kills) + ["storm"] * plan.storms + ["final"])


@pytest.mark.parametrize("seed", range(2))
def test_attention_chaos_matches_reference(seed):
    rng = np.random.RandomState(seed % 2**31)
    lengths = np.array([32, 8, 8, 16])[rng.permutation(4)]
    H, hd, bq, bk = 2, 8, 8, 8
    B, S = len(lengths), int(max(lengths))
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    js = j_make_state(j_emit_flash(lengths, H, bq, bk, causal=True), n_programs=4)
    tasks = emit_flash_tasks(lengths, H, bq, bk, causal=True)
    ts = make_queue_state(tasks, n_programs=4)
    plan, jplan = FaultPlan.from_seed(seed, n_programs=4), JFaultPlan.from_seed(seed, n_programs=4)
    rounds = default_rounds(ts, steal=True)

    def j_launch(state, *, rounds, out, mult, fault_plan):
        return j_run_ws(state, *map(jnp.asarray, (q, k, v)), causal=True, bq=bq, bk=bk,
                        steal=True, rounds=rounds, out=out,
                        mult=None if mult is None else jnp.asarray(mult), trace=True,
                        fault_plan=fault_plan)

    def t_launch(state, *, rounds, out, mult, fault_plan):
        return run_ws_schedule(state, *map(torch.from_numpy, (q, k, v)), causal=True, bq=bq,
                               bk=bk, steal=True, rounds=rounds, out=out, mult=mult,
                               trace=True, fault_plan=fault_plan, mode="lockstep")

    cj = j_run_with_faults(js, j_launch, jplan, rounds=rounds)
    ct = run_with_faults(ts, t_launch, plan, rounds=rounds)
    _assert_same_chaos(cj, ct)
    oracle = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)), lengths))
    div = multiplicity_divisor(tasks, ct.res.mult.numpy(), (B, H, S))
    rep_t = SafetyChecker().check(ct, n_tasks=ts.n_tasks,
                                  normalized=ct.res.out.numpy() / div[..., None],
                                  oracle_normalized=oracle, rtol=1e-5, atol=1e-5)
    jdiv = multiplicity_divisor(tasks, np.asarray(cj.res.mult), (B, H, S))
    rep_j = JSafetyChecker().check(cj, n_tasks=js.n_tasks,
                                   normalized=np.asarray(cj.res.out) / jdiv[..., None],
                                   oracle_normalized=oracle, rtol=1e-5, atol=1e-5)
    assert rep_t.summary() == rep_j.summary()
    assert rep_t.ok, rep_t.summary()


def test_grad_chaos_without_launch_faults_matches_reference():
    """The backward kernel takes no launch faults (as the reference's grad
    schedule), so chaos drives it with kills and storms only."""
    plan, ct, rep = _moe_chaos_both(2, grad=True)
    assert plan.kills and plan.storms and not plan.max_stall, plan
    assert rep.max_mult >= 2


def test_fault_plan_none_and_zero_plan_are_bit_identical():
    m = _moe_problem(7)
    _, t_launch = _moe_launches(m)
    rounds = default_rounds(m["ts"], steal=True)
    runs = [t_launch(copy_state(m["ts"]), rounds=rounds, out=None, mult=None, fault_plan=p)
            for p in (None, FaultPlan())]
    base = run_moe_schedule(copy_state(m["ts"]), torch.from_numpy(m["x"]), m["tr"].tok_idx,
                            *map(torch.from_numpy, m["w"]), bt=m["bt"], rounds=rounds,
                            mode="lockstep", trace=True)
    assert FaultPlan().is_off
    for res in runs:
        for n in INTS + ("out", "events", "ev_cursor"):
            assert torch.equal(getattr(res, n), getattr(base, n)), n


def test_stalled_programs_extract_nothing_before_release():
    """A stall is an initial clock: the stalled program's first event lands
    at or after its stall, the budget grows by the largest stall, every
    task still runs once, and the rings are the reference's."""
    lengths = np.array([32, 8, 8, 16])
    H, bq, bk, hd = 2, 8, 8, 8
    B, S = len(lengths), int(max(lengths))
    r = np.random.default_rng(11)
    q, k, v = (r.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    ts = make_queue_state(emit_flash_tasks(lengths, H, bq, bk, causal=True), n_programs=4)
    js = j_make_state(j_emit_flash(lengths, H, bq, bk, causal=True), n_programs=4)
    stalls = (3, 0, 2, 0)
    res = run_ws_schedule(ts, *map(torch.from_numpy, (q, k, v)), causal=True, bq=bq, bk=bk,
                          trace=True, fault_plan=FaultPlan(stalls=stalls), mode="lockstep")
    rj = j_run_ws(js, *map(jnp.asarray, (q, k, v)), causal=True, bq=bq, bk=bk, trace=True,
                  fault_plan=JFaultPlan(stalls=stalls))
    np.testing.assert_array_equal(res.events.numpy(), np.asarray(rj.events))
    assert res.events.shape[1] == default_rounds(ts, steal=True) + max(stalls)
    assert (res.mult[: ts.n_tasks] == 1).all(), "stalls must not drop work"
    stream, dropped = decode_rings(res.events, res.ev_cursor)
    assert (dropped == 0).all()
    for p, stall in enumerate(stalls):
        mine = stream[stream[:, EV_PROG] == p]
        if len(mine):
            assert int(mine[:, EV_ROUND].min()) >= stall, p


def test_checker_catches_violations():
    """Corrupt a clean run's counters / outputs and the matching clause trips."""
    m = _moe_problem(1)
    _, t_launch = _moe_launches(m)
    plan = FaultPlan(seed=1, storms=1, full_first_storm=True)
    rounds = default_rounds(m["ts"], steal=True)
    oracle = t_launch(copy_state(m["ts"]), rounds=rounds, out=None, mult=None, fault_plan=None)
    chaos = run_with_faults(m["ts"], t_launch, plan, rounds=rounds)
    checker = SafetyChecker()
    assert checker.check(chaos, n_tasks=m["ts"].n_tasks).ok

    clean_res = chaos.segments[-1].res
    mult = clean_res.mult.clone()
    mult[0] = 0
    chaos.segments[-1].res = dc.replace(clean_res, mult=mult)
    rep = checker.check(chaos, n_tasks=m["ts"].n_tasks)
    assert not rep.ok
    assert any(v.kind in ("lost-task", "stream-mult-mismatch") for v in rep.violations)
    chaos.segments[-1].res = clean_res

    bad_out = oracle.out.clone()
    bad_out.view(-1)[0] += 1.0
    rep = checker.check(chaos, n_tasks=m["ts"].n_tasks, normalized=bad_out,
                        oracle_normalized=oracle.out)
    assert rep.normalized_parity == "diverged"
    assert any(v.kind == "normalized-parity" for v in rep.violations)


# ---------------------------------------------------------------------------
# free mode: the checker's free-mode reading


@pytest.mark.parametrize("seed", range(4))
def test_free_mode_seeded_plans_are_clean(seed):
    """Seeded plans (stalls, kills cutting a program's own clock, storms,
    advisory garbage) through free launches of the plain walk: clean under
    the free-mode reading, and the stored tiles are the fault-free ones."""
    m = _moe_problem(seed)
    _, t_launch = _moe_launches(m, mode="free")
    plan = FaultPlan.from_seed(seed, n_programs=P)
    rounds = default_rounds(m["ts"], steal=True)
    clean = t_launch(copy_state(m["ts"]), rounds=0, out=None, mult=None, fault_plan=None)
    chaos = run_with_faults(m["ts"], t_launch, plan, rounds=rounds, mode="free")
    budgets = [s.budget for s in chaos.segments]
    assert budgets == ([k + (plan.max_stall if i == 0 else 0) for i, k in enumerate(plan.kills)]
                       + [0] * (plan.storms + 1))
    rep = SafetyChecker().check(chaos, n_tasks=m["ts"].n_tasks, normalized=chaos.res.out,
                                oracle_normalized=clean.out)
    assert rep.ok and rep.normalized_parity == "bitwise", rep.summary()
    assert rep.stats["mode"] == "free"
    assert rep.stats["clauses"]["2b-round-double-claim"] == "skipped"


def test_free_mode_full_storm_is_clean_and_duplicates():
    m = _moe_problem(3)
    _, t_launch = _moe_launches(m, mode="free")
    plan = FaultPlan(seed=3, kills=(1,), storms=1, full_first_storm=True)
    clean = t_launch(copy_state(m["ts"]), rounds=0, out=None, mult=None, fault_plan=None)
    chaos = run_with_faults(m["ts"], t_launch, plan, rounds=default_rounds(m["ts"], True),
                            mode="free")
    rep = SafetyChecker().check(chaos, n_tasks=m["ts"].n_tasks, normalized=chaos.res.out,
                                oracle_normalized=clean.out)
    assert rep.ok and rep.max_mult >= 2, rep.summary()
    assert rep.normalized_parity == "bitwise"


def test_free_mode_checker_catches_a_program_reclaim():
    """Two programs claiming one slot is free mode's sanctioned multiplicity
    (clause 2b does not apply, 2c bounds it by the programs whose view was at
    or below the slot); one program claiming it twice breaks clause 2a."""
    m = _moe_problem(2)
    res = run_moe_schedule(copy_state(m["ts"]), torch.from_numpy(m["x"]), m["tr"].tok_idx,
                           *map(torch.from_numpy, m["w"]), bt=m["bt"], mode="free", trace=True)
    chaos = single_launch(m["ts"], res)
    n = m["ts"].n_tasks
    assert SafetyChecker().check(chaos, n_tasks=n).ok
    ev = chaos.segments[0].stream
    tid = int(ev[0, 4])
    mult = res.mult.clone()
    mult[tid] += 1
    other = ev[0].copy()
    other[EV_PROG] = (other[EV_PROG] + 1) % P      # another program, the same round
    chaos.segments[0].stream = np.concatenate([ev, other[None]])
    chaos.segments[0].res = dc.replace(res, mult=mult)
    rep = SafetyChecker().check(chaos, n_tasks=n)
    assert rep.ok, rep.summary()
    chaos.segments[0].stream = np.concatenate([ev, ev[:1]])  # the same program twice
    rep = SafetyChecker().check(chaos, n_tasks=n)
    assert [v.kind for v in rep.violations] == ["program-reclaim"]
    # the lockstep reading of the two-program stream flags the round double claim
    chaos.segments[0].stream = np.concatenate([ev, other[None]])
    chaos.segments[0].res = dc.replace(res, mult=mult, mode="lockstep")
    kinds = [v.kind for v in SafetyChecker().check(chaos, n_tasks=n).violations]
    assert "round-double-claim" in kinds


def test_rewind_helpers_match_reference():
    """apply_rewind / resume_state / RewindSpec.full on a host state and on
    a result's tensors give the reference's arrays."""
    from repro.chaos import RewindSpec as JRewindSpec
    from repro.chaos import apply_rewind as j_apply_rewind

    m = _moe_problem(5)
    res = run_moe_schedule(copy_state(m["ts"]), torch.from_numpy(m["x"]), m["tr"].tok_idx,
                           *map(torch.from_numpy, m["w"]), bt=m["bt"], mode="lockstep")
    st, sj = copy_state(m["ts"]), j_copy_state(m["js"])
    resume_state(st, res)
    sj.head, sj.local_head = res.head.numpy().copy(), res.local_head.numpy().copy()
    sj.taken, sj.remaining = res.taken.numpy().copy(), res.remaining.numpy().copy()
    spec = RewindSpec(head_targets={0: 1, 2: 0}, wiped=(1,), advisory="random",
                      advisory_seed=9)
    apply_rewind(st, spec)
    j_apply_rewind(sj, JRewindSpec(**dc.asdict(spec)))
    for n in ("head", "local_head", "taken", "remaining"):
        np.testing.assert_array_equal(getattr(st, n), np.asarray(getattr(sj, n)), err_msg=n)
    assert RewindSpec.full(st) == RewindSpec(**dc.asdict(JRewindSpec.full(sj)))
