"""The serving engine's faults against the JAX package's: crash plans on the
work-stealing frontend and the unified step's watchdog, on the CPU.

* crash plans (``ReplicaCrashPlan``), the cases of tests/test_chaos.py —
  a crash with requests in flight, a crash of an empty engine, a dead
  replica's queue stolen by the survivor, and a crash on a completion
  boundary — each through the port's frontend and the reference's on the
  same batchers: the reference's deterministic stand-in (token k of a
  request is its sequence length at emission), and llama3.2-3b smoke in
  fp32 with the reference's weights (``params_from_jax``; the port's ws
  decode step, the reference's jitted dense one).  Completed streams,
  counters and the per-replica history equal the reference's, and every
  stream equals the uninterrupted run's: no token emitted twice.
* the watchdog (``EngineFaultPlan``, ``step_deadline_s``,
  ``watchdog_cooldown``) on the unified engine at llama smoke fp32: poisoned
  steps redone on the split path and a blown deadline's cooldown, streams
  and degradations equal to the reference's, and no unified launch during a
  cooldown.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.chaos import EngineFaultPlan as JEngineFaultPlan  # noqa: E402
from repro.chaos import ReplicaCrashPlan as JReplicaCrashPlan  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import WorkStealingFrontend as JFrontend  # noqa: E402
from repro_torch.chaos import EngineFaultPlan, ReplicaCrashPlan  # noqa: E402
from repro_torch.configs.llama3_2_3b import SMOKE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

CAP = 32


@pytest.fixture(scope="module")
def model():
    cfg = get_config("llama3.2-3b", smoke=True)
    params = j_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, params, tp


class SeqLenBatcher:
    """The reference's deterministic stand-in (tests/test_chaos.py): token k
    of a request is ``len(prompt) + k``, so a resumed stream (prompt plus
    the tokens emitted, the remaining budget) continues exactly where the
    uninterrupted one would.  ``lazy`` keeps a finished request in its slot
    until the next step, so a crash can land on its completion boundary."""

    def __init__(self, slots=2, cap=64, lazy=False):
        self.B, self.cap, self.lazy = slots, cap, lazy
        self.live = [None] * slots

    @property
    def n_live(self):
        return sum(r is not None for r in self.live)

    def admit(self, req):
        if not 0 < len(req.tokens) < self.cap:
            return False
        try:
            slot = self.live.index(None)
        except ValueError:
            return False
        req.out.append(len(req.tokens))  # first token at admit
        self.live[slot] = req
        return True

    def step(self):
        done = []
        for i, r in enumerate(self.live):
            if r is None:
                continue
            full = len(r.out) >= r.max_new
            if not full:
                r.out.append(len(r.tokens) + len(r.out))
            if len(r.out) >= r.max_new and (full or not self.lazy):
                done.append(r)
                self.live[i] = None
        return done


def _batchers(kind, model, slots=2):
    """(port make_batcher, reference make_batcher) of one kind."""
    if kind == "seqlen":
        return (lambda: SeqLenBatcher(slots=slots)), (lambda: SeqLenBatcher(slots=slots))
    if kind == "lazy":
        return ((lambda: SeqLenBatcher(slots=slots, lazy=True)),
                (lambda: SeqLenBatcher(slots=slots, lazy=True)))
    cfg, params, tp = model
    return ((lambda: ContinuousBatcher(tp, SMOKE, slots=slots, capacity=CAP)),
            (lambda: JBatcher(params, cfg, slots=slots, capacity=CAP, use_ws=False)))


def _prompts(kind, n, lens):
    if kind != "llama":
        return {rid: np.arange(lens(rid), dtype=np.int32) for rid in range(n)}
    rng = np.random.default_rng(7)
    return {rid: rng.integers(0, SMOKE.vocab_size, lens(rid)).astype(np.int32)
            for rid in range(n)}


def _run(front_cls, req_cls, make, prompts, submit_to, max_new, n_replicas=2, plan=None):
    front = front_cls(make, n_replicas=n_replicas, crash_plan=plan)
    for rid, p in prompts.items():
        front.submit(submit_to(rid), req_cls(rid, p, max_new=max_new))
    done = front.run(max_iters=500)
    return {rid: list(r.out) for rid, r in done.items()}, front


def _both(kind, model, prompts, submit_to, max_new, crash, slots=2):
    """The same crash plan through the port's frontend and the reference's,
    and the port's uninterrupted run: ((streams, front) x 3)."""
    mine, theirs = _batchers(kind, model, slots)
    got = _run(WorkStealingFrontend, Request, mine, prompts, submit_to, max_new,
               plan=ReplicaCrashPlan(crash))
    want = _run(JFrontend, JRequest, theirs, prompts, submit_to, max_new,
                plan=JReplicaCrashPlan(crash))
    whole = _run(WorkStealingFrontend, Request, mine, prompts, submit_to, max_new)
    return got, want, whole


def _same_history(front, jfront):
    assert front.counters == jfront.counters
    assert front.per_replica == jfront.per_replica
    assert front.dead == jfront.dead and not front.rejected and not jfront.rejected


@pytest.mark.parametrize("kind", ["seqlen", "llama"])
def test_replica_crash_readmits_without_duplicate_tokens(kind, model, monkeypatch):
    prompts = _prompts(kind, 6, lambda rid: 3 + rid % 4)
    inflight = []
    crash = WorkStealingFrontend._crash

    def counting(self, rep):
        inflight.append(self.batchers[rep].n_live)
        crash(self, rep)

    monkeypatch.setattr(WorkStealingFrontend, "_crash", counting)
    (got, front), (want, jfront), (whole, _) = _both(kind, model, prompts, lambda r: r % 2, 5,
                                                     {0: 2})
    assert got == want == whole, "a resumed stream differs from the uninterrupted one"
    assert sorted(got) == list(prompts) and all(len(o) == 5 for o in got.values())
    for rid, r in front.completed.items():
        np.testing.assert_array_equal(np.asarray(r.tokens), prompts[rid])
    if kind == "seqlen":
        assert got == {rid: [len(p) + i for i in range(5)] for rid, p in prompts.items()}
    _same_history(front, jfront)
    assert front.counters["crashed"] == 1 and front.counters["dup_completed"] == 0
    assert inflight[0] >= 1 and front.counters["readmitted"] == inflight[0]
    assert front.dead == {0} and len(front.batchers) == 2


@pytest.mark.parametrize("kind", ["seqlen", "llama"])
def test_replica_crash_on_empty_engine_is_harmless(kind, model):
    prompts = _prompts(kind, 1, lambda rid: 2)
    (got, front), (want, jfront), (whole, _) = _both(kind, model, prompts, lambda r: 0, 3,
                                                     {1: 0}, slots=1)
    assert got == want == whole and sorted(got) == [0]
    _same_history(front, jfront)
    assert front.counters["crashed"] == 1 and front.counters["readmitted"] == 0


@pytest.mark.parametrize("kind", ["seqlen", "llama"])
def test_dead_replica_queue_remains_stealable(kind, model):
    """The crash kills the engine, not the queue: work submitted to the dead
    replica's queue is stolen and completed by the survivor."""
    prompts = _prompts(kind, 3, lambda rid: 2 + rid)
    (got, front), (want, jfront), (whole, _) = _both(kind, model, prompts, lambda r: 0, 3,
                                                     {0: 0})
    assert got == want == whole and sorted(got) == [0, 1, 2]
    _same_history(front, jfront)
    assert front.counters["stolen"] >= 3, "survivor stole from the dead queue"
    assert front.per_replica[0]["admitted"] == 0
    assert front.per_replica[1]["completed"] == 3


def test_crash_on_a_completion_boundary_completes_without_a_resume(model):
    """A crash that finds a request with its whole budget emitted completes
    it (the reference's boundary case) instead of readmitting it."""
    prompts = _prompts("lazy", 2, lambda rid: 4)
    (got, front), (want, jfront), (whole, _) = _both("lazy", model, prompts, lambda r: 0, 2,
                                                     {0: 1})
    assert got == want == whole == {rid: [4, 5] for rid in prompts}
    _same_history(front, jfront)
    assert front.counters["readmitted"] == 0 and front.counters["crashed"] == 1


def test_reassemble_splices_the_pre_crash_emission_back():
    f = WorkStealingFrontend(lambda: SeqLenBatcher(), n_replicas=1)
    f.submit(0, Request(3, np.array([1, 2, 3], np.int32), max_new=6))
    resumed = Request(3, np.array([1, 2, 3, 40, 41], np.int32), max_new=4, out=[42, 43])
    full = f._reassemble(resumed)
    np.testing.assert_array_equal(full.tokens, [1, 2, 3])
    assert full.out == [40, 41, 42, 43] and full.max_new == 6
    plain = Request(9, np.array([5], np.int32), out=[1])
    assert f._reassemble(plain) is plain


# ---------------------------------------------------------------------------
# the watchdog on the unified engine

def _requests(req_cls, max_new=3):
    return [req_cls(0, np.array([5, 6, 7, 8], np.int32), max_new=max_new),
            req_cls(1, np.array([9, 8, 7], np.int32), max_new=max_new)]


def _drain(b, reqs, iters=24):
    for r in reqs:
        assert b.admit(r)
    done = []
    for _ in range(iters):
        done += b.step()
        if not b.n_live:
            break
    assert not b.n_live
    return {r.rid: list(r.out) for r in done}


def _unified_calls(monkeypatch):
    """Record the step index of every unified launch the port's engine makes."""
    calls = []
    real = engine.decode_step_unified

    def counted(*a, **kw):
        calls.append(len(calls))
        return real(*a, **kw)

    monkeypatch.setattr(engine, "decode_step_unified", counted)
    return calls


def _kinds(b):
    return [(d["step"], d["kind"]) for d in b.degradations]


def test_watchdog_poisoned_logits_fall_back_like_the_reference(model, monkeypatch):
    """Poisoned (NaN) unified logits at steps 0 and 2: each step is redone
    on the split path, the streams equal the fault-free run's, and the
    degradations equal the reference's."""
    cfg, params, tp = model
    jb = JBatcher(params, cfg, slots=2, capacity=CAP, unified_step=True,
                  fault_plan=JEngineFaultPlan(poison_steps=(0, 2)))
    want = _drain(jb, _requests(JRequest))
    clean = _drain(ContinuousBatcher(tp, SMOKE, slots=2, capacity=CAP, unified_step=True),
                   _requests(Request))
    calls = _unified_calls(monkeypatch)
    b = ContinuousBatcher(tp, SMOKE, slots=2, capacity=CAP, unified_step=True,
                          fault_plan=EngineFaultPlan(poison_steps=(0, 2)))
    got = _drain(b, _requests(Request))
    assert got == want == clean
    assert _kinds(b) == _kinds(jb) == [(0, "non-finite"), (2, "non-finite")]
    assert b.stats()["degradations"] == jb.stats()["degradations"] == {"non-finite": 2}
    assert len(calls) == b.stats()["steps"], "a poisoned step still launched the unified step"


@pytest.mark.parametrize("cooldown", [1, 2])
def test_watchdog_deadline_routes_cooldown_steps_split_like_the_reference(model, monkeypatch,
                                                                          cooldown):
    """A blown deadline at step 1 sends the next ``cooldown`` steps straight
    to the split path (no unified launch), with one recorded degradation;
    the streams and degradations equal the reference's, and the unified
    launches resume after the cooldown."""
    cfg, params, tp = model
    kw = dict(step_deadline_s=120.0, watchdog_cooldown=cooldown)
    jb = JBatcher(params, cfg, slots=2, capacity=CAP, unified_step=True, **kw,
                  fault_plan=JEngineFaultPlan(slow_steps=(1,), added_latency_s=1e9))
    want = _drain(jb, _requests(JRequest, max_new=5))
    calls = _unified_calls(monkeypatch)
    b = ContinuousBatcher(tp, SMOKE, slots=2, capacity=CAP, unified_step=True, **kw,
                          fault_plan=EngineFaultPlan(slow_steps=(1,), added_latency_s=1e9))
    got = _drain(b, _requests(Request, max_new=5))
    steps = b.stats()["steps"]
    assert got == want
    assert _kinds(b) == _kinds(jb) == [(1, "deadline")]
    assert b._degraded_until == 2 + cooldown
    assert steps > 2 + cooldown
    # unified launches at every step but the cooldown's
    assert len(calls) == steps - cooldown


def test_watchdog_is_off_without_a_plan_or_deadline(model):
    *_, tp = model
    b = ContinuousBatcher(tp, SMOKE, slots=2, capacity=CAP, unified_step=True)
    assert b.step_deadline_s is None and b.fault_plan is None and b.watchdog_cooldown == 1
    _drain(b, _requests(Request))
    assert b.degradations == [] and b._degraded_until == -1
    assert torch.isfinite(b.caches.kv.k).all()
