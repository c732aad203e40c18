"""The port's host shims of the device queue layout,
``repro_torch.pallas_ws.host.PallasWSHost`` and
``repro_torch.moe_ws.dispatch.MoEDispatchHost``, against the JAX package's,
on the CPU.

* A seeded sequence of put / put_segment / take / steal calls, with and
  without a ``FaultPlan`` setting both host fields (``drop_advisory_every``,
  ``stale_head_every``), gives the reference's results, snapshots,
  ``remaining``, trace events and ``faults_injected``.
* ``put_segment`` against a loop of ``put``; a full queue returns ``False``
  and raises under ``strict=True``, all-or-none.
* Seeded simulated schedules under a fault plan: the reference's records
  (its controller given the port's grant loop, as in
  ``tests/test_torch_core.py``) and weak multiplicity.
* The layout: each queue of the llama3.2-3b decode Put built by the device
  Put on the CPU, given to a shim by ``put_segment``, holds the same task
  slots, tail, trailing ⊥ slots, head, remaining and announcements, and
  drains every record (``chip_smoke.core_layout``, which the ``core`` phase
  runs on the card).
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.core as J  # noqa: E402
import repro.core.simulator as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.simulator as TS  # noqa: E402
from repro.chaos import FaultPlan as JFaultPlan  # noqa: E402
from repro.moe_ws.dispatch import MoEDispatchHost as JMoEHost  # noqa: E402
from repro.pallas_ws.host import PallasWSHost as JHost  # noqa: E402
from repro.pallas_ws.tasks import ExpertTask as JExpertTask  # noqa: E402
from repro_torch.chaos import FaultPlan  # noqa: E402
from repro_torch.moe_ws import MoEDispatchHost  # noqa: E402
from repro_torch.pallas_ws import ExpertTask, PallasWSHost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOSTS = {"pallas-ws": (PallasWSHost, JHost), "moe-ws": (MoEDispatchHost, JMoEHost)}
PLANS = {"no faults": {}, "both host faults": dict(drop_advisory_every=2, stale_head_every=3)}


def _payload(rng):
    """An opaque int (cost 1) or an encoded task record (cost in F_COST)."""
    if rng.random() < 0.5:
        return int(rng.integers(0, 1000))
    return tuple(int(x) for x in rng.integers(0, 6, size=8))


def _ops(seed, n=160):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            ops.append(("put", _payload(rng)))
        elif r < 0.45:
            ops.append(("put_segment", [_payload(rng) for _ in range(int(rng.integers(0, 6)))]))
        elif r < 0.7:
            ops.append(("take", None))
        else:
            ops.append(("steal", int(rng.integers(1, 4))))
    return ops


def _drive(q, ops, empty):
    seen = []
    for kind, arg in ops:
        if kind == "put":
            r = q.put(arg)
        elif kind == "put_segment":
            r = q.put_segment(arg)
        elif kind == "take":
            r = q.take()
        else:
            r = q.steal(arg)
        seen.append(("EMPTY" if r is empty else r, q.snapshot(), q.remaining_estimate()))
    return seen


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("host", list(HOSTS))
def test_call_sequence_matches_reference(host, seed, plan):
    ours, theirs = HOSTS[host]
    kw = PLANS[plan]
    q = ours(capacity=48, trace=True, fault_plan=FaultPlan(**kw) if kw else None)
    jq = theirs(capacity=48, trace=True, fault_plan=JFaultPlan(**kw) if kw else None)
    ops = _ops(seed)
    assert _drive(q, ops, T.EMPTY) == _drive(jq, ops, J.EMPTY)
    assert q.trace_events() == jq.trace_events()
    assert q.faults_injected == jq.faults_injected
    if kw:
        assert all(v > 0 for v in q.faults_injected.values())


def test_put_segment_matches_put_loop():
    xs = [(1, 0, 0, 0, 1, 64, i, 1 + i % 3) for i in range(10)]
    a, b, jb = PallasWSHost(capacity=32), PallasWSHost(capacity=32), JHost(capacity=32)
    for x in xs:
        assert a.put(x)
    assert b.put_segment(xs) and jb.put_segment(xs)
    assert a.snapshot() == b.snapshot() == jb.snapshot()
    assert a.remaining_estimate() == b.remaining_estimate() == jb.remaining_estimate() == \
        sum(x[7] for x in xs)
    assert a.tasks.a == b.tasks.a
    assert [b.take() for _ in xs] == xs
    assert b.take() is T.EMPTY


@pytest.mark.parametrize("host", list(HOSTS))
def test_full_queue_is_a_verdict(host):
    """A full queue: ``put`` and ``put_segment`` return False with nothing
    touched (capacity - 1 tasks at most) and raise under ``strict=True``,
    as the reference's."""
    ours, theirs = HOSTS[host]
    for cls, bottom in ((ours, T.BOTTOM), (theirs, J.BOTTOM)):
        q = cls(capacity=8)
        assert q.put_segment([]) and q.put_segment([1, 2, 3])
        assert not q.put_segment([4, 5, 6, 7, 8])
        assert q.tail == 3 and q.remaining_estimate() == 3
        accepted = 3
        while q.put(accepted + 1):
            accepted += 1
        assert accepted == q.capacity - 1
        assert q.snapshot() == (0, q.capacity - 1, {})
        with pytest.raises(RuntimeError):
            q.put(99, strict=True)
        with pytest.raises(RuntimeError):
            q.put_segment([99], strict=True)
        assert q.tasks.read(q.tail, q.OWNER) is bottom
        assert [q.take() for _ in range(accepted)] == list(range(1, accepted + 1))


def test_moe_put_tasks_matches_reference():
    tasks = [ExpertTask(expert=e % 3, row_start=4 * e, row_len=4, tid=e, cost=1 + e % 4)
             for e in range(12)]
    jtasks = [JExpertTask(expert=t.expert, row_start=t.row_start, row_len=t.row_len,
                          tid=t.tid, cost=t.cost) for t in tasks]
    a, b, ja = MoEDispatchHost(capacity=64), MoEDispatchHost(capacity=64), \
        JMoEHost(capacity=64)
    for t in tasks:
        assert a.put_task(t)
    assert b.put_tasks(tasks) and ja.put_tasks(jtasks)
    assert a.snapshot() == b.snapshot() == ja.snapshot()
    assert a.remaining_estimate() == b.remaining_estimate() == ja.remaining_estimate()
    assert [b.take() for _ in tasks] == [ja.take() for _ in tasks] == \
        [tuple(int(v) for v in t.encode()) for t in tasks]
    c = MoEDispatchHost(capacity=8)
    assert not c.put_tasks(tasks) and c.snapshot() == (0, 0, {})
    with pytest.raises(RuntimeError):
        c.put_tasks(tasks, strict=True)


class _ReferenceController(J.SimController):
    """The reference's controller with the port's grant loop."""

    run = T.SimController.run


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("host", list(HOSTS))
def test_sim_faults_match_reference(host, seed, monkeypatch):
    monkeypatch.setattr(JS, "SimController", _ReferenceController)
    ours, theirs = HOSTS[host]
    prog = {0: [("put", i) for i in range(1, 9)] + [("take", None)] * 5}
    for t in (1, 2, 3):
        prog[t] = [("steal", None)] * 5
    schedule = np.random.default_rng(seed).integers(0, 4, size=300).tolist()
    kw = PLANS["both host faults"]
    trec = TS.run_program(lambda b: ours(backend=b, capacity=64, fault_plan=FaultPlan(**kw)),
                          prog, schedule)
    jrec = JS.run_program(lambda b: theirs(backend=b, capacity=64,
                                           fault_plan=JFaultPlan(**kw)), prog, schedule)

    def plain(records, empty):
        return [(r.pid, r.kind, r.arg, "EMPTY" if r.result is empty else r.result, r.inv,
                 r.res) for r in records]

    assert plain(trec, T.EMPTY) == plain(jrec, J.EMPTY)
    TS.check_no_process_duplicates(trec)
    TS.check_no_lost_tasks_fifo(trec)


def test_layout_matches_the_device_put_on_cpu():
    """The ``core`` phase's layout check, on the CPU: every queue of the
    llama3.2-3b decode Put equal field for field, every record drained."""
    sys.path.insert(0, str(ROOT))
    chip_smoke = importlib.import_module("chip_smoke")
    out = chip_smoke.core_layout(torch.device("cpu"))
    assert len(out["queues"]) == chip_smoke.CORE["layout"]["P"]
    assert sum(q["tail"] for q in out["queues"]) == \
        chip_smoke.CORE["layout"]["B"] * chip_smoke.CORE["layout"]["H"]
    assert all(all(q["equal"].values()) for q in out["queues"])
