"""The port's copy of the paper's shared-memory algorithms
(``repro_torch.core``) against the JAX package's ``repro.core``, on the CPU.

* A repair: the reference's ``SimController.run`` decides the next step
  before the granted process has taken its grant (it still reads
  "at_gate"), so grants are overwritten and the same schedule gives other
  interleavings from run to run.  The port's controller waits for the grant
  to be taken: each shared access is one step, and a schedule fixes the
  records.
* A repair: the reference's THE Cilk Steal publishes H + 1 only after it
  has read T and decided, while its Take's fast path accepts h <= t, so a
  Take and a Steal can both return the last task (a schedule below shows
  it).  The port's Take takes the fast path only for h < t; the last task
  goes through the lock.  Its Steal, and so every record of a program in
  which the owner does not take, stay the reference's.
* For each of the 12 ``ALGORITHMS`` names, the same program and the same
  seeded schedule through the reference's ``run_program`` (its controller
  given the port's ``run`` loop, so its records are reproducible; its
  cells, gates and algorithms its own) and the port's give the same
  records (pid, kind, arg, result and the inv/res step stamps), the
  sentinels mapped (``repro.core.EMPTY`` to ``repro_torch.core.EMPTY``);
  the port's property checkers give the reference's verdicts on them.
* The registry's names, families and ``__all__`` equal the reference's.
* Sequential executions equal the reference's (and its exact oracles'),
  the storage schemes (infinite, growable, linked) under ``WSWMult`` and
  ``WSMult``, the max registers.
* Each algorithm on real threads (``ThreadBackend``) keeps its family's
  contract: multiplicity no process twice and nothing lost, exact each task
  once, idempotent each at least once.

Schedules are seeded numpy draws, a few a name; no sweeps.
"""

import sys
import threading

import numpy as np
import pytest

import repro.core as J
import repro.core.simulator as JS
import repro_torch.core as T
import repro_torch.core.simulator as TS

NAMES = sorted(T.ALGORITHMS)
SEEDS = (0, 1, 2)
CHECKERS = ("check_no_process_duplicates", "check_no_lost_tasks_fifo",
            "check_pairwise_concurrent_duplicates", "check_owner_fifo")


def _program(name):
    """pid -> ops.  THE Cilk's Steal holds a lock across shared steps, and a
    simulated step granted to a second locker would block the controller, so
    its program has one thief and an owner that never takes the lock (puts
    below the buffer's length)."""
    if name == "the-cilk":
        return {0: [("put", i) for i in range(1, 9)], 1: [("steal", None)] * 6}
    prog = {0: [("put", i) for i in range(1, 9)] + [("take", None)] * 5}
    for t in (1, 2, 3):
        prog[t] = [("steal", None)] * 5
    return prog


def _factory(pkg, name):
    make = pkg.ALGORITHMS[name]
    if name in ("ws-mult", "b-ws-mult"):
        return lambda backend: make(backend=backend, max_register="tree", capacity=64)
    if name in ("pallas-ws", "moe-ws"):
        return lambda backend: make(backend=backend, capacity=64)
    return lambda backend: make(backend=backend)


class _ReferenceController(J.SimController):
    """The reference's controller with the port's grant loop."""

    run = T.SimController.run


@pytest.fixture
def jsim(monkeypatch):
    monkeypatch.setattr(JS, "SimController", _ReferenceController)
    return JS


def _schedule(seed, n_procs, n=400):
    return np.random.default_rng(seed).integers(0, n_procs, size=n).tolist()


def _plain(records, empty):
    return [(r.pid, r.kind, r.arg, "EMPTY" if r.result is empty else r.result, r.inv, r.res)
            for r in records]


def _verdict(module, check, records):
    try:
        getattr(module, check)(records)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_sim_records_and_verdicts_match_reference(name, seed, jsim):
    prog = _program(name)
    schedule = _schedule(seed, len(prog))
    jrec = jsim.run_program(_factory(J, name), prog, schedule, timeout=20.0)
    trec = TS.run_program(_factory(T, name), prog, schedule, timeout=20.0)
    assert _plain(trec, T.EMPTY) == _plain(jrec, J.EMPTY)
    assert all(r.result is not J.EMPTY for r in trec)
    # the port's checkers on its records, the reference's on its own
    assert [_verdict(TS, c, trec) for c in CHECKERS] == \
        [_verdict(JS, c, jrec) for c in CHECKERS]
    assert len(TS.extractions(trec)) == len(JS.extractions(jrec))


def test_controller_grants_each_step_once(monkeypatch):
    """Every grant is one shared access of the granted process: the trace
    has one entry per gate passed, and a rerun gives the same records."""
    made, passed = [], []

    class Counting(T.SimController):
        def __init__(self, schedule):
            super().__init__(schedule)
            made.append(self)

        def gate(self, pid):
            super().gate(pid)
            if self.active:
                passed.append(pid)

    monkeypatch.setattr(TS, "SimController", Counting)
    prog = _program("ws-wmult")
    schedule = _schedule(5, len(prog))
    runs = [_plain(TS.run_program(_factory(T, "ws-wmult"), prog, schedule), T.EMPTY)
            for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]
    ctrl = made[-1]
    assert ctrl.trace == passed[-len(ctrl.trace):] and ctrl.step_no == len(ctrl.trace)
    # the last record's response stamp is the last step
    assert max(r[5] for r in runs[-1]) == ctrl.step_no


def test_the_cilk_last_task_goes_to_one_process(jsim):
    """Owner puts 1 (4 steps); the thief locks and reads H = 0, T = 1 (3
    steps); the owner's Take runs (the reference's returns at its 4th step,
    the port's restores T at its 5th); the thief finishes.  The reference
    hands the task to both, the port to the thief alone."""
    prog = {0: [("put", 1), ("take", None)], 1: [("steal", None)]}
    schedule = [0] * 4 + [1] * 3 + [0] * 5 + [1] * 2
    jrec = jsim.run_program(_factory(J, "the-cilk"), prog, schedule, timeout=20.0)
    trec = TS.run_program(_factory(T, "the-cilk"), prog, schedule, timeout=20.0)
    assert sorted(r.result for r in JS.extractions(jrec)) == [1, 1]
    assert [(r.kind, r.result) for r in TS.extractions(trec)] == [("steal", 1)]
    assert [r.result for r in trec if r.kind == "take"] == [T.EMPTY]


@pytest.mark.parametrize("name", ["ws-mult", "b-ws-mult"])
def test_atomic_max_register_records_match_reference(name, jsim):
    prog = _program(name)
    schedule = _schedule(9, len(prog))

    def make(pkg):
        return lambda backend: pkg.ALGORITHMS[name](backend=backend, max_register="atomic")

    assert _plain(TS.run_program(make(T), prog, schedule), T.EMPTY) == \
        _plain(jsim.run_program(make(J), prog, schedule), J.EMPTY)


def test_registry_matches_reference():
    assert sorted(T.ALGORITHMS) == sorted(J.ALGORITHMS)
    assert T.MULTIPLICITY_FAMILY == J.MULTIPLICITY_FAMILY
    assert T.EXACT_FAMILY == J.EXACT_FAMILY
    assert T.IDEMPOTENT_FAMILY == J.IDEMPOTENT_FAMILY
    assert sorted(T.__all__) == sorted(J.__all__)
    for name in T.__all__:
        assert hasattr(T, name), name
    # the shims come from the port's own modules
    assert type(T.ALGORITHMS["pallas-ws"]()).__module__ == "repro_torch.pallas_ws.host"
    assert type(T.ALGORITHMS["moe-ws"]()).__module__ == "repro_torch.moe_ws.dispatch"


SEQ_PROGRAMS = [
    [(0, "put", 1), (0, "put", 2), (0, "take", None), (1, "steal", None),
     (0, "take", None), (1, "steal", None)],
    [(0, "take", None), (1, "steal", None), (0, "put", 1), (1, "steal", None),
     (1, "steal", None), (0, "take", None)],
    [(0, "put", i) for i in range(1, 9)]
    + [(0, "take", None)] * 3 + [(1, "steal", None)] * 3 + [(2, "steal", None)] * 4,
]


def _seq_plain(out, empty):
    return [(p, k, a, "EMPTY" if r is empty else r) for p, k, a, r in out]


@pytest.mark.parametrize("name", NAMES)
def test_sequential_runs_match_reference(name):
    """Sequential executions: the port equals the reference, and both equal
    the reference's exact oracle (FIFO, owner-LIFO deque, or LIFO stack)."""
    for prog in SEQ_PROGRAMS:
        got = _seq_plain(TS.run_sequential(T.ALGORITHMS[name](), prog), T.EMPTY)
        want = _seq_plain(JS.run_sequential(J.ALGORITHMS[name](), prog), J.EMPTY)
        assert got == want
        if name in ("chase-lev", "the-cilk", "idempotent-deque"):
            oracle = TS.ExactLIFOOracle(steal_end="head")
        elif name == "idempotent-lifo":
            oracle = TS.ExactLIFOOracle(steal_end="tail")
        else:
            oracle = TS.ExactFIFOOracle()
        assert [g[3] for g in got] == [w[3] for w in _seq_plain(
            TS.run_sequential(oracle, prog), T.EMPTY)]


@pytest.mark.parametrize("name", ["ws-wmult", "ws-mult"])
@pytest.mark.parametrize("storage", ["infinite", "growable", "linked"])
def test_storage_schemes(name, storage):
    """§6: the finite-array schemes are drop-in replacements; a thousand
    puts force several expansions or node links."""
    kw = {"storage": storage}
    if storage == "growable":
        kw["initial_len"] = 8
    if storage == "linked":
        kw["node_len"] = 8
    if name == "ws-mult":
        kw["max_register"] = "atomic"
    outs = []
    for pkg in (T, J):
        q = pkg.ALGORITHMS[name](**kw)
        for i in range(1000):
            q.put(i)
        out = [q.take() for _ in range(500)]
        for i in range(1000, 1500):
            q.put(i)
        while (x := q.steal(1)) is not pkg.EMPTY:
            out.append(x)
        outs.append(out)
    assert outs[0] == outs[1] == list(range(1500))
    if storage == "growable":
        store = T.make_store("growable", initial_len=4)
        assert isinstance(store, T.GrowableStore)
        store.write(9, "x")
        assert store.read(9) == "x" and store.ref.read().size == 16
        assert store.read(40) is T.UNINIT


def test_max_registers_match_reference():
    rng = np.random.default_rng(3)
    tm, jm = T.TreeMaxRegister(capacity=100), J.TreeMaxRegister(capacity=100)
    assert tm.capacity == jm.capacity == 128
    am, ja = T.AtomicMaxRegister(init=1), J.AtomicMaxRegister(init=1)
    rm, jr = T.RangeMaxRegister(init=1), J.RangeMaxRegister(init=1)
    for v in rng.integers(0, 128, size=200).tolist():
        pid = v % 4
        for a, b in ((tm, jm), (am, ja)):
            a.max_write(v, pid)
            b.max_write(v, pid)
            assert a.max_read(pid) == b.max_read(pid)
        rm.rmax_write(v, pid)
        jr.rmax_write(v, pid)
        assert rm.rmax_read((pid + 1) % 4) == jr.rmax_read((pid + 1) % 4)
    with pytest.raises(ValueError):
        tm.max_write(128)


def _thread_drain(name, n_tasks=600, n_thieves=3):
    """1 owner (puts, a take every third put, then takes to empty) and
    ``n_thieves`` thieves stealing until the owner is done and 3 misses."""
    kw = {"capacity": n_tasks + 8} if name in ("pallas-ws", "moe-ws") else {}
    q = T.ALGORITHMS[name](**kw)
    results = {pid: [] for pid in range(n_thieves + 1)}
    stop = threading.Event()

    def owner():
        for i in range(n_tasks):
            assert q.put(i)
            if i % 3 == 0 and (x := q.take()) is not T.EMPTY:
                results[0].append(x)
        while (x := q.take()) is not T.EMPTY:
            results[0].append(x)
        stop.set()

    def thief(pid):
        misses = 0
        while not (stop.is_set() and misses >= 3):
            x = q.steal(pid)
            if x is T.EMPTY:
                misses += 1
            else:
                results[pid].append(x)
                misses = 0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=owner)] + [
            threading.Thread(target=thief, args=(p,)) for p in range(1, n_thieves + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), f"{name}: a thread did not finish"
    return results


@pytest.mark.parametrize("name", NAMES)
def test_thread_drain_keeps_family_contract(name):
    n = 600
    results = _thread_drain(name, n)
    every = [x for got in results.values() for x in got]
    assert set(every) == set(range(n)), f"{name} lost tasks"
    if name in T.MULTIPLICITY_FAMILY:
        for pid, got in results.items():
            assert len(got) == len(set(got)), f"{name}: process {pid} extracted a task twice"
    if name in T.EXACT_FAMILY:
        assert len(every) == n, f"{name} duplicated a task"
