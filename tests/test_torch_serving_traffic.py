"""The traffic mixes of ``tests/test_serving_traffic.py`` through the port's
engine (``repro_torch.serving``), on the CPU, at llama3.2-3b smoke in fp32
with the reference's weights (``params_from_jax``).

Each test of the reference's file runs on the port's ``ContinuousBatcher``
and ``WorkStealingFrontend``, and where the reference's engine gives token
streams the port's are compared with them on the same trace: the ``greedy``
flag, seeded sampling and sampled streams that diverge from greedy ones,
the admit boundary at cap - 1, cap and cap + 1 (split and unified engines),
rejections surfaced by the frontend, a seeded bursty arrival trace through
2 replicas (``benchmarks/serving_traffic.py``'s ``make_trace`` and
``replay``) replayed deterministically, and the unified engine's streams
against the split engine's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.serving.engine as jengine  # noqa: E402
from benchmarks.serving_traffic import make_trace, replay  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.configs.llama3_2_3b import SMOKE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend  # noqa: E402


@pytest.fixture(scope="module")
def model():
    cfg = get_config("llama3.2-3b", smoke=True)
    params = j_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, params, tp


def _pair(model, **kw):
    """A port batcher and a reference batcher built alike."""
    cfg, params, tp = model
    kw.setdefault("slots", 2)
    kw.setdefault("capacity", 16)
    return ContinuousBatcher(tp, SMOKE, **kw), jengine.ContinuousBatcher(params, cfg, **kw)


def _generate(b, req):
    assert b.admit(req)
    while b.n_live:
        b.step()
    return list(map(int, req.out))


def test_greedy_flag_selects_argmax(model):
    b, jb = _pair(model, greedy=True)
    logits = np.array([[0.0, 3.0, 1.0], [2.0, 0.0, 0.5]], np.float32)
    np.testing.assert_array_equal(b._select(logits), [1, 0])
    np.testing.assert_array_equal(b._select(logits), jb._select(logits))


def test_greedy_false_samples_with_seed(model):
    """Seeded sampling over a near-flat distribution: not all argmax, the
    same seed reproduces the stream (and the reference's), another differs."""
    logits = np.zeros((1, 50), np.float32)
    logits[0, 7] += 1e-3
    streams = {}
    for seed in (123, 123, 999):
        b, jb = _pair(model, greedy=False, temperature=1.0, sample_seed=seed)
        got = [int(b._select(logits)[0]) for _ in range(16)]
        assert got == [int(jb._select(logits)[0]) for _ in range(16)]
        streams.setdefault(seed, []).append(got)
    assert streams[123][0] == streams[123][1]
    assert any(t != 7 for t in streams[123][0])
    assert streams[999][0] != streams[123][0]


def test_greedy_sampled_streams_diverge_in_generation(model):
    """The same prompt greedy and hot-sampled: different continuations, each
    the reference engine's."""
    prompt = np.array([5, 6, 7], np.int32)
    out = {}
    for name, kw in (("greedy", dict(greedy=True)),
                     ("sampled", dict(greedy=False, temperature=8.0, sample_seed=7))):
        b, jb = _pair(model, **kw)
        out[name] = _generate(b, Request(0, prompt, max_new=4))
        assert out[name] == _generate(jb, jengine.Request(0, prompt, max_new=4)), name
    assert len(out["greedy"]) == len(out["sampled"]) == 4
    assert out["greedy"] != out["sampled"]


@pytest.mark.parametrize("unified", [False, True])
def test_admit_capacity_boundary(model, unified):
    """cap - 1 is the longest admissible prompt; cap, cap + 1 and an empty
    prompt are refused without taking a slot."""
    cap = 8
    b, jb = _pair(model, capacity=cap, unified_step=unified)
    for q, req_cls in ((b, Request), (jb, jengine.Request)):
        assert not q.admit(req_cls(1, np.arange(cap, dtype=np.int32)))
        assert not q.admit(req_cls(2, np.arange(cap + 1, dtype=np.int32)))
        assert not q.admit(req_cls(3, np.zeros(0, np.int32)))
        assert q.n_live == 0
        assert q.admit(req_cls(4, np.arange(1, cap, dtype=np.int32)))
        assert q.n_live == 1


def _frontends(model, make_kw, n_replicas=2):
    cfg, params, tp = model
    fe = WorkStealingFrontend(lambda: ContinuousBatcher(tp, SMOKE, **make_kw),
                              n_replicas=n_replicas)
    jfe = jengine.WorkStealingFrontend(lambda: jengine.ContinuousBatcher(params, cfg,
                                                                         **make_kw),
                                       n_replicas=n_replicas)
    return fe, jfe


def test_frontend_surfaces_rejections(model):
    cap = 8
    fe, jfe = _frontends(model, dict(slots=2, capacity=cap))
    for front, req_cls in ((fe, Request), (jfe, jengine.Request)):
        front.submit(0, req_cls(0, np.array([1, 2, 3], np.int32), max_new=2))
        front.submit(0, req_cls(1, np.arange(cap, dtype=np.int32), max_new=2))
        front.submit(1, req_cls(2, np.array([4, 5], np.int32), max_new=2))
    completed = fe.run(max_iters=100)
    jcompleted = jfe.run(max_iters=100)
    assert set(completed) == {0, 2}
    assert set(fe.rejected) == {1}
    stats = fe.stats()
    assert stats["totals"]["rejected"] == 1 and stats["totals"]["admitted"] == 2
    assert len(completed) == stats["totals"]["admitted"] - stats["totals"]["dup_completed"]
    assert {r: list(map(int, q.out)) for r, q in completed.items()} == \
        {r: list(map(int, q.out)) for r, q in jcompleted.items()}
    assert stats["totals"] == jfe.stats()["totals"]


def _replay(front, trace, monkeypatch, req_cls):
    """The reference's ``replay`` driving ``front`` with ``req_cls`` requests."""
    with monkeypatch.context() as m:
        m.setattr(jengine, "Request", req_cls)
        return replay(front, trace)


def test_seeded_trace_replay_deterministic(model, monkeypatch):
    """A seeded bursty trace (one request in five over capacity) through a
    fresh 2-replica frontend twice: every rid completed or rejected once,
    counters reconcile with the outcome, the outcome and streams repeat, and
    they equal the reference engine's on the same trace."""
    n_requests, cap = 5, 16
    trace = make_trace("bursty", n_requests, cap, 2, seed=11, max_new=2)
    kw = dict(slots=2, capacity=cap)
    rows = []
    for _ in range(2):
        fe, _ = _frontends(model, kw)
        rows.append((fe, _replay(fe, trace, monkeypatch, Request)))
    fe, row = rows[0]
    got = set(row["completed"]) | set(row["rejected"])
    assert got == set(range(n_requests)) and not set(row["completed"]) & set(row["rejected"])
    assert row["rejected"], "the trace's over-capacity request was admitted"
    stats = fe.stats()
    assert stats["totals"]["rejected"] == len(row["rejected"])
    assert len(row["completed"]) == stats["totals"]["admitted"] - \
        stats["totals"]["dup_completed"]
    assert sum(r["submitted"] for r in stats["per_replica"]) == n_requests
    assert row["steps"] == sum(s["steps"] for s in stats["batchers"] if s)
    assert all(len(out) == 2 for out in row["streams"].values())
    for key in ("streams", "completed", "rejected", "steps"):
        assert rows[1][1][key] == row[key], key
    _, jfe = _frontends(model, kw)
    jrow = _replay(jfe, trace, monkeypatch, jengine.Request)
    for key in ("streams", "completed", "rejected", "counters", "per_replica"):
        assert row[key] == jrow[key], key


def test_engine_unified_matches_split_streams(model):
    """The same 2-request load through the unified engine and the split one
    (the captured ws step): identical greedy streams, and the reference's."""
    prompts = [np.array([5, 6, 7, 8], np.int32), np.array([9, 8, 7], np.int32)]
    streams = {}
    for unified in (False, True):
        fe, jfe = _frontends(model, dict(slots=2, capacity=32, unified_step=unified,
                                         jit_ws=not unified), n_replicas=1)
        for front, req_cls, key in ((fe, Request, "port"), (jfe, jengine.Request, "ref")):
            for rid, p in enumerate(prompts):
                front.submit(0, req_cls(rid, p, max_new=3))
            done = front.run(max_iters=50)
            assert set(done) == {0, 1}
            streams[key, unified] = {rid: list(map(int, r.out)) for rid, r in done.items()}
    assert streams["port", True] == streams["port", False] == streams["ref", False] == \
        streams["ref", True]

