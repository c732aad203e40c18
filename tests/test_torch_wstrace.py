"""The port's event rings and trace analyses (``repro_torch.wstrace``, the
ring branch of the scheduler) against the JAX package, on the same numpy
inputs: the reference in interpret mode, the port's plain walk in lockstep.

Lockstep rings are integer arrays, so ``events`` and ``ev_cursor`` must be
bit-equal, as must every scheduler array; the analyses over equal streams
(``summary``, ``family_counts``, the Perfetto export) must be equal too.
Free mode has no reference; its rings are held to the launch's own
counters.  Seeded slices, no sweeps."""

import dataclasses as dc
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import decode_step_unified as j_unified  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.moe_ws.dispatch import route_to_tasks as j_route  # noqa: E402
from repro.moe_ws.expert_kernel import run_moe_schedule as j_run_moe  # noqa: E402
from repro.pallas_ws.kernel import run_ws_schedule as j_run_ws  # noqa: E402
from repro.pallas_ws.queues import make_queue_state as j_make_state  # noqa: E402
from repro.pallas_ws.tasks import emit_flash_tasks as j_emit_flash  # noqa: E402
from repro.wstrace.perfetto import to_perfetto as j_to_perfetto  # noqa: E402
from repro.wstrace.ring import decode_rings as j_decode  # noqa: E402
from repro.wstrace.trace import WSTrace as JWSTrace  # noqa: E402
from repro_torch.chaos import SafetyChecker, single_launch  # noqa: E402
from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as KIMI  # noqa: E402
from repro_torch.configs.llama3_2_3b import SMOKE as LLAMA  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Caches, KVCache  # noqa: E402
from repro_torch.models.unified import decode_step_unified  # noqa: E402
from repro_torch.moe_ws import route_to_tasks, run_moe_schedule  # noqa: E402
from repro_torch.pallas_ws import (  # noqa: E402
    emit_flash_tasks,
    make_queue_state,
    run_ws_schedule,
)
from repro_torch.wstrace import (  # noqa: E402
    EV_COST,
    EV_KIND,
    EV_MULT,
    EV_PROG,
    EV_ROUND,
    EVENT_WIDTH,
    STEAL_KINDS,
    WSTrace,
    decode_rings,
    to_perfetto,
)

P = 3
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
SEED_CASES = [  # tests/test_wstrace.py: (T, E, k, bt, skewed to one expert)
    (12, 4, 1, 2, False),
    (24, 6, 2, 4, False),
    (24, 6, 1, 4, True),
]


def _assert_same_run(rj, rt, *, out_atol=1e-5):
    """Every integer array and both rings bit-equal; ``out`` to fp32 tolerance."""
    for n in INTS + ("events", "ev_cursor"):
        np.testing.assert_array_equal(getattr(rt, n).numpy(), np.asarray(getattr(rj, n)),
                                      err_msg=n)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=out_atol)


def _moe_problem(case, seed=0):
    T, E, k, bt, skew = case
    rng = np.random.RandomState(7)
    idx = (np.zeros((T, k), np.int32) if skew
           else rng.randint(0, E, size=(T, k)).astype(np.int32))
    gates = np.ones((T, k), np.float32)
    r = np.random.default_rng(seed)
    d, f = 4, 8
    x = r.standard_normal((T, d)).astype(np.float32)
    w = [(r.standard_normal(s) / 2).astype(np.float32) for s in ((E, d, f), (E, d, f), (E, f, d))]
    jt, jr = j_route(idx, gates, E, bt=bt)
    tt, tr = route_to_tasks(idx, gates, E, bt=bt)
    return (x, w, bt, j_make_state(jt, P, n_queues=E, partition="owner"), jr,
            make_queue_state(tt, P, n_queues=E, partition="owner"), tr)


def _moe_both(case, **kw):
    x, w, bt, js, jr, ts, tr = _moe_problem(case)
    rj = j_run_moe(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), bt=bt, **kw)
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          bt=bt, mode="lockstep", **kw)
    return js, rj, ts, rt


# ---------------------------------------------------------------------------
# decode


@pytest.mark.parametrize("seed", range(4))
def test_decode_rings_matches_reference(seed):
    """Random rings with partial fills and overflowed cursors: the same
    stream, in the same (round, program) order, and the same drops."""
    rng = np.random.RandomState(seed)
    n_programs, cap = rng.randint(1, 6), rng.randint(1, 9)
    events = rng.randint(0, 50, size=(n_programs, cap, EVENT_WIDTH)).astype(np.int32)
    cursor = rng.randint(0, 2 * cap + 1, size=(n_programs,)).astype(np.int32)
    s_j, d_j = j_decode(events, cursor)
    s_t, d_t = decode_rings(torch.from_numpy(events), torch.from_numpy(cursor))
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))


def test_decode_rings_empty_cursor():
    events = np.zeros((3, 4, EVENT_WIDTH), np.int32)
    stream, dropped = decode_rings(events, np.zeros(3, np.int32))
    s_j, d_j = j_decode(events, np.zeros(3, np.int32))
    assert stream.shape == np.asarray(s_j).shape == (0, EVENT_WIDTH)
    np.testing.assert_array_equal(dropped, np.asarray(d_j))


# ---------------------------------------------------------------------------
# lockstep rings, bit for bit


@pytest.mark.parametrize("policy", ["scan", "cost"])
@pytest.mark.parametrize("case", SEED_CASES)
def test_moe_lockstep_rings_match_reference(policy, case):
    js, rj, ts, rt = _moe_both(case, steal=True, steal_policy=policy, trace=True)
    _assert_same_run(rj, rt)
    stream, dropped = decode_rings(rt.events, rt.ev_cursor)
    assert int(dropped.sum()) == 0 and len(stream) == rt.extractions
    for p in range(P):  # the stream balances the launch's counters
        mine = stream[stream[:, EV_PROG] == p]
        assert mine[:, EV_COST].sum() == int(rt.work[p])
        assert np.isin(mine[:, EV_KIND], STEAL_KINDS).sum() == int(rt.steals[p])


def test_attention_lockstep_rings_match_reference():
    """Causal flash tiles over ragged rows (the rewind drill's problem)."""
    lengths = np.array([32, 8, 8, 16])
    H, hd, bq, bk = 2, 8, 8, 8
    B, S = len(lengths), int(max(lengths))
    r = np.random.default_rng(1)
    q, k, v = (r.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    js = j_make_state(j_emit_flash(lengths, H, bq, bk, causal=True), n_programs=4)
    ts = make_queue_state(emit_flash_tasks(lengths, H, bq, bk, causal=True), n_programs=4)
    rj = j_run_ws(js, *map(jnp.asarray, (q, k, v)), causal=True, bq=bq, bk=bk, trace=True)
    rt = run_ws_schedule(ts, *map(torch.from_numpy, (q, k, v)), causal=True, bq=bq, bk=bk,
                         trace=True, mode="lockstep")
    _assert_same_run(rj, rt)


def test_compressed_drain_rings_match_reference():
    """No thieves: each owner drains its queue in one grid cell, and every
    claim of the run is traced (capacity: the queue capacity)."""
    case = (18, 3, 1, 2, False)
    js, rj, ts, rt = _moe_both(case, steal=False, compress_runs=True, trace=True)
    _assert_same_run(rj, rt)
    assert rt.events.shape[1] == ts.capacity
    stream, _ = decode_rings(rt.events, rt.ev_cursor)
    assert len(stream) == rt.extractions and (stream[:, EV_KIND] == 0).all()


def test_overflowing_capacity_keeps_prefix_and_drop_count():
    js, rj, ts, rt = _moe_both((24, 6, 1, 2, True), steal=True, trace=True, trace_capacity=2)
    _assert_same_run(rj, rt)
    stream, dropped = decode_rings(rt.events, rt.ev_cursor)
    np.testing.assert_array_equal(dropped, np.asarray(j_decode(rj.events, rj.ev_cursor)[1]))
    assert int(dropped.sum()) > 0 and len(stream) + int(dropped.sum()) == rt.extractions
    assert WSTrace.from_run(ts, rt).summary()["dropped"] == int(dropped.sum())


def test_trace_off_is_unchanged():
    """trace=False: no rings, and the same arrays and out as a traced run."""
    x, w, bt, _, _, ts, tr = _moe_problem((24, 6, 2, 4, False), seed=1)
    runs = {t: run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                                bt=bt, mode="lockstep", trace=t) for t in (False, True)}
    assert runs[False].events is None and runs[False].ev_cursor is None
    for n in INTS + ("out",):
        assert torch.equal(getattr(runs[False], n), getattr(runs[True], n)), n


def test_trace_views_match_reference():
    """summary(), family_counts() and the Perfetto export of equal streams."""
    js, rj, ts, rt = _moe_both((24, 6, 1, 4, True), steal=True, trace=True)
    tj, tt = JWSTrace.from_run(js, rj), WSTrace.from_run(ts, rt)
    assert tt.summary() == tj.summary()
    assert tt.family_counts() == tj.family_counts() == {"expert": rt.extractions}
    np.testing.assert_array_equal(tt.utilization(), tj.utilization())
    np.testing.assert_array_equal(tt.per_queue_drain(), tj.per_queue_drain())
    assert json.loads(json.dumps(to_perfetto(tt))) == json.loads(json.dumps(j_to_perfetto(tj)))


# ---------------------------------------------------------------------------
# free mode: the rings hold the launch's own counters


@pytest.mark.parametrize("policy", ["scan", "cost"])
def test_free_mode_rings_balance_the_counters(policy):
    x, w, bt, _, _, ts, tr = _moe_problem((24, 6, 1, 4, True))
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          bt=bt, steal_policy=policy, mode="free", trace=True)
    assert rt.events.shape[1] == int(np.asarray(ts.tail).sum())  # default: Σtail
    stream, dropped = decode_rings(rt.events, rt.ev_cursor)
    assert int(dropped.sum()) == 0 and len(stream) == rt.extractions
    for p in range(P):
        mine = stream[stream[:, EV_PROG] == p]
        assert mine[:, EV_COST].sum() == int(rt.work[p])
        # EV_ROUND is the program's own clock: back to back from 0
        ends = np.cumsum(mine[:, EV_COST])
        np.testing.assert_array_equal(mine[:, EV_ROUND], ends - mine[:, EV_COST])
    assert (stream[:, EV_MULT] >= 1).all()
    report = SafetyChecker().check(single_launch(ts, rt), n_tasks=ts.n_tasks)
    assert report.ok and report.stats["mode"] == "free", report.summary()


# ---------------------------------------------------------------------------
# front ends: the unified step, moe_ffn_ws, ragged decode


CAP = 32


def _unified_case(arch):
    jcfg = get_config(arch, smoke=True)
    cfg = LLAMA
    if arch != "llama3.2-3b":
        jcfg = dc.replace(jcfg, moe_dispatch="ws")
        cfg = KIMI.replace(dtype="float32", moe_dispatch="ws")
    params = j_init(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.asarray(np.array([[5, 6, 7, 8], [9, 8, 7, 6]], np.int32))}
    _, caches = j_prefill(params, jcfg, batch, capacity=CAP)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, params, caches, cfg, tp


def _caches(jc):
    return Caches(kv=KVCache(torch.from_numpy(np.array(jc.kv.k)),
                             torch.from_numpy(np.array(jc.kv.v))))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "kimi-k2-1t-a32b"])
def test_unified_rings_match_reference(arch):
    """One lockstep launch, one ring stream holding every family's ops, bit
    for bit the reference's; free mode's per-stage streams in stage order
    are clean under the checker's free-mode reading."""
    jcfg, params, caches, cfg, tp = _unified_case(arch)
    tok, pos = np.array([[3], [4]], np.int32), np.array([4, 2], np.int32)
    _, _, rep_j = j_unified(params, jcfg, caches, jnp.asarray(tok), pos, trace=True)
    _, _, rep_t = decode_step_unified(tp, cfg, _caches(caches), torch.from_numpy(tok), pos,
                                      trace=True)
    for n in ("events", "ev_cursor"):
        np.testing.assert_array_equal(getattr(rep_t.res, n).numpy(),
                                      np.asarray(getattr(rep_j.res, n)), err_msg=n)
    stream_j, _ = j_decode(rep_j.res.events, rep_j.res.ev_cursor)
    np.testing.assert_array_equal(rep_t.trace_stream, np.asarray(stream_j))
    counts = WSTrace.from_run(rep_t.state, rep_t.res).family_counts()
    assert counts == JWSTrace.from_run(rep_j.state, rep_j.res).family_counts()
    want = {"attention", "step-glue"} | ({"expert"} if cfg.n_experts else set())
    assert set(counts) == want and sum(counts.values()) == rep_t.n_tasks

    _, _, rep_f = decode_step_unified(tp, cfg, _caches(caches), torch.from_numpy(tok), pos,
                                      trace=True, mode="free")
    stream = rep_f.trace_stream
    assert len(stream) == int(rep_f.res.mult.sum()) == int(rep_f.res.ev_cursor.sum())
    report = SafetyChecker().check(single_launch(rep_f.state, rep_f.res),
                                   n_tasks=rep_f.n_tasks)
    assert report.ok, report.summary()
    assert WSTrace.from_run(rep_f.state, rep_f.res).family_counts().keys() == counts.keys()


def test_moe_ffn_ws_and_ragged_decode_attach_the_trace():
    from repro_torch.models import init_params
    from repro_torch.moe_ws import moe_ffn_ws
    from repro_torch.pallas_ws import ragged_decode_attention

    cfg = KIMI.replace(dtype="float32")
    p = init_params(cfg, seed=0, device="cpu")["layers"]["moe"]
    p = {n: t[0] for n, t in p.items()}
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, _, stats = moe_ffn_ws(x, p, cfg, trace=True, return_stats=True, mode="lockstep")
    assert stats.trace.n_events == stats.extractions and stats.trace.n_steals == stats.steals
    with pytest.raises(ValueError, match="return_stats"):
        moe_ffn_ws(x, p, cfg, trace=True)

    r = np.random.default_rng(2)
    q = torch.from_numpy(r.standard_normal((3, 4, 16)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((3, 2, 40, 16)).astype(np.float32))
    _, rs = ragged_decode_attention(q, k, k, [40, 7, 19], n_programs=4, bk=8,
                                    return_stats=True, trace=True)
    assert rs.trace.n_events == rs.extractions
    assert rs.trace.family_counts() == {"attention": rs.extractions}
