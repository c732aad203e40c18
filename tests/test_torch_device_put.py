"""The device Put and the captured ws decode step (the reference's traced
Put and ``jit_decode_step_ws``) in the port, against the JAX package on the
same numpy inputs.

* Layouts: the decode family (``emit_decode_tasks_torch`` +
  ``owner_queue_candidates`` + ``make_queue_state_torch``) and the padded
  expert layout (``route_to_tasks_torch`` + ``expert_queue_candidates``)
  bit-equal, array for array, to the reference's traced Put built under
  ``jax.jit``; the shared pool's device state to ``make_pool_queue_state_jax``.
* Launches: a lockstep launch on each device-built state bit-equal to the
  reference's on its traced state (every integer array and ring; fp32
  outputs within 1e-5), and the padded case of the reference's half-run
  adversarial schedules (drawn head rewinds, under-provisioned relaunches).
* Entry points: ``ragged_decode_attention`` with tensor lengths against
  ``jax.jit`` of the reference's (a dead slot exactly 0), ``jit_decode_step_ws``
  at llama3.2-3b and kimi-k2 smoke (logits 1e-4, caches 1e-5, as the
  reference's own test), the batcher with ``jit_ws`` against the eager port
  and the JAX engine, ``ragged_slot_attention``, and the drain check read
  once a step (a cut lockstep budget raises there).

The ``cuda`` cases at the bottom hold the captured step to the eager
device-Put step on the card and need no JAX.
"""

import random

import numpy as np
import pytest
import torch

from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as T_KIMI
from repro_torch.configs.llama3_2_3b import SMOKE as T_LLAMA
from repro_torch.models import Caches, KVCache, decode_step_ws, init_params, prefill
from repro_torch.moe_ws import (
    combine_routed,
    divisor_from_tiles,
    expert_ffn_nodrop_ref,
    expert_queue_candidates,
    expert_rounds_bound,
    route_to_tasks,
    route_to_tasks_pool_torch,
    route_to_tasks_torch,
    row_divisor,
    run_moe_schedule,
)
from repro_torch.pallas_ws import (
    BOTTOM,
    decode_queue_state,
    decode_rounds_bound,
    emit_decode_tasks,
    emit_decode_tasks_torch,
    make_pool_queue_state,
    make_queue_state,
    make_queue_state_torch,
    owner_queue_candidates,
    ragged_decode_attention,
    ragged_decode_ref,
    run_ws_schedule,
)
from repro_torch.pallas_ws.tasks import F_TID
from repro_torch.serving import ContinuousBatcher, Request, jit_decode_step_ws
from repro_torch.serving import ragged_slot_attention

try:
    import jax
    import jax.numpy as jnp

    import repro.moe_ws as J_moe
    import repro.pallas_ws as J_ws
    from conftest import apply_rewind, drawn_rewind, resume_state
    from repro.pallas_ws.queues import make_queue_state_jax as j_make_queue_state
    from repro.pallas_ws.queues import owner_queue_candidates as j_owner_candidates
    from repro.pallas_ws.ragged import decode_rounds_bound as j_decode_rounds_bound
    from repro.pallas_ws.ragged import emit_decode_tasks_jax as j_emit_decode

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

P = 3  # programs: fewer than most drawn queue counts, so thieves roam
ATOL = 1e-5
STATE = ("tasks", "head", "tail", "local_head", "taken", "remaining")
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
RINGS = ("events", "ev_cursor")


def _rng_draws(seed):
    rng = random.Random(seed)
    return (lambda lo, hi: rng.randint(lo, hi)), (lambda: rng.random() < 0.5)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_state(sj, st, fields=STATE):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(st, f)), np.asarray(getattr(sj, f)),
                                      err_msg=f)
    assert st.n_tasks == sj.n_tasks


def _same_run(rj, rt, names=INTS + RINGS):
    for n in names:
        np.testing.assert_array_equal(_np(getattr(rt, n)), np.asarray(getattr(rj, n)),
                                      err_msg=n)
    np.testing.assert_allclose(_np(rt.out), np.asarray(rj.out), rtol=0, atol=ATOL)


def _clone(c):
    return Caches(kv=KVCache(c.kv.k.clone(), c.kv.v.clone()))


# ---------------------------------------------------------------------------
# the decode family's layout (tests/test_dispatch_conformance.py:409)


def _decode_draw(seed):
    draw_int, _ = _rng_draws(200 + seed)
    B, H = draw_int(1, 5), draw_int(1, 3)
    bk, nq = (4, 8)[draw_int(0, 1)], draw_int(1, 4)
    lengths = np.asarray([draw_int(0, 32) for _ in range(B)], dtype=np.int64)
    return B, H, bk, nq, lengths


def _jitted_state(build, *args):
    """A reference Put built under jax.jit (a QueueState is no JAX type: the
    jitted function returns its arrays; the eager build gives the static
    hint and must agree with the jitted one)."""
    fields = jax.jit(lambda *a: {f: getattr(build(*a), f) for f in STATE})(*args)
    st = build(*args)
    for f in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)), np.asarray(fields[f]))
        setattr(st, f, fields[f])
    return st


def _j_decode_state(lengths, H, bk, nq):
    def build(ln):
        records, live = j_emit_decode(ln, H, bk)
        cand, cand_live = j_owner_candidates(records, live, nq)
        return j_make_queue_state(cand, cand_live, P, n_tasks=len(lengths) * H)

    return _jitted_state(build, jnp.asarray(lengths))


def _t_decode_state(lengths, H, bk, nq):
    records, live = emit_decode_tasks_torch(torch.from_numpy(lengths), H, bk)
    cand, cand_live = owner_queue_candidates(records, live, nq)
    return make_queue_state_torch(cand, cand_live, P, n_tasks=len(lengths) * H)


@needs_jax
@pytest.mark.parametrize("seed", range(4))
def test_decode_layout_matches_reference_seeded(seed):
    """Every array of the device Put equals the reference's traced Put under
    jit, and its live prefixes are the host Put's records but for the tid
    (static b·H + h)."""
    B, H, bk, nq, lengths = _decode_draw(seed)
    sj = _j_decode_state(lengths, H, bk, nq)
    st = _t_decode_state(lengths, H, bk, nq)
    _same_state(sj, st)
    sh = make_queue_state(emit_decode_tasks(lengths, H, bk), P, n_queues=nq, partition="batch")
    tasks = st.tasks.numpy()
    for q in range(nq):
        n_q = int(sh.tail[q])
        assert int(st.tail[q]) == n_q
        cols = [c for c in range(tasks.shape[-1]) if c != F_TID]
        np.testing.assert_array_equal(tasks[q, :n_q][:, cols], sh.tasks[q, :n_q][:, cols])
        np.testing.assert_array_equal(tasks[q, :n_q, F_TID],
                                      tasks[q, :n_q, 1] * H + tasks[q, :n_q, 2])
        assert (tasks[q, n_q:, 0] == BOTTOM).all()


def test_decode_queue_state_device_put_refuses_other_partitions():
    with pytest.raises(ValueError, match="batch row"):
        decode_queue_state(torch.tensor([3, 1]), 2, 8, partition="round_robin")


# ---------------------------------------------------------------------------
# the padded expert layout (tests/test_dispatch_conformance.py:167)


def _routing_from(draw_int):
    E = draw_int(2, 5)
    T = draw_int(1, 10)
    k = draw_int(1, min(2, E))
    bt = (2, 4)[draw_int(0, 1)]
    seed = draw_int(0, 2**16)
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    return E, T, k, bt, seed, idx, gates


def _j_padded(idx, gates, E, bt, n_queues):
    def build(i, g):
        records, live, routed = J_moe.route_to_tasks_jax(i, g, E, bt=bt)
        cand, cand_live = J_moe.expert_queue_candidates(records, live, n_queues)
        return records, live, routed, cand, cand_live

    records, live, routed, cand, cand_live = jax.jit(build)(jnp.asarray(idx),
                                                            jnp.asarray(gates))
    state = j_make_queue_state(cand, cand_live, P, n_tasks=records.shape[0] * records.shape[1])
    return records, live, routed, state


def _t_padded(idx, gates, E, bt, n_queues):
    records, live, routed = route_to_tasks_torch(torch.from_numpy(idx),
                                                 torch.from_numpy(gates), E, bt=bt)
    cand, cand_live = expert_queue_candidates(records, live, n_queues)
    state = make_queue_state_torch(cand, cand_live, P,
                                   n_tasks=records.shape[0] * records.shape[1])
    return records, live, routed, state


@needs_jax
@pytest.mark.parametrize("cap_over_T", [1, 5, 12], ids=["T+1", "T+5", "T*k"])
def test_padded_layout_with_repeated_experts_matches_reference(cap_over_T):
    """A routing that repeats an expert among a token's k choices (expert 1
    takes 13 of the 18 pairs, past T = 6 rows), with ``max_expert_load``
    between T + 1 and T·k: the padded Put against the reference's traced
    one under jit, every array bit-equal (at T + 1 and T + 5 the pairs past
    the provisioned rows are dropped by the mask in both)."""
    E, T, k, bt = 4, 6, 3, 2
    idx = np.array([[1, 1, 2], [1, 1, 1], [0, 1, 1], [3, 1, 1], [1, 2, 1], [1, 1, 0]],
                   dtype=np.int32)
    gates = np.random.default_rng(3).uniform(0.1, 1.0, (T, k)).astype(np.float32)
    cap = T + cap_over_T
    assert T < cap <= T * k and int((idx == 1).sum()) > T

    def build(i, g):
        return J_moe.route_to_tasks_jax(i, g, E, bt=bt, max_expert_load=cap)

    rj, lj, routed_j = jax.jit(build)(jnp.asarray(idx), jnp.asarray(gates))
    rt, lt, routed_t = route_to_tasks_torch(torch.from_numpy(idx), torch.from_numpy(gates),
                                            E, bt=bt, max_expert_load=cap)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for f in ("tok_idx", "gates", "row_src", "loads", "expert_off"):
        np.testing.assert_array_equal(_np(getattr(routed_t, f)),
                                      np.asarray(getattr(routed_j, f)), err_msg=f)
    assert routed_t.n_rows == routed_j.n_rows == E * -(-cap // bt) * bt


@needs_jax
@pytest.mark.parametrize("seed", range(4))
def test_padded_expert_layout_matches_reference_seeded(seed):
    """route_to_tasks_torch + expert_queue_candidates + make_queue_state_torch
    against the reference's traced Put under jit, per-expert queues and the
    static baseline's program queues: every array bit-equal, the routed rows
    too, and the tails the host Put's."""
    draw_int, _ = _rng_draws(seed)
    E, T, k, bt, _, idx, gates = _routing_from(draw_int)
    for n_queues in (E, P):
        rj, lj, routed_j, sj = _j_padded(idx, gates, E, bt, n_queues)
        rt, lt, routed_t, st = _t_padded(idx, gates, E, bt, n_queues)
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        _same_state(sj, st)
        for f in ("tok_idx", "gates", "row_src", "loads", "expert_off"):
            np.testing.assert_array_equal(_np(getattr(routed_t, f)),
                                          np.asarray(getattr(routed_j, f)), err_msg=f)
        assert routed_t.n_rows == routed_j.n_rows
    _, routed_h = route_to_tasks(idx, gates, E, bt=bt)
    sh = make_queue_state(route_to_tasks(idx, gates, E, bt=bt)[0], P, n_queues=E,
                          partition="owner")
    np.testing.assert_array_equal(_t_padded(idx, gates, E, bt, E)[3].tail.numpy(), sh.tail)
    np.testing.assert_array_equal(routed_t.loads.numpy(), routed_h.loads)


# ---------------------------------------------------------------------------
# lockstep launches on each device-built state


def _weights(seed, T, E, d=4, f=8):
    r = np.random.default_rng(100 + seed)
    x = r.standard_normal((T, d)).astype(np.float32)
    w = [(r.standard_normal(s) / 2).astype(np.float32) for s in ((E, d, f), (E, d, f), (E, f, d))]
    return x, w


@needs_jax
@pytest.mark.parametrize("seed", range(2))
def test_decode_lockstep_launch_on_device_put_matches_reference(seed):
    B, H, bk, nq, lengths = _decode_draw(seed)
    nq = P  # decode_rounds_bound's batch-row queues
    S, hd = 32, 8
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, hd)).astype(np.float32)
    k = rng.standard_normal((B, 1, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, 1, S, hd)).astype(np.float32)
    rounds = decode_rounds_bound(B, H, S, bk, nq, P, True)
    assert rounds == j_decode_rounds_bound(B, H, S, bk, nq, P, True)
    kw = dict(causal=False, bq=1, bk=bk, rounds=rounds, trace=True)
    rj = J_ws.run_ws_schedule(_j_decode_state(lengths, H, bk, nq), jnp.asarray(q),
                              jnp.asarray(k), jnp.asarray(v), **kw)
    rt = run_ws_schedule(_t_decode_state(lengths, H, bk, nq), torch.from_numpy(q),
                         torch.from_numpy(k), torch.from_numpy(v), mode="lockstep", **kw)
    _same_run(rj, rt)
    live = np.repeat(lengths > 0, H)
    assert (rt.mult.numpy()[live] >= 1).all() and (rt.mult.numpy()[~live] == 0).all()


@needs_jax
@pytest.mark.parametrize("layout", ["padded", "pool"])
@pytest.mark.parametrize("seed", range(2))
def test_expert_lockstep_launch_on_device_put_matches_reference(seed, layout):
    draw_int, _ = _rng_draws(300 + seed)
    E, T, k, bt, wseed, idx, gates = _routing_from(draw_int)
    x, w = _weights(wseed, T, E)
    if layout == "pool":
        jr = J_moe.route_to_tasks_pool_jax(jnp.asarray(idx), jnp.asarray(gates), E, bt=bt)
        sj = J_ws.make_pool_queue_state_jax(*jr[:3], jr[3].loads, P, n_tasks=jr[0].shape[0])
        tr = route_to_tasks_pool_torch(torch.from_numpy(idx), torch.from_numpy(gates), E,
                                       bt=bt)
        st = make_pool_queue_state(*tr[:3], tr[3].loads, P, n_tasks=tr[0].shape[0])
        assert isinstance(st.tasks, torch.Tensor) and isinstance(st.pool_off, torch.Tensor)
        _same_state(sj, st, STATE + ("pool_off",))
        routed_j, routed_t = jr[3], tr[3]
    else:
        _, _, routed_j, sj = _j_padded(idx, gates, E, bt, E)
        _, _, routed_t, st = _t_padded(idx, gates, E, bt, E)
    rounds = expert_rounds_bound(T * k, bt, E, P, True)
    kw = dict(bt=bt, rounds=rounds, trace=True)
    rj = J_moe.run_moe_schedule(sj, jnp.asarray(x), routed_j.tok_idx,
                                *map(jnp.asarray, w), **kw)
    rt = run_moe_schedule(st, torch.from_numpy(x), routed_t.tok_idx,
                          *map(torch.from_numpy, w), mode="lockstep", **kw)
    _same_run(rj, rt)
    y = combine_routed(routed_t, None, rt, bt=bt)
    ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_divisor_from_tiles_tensor_matches_numpy():
    mult = np.array([0, 1, 3, 2, 0], dtype=np.int32)
    starts = np.arange(5) * 4
    want = divisor_from_tiles(starts, np.full(5, 4), mult, 24)
    got = divisor_from_tiles(torch.from_numpy(starts), 4, torch.from_numpy(mult), 24)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the padded case of test_adversarial_schedules_halfrun_seeded
# (tests/test_dispatch_conformance.py:520; the pool case is
# tests/test_torch_halfrun.py's)


def _moe_both(js, jr, ts, tr, x, w, bt, *, jout=None, tout=None, jmult=None, tmult=None,
              **kw):
    rj = J_moe.run_moe_schedule(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), bt=bt,
                                out=jout, mult=jmult, **kw)
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          bt=bt, mode="lockstep", out=tout, mult=tmult, **kw)
    _same_run(rj, rt, INTS)
    return rj, rt


def _resync(js, ts):
    """The port's state takes the reference's drilled (mutated) arrays."""
    for f in ("head", "local_head", "taken", "remaining"):
        setattr(ts, f, np.array(getattr(js, f)))


@needs_jax
@pytest.mark.parametrize("seed", range(2))
def test_adversarial_schedules_halfrun_padded_seeded(seed):
    """The host Put and the padded device Put under cap 4 through drawn
    head-rewind relaunches (some under-provisioned): every launch bit-equal
    to the reference's, the two layouts slot for slot the same schedule,
    normalised rows bit-identical per expert and the combine at the
    oracle."""
    draw_int, draw_bool = _rng_draws(900 + seed)
    E, T, k, bt, wseed, idx, gates = _routing_from(draw_int)
    x, w = _weights(wseed, T, E)
    jt, jrh = J_moe.route_to_tasks(idx, gates, E, bt=bt)
    tt, trh = route_to_tasks(idx, gates, E, bt=bt)
    jh = J_ws.make_queue_state(jt, P, n_queues=E, partition="owner")
    th = make_queue_state(tt, P, n_queues=E, partition="owner")
    _, _, jrp, jp = _j_padded(idx, gates, E, bt, E)
    for f in STATE:  # the drills mutate the reference's arrays: numpy
        setattr(jp, f, np.asarray(getattr(jp, f)).copy())
    _, _, trp, tp = _t_padded(idx, gates, E, bt, E)
    rounds = expert_rounds_bound(T * k, bt, E, P, True, steal_run_cap=4)
    kw = dict(steal_policy="cost", steal_run_cap=4)
    rh = _moe_both(jh, jrh, th, trh, x, w, bt, rounds=rounds, **kw)
    rp = _moe_both(jp, jrp, tp, trp, x, w, bt, rounds=rounds, **kw)
    for _ in range(draw_int(1, 2)):
        np.testing.assert_array_equal(rh[1].head.numpy(), rp[1].head.numpy())
        spec = drawn_rewind(jh, rh[0], draw_int, draw_bool, heads=np.asarray(rh[0].head))
        resume_state(jp, rp[0])
        apply_rewind(jp, spec)
        _resync(jh, th)
        _resync(jp, tp)
        r = draw_int(1, rounds)
        rh = _moe_both(jh, jrh, th, trh, x, w, bt, rounds=r, jout=rh[0].out, tout=rh[1].out,
                       jmult=jnp.asarray(rh[0].mult), tmult=rh[1].mult, **kw)
        rp = _moe_both(jp, jrp, tp, trp, x, w, bt, rounds=r, jout=rp[0].out, tout=rp[1].out,
                       jmult=jnp.asarray(rp[0].mult), tmult=rp[1].mult, **kw)
    resh, resp = rh[1], rp[1]
    for f in ("head", "clock", "work", "steals"):
        np.testing.assert_array_equal(getattr(resh, f).numpy(), getattr(resp, f).numpy(),
                                      err_msg=f)
    loads = np.bincount(idx.reshape(-1), minlength=E)
    tiles_per_e = -(-min(T, T * k) // bt)
    remap = np.concatenate([e * tiles_per_e + np.arange(-(-int(n) // bt))
                            for e, n in enumerate(loads)]).astype(np.int64)
    mult_h = resh.mult.numpy()[: th.n_tasks]
    np.testing.assert_array_equal(mult_h, resp.mult.numpy()[remap])
    assert (mult_h >= 1).all()
    dead = np.setdiff1d(np.arange(resp.mult.shape[0]), remap)
    assert (resp.mult.numpy()[dead] == 0).all()
    yh = resh.out.numpy() / row_divisor(tt, resh.mult.numpy(), trh.n_rows)[:, None]
    yp = (resp.out / divisor_from_tiles(torch.arange(resp.mult.shape[0]) * bt, bt, resp.mult,
                                        trp.n_rows)[:, None]).numpy()
    for e in range(E):
        a, b = int(trh.expert_off[e]), int(trp.expert_off[e])
        np.testing.assert_array_equal(yh[a:a + loads[e]], yp[b:b + loads[e]])
    ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
    for routed, tasks, res in ((trh, tt, resh), (trp, None, resp)):
        y = combine_routed(routed, tasks, res, bt=bt)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# ragged decode with tensor lengths (tests/test_traced_dispatch.py:215) and
# ragged_slot_attention (tests/test_serving_ws.py:152)


SLOT_LENGTHS = np.array([32, 0, 8, 16])  # slot 1 is free


def _slot_inputs(seed=3, B=4, H=2, S=32, hd=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, H, S, hd), (B, H, S, hd))]


@needs_jax
@pytest.mark.parametrize("mode", ["free", "lockstep"])
def test_ragged_decode_tensor_lengths_matches_jitted_reference(mode):
    q, k, v = _slot_inputs()
    want = jax.jit(lambda ln: J_ws.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ln, schedule="ws", bk=8))(
            jnp.asarray(SLOT_LENGTHS))
    got = ragged_decode_attention(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(SLOT_LENGTHS), schedule="ws", bk=8,
                                  mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    host = ragged_decode_attention(*map(torch.from_numpy, (q, k, v)), SLOT_LENGTHS,
                                   schedule="ws", bk=8, mode=mode)
    np.testing.assert_allclose(got.numpy(), host.numpy(), rtol=0, atol=ATOL)
    assert float(got[1].abs().max()) == 0.0  # the dead slot stays exactly 0


def test_ragged_decode_tensor_lengths_refuses_telemetry():
    q, k, v = map(torch.from_numpy, _slot_inputs())
    for kw in (dict(return_stats=True), dict(trace=True)):
        with pytest.raises(ValueError, match="host lengths"):
            ragged_decode_attention(q, k, v, torch.from_numpy(SLOT_LENGTHS), bk=8, **kw)


@needs_jax
def test_ragged_slot_attention_matches_reference():
    from repro.serving import ragged_slot_attention as j_ragged_slot

    q, k, v = _slot_inputs()
    want = np.asarray(j_ragged_slot(*map(jnp.asarray, (q, k, v)), SLOT_LENGTHS,
                                    schedule="ws", bk=8))
    ref = ragged_decode_ref(*map(torch.from_numpy, (q, k, v)), SLOT_LENGTHS).numpy()
    for lengths in (SLOT_LENGTHS, torch.from_numpy(SLOT_LENGTHS)):
        got = ragged_slot_attention(*map(torch.from_numpy, (q, k, v)), lengths, bk=8)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_ragged_slot_attention_reads_a_batchers_live_lengths():
    cfg = T_LLAMA
    b = ContinuousBatcher(init_params(cfg, seed=0, device="cpu"), cfg, slots=4, capacity=32,
                          attn_schedule="static")
    assert b.admit(Request(0, np.arange(1, 6, dtype=np.int32), max_new=4))
    assert b.admit(Request(1, np.arange(1, 4, dtype=np.int32), max_new=4))
    np.testing.assert_array_equal(b.live_lengths(), [5, 3, 0, 0])
    q, k, v = map(torch.from_numpy, _slot_inputs())
    got = ragged_slot_attention(q, k, v, b, bk=8)
    want = ragged_decode_attention(q, k, v, [5, 3, 0, 0], schedule="static", bk=8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# jit_decode_step_ws (tests/test_traced_dispatch.py:192) and the batcher
# (:240), at llama3.2-3b and kimi-k2 smoke


@pytest.fixture(scope="module")
def models():
    if not HAVE_JAX:
        pytest.skip("the reference needs JAX")
    from repro.configs.kimi_k2_1t_a32b import SMOKE as J_KIMI
    from repro.configs.llama3_2_3b import SMOKE as J_LLAMA
    from repro.models import init_params as j_init
    from repro.models import prefill as j_prefill
    from repro_torch.convert import params_from_jax

    out = {}
    for name, jcfg, tcfg, key in (("llama", J_LLAMA, T_LLAMA, 0),
                                  ("kimi", J_KIMI.replace(moe_dispatch="ws"),
                                   T_KIMI.replace(moe_dispatch="ws"), 2)):
        jp = j_init(jax.random.PRNGKey(key), jcfg)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        toks = np.array([[5, 6, 7, 8], [9, 8, 7, 6]], np.int32)
        _, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, capacity=32)
        _, tc = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, capacity=32)
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jc=jc, tc=tc)
    return out


@needs_jax
@pytest.mark.parametrize("name", ["llama", "kimi"])
def test_jit_decode_step_ws_matches_reference(models, name):
    from repro.serving.engine import jit_decode_step_ws as j_jit_step

    m = models[name]
    tok = np.array([[3], [4]], np.int32)
    pos = np.array([4, 2], np.int32)  # heterogeneous slots
    jl, jc = j_jit_step(m["jcfg"])(m["jp"], m["jc"], jnp.asarray(tok), jnp.asarray(pos))
    step = jit_decode_step_ws(m["tcfg"])
    tl, tc = step(m["tp"], _clone(m["tc"]), tok.astype(np.int64), pos)
    step.check_drained()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.kv.v.numpy(), np.asarray(jc.kv.v), rtol=1e-5, atol=1e-5)
    # the host-Put step on the same caches: the same tiles, the same numbers
    hl, _ = decode_step_ws(m["tp"], m["tcfg"], _clone(m["tc"]), torch.from_numpy(tok).long(),
                           pos)
    np.testing.assert_array_equal(tl.numpy(), hl.numpy())


def _serve(b, steps=10):
    b.admit(Request(0, np.array([5, 6, 7], np.int32), max_new=4))
    b.admit(Request(1, np.array([9, 8], np.int32), max_new=4))
    done = []
    for _ in range(steps):
        done += b.step()
        if not b.n_live:
            break
    return {r.rid: list(r.out) for r in done}


@needs_jax
@pytest.mark.parametrize("name", ["llama", "kimi"])
def test_batcher_jit_ws_streams_match_eager_and_reference(models, name):
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest

    m = models[name]
    got = {}
    for jit_ws in (False, True):
        b = ContinuousBatcher(m["tp"], m["tcfg"], slots=2, capacity=32, jit_ws=jit_ws)
        assert b.use_ws and (b._jit is not None) == jit_ws
        got[jit_ws] = _serve(b)
    jb = JBatcher(m["jp"], m["jcfg"], slots=2, capacity=32, jit_ws=True)
    jb.admit(JRequest(0, np.array([5, 6, 7], np.int32), max_new=4))
    jb.admit(JRequest(1, np.array([9, 8], np.int32), max_new=4))
    want = []
    for _ in range(10):
        want += jb.step()
        if not jb.n_live:
            break
    assert got[True] == got[False] == {r.rid: list(r.out) for r in want}
    assert sorted(got[True]) == [0, 1] and all(len(o) == 4 for o in got[True].values())


# ---------------------------------------------------------------------------
# the drain check, read once a step


def _cut_rounds(monkeypatch):
    """Every device-Put lockstep launch gets no round at all (one round can
    drain a smoke step: 8 programs, 8 one-block tasks)."""
    from repro_torch.moe_ws import layer
    from repro_torch.pallas_ws import ragged

    monkeypatch.setattr(ragged, "decode_rounds_bound", lambda *a, **kw: 0)
    monkeypatch.setattr(layer, "expert_rounds_bound", lambda *a, **kw: 0)


def _smoke_step(cfg, dev="cpu"):
    params = init_params(cfg, seed=0, device=dev)
    toks = torch.tensor([[5, 6, 7, 8, 9], [9, 8, 7, 6, 5]], device=dev)
    _, caches = prefill(params, cfg, {"tokens": toks}, capacity=32)
    return params, caches, np.array([[3], [4]], np.int64), np.array([5, 4], np.int32)


@pytest.mark.parametrize("cfg", [T_LLAMA, T_KIMI.replace(moe_dispatch="ws")],
                         ids=["llama", "kimi"])
def test_under_provisioned_step_raises_at_its_one_read(monkeypatch, cfg):
    """A cut lockstep budget leaves live tasks unexecuted: the eager
    device-Put step raises at its end, the stand-in at check_drained, never
    inside a launch; with the bound the same step passes."""
    params, caches, tok, pos = _smoke_step(cfg)
    decode_step_ws(params, cfg, _clone(caches), torch.from_numpy(tok), torch.from_numpy(pos),
                   mode="lockstep")
    step = jit_decode_step_ws(cfg, mode="lockstep")
    step(params, _clone(caches), tok, pos)
    step.check_drained()
    _cut_rounds(monkeypatch)
    with pytest.raises(RuntimeError, match="under-provisioned"):
        decode_step_ws(params, cfg, _clone(caches), torch.from_numpy(tok),
                       torch.from_numpy(pos), mode="lockstep")
    logits, _ = step(params, _clone(caches), tok, pos)  # the launches themselves pass
    assert logits.shape == (2, cfg.padded_vocab)
    with pytest.raises(RuntimeError, match="under-provisioned"):
        step.check_drained()
    step(params, _clone(caches), tok, pos)
    with pytest.raises(RuntimeError, match="under-provisioned"):  # an unread step, next call
        step(params, _clone(caches), tok, pos)


# ---------------------------------------------------------------------------
# the captured step on a card (no JAX)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CFGS = [T_LLAMA, T_LLAMA.replace(dtype="bfloat16"), T_KIMI.replace(moe_dispatch="ws")]
CARD_IDS = ["llama-fp32", "llama-bf16", "kimi-fp32"]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CARD_CFGS, ids=CARD_IDS)
def test_replayed_step_equals_eager_device_put_step_on_card(cuda_device, cfg):
    """The first call (eager, then the capture) and a replay on the same
    caches restored in place: logits and caches equal to the eager
    device-Put step's (bit for bit on llama; the MoE combine's index_add_
    order is not fixed), ws_attention launches L a call."""
    from repro_torch.pallas_ws import launches, reset_launches

    params, caches, tok, pos = _smoke_step(cfg, cuda_device)
    want_l, want_c = decode_step_ws(params, cfg, _clone(caches), torch.from_numpy(tok).cuda(),
                                    torch.from_numpy(pos).cuda())
    mine = _clone(caches)
    step = jit_decode_step_ws(cfg)
    reset_launches()
    for _ in range(3):
        mine.kv.k.copy_(caches.kv.k)
        mine.kv.v.copy_(caches.kv.v)
        got_l, got_c = step(params, mine, tok, pos)
        step.check_drained()
        if cfg.family == "moe":
            torch.testing.assert_close(got_l, want_l, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got_c.kv.k, want_c.kv.k, rtol=0, atol=0)
        else:
            assert torch.equal(got_l, want_l) and torch.equal(got_c.kv.k, want_c.kv.k)
    assert launches["ws_attention"] == 3 * cfg.n_layers
    assert launches["ws_expert"] == (3 * cfg.n_layers if cfg.family == "moe" else 0)


@pytest.mark.cuda
def test_replay_sees_a_spliced_admission_on_card(cuda_device):
    """A request admitted between replays (its prefill spliced into the
    batcher's caches in place) decodes as on the eager batcher."""
    cfg = T_LLAMA
    params = init_params(cfg, seed=0, device=cuda_device)
    streams = []
    for jit_ws in (False, True):
        b = ContinuousBatcher(params, cfg, slots=2, capacity=32, jit_ws=jit_ws)
        b.admit(Request(0, np.array([5, 6, 7], np.int32), max_new=6))
        done = b.step() + b.step()  # the capture, then a replay
        b.admit(Request(1, np.array([9, 8], np.int32), max_new=3))
        for _ in range(6):
            done += b.step()
        streams.append({r.rid: list(r.out) for r in done})
    assert streams[0] == streams[1] and sorted(streams[1]) == [0, 1]


@pytest.mark.cuda
def test_drain_counter_trips_on_a_cut_budget_on_card(cuda_device, monkeypatch):
    cfg = T_LLAMA
    params, caches, tok, pos = _smoke_step(cfg, cuda_device)
    step = jit_decode_step_ws(cfg, mode="lockstep")
    step(params, caches, tok, pos)
    step.check_drained()
    _cut_rounds(monkeypatch)
    step = jit_decode_step_ws(cfg, mode="lockstep")
    for _ in range(2):  # eager (and the capture), then a replay
        step(params, caches, tok, pos)
        with pytest.raises(RuntimeError, match="under-provisioned"):
            step.check_drained()


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [T_LLAMA, T_KIMI.replace(moe_dispatch="ws")],
                         ids=["llama", "kimi"])
def test_replay_synchronises_nothing_on_card(cuda_device, cfg):
    params, caches, tok, pos = _smoke_step(cfg, cuda_device)
    step = jit_decode_step_ws(cfg)
    step(params, caches, tok, pos)
    step.check_drained()
    for t, p in ((tok, pos), (torch.from_numpy(tok).cuda(), torch.from_numpy(pos).cuda())):
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = step(params, caches, t, p)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(torch.isfinite(logits).all())
        step.check_drained()
