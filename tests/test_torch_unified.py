"""The unified engine step of the port (dense models) against the JAX package:
the stage-gated Put, the one-launch step (decode and a folded prompt), its
free-mode per-stage launches and their glue-duplication drill, the stage
cache, the gate, and the serving engine's unified mode.  Smoke sizes; the
plain version runs for CPU tensors."""

import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decode_step_unified as j_unified
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as KIMI
from repro_torch.configs.llama3_2_3b import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.models import Caches, KVCache, decode_step_ws, prefill
from repro_torch.models.unified import (
    GLUE_EMBED,
    GLUE_LOGITS,
    GLUE_POST,
    GLUE_PRE,
    check_ported,
    clear_stage_cache,
    decode_step_unified,
    plan_step,
    run_step,
    stage_cache_stats,
    unified_step_supported,
)
from repro_torch.pallas_ws import launches

CAP = 32
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
# fp32 on both sides: the same projections and softmax sums taken in
# another order by XLA and ATen differ by a few ulps of O(1) values
TOL = 1e-5
PTOK = np.arange(11, 31, dtype=np.int32).reshape(1, 20)  # Lp 20: ragged q and kv blocks


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke llama, its caches after a ragged prefill, and
    the same state carried across to the port."""
    cfg = get_config("llama3.2-3b", smoke=True)
    params = j_init(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.asarray(np.array([[5, 6, 7, 8], [9, 8, 7, 6]], np.int32))}
    _, caches = j_prefill(params, cfg, batch, capacity=CAP)
    tok = np.array([[3], [4]], np.int32)
    pos = np.array([4, 2], np.int32)  # heterogeneous live lengths
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, params, caches, tok, pos, tp


def _caches(jc):
    return Caches(kv=KVCache(torch.from_numpy(np.array(jc.kv.k)),
                             torch.from_numpy(np.array(jc.kv.v))))


def _clone(c):
    return Caches(kv=KVCache(c.kv.k.clone(), c.kv.v.clone()))


def _assert_ints(rep_j, rep_t):
    for n in INTS:
        np.testing.assert_array_equal(np.asarray(getattr(rep_j.res, n)),
                                      getattr(rep_t.res, n).numpy(), err_msg=n)


def test_staged_queue_state_matches_reference():
    from repro.pallas_ws import queues as jq
    from repro.pallas_ws import tasks as jt
    from repro_torch.pallas_ws import queues as tq
    from repro_torch.pallas_ws import tasks as tt

    def stages(t):
        dec = t.emit_decode_tasks([9, 3, 17], 4, 4)
        flash = t.emit_flash_tasks([13], 4, 8, 4)
        return [[t.StepGlueTask(0, 0, t.BOTTOM, 0, 1)], dec,
                [t.StepGlueTask(2, 1, t.BOTTOM, 1, 1)], dec + flash, [], flash]

    for n_programs in (3, 8):
        sj, oj, rj = jq.make_staged_queue_state(stages(jt), n_programs)
        st, ot, rt = tq.make_staged_queue_state(stages(tt), n_programs)
        for n in ("tasks", "head", "tail", "local_head", "taken", "remaining"):
            np.testing.assert_array_equal(np.asarray(getattr(sj, n)), getattr(st, n), err_msg=n)
        np.testing.assert_array_equal(oj, ot)
        assert rj == rt and sj.n_tasks == st.n_tasks


@pytest.mark.parametrize("policy", ["cost", "scan"])
def test_stage_gated_attention_launch_matches_reference(policy):
    """The stage gate of the plain walk, through the attention family's
    launch_ws_grid, against the reference's launch at the same stage_open."""
    from repro.pallas_ws import queues as jq
    from repro.pallas_ws import tasks as jt
    from repro.pallas_ws.kernel import _attention_execute
    from repro.pallas_ws.kernel import launch_ws_grid as j_launch
    from repro_torch.pallas_ws import kernel as tk
    from repro_torch.pallas_ws import queues as tq
    from repro_torch.pallas_ws import tasks as tt

    rng = np.random.default_rng(3)
    B, H, S, hd, bk, P = 3, 2, 16, 8, 4, 3
    q = rng.standard_normal((B, H, 1, hd)).astype(np.float32)
    k = rng.standard_normal((B, 1, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, 1, S, hd)).astype(np.float32)

    def stages(t):
        a = t.emit_decode_tasks([16, 5, 9], H, bk)
        b = [dc.replace(x, tid=x.tid + len(a)) for x in t.emit_decode_tasks([3, 12, 7], H, bk)]
        return [a, b]

    sj, oj, rounds = jq.make_staged_queue_state(stages(jt), P)
    st, ot, _ = tq.make_staged_queue_state(stages(tt), P)
    execute = functools.partial(_attention_execute, bq=1, bk=bk, causal=False,
                                scale=hd ** -0.5, g=H)
    out = np.zeros((B, H, 1, hd), np.float32)
    rj = j_launch(sj, execute, (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
                  jnp.asarray(out), steal_policy=policy, rounds=rounds, stage_open=oj,
                  compress_runs=False)
    rt = tk.launch_ws_grid(st, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(out), bq=1, bk=bk, causal=False, scale=hd ** -0.5,
                           steal_policy=policy, rounds=rounds, stage_open=ot,
                           compress_runs=False, mode="lockstep")
    for n in INTS:
        np.testing.assert_array_equal(np.asarray(getattr(rj, n)), getattr(rt, n).numpy(),
                                      err_msg=n)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), atol=TOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(compress_runs=True, steal=False), dict(mode="free"),
                                dict(steal_run_cap=2)])
def test_stage_open_refusals(kw):
    from repro_torch.pallas_ws import emit_decode_tasks, launch_ws_grid, make_queue_state

    state = make_queue_state(emit_decode_tasks([8], 1, 8), 1)
    q, k = torch.zeros((1, 1, 1, 8)), torch.zeros((1, 1, 8, 8))
    kw = {"mode": "lockstep", **kw}
    with pytest.raises(ValueError):
        launch_ws_grid(state, q, k, k, torch.zeros((1, 1, 1, 8)), bq=1, bk=8, causal=False,
                       scale=1.0, stage_open=np.zeros(1, np.int32), **kw)
    with pytest.raises(ValueError):  # not the stage-major layout
        launch_ws_grid(make_queue_state(emit_decode_tasks([8, 8], 1, 8), 2), q, k, k,
                       torch.zeros((1, 1, 1, 8)), bq=1, bk=8, causal=False, scale=1.0,
                       mode="lockstep", stage_open=np.array([1, 0], np.int32))


def test_unified_decode_matches_reference(ref):
    cfg, params, caches, tok, pos, tp = ref
    # params_from_jax keeps fp32 as fp32: both sides run on identical numbers
    assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(tp))
    l_j, c_j, rep_j = j_unified(params, cfg, caches, jnp.asarray(tok), pos)
    before = launches["ws_unified"]
    l_t, c_t, rep_t = decode_step_unified(tp, SMOKE, _caches(caches), torch.from_numpy(tok), pos)
    _assert_ints(rep_j, rep_t)
    np.testing.assert_array_equal(np.asarray(rep_j.state.tasks), rep_t.state.tasks)
    np.testing.assert_array_equal(rep_j.stage_open, rep_t.stage_open)
    assert (rep_j.rounds, rep_j.n_tasks, rep_j.tid_bases) == (
        rep_t.rounds, rep_t.n_tasks, rep_t.tid_bases)
    assert rep_t.launches == 1 and launches["ws_unified"] == before  # CPU: the plain version
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(c_t.kv.k.numpy(), np.asarray(c_j.kv.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(c_t.kv.v.numpy(), np.asarray(c_j.kv.v), atol=TOL, rtol=0)


def test_unified_prefill_fold_matches_reference(ref):
    cfg, params, caches, tok, pos, tp = ref
    _, _, rep_j = j_unified(params, cfg, caches, jnp.asarray(tok), pos,
                            prefill_tokens=jnp.asarray(PTOK), bq=8, bk=8)
    _, _, rep_t = decode_step_unified(tp, SMOKE, _caches(caches), torch.from_numpy(tok), pos,
                                      prefill_tokens=torch.from_numpy(PTOK), bq=8, bk=8)
    _assert_ints(rep_j, rep_t)
    np.testing.assert_allclose(rep_t.prefill_logits.numpy(),
                               np.asarray(rep_j.prefill_logits), atol=TOL, rtol=0)
    np.testing.assert_allclose(rep_t.prefill_kv.k.numpy(), np.asarray(rep_j.prefill_kv.k),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(rep_t.prefill_kv.v.numpy(), np.asarray(rep_j.prefill_kv.v),
                               atol=TOL, rtol=0)


def test_unified_step_bitwise_equals_split_step_on_cpu(ref):
    """As in the reference, the unified step's decode half is the split
    step bit for bit (both plain torch in the same op order on the CPU),
    and a folded prompt's logits match the standalone prefill to TOL."""
    *_, tok, pos, tp = ref
    p = {**tp}
    _, c0 = prefill(p, SMOKE, {"tokens": torch.tensor([[5, 6, 7, 8], [9, 8, 7, 6]])},
                    capacity=CAP)
    l_s, c_s = decode_step_ws(p, SMOKE, _clone(c0), torch.from_numpy(tok), pos)
    l_u, c_u, _ = decode_step_unified(p, SMOKE, _clone(c0), torch.from_numpy(tok), pos)
    assert torch.equal(l_s, l_u)
    assert torch.equal(c_s.kv.k, c_u.kv.k) and torch.equal(c_s.kv.v, c_u.kv.v)
    l_f, _, rep = decode_step_unified(p, SMOKE, _clone(c0), torch.from_numpy(tok), pos,
                                      prefill_tokens=torch.from_numpy(PTOK), bq=8, bk=8)
    assert torch.equal(l_f, l_s)
    lp, cp = prefill(p, SMOKE, {"tokens": torch.from_numpy(PTOK).long()}, capacity=CAP)
    torch.testing.assert_close(rep.prefill_logits, lp, atol=TOL, rtol=0)
    torch.testing.assert_close(rep.prefill_kv.k, cp.kv.k, atol=TOL, rtol=0)


@pytest.mark.parametrize("fold", [False, True])
def test_free_mode_per_stage_launches(ref, fold):
    *_, caches, tok, pos, tp = ref
    kw = dict(prefill_tokens=torch.from_numpy(PTOK), bq=8, bk=8) if fold else {}
    l_l, c_l, rep_l = decode_step_unified(tp, SMOKE, _caches(caches), torch.from_numpy(tok),
                                          pos, **kw)
    l_f, c_f, rep_f = decode_step_unified(tp, SMOKE, _caches(caches), torch.from_numpy(tok),
                                          pos, mode="free", **kw)
    assert rep_f.launches == 2 + 3 * SMOKE.n_layers
    assert bool((rep_f.res.mult[:rep_f.n_tasks] >= 1).all())
    torch.testing.assert_close(l_f, l_l, atol=1e-6, rtol=0)
    torch.testing.assert_close(c_f.kv.k, c_l.kv.k, atol=1e-6, rtol=0)
    if fold:
        torch.testing.assert_close(rep_f.prefill_logits, rep_l.prefill_logits, atol=1e-6, rtol=0)


@pytest.mark.parametrize("phase", [GLUE_EMBED, GLUE_PRE, GLUE_POST, GLUE_LOGITS])
def test_glue_duplication_drill(ref, phase):
    """Run one glue task twice (its stage relaunched from the Put, the heads
    rewound, mult carried): the step's logits and caches do not move, since
    no glue phase updates a buffer in place."""
    *_, caches, tok, pos, tp = ref
    kw = dict(prefill_tokens=torch.from_numpy(PTOK), bq=8, bk=8)
    run = dict(mode="free", steal=True, steal_policy="cost", n_programs=8)
    clean = plan_step(tp, SMOKE, _caches(caches), torch.from_numpy(tok), pos, **kw)
    run_step(tp, SMOKE, clean, **run)
    plan = plan_step(tp, SMOKE, _caches(caches), torch.from_numpy(tok), pos, **kw)
    n_stages = 2 + 3 * SMOKE.n_layers
    s = {GLUE_EMBED: 0, GLUE_PRE: 1, GLUE_POST: 3, GLUE_LOGITS: n_stages - 1}[phase]
    first, _ = run_step(tp, SMOKE, plan, stages=range(s + 1), **run)
    again, _ = run_step(tp, SMOKE, plan, stages=[s], mult=first.mult, **run)
    res = again
    if s + 1 < n_stages:
        res, _ = run_step(tp, SMOKE, plan, stages=range(s + 1, n_stages), mult=again.mult,
                          **run)
    glue_tid = int(plan.state.tasks[s * 8, 0, 6])
    assert int(res.mult[glue_tid]) == 2
    assert int((res.mult[:plan.g.n_tasks] == 2).sum()) == 1
    for name in ("logits", "logp", "kc", "vc", "kp", "vp"):
        assert torch.equal(plan.bufs[name], clean.bufs[name]), name


def test_stage_assembly_memoized(ref):
    *_, caches, tok, pos, tp = ref
    clear_stage_cache()
    step = functools.partial(decode_step_unified, tp, SMOKE)
    l0, c0, _ = step(_caches(caches), torch.from_numpy(tok), pos)
    assert stage_cache_stats() == {"builds": 1, "hits": 0}
    l1, _, _ = step(_caches(caches), torch.from_numpy(tok), pos)
    assert stage_cache_stats() == {"builds": 1, "hits": 1}
    assert torch.equal(l0, l1)
    step(_clone(c0), torch.from_numpy(tok), pos + 1)
    step(_clone(c0), torch.from_numpy(tok), pos + 1)
    assert stage_cache_stats() == {"builds": 2, "hits": 2}
    step(_clone(c0), torch.from_numpy(tok), pos + 1,
         prefill_tokens=torch.from_numpy(PTOK[:, :8]), bq=8, bk=8)
    assert stage_cache_stats() == {"builds": 3, "hits": 2}
    clear_stage_cache()
    assert stage_cache_stats() == {"builds": 0, "hits": 0}


def test_unified_gate_and_unported_knobs(ref):
    from repro_torch.serving import ContinuousBatcher

    *_, caches, tok, pos, tp = ref
    assert unified_step_supported(SMOKE)
    assert not unified_step_supported(SMOKE.replace(dtype="bfloat16"))
    assert not unified_step_supported(SMOKE.replace(family="ssm"))
    kimi = KIMI.replace(dtype="float32", moe_dispatch="ws")
    assert unified_step_supported(kimi)
    with pytest.raises(ValueError):
        decode_step_unified(tp, SMOKE.replace(dtype="bfloat16"), _caches(caches),
                            torch.from_numpy(tok), pos)
    check_ported(kimi)  # the MoE half is ported; its own tests are test_torch_unified_moe
    with pytest.raises(ValueError):  # the dense dispatch has no ws oracle
        decode_step_unified(tp, kimi.replace(moe_dispatch="dense"), _caches(caches),
                            torch.from_numpy(tok), pos)
    # trace rings are ported: one ring stream with every task of the step
    _, _, rep = decode_step_unified(tp, SMOKE, _caches(caches), torch.from_numpy(tok), pos,
                                    trace=True)
    assert len(rep.trace_stream) == rep.n_tasks == int(rep.res.ev_cursor.sum())
    with pytest.raises(ValueError):
        ContinuousBatcher(tp, SMOKE.replace(dtype="bfloat16"), slots=2, capacity=16,
                          unified_step=True)


def _serve(make_frontend, req_cls, prompts, max_new=3):
    front = make_frontend()
    for rid, p in enumerate(prompts):
        front.submit(0, req_cls(rid=rid, tokens=p, max_new=max_new))
    done = front.run(max_iters=100)
    return {rid: list(r.out) for rid, r in done.items()}, front


def test_unified_engine_streams_match_reference_and_split(ref):
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import WorkStealingFrontend as JFrontend
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    cfg, params, *_, tp = ref
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (5, 9)]
    want, _ = _serve(lambda: JFrontend(lambda: JBatcher(params, cfg, slots=2, capacity=16,
                                                        unified_step=True), n_replicas=1),
                     JRequest, prompts)
    got, front = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, SMOKE, slots=2, capacity=16, unified_step=True), n_replicas=1), Request, prompts)
    split, _ = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, SMOKE, slots=2, capacity=16), n_replicas=1), Request, prompts)
    assert got == want == split
    assert sorted(got) == [0, 1] and all(len(o) == 3 for o in got.values())
    (b,) = front.batchers
    assert b.degradations == [] and b.stats()["steps"] == 4


def test_unified_engine_redoes_a_non_finite_step_on_the_split_path(ref, monkeypatch):
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend
    from repro_torch.serving import engine

    *_, tp = ref
    prompts = [np.array([7, 3, 9, 1], np.int32), np.array([2, 8], np.int32)]
    real = engine.decode_step_unified
    calls = [0]

    def poisoned(*a, **kw):
        logits, caches, rep = real(*a, **kw)
        calls[0] += 1
        return (torch.full_like(logits, float("nan")) if calls[0] == 2 else logits), caches, rep

    monkeypatch.setattr(engine, "decode_step_unified", poisoned)
    got, front = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, SMOKE, slots=2, capacity=16, unified_step=True), n_replicas=1), Request, prompts)
    split, _ = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, SMOKE, slots=2, capacity=16), n_replicas=1), Request, prompts)
    assert got == split
    (b,) = front.batchers
    assert [d["step"] for d in b.degradations] == [1]
    assert b.stats()["degradations"] == {"non-finite": 1}
