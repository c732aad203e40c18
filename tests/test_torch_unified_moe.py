"""The unified engine step of the port, MoE half, against the JAX package:
the router's tie rule, the traced shared-pool Put, the one-launch MoE step
(decode and a folded prompt) with its routing buffers, its bit-equality
with the port's split step, free mode's per-stage launches and their
glue-duplication drill, dead pool tiles, and the serving engine's unified
mode.  kimi-k2's smoke config in fp32 with the ws expert dispatch; the
plain version runs for CPU tensors."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decode_step_unified as j_unified
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro_torch.configs.kimi_k2_1t_a32b import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.models import Caches, KVCache, decode_step_ws
from repro_torch.models.unified import (
    GLUE_COMB,
    GLUE_POST,
    decode_step_unified,
    plan_step,
    run_step,
)
from repro_torch.pallas_ws import launches

CFG = SMOKE.replace(dtype="float32", moe_dispatch="ws")
CAP = 32
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
# fp32 on both sides: the same projections, softmax and expert products
# summed in another order by XLA and ATen differ by a few ulps of O(1) values
TOL = 2e-6
FOLD_TOL = 2e-5  # the prompt's rows also pass its flash tiles' online softmax
PTOK = np.array([[11, 12, 13, 14, 15, 16, 17]], np.int32)  # the reference's 7-token fold
ROUTING = ("tok", "gate", "e", "rl")
LOCKSTEP = dict(mode="lockstep", steal=True, steal_policy="cost", n_programs=8)
FREE = dict(LOCKSTEP, mode="free")


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke kimi-k2 (fp32, ws dispatch), its caches after a
    ragged prefill, the same state carried across to the port, and the
    reference's unified decode step and 7-token fold, each run once."""
    cfg = dc.replace(get_config("kimi-k2-1t-a32b", smoke=True), moe_dispatch="ws")
    params = j_init(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.asarray(np.array([[5, 6, 7, 8], [9, 8, 7, 6]], np.int32))}
    _, caches = j_prefill(params, cfg, batch, capacity=CAP)
    tok = np.array([[3], [4]], np.int32)
    pos = np.array([4, 2], np.int32)  # heterogeneous live lengths
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    dec = j_unified(params, cfg, caches, jnp.asarray(tok), pos)
    fold = j_unified(params, cfg, caches, jnp.asarray(tok), pos,
                     prefill_tokens=jnp.asarray(PTOK))
    return cfg, params, caches, tok, pos, tp, dec, fold


def _caches(jc):
    return Caches(kv=KVCache(torch.from_numpy(np.array(jc.kv.k)),
                             torch.from_numpy(np.array(jc.kv.v))))


def _ref_routing(rep, fold):
    """The reference's routing buffers from its launch's outputs (the order
    in which ``decode_step_unified`` allocates them), each the decode
    segment's then the prompt's, as the port lays them out."""
    names = ["kc", "vc", "h", "qd", "ktd", "vtd", "attd", "logits", "xfd", "tokd", "gated",
             "ed", "rld", "yrd"]
    if fold:
        names += ["hp", "qp", "ktp", "vtp", "attp", "kp", "vp", "logp", "xfp", "tokp", "gatep",
                  "ep", "rlp", "yrp"]
    out = {n: np.asarray(a) for n, a in zip(names, rep.res.out)}
    segs = ("d", "p") if fold else ("d",)
    return {n: np.concatenate([out[n + s] for s in segs]) for n in ROUTING}


# ---------------------------------------------------------------------------
# the router's tie rule


@pytest.mark.parametrize("kind", ["zero-router", "partly-tied"])
def test_router_topk_ties_match_reference(kind):
    """Equal probabilities are taken lower expert index first, as
    ``jax.lax.top_k`` takes them (``torch.topk`` orders ties its own way).
    A zero router ties every expert.  The partly tied router gives token t
    logit 0 on a few experts and -1e4 on the rest (x one-hot, so the logits
    are exact): probabilities exactly 1/n and 0 in both frameworks, with
    ties among the winners and among the rest, cut by the top-k."""
    from repro.models.moe import router_topk as j_router_topk
    from repro_torch.models.moe import router_topk

    E, k, T = 16, 4, 12
    cfg = SMOKE.replace(n_experts=E, top_k=k)
    jcfg = dc.replace(get_config("kimi-k2-1t-a32b", smoke=True), n_experts=E, top_k=k)
    d = cfg.d_model
    rng = np.random.default_rng(5)
    if kind == "zero-router":
        x = rng.standard_normal((2, T // 2, d)).astype(np.float32)
        router = np.zeros((d, E), np.float32)
    else:
        x = np.eye(T, d, dtype=np.float32).reshape(2, T // 2, d)
        router = np.full((d, E), -1e4, np.float32)
        for t in range(T):
            router[t, rng.choice(E, size=1 + t % 6, replace=False)] = 0.0
    _, g_j, i_j, _ = j_router_topk(jnp.asarray(x), {"router": jnp.asarray(router)}, jcfg)
    _, g_t, i_t, _ = router_topk(torch.from_numpy(x), {"router": torch.from_numpy(router)},
                                 cfg)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


# ---------------------------------------------------------------------------
# the traced shared-pool Put


@pytest.mark.parametrize("T,k,E,bt", [(4, 8, 40, 8),    # the decode shape, bt | T·k
                                      (5, 3, 24, 4)])   # T·k = 15, not a multiple of bt
def test_pool_put_torch_matches_reference(T, k, E, bt):
    from repro.moe_ws.dispatch import route_to_tasks_pool_jax
    from repro_torch.moe_ws import route_to_tasks_pool_torch

    rng = np.random.default_rng(T * 100 + E)
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    idx[1] = idx[1, 0]             # one token sends every choice to one expert
    idx[2, : k // 2 + 1] = E - 1   # and another repeats the last expert
    gates = rng.random((T, k)).astype(np.float32)
    rj = route_to_tasks_pool_jax(idx, gates, E, bt=bt)
    rt = route_to_tasks_pool_torch(torch.from_numpy(idx), torch.from_numpy(gates), E, bt=bt)
    for name, a, b in zip(("records", "tail", "pool_off"), rj[:3], rt[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert (rt[3].n_rows, rt[3].n_routed, rt[3].n_tokens) == (
        rj[3].n_rows, rj[3].n_routed, rj[3].n_tokens)
    for name in ("tok_idx", "gates", "row_src", "expert_off", "loads"):
        np.testing.assert_array_equal(getattr(rt[3], name).numpy(),
                                      np.asarray(getattr(rj[3], name)), err_msg=name)
    assert int((rt[3].loads == 0).sum()) > 0  # some expert is empty


# ---------------------------------------------------------------------------
# the step against the reference


def _check_against_reference(rep_j, rep_t, plan, fold):
    for n in INTS:
        np.testing.assert_array_equal(getattr(rep_t.res, n).numpy(),
                                      np.asarray(getattr(rep_j.res, n)), err_msg=n)
    np.testing.assert_array_equal(rep_t.state.tasks, np.asarray(rep_j.state.tasks))
    np.testing.assert_array_equal(rep_t.stage_open, rep_j.stage_open)
    assert (rep_t.rounds, rep_t.n_tasks, rep_t.tid_bases) == (
        rep_j.rounds, rep_j.n_tasks, rep_j.tid_bases)
    want = _ref_routing(rep_j, fold)
    for n in ("tok", "e", "rl"):
        np.testing.assert_array_equal(plan.bufs[n].numpy(), want[n], err_msg=n)
    # the gates are router softmax values, rounded as each framework sums
    np.testing.assert_allclose(plan.bufs["gate"].numpy(), want["gate"], atol=TOL, rtol=0)


@pytest.mark.parametrize("fold", [False, True])
def test_unified_moe_step_matches_reference(ref, fold):
    cfg, params, caches, tok, pos, tp, dec, folded = ref
    l_j, c_j, rep_j = folded if fold else dec
    kw = dict(prefill_tokens=torch.from_numpy(PTOK)) if fold else {}
    before = launches["ws_unified"]
    l_t, c_t, rep_t = decode_step_unified(tp, CFG, _caches(caches), torch.from_numpy(tok),
                                          pos, **kw)
    assert rep_t.launches == 1 and launches["ws_unified"] == before  # CPU: the plain version
    plan = plan_step(tp, CFG, _caches(caches), torch.from_numpy(tok), pos, **kw)
    run_step(tp, CFG, plan, **LOCKSTEP)
    _check_against_reference(rep_j, rep_t, plan, fold)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(c_t.kv.k.numpy(), np.asarray(c_j.kv.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(c_t.kv.v.numpy(), np.asarray(c_j.kv.v), atol=TOL, rtol=0)
    if fold:
        for got, want in ((rep_t.prefill_logits, rep_j.prefill_logits),
                          (rep_t.prefill_kv.k, rep_j.prefill_kv.k),
                          (rep_t.prefill_kv.v, rep_j.prefill_kv.v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FOLD_TOL, rtol=0)


def test_unified_moe_step_bitwise_equals_split_step_on_cpu(ref):
    """As the reference holds for itself: the MoE unified step is the split
    step bit for bit on the CPU (the same router, pool tiles of the same
    rows, the combine's index_add_ over the rows in the same order)."""
    *_, caches, tok, pos, tp, _, _ = ref
    l_s, c_s = decode_step_ws(tp, CFG, _caches(caches), torch.from_numpy(tok), pos)
    l_u, c_u, _ = decode_step_unified(tp, CFG, _caches(caches), torch.from_numpy(tok), pos)
    assert torch.equal(l_s, l_u)
    assert torch.equal(c_s.kv.k, c_u.kv.k) and torch.equal(c_s.kv.v, c_u.kv.v)


def test_every_expert_tile_runs_once_in_lockstep(ref):
    """Stands in for the reference's trace witness (trace rings are not
    ported): one stage-gated launch runs every task, the expert tiles of
    both segments and the combine glue included, exactly once."""
    *_, caches, tok, pos, tp, _, _ = ref
    _, _, rep = decode_step_unified(tp, CFG, _caches(caches), torch.from_numpy(tok), pos,
                                    prefill_tokens=torch.from_numpy(PTOK))
    tb = rep.tid_bases
    assert tb["exp_pre"] > tb["exp_dec"] > tb["pre_att"] and rep.n_tasks > tb["exp_pre"]
    assert bool((rep.res.mult[:rep.n_tasks] == 1).all())


# ---------------------------------------------------------------------------
# free mode, duplicated glue, dead pool tiles


@pytest.mark.parametrize("fold", [False, True])
def test_moe_free_mode_per_stage_launches(ref, fold):
    *_, caches, tok, pos, tp, _, _ = ref
    kw = dict(prefill_tokens=torch.from_numpy(PTOK)) if fold else {}
    l_l, c_l, rep_l = decode_step_unified(tp, CFG, _caches(caches), torch.from_numpy(tok),
                                          pos, **kw)
    l_f, c_f, rep_f = decode_step_unified(tp, CFG, _caches(caches), torch.from_numpy(tok),
                                          pos, mode="free", **kw)
    assert rep_f.launches == 2 + 5 * CFG.n_layers
    assert bool((rep_f.res.mult[:rep_f.n_tasks] >= 1).all())
    # free tiles store what lockstep adds onto zeros and divides by mult 1
    assert torch.equal(l_f, l_l)
    assert torch.equal(c_f.kv.k, c_l.kv.k) and torch.equal(c_f.kv.v, c_l.kv.v)
    if fold:
        assert torch.equal(rep_f.prefill_logits, rep_l.prefill_logits)


@pytest.mark.parametrize("phase", [GLUE_POST, GLUE_COMB])
def test_moe_glue_duplication_drill(ref, phase):
    """Run the router Put or the expert combine twice (its stage relaunched
    from the Put, mult carried): the logits and caches do not move, since
    neither updates a buffer in place (the combine reads the residual the
    post-glue left in ``h2`` and writes the other half of ``h``)."""
    *_, caches, tok, pos, tp, _, _ = ref
    kw = dict(prefill_tokens=torch.from_numpy(PTOK))
    clean = plan_step(tp, CFG, _caches(caches), torch.from_numpy(tok), pos, **kw)
    run_step(tp, CFG, clean, **FREE)
    plan = plan_step(tp, CFG, _caches(caches), torch.from_numpy(tok), pos, **kw)
    n_stages = 2 + 5 * CFG.n_layers
    s = {GLUE_POST: 3, GLUE_COMB: 5}[phase] + 5  # in the second layer
    first, _ = run_step(tp, CFG, plan, stages=range(s + 1), **FREE)
    again, _ = run_step(tp, CFG, plan, stages=[s], mult=first.mult, **FREE)
    res, _ = run_step(tp, CFG, plan, stages=range(s + 1, n_stages), mult=again.mult, **FREE)
    (rec,) = [r for r in plan.state.tasks[s * 8:(s + 1) * 8, 0] if r[0] != -1]
    glue_tid = int(rec[6])
    assert int(rec[1]) == phase
    assert int(res.mult[glue_tid]) == 2
    assert int((res.mult[:plan.g.n_tasks] == 2).sum()) == 1
    for name in ("logits", "logp", "kc", "vc", "kp", "vp", *ROUTING):
        assert torch.equal(plan.bufs[name], clean.bufs[name]), name


def test_dead_pool_tile_leaves_its_rows_untouched(ref):
    """A pool tile with no live rows returns at once: after the expert stage
    its rows still hold what they held before it, while every live row was
    written."""
    *_, caches, tok, pos, tp, _, _ = ref
    plan = plan_step(tp, CFG, _caches(caches), torch.from_numpy(tok), pos)
    g = plan.g
    run_step(tp, CFG, plan, stages=range(4), **FREE)     # embed, pre, attention, post
    yr = plan.bufs["yr"][0]
    yr.fill_(float("nan"))
    run_step(tp, CFG, plan, stages=[4], **FREE)          # the first layer's expert tiles
    rl = plan.bufs["rl"][:g.pool_dec]
    dead = torch.nonzero(rl == 0).flatten()
    assert 0 < len(dead) < g.pool_dec
    rows = yr[:g.n_rows_dec].reshape(g.pool_dec, g.bt, g.d)
    assert bool(rows[dead].isnan().all())
    live = torch.arange(g.bt)[None, :] < rl[:, None]
    assert bool(torch.isfinite(rows[live]).all())


# ---------------------------------------------------------------------------
# the serving engine


def _serve(make_frontend, req_cls, prompts, max_new=2):
    front = make_frontend()
    for rid, p in enumerate(prompts):
        front.submit(0, req_cls(rid=rid, tokens=p, max_new=max_new))
    done = front.run(max_iters=100)
    return {rid: list(r.out) for rid, r in done.items()}, front


def test_unified_moe_engine_streams_match_reference_and_split(ref):
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import WorkStealingFrontend as JFrontend
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    cfg, params, *_, tp, _, _ = ref
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in (5, 9)]
    want, _ = _serve(lambda: JFrontend(lambda: JBatcher(params, cfg, slots=2, capacity=16,
                                                        unified_step=True), n_replicas=1),
                     JRequest, prompts)
    got, front = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, CFG, slots=2, capacity=16, unified_step=True), n_replicas=1), Request, prompts)
    split, _ = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, CFG, slots=2, capacity=16), n_replicas=1), Request, prompts)
    assert got == want == split
    assert sorted(got) == [0, 1] and all(len(o) == 2 for o in got.values())
    (b,) = front.batchers
    assert b.degradations == [] and b.stats()["steps"] == 3


def test_unified_moe_engine_redoes_a_non_finite_step_on_the_split_path(ref, monkeypatch):
    """A MoE unified step whose logits come back non-finite is discarded and
    redone on the split path (standalone prefill, decode_step_ws with the
    expert kernel's plain version), and recorded: the streams stay the split
    engine's."""
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend
    from repro_torch.serving import engine

    *_, tp, _, _ = ref
    prompts = [np.array([7, 3, 9, 1], np.int32), np.array([2, 8], np.int32)]
    real = engine.decode_step_unified
    calls = [0]

    def poisoned(*a, **kw):
        logits, caches, rep = real(*a, **kw)
        calls[0] += 1
        return (torch.full_like(logits, float("nan")) if calls[0] == 2 else logits), caches, rep

    monkeypatch.setattr(engine, "decode_step_unified", poisoned)
    got, front = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, CFG, slots=2, capacity=16, unified_step=True), n_replicas=1), Request, prompts, 3)
    split, _ = _serve(lambda: WorkStealingFrontend(lambda: ContinuousBatcher(
        tp, CFG, slots=2, capacity=16), n_replicas=1), Request, prompts, 3)
    assert got == split
    (b,) = front.batchers
    assert [d["step"] for d in b.degradations] == [1]
    assert b.stats()["degradations"] == {"non-finite": 1}
