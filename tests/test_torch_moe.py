"""The port's dropless MoE path (``repro_torch.moe_ws`` and
``repro_torch.models.moe``) against the JAX package at the kimi-k2 SMOKE
size (d 64, f 32, 8 experts, top-2, bt 8, 8 programs), on the same numpy
inputs.

Integer scheduler arrays and the host Put's layouts must be bit-equal.
Float outputs are held to 1e-5: both sides compute the same fp32 tile math,
but XLA and torch sum their dot products (64 and 32 terms here, |y| <~ 3) in
different orders.  Routing is compared only on continuous random inputs:
``torch.topk`` and ``jax.lax.top_k`` may order exactly equal probabilities
differently, and random fp32 logits have no ties.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.kimi_k2_1t_a32b import SMOKE as J_SMOKE  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.models.moe import moe_ffn as j_moe_ffn  # noqa: E402
from repro.moe_ws import combine_routed as j_combine  # noqa: E402
from repro.moe_ws import moe_ffn_nodrop_ref as j_nodrop  # noqa: E402
from repro.moe_ws import moe_ffn_ws as j_moe_ffn_ws  # noqa: E402
from repro.moe_ws import route_to_tasks as j_route  # noqa: E402
from repro.moe_ws import run_moe_schedule as j_run  # noqa: E402
from repro.pallas_ws import make_queue_state as j_make_state  # noqa: E402
from repro_torch.configs.kimi_k2_1t_a32b import SMOKE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import moe_ffn, moe_ffn_dispatch  # noqa: E402
from repro_torch.moe_ws import (  # noqa: E402
    combine_routed,
    expert_ffn_nodrop_ref,
    moe_ffn_nodrop_ref,
    moe_ffn_ws,
    route_to_tasks,
    run_moe_schedule,
)
from repro_torch.pallas_ws import launches, make_queue_state  # noqa: E402

ATOL = 1e-5
INT_FIELDS = ("head", "local_head", "taken", "remaining", "clock", "work",
              "steals", "scanned", "mult")
T, D, F_, E, K, BT, P = 16, SMOKE.d_model, SMOKE.moe_d_ff, SMOKE.n_experts, SMOKE.top_k, 8, 8


def _routing(seed, T=T, E=E, k=K, skip_expert=None):
    """Distinct experts per token (as top-k gives), normalised gates."""
    rng = np.random.default_rng(seed)
    experts = [e for e in range(E) if e != skip_expert]
    idx = np.stack([rng.choice(experts, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    return idx, gates / gates.sum(1, keepdims=True)


def _tensors(seed):
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    wg = (rng.standard_normal((E, D, F_)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F_)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, F_, D)) / np.sqrt(F_)).astype(np.float32)
    return x, (wg, wu, wd)


def _states(idx, gates, steal):
    """The same host Put on both sides: per-expert queues with stealing,
    experts round-robin over the programs' queues without."""
    n_queues = E if steal else P
    jt, jr = j_route(idx, gates, E, bt=BT)
    tt, tr = route_to_tasks(idx, gates, E, bt=BT)
    return (j_make_state(jt, P, n_queues=n_queues, partition="owner"), jt, jr,
            make_queue_state(tt, P, n_queues=n_queues, partition="owner"), tt, tr)


def _both(js, jr, ts, tr, x, w, *, jout=None, tout=None, jmult=None, tmult=None, **kw):
    rj = j_run(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), bt=BT, out=jout,
               mult=jmult, **kw)
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          bt=BT, out=tout, mult=tmult, mode="lockstep", **kw)
    return rj, rt


def _assert_same(rj, rt):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj, f)), getattr(rt, f).numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed,skip", [(0, 3), (1, None)])
def test_route_to_tasks_layout_matches_reference(seed, skip):
    """Routed arrays and queue records equal the reference's, including an
    expert that receives no token (``skip``)."""
    idx, gates = _routing(seed, skip_expert=skip)
    js, jt, jr, ts, tt, tr = _states(idx, gates, steal=True)
    for f in ("tok_idx", "gates", "expert_off", "loads", "row_src"):
        np.testing.assert_array_equal(getattr(tr, f), np.asarray(getattr(jr, f)), err_msg=f)
    assert (tr.n_rows, tr.n_routed, tr.n_tokens) == (jr.n_rows, jr.n_routed, jr.n_tokens)
    assert [t.encode().tolist() for t in tt] == [t.encode().tolist() for t in jt]
    for f in ("tasks", "head", "tail", "local_head", "taken", "remaining"):
        np.testing.assert_array_equal(getattr(ts, f), np.asarray(getattr(js, f)), err_msg=f)
    if skip is not None:
        assert tr.loads[skip] == 0 and ts.tail[skip] == 0


@pytest.mark.parametrize("n_routed,steal", [(32, True), (512, True), (7, True), (32, False)])
def test_expert_rounds_bound_matches_reference(n_routed, steal):
    from repro.moe_ws import expert_rounds_bound as j_bound
    from repro_torch.moe_ws import expert_rounds_bound

    assert expert_rounds_bound(n_routed, BT, E, P, steal) == j_bound(n_routed, BT, E, P, steal)


@pytest.mark.parametrize("steal,policy", [(True, "cost"), (True, "scan"), (False, "cost")])
def test_lockstep_matches_reference(steal, policy):
    idx, gates = _routing(2)
    x, w = _tensors(2)
    js, jt, jr, ts, tt, tr = _states(idx, gates, steal)
    rj, rt = _both(js, jr, ts, tr, x, w, steal=steal, steal_policy=policy)
    _assert_same(rj, rt)
    assert (rt.mult.numpy()[: ts.n_tasks] == 1).all()


def test_free_mode_runs_every_tile_and_combines_like_reference():
    """Free mode's plain walk runs every tile; its stored `out` is already
    normalised, so its combine equals the reference's mult-normalised one."""
    idx, gates = _routing(3)
    x, w = _tensors(3)
    js, jt, jr, ts, tt, tr = _states(idx, gates, steal=True)
    rj = j_run(js, jnp.asarray(x), jr.tok_idx, *map(jnp.asarray, w), bt=BT)
    want = np.asarray(j_combine(jr, jt, rj))
    before = launches["ws_expert"]
    rt = run_moe_schedule(ts, torch.from_numpy(x), tr.tok_idx, *map(torch.from_numpy, w),
                          bt=BT, mode="free")
    assert launches["ws_expert"] == before  # CPU tensors run the plain version
    assert rt.mode == "free" and (rt.mult.numpy()[: ts.n_tasks] >= 1).all()
    np.testing.assert_allclose(combine_routed(tr, tt, rt).numpy(), want, rtol=0, atol=ATOL)


def test_head_rewind_drill_gives_mult_two():
    """Mirror of the reference's rewind drill: relaunch on the finished
    state with every Head at 0 and every local bound wiped.  Every tile runs
    again (mult == 2), the integer arrays stay bit-equal to the reference's
    and the combine still equals the no-drop oracle."""
    idx, gates = _routing(4)
    x, w = _tensors(4)
    js, jt, jr, ts, tt, tr = _states(idx, gates, steal=True)
    rj, rt = _both(js, jr, ts, tr, x, w, steal=True)
    for s in (js, ts):
        s.head = np.zeros_like(np.asarray(s.head))
        s.local_head = np.zeros_like(np.asarray(s.local_head))
    rj2, rt2 = _both(js, jr, ts, tr, x, w, steal=True, jout=rj.out, tout=rt.out,
                     jmult=jnp.asarray(rj.mult), tmult=rt.mult)
    _assert_same(rj2, rt2)
    assert (rt2.mult.numpy()[: ts.n_tasks] == 2).all()
    ref = expert_ffn_nodrop_ref(idx, gates, torch.from_numpy(x), *map(torch.from_numpy, w))
    np.testing.assert_allclose(combine_routed(tr, tt, rt2).numpy(), ref.numpy(),
                               rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def layer_inputs():
    jp = j_init_moe(jax.random.PRNGKey(5), J_SMOKE, jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(6).standard_normal((2, 8, D)).astype(np.float32)
    return jp, tp, x


def _without_shared(p):
    return {k: v for k, v in p.items() if not k.startswith("ws_")}


@pytest.mark.parametrize("shared", [1, 0])
@pytest.mark.parametrize("dispatch", ["ws", "dense"])
def test_moe_ffn_matches_reference(layer_inputs, dispatch, shared):
    """``moe_ffn_ws`` (free and lockstep) and the capacity-dropping
    ``moe_ffn`` against the reference's, with and without the shared expert."""
    jp, tp, x = layer_inputs
    jcfg = J_SMOKE.replace(n_shared_experts=shared, moe_dispatch=dispatch)
    tcfg = SMOKE.replace(n_shared_experts=shared, moe_dispatch=dispatch)
    if not shared:
        jp, tp = _without_shared(jp), _without_shared(tp)
    jfn = j_moe_ffn_ws if dispatch == "ws" else j_moe_ffn
    jy, jaux = jfn(jnp.asarray(x), jp, jcfg)
    modes = ("free", "lockstep") if dispatch == "ws" else (None,)
    for mode in modes:
        ty, taux = (moe_ffn_dispatch(torch.from_numpy(x), tp, tcfg, mode=mode)
                    if dispatch == "ws" else moe_ffn(torch.from_numpy(x), tp, tcfg))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


def test_static_schedule_and_stats_match_reference(layer_inputs):
    jp, tp, x = layer_inputs
    jy, _, jst = j_moe_ffn_ws(jnp.asarray(x), jp, J_SMOKE, schedule="static",
                              return_stats=True)
    ty, _, tst = moe_ffn_ws(torch.from_numpy(x), tp, SMOKE, schedule="static",
                            mode="lockstep", return_stats=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    for f in ("n_tasks", "makespan", "total_work", "steals", "mult_max", "slots_scanned",
              "queue_loads"):
        assert getattr(tst, f) == getattr(jst, f), f


def test_nodrop_ref_matches_port_ws_and_reference(layer_inputs):
    jp, tp, x = layer_inputs
    ref, aux = moe_ffn_nodrop_ref(torch.from_numpy(x), tp, SMOKE)
    y, aux_ws = moe_ffn_ws(torch.from_numpy(x), tp, SMOKE)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    assert float(aux) == float(aux_ws)
    jref, _ = j_nodrop(jnp.asarray(x), jp, J_SMOKE)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=0, atol=ATOL)


def _layer_grads(fn, params, x, names):
    """Gradients of ``sum(y * c) + aux`` w.r.t. x and ``names`` (a fixed
    random projection ``c``, so every cotangent direction is exercised at
    O(1) scale)."""
    c = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)
    if isinstance(x, np.ndarray) or hasattr(x, "block_until_ready"):
        def loss(p, xx):
            y, aux = fn(xx, p)
            return (y * jnp.asarray(c)).sum() + aux

        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        return [np.asarray(gx)] + [np.asarray(gp[n]) for n in names]
    y, aux = fn(x, params)
    loss = (y * torch.from_numpy(c)).sum() + aux
    return [g.numpy() for g in torch.autograd.grad(loss, [x] + [params[n] for n in names])]


@pytest.mark.parametrize("kw", [dict(queue_layout="pool"), dict(grad_dispatch="ws"),
                                dict(trace=True), dict(steal_run_cap=2)])
def test_unported_knobs_raise(layer_inputs, kw):
    """Every knob these cases once refused is ported, so each holds the port
    to the reference: the pool layout's forward (lockstep, with its launch
    telemetry), the gradients of the layer with ``grad_dispatch="ws"``, the
    traced launch's stats and trace, and half-run steals
    (``steal_run_cap=2``): the host Put's forward with its telemetry, then
    the gradients through the ws backward at the same cap."""
    jp, tp, x = layer_inputs
    if "trace" in kw:
        _, _, jst = j_moe_ffn_ws(jnp.asarray(x), jp, J_SMOKE, return_stats=True, **kw)
        with torch.no_grad():
            _, _, tst = moe_ffn_ws(torch.from_numpy(x), tp, SMOKE, mode="lockstep",
                                   return_stats=True, **kw)
        assert tst.trace.summary() == jst.trace.summary()
        np.testing.assert_array_equal(tst.trace.events, np.asarray(jst.trace.events))
        return
    if "queue_layout" in kw or "steal_run_cap" in kw:
        jy, jaux, jst = j_moe_ffn_ws(jnp.asarray(x), jp, J_SMOKE, return_stats=True, **kw)
        ty, taux, tst = moe_ffn_ws(torch.from_numpy(x), tp, SMOKE, mode="lockstep",
                                   return_stats=True, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
        assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
        for f in ("n_tasks", "makespan", "total_work", "steals", "mult_max",
                  "slots_scanned", "queue_loads"):
            assert getattr(tst, f) == getattr(jst, f), f
        if "queue_layout" in kw:
            return
        kw = dict(kw, grad_dispatch="ws")
    names = sorted(tp)
    tpg = {n: t.clone().requires_grad_() for n, t in tp.items()}
    want = _layer_grads(lambda xx, p: j_moe_ffn_ws(xx, p, J_SMOKE, **kw), jp, x, names)
    for mode in ("free", "lockstep"):
        got = _layer_grads(lambda xx, p: moe_ffn_ws(xx, p, SMOKE, mode=mode, **kw), tpg,
                           torch.from_numpy(x).requires_grad_(), names)
        for g, w, n in zip(got, want, ["x"] + names):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{mode} d{n}")


def test_backward_and_mesh_dispatch_raise(layer_inputs):
    """The backward is ported: with inputs that require grad the layer
    records its custom VJP and its gradients (the dense transpose, by
    default) match the reference's, and under ``no_grad`` it runs the same
    forward.  The cross-device ``mesh-ws`` dispatch is forward-only: it
    raises when autograd records the call, and under ``no_grad`` it runs the
    1-device mesh (no process group) and gives the ws layer's output."""
    jp, tp, x = layer_inputs
    names = sorted(tp)
    tpg = {n: t.clone().requires_grad_() for n, t in tp.items()}
    want = _layer_grads(lambda xx, p: j_moe_ffn_ws(xx, p, J_SMOKE), jp, x, names)
    xg = torch.from_numpy(x).requires_grad_()
    got = _layer_grads(lambda xx, p: moe_ffn_ws(xx, p, SMOKE), tpg, xg, names)
    for g, w, n in zip(got, want, ["x"] + names):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"d{n}")
    with torch.no_grad():
        y, _ = moe_ffn_ws(xg, tp, SMOKE)
    y_grad, _ = moe_ffn_ws(xg, tpg, SMOKE)
    torch.testing.assert_close(y, y_grad.detach(), rtol=0, atol=ATOL)
    mesh_cfg = SMOKE.replace(moe_dispatch="mesh-ws")
    with pytest.raises(ValueError, match="mesh-ws.*forward-only"):
        moe_ffn_dispatch(xg, tpg, mesh_cfg)
    with torch.no_grad():
        y_mesh, _ = moe_ffn_dispatch(torch.from_numpy(x), tp, mesh_cfg)
    torch.testing.assert_close(y_mesh, y, rtol=0, atol=ATOL)


def test_return_stats_under_autograd_raises(layer_inputs):
    """``return_stats`` runs the forward launch alone, with no backward: the
    reference refuses it under ``jax.grad`` and the port refuses it when
    autograd records the call, rather than detaching the routed experts'
    output.  Under ``no_grad`` the same call returns its stats."""
    jp, tp, x = layer_inputs
    with pytest.raises(ValueError, match="return_stats"):
        jax.grad(lambda xx: j_moe_ffn_ws(xx, jp, J_SMOKE, return_stats=True)[0].sum())(
            jnp.asarray(x))
    for n in ("x", "we_g"):
        xg = torch.from_numpy(x).requires_grad_(n == "x")
        tpg = {k: t.clone().requires_grad_(k == n) for k, t in tp.items()}
        with pytest.raises(ValueError, match="return_stats"):
            moe_ffn_ws(xg, tpg, SMOKE, return_stats=True)
        with torch.no_grad():
            _, _, st = moe_ffn_ws(xg, tpg, SMOKE, return_stats=True)
        assert st.n_tasks > 0


def test_bad_expert_records_are_rejected():
    idx, gates = _routing(7)
    x, w = _tensors(7)
    tasks, routed = route_to_tasks(idx, gates, E, bt=BT)
    state = make_queue_state(tasks, P, n_queues=E, partition="owner")
    state.tasks[int(np.argmax(state.tail)), 0, 1] = E  # expert id out of range
    with pytest.raises(ValueError, match="out of range"):
        run_moe_schedule(state, torch.from_numpy(x), routed.tok_idx,
                         *map(torch.from_numpy, w), bt=BT)
    with pytest.raises(ValueError, match="tok_idx"):
        run_moe_schedule(state, torch.from_numpy(x), routed.tok_idx + T,
                         *map(torch.from_numpy, w), bt=BT)
