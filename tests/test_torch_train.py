"""The port's training slice against the JAX package on the deepseek-v2
SMOKE config (MLA + MoE, d 64, 8 experts top-2, 2 shared experts), on the
same numpy inputs; the reference's kernels run in Pallas interpret mode, as
its own tests run them.

* the shared-pool Put and its queue state, array for array, over the
  routings of the reference's gradient suite (uniform, repeat-expert,
  empty-expert);
* the backward tile walk on pool queues: lockstep integer arrays bit-equal,
  ``out`` within 1e-5;
* ``torch.autograd.grad`` through ``moe_ffn_ws`` (grad dispatch dense and
  ws) against ``jax.grad`` of the reference layer, router and aux loss
  included, and the backward head-rewind drill (mult == 2, the same
  gradients);
* ``mla_train`` and the ``flash_ref`` VJP, forward and gradients;
* ``loss_fn`` and every parameter gradient of the whole smoke model;
* one AdamW and one adafactor-momentum update;
* 3 ``train()`` steps against the reference's jitted 3-step trajectory.

Tolerances: 1e-5 on fp32 values of magnitude <~ 3 (XLA and torch sum the
same products in other orders; the smoke widths are 8 to 64 terms), 1e-3 on
the training losses (the reference's own drop-free ws-vs-dense bound).
Routing is compared on continuous random inputs only: ``torch.topk`` and
``jax.lax.top_k`` may order exactly equal probabilities differently.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.deepseek_v2_236b import SMOKE as J_SMOKE  # noqa: E402
from repro.moe_ws import route_to_tasks_pool_jax  # noqa: E402
from repro.moe_ws import run_moe_grad_schedule as j_run_grad  # noqa: E402
from repro.moe_ws.layer import _grad_dense as j_grad_dense  # noqa: E402
from repro.pallas_ws import make_pool_queue_state_jax  # noqa: E402
from repro_torch.configs.deepseek_v2_236b import SMOKE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.moe_ws import (  # noqa: E402
    expert_rounds_bound,
    moe_ffn_ws,
    route_to_tasks_pool,
    run_moe_grad_schedule,
)
from repro_torch.moe_ws.layer import _grad_dense, assemble_row_grads  # noqa: E402
from repro_torch.pallas_ws import make_pool_queue_state  # noqa: E402

ATOL = 1e-5
INT_FIELDS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
              "scanned", "mult")


def _routing(seed, T=9, E=4, k=2, kind="uniform"):
    """The reference suite's routing shapes: uniform, repeat-expert (a token
    names one expert k times), empty-expert (expert E-1 never routed)."""
    rng = np.random.RandomState(seed)
    if kind == "repeat-expert":
        idx = np.repeat(rng.randint(E, size=(T, 1)), k, axis=1)
    elif kind == "empty-expert":
        idx = np.stack([rng.choice(E - 1, k, replace=False) for _ in range(T)])
    else:
        idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    return idx.astype(np.int32), gates / gates.sum(1, keepdims=True)


def _core(seed, T=9, E=4, k=2, d=8, f=16, kind="uniform"):
    idx, gates = _routing(seed, T, E, k, kind)
    rng = np.random.RandomState(100 + seed)
    x = rng.randn(T, d).astype(np.float32)
    gy = rng.randn(T, d).astype(np.float32)
    w = [(rng.randn(*s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return idx, gates, x, gy, w


def _both_pool_states(idx, gates, E, bt, P):
    jr = route_to_tasks_pool_jax(jnp.asarray(idx), jnp.asarray(gates), E, bt=bt)
    tr = route_to_tasks_pool(idx, gates, E, bt=bt)
    js = make_pool_queue_state_jax(*jr[:3], jr[3].loads, P, n_tasks=jr[0].shape[0])
    ts = make_pool_queue_state(*tr[:3], tr[3].loads, P, n_tasks=tr[0].shape[0])
    return jr, tr, js, ts


# ---------------------------------------------------------------------------
# the shared-pool Put and the backward walk


@pytest.mark.parametrize("kind", ["uniform", "repeat-expert", "empty-expert"])
def test_pool_put_matches_reference(kind):
    idx, gates = _routing(1, T=11, E=5, k=3 if kind != "empty-expert" else 2, kind=kind)
    jr, tr, js, ts = _both_pool_states(idx, gates, 5, 4, 3)
    for a, b, name in zip(jr[:3], tr[:3], ("records", "tail", "pool_off")):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    for f in ("tok_idx", "gates", "expert_off", "loads", "row_src"):
        np.testing.assert_array_equal(np.asarray(getattr(jr[3], f)), getattr(tr[3], f),
                                      err_msg=f)
    assert (jr[3].n_rows, jr[3].n_routed, jr[3].n_tokens) == (
        tr[3].n_rows, tr[3].n_routed, tr[3].n_tokens)
    for f in ("tasks", "head", "tail", "local_head", "taken", "remaining", "pool_off"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f), err_msg=f)
    assert ts.n_tasks == js.n_tasks and ts.capacity == js.capacity
    # the all-⊥ suffix: every slot past the live prefix is ⊥
    n_live = int(ts.tail.sum())
    assert (ts.tasks[n_live:, 0] == -1).all() and (ts.tasks[:n_live, 0] >= 0).all()


@pytest.mark.parametrize("kind,policy", [("uniform", "cost"), ("repeat-expert", "scan"),
                                         ("empty-expert", "cost")])
def test_grad_walk_lockstep_matches_reference_on_pool(kind, policy):
    """``plain_moe_grad_grid`` (through ``run_moe_grad_schedule`` on CPU
    tensors) on pool queues: a probe bound by ``tail`` never reads the next
    queue's segment, so every integer array equals the reference's."""
    idx, gates, x, gy, w = _core(3, kind=kind)
    E, bt, P = 4, 4, 3
    jr, tr, js, ts = _both_pool_states(idx, gates, E, bt, P)
    rounds = expert_rounds_bound(idx.size, bt, E, P, True)
    rj = j_run_grad(js, jnp.asarray(x), jnp.asarray(gy), jr[3].tok_idx, jr[3].gates,
                    *map(jnp.asarray, w), bt=bt, steal_policy=policy, rounds=rounds)
    rt = run_moe_grad_schedule(ts, torch.from_numpy(x), torch.from_numpy(gy), tr[3].tok_idx,
                               tr[3].gates, *map(torch.from_numpy, w), bt=bt,
                               steal_policy=policy, rounds=rounds, mode="lockstep")
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                      err_msg=f)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=ATOL)
    # free mode (the plain walk's serial order) runs every live tile once
    rf = run_moe_grad_schedule(ts, torch.from_numpy(x), torch.from_numpy(gy), tr[3].tok_idx,
                               tr[3].gates, *map(torch.from_numpy, w), bt=bt,
                               steal_policy=policy)
    n_live = int(ts.tail.sum())
    assert (rf.mult[:n_live] == 1).all() and (rf.mult[n_live:] == 0).all()
    np.testing.assert_allclose(rf.out.numpy(), np.asarray(rj.out), rtol=0, atol=ATOL)


def test_backward_multiplicity_normalization_under_head_rewind():
    """The reference's drill on the port: after a full drain every head is
    rewound and every local bound wiped, and the relaunch with carried
    out/mult re-executes every grad tile (mult == 2); the assembled
    gradients are bit-identical to the single launch's and match the port's
    dense transpose and the reference's."""
    idx, gates, x, gy, w = _core(5, T=8, d=4, f=8)
    E, bt, P = 4, 4, 4
    tr = route_to_tasks_pool(idx, gates, E, bt=bt)
    ts = make_pool_queue_state(*tr[:3], tr[3].loads, P, n_tasks=tr[0].shape[0])
    args = (torch.from_numpy(x), torch.from_numpy(gy), tr[3].tok_idx, tr[3].gates,
            *map(torch.from_numpy, w))
    res1 = run_moe_grad_schedule(ts, *args, bt=bt, mode="lockstep")
    n_live = int(ts.tail.sum())
    assert (res1.mult[:n_live] == 1).all()
    tw = tuple(map(torch.from_numpy, w))
    tidx = torch.from_numpy(idx).long()
    g1 = assemble_row_grads(res1, tr[3], tidx, args[0], args[1], bt=bt, weights=tw)
    ts.head = np.zeros_like(ts.head)
    ts.local_head = np.zeros_like(ts.local_head)
    res2 = run_moe_grad_schedule(ts, *args, bt=bt, mode="lockstep", out=res1.out,
                                 mult=res1.mult)
    assert (res2.mult[:n_live] == 2).all(), "every tile re-ran"
    g2 = assemble_row_grads(res2, tr[3], tidx, args[0], args[1], bt=bt, weights=tw)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    dense = _grad_dense(args[0], tidx, torch.from_numpy(gates), *tw, args[1])
    for a, b in zip(g2, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    want = j_grad_dense(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates),
                        *map(jnp.asarray, w), jnp.asarray(gy))
    for a, b in zip(g2, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the layer, MLA and the whole loss


@pytest.fixture(scope="module")
def moe_layer():
    from repro.models.moe import init_moe as j_init_moe

    jp = j_init_moe(jax.random.PRNGKey(0), J_SMOKE, jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 8, SMOKE.d_model)).astype(np.float32)
    c = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    return jp, tp, x, c


@pytest.mark.parametrize("grad_dispatch", ["dense", "ws"])
def test_moe_ffn_ws_grads_match_reference(moe_layer, grad_dispatch):
    """x and every layer parameter (router through the gates and the aux
    loss, routed experts through the custom VJP, shared experts outside it)
    of ``sum(y * c) + aux``, free and lockstep kernels."""
    from repro.moe_ws import moe_ffn_ws as j_moe_ffn_ws

    jp, tp, x, c = moe_layer
    names = sorted(tp)

    def j_loss(p, xx):
        y, aux = j_moe_ffn_ws(xx, p, J_SMOKE, n_programs=4, bt=4, grad_dispatch=grad_dispatch)
        return (y * jnp.asarray(c)).sum() + aux

    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    for mode in ("free", "lockstep"):
        tpg = {n: t.clone().requires_grad_() for n, t in tp.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y, aux = moe_ffn_ws(xt, tpg, SMOKE, n_programs=4, bt=4, grad_dispatch=grad_dispatch,
                            mode=mode)
        loss = (y * torch.from_numpy(c)).sum() + aux
        grads = torch.autograd.grad(loss, [xt] + [tpg[n] for n in names])
        assert float(loss) == pytest.approx(float(jv), abs=1e-4)
        for g, want, n in zip(grads, [jgx] + [jgp[n] for n in names], ["x"] + names):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                       err_msg=f"{mode} d{n}")


def test_flash_ref_vjp_matches_reference():
    """Causal flash attention with chunks smaller than the sequence (4 query
    x 4 key blocks), forward and the VJP's dq, dk, dv."""
    from repro.models.attention import flash_ref as j_flash
    from repro_torch.models import flash_ref

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 16, 3, 8)).astype(np.float32) for _ in range(3))
    do = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    jo, jvjp = jax.vjp(lambda a, b, cc: j_flash(a, b, cc, causal=True, window=0, chunk=4),
                       *map(jnp.asarray, (q, k, v)))
    jg = jvjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = flash_ref(tq, tk, tv, causal=True, window=0, chunk=4)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    for a, b, n in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL, err_msg=f"d{n}")


def test_mla_train_matches_reference():
    from repro.models.attention import init_mla as j_init_mla
    from repro.models.attention import mla_train as j_mla_train
    from repro_torch.models import mla_train

    jp = j_init_mla(jax.random.PRNGKey(4), J_SMOKE, jnp.float32)
    tp = {n: t.requires_grad_() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu").items()}
    B, S = 2, 12
    x = np.random.default_rng(5).standard_normal((B, S, SMOKE.d_model)).astype(np.float32)
    c = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    names = sorted(tp)

    def j_loss(p, xx):
        o = j_mla_train(xx, p, J_SMOKE, jnp.asarray(pos), window=0, chunk=4)
        return (o * jnp.asarray(c)).sum(), o

    (_, jo), (jgp, jgx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    o = mla_train(xt, tp, SMOKE, torch.from_numpy(pos.copy()).long(), window=0, chunk=4)
    grads = torch.autograd.grad((o * torch.from_numpy(c)).sum(), [xt] + [tp[n] for n in names])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    for g, want, n in zip(grads, [jgx] + [jgp[n] for n in names], ["x"] + names):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=f"d{n}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dispatch", ["dense", "ws"])
def test_loss_fn_and_grads_match_reference(dispatch):
    """The whole smoke model (2 MLA+MoE layers, remat): the loss, its ce
    and aux parts, and the gradient of every parameter.  ``ws`` runs both
    expert kernels' plain versions (forward, replay and backward)."""
    from repro.models import init_params as j_init
    from repro.models import loss_fn as j_loss_fn
    from repro_torch.launch.steps import loss_and_grads

    jcfg = J_SMOKE.replace(moe_dispatch=dispatch, moe_grad_dispatch=dispatch)
    tcfg = SMOKE.replace(moe_dispatch=dispatch, moe_grad_dispatch=dispatch)
    jp = j_init(jax.random.PRNGKey(7), jcfg)
    toks = np.random.default_rng(8).integers(0, SMOKE.vocab_size, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}), has_aux=True))(jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    loss, metrics, grads = loss_and_grads(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(loss) == pytest.approx(float(jl), abs=ATOL)
    for k in ("ce", "aux"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=ATOL), k
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    got = _flat(grads)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=0, atol=ATOL, err_msg=n)


# ---------------------------------------------------------------------------
# optimizers and the trainer


@pytest.mark.parametrize("flavor", ["adamw", "adafactor_momentum"])
def test_one_optimizer_update_matches_reference(flavor):
    """One clipped update (the grads' norm is over the clip, so the scale
    matters) of a tree with 1-, 2- and 3-D leaves: new parameters and every
    state array."""
    from repro.optim import make_adafactor_momentum as j_adafactor
    from repro.optim import make_adamw as j_adamw
    from repro.optim import cosine_schedule as j_cosine
    from repro_torch.optim import cosine_schedule, make_adafactor_momentum, make_adamw

    rng = np.random.default_rng(9)
    shapes = {"norm": (16,), "w": (16, 24), "experts": {"we": (3, 8, 12)}}
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                                    shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                                   shapes, is_leaf=lambda s: isinstance(s, tuple))
    make_j, make_t = ((j_adamw, make_adamw) if flavor == "adamw"
                      else (j_adafactor, make_adafactor_momentum))
    jopt = make_j(j_cosine(1e-2, warmup=2, total=10))
    topt = make_t(cosine_schedule(1e-2, warmup=2, total=10))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jparams)
    jnew, js = jopt.apply(jparams, jax.tree_util.tree_map(jnp.asarray, grads), js)
    jnew, js = jopt.apply(jnew, jax.tree_util.tree_map(jnp.asarray, grads), js)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tgrads = jax.tree_util.tree_map(torch.from_numpy, grads)
    ts = topt.init(tparams)
    for _ in range(2):
        tparams, ts = topt.apply(tparams, tgrads, ts)
    assert ts.step == int(js.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(tparams), jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves((ts.m, ts.v)),
                    jax.tree_util.tree_leaves((js.m, js.v))):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b).astype(np.float32),
                                   rtol=1e-5, atol=1e-7)


def _reference_trajectory(cfg, n_steps=3, seed=0):
    """The reference's ``_run_train_steps`` (tests/test_moe_ws_grad.py):
    2 rows x 16 tokens, peak lr 1e-3, jitted steps.  Returns (initial
    params as numpy, losses)."""
    from repro.data import make_batch as j_make_batch
    from repro.launch.steps import make_optimizer as j_make_optimizer
    from repro.launch.steps import make_train_step as j_make_train_step
    from repro.models import init_params as j_init
    from repro.models.config import ShapeConfig as JShape

    shape = JShape("custom", "train", 16, 2)
    opt = j_make_optimizer(cfg, total_steps=n_steps, peak_lr=1e-3)
    params = j_init(jax.random.PRNGKey(seed), cfg)
    init = jax.tree_util.tree_map(np.asarray, params)
    state = {"params": params, "opt": opt.init(params)}
    step_fn = jax.jit(j_make_train_step(cfg, opt))
    losses = []
    for step in range(n_steps):
        batch = {k: jnp.asarray(v)
                 for k, v in j_make_batch(cfg, shape, step, n_rows=2, seed=seed).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    return init, losses


def _port_trajectory(init, seed=0, **kw):
    from repro_torch.launch.train import train

    _, losses = train("deepseek-v2-236b", smoke=True, steps=3, rows=2, seq=16, lr=1e-3,
                      seed=seed, device="cpu", params=params_from_jax(init, device="cpu"),
                      **kw)
    return losses


def test_train_three_steps_match_reference_trajectory():
    """3 ``train()`` steps with both ws kernels (plain versions on the CPU)
    from the reference's initial parameters track the reference's jitted
    trajectory; the port's dense dispatch, drop-free at the smoke
    capacity factor, tracks it too."""
    init, want = _reference_trajectory(
        J_SMOKE.replace(moe_dispatch="ws", moe_grad_dispatch="ws"))
    ws = _port_trajectory(init, moe_dispatch="ws", moe_grad_dispatch="ws")
    dense = _port_trajectory(init, moe_dispatch="dense")
    assert len(ws) == 3 and all(np.isfinite(ws))
    np.testing.assert_allclose(ws, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(dense, ws, rtol=0, atol=1e-3)


def _port_run_train_steps(cfg, n_steps=3, seed=0):
    """The port's twin of the reference's ``_run_train_steps``, through
    ``make_optimizer`` / ``make_train_step`` / ``make_batch``."""
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import ShapeConfig, init_params

    shape = ShapeConfig("custom", "train", 16, 2)
    opt = make_optimizer(cfg, total_steps=n_steps, peak_lr=1e-3)
    params = init_params(cfg, seed=seed, device="cpu")
    state = {"params": params, "opt": opt.init(params)}
    step_fn = make_train_step(cfg, opt)
    losses = []
    for step in range(n_steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(cfg, shape, step, n_rows=2, seed=seed).items()}
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
    return losses


def test_train_ws_diverges_from_dense_when_dense_drops():
    """With the dense capacity starved (cf 0.25) the dense dispatch drops
    tokens and optimises another objective: the dropless ws trajectory must
    move away from it while staying finite."""
    cfg = SMOKE.replace(capacity_factor=0.25)
    ws = _port_run_train_steps(cfg.replace(moe_dispatch="ws", moe_grad_dispatch="ws"), seed=1)
    dense = _port_run_train_steps(cfg.replace(moe_dispatch="dense"), seed=1)
    assert all(np.isfinite(ws))
    assert max(abs(a - b) for a, b in zip(ws, dense)) > 1e-5


def test_step_grads_are_freed_without_the_cycle_collector():
    """A step's gradient tree is released as soon as the caller drops it: no
    reference cycle may hold it until the cyclic collector runs (at full
    width each extra tree is 10 GB beside 60 GB of parameters, AdamW states
    and the live gradients)."""
    import gc
    import weakref

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params

    cfg = SMOKE.replace(moe_dispatch="ws", moe_grad_dispatch="ws")
    params = init_params(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(10).integers(0, SMOKE.vocab_size, (2, 16)))}
    loss_and_grads(params, cfg, batch)  # first call: lazy imports may leave cycles
    gc.collect()
    gc.disable()
    try:
        _, _, grads = loss_and_grads(params, cfg, batch)
        refs = [weakref.ref(g) for g in jax.tree_util.tree_leaves(grads)]
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_train_entry_point_raises_what_is_not_ported(monkeypatch):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train

    with pytest.raises(ValueError, match="ws-bogus"):
        train("deepseek-v2-236b", steps=1, device="cpu", ws_mode="ws-bogus")
    with pytest.raises(ValueError, match="not in"):
        make_train_step(SMOKE, None, ws_mode="ws-bogus", n_workers=4)
    with pytest.raises(ValueError, match="mesh-ws"):
        make_train_step(SMOKE.replace(moe_dispatch="mesh-ws"), None, ws_mode="ws-wmult",
                        n_workers=4)
    with pytest.raises(ValueError, match="mesh-ws"):
        make_train_step(SMOKE.replace(moe_dispatch="mesh-ws"), None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train("deepseek-v2-236b", steps=1)
