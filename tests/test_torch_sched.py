"""The port's work-stealing scheduler (``repro_torch.sched``) and its
training integration against the JAX package's ``repro.sched``, on the CPU.

* the hash, ``pick_tasks`` (both victim policies, with ties),
  ``pick_ranked``, ``sync_views`` and ``resolve_claims`` on seeded views:
  bit-equal, one worker at a time and all workers at once;
* ``schedule_rounds`` and ``run_lockstep_rounds`` for every mode x
  ``sync_every`` in {1, 3} x six tails (four fixed skews, two seeded):
  assignment, counts, done_round and ``RoundStats`` bit-equal;
* ``async_makespan`` for static, ws-mult, ws-wmult and b-ws-wmult on seeded
  durations and with a straggler: every ``SimResult`` field equal;
* ``ws_accumulate_grads`` on the reference's toy loss (its cases, and
  [12, 0, 0, 0] with ``sync_every`` 3): against the reference and against
  the full batch at rtol 1e-5;
* ``make_train_step(ws_mode=...)`` on llama3.2-3b smoke from the
  reference's parameters against the reference's step (ws-wmult and
  ws-wmult-deque), and every mode against the port's own plain step: loss
  within rtol 2e-5, parameters within rtol 3e-4 and atol 3e-5 (the
  reference's own tolerances, tests/test_launch.py);
* ``_skewed_tails`` and two ``train(ws_mode="ws-wmult")`` steps against
  the reference's; the CLI's ``--ws-mode``;
* a ``cuda`` twin of the exactness case (no JAX), which skips here.

JAX is imported inside the tests that use it, so the ``cuda`` case runs on
a machine without it: ``python -m pytest -m cuda tests/test_torch_sched.py``.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.sched import (
    MODES,
    async_makespan,
    pick_ranked,
    pick_tasks,
    resolve_claims,
    run_lockstep_rounds,
    schedule_rounds,
    sync_views,
    ws_accumulate_grads,
)
from repro_torch.sched.policy import _hash, queue_bases

N_TASKS, ROWS, SEQ, N_WORKERS = 8, 2, 16, 4
STEP_TAILS = [5, 1, 1, 1]  # tests/test_launch.py's skewed queues


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return jnp


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _views(seed, n_q=5, ties=False):
    """Seeded tails and one view per worker (views never past the tails);
    with ``ties`` several queues hold the same remaining count."""
    rng = np.random.default_rng(seed)
    if ties:
        tails = np.full(n_q, 4, dtype=np.int32)
        tails[rng.integers(n_q)] = 0
        views = rng.integers(0, 2, (n_q, n_q)).astype(np.int32) * 2
    else:
        tails = rng.integers(0, 7, n_q).astype(np.int32)
        views = rng.integers(0, 7, (n_q, n_q)).astype(np.int32)
    return tails, np.minimum(views, tails[None, :])


def test_hash_and_bases_match_reference():
    jnp = _jnp()
    from repro.sched.policy import _hash as j_hash
    from repro.sched.policy import queue_bases as j_bases

    x = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(j_hash(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(_hash(torch.from_numpy(x.astype(np.int64))).numpy(), want)
    np.testing.assert_array_equal(_hash(torch.from_numpy(x.view(np.int32))).numpy(), want)
    tails = np.array([3, 0, 2, 5], dtype=np.int32)
    np.testing.assert_array_equal(queue_bases(torch.from_numpy(tails)).numpy(),
                                  np.asarray(j_bases(jnp.asarray(tails))))


@pytest.mark.parametrize("seed", range(4))
def test_pick_tasks_matches_reference(seed):
    jnp = _jnp()
    from repro.sched.policy import pick_tasks as j_pick

    for ties in (False, True):
        tails, views = _views(seed, ties=ties)
        n_q = len(tails)
        for policy in ("richest", "random"):
            batched = pick_tasks(torch.from_numpy(views), torch.from_numpy(tails),
                                 torch.arange(n_q), salt=seed + 3, victim_policy=policy)
            for w in range(n_q):
                want = j_pick(jnp.asarray(views[w]), jnp.asarray(tails), jnp.int32(w),
                              salt=seed + 3, victim_policy=policy)
                got = pick_tasks(torch.from_numpy(views[w]), torch.from_numpy(tails), w,
                                 salt=seed + 3, victim_policy=policy)
                for g, b, j in zip(got, batched, want):
                    assert g.dtype == torch.int32
                    np.testing.assert_array_equal(g.numpy(), np.asarray(j))
                    np.testing.assert_array_equal(b[w].numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(4))
def test_pick_ranked_matches_reference(seed):
    jnp = _jnp()
    from repro.sched.policy import pick_ranked as j_ranked

    for ties in (False, True):
        tails, views = _views(seed, ties=ties)
        n_q = len(tails)
        synced = np.broadcast_to(views.max(0), views.shape).copy()  # a synced view
        for vs in (synced, views):
            batched = pick_ranked(torch.from_numpy(vs), torch.from_numpy(tails),
                                  torch.arange(n_q), n_q)
            for w in range(n_q):
                want = j_ranked(jnp.asarray(vs[w]), jnp.asarray(tails), jnp.int32(w), n_q)
                got = pick_ranked(torch.from_numpy(vs[w]), torch.from_numpy(tails), w, n_q)
                for g, b, j in zip(got, batched, want):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(j))
                    np.testing.assert_array_equal(b[w].numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(4))
def test_sync_views_and_resolve_claims_match_reference(seed):
    jnp = _jnp()
    from repro.sched.policy import resolve_claims as j_claims
    from repro.sched.policy import sync_views as j_sync

    rng = np.random.default_rng(seed)
    views = rng.integers(0, 9, (4, 6)).astype(np.int32)
    np.testing.assert_array_equal(sync_views(torch.from_numpy(views)).numpy(),
                                  np.asarray(j_sync(jnp.asarray(views))))
    n_tasks = 5
    for _ in range(8):
        tasks = rng.integers(-1, n_tasks, 6).astype(np.int32)  # collisions and idles
        wids = rng.permutation(6).astype(np.int32)
        got = resolve_claims(torch.from_numpy(tasks), torch.from_numpy(wids), n_tasks)
        want = j_claims(jnp.asarray(tasks), jnp.asarray(wids), n_tasks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mesh_forms_raise():
    v = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="needs an initialised process group"):
        sync_views(v, axis_name="dp")
    with pytest.raises(RuntimeError, match="needs an initialised process group"):
        resolve_claims(v[0], v[0], 2, axis_name="dp")
    with pytest.raises(ValueError, match="not in"):
        schedule_rounds(torch.tensor([1, 1]), 2, "ws-bogus", 1, 2, 2)


_SEEDED = [np.random.default_rng(s).integers(0, 9, 4).tolist() for s in (5, 6)]
TAILS = [[4, 4, 4, 4], [10, 2, 2, 2], [12, 0, 0, 0], [5, 1, 1, 1], *_SEEDED]


@pytest.mark.parametrize("tails", TAILS, ids=lambda t: "-".join(map(str, t)))
@pytest.mark.parametrize("sync_every", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_schedule_matches_reference(mode, sync_every, tails):
    jnp = _jnp()
    from repro.sched import run_lockstep_rounds as j_run
    from repro.sched.rounds import _run as j_schedule

    n_tasks = sum(tails)
    for max_rounds in (n_tasks, n_tasks // 2 + 1):
        want = j_schedule(jnp.asarray(tails, dtype=jnp.int32), 4, mode, sync_every,
                          max_rounds, n_tasks)
        got = schedule_rounds(torch.tensor(tails), 4, mode, sync_every, max_rounds, n_tasks)
        for g, j in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    a, c, stats = run_lockstep_rounds(tails, 4, mode=mode, sync_every=sync_every)
    ja, jc, jstats = j_run(tails, 4, mode=mode, sync_every=sync_every)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.duplicate_ratio == jstats.duplicate_ratio


def _durations(case):
    rng = np.random.default_rng(0 if case == "seeded" else 1)
    n_tasks, n_workers = (96, 6) if case == "seeded" else (128, 8)
    durations = rng.lognormal(mean=-7, sigma=0.5, size=n_tasks)
    owner = rng.integers(0, n_workers, n_tasks)
    speed = np.ones(n_workers)
    if case == "straggler":
        speed[0] = 0.2
    return durations, owner, n_workers, speed


@pytest.mark.parametrize("case", ["seeded", "straggler"])
@pytest.mark.parametrize("mode", ["static", "ws-mult", "ws-wmult", "b-ws-wmult"])
def test_async_makespan_matches_reference(mode, case):
    _jnp()
    from repro.sched import async_makespan as j_makespan

    durations, owner, n_workers, speed = _durations(case)
    got = async_makespan(durations, owner, n_workers, mode, worker_speed=speed, seed=2)
    want = j_makespan(durations, owner, n_workers, mode, worker_speed=speed, seed=2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.efficiency == want.efficiency


def _toy_loss_torch(params, micro):
    return ((micro["x"] - params["w"]) ** 2).mean(dim=-1)


def _toy_loss_jax(params, micro):
    return ((micro["x"] - params["w"]) ** 2).mean(axis=-1)


@pytest.mark.parametrize("case", [*itertools.product(MODES, ([4, 4, 4, 4], [10, 2, 2, 2])),
                                  ("ws-wmult", [12, 0, 0, 0])],
                         ids=lambda c: f"{c[0]}-{'-'.join(map(str, c[1]))}")
def test_ws_accumulate_matches_reference(case):
    """The reference's toy cases (tests/test_sched.py): against the
    reference's ``ws_accumulate_grads`` and against the full batch."""
    import jax

    jnp = _jnp()
    from repro.sched import ws_accumulate_grads as j_acc

    mode, tails = case
    sync_every, slack = (3, 8) if tails == [12, 0, 0, 0] else (1, 4)
    rng = np.random.default_rng(1 if tails == [12, 0, 0, 0] else 0)
    n_tasks, d = sum(tails), 4 if tails == [12, 0, 0, 0] else 8
    x = rng.normal(size=(n_tasks, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    kw = dict(n_workers=4, mode=mode, sync_every=sync_every, slack=slack)
    loss, grads, aux = ws_accumulate_grads(_toy_loss_torch, {"w": torch.from_numpy(w.copy())},
                                           {"x": torch.from_numpy(x)}, torch.tensor(tails),
                                           **kw)
    jloss, jgrads, jaux = j_acc(_toy_loss_jax, {"w": jnp.asarray(w)}, {"x": jnp.asarray(x)},
                                jnp.asarray(tails, dtype=jnp.int32), **kw)
    np.testing.assert_array_equal(aux["counts"].numpy(), np.asarray(jaux["counts"]))
    assert int(aux["extractions"]) == int(jaux["extractions"]) >= n_tasks
    assert float(aux["coverage"]) == float(jaux["coverage"])
    np.testing.assert_allclose(float(aux["loss_weight"]), float(jaux["loss_weight"]), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(jgrads["w"]), rtol=1e-5, atol=1e-6)
    assert grads["w"].dtype == torch.float32
    if float(jaux["coverage"]) == 1.0:
        ref_l, ref_g = jax.value_and_grad(
            lambda p: _toy_loss_jax(p, {"x": jnp.asarray(x)}).mean())({"w": jnp.asarray(w)})
        np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-5)
        np.testing.assert_allclose(grads["w"].numpy(), np.asarray(ref_g["w"]), rtol=1e-5,
                                   atol=1e-6)


def test_ws_accumulate_skips_only_empty_rounds():
    """Rounds whose picks are all -1 are not run: a budget past the last
    pick runs the same rounds to the same result, and such a round (row 0
    gathered at weight 0, as the reference's scan runs it) adds exact
    zeros."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    w = rng.normal(size=(6,)).astype(np.float32)
    calls = []

    def loss(p, micro):
        calls.append(micro["x"].shape[0])
        return _toy_loss_torch(p, micro)

    tails = torch.tensor([8, 0, 0, 0])
    runs = []
    for max_rounds in (None, 12):
        calls.clear()
        runs.append(ws_accumulate_grads(loss, {"w": torch.from_numpy(w.copy())}, {"x": x},
                                        tails, n_workers=4, mode="static",
                                        max_rounds=max_rounds))
        assert calls == [4] * 8  # static: only worker 0 picks, one task a round
    assert torch.equal(runs[0][1]["w"], runs[1][1]["w"]) and float(runs[0][0]) == float(runs[1][0])
    p = {"w": torch.from_numpy(w.copy()).requires_grad_(True)}
    empty = (_toy_loss_torch(p, {"x": x[[0, 0, 0, 0]]}) * torch.zeros(4)).sum()
    (g,) = torch.autograd.grad(empty, [p["w"]])
    assert float(empty) == 0.0 and not g.any()


@pytest.mark.parametrize("mode", ["static", "ws-wmult"])
def test_ws_accumulate_acc_dtype(mode):
    """``acc_dtype`` None keeps the parameters' dtype (bf16 stays bf16); a
    wider accumulator, asked for by name, returns its dtype and the same
    gradient within the narrower one's rounding."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    w = rng.normal(size=(6,)).astype(np.float32)
    kw = dict(n_workers=4, mode=mode)
    tails = torch.tensor([5, 1, 1, 1])
    full = torch.func.grad(lambda p: _toy_loss_torch(p, {"x": x}).mean())(
        {"w": torch.from_numpy(w.copy())})["w"]
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        for acc in (None, torch.float64 if dt == torch.float32 else torch.float32):
            _, g, aux = ws_accumulate_grads(_toy_loss_torch, {"w": torch.from_numpy(w).to(dt)},
                                            {"x": x.to(dt)}, tails, acc_dtype=acc, **kw)
            assert g["w"].dtype == (acc or dt) and float(aux["coverage"]) == 1.0
            got[dt, acc] = g["w"]
    np.testing.assert_allclose(got[torch.float32, torch.float64].numpy(),
                               got[torch.float32, None].double().numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[torch.float32, None].numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)
    for acc in (None, torch.float32):
        np.testing.assert_allclose(got[torch.bfloat16, acc].float().numpy(), full.numpy(),
                                   rtol=3e-2, atol=3e-2)


def _llama_smoke():
    from repro_torch.configs.llama3_2_3b import SMOKE

    return SMOKE


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (N_TASKS, ROWS, SEQ))


def _port_step(cfg, params, tokens, ws_mode, device="cpu"):
    from repro_torch.launch.steps import make_optimizer, make_train_step

    opt = make_optimizer(cfg, total_steps=10)
    state = {"params": params, "opt": opt.init(params)}
    t = torch.from_numpy(tokens).to(device)
    if ws_mode is None:
        step, batch = make_train_step(cfg, opt), {"tokens": t.reshape(N_TASKS * ROWS, SEQ)}
    else:
        step = make_train_step(cfg, opt, ws_mode=ws_mode, n_workers=N_WORKERS)
        batch = {"tokens": t, "tails": torch.tensor(STEP_TAILS)}
    return step(state, batch)


def _assert_step_close(got, want):
    (gstate, gm), (wstate, wm) = got, want
    np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=2e-5)
    from repro_torch.optim import tree_leaves

    for a, b in zip(tree_leaves(gstate["params"]), tree_leaves(wstate["params"])):
        np.testing.assert_allclose(_np(a.detach().float()), _np(b.detach().float()),
                                   rtol=3e-4, atol=3e-5)


@pytest.fixture(scope="module")
def reference_llama():
    """The reference's llama smoke config and parameters."""
    import jax

    from repro.configs import get_config
    from repro.models import init_params as j_init

    cfg = get_config("llama3.2-3b", smoke=True)
    return cfg, j_init(jax.random.PRNGKey(0), cfg)


def _reference_step(jcfg, jparams, tokens, ws_mode):
    """The reference's jitted step: (params as port tensors, loss, metrics)."""
    import jax

    jnp = _jnp()
    from repro.launch.steps import make_optimizer as j_make_opt
    from repro.launch.steps import make_train_step as j_make_step
    from repro_torch.convert import params_from_jax

    opt = j_make_opt(jcfg, total_steps=10)
    state = {"params": jparams, "opt": opt.init(jparams)}
    if ws_mode is None:
        step = jax.jit(j_make_step(jcfg, opt))
        batch = {"tokens": jnp.asarray(tokens.reshape(N_TASKS * ROWS, SEQ), dtype=jnp.int32)}
    else:
        step = jax.jit(j_make_step(jcfg, opt, ws_mode=ws_mode, n_workers=N_WORKERS))
        batch = {"tokens": jnp.asarray(tokens, dtype=jnp.int32),
                 "tails": jnp.asarray(STEP_TAILS, dtype=jnp.int32)}
    new, m = step(state, batch)
    return ({"params": params_from_jax(jax.device_get(new["params"]), device="cpu")},
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("mode", ["ws-wmult", "ws-wmult-deque"])
def test_ws_grads_match_reference(reference_llama, mode):
    """``ws_accumulate_grads`` over the model loss (the step's flat
    contract): counts equal, loss within rtol 2e-5, every gradient within
    1e-6 of the reference's (magnitudes <= 0.07)."""
    import jax

    jnp = _jnp()
    from repro.models import loss_fn as j_loss
    from repro.sched import ws_accumulate_grads as j_acc
    from repro_torch.convert import params_from_jax
    from repro_torch.models import loss_fn
    from repro_torch.optim import tree_leaves

    jcfg, jparams = reference_llama
    cfg = _llama_smoke()
    tokens = _tokens(cfg)

    def j_flat(p, flat, row_w):
        return j_loss(p, jcfg, flat, row_weights=row_w)[0]

    def flat(p, f, row_w):
        return loss_fn(p, cfg, f, row_weights=row_w)[0]

    jl, jg, jaux = jax.jit(lambda p, b, t: j_acc(j_flat, p, b, t, n_workers=N_WORKERS, mode=mode,
                                                 flat_loss=True))(
        jparams, {"tokens": jnp.asarray(tokens, dtype=jnp.int32)},
        jnp.asarray(STEP_TAILS, dtype=jnp.int32))
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    loss, grads, aux = ws_accumulate_grads(flat, params, {"tokens": torch.from_numpy(tokens)},
                                           torch.tensor(STEP_TAILS), n_workers=N_WORKERS,
                                           mode=mode, flat_loss=True)
    np.testing.assert_array_equal(aux["counts"].numpy(), np.asarray(jaux["counts"]))
    assert int(aux["extractions"]) > N_TASKS  # duplicates, divided back out
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
    for g, j in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jg)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["ws-wmult", "ws-wmult-deque"])
def test_ws_step_matches_reference_step(reference_llama, mode):
    """The port's ws step against the reference's: the metrics, the loss
    within rtol 2e-5, and every parameter within rtol 3e-4 + atol 3e-5 of
    the reference's; an element past that may miss by as far as the two
    packages' plain steps lie apart there, if they too miss the tolerance
    there, at no more than 4 elements in all.  (AdamW's first update is g / (|g| + 1e-8): at a gradient of
    ~1e-8 the two packages' last-bit sums give different updates, so one
    element of the plain steps misses the bare tolerance too; the gradients
    themselves agree within 1e-6, test_ws_grads_match_reference.)"""
    import jax
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import tree_leaves

    jcfg, jparams = reference_llama
    cfg = _llama_smoke()
    tokens = _tokens(cfg)
    want, jm = _reference_step(jcfg, jparams, tokens, mode)
    want_plain, _ = _reference_step(jcfg, jparams, tokens, None)
    got = _port_step(cfg, params_from_jax(jax.device_get(jparams), device="cpu"), tokens, mode)
    plain = _port_step(cfg, params_from_jax(jax.device_get(jparams), device="cpu"), tokens, None)
    np.testing.assert_allclose(got[1]["loss"], jm["loss"], rtol=2e-5)
    assert got[1]["ws_coverage"] == jm["ws_coverage"] == 1.0
    assert got[1]["ws_extractions"] == jm["ws_extractions"]
    assert got[1]["ce"] == got[1]["loss"] and sorted(got[1]) == sorted(jm)
    n_slack = 0
    for a, b, pa, pb in zip(*(tree_leaves(t["params"]) for t in (got[0], want, plain[0],
                                                                  want_plain))):
        a, b, pa, pb = (t.detach().numpy() for t in (a, b, pa, pb))
        miss = np.abs(a - b) > 3e-5 + 3e-4 * np.abs(b)
        # the plain steps' distance is added only where the plain steps
        # themselves miss the bare tolerance, and only at a handful of elements
        assert (np.abs(pa - pb) > 3e-5 + 3e-4 * np.abs(pb))[miss].all()
        assert (np.abs(a - b) <= 3e-5 + 3e-4 * np.abs(b) + np.abs(pa - pb))[miss].all()
        n_slack += int(miss.sum())
    assert n_slack <= 4, n_slack


@pytest.mark.parametrize("mode", MODES)
def test_ws_step_matches_plain_step(mode):
    """Every mode's step equals the plain full-batch step at the reference's
    tolerances (the 1/count weighting makes the relaxation exact)."""
    from repro_torch.models import init_params

    cfg = _llama_smoke()
    tokens = _tokens(cfg)
    plain = _port_step(cfg, init_params(cfg, seed=0, device="cpu"), tokens, None)
    got = _port_step(cfg, init_params(cfg, seed=0, device="cpu"), tokens, mode)
    assert got[1]["ws_coverage"] == 1.0
    _assert_step_close(got, plain)


@pytest.mark.cuda
def test_ws_step_matches_plain_step_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import init_params

    cfg = _llama_smoke()
    tokens = _tokens(cfg)
    for mode in MODES:
        plain = _port_step(cfg, init_params(cfg, seed=0, device="cuda"), tokens, None, "cuda")
        got = _port_step(cfg, init_params(cfg, seed=0, device="cuda"), tokens, mode, "cuda")
        assert got[1]["ws_coverage"] == 1.0
        _assert_step_close(got, plain)
        cpu = schedule_rounds(torch.tensor(STEP_TAILS), N_WORKERS, mode, 1, N_TASKS, N_TASKS)
        card = schedule_rounds(torch.tensor(STEP_TAILS, device="cuda"), N_WORKERS, mode, 1,
                               N_TASKS, N_TASKS)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)), mode


def test_ws_step_refuses_unknown_modes():
    from repro_torch.launch.steps import make_train_step

    cfg = _llama_smoke()
    with pytest.raises(ValueError, match="not in"):
        make_train_step(cfg, None, ws_mode="ws-bogus", n_workers=4)
    with pytest.raises(ValueError, match="n_workers"):
        make_train_step(cfg, None, ws_mode="ws-wmult")


def test_skewed_tails_match_reference():
    _jnp()
    from repro.launch.train import _skewed_tails as j_tails
    from repro_torch.launch.train import _skewed_tails

    for step, skew, n_w, n_tasks in itertools.product(range(4), (0.5, 1.0, 4.0, 16.0), (2, 4),
                                                      (8, 13)):
        got = _skewed_tails(n_tasks, n_w, step, skew)
        np.testing.assert_array_equal(got, j_tails(n_tasks, n_w, step, skew))
        assert got.sum() == n_tasks


def test_train_ws_steps_match_reference(reference_llama):
    import jax

    from repro.launch.train import train as j_train
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.train import train

    jcfg, jparams = reference_llama
    kw = dict(smoke=True, steps=2, rows=8, seq=16, ws_mode="ws-wmult", skew=4.0, log_every=1)
    _, want = j_train("llama3.2-3b", **kw)
    _, got = train("llama3.2-3b", device="cpu",
                   params=params_from_jax(jax.device_get(jparams), device="cpu"), **kw)
    assert len(got) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_train_cli_runs_ws_mode(capsys):
    from repro_torch.launch.train import main

    assert main(["--arch", "llama3.2-3b", "--steps", "3", "--ws-mode", "ws-wmult", "--skew",
                 "4", "--device", "cpu", "--seq", "16", "--log-every", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if '"ws_coverage"' in ln]
    assert len(lines) == 3 and all('"ws_coverage": 1.0' in ln for ln in lines)
