"""The port's cross-device expert stealing (``repro_torch.mesh_ws``) against
the JAX package's ``repro.mesh_ws``, in one process on the CPU.

* ``route_local_pool_torch`` against ``route_local_pool_jax``, field for
  field, on every device of the reference's ``_mesh_problem_from`` draws
  (copied below from ``tests/test_dispatch_conformance.py``);
* ``hops_matrix``, ``plan_steals``, ``steal_queue_state``,
  ``reduce_advisory``, ``donated_cost``, ``apply_donation``,
  ``exchange_payload_bytes`` and ``mesh_wstrace`` bit for bit, D in {1, 2,
  4, 8} and alpha in {0, 1, 3};
* two calls of the reference's ``emulate_mesh_dispatch`` (8–14 s each): a
  clean seed with a steal, and an adversarial plan with two thieves on one
  segment of an unaware victim.  The port's emulation in lockstep gives
  bit-equal ``adv``, ``plans``, ``mult_total``, ``clocks`` and ``tails``
  and y within the reference's ``rtol=1e-5, atol=1e-6``;
* the port's emulation in free mode (the plain walk) against the port's
  no-drop oracle: clean, stale-advisory and adversarial plans, the writer
  counts the combine divides by;
* a ``cuda`` case (no JAX) that runs the phase-1 budget and the free-mode
  combine on the card, which skips here:
  ``python -m pytest -m cuda tests/test_torch_mesh.py``.

JAX is imported inside the tests that use it (the ``ref`` fixture).  The
rank-level path (gloo process groups) is ``tests/test_torch_mesh_ranks.py``.
"""

import random

import numpy as np
import pytest
import torch

from repro_torch.mesh_ws import (
    TELE_FIELDS,
    StealPlan,
    apply_donation,
    donated_cost,
    emulate_mesh_dispatch,
    exchange_payload_bytes,
    expert_ffn_mesh_ws,
    expert_shard,
    hops_matrix,
    mesh_wstrace,
    plan_steals,
    reduce_advisory,
    route_local_pool_torch,
    steal_queue_state,
)
from repro_torch.moe_ws import expert_ffn_nodrop_ref

RTOL, ATOL = 1e-5, 1e-6   # the reference's own allclose for the mesh


@pytest.fixture(scope="module")
def ref():
    """The reference's mesh package (JAX on the CPU)."""
    pytest.importorskip("jax")
    import repro.mesh_ws as ref_mesh

    return ref_mesh


def _rng_draws(seed):
    rng = random.Random(seed)
    return (lambda lo, hi: rng.randint(lo, hi)), (lambda: rng.random() < 0.5)


def _mesh_problem_from(draw_int):
    """The reference's draw of a mesh-sharded MoE problem (device count,
    expert shard, uniform / hot-shard / empty-expert routing, inputs and
    weights), as ``tests/test_dispatch_conformance.py`` has it."""
    D = (2, 4)[draw_int(0, 1)]
    El = draw_int(1, 2)
    E = D * El
    T = draw_int(1, 10)
    k = draw_int(1, min(2, E))
    bt = (2, 4)[draw_int(0, 1)]
    seed = draw_int(0, 2**16)
    rng = np.random.RandomState(seed)
    shape = draw_int(0, 2)
    if shape == 0:        # uniform
        idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    elif shape == 1:      # hot: mass on device 0's shard (what makes devices steal)
        hot = max(k, El)
        idx = np.stack([
            rng.choice(hot if rng.rand() < 0.75 else E, k, replace=False)
            for _ in range(T)
        ])
    else:                 # empty experts: restrict to a drawn subset
        alive = rng.choice(E, max(k, draw_int(k, E)), replace=False)
        idx = np.stack([rng.choice(alive, k, replace=False) for _ in range(T)])
    idx = idx.astype(np.int32)
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    d, f = 4, 8
    x = rng.randn(T, d).astype(np.float32)
    wg = (0.1 * rng.randn(E, d, f)).astype(np.float32)
    wu = (0.1 * rng.randn(E, d, f)).astype(np.float32)
    wd = (0.1 * rng.randn(E, f, d)).astype(np.float32)
    return D, E, T, k, bt, idx, gates, x, wg, wu, wd


def _problem(seed):
    return _mesh_problem_from(_rng_draws(seed)[0])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


# draws of the reference's seeded slices (30x clean, 40x stale, 60x
# adversarial, 700 the degenerate mesh): D 2 and 4, El 1 and 2, bt 2 and 4,
# uniform, hot and empty-expert routings
PUT_SEEDS = (301, 401, 600, 602, 700)


@pytest.mark.parametrize("seed", PUT_SEEDS)
def test_route_local_pool_matches_reference(ref, seed):
    D, E, T, k, bt, idx, gates, *_ = _problem(seed)
    El = expert_shard(E, D)
    for m in range(D):
        want = ref.route_local_pool_jax(idx, gates, E, m * El, El, bt)
        got = route_local_pool_torch(_t(idx), _t(gates), E, m * El, El, bt)
        for f in ("records", "tail", "toff", "tile_expert", "tile_index"):
            _eq(getattr(got, f), getattr(want, f), f"device {m} {f}")
        for f in ("tok_idx", "gates", "expert_off", "loads", "row_src"):
            _eq(getattr(got.routed, f), getattr(want.routed, f), f"device {m} routed.{f}")
        for f in ("n_rows", "n_routed", "n_tokens"):
            assert getattr(got.routed, f) == getattr(want.routed, f), f


def test_route_local_pool_refuses_an_uneven_mesh():
    with pytest.raises(ValueError, match="not divisible"):
        expert_shard(6, 4)
    with pytest.raises(ValueError, match=">= 1 device"):
        expert_shard(6, 0)


@pytest.mark.parametrize("D", (1, 2, 4, 8))
def test_hops_matrix_matches_reference(ref, D):
    _eq(hops_matrix(D), ref.hops_matrix(D), f"hops D={D}")


def _snapshots(D, El, seed):
    """Seeded post-exchange snapshots: idle devices (advisory 0), loaded
    ones, heads past and short of their tails, empty queues."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, 6, (D, El)).astype(np.int32)
    head = np.minimum(rng.integers(-1, 4, (D, El)), tail + 1).astype(np.int32)
    adv = np.where(rng.random(D) < 0.5, 0, rng.integers(1, 40, D)).astype(np.int32)
    adv[rng.integers(D)] = 0            # at least one thief
    return adv, head, tail


@pytest.mark.parametrize("alpha", (0, 1, 3))
@pytest.mark.parametrize("D", (1, 2, 4, 8))
def test_plan_steals_matches_reference(ref, D, alpha):
    import jax.numpy as jnp

    for seed in range(2):
        adv, head, tail = _snapshots(D, 3, 100 * D + 10 * alpha + seed)
        for me in range(D):
            want = ref.plan_steals(jnp.asarray(adv), jnp.asarray(head), jnp.asarray(tail),
                                   jnp.int32(me), n_devices=D, bt=4, alpha=alpha)
            got = plan_steals(_t(adv), _t(head), _t(tail), me, n_devices=D, bt=4, alpha=alpha)
            for f in StealPlan._fields:
                _eq(getattr(got, f), getattr(want, f), f"D={D} alpha={alpha} me={me} {f}")


@pytest.mark.parametrize("D", (1, 2, 4, 8))
def test_steal_queue_state_matches_reference(ref, D):
    import jax.numpy as jnp

    E, T, k, bt, P = 2 * D, 11, 2, 2, 3
    rng = np.random.default_rng(D)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    gates = np.full((T, k), 0.5, np.float32)
    El = E // D
    jputs = [ref.route_local_pool_jax(idx, gates, E, m * El, El, bt) for m in range(D)]
    tputs = [route_local_pool_torch(_t(idx), _t(gates), E, m * El, El, bt) for m in range(D)]
    pool_tiles = tputs[0].records.shape[0]
    adv, head, _ = _snapshots(D, El, D)
    tail = np.stack([np.asarray(p.tail) for p in jputs])
    for me in range(D):
        jplan = ref.plan_steals(jnp.asarray(adv), jnp.asarray(head), jnp.asarray(tail),
                                jnp.int32(me), n_devices=D, bt=bt)
        tplan = plan_steals(_t(adv), _t(head), _t(tail), me, n_devices=D, bt=bt)
        want = ref.steal_queue_state(jnp.stack([p.records for p in jputs]),
                                     jnp.stack([p.toff[:El + 1] for p in jputs]), jplan,
                                     n_programs=P, pool_tiles=pool_tiles, bt=bt)
        got = steal_queue_state(torch.stack([p.records for p in tputs]),
                                torch.stack([p.toff[:El + 1] for p in tputs]), tplan,
                                n_programs=P, pool_tiles=pool_tiles, bt=bt,
                                victim=int(tplan.victim))
        for f in ("tasks", "head", "tail", "local_head", "taken", "remaining", "pool_off"):
            _eq(getattr(got, f), getattr(want, f), f"D={D} me={me} {f}")
        assert got.n_tasks_hint == want.n_tasks_hint


@pytest.mark.parametrize("seed", (301, 401, 601, 12))
def test_advisory_functions_match_reference(ref, seed):
    import jax.numpy as jnp

    D, E, T, k, bt, idx, gates, *_ = _problem(seed)
    El = E // D
    rng = np.random.default_rng(seed)
    for m in range(D):
        jput = ref.route_local_pool_jax(idx, gates, E, m * El, El, bt)
        tput = route_local_pool_torch(_t(idx), _t(gates), E, m * El, El, bt)
        remaining = rng.integers(-3, 9, El).astype(np.int32)   # stale-low entries too
        _eq(reduce_advisory(_t(remaining)), ref.reduce_advisory(jnp.asarray(remaining)),
            "reduce_advisory")
        new_tail = np.minimum(rng.integers(0, 4, El), np.asarray(jput.tail)).astype(np.int32)
        don = donated_cost(tput, _t(new_tail))
        _eq(don, ref.donated_cost(jput, jnp.asarray(new_tail)), "donated_cost")
        _eq(apply_donation(_t(remaining), don),
            ref.apply_donation(jnp.asarray(remaining), jnp.asarray(don.numpy())),
            "apply_donation")
    for D_, El_, d, f in ((1, 8, 16, 32), (4, 40, 5120, 1536), (8, 20, 7168, 2048)):
        kw = dict(n_devices=D_, pool_tiles=233, n_local=El_, n_rows=1864, n_routed=1536,
                  d=d, f=f)
        assert exchange_payload_bytes(**kw) == ref.exchange_payload_bytes(**kw)


@pytest.mark.parametrize("D", (1, 2, 4, 8))
def test_mesh_wstrace_matches_reference(ref, D):
    from repro.wstrace import to_perfetto as ref_perfetto

    from repro_torch.wstrace import to_perfetto

    rng = np.random.default_rng(D)
    tele = rng.integers(0, 30, (D, len(TELE_FIELDS))).astype(np.int32)
    tele[:, 5] = rng.integers(0, 2, D)
    tele[:, 4] = rng.integers(0, D, D)
    for cb in (None, 12345):
        want = ref.mesh_wstrace(tele, collective_bytes=cb)
        got = mesh_wstrace(torch.from_numpy(tele), collective_bytes=cb)
        assert got.mesh_phases == want.mesh_phases
        assert (got.n_programs, got.n_queues, got.makespan) == (
            want.n_programs, want.n_queues, want.makespan)
        _eq(got.events, want.events, "events")
        _eq(got.dropped, want.dropped, "dropped")
        assert to_perfetto(got) == ref_perfetto(want)


def _port_emulation(p, **kw):
    D, E, T, k, bt, idx, gates, x, wg, wu, wd = p
    return emulate_mesh_dispatch(_t(x), _t(idx), _t(gates), _t(wg), _t(wu), _t(wd),
                                 n_devices=D, bt=bt, n_programs=2, **kw)


def _held_to_reference(got, want, ref_plans=True):
    _eq(got.adv, want.adv, "adv")
    for m, (g, w) in enumerate(zip(got.mult_total, want.mult_total)):
        _eq(g, w, f"mult_total device {m}")
    for m, (g, w) in enumerate(zip(got.tails, want.tails)):
        _eq(g, w, f"tails device {m}")
    assert [tuple(c) for c in got.clocks] == [tuple(int(v) for v in c) for c in want.clocks]
    if ref_plans:
        for m, (g, w) in enumerate(zip(got.plans, want.plans)):
            for f in StealPlan._fields:
                _eq(getattr(g, f), getattr(w, f), f"plan of device {m}: {f}")
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=RTOL, atol=ATOL)


def _oracle(p):
    D, E, T, k, bt, idx, gates, x, wg, wu, wd = p
    return expert_ffn_nodrop_ref(_t(idx), _t(gates), _t(x), _t(wg), _t(wu), _t(wd)).numpy()


def _covered(em):
    for tail, mult in zip(em.tails, em.mult_total):
        n_live = int(tail.sum())
        assert bool((mult[:n_live] >= 1).all())


# seed 301 of the reference's clean slice: D 4, E 8, T 9 with device 0 hot;
# device 0 steals in the reference's plan
CLEAN_SEED = 301


def test_emulation_lockstep_matches_reference_clean(ref):
    p = _problem(CLEAN_SEED)
    D, E, T, k, bt, idx, gates, x, wg, wu, wd = p
    want = ref.emulate_mesh_dispatch(x, idx, gates, wg, wu, wd, n_devices=D, bt=bt,
                                     n_programs=2)
    got = _port_emulation(p, mode="lockstep")
    assert any(bool(pl.stole) for pl in got.plans), "the clean seed must steal"
    _held_to_reference(got, want)
    np.testing.assert_allclose(got.y.numpy(), _oracle(p), rtol=RTOL, atol=ATOL)
    _covered(got)


def _double_thief_plans(p, seed, plan_type, as_array):
    """A forced plan: two thieves pull one drawn segment of each of the
    victim's queues while the victim keeps its full tails (unaware), so the
    segment runs on three devices."""
    D, E, T, k, bt, idx, gates, *_ = p
    El = E // D
    tails = [route_local_pool_torch(_t(idx), _t(gates), E, m * El, El, bt).tail.numpy()
             for m in range(D)]
    rng = np.random.default_rng(seed)
    victim = int(np.argmax([t.sum() for t in tails]))
    thieves = [m for m in range(D) if m != victim][:2]
    s_head = np.zeros(El, np.int32)
    s_tail = np.zeros(El, np.int32)
    for q in range(El):
        if tails[victim][q]:
            s_head[q] = rng.integers(0, tails[victim][q])
            s_tail[q] = rng.integers(s_head[q] + 1, tails[victim][q] + 1)
    take = int((s_tail - s_head).sum())
    zeros = np.zeros(El, np.int32)

    def plan(m):
        stole = m in thieves
        return plan_type(victim=as_array(np.int32(victim)), stole=as_array(np.bool_(stole)),
                         s_head=as_array(s_head if stole else zeros),
                         s_tail=as_array(s_tail if stole else zeros),
                         new_tail=as_array(tails[m]),
                         take_tiles=as_array(np.int32(take if stole else 0)))

    return [plan(m) for m in range(D)], victim, thieves, s_head, s_tail


# a draw of the reference's adversarial slice with D 4 (two thieves possible)
ADV_SEED = 602


def test_emulation_lockstep_matches_reference_double_thief(ref):
    import jax.numpy as jnp

    p = _problem(ADV_SEED)
    D, E, T, k, bt, idx, gates, x, wg, wu, wd = p
    assert D == 4
    jplans, victim, thieves, s_head, s_tail = _double_thief_plans(
        p, 0, ref.StealPlan, jnp.asarray)
    tplans = _double_thief_plans(p, 0, StealPlan, lambda a: torch.from_numpy(np.asarray(a)))[0]
    want = ref.emulate_mesh_dispatch(x, idx, gates, wg, wu, wd, n_devices=D, bt=bt,
                                     n_programs=2, plans_override=jplans)
    got = _port_emulation(p, mode="lockstep", plans_override=tplans)
    _held_to_reference(got, want, ref_plans=False)
    # the segment ran on the victim and on both thieves: 3 executions a live tile
    seg = np.zeros(got.mult_total[victim].shape[0], bool)
    off = route_local_pool_torch(_t(idx), _t(gates), E, victim * (E // D), E // D,
                                 bt).toff.numpy()
    for q in range(E // D):
        seg[off[q] + s_head[q]:off[q] + s_tail[q]] = True
    assert seg.any()
    mult = got.mult_total[victim].numpy()
    assert (mult[seg] == 3).all(), mult
    np.testing.assert_allclose(got.y.numpy(), _oracle(p), rtol=RTOL, atol=ATOL)


FREE_SEEDS = (300, 301, 302, 11, 12, 13)


@pytest.mark.parametrize("seed", FREE_SEEDS)
def test_free_emulation_clean_matches_oracle(seed):
    p = _problem(seed)
    em = _port_emulation(p)
    _covered(em)
    for w, m in zip(em.writers, em.mult_total):
        assert bool(((w >= 1) == (m >= 1)).all()) and bool((w <= m).all())
    np.testing.assert_allclose(em.y.numpy(), _oracle(p), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", (400, 401, 402))
def test_free_emulation_stale_advisories_match_oracle(seed):
    draw_int, _ = _rng_draws(seed)
    p = _mesh_problem_from(draw_int)
    D, T, k = p[0], p[2], p[3]
    adv = np.array([draw_int(0, T * k) for _ in range(D)], np.int32)
    em = _port_emulation(p, adv_override=adv)
    _covered(em)
    np.testing.assert_allclose(em.y.numpy(), _oracle(p), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", (600, 601, 602, 11))
def test_free_emulation_adversarial_plans_match_oracle(seed):
    """Forced duplicates across devices: free launches store whole
    normalised tiles, so the combine divides by the devices that wrote a
    tile (victim + thieves), never by the executions."""
    p = _problem(seed)
    D = p[0]
    plans, victim, thieves, s_head, s_tail = _double_thief_plans(
        p, seed, StealPlan, lambda a: torch.from_numpy(np.asarray(a)))
    em = _port_emulation(p, plans_override=plans)
    _covered(em)
    E, bt, idx, gates = p[1], p[4], p[5], p[6]
    El = E // D
    off = route_local_pool_torch(_t(idx), _t(gates), E, victim * El, El, bt).toff.numpy()
    n_live = int(em.tails[victim].sum())
    want = np.ones(n_live, np.int32)
    for q in range(El):
        want[off[q] + s_head[q]:off[q] + s_tail[q]] += len(thieves)
    _eq(em.writers[victim][:n_live], want, "writers of the victim's tiles")
    np.testing.assert_allclose(em.y.numpy(), _oracle(p), rtol=RTOL, atol=ATOL)


def test_one_device_mesh_without_process_group_matches_oracle():
    from repro_torch.launch.mesh import make_expert_mesh

    p = _problem(700)
    D, E, T, k, bt, idx, gates, x, wg, wu, wd = p
    mesh = make_expert_mesh(E, 1)
    for mode in ("free", "lockstep"):
        y, tele = expert_ffn_mesh_ws(idx, gates, _t(x), _t(wg), _t(wu), _t(wd), mesh=mesh,
                                     bt=bt, mode=mode, return_telemetry=True)
        np.testing.assert_allclose(y.numpy(), _oracle(p), rtol=RTOL, atol=ATOL)
        assert tele.shape == (1, len(TELE_FIELDS)) and int(tele[0, 5]) == 0
    with pytest.raises(ValueError, match="available devices"):
        make_expert_mesh(E, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the expert kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phase1_budget_and_free_combine_on_card(cuda_device):
    """On the card: the traced free launch stops phase 1 at its budget (the
    hot device keeps work and an idle device steals), the free combine
    divides by the writers (a forced double execution included), and the
    1-device mesh launches 3 kernels; every output within 1e-4 of the
    oracle, which runs on the same card."""
    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.mesh_ws.selfcheck import skewed_routing
    from repro_torch.pallas_ws import launches

    dev = cuda_device
    D, E, T, k, d, f, bt, P = 4, 16, 96, 4, 64, 128, 8, 8
    rng = np.random.default_rng(0)
    idx, gates = skewed_routing(rng, T, E, k, hot_experts=E // D)
    x = torch.from_numpy(rng.standard_normal((T, d), dtype=np.float32)).to(dev)
    w = [torch.from_numpy((s ** -0.5) * rng.standard_normal(sh, dtype=np.float32)).to(
        dev, torch.bfloat16) for s, sh in ((d, (E, d, f)), (d, (E, d, f)), (f, (E, f, d)))]
    want = expert_ffn_nodrop_ref(idx, gates, x, *w)
    em = emulate_mesh_dispatch(x, idx, gates, *w, n_devices=D, bt=bt, n_programs=P)
    assert int(em.adv[0]) > 0 and any(bool(p.stole) for p in em.plans)
    _covered(em)
    assert float((em.y - want).abs().max()) <= 1e-4
    p = (D, E, T, k, bt, idx, gates)
    plans, victim, thieves, s_head, s_tail = _double_thief_plans(
        p, 1, StealPlan, lambda a: torch.from_numpy(np.asarray(a)).to(dev))
    adv_em = emulate_mesh_dispatch(x, idx, gates, *w, n_devices=D, bt=bt, n_programs=P,
                                   plans_override=plans)
    _covered(adv_em)
    assert int(adv_em.writers[victim].max()) == 1 + len(thieves)
    assert float((adv_em.y - want).abs().max()) <= 1e-4
    before = launches["ws_expert"]
    y = expert_ffn_mesh_ws(idx, gates, x, *w, mesh=make_expert_mesh(E, 1), bt=bt,
                           n_programs=P)
    assert launches["ws_expert"] - before == 3
    assert float((y - want).abs().max()) <= 1e-4
