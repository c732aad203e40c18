"""The mesh on ``torch.distributed``: one gloo process group of D ranks on
the CPU (``repro_torch.launch.mesh.run_ranks``: spawned processes, a file
init in a temporary directory), D in {2, 4}, one spawn a world size.

Inside the ranks:

* ``expert_ffn_mesh_ws`` on every rank (free and lockstep, the plain walk),
  which must be bit-equal to the port's one-process
  ``emulate_mesh_dispatch``: every sum the ranks make has one nonzero
  contributor a slot, so it is exact in any order.  This is the certificate
  the reference's ``test_mesh_shard_map_conformance`` gives its emulation;
  the telemetry rows are the emulation's plans and clocks.  The
  ``steal=False`` baseline against the oracle;
* the ``axis_name`` forms of ``sync_views`` (MAX), ``resolve_claims`` (a
  one-hot claim row, MIN) and ``int8_compress_decompress`` /
  ``make_ef_compressor`` (SUM), against the reference's axis-free functions
  applied to the stacked per-rank inputs;
* ``make_expert_mesh``'s refusals and ``make_host_mesh``'s axis groups;
* the self-check's ``run_checks`` over 2 ranks.

JAX is imported in the parent only (the ``ref_fns`` fixture); the ranks
import the port.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_expert_mesh, make_host_mesh, run_ranks
from repro_torch.mesh_ws import (
    TELE_FIELDS,
    emulate_mesh_dispatch,
    expert_ffn_mesh_ws,
    send_stolen_shards,
)
from repro_torch.moe_ws import expert_ffn_nodrop_ref
from repro_torch.optim.compress import int8_compress_decompress, make_ef_compressor
from repro_torch.sched.policy import resolve_claims, sync_views

WORLDS = (2, 4)
CASES = (("free", 0), ("free", 1), ("lockstep", 0), ("lockstep", 1))
BT, P = 2, 2
N_TASKS = 5


def _problem(D, seed):
    """A seeded skewed routing over E = 2D experts (device 0's block hot),
    fp32 inputs and weights at d 8, f 16."""
    rng = np.random.default_rng(100 * D + seed)
    E, T, k, d, f = 2 * D, 10, 2, 8, 16
    idx = np.stack([rng.choice(2 if t < 7 else E, k, replace=False)
                    for t in range(T)]).astype(np.int32)
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = [(0.1 * rng.standard_normal(s)).astype(np.float32)
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return [torch.from_numpy(a) for a in (idx, gates, x, *w)]


def _victim_of(D):
    """A plan's (thief: victim) pairs for the transfer check: rank 0's shard
    to ranks 1 and D - 1, rank 1's to rank 2 (D 4)."""
    return {1: 0, D - 1: 0, **({2: 1} if D > 2 else {})}


def _shard(rank, D, *w):
    """This rank's block of the expert dim: the weights each rank holds."""
    El = w[0].shape[0] // D
    return [t[rank * El:(rank + 1) * El] for t in w]


def _axis_inputs(D, rank):
    rng = np.random.default_rng(7 * D + rank)
    views = rng.integers(0, 9, 6).astype(np.int32)
    task = np.int32(rng.integers(-1, N_TASKS))
    grad = rng.standard_normal((3, 4)).astype(np.float32)
    return views, task, grad


def _raises(fn, *a):
    try:
        fn(*a)
    except ValueError as e:
        return str(e)
    return None


def _rank_body(rank, D):
    """One rank's share of every check; numpy results only."""
    out = {"dispatch": {}}
    for mode, seed in CASES:
        idx, gates, x, wg, wu, wd = _problem(D, seed)
        mesh = make_expert_mesh(wg.shape[0], D)
        y, tele = expert_ffn_mesh_ws(idx, gates, x, *_shard(rank, D, wg, wu, wd), mesh=mesh,
                                     bt=BT, n_programs=P, mode=mode, return_telemetry=True)
        out["dispatch"][mode, seed] = (y.numpy(), tele.numpy())
    idx, gates, x, wg, wu, wd = _problem(D, 0)
    y, tele = expert_ffn_mesh_ws(idx, gates, x, *_shard(rank, D, wg, wu, wd),
                                 mesh=make_expert_mesh(2 * D, D), bt=BT, n_programs=P,
                                 steal=False, return_telemetry=True)
    # the weight transfer, and nothing for an empty plan
    mine = _shard(rank, D, wg, wu.to(torch.bfloat16), wd)
    got = send_stolen_shards(mine, sorted(_victim_of(D).items()), "model")
    out["shards"] = (None if got is None else [(t.dtype, t.float().numpy()) for t in got],
                     send_stolen_shards(mine, [], "model"))
    out["static"] = (y.numpy(), tele.numpy())

    views, task, grad = _axis_inputs(D, rank)
    out["sync"] = sync_views(torch.from_numpy(views), axis_name="model").numpy()
    out["won"] = bool(resolve_claims(torch.tensor(task), torch.tensor(rank, dtype=torch.int32),
                                     N_TASKS, axis_name="model"))
    value, residual = int8_compress_decompress(torch.from_numpy(grad), axis_name="model")
    out["int8"] = (value.numpy(), residual.numpy())
    init, apply = make_ef_compressor(True, axis_name="model")
    tree = {"a": torch.from_numpy(grad), "b": torch.from_numpy(grad[0]).to(torch.bfloat16)}
    state = init(tree)
    g1, state = apply(tree, state)
    out["ef"] = ({k: v.float().numpy() for k, v in g1.items()},
                 {k: v.numpy() for k, v in state.items()}, g1["b"].dtype == torch.bfloat16)

    out["refusals"] = [_raises(make_expert_mesh, 2 * D, 2 * D),      # past the ranks
                       _raises(make_expert_mesh, 2 * D + 1, D),      # does not divide E
                       _raises(make_expert_mesh, 4 * D, D // 2) if D > 2 else None,
                       _raises(make_host_mesh, (D + 1,), ("model",))]
    host = make_host_mesh((2, D // 2), ("data", "model"))
    out["host"] = {name: (host.axis(name).size, host.axis(name).index,
                          sync_views(torch.tensor([rank]), host.axis(name)).numpy())
                   for name in ("data", "model")}
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"D{d}")
def ranks(request):
    D = request.param
    return D, run_ranks(_rank_body, D, D, device="cpu", timeout=300)


@pytest.fixture(scope="module")
def ref_fns():
    pytest.importorskip("jax")
    from repro.optim.compress import int8_compress_decompress as j_int8
    from repro.sched.policy import resolve_claims as j_claims
    from repro.sched.policy import sync_views as j_sync

    return j_sync, j_claims, j_int8


def test_ranks_match_the_emulation_bit_for_bit(ranks):
    D, outs = ranks
    stole = False
    for mode, seed in CASES:
        idx, gates, x, wg, wu, wd = _problem(D, seed)
        em = emulate_mesh_dispatch(x, idx, gates, wg, wu, wd, n_devices=D, bt=BT,
                                   n_programs=P, mode=mode)
        for r, out in enumerate(outs):
            y, tele = out["dispatch"][mode, seed]
            np.testing.assert_array_equal(y, em.y.numpy(), err_msg=f"{mode} {seed} rank {r}")
            np.testing.assert_array_equal(tele, outs[0]["dispatch"][mode, seed][1])
        tele = outs[0]["dispatch"][mode, seed][1]
        assert tele.shape == (D, len(TELE_FIELDS))
        for m, plan in enumerate(em.plans):
            assert tuple(tele[m, :3]) == em.clocks[m], (mode, seed, m)
            assert tele[m, 3] == int(em.adv[m])
            assert tele[m, 5] == int(plan.stole) and tele[m, 6] == int(plan.take_tiles)
            assert tele[m, 4] == int(plan.victim)
            assert tele[m, 7] == int(em.mult_total[m].sum())
        stole = stole or bool(tele[:, 5].any())
        want = expert_ffn_nodrop_ref(idx, gates, x, wg, wu, wd).numpy()
        np.testing.assert_allclose(outs[0]["dispatch"][mode, seed][0], want, rtol=1e-5,
                                   atol=1e-6)
    assert stole, "no case stole across ranks"


def test_static_baseline_on_ranks_matches_oracle(ranks):
    D, outs = ranks
    idx, gates, x, wg, wu, wd = _problem(D, 0)
    want = expert_ffn_nodrop_ref(idx, gates, x, wg, wu, wd).numpy()
    for out in outs:
        y, tele = out["static"]
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-6)
        assert not tele[:, [1, 2, 4, 5, 6]].any()


def test_axis_forms_match_the_reference_on_stacked_inputs(ranks, ref_fns):
    import jax.numpy as jnp

    j_sync, j_claims, j_int8 = ref_fns
    D, outs = ranks
    inputs = [_axis_inputs(D, r) for r in range(D)]
    views = np.stack([v for v, _, _ in inputs])
    want_sync = np.asarray(j_sync(jnp.asarray(views)))
    tasks = np.array([t for _, t, _ in inputs], np.int32)
    want_won = np.asarray(j_claims(jnp.asarray(tasks), jnp.arange(D, dtype=jnp.int32), N_TASKS))
    refs = [j_int8(jnp.asarray(g)) for _, _, g in inputs]
    scales = [max(float(np.abs(g).max()), 1e-12) / 127.0 for _, _, g in inputs]
    q = [np.round(np.asarray(v) / s) for (v, _), s in zip(refs, scales)]
    want_value = np.sum(q, axis=0) * (np.float32(np.sum(scales, dtype=np.float32)) / D)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["sync"], want_sync[r])
        assert out["won"] == bool(want_won[r])
        value, residual = out["int8"]
        np.testing.assert_array_equal(residual, np.asarray(refs[r][1]))
        np.testing.assert_allclose(value, want_value, rtol=1e-6, atol=0)


def test_ef_compressor_axis_form_sums_over_ranks(ranks):
    D, outs = ranks
    grads = [_axis_inputs(D, r)[2] for r in range(D)]
    for r, out in enumerate(outs):
        g1, state, kept_dtype = out["ef"]
        assert kept_dtype
        np.testing.assert_array_equal(g1["a"], outs[0]["ef"][0]["a"])   # replicated
        value, residual = int8_compress_decompress(torch.from_numpy(grads[r]))
        np.testing.assert_array_equal(state["a"], residual.numpy())
        # a zero first residual: the leaf is the axis form's value of the gradient
        np.testing.assert_array_equal(g1["a"], out["int8"][0])


def test_expert_mesh_refusals_and_host_mesh_axes(ranks):
    D, outs = ranks
    for out in outs:
        past, uneven, partial, host = out["refusals"]
        assert "available devices" in past
        assert "does not divide" in uneven
        assert partial is None if D == 2 else "not the process group" in partial
        assert "needs" in host
    for r, out in enumerate(outs):
        data_size, data_index, data_max = out["host"]["data"]
        model_size, model_index, model_max = out["host"]["model"]
        assert (data_size, model_size) == (2, D // 2)
        assert r == data_index * (D // 2) + model_index   # row-major, as the reference
        # the max over each line of ranks along the axis
        assert int(data_max[0]) == (D // 2) + model_index
        assert int(model_max[0]) == data_index * (D // 2) + D // 2 - 1


def test_stolen_shards_go_to_thieves_only(ranks):
    """``send_stolen_shards``: a thief gets its victim's shard bit for bit
    (bf16 and fp32 alike keep their dtype), every other rank gets nothing,
    and an empty plan moves nothing."""
    D, outs = ranks
    _, _, _, wg, wu, wd = _problem(D, 0)
    victim_of = _victim_of(D)
    for r, out in enumerate(outs):
        got, empty = out["shards"]
        assert empty is None
        if r not in victim_of:
            assert got is None, r
            continue
        want = _shard(victim_of[r], D, wg, wu.to(torch.bfloat16), wd)
        assert [g[0] for g in got] == [t.dtype for t in want]
        for (_, g), w in zip(got, want):
            np.testing.assert_array_equal(g, w.float().numpy())


def test_production_mesh_describes_its_shapes():
    """The reference's production shapes, described only: no process group
    of 256 or 512 ranks is made, so asking for an axis raises."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    for m in (mesh, pod):
        with pytest.raises(ValueError, match="describes its shape"):
            m.axis("model")


def test_str_axis_without_process_group_raises():
    with pytest.raises(RuntimeError, match="needs an initialised process group"):
        sync_views(torch.zeros(3, dtype=torch.int32), axis_name="model")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_host_mesh((2, 2))
    mesh = make_host_mesh((1,), ("model",))
    assert mesh.axis("model").group is None and mesh.shape == {"model": 1}


def test_selfcheck_rows_over_two_ranks():
    """``python -m repro_torch.mesh_ws.selfcheck``'s checks (the reference's
    selfcheck, and ``launch/train.py --devices``'s demo) over 2 ranks."""
    from repro_torch.mesh_ws.selfcheck import run_checks

    rows = run_checks(2, 1, device="cpu")
    assert [r["seed"] for r in rows] == [0]
    assert all(r["within_tol"] and r["ranks_equal"] for r in rows), rows
    assert rows[0]["devices_stole"] >= 1, rows
