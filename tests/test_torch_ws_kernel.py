"""The port's work-stealing megakernel (plain version, lockstep) against the
JAX reference ``repro.pallas_ws.kernel.run_ws_schedule`` in Pallas interpret
mode, on the same numpy inputs.

Integer scheduler arrays must be bit-equal.  ``out`` is held to 1e-5: both
sides accumulate the same fp32 tile math, but XLA's dot products and
reductions sum in another order than torch's on the CPU (|out| <= ~3 here,
so 1e-5 is a few fp32 ulps of the sums).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import drawn_rewind, full_rewind  # noqa: E402
from repro.pallas_ws import emit_decode_tasks as j_emit_decode  # noqa: E402
from repro.pallas_ws import emit_flash_tasks as j_emit_flash  # noqa: E402
from repro.pallas_ws import make_queue_state as j_make_state  # noqa: E402
from repro.pallas_ws import run_ws_schedule as j_run  # noqa: E402
from repro_torch.pallas_ws import (  # noqa: E402
    emit_decode_tasks,
    emit_flash_tasks,
    make_queue_state,
    run_ws_schedule,
)

ATOL = 1e-5
INT_FIELDS = ("head", "local_head", "taken", "remaining", "clock", "work",
              "steals", "scanned", "mult")
LENGTHS = np.array([40, 8, 0, 24])


def _inputs(kind, seed=0, B=4, H=4, Hkv=2, S=48, hd=8):
    rng = np.random.default_rng(seed)
    Sq = S if kind == "flash" else 1
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v


def _states(kind, lengths, H, bq, bk, P=4):
    if kind == "flash":
        jt, tt = j_emit_flash(lengths, H, bq, bk), emit_flash_tasks(lengths, H, bq, bk)
    else:
        jt, tt = j_emit_decode(lengths, H, bk), emit_decode_tasks(lengths, H, bk)
    return j_make_state(jt, P), make_queue_state(tt, P)


def _both(jstate, tstate, q, k, v, *, kind, bq, bk, jout=None, tout=None,
          jmult=None, tmult=None, **kw):
    causal = kind == "flash"
    rj = j_run(jstate, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
               bq=bq, bk=bk, out=jout, mult=jmult, **kw)
    rt = run_ws_schedule(tstate, torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, bq=bq, bk=bk,
                         out=tout, mult=tmult, mode="lockstep", **kw)
    return rj, rt


def _assert_same(rj, rt):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj, f)), getattr(rt, f).numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(rt.out.numpy(), np.asarray(rj.out), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["decode", "flash"])
@pytest.mark.parametrize("steal,policy", [(True, "cost"), (True, "scan"),
                                          (False, "cost"), (False, "scan")])
def test_lockstep_matches_reference(kind, steal, policy):
    bq = 8 if kind == "flash" else 1
    bk = 8
    q, k, v = _inputs(kind)
    js, ts = _states(kind, LENGTHS, q.shape[1], bq, bk)
    rj, rt = _both(js, ts, q, k, v, kind=kind, bq=bq, bk=bk, steal=steal,
                   steal_policy=policy)
    _assert_same(rj, rt)
    assert (rt.mult.numpy() == 1).all()


def test_lockstep_uncompressed_no_steal_matches_reference():
    """compress_runs=False walks the no-steal schedule round by round."""
    q, k, v = _inputs("flash", seed=1)
    js, ts = _states("flash", LENGTHS, q.shape[1], 8, 8)
    rj, rt = _both(js, ts, q, k, v, kind="flash", bq=8, bk=8, steal=False,
                   compress_runs=False)
    _assert_same(rj, rt)


@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_full_rewind_drill_matches_reference(kind):
    """Resume a finished launch with every head at 0 and every local bound
    wiped: both kernels re-execute every task (mult == 2), accumulate a second
    copy of each tile, and agree bit for bit on the integer arrays."""
    bq = 8 if kind == "flash" else 1
    q, k, v = _inputs(kind, seed=2)
    js, ts = _states(kind, LENGTHS, q.shape[1], bq, 8)
    rj, rt = _both(js, ts, q, k, v, kind=kind, bq=bq, bk=8)
    full_rewind(js, rj)
    full_rewind(ts, rt)
    rj2, rt2 = _both(js, ts, q, k, v, kind=kind, bq=bq, bk=8,
                     jout=rj.out, tout=rt.out, jmult=jnp.asarray(rj.mult), tmult=rt.mult)
    _assert_same(rj2, rt2)
    assert (rt2.mult.numpy() == 2).all()


@pytest.mark.parametrize("seed", range(3))
def test_seeded_stale_head_drill_matches_reference(seed):
    """A seeded storm: some heads rewound to drawn targets, some programs'
    local bounds wiped, with the cost advisory scrambled — the same spec
    applied to both states."""
    rng = np.random.default_rng(100 + seed)
    q, k, v = _inputs("flash", seed=seed)
    js, ts = _states("flash", LENGTHS, q.shape[1], 8, 8)
    rj, rt = _both(js, ts, q, k, v, kind="flash", bq=8, bk=8)
    _assert_same(rj, rt)
    drawn_rewind(
        js, rj,
        lambda lo, hi: int(rng.integers(lo, hi + 1)),
        lambda: bool(rng.integers(0, 2)),
        advisory_modes=("exact", "random"),
    )
    # the launches agreed bit for bit, so the same storm leaves the port's
    # state in exactly the reference's stale snapshot
    for f in ("head", "local_head", "taken", "remaining"):
        setattr(ts, f, np.array(getattr(js, f)))
    rj2, rt2 = _both(js, ts, q, k, v, kind="flash", bq=8, bk=8,
                     jout=rj.out, tout=rt.out, jmult=jnp.asarray(rj.mult), tmult=rt.mult)
    _assert_same(rj2, rt2)
    assert (rt2.mult.numpy() >= 1).all()


@pytest.mark.parametrize("steal", [False, True])
def test_free_mode_rewind_drill_is_not_divided_again(steal):
    """Free mode stores whole normalised tiles: after a full rewind every task
    runs again (mult == 2 without thieves, >= 2 with them) and `out` still
    equals the reference's mult-normalised output as it stands."""
    from repro.pallas_ws import multiplicity_divisor as j_divisor

    q, k, v = _inputs("flash", seed=5)
    js, ts = _states("flash", LENGTHS, q.shape[1], 8, 8)
    rj = j_run(js, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
               bq=8, bk=8)
    want = np.asarray(rj.out) / j_divisor(js.task_list, rj.mult, rj.out.shape[:3])[..., None]
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    kw = dict(causal=True, bq=8, bk=8, steal=steal, mode="free")
    first = run_ws_schedule(ts, *args, **kw)
    full_rewind(ts, first)
    second = run_ws_schedule(ts, *args, out=first.out, mult=first.mult, **kw)
    mult = second.mult.numpy()
    assert (mult == 2).all() if not steal else (mult >= 2).all()
    np.testing.assert_allclose(second.out.numpy(), want, rtol=0, atol=ATOL)
