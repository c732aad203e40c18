"""The port's work-stealing data loader (``repro_torch.data.loader``) and
int8 error-feedback compression (``repro_torch.optim.compress``) against
the JAX package's, on the CPU.

* ``WorkStealingLoader`` over the port's WS-WMULT queue: every task
  materialized at least once and returned in task order, its stats
  consistent (extractions = tasks + duplicates), the reference's case
  (llama smoke batches from the synthetic corpus, 12 tasks, 3 thieves) equal
  to the reference loader's batches;
* ``int8_compress_decompress`` bit-equal to the reference's on seeded
  gradients (fp32 and bf16, all-zero, one huge element);
* ``make_ef_compressor``: 50 steps of the error-feedback loop of
  tests/test_substrates.py on the same seeded gradients, every step's
  output and residual equal to the reference's and the totals within 0.05.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.data import WorkStealingLoader
from repro_torch.optim import int8_compress_decompress, make_ef_compressor


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return jnp


@pytest.mark.parametrize("n_workers,node_len", [(1, 64), (3, 64), (4, 8)])
def test_loader_delivers_every_task_in_order(n_workers, node_len):
    seen, lock = [], threading.Lock()

    def prepare(t):
        with lock:
            seen.append(t)
        return {"task": t, "rows": np.full(3, t)}

    loader = WorkStealingLoader(prepare, n_tasks=40, n_workers=n_workers,
                                node_len=node_len).start()
    batches = loader.batches(timeout=60)
    assert [b["task"] for b in batches] == list(range(40))
    assert sorted(set(seen)) == list(range(40))
    st = loader.stats
    assert st["extractions"] == len(seen) >= 40
    assert st["duplicates"] == st["extractions"] - 40


def test_loader_times_out_naming_missing_tasks():
    loader = WorkStealingLoader(lambda t: {"t": t}, n_tasks=3, n_workers=1)
    loader.queue.put(0)  # only one task is ever Put; the owner never starts
    loader._complete(loader.queue.take())
    with pytest.raises(TimeoutError, match="missing tasks"):
        loader.batches(timeout=0.05)


def test_loader_matches_reference_batches():
    _jnp()
    from repro.configs import get_config as j_get_config
    from repro.data import WorkStealingLoader as JLoader
    from repro.data import make_batch as j_make_batch
    from repro.models.config import SHAPES as J_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models.config import ShapeConfig

    cfg, jcfg = get_config("llama3.2-3b", smoke=True), j_get_config("llama3.2-3b", smoke=True)
    shape = ShapeConfig("train_4k", "train", 4096, 256)
    got = WorkStealingLoader(lambda t: make_batch(cfg, shape, step=t, n_rows=1),
                             n_tasks=12, n_workers=3).start().batches(timeout=60)
    want = JLoader(lambda t: j_make_batch(jcfg, J_SHAPES["train_4k"], step=t, n_rows=1),
                   n_tasks=12, n_workers=3).start().batches(timeout=60)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def _grads(seed, shape, kind):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    if kind == "zeros":
        g[:] = 0.0
    elif kind == "spike":
        g.flat[rng.integers(g.size)] = 1e4
    return g


@pytest.mark.parametrize("kind", ["normal", "zeros", "spike"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compress_matches_reference(kind, dtype):
    jnp = _jnp()
    from repro.optim import int8_compress_decompress as j_compress

    for seed, shape in ((0, (128,)), (1, (33, 17)), (2, (4, 8, 16))):
        g = _grads(seed, shape, kind)
        t = torch.from_numpy(g).to(getattr(torch, dtype))
        jv, jr = j_compress(jnp.asarray(g, dtype=getattr(jnp, dtype)))
        v, r = int8_compress_decompress(t)
        assert v.dtype == r.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        scale = float(t.float().abs().max()) / 127.0
        assert float((t.float() - v).abs().max()) <= scale * 0.51
        np.testing.assert_allclose((v + r).numpy(), t.float().numpy(), rtol=1e-6)


def test_error_feedback_tracks_reference():
    import jax

    jnp = _jnp()
    from repro.optim import make_ef_compressor as j_make_ef

    key = jax.random.PRNGKey(0)
    g0 = np.array(jax.random.normal(key, (128,)))
    steps = [np.array(jax.random.normal(jax.random.fold_in(key, i), (128,)) * 0.1)
             for i in range(50)]
    init, apply = make_ef_compressor(True)
    j_init, j_apply = j_make_ef(True)
    state, jstate = init({"g": torch.from_numpy(g0)}), j_init({"g": jnp.asarray(g0)})
    total_true = np.zeros(128, np.float32)
    total_comp = torch.zeros(128)
    for gi in steps:
        comp, state = apply({"g": torch.from_numpy(gi)}, state)
        jcomp, jstate = j_apply({"g": jnp.asarray(gi)}, jstate)
        np.testing.assert_array_equal(comp["g"].numpy(), np.asarray(jcomp["g"]))
        np.testing.assert_array_equal(state["g"].numpy(), np.asarray(jstate["g"]))
        total_true += gi
        total_comp += comp["g"]
    # the residual carries over, so the totals match within one quantization step
    assert float(np.abs(total_true - total_comp.numpy()).max()) < 0.05


def test_error_feedback_keeps_dtypes_and_refuses_the_mesh_form():
    init, apply = make_ef_compressor(True)
    g = {"a": torch.randn(8, dtype=torch.bfloat16), "b": {"w": torch.randn(3, 4)}}
    state = init(g)
    assert state["a"].dtype == state["b"]["w"].dtype == torch.float32
    out, state = apply(g, state)
    assert out["a"].dtype == torch.bfloat16 and out["b"]["w"].dtype == torch.float32
    off_init, off_apply = make_ef_compressor(False)
    assert off_init(g) == () and off_apply(g, ()) == (g, ())
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        make_ef_compressor(True, axis_name="pod")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        int8_compress_decompress(torch.zeros(2), axis_name="pod")
