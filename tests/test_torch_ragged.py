"""The port's ``ragged_decode_attention`` against the JAX function (Pallas
interpret mode) and both dense oracles, on the same numpy inputs.

Tolerance 1e-5: fp32 tile math on both sides, summed in another order
(|out| <= ~3).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.pallas_ws import ragged_decode_attention as j_ragged  # noqa: E402
from repro.pallas_ws import ragged_decode_ref as j_ref  # noqa: E402
from repro_torch.pallas_ws import ragged_decode_attention, ragged_decode_ref  # noqa: E402

ATOL = 1e-5


def _inputs(seed, B=4, H=4, Hkv=2, S=32, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("schedule", ["ws", "static"])
@pytest.mark.parametrize("mode", ["lockstep", "free"])
def test_ragged_decode_matches_reference(schedule, mode):
    q, k, v = _inputs(0)
    lengths = np.array([32, 5, 0, 17])
    want = np.asarray(j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
                               schedule=schedule, n_programs=4, bk=8))
    got, stats = ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lengths,
        schedule=schedule, n_programs=4, bk=8, mode=mode, return_stats=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert stats.n_tasks == 3 * 4 and stats.mult_max == 1
    assert (stats.steals > 0) == (schedule == "ws")


@pytest.mark.parametrize("seed", range(3))
def test_ragged_decode_matches_dense_oracles(seed):
    """Seeded ragged lengths, K/V given as the transposed view of a
    [B, S, Hkv, hd] cache (the layout gqa_decode_ws passes, read in place)."""
    rng = np.random.default_rng(10 + seed)
    q, k, v = _inputs(seed, S=40)
    lengths = rng.integers(0, 41, size=4)
    kc = torch.from_numpy(np.ascontiguousarray(k.transpose(0, 2, 1, 3)))
    vc = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1, 3)))
    kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    assert not kt.is_contiguous()
    got = ragged_decode_attention(torch.from_numpy(q), kt, vt, lengths, n_programs=4, bk=16)
    ref_port = ragged_decode_ref(torch.from_numpy(q), kt, vt, lengths)
    ref_jax = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths))
    np.testing.assert_allclose(ref_port.numpy(), ref_jax, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref_jax, rtol=0, atol=ATOL)
    assert (got.numpy()[lengths == 0] == 0).all()
