"""The port's llama3.2-3b SMOKE model path against the JAX package, fp32,
with the reference's weights carried across by ``convert.params_from_jax``.

Tolerance 1e-4 on logits of magnitude ~3 and caches of magnitude ~2: both
sides are fp32 but XLA and torch sum their contractions (d_model 64, d_ff
128, two layers) in different orders.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.llama3_2_3b import SMOKE as J_SMOKE  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import decode_step_ws as j_decode_ws  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch.configs.llama3_2_3b import SMOKE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Caches, KVCache, decode_step, decode_step_ws, prefill  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jp = j_init(jax.random.PRNGKey(0), J_SMOKE)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, J_SMOKE.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = j_prefill(jp, J_SMOKE, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = prefill(tp, SMOKE, {"tokens": torch.from_numpy(toks).long()}, capacity=32)
    nt = rng.integers(0, J_SMOKE.vocab_size, (2, 1)).astype(np.int32)
    return dict(jp=jp, tp=tp, jl=jl, jc=jc, tl=tl, tc=tc, nt=nt,
                pos=np.array([12, 5], np.int32))


def _clone(c):
    return Caches(kv=KVCache(c.kv.k.clone(), c.kv.v.clone()))


def test_config_mirrors_reference():
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "rope_theta", "norm_eps", "padded_vocab", "hd", "eff_heads",
              "layer_windows", "tie_embeddings", "depth_scaled_residual"):
        assert getattr(SMOKE, f) == getattr(J_SMOKE, f), f
    from repro.configs.llama3_2_3b import CONFIG as J_CONFIG
    from repro_torch.configs.llama3_2_3b import CONFIG

    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "rope_theta", "dtype", "padded_vocab", "hd", "eff_heads"):
        assert getattr(CONFIG, f) == getattr(J_CONFIG, f), f
    assert SMOKE.replace(pad_heads=True).eff_heads == J_SMOKE.replace(pad_heads=True).eff_heads


def test_padded_heads_are_zeroed_like_reference():
    """pad_heads allocates extra (zeroed) head slices; the port zeroes the
    same slices as the reference's init."""
    from repro_torch.models import init_params

    jp = j_init(jax.random.PRNGKey(1), J_SMOKE.replace(pad_heads=True))
    tp = init_params(SMOKE.replace(pad_heads=True), seed=1, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        jz = np.asarray(jp["layers"]["attn"][name]) == 0
        tz = tp["layers"]["attn"][name].numpy() == 0
        assert jz.shape == tz.shape and (jz == tz).all(), name


def test_prefill_matches_reference(setup):
    s = setup
    np.testing.assert_allclose(s["tl"].numpy(), np.asarray(s["jl"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(s["tc"].kv.k.numpy(), np.asarray(s["jc"].kv.k), rtol=0, atol=ATOL)
    np.testing.assert_allclose(s["tc"].kv.v.numpy(), np.asarray(s["jc"].kv.v), rtol=0, atol=ATOL)


def test_decode_step_matches_reference(setup):
    s = setup
    jl, jc = j_decode(s["jp"], J_SMOKE, s["jc"], jnp.asarray(s["nt"]), jnp.asarray(s["pos"]))
    tl, tc = decode_step(s["tp"], SMOKE, _clone(s["tc"]), torch.from_numpy(s["nt"]).long(),
                         s["pos"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), rtol=0, atol=ATOL)


@pytest.mark.parametrize("schedule,mode", [("ws", "free"), ("ws", "lockstep"),
                                           ("static", "free")])
def test_decode_step_ws_matches_reference(setup, schedule, mode):
    s = setup
    jl, jc = j_decode_ws(s["jp"], J_SMOKE, s["jc"], jnp.asarray(s["nt"]), s["pos"],
                         schedule=schedule)
    tl, tc = decode_step_ws(s["tp"], SMOKE, _clone(s["tc"]),
                            torch.from_numpy(s["nt"]).long(), s["pos"],
                            schedule=schedule, mode=mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.kv.v.numpy(), np.asarray(jc.kv.v), rtol=0, atol=ATOL)


def test_ws_and_dense_decode_agree_in_the_port(setup):
    s = setup
    tok = torch.from_numpy(s["nt"]).long()
    a, _ = decode_step_ws(s["tp"], SMOKE, _clone(s["tc"]), tok, s["pos"])
    b, _ = decode_step(s["tp"], SMOKE, _clone(s["tc"]), tok, s["pos"])
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)
