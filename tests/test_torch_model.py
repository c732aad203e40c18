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


# ---------------------------------------------------------------------------
# kimi-k2 SMOKE (GQA + MoE, moe_dispatch="ws"): the expert megakernel's plain
# version in every MoE layer.  Same tolerance: fp32 on both sides.


@pytest.fixture(scope="module")
def moe_setup():
    from repro.configs.kimi_k2_1t_a32b import SMOKE as J_KIMI
    from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as KIMI

    jcfg, tcfg = J_KIMI.replace(moe_dispatch="ws"), KIMI.replace(moe_dispatch="ws")
    jp = j_init(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, capacity=32)
    nt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([12, 7], np.int32)
    jws, _ = j_decode_ws(jp, jcfg, jc, jnp.asarray(nt), pos)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jl=jl, jc=jc, tl=tl, tc=tc, nt=nt,
                pos=pos, jws=jws)


def test_params_from_jax_carries_the_moe_subtree(moe_setup):
    s = moe_setup
    jm, tm = s["jp"]["layers"]["moe"], s["tp"]["layers"]["moe"]
    assert sorted(tm) == sorted(jm) == ["router", "we_d", "we_g", "we_u",
                                        "ws_d", "ws_g", "ws_u"]
    assert tm["router"].dtype == torch.float32
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    from repro_torch.models import init_params

    mine = init_params(s["tcfg"], seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), s["jp"])
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine) == shapes


def test_moe_prefill_matches_reference(moe_setup):
    s = moe_setup
    np.testing.assert_allclose(s["tl"].numpy(), np.asarray(s["jl"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(s["tc"].kv.k.numpy(), np.asarray(s["jc"].kv.k), rtol=0, atol=ATOL)


def test_moe_decode_step_matches_reference(moe_setup):
    s = moe_setup
    jl, _ = j_decode(s["jp"], s["jcfg"], s["jc"], jnp.asarray(s["nt"]), jnp.asarray(s["pos"]))
    tl, _ = decode_step(s["tp"], s["tcfg"], _clone(s["tc"]), torch.from_numpy(s["nt"]).long(),
                        s["pos"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["free", "lockstep"])
def test_moe_decode_step_ws_matches_reference(moe_setup, mode):
    s = moe_setup
    tl, tc = decode_step_ws(s["tp"], s["tcfg"], _clone(s["tc"]),
                            torch.from_numpy(s["nt"]).long(), s["pos"], mode=mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(s["jws"]), rtol=0, atol=ATOL)


def test_moe_support_is_exactly_the_references(moe_setup):
    """MoE with full GQA attention is served by the ws step.  MLA is built
    and served on the dense step: ``init_params`` gives the reference's
    parameter tree and ``init_caches`` its MLA cache (the same keys and
    shapes), while windowed MoE raises instead of falling through to another
    step.  The ws step covers neither MLA nor the ssm family, as in the
    reference: ``decode_step_ws`` raises."""
    from repro.models import init_caches as j_init_caches
    from repro.models import init_params as j_init_params
    from repro_torch.models import init_caches, init_params, ws_decode_supported
    from repro_torch.models.model import cache_tensors

    cfg = moe_setup["tcfg"]
    assert ws_decode_supported(cfg)
    for bad in (cfg.replace(attn_kind="mla"), cfg.replace(window=4),
                cfg.replace(family="ssm")):
        assert not ws_decode_supported(bad)
        if bad.attn_kind == "mla":
            jcfg = moe_setup["jcfg"].replace(attn_kind="mla")
            shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                            j_init_params(jax.random.PRNGKey(0), jcfg))
            got = init_params(bad, device="cpu")
            assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), got)
        elif bad.family != "ssm":
            with pytest.raises(NotImplementedError):
                init_params(bad, device="cpu")
        if bad.attn_kind == "mla":
            want = [a.shape for a in jax.tree_util.tree_leaves(j_init_caches(jcfg, 1, 8))]
            got = cache_tensors(init_caches(bad, 1, 8, device="cpu"))
            assert [tuple(t.shape) for t in got] == want
        elif bad.family != "ssm":
            with pytest.raises(NotImplementedError):
                init_caches(bad, 1, 8, device="cpu")
        with pytest.raises(NotImplementedError):
            decode_step_ws(moe_setup["tp"], bad, _clone(moe_setup["tc"]),
                           torch.from_numpy(moe_setup["nt"]).long(), moe_setup["pos"])


@pytest.mark.parametrize("ws", [False, True], ids=["dense_step", "ws_step"])
def test_moe_decode_hidden_is_the_step_before_its_unembedding(moe_setup, ws):
    """decode_hidden(_ws) returns the residual stream that decode_step(_ws)
    normalises and unembeds: the same logits, bit for bit."""
    from repro_torch.models import decode_hidden, decode_hidden_ws
    from repro_torch.models.common import rms_norm

    s = moe_setup
    cfg = s["tcfg"]
    hidden, step = (decode_hidden_ws, decode_step_ws) if ws else (decode_hidden, decode_step)
    tok = torch.from_numpy(s["nt"]).long()
    h, _ = hidden(s["tp"], cfg, _clone(s["tc"]), tok, s["pos"])
    tl, _ = step(s["tp"], cfg, _clone(s["tc"]), tok, s["pos"])
    assert tuple(h.shape) == (2, 1, cfg.d_model)
    hn = rms_norm(h, s["tp"]["final_norm"], cfg.norm_eps)
    lg = torch.einsum("bsd,dv->bsv", hn, s["tp"]["unembed"])[:, 0].float()
    V = cfg.vocab_size
    torch.testing.assert_close(tl[:, :V], lg[:, :V], rtol=0, atol=0)
