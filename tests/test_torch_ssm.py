"""The port's ssm and hybrid families (mamba2-2.7b, zamba2-2.7b) against the
JAX package at SMOKE size in fp32, on the same numpy inputs and the
reference's weights (``params_from_jax``).

* every function of the Mamba-2 layer (``init_mamba``, ``_causal_conv``,
  ``_gated_norm``, ``mamba_train`` with its cache, ``init_ssm_cache``,
  ``_conv_step``, ``mamba_decode``) against the reference's;
* ``init_params`` trees, ``lm_hidden``, ``prefill`` logits and caches,
  ``decode_step`` logits and caches, ``loss_fn`` and every gradient, for
  both smoke models; ``param_count`` of both full configs;
* prefill of S tokens against prefill of S/2 and S/2 decode steps (the
  reference's tests/test_models_smoke.py case), and the refusal of a
  prompt past the chunk that is not a multiple of it;
* ``ContinuousBatcher`` greedy streams against the reference batcher's, two
  replicas behind the frontend, and two requests in turn through one slot
  (the splice must carry the SSM state and conv inputs, and the hybrid's
  shared kv, into the slot).

Tolerance: fp32 values within 1e-5 of their scale (``max |want|``, at least
1): both sides are fp32, and XLA and torch sum the same products (widths 8
to 128) in other orders; the decode-against-prefill check is the
reference's own 2e-3.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import loss_fn as j_loss  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_caches,
    init_params,
    lm_hidden,
    loss_fn,
    prefill,
    ssm,
)
from repro_torch.models.model import cache_tensors  # noqa: E402

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
RTOL = 1e-5


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg, cfg = j_get_config(request.param, smoke=True), get_config(request.param, smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks)


def _layer(a, idx=0):
    """Layer ``idx``'s mamba parameters: (reference, port)."""
    jl = jax.tree_util.tree_map(lambda x: x[idx], a["jp"]["layers"]["mamba"])
    return jl, {k: v[idx] for k, v in a["tp"]["layers"]["mamba"].items()}


def _x(a, S=16, seed=1):
    return np.random.default_rng(seed).standard_normal((2, S, a["cfg"].d_model)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the layer's functions

def test_config_fields_and_param_count_mirror_the_reference():
    for name in ARCHS:
        for smoke in (False, True):
            jc, tc = j_get_config(name, smoke=smoke), get_config(name, smoke=smoke)
            for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab_size", "ssm_state", "ssm_expand", "ssm_headdim", "ssm_chunk",
                      "ssm_conv_width", "hybrid_attn_every", "d_inner", "ssm_heads", "is_ssm",
                      "dtype", "padded_vocab", "hd"):
                assert getattr(tc, f) == getattr(jc, f), (name, f)
            assert tc.param_count() == jc.param_count(), name
    assert get_config("mamba2-2.7b").ssm_heads == 80


def test_init_mamba_and_params_have_the_reference_tree(arch):
    cfg, jcfg = arch["cfg"], arch["jcfg"]
    shapes = jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), arch["jp"])
    got = init_params(cfg, seed=3, device="cpu")
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    one = ssm.init_mamba(cfg, torch.float32, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    want = j_ssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    assert {k: tuple(v.shape) for k, v in one.items()} == {k: v.shape for k, v in want.items()}
    for k in ("A_log", "D", "dt_bias", "norm"):
        _close(one[k], want[k], k)  # constants: zeros and ones
    # the carried tree is the reference's, leaf for leaf
    for (path, jv), tv in zip(jax.tree_util.tree_leaves_with_path(arch["jp"]),
                              jax.tree_util.tree_leaves(arch["tp"])):
        assert np.array_equal(tv.numpy(), np.asarray(jv)), jax.tree_util.keystr(path)


def test_causal_conv_gated_norm_and_conv_step_match(arch):
    rng = np.random.default_rng(2)
    W, C = 4, 24
    x = rng.standard_normal((2, 9, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    _close(ssm._causal_conv(_t(x), _t(w)), j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    y, z = (rng.standard_normal((2, 5, C)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(C).astype(np.float32) * 0.1
    _close(ssm._gated_norm(_t(y), _t(z), _t(g)), j_ssm._gated_norm(*map(jnp.asarray, (y, z, g))))
    new, state = rng.standard_normal((2, C)).astype(np.float32), x[:, :W - 1]
    got = ssm._conv_step(_t(new), _t(state), _t(w))
    want = j_ssm._conv_step(*map(jnp.asarray, (new, state, w)))
    for gv, wv in zip(got, want):
        _close(gv, wv)


def test_mamba_train_and_decode_match(arch):
    cfg, jcfg = arch["cfg"], arch["jcfg"]
    jl, tl = _layer(arch, 1)
    x = _x(arch)
    out, cache = ssm.mamba_train(_t(x), tl, cfg, return_cache=True)
    jout, jcache = j_ssm.mamba_train(jnp.asarray(x), jl, jcfg, return_cache=True)
    _close(out, jout, "out")
    _close(ssm.mamba_train(_t(x), tl, cfg), jout, "out without the cache")
    for name, g, w in zip(cache._fields, cache, jcache):
        _close(g, w, name)
    assert cache.state.dtype == torch.float32
    zeros = ssm.init_ssm_cache(2, cfg, torch.float32, device="cpu")
    jzeros = j_ssm.init_ssm_cache(2, jcfg, jnp.float32)
    assert [tuple(t.shape) for t in zeros] == [t.shape for t in jzeros]
    xt = _x(arch, S=1, seed=4)
    dout, dcache = ssm.mamba_decode(_t(xt), tl, cfg, cache)
    jdout, jdcache = j_ssm.mamba_decode(jnp.asarray(xt), jl, jcfg, jcache)
    _close(dout, jdout, "decode out")
    for name, g, w in zip(dcache._fields, dcache, jdcache):
        _close(g, w, "decode " + name)


def test_mamba_decode_keeps_the_reference_types_at_bf16(arch):
    """bf16 model: the state stays fp32 (cast to bf16 before the product
    with C), dt is fp32, and the output and conv caches are bf16."""
    cfg = arch["cfg"].replace(dtype="bfloat16")
    p = {k: v.to(torch.bfloat16) if k not in ("A_log", "D", "dt_bias") else v
         for k, v in _layer(arch)[1].items()}
    cache = ssm.init_ssm_cache(2, cfg, torch.bfloat16, device="cpu")
    out, new = ssm.mamba_decode(_t(_x(arch, S=1)).to(torch.bfloat16), p, cfg, cache)
    assert out.dtype == torch.bfloat16 and new.state.dtype == torch.float32
    assert new.conv_x.dtype == torch.bfloat16 and bool(new.state.abs().sum() > 0)


def test_short_prompt_conv_cache_and_chunk_refusal(arch):
    """A prompt shorter than the conv keeps zeros before it in the conv cache
    (what the causal conv reads); a prompt past the chunk that is not a
    multiple of it raises, as the reference's assert does."""
    cfg = arch["cfg"]
    tl = _layer(arch)[1]
    _, cache = ssm.mamba_train(_t(_x(arch, S=2)), tl, cfg, return_cache=True)
    assert cache.conv_x.shape[1] == cfg.ssm_conv_width - 1
    assert bool((cache.conv_x[:, 0] == 0).all())
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.mamba_train(_t(_x(arch, S=cfg.ssm_chunk + 3)), tl, cfg)
    with pytest.raises(AssertionError):
        j_ssm.mamba_train(jnp.asarray(_x(arch, S=cfg.ssm_chunk + 3)), _layer(arch)[0],
                          arch["jcfg"])


# ---------------------------------------------------------------------------
# the model

def test_lm_hidden_matches(arch):
    cfg, jcfg = arch["cfg"], arch["jcfg"]
    x = _x(arch)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    h, aux = lm_hidden(arch["tp"], cfg, _t(x), _t(pos), remat=False)
    jh, jaux = j_tf.lm_hidden(arch["jp"], jcfg, jnp.asarray(x), jnp.asarray(pos), remat=False)
    _close(h, jh)
    assert float(aux) == float(jaux) == 0.0
    _close(lm_hidden(arch["tp"], cfg, _t(x), _t(pos), remat=True)[0], jh, "remat")


def test_prefill_and_decode_match(arch):
    cfg, jcfg, toks = arch["cfg"], arch["jcfg"], arch["toks"]
    jl, jc = j_prefill(arch["jp"], jcfg, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = prefill(arch["tp"], cfg, {"tokens": _t(toks).long()}, capacity=32)
    _close(tl, jl, "prefill logits")
    jleaves = jax.tree_util.tree_leaves(jc)
    assert len(cache_tensors(tc)) == len(jleaves)
    for g, w in zip(cache_tensors(tc), jleaves):
        _close(g, w, "prefill cache")
    nt = np.array([[3], [5]], np.int32)
    pos = np.array([16, 16], np.int32)
    for step in range(3):
        jl, jc = j_decode(arch["jp"], jcfg, jc, jnp.asarray(nt), jnp.asarray(pos))
        tl, tc = decode_step(arch["tp"], cfg, tc, _t(nt).long(), pos)
        _close(tl, jl, f"decode logits {step}")
        for g, w in zip(cache_tensors(tc), jax.tree_util.tree_leaves(jc)):
            _close(g, w, f"decode cache {step}")
        nt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1


def test_init_caches_match(arch):
    cfg, jcfg = arch["cfg"], arch["jcfg"]
    from repro.models import init_caches as j_init_caches

    got = init_caches(cfg, 3, 24, device="cpu")
    want = j_init_caches(jcfg, 3, 24)
    assert [tuple(t.shape) for t in cache_tensors(got)] == [
        a.shape for a in jax.tree_util.tree_leaves(want)]
    assert got.kv == ()
    assert (got.shared_kv == ()) == (cfg.family == "ssm")


def test_loss_and_grads_match(arch):
    cfg, jcfg, toks = arch["cfg"], arch["jcfg"], arch["toks"]
    (jv, jm), jg = jax.value_and_grad(
        lambda p: j_loss(p, jcfg, {"tokens": jnp.asarray(toks)}), has_aux=True)(arch["jp"])
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), arch["tp"])
    leaves = jax.tree_util.tree_leaves(params)
    loss, metrics = loss_fn(params, cfg, {"tokens": _t(toks).long()})
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jv, "loss")
    _close(metrics["ce"], jm["ce"], "ce")
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg), grads):
        _close(g, w, jax.tree_util.keystr(path))


def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """The reference's tests/test_models_smoke.py case: prefill of S tokens
    against a prefill of S/2 then S/2 decode steps, within 2e-3."""
    cfg, tp, toks = arch["cfg"], arch["tp"], _t(arch["toks"]).long()
    full, _ = prefill(tp, cfg, {"tokens": toks}, capacity=16)
    _, caches = prefill(tp, cfg, {"tokens": toks[:, :8]}, capacity=16)
    for i in range(8, 16):
        logits, caches = decode_step(tp, cfg, caches, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_ws_decode_is_not_offered_for_ssm_families(arch):
    from repro_torch.models import decode_step_ws, ws_decode_supported
    from repro.models import ws_decode_supported as j_ws_supported

    cfg = arch["cfg"]
    assert not ws_decode_supported(cfg) and not j_ws_supported(arch["jcfg"])
    caches = init_caches(cfg, 2, 16, device="cpu")
    for pos in (np.array([3, 3]), torch.tensor([3, 3])):
        with pytest.raises(NotImplementedError):
            decode_step_ws(arch["tp"], cfg, caches, torch.zeros((2, 1), dtype=torch.long), pos)


# ---------------------------------------------------------------------------
# serving

def _serve(front_cls, batcher, req_cls, prompts, max_new=4, n_replicas=2):
    front = front_cls(batcher, n_replicas=n_replicas)
    for rid, p in enumerate(prompts):
        front.submit(0, req_cls(rid, p, max_new=max_new))
    done = front.run(max_iters=200)
    return {rid: list(r.out) for rid, r in done.items()}, front


@pytest.mark.parametrize("slots", [1, 2], ids=["one_slot_in_turn", "two_replicas_x2"])
def test_batcher_streams_match_the_reference(arch, slots):
    """Greedy streams of the port's batcher equal the reference batcher's.
    With one slot and one replica the requests pass through the same slot
    in turn, so each admission must splice every cache (SSM state, conv
    inputs, shared kv) over the last request's."""
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import WorkStealingFrontend as JFrontend
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    cfg, jcfg = arch["cfg"], arch["jcfg"]
    rng = np.random.default_rng(5)
    lens = (5, 8, 3, 7) if slots == 2 else (6, 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    n_rep = 2 if slots == 2 else 1
    want, _ = _serve(JFrontend, lambda: JBatcher(arch["jp"], jcfg, slots=slots, capacity=24),
                     JRequest, prompts, n_replicas=n_rep)
    got, front = _serve(WorkStealingFrontend,
                        lambda: ContinuousBatcher(arch["tp"], cfg, slots=slots, capacity=24),
                        Request, prompts, n_replicas=n_rep)
    assert got == want and sorted(got) == list(range(len(prompts)))
    assert not any(b.use_ws for b in front.batchers)
    if slots == 1:
        # the second request alone, in a fresh batcher: the same stream
        alone, _ = _serve(WorkStealingFrontend,
                          lambda: ContinuousBatcher(arch["tp"], cfg, slots=1, capacity=24),
                          Request, prompts[1:], n_replicas=1)
        assert alone[0] == got[1]


def test_splice_copies_every_cache_into_the_slot(arch):
    from repro_torch.serving import ContinuousBatcher, Request

    cfg = arch["cfg"]
    b = ContinuousBatcher(arch["tp"], cfg, slots=3, capacity=24)
    before = [t.clone() for t in cache_tensors(b.caches)]
    assert b.admit(Request(0, arch["toks"][0, :7], max_new=3))
    assert b.admit(Request(1, arch["toks"][1, :5], max_new=3))
    _, c1 = prefill(arch["tp"], cfg, {"tokens": _t(arch["toks"][1:2, :5]).long()},
                    capacity=24)
    for full, one, old in zip(cache_tensors(b.caches), cache_tensors(c1), before):
        assert torch.equal(full[:, 1], one[:, 0])
        assert torch.equal(full[:, 2], old[:, 2])  # the free slot untouched
