"""The port's encdec and vlm families (whisper-base, pixtral-12b) against the
JAX package at SMOKE size in fp32, on the same numpy inputs and the
reference's weights (``params_from_jax``).

For both models: the configs field by field, ``init_caches`` shapes (the
encoder's ``cross_kv`` included), ``loss_fn`` and every gradient, ``prefill``
logits and caches, ``decode_step`` step by step, a prefill then decode steps
against a longer prefill, and the engine's refusal of both families (its
prompts are tokens only, as the reference's).  For pixtral, also
``decode_step_ws`` with a host ``pos`` and with a tensor ``pos`` (the device
Put) against the port's ``decode_step`` and the reference's
``decode_step_ws``.

Every JAX function runs once a model, in the module fixture.  Tolerances:
fp32 on both sides, XLA and torch summing the same products in other
orders: the loss and gradients within rtol 1e-4 / atol 1e-5, logits and
caches within 1e-5 of their scale (``max |want|``, at least 1), the
decode-against-prefill check at the reference's 2e-3.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import decode_step_ws as j_decode_ws  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import loss_fn as j_loss  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    decode_step_ws,
    init_caches,
    init_params,
    loss_fn,
    prefill,
    ws_decode_supported,
)
from repro_torch.models.model import cache_tensors  # noqa: E402

ARCHS = ["whisper-base", "pixtral-12b"]
RTOL = 1e-5
S = 12          # prompt tokens
CAP = 32        # cache slots (pixtral's count its 4 patches too)
STEPS = 3
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "head_dim", "attn_kind", "window", "n_enc_layers", "n_dec_layers",
          "enc_seq_len", "frontend", "n_patches", "rope_theta", "norm_eps",
          "tie_embeddings", "dtype", "hd", "padded_vocab", "eff_heads", "layer_windows",
          "is_moe")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what=""):
    got, want = _np(got), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, rng, n_tokens=S):
    """The model's numpy batch: tokens, and its patches or frames."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, n_tokens)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(
            np.float32) * 0.02
    else:
        b["frames"] = rng.standard_normal((2, cfg.enc_seq_len, cfg.d_model)).astype(
            np.float32) * 0.02
    return b


def _torch_batch(b):
    return {k: _t(v).long() if k == "tokens" else _t(v) for k, v in b.items()}


def _offset(cfg) -> int:
    """Where the text starts: after a vlm model's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def _model(arch):
    """One model: the reference's weights on both sides and every JAX result
    the tests compare with, built once."""
    jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    batch = _batch(cfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, batch=batch)
    (lv, lm), lg = jax.jit(jax.value_and_grad(lambda p: j_loss(p, jcfg, jb), has_aux=True))(jp)
    out["loss"] = (float(lv), float(lm["ce"]), lg)
    jl, jc = j_prefill(jp, jcfg, jb, capacity=CAP)
    out["prefill"] = (np.asarray(jl), [np.asarray(a) for a in jax.tree_util.tree_leaves(jc)])
    step = jax.jit(lambda p, c, t, pos: j_decode(p, jcfg, c, t, pos))
    nt, pos, steps = np.array([[3], [5]], np.int32), np.full(2, S + _offset(cfg), np.int32), []
    c = jc
    for _ in range(STEPS):
        lgt, c = step(jp, c, jnp.asarray(nt), jnp.asarray(pos))
        steps.append((nt, pos, np.asarray(lgt), [np.asarray(a) for a in
                                                  jax.tree_util.tree_leaves(c)]))
        nt = np.asarray(lgt).argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1
    out["steps"] = steps
    out["cache_shapes"] = [a.shape for a in jax.tree_util.tree_leaves(
        j_init_caches(jcfg, 3, 24))]
    if cfg.family == "vlm":
        # the reference's ws step at ragged positions (the text 12 and 7 long)
        wpos = np.array([S, 7], np.int32) + _offset(cfg)
        wl, _ = j_decode_ws(jp, jcfg, jc, jnp.asarray(nt), wpos)
        out["ws"] = (nt, wpos, np.asarray(wl))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def m(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def vlm():
    return _model("pixtral-12b")


def test_configs_mirror_the_reference():
    from repro_torch.configs import get_config as port_config

    for name in ARCHS:
        for smoke in (False, True):
            jc, tc = j_get_config(name, smoke=smoke), port_config(name, smoke=smoke)
            for f in FIELDS:
                assert getattr(tc, f) == getattr(jc, f), (name, smoke, f)
            assert tc.param_count() == jc.param_count(), (name, smoke)
    assert port_config("pixtral-12b").hd == 160


def test_init_params_and_caches_have_the_reference_shapes(m):
    cfg, jcfg = m["cfg"], m["jcfg"]
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), m["jp"])
    got = init_params(cfg, seed=1, device="cpu")
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    caches = init_caches(cfg, 3, 24, device="cpu")
    assert [tuple(t.shape) for t in cache_tensors(caches)] == m["cache_shapes"]
    assert (caches.cross_kv != ()) == (cfg.family == "encdec")


def test_loss_and_grads_match(m):
    cfg = m["cfg"]
    want_loss, want_ce, jg = m["loss"]
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), m["tp"])
    loss, metrics = loss_fn(params, cfg, _torch_batch(m["batch"]))
    grads = torch.autograd.grad(loss, jax.tree_util.tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), want_ce, rtol=1e-4, atol=1e-5)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg), grads):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_matches(m):
    tl, tc = prefill(m["tp"], m["cfg"], _torch_batch(m["batch"]), capacity=CAP)
    want_l, want_c = m["prefill"]
    _close(tl, want_l, "prefill logits")
    assert len(cache_tensors(tc)) == len(want_c)
    for g, w in zip(cache_tensors(tc), want_c):
        _close(g, w, "prefill cache")


def test_decode_step_matches_per_step(m):
    cfg = m["cfg"]
    _, tc = prefill(m["tp"], cfg, _torch_batch(m["batch"]), capacity=CAP)
    for i, (nt, pos, want_l, want_c) in enumerate(m["steps"]):
        tl, tc = decode_step(m["tp"], cfg, tc, _t(nt).long(), pos)
        _close(tl, want_l, f"step {i} logits")
        for g, w in zip(cache_tensors(tc), want_c):
            _close(g, w, f"step {i} cache")


def test_prefill_then_decode_equals_a_longer_prefill(m):
    """The reference's tests/test_models_smoke.py case: a prefill of S tokens
    against a prefill of S/2 then S/2 decode steps, within 2e-3 (a vlm
    row's text positions start after its patches)."""
    cfg, tp = m["cfg"], m["tp"]
    b = _torch_batch(m["batch"])
    toks, off = b["tokens"], _offset(cfg)
    full, _ = prefill(tp, cfg, b, capacity=S + off)
    _, caches = prefill(tp, cfg, dict(b, tokens=toks[:, :S // 2]), capacity=S + off)
    for i in range(S // 2, S):
        logits, caches = decode_step(tp, cfg, caches, toks[:, i:i + 1], i + off)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_ws_step_covers_exactly_the_references_families(m):
    from repro.models import ws_decode_supported as j_ws_supported

    assert ws_decode_supported(m["cfg"]) == j_ws_supported(m["jcfg"]) == (
        m["cfg"].family == "vlm")
    if m["cfg"].family == "encdec":
        caches = init_caches(m["cfg"], 2, 16, device="cpu")
        with pytest.raises(NotImplementedError):
            decode_step_ws(m["tp"], m["cfg"], caches, torch.zeros((2, 1), dtype=torch.long),
                           np.array([3, 3]))


@pytest.mark.parametrize("device_put", [False, True], ids=["host_pos", "tensor_pos"])
def test_vlm_ws_step_matches_the_dense_step_and_the_reference(vlm, device_put):
    """pixtral's ws step at ragged text positions (after the patches) with a
    host ``pos`` and with a tensor ``pos`` (every Put on the device): its
    logits against the port's dense step and the reference's ws step within
    1e-5, and its caches against the dense step's."""
    m = vlm
    cfg = m["cfg"]
    nt, pos, want = m["ws"]
    _, tc = prefill(m["tp"], cfg, _torch_batch(m["batch"]), capacity=CAP)
    _, dc = prefill(m["tp"], cfg, _torch_batch(m["batch"]), capacity=CAP)
    p = torch.from_numpy(pos).long() if device_put else pos
    wl, wc = decode_step_ws(m["tp"], cfg, tc, _t(nt).long(), p)
    dl, dc = decode_step(m["tp"], cfg, dc, _t(nt).long(), pos)
    np.testing.assert_allclose(wl.numpy(), dl.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(wl.numpy(), want, rtol=0, atol=1e-5)
    for g, w in zip(cache_tensors(wc), cache_tensors(dc)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_engine_refuses_both_families_clearly(m):
    from repro_torch.serving import ContinuousBatcher

    need = "patches" if m["cfg"].family == "vlm" else "frames"
    with pytest.raises(NotImplementedError, match=f"token-only prompts.*'{need}'"):
        ContinuousBatcher(m["tp"], m["cfg"], slots=2, capacity=24)


def test_train_entry_point_takes_both_families(m):
    """``train()`` on the synthetic corpus, whose batches carry the frames or
    the patches: two steps with finite losses."""
    from repro_torch.launch.train import train

    _, losses = train(m["cfg"].name.removesuffix("-smoke"), smoke=True, steps=2, rows=2,
                      seq=16, device="cpu", log_every=10)
    assert len(losses) == 2 and all(np.isfinite(losses))
