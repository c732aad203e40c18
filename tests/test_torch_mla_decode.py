"""The port's MLA decode (deepseek-v2 served) against the JAX package at
SMOKE size in fp32, on the same numpy inputs and the reference's weights
(``params_from_jax``).

* ``mla_decode`` (the absorbed form: scores and output in the latent space)
  for one step and for four, its output and both cache arrays;
* the MLA ``prefill`` logits and ``MLACache``;
* ``decode_step`` with ``moe_dispatch`` "dense" and "ws" (the expert
  kernel's plain version on the CPU) against the reference's, step by step;
* a prefill then decode steps against a longer prefill (the reference's
  tests/test_models_smoke.py case);
* the engine serving deepseek-v2 SMOKE on 2 replicas: greedy streams equal
  to the reference engine's, on the dense decode step;
* ``repro_torch.launch.serve`` on the CPU.

Every JAX function runs once, in the module fixture.  Tolerances: fp32 on
both sides, XLA and torch summing the same products in other orders;
``mla_decode`` within rtol 1e-5 / atol 1e-6, the model's logits and caches
within 1e-5 of their scale (``max |want|``, at least 1), and the
decode-against-prefill check at the reference's 2e-3.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode_step, init_caches, prefill  # noqa: E402
from repro_torch.models.attention import MLACache, mla_decode  # noqa: E402
from repro_torch.models.model import Caches, cache_tensors  # noqa: E402

ARCH = "deepseek-v2-236b"
RTOL = 1e-5
STEPS = 3
PROMPT_LENS = (5, 8, 3, 7)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what=""):
    got, want = _np(got), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _clone(c: Caches) -> Caches:
    return Caches(kv=MLACache(*(t.clone() for t in c.kv)))


def _mla_inputs(cfg, rng):
    """A layer's decode inputs: 4 token rows [2, 1, d] and a cache of 16
    slots filled at random, positions [5, 9] then on."""
    xs = rng.standard_normal((4, 2, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((2, 16, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 16, cfg.rope_head_dim)).astype(np.float32)
    return xs, ckv, kr, np.array([5, 9], np.int32)


def _serve(front_cls, batcher, req_cls, prompts, max_new=4):
    front = front_cls(batcher, n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, req_cls(rid, p, max_new=max_new))
    done = front.run(max_iters=200)
    return {rid: list(r.out) for rid, r in done.items()}, front


@pytest.fixture(scope="module")
def ds():
    """deepseek-v2 SMOKE: the reference's weights on both sides and every
    JAX result the tests compare with."""
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import WorkStealingFrontend as JFrontend

    jcfg, cfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    # under jit: the same weights as eager init, bit for bit, in half the time
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    out = dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp)

    # mla_decode on layer 0's projections, 4 steps
    xs, ckv, kr, pos = _mla_inputs(cfg, rng)
    jl0 = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    cache, mla = j_attn.MLACache(jnp.asarray(ckv), jnp.asarray(kr)), []
    for i, x in enumerate(xs):
        o, cache = j_attn.mla_decode(jnp.asarray(x), jl0, jcfg, cache, jnp.asarray(pos + i))
        mla.append((np.asarray(o), np.asarray(cache.ckv), np.asarray(cache.kr)))
    out.update(mla_in=(xs, ckv, kr, pos), mla=mla)

    # prefill, then decode steps with both dispatches
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, capacity=32)
    out.update(toks=toks, prefill=(np.asarray(jl), [np.asarray(a) for a in jc.kv]))
    nt0 = np.array([[3], [5]], np.int32)
    steps = {}
    for dispatch in ("dense", "ws"):
        c, nt, p, got = jc, nt0, np.array([12, 7], np.int32), []
        step = jax.jit(lambda *a, d=dispatch: j_decode(a[0], jcfg.replace(moe_dispatch=d),
                                                       *a[1:]))
        for _ in range(STEPS):
            lg, c = step(jp, c, jnp.asarray(nt), jnp.asarray(p))
            got.append((nt, p, np.asarray(lg), [np.asarray(a) for a in c.kv]))
            nt = np.asarray(lg).argmax(-1)[:, None].astype(np.int32)
            p = p + 1
        steps[dispatch] = got
    out["steps"] = steps
    out["cache_shapes"] = [a.shape for a in jax.tree_util.tree_leaves(
        j_init_caches(jcfg, 3, 24))]

    # the reference engine's greedy streams
    prng = np.random.default_rng(5)
    prompts = [prng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    out["prompts"] = prompts
    out["streams"], _ = _serve(JFrontend, lambda: JBatcher(jp, jcfg, slots=2, capacity=24),
                               JRequest, prompts)
    return out


def test_mla_decode_one_step_matches(ds):
    cfg = ds["cfg"]
    xs, ckv, kr, pos = ds["mla_in"]
    p = {k: v[0] for k, v in ds["tp"]["layers"]["attn"].items()}
    o, cache = mla_decode(_t(xs[0]), p, cfg, MLACache(_t(ckv), _t(kr)), pos)
    want_o, want_ckv, want_kr = ds["mla"][0]
    np.testing.assert_allclose(_np(o), want_o, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(cache.ckv), want_ckv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(cache.kr), want_kr, rtol=1e-5, atol=1e-6)


def test_mla_decode_four_steps_match_and_write_in_place(ds):
    """Four steps on one cache: each output and both cache arrays against the
    reference's, the new rows written into the tensors passed in."""
    cfg = ds["cfg"]
    xs, ckv, kr, pos = ds["mla_in"]
    p = {k: v[0] for k, v in ds["tp"]["layers"]["attn"].items()}
    cache = MLACache(_t(ckv), _t(kr))
    for i, (want_o, want_ckv, want_kr) in enumerate(ds["mla"]):
        o, new = mla_decode(_t(xs[i]), p, cfg, cache, torch.from_numpy(pos + i))
        assert new.ckv is cache.ckv and new.kr is cache.kr
        np.testing.assert_allclose(_np(o), want_o, rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(_np(cache.ckv), want_ckv, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(cache.kr), want_kr, rtol=1e-5, atol=1e-6)


def test_init_caches_match(ds):
    got = init_caches(ds["cfg"], 3, 24, device="cpu")
    assert isinstance(got.kv, MLACache)
    assert [tuple(t.shape) for t in cache_tensors(got)] == ds["cache_shapes"]
    assert got.cross_kv == () and got.ssm == ()


def test_prefill_matches(ds):
    tl, tc = prefill(ds["tp"], ds["cfg"], {"tokens": _t(ds["toks"]).long()}, capacity=32)
    want_l, want_c = ds["prefill"]
    _close(tl, want_l, "prefill logits")
    assert isinstance(tc.kv, MLACache)
    for name, g, w in zip(MLACache._fields, tc.kv, want_c):
        _close(g, w, "prefill " + name)


@pytest.mark.parametrize("dispatch", ["dense", "ws"])
def test_decode_step_matches_per_step(ds, dispatch):
    """Three decode steps from the prefill's caches at positions [12, 7]: each
    step's logits and both cache arrays (with "ws" the expert megakernel's
    plain version runs each MoE layer)."""
    cfg = ds["cfg"].replace(moe_dispatch=dispatch)
    _, tc = prefill(ds["tp"], cfg, {"tokens": _t(ds["toks"]).long()}, capacity=32)
    for i, (nt, pos, want_l, want_c) in enumerate(ds["steps"][dispatch]):
        tl, tc = decode_step(ds["tp"], cfg, tc, _t(nt).long(), pos)
        _close(tl, want_l, f"{dispatch} step {i} logits")
        for name, g, w in zip(MLACache._fields, tc.kv, want_c):
            _close(g, w, f"{dispatch} step {i} {name}")


def test_dense_and_ws_dispatch_agree_in_the_port(ds):
    cfg = ds["cfg"]
    _, tc = prefill(ds["tp"], cfg, {"tokens": _t(ds["toks"]).long()}, capacity=32)
    tok, pos = torch.tensor([[3], [5]]), np.array([12, 7])
    a, _ = decode_step(ds["tp"], cfg, _clone(tc), tok, pos)
    b, _ = decode_step(ds["tp"], cfg.replace(moe_dispatch="ws"), _clone(tc), tok, pos)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_prefill_then_decode_equals_a_longer_prefill(ds):
    """The reference's tests/test_models_smoke.py case: a prefill of S tokens
    against a prefill of S/2 then S/2 decode steps, within 2e-3; both
    layers' caches, so a slip in the layer index would show."""
    cfg, tp = ds["cfg"], ds["tp"]
    toks = _t(ds["toks"]).long()
    full, full_c = prefill(tp, cfg, {"tokens": toks}, capacity=12)
    _, caches = prefill(tp, cfg, {"tokens": toks[:, :6]}, capacity=12)
    for i in range(6, 12):
        logits, caches = decode_step(tp, cfg, caches, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
    for g, w in zip(caches.kv, full_c.kv):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3, atol=2e-3)


def test_ws_step_is_not_offered_for_mla(ds):
    """MLA decodes on the dense step, as in the reference: no ws step, no
    unified step, and ``decode_step_ws`` raises."""
    from repro.models import ws_decode_supported as j_ws_supported
    from repro_torch.models import decode_step_ws, unified_step_supported, ws_decode_supported

    cfg = ds["cfg"]
    assert not ws_decode_supported(cfg) and not j_ws_supported(ds["jcfg"])
    assert not unified_step_supported(cfg.replace(moe_dispatch="ws"))
    caches = init_caches(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        decode_step_ws(ds["tp"], cfg, caches, torch.zeros((2, 1), dtype=torch.long),
                       np.array([3, 3]))


def test_engine_streams_match_the_reference(ds):
    """2 replicas x 2 slots, 4 requests submitted to replica 0: the port's
    greedy streams equal the reference engine's, every request completes,
    and no replica took the ws step."""
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    got, front = _serve(WorkStealingFrontend,
                        lambda: ContinuousBatcher(ds["tp"], ds["cfg"], slots=2, capacity=24),
                        Request, ds["prompts"])
    assert got == ds["streams"] and sorted(got) == list(range(len(PROMPT_LENS)))
    assert not any(b.use_ws for b in front.batchers)
    assert all(isinstance(b.caches.kv, MLACache) for b in front.batchers)


def test_serve_cli_completes_every_request(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", ARCH, "--device", "cpu", "--requests", "5", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "5/5 completed" in out and "all=True" in out
