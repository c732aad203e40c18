"""The banded flash path for static causal windows against the JAX package,
on the CPU.

``repro_torch.models.attention.flash_ref`` takes the banded branch
(``_flash_banded``) exactly where the reference's does: window > 0, causal,
Sq == Sk > window.  Each query chunk runs the flash core (``_Flash``) on a
view of the key band it can see, with its offset in the band.  Held here:

* forward and gradients (``torch.autograd`` against ``jax.vjp`` of the
  reference's ``flash_ref``) in fp32 within 1e-5, for a window that divides
  the chunk, one that does not, a band clipped to the query chunks, a
  window of at least S (both packages mask every block) and ``causal=False``;
* a spy on ``_Flash.apply``: the chunk ``c``, the band width ``nb`` and
  each chunk's ``qoff`` are the reference's, and the band is a view;
* ``loss_fn`` and every gradient at the gemma3-12b and h2o-danube-1.8b
  smoke configs at a sequence past their windows, with the banded branch
  taken in every windowed layer.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models.attention import _pick_chunk as j_pick_chunk  # noqa: E402
from repro.models.attention import flash_ref as j_flash_ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.attention import flash_ref  # noqa: E402

TOL = 1e-5   # the same fp32 online softmax, blockwise in the same order

# (S, window, chunk, causal): the band's cases
CASES = {
    "window divides the chunk": (64, 16, 16, True),
    "window does not divide": (96, 20, 32, True),
    "band clipped to nq": (48, 40, 16, True),
    "window >= S (masked)": (32, 40, 16, True),
    "not causal (masked)": (64, 16, 16, False),
}


def _inputs(seed, S, B=2, H=3, hd=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_ref_matches_reference(case):
    S, window, chunk, causal = CASES[case]
    q, k, v, do = _inputs(list(CASES).index(case), S)
    jo, vjp = jax.vjp(lambda a, b, c: j_flash_ref(a, b, c, causal=causal, window=window,
                                                  chunk=chunk), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_ref(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), rtol=0, atol=TOL)
    for name, t, g in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=TOL,
                                   err_msg=f"d{name}")


class _Spy:
    """Records each ``_Flash.apply`` call, then runs it."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def apply(self, q, k, v, win, qoff, causal, chunk):
        self.calls.append(dict(q=q, k=k, v=v, win=win, qoff=qoff, causal=causal, chunk=chunk))
        return self.real.apply(q, k, v, win, qoff, causal, chunk)


def _reference_band(S, window, chunk):
    """The reference's chunking (``repro/models/attention.py::_flash_banded``)."""
    c = j_pick_chunk(S, min(chunk, max(window, 16)))
    nq = S // c
    nb = min(-(-window // c) + 1, nq)
    return c, nq, nb


@pytest.mark.parametrize("case", list(CASES))
def test_banded_branch_takes_the_reference_chunks(case, monkeypatch):
    S, window, chunk, causal = CASES[case]
    spy = _Spy(attention._Flash)
    monkeypatch.setattr(attention, "_Flash", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(0, S))
    flash_ref(q, k, v, causal=causal, window=window, chunk=chunk)
    if not (causal and S > window):
        assert len(spy.calls) == 1
        call = spy.calls[0]
        assert (call["qoff"], call["win"], call["causal"], call["chunk"]) == (0, window, causal,
                                                                             chunk)
        assert call["q"] is q and call["k"] is k
        return
    c, nq, nb = _reference_band(S, window, chunk)
    assert len(spy.calls) == nq
    for qi, call in enumerate(spy.calls):
        lo = max(qi - (nb - 1), 0)
        assert (call["win"], call["causal"], call["chunk"]) == (window, True, c)
        assert call["qoff"] == (qi - lo) * c
        assert call["q"].shape[1] == c and call["k"].shape[1] == nb * c
        # views of the caller's tensors, not copies
        assert call["k"].data_ptr() == k[:, lo * c].data_ptr()
        assert call["v"].data_ptr() == v[:, lo * c].data_ptr()
        assert call["q"].data_ptr() == q[:, qi * c].data_ptr()


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "/"))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("mod", ["gemma3_12b", "h2o_danube_1_8b"])
def test_windowed_loss_and_grads_banded(mod, monkeypatch):
    """``loss_fn`` on 2 x 24 tokens (three times the smoke windows of 8) and
    every gradient, with remat, against the reference's; every windowed
    layer's forward takes the banded branch (and its replay in the
    backward)."""
    import importlib

    from repro.models import init_params as j_init
    from repro.models import loss_fn as j_loss_fn
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.steps import loss_and_grads

    j = importlib.import_module(f"repro.configs.{mod}")
    t = importlib.import_module(f"repro_torch.configs.{mod}")
    S = 24
    n_windowed = sum(1 for w in t.SMOKE.layer_windows if 0 < w < S)
    assert n_windowed > 0
    jp = j_init(jax.random.PRNGKey(7), j.SMOKE)
    toks = np.random.default_rng(8).integers(0, j.SMOKE.vocab_size, (2, S)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, j.SMOKE, {"tokens": jnp.asarray(toks)}), has_aux=True))(jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    banded = []
    real = attention._flash_banded
    monkeypatch.setattr(attention, "_flash_banded",
                        lambda *a: banded.append(a[3]) or real(*a))
    loss, _, grads = loss_and_grads(tp, t.SMOKE, {"tokens": torch.from_numpy(toks)})
    # forward, and the remat replay of each layer in the backward
    assert banded == [w for w in t.SMOKE.layer_windows if 0 < w < S] * 2
    assert float(loss) == pytest.approx(float(jl), abs=TOL)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jg)), _flat(grads)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=TOL,
                                   err_msg=name)
