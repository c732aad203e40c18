"""The port's standalone kernels (``repro_torch.kernels``) and the windowed
dense configs against the JAX package, on the CPU.

The kernels' plain versions (what a wrapper runs for CPU tensors) are held
to the reference's dense oracles (``attention_ref``, ``decode_attention_ref``,
``ssd_ref``) in every case of ``tests/test_kernels.py`` and, in fp32, to the
Pallas kernels in interpret mode (flash ``lse`` and the SSD final state
included); the port's ``ssd_chunked``/``_segsum`` to the reference's; the two
autograd Functions' gradients to ``jax.grad`` of the reference ops.  The
CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_isolation.py``, marked ``cuda``, and ``chip_smoke.py``).

Tolerances: fp32 forwards 1e-5 abs + 1e-5 rel, gradients 1e-4 (the same fp32
arithmetic in another order: blockwise online softmax against a dense
softmax, a chunked scan against a sequential one); bf16 the reference's own
2e-2 (``tests/test_kernels.py``), both sides rounding fp32 results to bf16.
Inputs are drawn with numpy from a seed; bf16 inputs are the same fp32
draws rounded to bf16 on both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention as j_decode_kernel  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as j_decode_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd as j_flash_fwd  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_kernel  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.models.ssm import _segsum as j_segsum  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention, launches, ssd_scan  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan as ssd_scan_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models.ssm import _segsum, ssd_chunked  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = 1e-4


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


def _close(got, want, dtype):
    tol = _tol(dtype)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype``."""
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors run the plain versions: no test here launches a kernel."""
    before = dict(launches)
    yield
    assert launches == before


# ---------------------------------------------------------------------------
# flash attention


FLASH_CASES = [  # B, H, Hkv, S, hd, bq, bk, causal, window (tests/test_kernels.py)
    (1, 2, 2, 32, 8, 16, 16, True, 0),
    (2, 4, 2, 64, 16, 16, 32, True, 0),
    (2, 4, 1, 64, 16, 32, 16, False, 0),
    (1, 8, 4, 128, 32, 32, 32, True, 24),
    (1, 2, 2, 48, 8, 16, 16, True, 16),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_fwd(case, dtype):
    """The plain forward and the port's oracle against the reference's
    oracle; in fp32 also out and lse against the Pallas kernel."""
    B, H, Hkv, S, hd, bq, bk, causal, window = case
    (jq, jk, jv), (q, k, v) = _pair(_draw(S + hd, (B, H, S, hd), (B, Hkv, S, hd),
                                          (B, Hkv, S, hd)), dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, bq=bq, bk=bk)
    assert out.dtype == q.dtype and lse.dtype == torch.float32 and lse.shape == (B, H, S)
    want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(out, want, dtype)
    _close(attention_ref(q, k, v, causal=causal, window=window), want, dtype)
    if dtype == "float32":
        jout, jlse = j_flash_fwd(jq, jk, jv, causal=causal, window=window, bq=bq, bk=bk,
                                 interpret=True)
        _close(out, jout, dtype)
        _close(lse, jlse, dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_flash_attention_grad(causal, window):
    """The autograd Function's gradients against jax.grad of the reference's
    custom-VJP op (its forward the Pallas kernel in interpret mode)."""
    B, H, Hkv, S, hd = 2, 4, 2, 32, 16
    arrays = _draw(7, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    want = jax.grad(lambda q, k, v: (j_flash(q, k, v, causal, window, 16, 16, True) ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    (flash_attention(*xs, causal, window, 16, 16) ** 2).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_ragged_entry_points_are_the_megakernels():
    """``ragged_flash_attention``/``ragged_decode_attention`` of the kernels
    package are the ws megakernel's entry points: the same outputs, and
    those of the dense length-masked oracles."""
    from repro_torch.kernels.decode_attention.ops import ragged_decode_attention
    from repro_torch.kernels.flash_attention.ops import ragged_flash_attention
    from repro_torch.pallas_ws import ragged as R

    lengths = [40, 9, 0, 24]
    q, k, v = (torch.from_numpy(a) for a in _draw(3, (4, 4, 40, 16), (4, 2, 40, 16),
                                                  (4, 2, 40, 16)))
    for schedule in ("ws", "static"):
        got = ragged_flash_attention(q, k, v, lengths, schedule=schedule, n_programs=4, bq=8,
                                     bk=8)
        assert torch.equal(got, R.ragged_flash_attention(q, k, v, lengths, schedule=schedule,
                                                         n_programs=4, bq=8, bk=8))
        np.testing.assert_allclose(got.numpy(), R.ragged_attention_ref(q, k, v, lengths).numpy(),
                                   rtol=1e-5, atol=1e-5)
        qd = q[:, :, 0]
        got = ragged_decode_attention(qd, k, v, lengths, schedule=schedule, n_programs=4, bk=8)
        assert torch.equal(got, R.ragged_decode_attention(qd, k, v, lengths, schedule=schedule,
                                                          n_programs=4, bk=8))
        np.testing.assert_allclose(got.numpy(), R.ragged_decode_ref(qd, k, v, lengths).numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# decode attention


DECODE_CASES = [  # B, H, Hkv, S, hd, bk, pos, window (tests/test_kernels.py)
    (1, 2, 1, 32, 8, 8, 31, 0),
    (2, 4, 2, 64, 16, 16, 30, 0),
    (2, 4, 2, 64, 16, 16, 63, 16),
    (1, 8, 8, 128, 32, 32, 5, 0),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_decode_attention(case, dtype):
    """The plain version (pos as an int and as a 0-d tensor) and the port's
    oracle against the reference's oracle; in fp32 also the Pallas kernel."""
    B, H, Hkv, S, hd, bk, pos, window = case
    (jq, jk, jv), (q, k, v) = _pair(_draw(S + pos, (B, H, hd), (B, Hkv, S, hd),
                                          (B, Hkv, S, hd)), dtype)
    want = j_decode_ref(jq, jk, jv, jnp.int32(pos), window=window)
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = decode_attention(q, k, v, p, window=window, bk=bk)
        assert got.dtype == q.dtype and got.shape == (B, H, hd)
        _close(got, want, dtype)
    _close(decode_attention_ref(q, k, v, pos, window=window), want, dtype)
    if dtype == "float32":
        _close(got, j_decode_kernel(jq, jk, jv, jnp.int32(pos), window=window, bk=bk,
                                    interpret=True), dtype)


# ---------------------------------------------------------------------------
# ssd scan


SSD_CASES = [  # b, S, H, P, N, chunk (tests/test_kernels.py)
    (1, 16, 2, 4, 4, 8), (2, 32, 3, 8, 4, 8), (1, 64, 2, 16, 8, 16), (2, 24, 1, 8, 8, 8),
]


def _ssd_inputs(seed, b, S, H, P, N):
    x, dtn, an, B, C = _draw(seed, (b, S, H, P), (b, S, H), (H,), (b, S, N), (b, S, N))
    dt = np.log1p(np.exp(dtn)).astype(np.float32)        # softplus
    A = (-np.exp(an)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_fwd(case, dtype):
    """The plain version's y and final state, and the port's sequential
    oracle, against the reference's oracle; in fp32 also the Pallas kernel."""
    b, S, H, P, N, chunk = case
    x, dt, A, B, C = _ssd_inputs(S + P + N, b, S, H, P, N)
    (jx, jdt, jB, jC), (tx, tdt, tB, tC) = _pair([x, dt, B, C], dtype)
    y, fin = ssd_scan_fwd(tx, tdt, torch.from_numpy(A), tB, tC, chunk=chunk)
    assert y.dtype == tx.dtype and fin.dtype == torch.float32 and fin.shape == (b, H, P, N)
    yr, finr = j_ssd_ref(jx, jdt, jnp.asarray(A), jB, jC)
    _close(y, yr, dtype)
    _close(fin, finr, dtype)
    ry, rfin = ssd_ref(tx, tdt, torch.from_numpy(A), tB, tC)
    _close(ry, yr, dtype)
    _close(rfin, finr, dtype)
    if dtype == "float32":
        jy, jfin = j_ssd_kernel(jx, jdt, jnp.asarray(A), jB, jC, chunk=chunk, interpret=True)
        _close(y, jy, dtype)
        _close(fin, jfin, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES[1:3], ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunked_and_segsum_match_reference(case, dtype):
    b, S, H, P, N, chunk = case
    x, dt, A, B, C = _ssd_inputs(11, b, S, H, P, N)
    (jx, jdt, jB, jC), (tx, tdt, tB, tC) = _pair([x, dt, B, C], dtype)
    jy, jfin = j_ssd_chunked(jx, jdt, jnp.asarray(A), jB, jC, chunk=chunk)
    y, fin = ssd_chunked(tx, tdt, torch.from_numpy(A), tB, tC, chunk=chunk)
    assert y.dtype == tx.dtype and fin.dtype == torch.float32
    _close(y, jy, dtype)
    _close(fin, jfin, dtype)
    dA = x[0, :chunk, 0, :4].T.copy()                      # [4, chunk]
    want = np.asarray(j_segsum(jnp.asarray(dA)))
    got = _segsum(torch.from_numpy(dA)).numpy()
    assert (np.isneginf(got) == np.isneginf(want)).all()
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


def test_ssd_grad_matches_reference():
    """The autograd Function's gradients (its backward the port's
    ssd_chunked under autograd) against jax.grad of the reference's op."""
    b, S, H, P, N = 1, 32, 2, 8, 4
    arrays = _ssd_inputs(5, b, S, H, P, N)
    want = jax.grad(lambda *a: (j_ssd(*a, 8, True) ** 2).sum(),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    (ssd_scan(*xs, 8) ** 2).sum().backward()
    for name, x, w in zip(("x", "dt", "A", "B", "C"), xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the dense configs with windows, tied embeddings and depth-scaled residuals

CONFIGS = ("minicpm_2b", "h2o_danube_1_8b", "gemma3_12b")
CONFIG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "rope_theta", "dtype", "padded_vocab", "hd", "eff_heads",
                 "layer_windows", "tie_embeddings", "depth_scaled_residual", "norm_eps")
MODEL_ATOL = 1e-5        # fp32 logits and caches of magnitude <~ 3, 2-6 layers of width 64


def _configs(mod):
    import importlib

    j = importlib.import_module(f"repro.configs.{mod}")
    t = importlib.import_module(f"repro_torch.configs.{mod}")
    return j, t


@pytest.mark.parametrize("mod", CONFIGS)
def test_windowed_config_mirrors_reference(mod):
    from repro_torch.configs import ARCH_MODULES, get_config

    j, t = _configs(mod)
    for f in CONFIG_FIELDS:
        assert getattr(t.CONFIG, f) == getattr(j.CONFIG, f), f
        assert getattr(t.SMOKE, f) == getattr(j.SMOKE, f), f
    assert ARCH_MODULES[j.CONFIG.name] == mod
    assert get_config(j.CONFIG.name) is t.CONFIG and get_config(j.CONFIG.name, True) is t.SMOKE


@pytest.mark.parametrize("mod", CONFIGS)
def test_windowed_prefill_and_decode_match_reference(mod):
    """Prefill of 12 tokens, then 8 decode steps (positions 12-19, past the
    smoke configs' 8-token windows): every step's logits and the final
    caches."""
    from repro.models import decode_step as j_decode
    from repro.models import init_params as j_init
    from repro.models import prefill as j_prefill
    from repro_torch.convert import params_from_jax
    from repro_torch.models import decode_step, prefill

    j, t = _configs(mod)
    jp = j_init(jax.random.PRNGKey(3), j.SMOKE)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, j.SMOKE.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = j_prefill(jp, j.SMOKE, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = prefill(tp, t.SMOKE, {"tokens": torch.from_numpy(toks).long()}, capacity=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=MODEL_ATOL)
    j_step = jax.jit(lambda p, c, tok, pos: j_decode(p, j.SMOKE, c, tok, pos))
    for step in range(8):
        nt = rng.integers(0, j.SMOKE.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([12 + step, 12 + step], np.int32)
        jl, jc = j_step(jp, jc, jnp.asarray(nt), jnp.asarray(pos))
        tl, tc = decode_step(tp, t.SMOKE, tc, torch.from_numpy(nt).long(), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=MODEL_ATOL,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), rtol=0, atol=MODEL_ATOL)
    np.testing.assert_allclose(tc.kv.v.numpy(), np.asarray(jc.kv.v), rtol=0, atol=MODEL_ATOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mod", CONFIGS)
def test_windowed_loss_and_grads_match_reference(mod):
    """loss_fn (remat) on 2 x 16 tokens, past the windows, and the gradient
    of every parameter."""
    from repro.models import init_params as j_init
    from repro.models import loss_fn as j_loss_fn
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.steps import loss_and_grads

    j, t = _configs(mod)
    jp = j_init(jax.random.PRNGKey(5), j.SMOKE)
    toks = np.random.default_rng(6).integers(0, j.SMOKE.vocab_size, (2, 16)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, j.SMOKE, {"tokens": jnp.asarray(toks)}), has_aux=True))(jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    loss, _, grads = loss_and_grads(tp, t.SMOKE, {"tokens": torch.from_numpy(toks)})
    assert float(loss) == pytest.approx(float(jl), abs=MODEL_ATOL)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jg)), _flat(grads)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=0, atol=MODEL_ATOL, err_msg=n)
