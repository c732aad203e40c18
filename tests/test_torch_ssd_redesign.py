"""The redesigned ``ssd_scan``: one CTA a (b, h, slice of PS columns of P)
walks the chunks with its slice of the state, every product on tensor cores
in bf16 parts.

On the CPU: the kernel's walk in torch ops (``plain_slice_walk``, slice by
slice, with and without the kernel's parts) composes to ``plain_ssd_scan``
and holds to the JAX package's Pallas kernel in interpret mode, its
``ssd_chunked`` and its sequential oracle ``ssd_ref`` (fp32 within 1e-5,
bf16 within 2e-2, as ``tests/test_torch_kernels.py``; fp32 at |cs| ~ 200
within 1e-3 abs, as ``tests/test_torch_isolation.py``), at one chunk, H 1,
P and N not multiples of 16, |cs| ~ 200 at chunk 128, and steps with
dt * A > 0; the walk with the shorter chunk and the tiles of N that
``plan`` picks where the caller's chunk does not fit; the part split;
shared memory at every shape the first version took; and the C arguments
the wrapper passes (a fake library).  The ``cuda`` cases at the bottom hold
the kernel to the plain version and to the sequential oracle on the card
(fp32 within 1e-5 rel + 1e-3 abs, as ``tests/test_torch_isolation.py``;
bf16 y within 2 bf16 ulps + 1e-4 x max|plain| and the state within 1e-3 rel
+ 1e-4 x max, as ``chip_smoke.py``) and check that the wrapper never syncs
with the host; they need no JAX.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import launches
from repro_torch.kernels._launch import SMEM_LIMIT
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan.ref import ssd_ref

try:
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_kernel
    from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
    from repro.models.ssm import ssd_chunked as j_ssd_chunked

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_torch_kernels.py's _tol
# fp32 at |cs| ~ 200 (chunk 128): tests/test_torch_isolation.py's SSD limit,
# 1e-3 abs; every form sums cs in its own order, and the ulp of 200 (1.5e-5)
# moves each exp(cs_i - cs_j) by up to that much relative; the same limit
# for the growth case, whose terms (|y| up to ~500) cancel to y of ~1
SSD_ATOL_FP32 = 1e-3

# b, S, H, P, N, chunk: tests/test_kernels.py's cases, then one chunk (S ==
# chunk), H 1 with two slices, P and N not multiples of 16 (P 40: a full
# slice and a slice of 8)
CASES = [
    (1, 16, 2, 4, 4, 8), (2, 32, 3, 8, 4, 8), (1, 64, 2, 16, 8, 16), (2, 24, 1, 8, 8, 8),
    (1, 32, 2, 8, 12, 32), (2, 48, 1, 64, 16, 16), (1, 48, 2, 40, 20, 16),
]
# the large decay: chunk 128 with dt * A ~ -1.6 a step, so cs reaches ~ -200
# within the chunk and exp(cs_i - cs_j) above the diagonal overflows fp32
BIG_DECAY = (1, 256, 2, 8, 16, 128)
# growth: A of the last head +0.05, so dt * A > 0 there and exp(cs_i - cs_j)
# exceeds 1 below the diagonal (within a chunk up to ~e^1, small enough
# not to overflow)
GROWTH = (1, 64, 3, 8, 16, 32)


def _inputs(seed, b, S, H, P, N, big_decay=False, growth=False):
    """x, dt, A, B, C as fp32 numpy arrays (dt = softplus(randn), A =
    -exp(randn); with ``big_decay`` dt in [0.75, 0.85] and A -2, -1.9; with
    ``growth`` A from -0.5 to +0.05 over the heads)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    if big_decay:
        dt = rng.uniform(0.75, 0.85, (b, S, H)).astype(np.float32)
        A = np.linspace(-2.0, -1.9, H).astype(np.float32)
    if growth:
        A = np.linspace(-0.5, 0.05, H).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    return x, dt, A, B, C


def _case_inputs(case, seed=None):
    b, S, H, P, N, _ = case
    return _inputs(S + P + N if seed is None else seed, b, S, H, P, N,
                   big_decay=case == BIG_DECAY, growth=case == GROWTH)


def _torch(arrays, dtype):
    x, dt, A, B, C = arrays
    t = {k: torch.from_numpy(v).to(DTYPES[dtype]) for k, v in zip("x dt B C".split(),
                                                                  (x, dt, B, C))}
    return t["x"], t["dt"], torch.from_numpy(A), t["B"], t["C"]


def _walk(args, chunk, parts, n_tile=None):
    """Every slice of the walk, concatenated over P."""
    P = args[0].shape[-1]
    ys, states = zip(*[SK.plain_slice_walk(*args, chunk=chunk, p0=p0, parts=parts,
                                           n_tile=n_tile)
                       for p0 in range(0, P, SK.PS)])
    return torch.cat(ys, dim=-1), torch.cat(states, dim=2)


def _close(got, want, dtype, atol=None):
    np.testing.assert_allclose(got.float().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32), rtol=TOL[dtype],
                               atol=TOL[dtype] if atol is None else atol)


def _atol(case, dtype):
    return SSD_ATOL_FP32 if case in (BIG_DECAY, GROWTH) and dtype == "float32" else None


# ---------------------------------------------------------------------------
# the walk against the plain version and the reference


@pytest.mark.parametrize("parts", [False, True], ids=["fp32", "parts"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + [BIG_DECAY, GROWTH],
                         ids=lambda c: "-".join(map(str, c)))
def test_slice_walk_composes_to_plain(case, dtype, parts):
    """The slices of the walk, concatenated, are plain_ssd_scan: y in x's
    type, the final state fp32."""
    b, S, H, P, N, chunk = case
    args = _torch(_case_inputs(case), dtype)
    y, state = _walk(args, chunk, parts)
    want_y, want_state = SK.plain_ssd_scan(*args, chunk=chunk)
    assert y.dtype == args[0].dtype and y.shape == (b, S, H, P)
    assert state.dtype == torch.float32 and state.shape == (b, H, P, N)
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    _close(y, want_y.float(), dtype, _atol(case, dtype))
    _close(state, want_state, dtype, _atol(case, dtype))


@needs_jax
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + [BIG_DECAY, GROWTH],
                         ids=lambda c: "-".join(map(str, c)))
def test_slice_walk_in_parts_matches_reference(case, dtype):
    """Each slice of the walk, with the kernel's bf16 parts, against the
    reference's Pallas kernel (interpret mode), its ssd_chunked (on fp32
    copies of the same values) and its sequential oracle."""
    b, S, H, P, N, chunk = case
    arrays = _case_inputs(case)
    args = _torch(arrays, dtype)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx, jdt, jB, jC = (jnp.asarray(a, jd) for a in (arrays[0], arrays[1], arrays[3], arrays[4]))
    jA = jnp.asarray(arrays[2])
    wants = [j_ssd_kernel(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True),
             j_ssd_chunked(*(jnp.asarray(t.float().numpy()) for t in (args[0], args[1])), jA,
                           *(jnp.asarray(t.float().numpy()) for t in (args[3], args[4])),
                           chunk=chunk),
             j_ssd_ref(jx, jdt, jA, jB, jC)]
    for p0 in range(0, P, SK.PS):
        y, state = SK.plain_slice_walk(*args, chunk=chunk, p0=p0, parts=True)
        cols = slice(p0, min(p0 + SK.PS, P))
        for want_y, want_state in wants:
            _close(y, np.asarray(want_y, np.float32)[..., cols], dtype, _atol(case, dtype))
            _close(state, np.asarray(want_state, np.float32)[:, :, cols], dtype,
                   _atol(case, dtype))


def test_big_decay_needs_the_guard():
    """At |cs| ~ 200 exp(cs_i - cs_j) above the diagonal is inf in fp32, so
    the walk takes it only where i >= j: unguarded, inf * 0 is NaN."""
    args = _torch(_inputs(1, *BIG_DECAY[:5], big_decay=True), "float32")
    dt, A = args[1], args[2]
    cs = torch.cumsum(dt[0, :128, 0] * A[0], 0)
    assert float(cs[-1]) < -180
    above = torch.triu(cs[:, None] - cs[None, :], 1)
    assert torch.isinf(torch.exp(above)).any()
    assert torch.isnan(torch.exp(above) * torch.zeros(())).any()
    y, state = _walk(args, 128, True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()


def test_growth_takes_exp_below_the_diagonal_unclamped():
    """With dt * A > 0, exp(cs_i - cs_j) > 1 for i > j: the walk takes it as
    it is there (a clamp at 0 would give 1), and agrees with plain."""
    args = _torch(_case_inputs(GROWTH), "float32")
    dt, A = args[1], args[2]
    cs = torch.cumsum(dt[0, :32, -1] * A[-1], 0)
    assert float(A[-1]) > 0 and float((cs[:, None] - cs[None, :]).tril().max()) > 0.5
    y, state = _walk(args, 32, True)
    want_y, want_state = SK.plain_ssd_scan(*args, chunk=32)
    _close(y, want_y, "float32", SSD_ATOL_FP32)
    _close(state, want_state, "float32", SSD_ATOL_FP32)


# (dtype, case) where plan() cuts the caller's chunk or N: fp32 at chunk 128
# with N 256 (chunk 64) and N 161; N past NMAX in tiles (256 + 44, 256 + 16);
# a chunk of 200 walked as 64s with a short last chunk; fp32 at chunk 424
PLANNED = [("float32", (1, 256, 1, 8, 256, 128)), ("float32", (1, 256, 2, 1, 161, 128)),
           ("float32", (1, 40, 2, 8, 300, 40)), ("bfloat16", (1, 64, 2, 4, 272, 64)),
           ("float32", (1, 200, 1, 4, 256, 200)), ("float32", (1, 848, 1, 4, 16, 424))]


@pytest.mark.parametrize("dtype,case", PLANNED, ids=lambda v: v if isinstance(v, str)
                         else "-".join(map(str, v)))
def test_planned_walk_composes_to_plain(dtype, case):
    """The walk with the chunk and tiles plan() picks, in the kernel's
    parts, is plain_ssd_scan at the caller's chunk (fp32 within the SSD
    limit of 1e-3 abs: sums over N up to 300 and chunks up to 424 in
    another order; both forms lie within 5e-4 of ssd_chunked in fp64)."""
    b, S, H, P, N, chunk = case
    q, nt = SK.plan(chunk, N, DTYPES[dtype])
    assert (q, nt) != (chunk, N) and nt <= SK.NMAX
    assert SK.smem_bytes(q, nt, DTYPES[dtype]) <= SMEM_LIMIT
    args = _torch(_case_inputs(case), dtype)
    y, state = _walk(args, q, True, n_tile=nt)
    want_y, want_state = SK.plain_ssd_scan(*args, chunk=chunk)
    assert y.shape == (b, S, H, P) and state.shape == (b, H, P, N)
    atol = SSD_ATOL_FP32 if dtype == "float32" else None
    _close(y, want_y.float(), dtype, atol)
    _close(state, want_state, dtype, atol)


# ---------------------------------------------------------------------------
# the part split


def test_three_parts_give_back_fp32():
    """hi + mid + lo (each a bf16) is every fp32 value within 2^-24
    relative, across the exponent range; two parts reach 2^-16 and one 2^-8
    (the controls: why an fp32 operand takes K parts)."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(20000) * np.exp2(rng.uniform(-60, 60, 20000)))
                         .astype(np.float32))
    for k, bound in ((3, 2.0 ** -24), (2, 2.0 ** -16), (1, 2.0 ** -8)):
        parts = SK.split_parts(v, k)
        assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in parts)
        back = sum(p.double() for p in parts)
        rel = ((back - v.double()).abs() / v.double().abs()).max()
        assert float(rel) <= bound
        if k < 3:
            assert float(rel) > bound / 8   # the bound is what k parts reach, no better


def test_two_parts_hold_a_bf16_product_exactly():
    """x dt of two bf16 values has at most 16 significant bits: two bf16
    parts give it back exactly (one does not)."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(20000).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(2))
    v = a * b                                  # exact in fp32
    assert torch.equal(v.double(), a.double() * b.double())
    hi, lo = SK.split_parts(v, 2)
    assert torch.equal(hi.double() + lo.double(), v.double())
    assert not torch.equal(SK.split_parts(v, 1)[0], v)


# ---------------------------------------------------------------------------
# shared memory and the C arguments


def _first_version_smem(Q, P, N, itemsize):
    """The first version's shared memory a CTA (its ``smem_bytes``)."""
    ldb = N + (2 if itemsize == 2 else 1)
    return 4 * (P * (N + 1) + Q * P + 32 * Q + 4 * Q) + 2 * Q * ldb * itemsize


# every shape of the repo's tests and chip_smoke.py (b, S, H, P, N, chunk)
SHAPES = CASES + [BIG_DECAY, GROWTH, (1, 256, 2, 64, 128, 128), (2, 2048, 80, 64, 128, 128),
                  (1, 1024, 80, 64, 128, 128), (1, 512, 8, 64, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smem_fits_every_shape_the_first_version_took(dtype):
    """Every (chunk, P, N) the first version's 227 KB took, from chunk 1 to
    its longest and N 1 to its widest, the kernel takes too: plan() keeps
    the caller's chunk wherever its tiles fit and N up to NMAX in one tile,
    else a shorter chunk (a multiple of 16) and tiles of NMAX, and those fit."""
    for *_, P, N, chunk in SHAPES:
        assert SK.plan(chunk, N, dtype) == (chunk, N)
        assert SK.smem_bytes(chunk, N, dtype) <= SMEM_LIMIT
    taken = 0
    for Q in (1, 8, 16, 24, 32, 48, 64, 96, 100, 128, 161, 168, 200, 256, 424, 512, 768, 1024,
              1452, 1600):
        for N in (1, 4, 12, 16, 20, 32, 64, 96, 128, 161, 200, 256, 257, 300, 512, 1000, 4096,
                  12000, 19000):
            for P in (1, 4, 8, 40, 64, 128, 256):
                if _first_version_smem(Q, P, N, dtype.itemsize) > SMEM_LIMIT:
                    continue
                taken += 1
                for aligned in (True, False):
                    q, nt = SK.plan(Q, N, dtype, aligned)
                    assert SK.smem_bytes(q, nt, dtype, aligned) <= SMEM_LIMIT, (Q, P, N)
                    assert nt == min(N, SK.NMAX) and 1 <= q <= Q and (q == Q or q % 16 == 0)
                    if SK.smem_bytes(Q, nt, dtype, aligned) <= SMEM_LIMIT:
                        assert q == Q
    assert taken > 500   # the sweep reaches N past NMAX and chunks past 1024
    assert SK.plan(1452, 1, torch.bfloat16)[0] < 1452 and SK.plan(8, 19000, dtype)[1] == SK.NMAX
    # mamba2-2.7b bf16: the B tile, x, the state's two parts and the vectors,
    # C in registers
    assert SK.c_in_regs(128, torch.bfloat16)
    assert SK.smem_bytes(128, 128, torch.bfloat16) == (128 * 136 * 2 + 128 * 40 * 2
                                                       + 2 * 32 * 136 * 2 + 4 * 3 * 128)
    assert not SK.c_in_regs(128, torch.bfloat16, c_aligned=False)
    assert [n for n in range(1, 300) if SK.c_in_regs(n, torch.bfloat16)] == [32, 64, 128]
    assert not SK.c_in_regs(128, torch.float32)


def test_grid_covers_p_in_slices():
    assert SK.grid(2, 80, 64) == (160, 2)
    assert SK.grid(1, 3, 40) == (6, 1)
    assert SK.grid(1, 1, 4) == (1, 1)


def _fake_launches(monkeypatch, runs):
    """Drive the CUDA branch on CPU tensors against a stand-in for the C
    entry point, one call per (dtype, case) of ``runs``: returns the
    arguments of each call, the entry point's argtypes and what the wrapper
    allocated (y, the final state, the fp32 buffer of y's sum or None)."""
    from repro_torch import _build

    calls = []

    def entry(*args):
        assert len(args) == len(entry.argtypes)
        for t, a in zip(entry.argtypes, args):
            t.from_param(a)
        calls.append(args)
        return 0

    entry.argtypes = None
    monkeypatch.setattr(_build, "load", lambda lib: types.SimpleNamespace(ssd_scan_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(SK, "runs_plain", lambda *t: False)
    launch_cuda, outs = SK._launch_cuda, []

    def recording(x, dt, A, B, C, y, fin, ys, **kw):
        outs.append((tuple(y.shape), y.dtype, tuple(fin.shape), fin.dtype,
                     None if ys is None else (tuple(ys.shape), ys.dtype)))
        return launch_cuda(x, dt, A, B, C, y, fin, ys, **kw)

    monkeypatch.setattr(SK, "_launch_cuda", recording)
    before = launches["ssd_scan"]
    for dtype, (b, S, H, P, N, chunk) in runs:
        args = _torch(_inputs(0, b, S, H, P, N), {torch.float32: "float32",
                                                  torch.bfloat16: "bfloat16"}[dtype])
        y, fin = SK.ssd_scan(*args, chunk=chunk)
        assert y.shape == (b, S, H, P) and y.dtype == dtype
        assert fin.shape == (b, H, P, N) and fin.dtype == torch.float32
    assert launches["ssd_scan"] == before + len(runs) and len(calls) == len(runs)
    return calls, entry.argtypes, outs


def test_wrapper_passes_its_arguments_and_allocates_no_scratch(monkeypatch):
    """17 arguments of their ctypes types (the grid is the C side's, from
    b, H and P), the chunk and tile of N of plan() (here the caller's
    chunk, and a shorter one where fp32 tiles at chunk 128 do not fit), one
    launch counted a call, and only y and the final state allocated: with
    N in one tile the walk keeps no intermediate (a null buffer pointer)."""
    runs = ((torch.bfloat16, (2, 64, 3, 40, 20, 16)), (torch.float32, (1, 32, 2, 8, 12, 32)),
            (torch.float32, (1, 256, 1, 8, 256, 128)))
    calls, argtypes, outs = _fake_launches(monkeypatch, runs)
    assert len(argtypes) == 17
    assert [c[0] for c in calls] == [1, 0, 0] and all(c[8] == 0 for c in calls)
    assert [c[9:16] for c in calls] == [(2, 64, 3, 40, 20, 16, 20), (1, 32, 2, 8, 12, 32, 12),
                                        (1, 256, 1, 8, 256, 64, 256)]
    assert outs == [((2, 64, 3, 40), torch.bfloat16, (2, 3, 40, 20), torch.float32, None),
                    ((1, 32, 2, 8), torch.float32, (1, 2, 8, 12), torch.float32, None),
                    ((1, 256, 1, 8), torch.float32, (1, 1, 8, 256), torch.float32, None)]


def test_wrapper_allocates_the_sum_buffer_only_for_tiles_of_n(monkeypatch):
    """N past NMAX: tiles of NMAX, and an fp32 [b, S, H, P] buffer for y's
    sum over them, passed as the ninth argument."""
    calls, _, outs = _fake_launches(monkeypatch, ((torch.bfloat16, (1, 32, 2, 8, 300, 32)),))
    assert calls[0][8] != 0 and calls[0][9:16] == (1, 32, 2, 8, 300, 32, SK.NMAX)
    assert outs == [((1, 32, 2, 8), torch.bfloat16, (1, 2, 8, 300), torch.float32,
                     ((1, 32, 2, 8), torch.float32))]


def test_wrapper_refuses_b_past_the_grid_before_any_launch(monkeypatch):
    from repro_torch import _build

    monkeypatch.setattr(_build, "load", lambda lib: pytest.fail("loaded the C library"))
    monkeypatch.setattr(SK, "runs_plain", lambda *t: False)
    args = _torch(_inputs(0, SK.MAX_GRID_Y + 1, 2, 1, 1, 1), "bfloat16")
    before = dict(launches)
    with pytest.raises(ValueError, match=f"b up to {SK.MAX_GRID_Y}"):
        SK.ssd_scan(*args, chunk=2)
    assert launches == before


# ---------------------------------------------------------------------------
# on the card (no JAX)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# fp32: 1e-5 rel + 1e-3 abs (tests/test_torch_isolation.py: the cumulative
# sum runs in another order than torch.cumsum); bf16: chip_smoke.py's limits
CARD_TOL32, CARD_ATOL32 = 1e-5, 1e-3
CARD_ULPS, CARD_FLOOR, STATE_RTOL = 2, 1e-4, 1e-3
CARD_CASES = CASES + [(1, 256, 2, 64, 128, 128), (1, 512, 8, 64, 128, 128),  # mamba2's widths, cut
                      (1, 96, 3, 40, 32, 32), (2, 64, 2, 64, 64, 64),  # C in registers, N 32, 64
                      (1, 128, 2, 64, 256, 64), (1, 64, 3, 72, 40, 32)]


def _limit_check(got, want, kind):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    floor = CARD_FLOOR * float(want.abs().max())
    if kind == "state":
        limit = STATE_RTOL * want.abs() + floor
    else:
        _, e = torch.frexp(want)                 # |want| in [2^(e-1), 2^e): ulp 2^(e-8)
        ulp = torch.where(want == 0, torch.zeros_like(want), torch.exp2((e - 8).float()))
        limit = CARD_ULPS * ulp + floor
    err = (got - want).abs()
    assert bool((err <= limit).all()), (f"{kind}: max |err| {float(err.max()):.3g}, "
                                        f"max |err| / limit {float((err / limit).max()):.3g}")


def _card_check(dev, case, dtype, offset=0):
    b, S, H, P, N, chunk = case
    args = _torch(_case_inputs(case),
                  {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype])
    want_y, want_state = SK.plain_ssd_scan(*args, chunk=chunk)
    oracle_y, oracle_state = ssd_ref(*(t.float() for t in args))

    def on_card(t):
        if offset == 0 or t.dim() < 2:
            return t.to(dev)
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        return buf[offset:].view(t.shape).copy_(t)

    before = launches["ssd_scan"]
    y, state = SK.ssd_scan(*(on_card(t) for t in args), chunk=chunk)
    torch.cuda.synchronize()
    assert launches["ssd_scan"] == before + 1
    assert y.dtype == dtype and y.shape == (b, S, H, P) and state.shape == (b, H, P, N)
    if dtype == torch.float32:
        torch.testing.assert_close(y.cpu(), want_y, rtol=CARD_TOL32, atol=CARD_ATOL32)
        torch.testing.assert_close(state.cpu(), want_state, rtol=CARD_TOL32, atol=CARD_ATOL32)
    else:
        _limit_check(y, want_y, "bf16")
        _limit_check(state, want_state, "state")
    _limit_check(y, oracle_y, "bf16")        # the sequential oracle, chip_smoke.py's limits
    _limit_check(state, oracle_state, "state")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    _card_check(cuda_device, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_big_decay_on_card(cuda_device, dtype):
    """|cs| ~ 200 at chunk 128: finite, within the limits."""
    _card_check(cuda_device, BIG_DECAY, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_growth_on_card(cuda_device, dtype):
    """dt * A > 0 on one head: exp(cs_i - cs_j) > 1 on the diagonal blocks
    as below them, within the limits."""
    _card_check(cuda_device, GROWTH, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for _, c in PLANNED] + [(1, 512, 1, 8, 256, 256)],
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_planned_shapes_on_card(cuda_device, case, dtype):
    """Shapes the first version took whose tiles do not fit at the caller's
    chunk (a shorter chunk, the last one short) or whose N passes NMAX
    (tiles of N, y summed in the fp32 buffer)."""
    _card_check(cuda_device, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_unaligned_inputs_on_card(cuda_device, dtype):
    """x, dt, B and C one element into their storage: no 16-byte rows and
    no 32-bit pairs of C, the scalar staging and the C tile."""
    _card_check(cuda_device, (1, 64, 3, 40, 32, 32), dtype, offset=1)


@pytest.mark.cuda
def test_wrapper_never_syncs_with_the_host_on_card(cuda_device):
    args = [t.to(cuda_device) for t in _torch(_inputs(3, 1, 256, 4, 64, 128), "bfloat16")]
    SK.ssd_scan(*args, chunk=128)  # build and load outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, state = SK.ssd_scan(*args, chunk=128)
        y2, _ = SK.ssd_scan(*args, chunk=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    assert torch.isfinite(y2.float()).all()
