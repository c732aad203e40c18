"""The redesigned attention kernels: ``ws_attention``'s three tile bodies
(decode GEMV, bf16 flash tiles on mma.sync, the fp32 body) and
``flash_fwd``'s tensor-core body.

On the CPU: which body each caller's shapes and layouts reach, their
shared memory, the wrappers' refusals before any launch, and a precision
model of the tensor-core P V in torch against the JAX package's dense
oracles: softmax weights rounded to bf16 once miss the 1e-4 the kernels'
fp32 outputs are held to on rows that see few keys, weights split into two
bf16 parts (hi + lo, as the kernels multiply them) stay inside it.  The
``cuda`` cases at the bottom hold every body of both kernels to its plain
version and skip without a card; they need no JAX.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import launches as klaunches
from repro_torch.kernels._launch import SMEM_LIMIT
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.pallas_ws import (
    emit_decode_tasks,
    emit_flash_tasks,
    make_queue_state,
    normalized_out,
    run_ws_schedule,
    to_device,
)
from repro_torch.pallas_ws import kernel as K

try:
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ref import attention_ref
    from repro.pallas_ws.ragged import ragged_attention_ref

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

# chip_smoke.py's ATOL: the kernels' fp32 `out` against fp32 references
ATOL = 1e-4
BF16, FP32 = torch.bfloat16, torch.float32


def _cache_view(B, S, Hkv, hd, dtype, layer=None):
    """K as the serving cache lays it out, [B, S, Hkv, hd] (or one layer of a
    stacked [L, B, S, Hkv, hd] cache), read as [B, Hkv, S, hd]."""
    if layer is None:
        return torch.zeros((B, S, Hkv, hd), dtype=dtype).permute(0, 2, 1, 3)
    return torch.zeros((layer + 1, B, S, Hkv, hd), dtype=dtype)[layer].permute(0, 2, 1, 3)


def _dense(B, H, S, hd, dtype):
    return torch.zeros((B, H, S, hd), dtype=dtype)


def _offset_rows(B, H, S, hd, dtype):
    """A view whose rows are hd + 1 elements apart: no 16-byte rows."""
    return torch.zeros((B, H, S, hd + 1), dtype=dtype)[..., 1:]


# (what calls it, q, k, bq, the body it must reach)
CALLERS = [
    ("llama3.2-3b split decode (gqa_decode_ws)", lambda: _dense(4, 24, 1, 128, BF16),
     lambda: _cache_view(4, 1024, 8, 128, BF16), 1, "decode"),
    ("kimi-k2 split decode, hd 112", lambda: _dense(4, 64, 1, 112, BF16),
     lambda: _cache_view(4, 1024, 8, 112, BF16), 1, "decode"),
    ("kimi-k2 fp32 split step (unified_moe phase)", lambda: _dense(4, 64, 1, 112, FP32),
     lambda: _cache_view(4, 64, 8, 112, FP32), 1, "decode"),
    ("llama fp32 split step, a layer of the stacked cache",
     lambda: _dense(4, 24, 1, 128, FP32), lambda: _cache_view(4, 64, 8, 128, FP32, layer=2),
     1, "decode"),
    ("ragged prefill (ragged_flash_attention), bq 32", lambda: _dense(4, 24, 64, 128, BF16),
     lambda: _dense(4, 8, 64, 128, BF16), 32, "mma"),
    ("chip_smoke parity flash, bq 16", lambda: _dense(2, 24, 256, 128, BF16),
     lambda: _dense(2, 8, 256, 128, BF16), 16, "mma"),
    ("bf16 flash tiles of bq 64", lambda: _dense(1, 2, 64, 64, BF16),
     lambda: _dense(1, 1, 64, 64, BF16), 64, "mma"),
    ("fp32 flash tiles", lambda: _dense(2, 4, 40, 16, FP32),
     lambda: _dense(2, 2, 40, 16, FP32), 8, "generic"),
    ("bf16 flash tiles at hd 256", lambda: _dense(1, 2, 64, 256, BF16),
     lambda: _dense(1, 1, 64, 256, BF16), 16, "generic"),
    ("bf16 flash tiles of bq 8", lambda: _dense(1, 2, 64, 64, BF16),
     lambda: _dense(1, 1, 64, 64, BF16), 8, "generic"),
    ("fp32 decode over a cache view, hd 8 (the wrapper's marshalling test)",
     lambda: _dense(2, 2, 1, 8, FP32), lambda: _cache_view(2, 16, 1, 8, FP32), 1, "decode"),
    ("decode over rows hd + 1 apart", lambda: _dense(2, 4, 1, 128, BF16),
     lambda: _offset_rows(2, 2, 64, 128, BF16), 1, "generic"),
    ("flash tiles over rows hd + 1 apart", lambda: _dense(2, 4, 64, 128, BF16),
     lambda: _offset_rows(2, 2, 64, 128, BF16), 32, "generic"),
    ("decode at hd 100 (not whole vectors)", lambda: _dense(2, 4, 1, 100, BF16),
     lambda: _dense(2, 2, 64, 100, BF16), 1, "generic"),
]


@pytest.mark.parametrize("case", CALLERS, ids=lambda c: c[0])
def test_attention_branch_of_every_caller(case):
    _, mk_q, mk_k, bq, want = case
    q, k = mk_q(), mk_k()
    assert K.attention_branch(q, k, k, bq) == want
    bk = 64
    assert K.smem_bytes(want, bq, bk, q.shape[-1]) <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_smem_fits_every_tested_shape(dtype):
    """Every (bq, bk, hd) of the card tests and the callers fits one CTA's
    shared memory in the body it reaches, in both kernels."""
    for bq in (1, 16, 32, 64):
        for bk in (16, 32, 64):
            for hd in (64, 112, 128, 256):
                q = _dense(1, 2, 64, hd, dtype)
                k = _dense(1, 1, 64, hd, dtype)
                for kv in (k, _cache_view(1, 64, 1, hd, dtype)):
                    branch = K.attention_branch(q, kv, kv, bq)
                    assert K.smem_bytes(branch, bq, bk, hd) <= SMEM_LIMIT, (bq, bk, hd, branch)
    for hd in (8, 16, 64, 72, 100, 112, 120, 128, 256):
        assert FK.smem_bytes(hd, dtype) <= SMEM_LIMIT
    assert FK.flash_branch(BF16, 128) == "mma" and FK.flash_branch(BF16, 72) == "mma"
    assert FK.flash_branch(BF16, 100) == "cores" and FK.flash_branch(FP32, 128) == "cores"
    # the tensor-core body's Q tile and two stages of K and V, rows padded by 8
    assert FK.smem_bytes(128, BF16) == 2 * (64 + 4 * 64) * 136
    assert FK.smem_bytes(72, BF16) == FK.smem_bytes(128, BF16)
    assert FK.smem_bytes(256, BF16) == 2 * (64 + 4 * 32) * 264


class _EntryPoint:
    """A stand-in for a C entry point: converts every argument through its
    declared ctypes type and keeps the calls' arguments."""

    argtypes = None
    restype = ctypes.c_int

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        for t, a in zip(self.argtypes, args):
            t.from_param(a)
        self.calls.append(args)
        return 0


def _ws_arrays(state, P):
    arrs = {n: torch.as_tensor(getattr(state, n)) for n in
            ("tasks", "tail", "head", "local_head", "taken", "remaining")}
    for n in ("clock", "work", "steals", "scanned"):
        arrs[n] = torch.zeros(P, dtype=torch.int32)
    arrs["mult"] = torch.zeros((P, state.n_tasks), dtype=torch.int32)
    return arrs


def test_ws_attention_wrapper_passes_the_branch_and_refuses_before_launch(monkeypatch):
    """The branch index reaches the C entry point; a tile past one CTA's
    shared memory (the fp32 body at bq = bk = 128, hd 256) is refused before
    the library is called or the launch counted."""
    from repro_torch import _build

    entry = _EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_attention_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    kw = dict(mode="free", rounds=0, steal=True, policy="cost", compress=False,
              causal=True, scale=0.1, g=1)
    state = make_queue_state(emit_flash_tasks([128], 1, 32, 32), 2)
    q = _dense(1, 1, 128, 128, BF16)
    before = K.launches["ws_attention"]
    K._launch_cuda(_ws_arrays(state, 2), q, q, q, torch.zeros((1, 1, 128, 128)), bq=32, bk=32,
                   n_tasks=state.n_tasks, **kw)
    assert K.launches["ws_attention"] == before + 1
    branch_arg = len(entry.argtypes) - 1 - 6 - 1 - 1  # before scale, the ring, the stream
    assert entry.calls[-1][branch_arg] == K.BRANCHES.index("mma")

    big = make_queue_state(emit_flash_tasks([128], 1, 128, 128), 2)
    q = _dense(1, 1, 128, 256, FP32)
    assert K.attention_branch(q, q, q, 128) == "generic"
    with pytest.raises(ValueError, match="shared memory"):
        K._launch_cuda(_ws_arrays(big, 2), q, q, q, torch.zeros((1, 1, 128, 256)), bq=128,
                       bk=128, n_tasks=big.n_tasks, **kw)
    assert K.launches["ws_attention"] == before + 1 and len(entry.calls) == 1


def test_flash_fwd_refuses_rows_off_16_byte_boundaries(monkeypatch):
    """The tensor-core body copies 16-byte rows: a contiguous bf16 view that
    starts off a 16-byte boundary is refused before any launch, and an
    aligned one passes the body the wrapper chose to the C entry point."""
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import kernel as fk

    monkeypatch.setattr(_build, "load", lambda lib: pytest.fail("loaded the C library"))
    monkeypatch.setattr(fk, "runs_plain", lambda *t: False)
    n = 1 * 2 * 64 * 64
    q = torch.zeros(n + 8, dtype=BF16)[1:n + 1].view(1, 2, 64, 64)
    k = torch.zeros((1, 1, 64, 64), dtype=BF16)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = dict(klaunches)
    with pytest.raises(ValueError, match="16-byte"):
        fk.flash_attention_fwd(q, k, k, bq=16, bk=16)
    assert klaunches == before

    entry = _EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda lib: types.SimpleNamespace(flash_fwd_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for dtype, hd, body in ((BF16, 72, "mma"), (BF16, 100, "cores"), (FP32, 64, "cores")):
        x = torch.zeros((1, 2, 64, hd), dtype=dtype)
        fk.flash_attention_fwd(x, x[:, :1], x[:, :1], bq=16, bk=16)
        assert entry.calls[-1][:2] == (int(dtype == BF16), fk.BODIES.index(body))
    assert klaunches["flash_fwd"] == before["flash_fwd"] + 3


# ---------------------------------------------------------------------------
# the precision model of P V on the tensor cores

def _tensor_core_model(q, k, v, valid, two_parts, chunk=16):
    """The tensor-core tiles' arithmetic in torch: fp32 scores (exact bf16
    products), an online softmax over chunks of 16 keys with fp32 weights
    and sums, and P V with each chunk's weights as bf16 once (two_parts
    False) or as bf16 hi + lo (True); fp32 sums of exact products."""
    G = q.shape[1] // k.shape[1]
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * q.shape[-1] ** -0.5
    s = torch.where(valid, s, torch.full_like(s, K.NEG_INF))
    m = torch.full(s.shape[:-1], K.NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, S, chunk):
        sc = s[..., k0:k0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        w = p.to(BF16).float()
        if two_parts:
            w = w + (p - w).to(BF16).float()
        acc = acc * corr[..., None] + w @ vf[:, :, k0:k0 + chunk]
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def _bf16_inputs(seed, B, H, Hkv, S, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16).float()
            for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


@needs_jax
@pytest.mark.parametrize("oracle", ["ragged_attention_ref", "attention_ref"])
def test_two_part_weights_hold_atol_where_one_part_misses(oracle):
    B, H, Hkv, S, hd = 2, 4, 2, 64, 64
    q, k, v = _bf16_inputs(11, B, H, Hkv, S, hd)
    pos = torch.arange(S)
    valid = pos[None, :] <= pos[:, None]
    if oracle == "ragged_attention_ref":
        lengths = np.array([S, 37])
        ln = torch.from_numpy(lengths)[:, None, None, None]
        valid = valid & (pos[None, :] < ln) & (pos[:, None] < ln)
        want = np.asarray(ragged_attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                               lengths))
        live = (pos[None, None, :, None] < ln).float()
    else:
        want = np.asarray(attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                        causal=True))
        live = torch.ones(())
    errs = {}
    for two in (False, True):
        got = _tensor_core_model(q, k, v, valid, two) * live
        errs[two] = (got - torch.from_numpy(np.array(want))).abs()
    assert float(errs[True].max()) <= ATOL, float(errs[True].max())
    # a row that sees a handful of keys carries its weights' rounding whole
    assert float(errs[False][:, :, 1:8].max()) > ATOL, float(errs[False][:, :, 1:8].max())


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# fp32 inputs: the same fp32 arithmetic summed in another order; bf16 inputs
# on the tensor cores: weights split in two bf16 parts (2^-18 of each) and
# mma's fp32 sums, within chip_smoke.py's ATOL
CARD_ATOL = {FP32: 1e-5, BF16: ATOL}
WS_CASES = [  # B, H, Hkv, S, hd, bq, bk, causal, dtype, layout, body
    (4, 6, 2, 200, 128, 1, 64, False, BF16, "cache", "decode"),
    (3, 8, 2, 150, 112, 1, 32, False, BF16, "cache", "decode"),
    (3, 4, 4, 77, 64, 1, 16, False, FP32, "cache", "decode"),
    (2, 4, 2, 300, 256, 1, 64, False, BF16, "dense", "decode"),
    (2, 4, 2, 100, 256, 1, 32, False, FP32, "dense", "decode"),
    (2, 4, 2, 90, 128, 1, 16, True, BF16, "dense", "decode"),
    (2, 4, 2, 64, 120, 1, 16, False, BF16, "offset", "generic"),
    (2, 4, 2, 100, 128, 16, 64, True, BF16, "dense", "mma"),
    (2, 4, 2, 90, 128, 32, 32, True, BF16, "dense", "mma"),
    (2, 4, 2, 130, 64, 64, 16, True, BF16, "dense", "mma"),
    (2, 6, 2, 77, 112, 32, 16, False, BF16, "dense", "mma"),
    (1, 2, 1, 70, 64, 64, 64, False, BF16, "dense", "mma"),
    (2, 4, 2, 100, 128, 16, 64, True, FP32, "dense", "generic"),
    (2, 4, 2, 60, 256, 16, 32, True, BF16, "dense", "generic"),
    (2, 2, 1, 50, 64, 32, 16, False, FP32, "dense", "generic"),
    (1, 2, 1, 40, 112, 64, 64, True, FP32, "dense", "generic"),
]


def _ws_inputs(case, seed=0):
    B, H, Hkv, S, hd, bq, bk, causal, dtype, layout, _ = case
    rng = np.random.default_rng(seed + S + hd + bq)
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0] = S
    Sq = 1 if bq == 1 else S
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, hd)).astype(np.float32)).to(dtype)

    def kv():
        if layout == "cache":
            t = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
            return torch.from_numpy(t).to(dtype).permute(0, 2, 1, 3)
        t = rng.standard_normal((B, Hkv, S, hd + (layout == "offset"))).astype(np.float32)
        t = torch.from_numpy(t).to(dtype)
        return t[..., 1:] if layout == "offset" else t

    tasks = (emit_decode_tasks(lengths, H, bk) if bq == 1
             else emit_flash_tasks(lengths, H, bq, bk, causal=causal))
    return q, kv(), kv(), tasks, dict(causal=causal, bq=bq, bk=bk)


def _on(t, dev):
    """``t`` on ``dev`` with its strides (a cache view stays a view)."""
    base = t
    while base._base is not None:
        base = base._base
    return torch.as_strided(base.to(dev), t.shape, t.stride(), t.storage_offset())


@pytest.mark.cuda
@pytest.mark.parametrize("case", WS_CASES, ids=lambda c: f"{c[-1]}-bq{c[5]}-hd{c[4]}-{c[8]}")
def test_ws_attention_body_matches_plain_on_card(cuda_device, case):
    q, k, v, tasks, kw = _ws_inputs(case)
    qd, kd, vd = (_on(t, cuda_device) for t in (q, k, v))
    assert kd.stride() == k.stride()
    assert K.attention_branch(qd, kd, vd, kw["bq"]) == case[-1]
    state = make_queue_state(tasks, 4)
    tol = CARD_ATOL[case[8]]
    for steal, policy in ((True, "cost"), (False, "cost")):
        lk = dict(kw, steal=steal, steal_policy=policy, mode="lockstep")
        got = run_ws_schedule(to_device(state, cuda_device), qd, kd, vd, **lk)
        want = run_ws_schedule(state, q, k, v, **lk)
        for f in ("head", "local_head", "taken", "remaining", "clock", "work", "steals",
                  "scanned", "mult"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        torch.testing.assert_close(got.out.cpu(), want.out, rtol=0, atol=tol)
    expect = normalized_out(want, tasks, tuple(want.out.shape[:3]))
    free = run_ws_schedule(to_device(state, cuda_device), qd, kd, vd, mode="free", **kw)
    assert bool((free.mult[: state.n_tasks] >= 1).all())
    torch.testing.assert_close(free.out.cpu(), expect, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["decode", "mma", "generic"])
def test_ws_attention_free_launches_store_the_same_bits_on_card(cuda_device, body):
    """A tile's bits do not depend on which CTA ran it or when: two free
    launches of one state store bit-equal outputs."""
    case = next(c for c in WS_CASES if c[-1] == body)
    q, k, v, tasks, kw = _ws_inputs(case, seed=1)
    qd, kd, vd = (_on(t, cuda_device) for t in (q, k, v))
    state = make_queue_state(tasks, 8)
    outs = [run_ws_schedule(to_device(state, cuda_device), qd, kd, vd, mode="free", **kw).out
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


FLASH_CASES = [  # B, H, Hkv, S, hd, causal, window
    (1, 4, 2, 200, 64, True, 0), (1, 4, 2, 136, 112, True, 50), (2, 2, 1, 192, 128, False, 0),
    (1, 4, 2, 200, 256, True, 64), (1, 2, 2, 104, 128, True, 0), (1, 2, 1, 72, 256, False, 40),
    # head dims of 16 k + 8: the last k-step's columns half zero-filled
    (1, 4, 2, 152, 72, True, 40), (1, 2, 1, 96, 120, False, 0),
]


def _ulp_limit(want):
    """2 bf16 ulps of each element + 1e-4 x max|want| (chip_smoke.py's KULPS)."""
    _, e = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want), torch.exp2((e - 8).float()))
    return 2 * ulp + 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fwd_body_matches_plain_on_card(cuda_device, case, dtype):
    B, H, Hkv, S, hd, causal, window = case
    g = torch.Generator().manual_seed(S + hd)
    q, k, v = (torch.randn(s, generator=g).to(dtype)
               for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    kw = dict(causal=causal, window=window, bq=8, bk=8)
    want, want_lse = FK.flash_attention_fwd(q, k, v, **kw)
    before = klaunches["flash_fwd"]
    got, lse = FK.flash_attention_fwd(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    assert klaunches["flash_fwd"] == before + 1
    got, lse = got.cpu().float(), lse.cpu()
    if dtype == BF16:
        assert bool(((got - want.float()).abs() <= _ulp_limit(want.float())).all())
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
