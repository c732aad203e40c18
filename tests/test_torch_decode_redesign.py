"""The redesigned ``decode_attention``: split-KV flash-decoding (splits of
the visible keys, one CTA per split and kv head, a merge pass).

On the CPU: the plain version, which splits, drops dead splits and merges
as the kernel does, against the JAX package's dense oracle and its Pallas
kernel in interpret mode (fp32 within 1e-5, bf16 within 2e-2, as
``tests/test_torch_kernels.py``), for every split size and at the edges of
a split (pos on its first or last key, pos 0, past S or before 0, a window
edge inside a split, a window across a split boundary); the host's split
choice (never from ``pos``, covering every visible key, enough CTAs for an
H100 at gemma3-12b's cache); shared memory; and the C arguments the
wrapper passes.  The ``cuda`` cases at the bottom hold the kernel to the
plain version on the card (fp32 within 1e-5, bf16 within 2 bf16 ulps +
1e-4 x max|plain|) and check that the wrapper never syncs with the host;
they need no JAX.
"""

import inspect
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import launches
from repro_torch.kernels._launch import SMEM_LIMIT
from repro_torch.kernels.decode_attention import kernel as DK

try:
    import jax.numpy as jnp

    from repro.kernels.decode_attention.kernel import decode_attention as j_decode_kernel
    from repro.kernels.decode_attention.ref import decode_attention_ref as j_decode_ref

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_torch_kernels.py's _tol


def _inputs(seed, B, H, Hkv, S, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _reference(arrays, dtype, pos, window, bk, dense=True):
    """The JAX package's Pallas kernel in interpret mode and (``dense``) its
    dense oracle, on the same values in ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    out = [j_decode_kernel(jq, jk, jv, jnp.int32(pos), window=window, bk=bk, interpret=True)]
    if dense:
        out.append(j_decode_ref(jq, jk, jv, jnp.int32(pos), window=window))
    return out


def _plain(arrays, dtype, pos, **kw):
    q, k, v = (torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays)
    return DK.plain_decode_attention(q, k, v, torch.tensor(pos, dtype=torch.int32), **kw)


# ---------------------------------------------------------------------------
# the plain split/merge version against the reference


DECODE_CASES = [  # B, H, Hkv, S, hd, bk, pos, window (tests/test_kernels.py)
    (1, 2, 1, 32, 8, 8, 31, 0),
    (2, 4, 2, 64, 16, 16, 30, 0),
    (2, 4, 2, 64, 16, 16, 63, 16),
    (1, 8, 8, 128, 32, 32, 5, 0),
]
# split sizes: the host's choice, one that divides S, one that does not,
# one split covering all of S
SPLITS = {"host": lambda S: None, "divides": lambda S: S // 4, "ragged": lambda S: S // 4 + 3,
          "whole": lambda S: S}


@needs_jax
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_split_matches_reference(case, split, dtype):
    B, H, Hkv, S, hd, bk, pos, window = case
    arrays = _inputs(S + pos, B, H, Hkv, S, hd)
    got = _plain(arrays, dtype, pos, window=window, bk=bk, split=SPLITS[split](S))
    assert got.shape == (B, H, hd) and got.dtype == DTYPES[dtype]
    for want in _reference(arrays, dtype, pos, window, bk):
        _close(got, want, dtype)


# (what it tests, pos, window, split) on B 2, H 6 over Hkv 2, S 64, hd 16, bk 16
EDGES = [
    ("pos on the first key of a split", 32, 0, 16),
    ("pos on the last key of a split", 47, 0, 16),
    ("pos 0", 0, 0, 16),
    ("pos past S", 100, 0, 16),
    ("window edge inside a split", 50, 10, 4),
    ("window across a split boundary", 50, 24, 16),
    ("window longer than pos", 40, 100, 16),
    ("window past S", 70, 12, 16),
]


@needs_jax
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("edge", EDGES, ids=lambda e: e[0].replace(" ", "-"))
def test_plain_split_edges_match_reference(edge, dtype):
    _, pos, window, split = edge
    B, H, Hkv, S, hd, bk = 2, 6, 2, 64, 16, 16
    arrays = _inputs(pos + window, B, H, Hkv, S, hd)
    got = _plain(arrays, dtype, pos, window=window, bk=bk, split=split)
    for want in _reference(arrays, dtype, pos, window, bk):
        _close(got, want, dtype)


@needs_jax
@pytest.mark.parametrize("pos, window", [(-1, 0), (-3, 8), (80, 8)],
                         ids=["pos-1", "pos-3-window", "window-wholly-past-S"])
def test_plain_with_no_visible_key_is_zero_as_the_reference(pos, window):
    """Every split dead: the merge writes 0, as the reference when it skips
    every block (its dense oracle has nothing to normalise over)."""
    arrays = _inputs(7, 1, 4, 2, 64, 16)
    got = _plain(arrays, "float32", pos, window=window, bk=16, split=16)
    assert not got.abs().any()
    _close(got, _reference(arrays, "float32", pos, window, 16, dense=False)[0], "float32")


@pytest.mark.parametrize("window, split", [(0, 5), (0, 16), (9, 3), (20, 7)])
def test_plain_split_holds_for_every_pos(window, split):
    """Every pos from before 0 to past S (the device's cut of the visible
    keys moves with it): the plain version against a dense softmax over the
    visible keys, 0 where none is."""
    g = torch.Generator().manual_seed(window + split)
    q = torch.randn((1, 3, 8), generator=g, dtype=torch.float64).float()
    k, v = (torch.randn((1, 1, 40, 8), generator=g, dtype=torch.float64).float()
            for _ in range(2))
    s = torch.einsum("bhd,bsd->bhs", q.double(), k[:, 0].double()) * 8 ** -0.5
    kpos = torch.arange(40)
    for pos in range(-2, 44):
        vis = (kpos <= pos) & ((pos - kpos < window) if window > 0 else True)
        got = DK.plain_decode_attention(q, k, v, torch.tensor(pos), window=window, bk=8,
                                        split=split)
        if not vis.any():
            assert not got.abs().any()
            continue
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), -1)
        want = torch.einsum("bhs,bsd->bhd", p, v[:, 0].double()).float()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_plain_merge_drops_a_dead_split_not_its_garbage():
    """A split whose every key is masked would carry exp(NEG_INF - NEG_INF)
    = 1 weights were they not zeroed: with huge values planted in the
    invisible keys the output stays the visible keys' softmax."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 2, 16), generator=g)
    k, v = (torch.randn((1, 1, 64, 16), generator=g) for _ in range(2))
    k[:, :, 41:], v[:, :, 41:] = 1e4, 1e6
    got = DK.plain_decode_attention(q, k, v, 40, bk=16, split=8)
    s = torch.einsum("bhd,bsd->bhs", q, k[:, 0, :41]) * 16 ** -0.5
    want = torch.einsum("bhs,bsd->bhd", torch.softmax(s, -1), v[:, 0, :41])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the host's split choice


def test_split_choice_never_reads_pos():
    """The grid comes from the shapes and the SM count alone."""
    assert list(inspect.signature(DK._split).parameters) == ["S", "bk", "window", "B", "Hkv",
                                                             "n_sm"]


@pytest.mark.parametrize("S, bk, window, B, Hkv, n_sm", [
    (8192, 512, 0, 4, 8, 132), (8192, 512, 1024, 4, 8, 132), (1024, 512, 0, 4, 8, 132),
    (64, 16, 16, 2, 2, 132), (32, 8, 0, 1, 1, 132), (300, 100, 0, 1, 1, 8),
    (4096, 4096, 5000, 1, 1, 132), (512, 64, 100, 1, 2, 132),
])
def test_split_choice_covers_every_visible_key(S, bk, window, B, Hkv, n_sm):
    """n_split splits of at most ``chunk`` (<= bk) keys cover the span
    (with no window, [0, S)), none wholly past it; for every pos (past S
    and before 0 included) the device's cut of the visible keys
    (``device_cut``: n_split splits of ceil(visible / n_split) keys from
    ``base``) holds every visible key once, in order, and no split longer
    than ``chunk``."""
    chunk, n = DK._split(S, bk, window, B, Hkv, n_sm)
    span = min(window, S) if window > 0 else S
    assert 0 < chunk <= bk and (n - 1) * chunk < span <= n * chunk
    if window == 0:
        assert n * chunk >= S
    kpos = np.arange(S)
    for pos in range(-2, S + 3):
        vis = kpos[(kpos <= pos) & ((pos - kpos < window) if window > 0 else True)]
        c = -(-len(vis) // n)
        assert c <= chunk
        if len(vis):
            base = max(0, pos - window + 1) if window > 0 else 0
            assert vis[0] == base and vis[-1] < base + n * c
        first, c_dev, last = DK.device_cut(pos, S, window, n)
        assert int(c_dev) == c and first.shape == (n,)
        held = [k for f in first.tolist() if f <= int(last)
                for k in range(f, min(f + c, int(last) + 1))]
        assert held == vis.tolist()


def test_split_choice_fills_an_h100_at_gemma_cache():
    """gemma3-12b's decode cache (B 4, 8 kv heads, S 8192): at least two
    CTAs an SM of the H100's 132 at its global layers; at its local layers
    (window 1024, splits of 128 keys) at least one an SM."""
    _, n = DK._split(8192, 512, 0, 4, 8, 132)
    assert 4 * 8 * n >= 2 * 132
    chunk, n = DK._split(8192, 512, 1024, 4, 8, 132)
    assert chunk == 128 and 4 * 8 * n >= 132


# ---------------------------------------------------------------------------
# shared memory and the C arguments


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smem_fits_every_head_dim_and_group(dtype):
    for hd in range(1, DK.MAX_HEAD_DIM + 1):
        for G in (1, 2, 3, 8, 64):
            assert DK.smem_bytes(hd, dtype, G) <= SMEM_LIMIT
    # gemma3-12b bf16, hd 256: 2 stages of 16 K and 16 V rows of 512 B
    # (five CTAs an SM fit); fp32: 2 stages of 16 K and 16 V rows of 1 KB;
    # hd 8 bf16: one lane a key, 512 rows a stage
    assert DK.smem_bytes(256, torch.bfloat16, 2) == 2 * 2 * 16 * 512
    assert 5 * DK.smem_bytes(256, torch.bfloat16, 2) <= SMEM_LIMIT
    assert DK.smem_bytes(256, torch.float32, 2) == 2 * 2 * 16 * 1024
    assert DK.smem_bytes(8, torch.bfloat16, 1) == 2 * 2 * 512 * 16


def test_wrapper_passes_its_split_and_scratch(monkeypatch):
    """The CUDA branch, driven on CPU tensors against a stand-in for the C
    entry point: the grid is the host's split choice whatever pos is, the
    scratch is [B, H, n_split, hd + 2] fp32, and one launch is counted."""
    from repro_torch import _build

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    entry.argtypes = None
    monkeypatch.setattr(_build, "load",
                        lambda lib: types.SimpleNamespace(decode_attention_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(DK, "runs_plain", lambda *t: False)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 6, 16), generator=g)
    k, v = (torch.randn((2, 2, 256, 16), generator=g) for _ in range(2))
    launch_cuda, parts = DK._launch_cuda, []

    def recording(q, k, v, pos, out, part, **kw):
        parts.append((part.shape, part.dtype))
        return launch_cuda(q, k, v, pos, out, part, **kw)

    monkeypatch.setattr(DK, "_launch_cuda", recording)
    before = launches["decode_attention"]
    for pos in (0, 100, 255, -4, 9999):
        DK.decode_attention(q, k, v, torch.tensor(pos), window=40, bk=64)
    assert launches["decode_attention"] == before + 5
    _, n = DK._split(256, 64, 40, 2, 2, DK.H100_SMS)
    for args in calls:
        assert len(args) == 16 == len(entry.argtypes)
        assert args[0] == 0 and args[7:14] == (2, 6, 2, 256, 16, 40, n)
        assert args[14] == pytest.approx(16 ** -0.5)
    assert parts == [((2, 6, n, 18), torch.float32)] * 5


# ---------------------------------------------------------------------------
# on the card (no JAX)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(seed, B, H, Hkv, S, hd, dtype, dev, offset=0):
    """q, k, v on the card; ``offset`` > 0 puts k and v that many elements
    into their storage (a cache not aligned to 16 bytes)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g).to(dtype).to(dev)
    kv = []
    for _ in range(2):
        t = torch.randn((B, Hkv, S, hd), generator=g).to(dtype)
        buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
        kv.append(buf[offset:].view(t.shape).copy_(t))
    return q, *kv


# fp32 within 1e-5; bf16 (the same fp32 sums rounded once) within
# chip_smoke.py's limit: 2 bf16 ulps of the plain value + 1e-4 x max|plain|
CARD_ULPS, CARD_FLOOR, CARD_TOL32 = 2, 1e-4, 1e-5
CARD_CASES = [  # B, H, Hkv, S, hd, bk, pos, window: G 1, 2, 3 at hd 8..256
    (2, 2, 2, 512, 8, 64, 300, 0),
    (2, 4, 2, 512, 16, 64, 511, 0),
    (1, 6, 2, 512, 32, 64, 200, 100),
    (2, 6, 2, 1024, 128, 128, 1000, 0),
    (1, 4, 2, 1024, 256, 128, 777, 300),
    (1, 2, 2, 512, 256, 64, 511, 0),
    (2, 3, 1, 512, 128, 64, 450, 0),
    (2, 20, 2, 256, 64, 64, 130, 0),     # G 10: two groups of query heads a kv head
    (1, 4, 1, 256, 12, 64, 100, 0),      # bf16 rows of 24 B: the scalar path
    (1, 4, 1, 256, 6, 64, 100, 30),      # rows of 12 / 24 B: the scalar path
]
# (what it tests, pos, window) at B 2, H 4 over 2, S 512, hd 128, bk 64 (splits of 64)
CARD_EDGES = [
    ("pos on the first key of a split", 128, 0), ("pos on the last key of a split", 191, 0),
    ("pos 0", 0, 0), ("pos past S", 600, 0), ("pos before 0", -1, 0),
    ("window edge inside a split", 300, 37), ("window across a split boundary", 300, 100),
    ("window past S", 520, 16), ("window longer than S", 400, 1000),
]


def _card_check(dev, case, dtype, offset=0):
    B, H, Hkv, S, hd, bk, pos, window = case
    q, k, v = _card_inputs(S + hd + pos, B, H, Hkv, S, hd, dtype, dev, offset)
    p = torch.tensor(pos, dtype=torch.int64, device=dev)
    want = DK.plain_decode_attention(q, k, v, p, window=window, bk=bk)
    before = launches["decode_attention"]
    got = DK.decode_attention(q, k, v, p, window=window, bk=bk)
    again = DK.decode_attention(q, k, v, p, window=window, bk=bk)
    torch.cuda.synchronize()
    assert launches["decode_attention"] == before + 2
    assert got.dtype == dtype and got.shape == (B, H, hd)
    assert torch.equal(got, again)  # a fixed merge order: the same bits every launch
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=CARD_TOL32, atol=CARD_TOL32)
        return
    _, e = torch.frexp(want)                     # |want| in [2^(e-1), 2^e): ulp 2^(e-8)
    ulp = torch.where(want == 0, torch.zeros_like(want), torch.exp2((e - 8).float()))
    err = (got - want).abs()
    limit = CARD_ULPS * ulp + CARD_FLOOR * float(want.abs().max())
    assert bool((err <= limit).all()), (f"max |err| {float(err.max()):.3g}, "
                                        f"max |err| / limit {float((err / limit).max()):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    _card_check(cuda_device, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", CARD_EDGES, ids=lambda e: e[0].replace(" ", "-"))
def test_kernel_edges_match_plain_on_card(cuda_device, edge, dtype):
    _, pos, window = edge
    _card_check(cuda_device, (2, 4, 2, 512, 128, 64, pos, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_an_unaligned_cache_on_card(cuda_device, dtype):
    """k and v one element into their storage: no 16-byte rows, the scalar
    path."""
    _card_check(cuda_device, (2, 4, 2, 512, 128, 64, 333, 0), dtype, offset=1)


@pytest.mark.cuda
def test_wrapper_never_syncs_with_the_host_on_card(cuda_device):
    """pos stays on the card: the call raises under sync debug mode if
    anything reads it (or anything else) back to the host."""
    q, k, v = _card_inputs(1, 4, 16, 8, 1024, 256, torch.bfloat16, cuda_device)
    pos = torch.tensor([900], dtype=torch.int32, device=cuda_device)
    DK.decode_attention(q, k, v, pos, window=256)  # build and load outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = DK.decode_attention(q, k, v, pos, window=256)
        out2 = DK.decode_attention(q, k, v, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(out2).all()
