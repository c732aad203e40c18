"""The redesigned unified step kernel (``csrc/ws_unified.cu``): in lockstep
a walker CTA runs the scheduler walk and hands every weight product to H
helper CTAs through tagged 64-bit words (value and request tag), each
helper computing its own column strips of 32 in a fixed order.

On the CPU: a torch model of the strip partition (every column one owner at
H = 0, 1, 7 and 131; the sum order of ``unified_kernel.strip_layout``, so
Y is bit-equal at every H) held to the JAX package's product; the tag rule
(a stale tag waits, a newer one faults) and the request word (the test's model of both); the tags'
advance and wrap; the host's choice of H and its refusals (a grid that
cannot be resident, helpers asked of free mode), before any launch; the
marshalled launch through a fake library; the hand-off's sizes and the
requests a step makes.  The ``cuda`` cases at the bottom hold the kernel to
its plain version on the card at llama and kimi smoke in fp32 (decode and
a fold), the logits bit-equal across H = 0, 1 and the largest H, the
vocabulary padding -1e30 at a vocabulary that is not a multiple of 256
(each padding word one writer), two free launches bit-equal, a spin past
its deadline raising in Python, and the walker's scheduler walk
(``owned_lockstep``) against the shared per-slot walk (``ws_lockstep``'s
loop) on the same queues, every array and ring (``csrc/probes/
lockstep_twins.cu``); they need no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_unified_redesign.py        # the CPU
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_unified_redesign.py  # the card
"""

import ctypes
import os
import struct
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as KIMI
from repro_torch.configs.llama3_2_3b import SMOKE as LLAMA
from repro_torch.models import Caches, KVCache, init_params
from repro_torch.models.unified import (
    decode_step_unified,
    plain_decode_step_unified,
    plan_step,
    run_step,
)
from repro_torch.pallas_ws import unified_kernel as U

try:
    import jax.numpy as jnp

    HAVE_JAX = True
except ImportError:  # without JAX only the cuda cases and the host's rules run
    HAVE_JAX = False

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="the reference needs JAX")

UNIFIED_RTOL = 1e-4   # chip_smoke.py's bound on logits against the plain version
INTS = ("head", "local_head", "taken", "remaining", "clock", "work", "steals", "scanned",
        "mult")
CAP = 32


# ---------------------------------------------------------------------------
# the test's model of the kernel (csrc/ws_unified.cu): the strips' layout and
# owners, the tagged word and the request word

NG = U.UTHREADS // (U.SW // 4)   # a CTA's thread groups: row blocks x k-slices
PASS_ROWS = NG * 8               # rows of one pass over a strip


def strip_layout(R):
    """How a CTA sums a strip of an R-row product (csrc/ws_unified.cu
    ``strips``): passes of at most PASS_ROWS rows, and for each its row
    blocks of 8 and the KS k-slices a (row block, column quad) is split
    into (the largest power of two with KS x blocks <= 64).  A thread sums
    every KS-th k of its slice in ascending order; the KS partial sums are
    added in ascending slice order.  It depends on R alone."""
    out = []
    for r0 in range(0, R, PASS_ROWS):
        nrb = -(-min(R - r0, PASS_ROWS) // 8)
        ks = 1
        while 2 * ks * nrb <= NG:
            ks *= 2
        out.append((r0, nrb, ks))
    return out


def strip_owners(n_cols, helpers):
    """The CTA that computes each column of an N-column product: strip s
    (columns [32 s, 32 s + 32)) belongs to helper 1 + s % H, or to the
    walker (CTA 0) when H = 0."""
    strips = torch.arange(n_cols) // U.SW
    return strips % helpers + 1 if helpers else torch.zeros_like(strips)


def tagged_word(value, tag):
    """A tagged 64-bit word as the kernel packs it: the fp32 bits of
    ``value`` low, ``tag`` high."""
    return (tag << 32) | struct.unpack("<I", struct.pack("<f", value))[0]


def read_word(word, want):
    """The kernel's rule for a tagged word read under tag ``want``: its
    value when the tag matches; None (spin on) when the tag is older; a
    newer tag is a fault (RuntimeError: the kernel traps)."""
    tag = word >> 32
    if tag > want:
        raise RuntimeError(f"tag {tag} newer than the expected {want}: the launch traps")
    if tag < want:
        return None
    return struct.unpack("<f", struct.pack("<I", word & 0xFFFFFFFF))[0]


REQUEST_KINDS = ("qkv", "wo", "gateup", "down", "router", "logits", "exp_gu", "exp_d")


def request_word(tag, kind, rows, layer, expert):
    """A request as the walker posts it (kind 4 bits, rows 11, layer 8,
    expert 9, under the tag); ValueError past a field's width."""
    if not (0 <= rows <= U.MAX_ROWS and 0 <= layer < U.MAX_LAYERS
            and 0 <= expert < U.MAX_EXPERTS):
        raise ValueError(f"request fields out of range: rows {rows}, layer {layer}, "
                         f"expert {expert}")
    return (tag << 32) | REQUEST_KINDS.index(kind) | rows << 4 | layer << 15 | expert << 23


# ---------------------------------------------------------------------------
# the strip partition and its sum order


@pytest.mark.parametrize("H", [0, 1, 7, 131])
def test_every_column_has_one_owner(H):
    """Each column of a product belongs to exactly one CTA, whole strips of
    32 at a time, and with H helpers every helper gets every H-th strip."""
    for N in (32, 80, 3072 + 2 * 1024, 128256):
        owner = strip_owners(N, H)
        assert owner.shape == (N,)
        if H == 0:
            assert bool((owner == 0).all())
            continue
        assert int(owner.min()) >= 1 and int(owner.max()) <= H
        strips = torch.arange(N) // U.SW
        for s in torch.unique(strips)[:200]:
            assert torch.unique(owner[strips == s]).numel() == 1
        n_strips = -(-N // U.SW)
        counts = torch.bincount(owner - 1, minlength=H)[:min(H, n_strips)]
        assert int(counts.sum()) == N


def _model_strip(x, w, cols):
    """One strip's Y in the kernel's sum order (csrc/ws_unified.cu
    ``strips``): per row pass, every KS-th k of a slice in ascending order,
    then the KS slice sums in ascending slice order (fp32 throughout)."""
    R, K = x.shape
    y = torch.empty((R, len(cols)), dtype=torch.float32)
    for r0, nrb, ks in strip_layout(R):
        rows = slice(r0, min(R, r0 + PASS_ROWS))
        total = torch.zeros((rows.stop - r0, len(cols)), dtype=torch.float32)
        for t in range(ks):
            part = torch.zeros_like(total)
            for k in range(t, K, ks):
                part = part + x[rows, k:k + 1] * w[k:k + 1, cols]
            total = total + part
        y[rows] = total
    return y


def _model_product(x, w, H):
    """Y = x w computed strip by strip, each CTA's strips in its own order,
    as the kernel spreads them over the walker (H = 0) or H helpers."""
    N = w.shape[1]
    owner = strip_owners(N, H)
    y = torch.full((x.shape[0], N), float("nan"))
    for cta in (range(1, H + 1) if H else [0]):
        for s in range(-(-N // U.SW)):
            cols = torch.arange(s * U.SW, min(N, (s + 1) * U.SW))
            if int(owner[cols[0]]) == cta:
                y[:, cols] = _model_strip(x, w, cols)
    return y


@pytest.mark.parametrize("R", [4, 5, 13])
def test_strip_sums_are_bit_equal_at_every_helper_count(R):
    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.standard_normal((R, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 100)).astype(np.float32))
    ys = [_model_product(x, w, H) for H in (0, 1, 7, 131)]
    assert not bool(torch.isnan(ys[0]).any())
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


@needs_jax
@pytest.mark.parametrize("R", [4, 104])
def test_strip_model_matches_reference_product(R):
    """The model's sum order against the JAX package's product of the same
    numpy inputs, within the fp32 rounding of a 256-term dot product."""
    rng = np.random.default_rng(100 + R)
    xn = rng.standard_normal((R, 256)).astype(np.float32)
    wn = (rng.standard_normal((256, 64)) / 16).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(xn), jnp.asarray(wn)))
    got = _model_product(torch.from_numpy(xn), torch.from_numpy(wn), 7).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_strip_layout_depends_on_rows_alone():
    assert strip_layout(4) == [(0, 1, 64)]
    assert strip_layout(8) == [(0, 1, 64)]
    assert strip_layout(9) == [(0, 2, 32)]
    assert strip_layout(104) == [(0, 13, 4)]   # llama's 100-token fold
    assert strip_layout(600) == [(0, 64, 1), (512, 11, 4)]
    for R in range(1, 700, 7):
        for _, nrb, ks in strip_layout(R):
            assert nrb * ks <= NG < 2 * nrb * ks or ks == 1


# ---------------------------------------------------------------------------
# tagged words and requests


def test_tag_rule_detects_stale_and_newer_words():
    for v in (0.0, -1.5, 3.25e-20, 1e30):
        w = tagged_word(v, 41)
        assert read_word(w, 41) == np.float32(v)
        assert read_word(w, 42) is None                # stale: spin on
        with pytest.raises(RuntimeError, match="newer"):
            read_word(w, 40)                           # newer: the launch traps
    assert read_word(0, 1) is None                     # a fresh workspace word
    assert tagged_word(2.0, 7) >> 32 == 7


def test_request_word_fields_and_limits():
    w = request_word(9, "exp_d", 8, 60, 383)
    assert w >> 32 == 9
    p = w & 0xFFFFFFFF
    assert (p & 15, (p >> 4) & 2047, (p >> 15) & 255, p >> 23) == (7, 8, 60, 383)
    assert request_word(1, "logits", U.MAX_ROWS, 0, 0) & 15 == 5
    for bad in (dict(rows=U.MAX_ROWS + 1), dict(layer=U.MAX_LAYERS),
                dict(expert=U.MAX_EXPERTS), dict(rows=-1)):
        kw = {"rows": 4, "layer": 0, "expert": 0, **bad}
        with pytest.raises(ValueError):
            request_word(1, "qkv", **kw)


def test_tags_advance_by_span_and_wrap():
    dev = torch.device("cpu")
    U._HANDS.pop(dev, None)
    sizes = {"x": 6, "y": 5, "done": 2}
    h, b0 = U._hand(dev, sizes, 100)
    _, b1 = U._hand(dev, sizes, 100)
    assert (b0, b1) == (1, 101) and h["ws"].numel() == 1 + 12 + 5 + 2 + len(U.STATS)
    h["ws"].fill_(7)
    h["next"] = (1 << 32) - 50
    _, b2 = U._hand(dev, sizes, 100)       # would wrap: every word back to tag 0
    assert b2 == 1 and int(h["ws"].abs().sum()) == 0
    _, b3 = U._hand(dev, {"x": 60, "y": 5, "done": 2}, 10)   # grown: tags restart
    assert b3 == 1 and U._HANDS[dev]["ws"].numel() == 1 + 120 + 5 + 2 + len(U.STATS)
    assert U.fault_word(dev) == [0, 0, 0, 0]
    U._HANDS.pop(dev)


# ---------------------------------------------------------------------------
# the host's choice of H, and its refusals before any launch


def test_choose_helpers():
    assert U.choose_helpers("lockstep", None, 132) == 131
    assert U.choose_helpers("lockstep", 0, 132) == 0
    assert U.choose_helpers("lockstep", 1, 132) == 1
    assert U.choose_helpers("lockstep", 131, 132) == 131
    for bad in (132, 500, -1):
        with pytest.raises(ValueError, match="resident"):
            U.choose_helpers("lockstep", bad, 132)
    assert U.choose_helpers("free", None, 132) == 0
    assert U.choose_helpers("free", 0, 132) == 0
    with pytest.raises(ValueError, match="lockstep"):
        U.choose_helpers("free", 4, 132)


def _smoke(cfg, dev, seed=0):
    cfg = cfg.replace(dtype="float32", **({"moe_dispatch": "ws"} if cfg.is_moe else {}))
    params = init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.n_layers, 2, CAP, cfg.n_kv_heads, cfg.hd)
    kv = (torch.randn(shape, generator=gen, device=dev),
          torch.randn(shape, generator=gen, device=dev))
    tok = torch.tensor([[3], [4]], device=dev)
    pos = np.array([CAP - 1, 9], np.int32)
    ptok = torch.arange(11, 31, device=dev).reshape(1, 20)
    return cfg, params, kv, tok, pos, ptok


def _caches(kv):
    return Caches(kv=KVCache(kv[0].clone(), kv[1].clone()))


def test_free_mode_refuses_helpers_before_any_launch():
    cfg, params, kv, tok, pos, _ = _smoke(LLAMA, torch.device("cpu"))
    with pytest.raises(ValueError, match="lockstep"):
        decode_step_unified(params, cfg, _caches(kv), tok, pos, mode="free", helpers=3)


class _EntryPoint:
    argtypes = None
    restype = ctypes.c_int
    status = 0

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        for t, a in zip(self.argtypes, args):
            t.from_param(a)
        self.calls.append(args)
        return self.status


@pytest.fixture
def fake_card(monkeypatch):
    """A fake ws_unified library on a card of 8 SMs (the tensors stay on
    the CPU)."""
    from repro_torch import _build

    entry = _EntryPoint()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(ws_unified_launch=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(U, "_sm_count", lambda dev: 8)
    U._HANDS.pop(torch.device("cpu"), None)
    yield entry
    U._HANDS.pop(torch.device("cpu"), None)


def _hdims(args):
    return list(ctypes.cast(args[18], ctypes.POINTER(ctypes.c_longlong * 7)).contents)


@pytest.mark.parametrize("fold", [False, True])
def test_launch_marshals_the_hand_off(fake_card, fold):
    cfg, params, kv, tok, pos, ptok = _smoke(LLAMA, torch.device("cpu"))
    plan = plan_step(params, cfg, _caches(kv), tok, pos,
                     prefill_tokens=ptok if fold else None)
    run = dict(steal=True, steal_policy="cost", n_programs=8, plain=False)
    run_step(params, cfg, plan, mode="lockstep", **run)
    run_step(params, cfg, plan, mode="lockstep", helpers=3, **run)
    run_step(params, cfg, plan, mode="free", stages=[0, 1], **run)
    (a, b, *free) = fake_card.calls
    sizes, span = U.hand_sizes(plan.g), U.request_span(plan.rounds, 8)
    assert _hdims(a) == [1, span, 7, sizes["x"], sizes["y"], int(U.DEADLINE_S * 1e9), 0]
    assert _hdims(b) == [1 + span, span, 3, sizes["x"], sizes["y"],
                         int(U.DEADLINE_S * 1e9), 0]
    assert a[16] and a[17]                     # the workspace and the fault word
    assert len(free) == 2 and all(f[16] is None and _hdims(f) == [0] * 7 for f in free)


def test_launch_refuses_a_grid_too_large_before_any_launch(fake_card):
    cfg, params, kv, tok, pos, _ = _smoke(LLAMA, torch.device("cpu"))
    plan = plan_step(params, cfg, _caches(kv), tok, pos)
    with pytest.raises(ValueError, match="resident on 8 SMs"):
        run_step(params, cfg, plan, mode="lockstep", steal=True, steal_policy="cost",
                 n_programs=8, plain=False, helpers=8)
    with pytest.raises(ValueError, match="lockstep"):
        run_step(params, cfg, plan, mode="free", steal=True, steal_policy="cost",
                 n_programs=8, plain=False, helpers=1)
    assert fake_card.calls == []
    fake_card.status = 720   # cudaErrorCooperativeLaunchTooLarge from the entry point
    with pytest.raises(RuntimeError, match="cannot be resident"):
        run_step(params, cfg, plan, mode="lockstep", steal=True, steal_policy="cost",
                 n_programs=8, plain=False, helpers=2)


@pytest.mark.parametrize("cfg", [LLAMA, KIMI], ids=["llama", "kimi"])
def test_hand_sizes_cover_every_product(cfg):
    cfg_, params, kv, tok, pos, ptok = _smoke(cfg, torch.device("cpu"))
    g = plan_step(params, cfg_, _caches(kv), tok, pos, prefill_tokens=ptok).g
    nq, nkv = g.H * g.hd, g.Hkv * g.hd
    prods = [(g.R, g.d, nq + 2 * nkv), (g.R, nq, g.d), (g.R, g.d, 2 * g.f), (g.R, g.f, g.d),
             (g.B + 1, g.d, g.Vp)]
    if g.E:
        prods += [(g.R, g.d, g.E), (g.bt, g.d, 2 * g.fe), (g.bt, g.fe, g.d)]
    s = U.hand_sizes(g)
    for R, K, N in prods:
        assert R * K <= s["x"]
        assert N == g.Vp or R * N <= s["y"]     # the logits are not gathered
    assert s["done"] * U.SW >= g.Vp


def test_expected_requests_of_a_dense_step():
    cfg, params, kv, tok, pos, ptok = _smoke(LLAMA, torch.device("cpu"))
    for kw in ({}, {"prefill_tokens": ptok}):
        _, _, rep = decode_step_unified(params, cfg, _caches(kv), tok, pos, **kw)
        g = plan_step(params, cfg, _caches(kv), tok, pos, **kw).g
        mult = rep.res.mult.numpy()
        assert U.expected_requests(g, mult, []) == 4 * cfg.n_layers + 1
        assert U.request_span(rep.rounds, 8) > U.expected_requests(g, mult, [])


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _ints(res):
    return {n: getattr(res, n).cpu() for n in INTS}


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True], ids=["decode", "fold"])
@pytest.mark.parametrize("cfg", [LLAMA, KIMI], ids=["llama", "kimi"])
def test_kernel_matches_plain_on_card(cuda_device, cfg, fold):
    cfg, params, kv, tok, pos, ptok = _smoke(cfg, cuda_device)
    kw = {"prefill_tokens": ptok} if fold else {}
    lk, ck, rk = decode_step_unified(params, cfg, _caches(kv), tok, pos, **kw)
    lp, cp, rp = plain_decode_step_unified(params, cfg, _caches(kv), tok, pos, **kw)
    for n, a in _ints(rk.res).items():
        assert torch.equal(a, _ints(rp.res)[n]), n
    assert _rel(lk, lp) <= UNIFIED_RTOL
    assert _rel(ck.kv.k, cp.kv.k) <= UNIFIED_RTOL and _rel(ck.kv.v, cp.kv.v) <= UNIFIED_RTOL
    if fold:
        assert _rel(rk.prefill_logits, rp.prefill_logits) <= UNIFIED_RTOL
        assert _rel(rk.prefill_kv.k, rp.prefill_kv.k) <= UNIFIED_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True], ids=["decode", "fold"])
@pytest.mark.parametrize("cfg", [LLAMA, KIMI], ids=["llama", "kimi"])
def test_logits_bit_equal_across_helpers_on_card(cuda_device, cfg, fold):
    cfg, params, kv, tok, pos, ptok = _smoke(cfg, cuda_device)
    kw = {"prefill_tokens": ptok} if fold else {}
    top = torch.cuda.get_device_properties(cuda_device).multi_processor_count - 1
    outs = []
    for H in (0, 1, top):
        lg, c, rep = decode_step_unified(params, cfg, _caches(kv), tok, pos, helpers=H, **kw)
        outs.append((lg, c.kv.k, rep.prefill_logits))
        stats = U.last_stats(cuda_device)
        assert stats["helpers"] == H and (stats["requests"] > 0) == (H > 0)
    for lg, k, pl in outs[1:]:
        assert torch.equal(lg, outs[0][0]) and torch.equal(k, outs[0][1])
        assert pl is None or torch.equal(pl, outs[0][2])


@pytest.mark.cuda
def test_walker_delegates_every_product_on_card(cuda_device):
    cfg, params, kv, tok, pos, ptok = _smoke(LLAMA, cuda_device)
    for kw in ({}, {"prefill_tokens": ptok}):
        _, _, rep = decode_step_unified(params, cfg, _caches(kv), tok, pos, helpers=3, **kw)
        g = plan_step(params, cfg, _caches(kv), tok, pos, **kw).g
        stats = U.last_stats(cuda_device)
        assert stats["requests"] == U.expected_requests(g, rep.res.mult.cpu().numpy(), [])
        assert 0 < stats["wait_ns"] < stats["walk_ns"]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [LLAMA, KIMI], ids=["llama", "kimi"])
def test_two_free_launches_bit_equal_on_card(cuda_device, cfg):
    cfg, params, kv, tok, pos, ptok = _smoke(cfg, cuda_device)
    a, _, ra = decode_step_unified(params, cfg, _caches(kv), tok, pos, mode="free",
                                   prefill_tokens=ptok)
    b, _, rb = decode_step_unified(params, cfg, _caches(kv), tok, pos, mode="free",
                                   prefill_tokens=ptok)
    assert ra.launches == rb.launches == 2 + (5 if cfg.is_moe else 3) * cfg.n_layers
    assert torch.equal(a, b) and torch.equal(ra.prefill_logits, rb.prefill_logits)
    lk, _, _ = decode_step_unified(params, cfg, _caches(kv), tok, pos, prefill_tokens=ptok)
    assert _rel(a, lk) <= UNIFIED_RTOL


DEADLINE_DRILL = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    from test_torch_unified_redesign import LLAMA, _caches, _smoke
    from repro_torch.models.unified import plan_step, run_step
    from repro_torch.pallas_ws import unified_kernel as U
    dev = torch.device("cuda", 0)
    cfg, params, kv, tok, pos, _ = _smoke(LLAMA, dev)
    plan = plan_step(params, cfg, _caches(kv), tok, pos)
    launch = U.launch_cuda
    U.launch_cuda = lambda *a, **kw: launch(*a, **kw, deadline_s=0.05, mute_helpers=True)
    try:
        run_step(params, cfg, plan, mode="lockstep", steal=True, steal_policy="cost",
                 n_programs=8, helpers=4)
        torch.cuda.synchronize()
    except Exception as e:
        print("RAISED", type(e).__name__, U.fault_word(dev), flush=True)
        sys.exit(0)
    print("NO ERROR", flush=True)
""")


@pytest.mark.cuda
def test_spin_past_its_deadline_raises_on_card(cuda_device):
    """Muted helpers never answer: the walker's first request passes its
    deadline, the launch traps (in a process of its own: the trap ends the
    context) and Python raises, with fault code 1 (deadline) from CTA 0."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", DEADLINE_DRILL], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert "RAISED" in out.stdout, out.stdout + out.stderr
    code, cta, _, _ = eval(out.stdout.split("RAISED", 1)[1].split(None, 1)[1])
    assert (code, cta) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,helpers", [("lockstep", None), ("lockstep", 0), ("free", 0)],
                         ids=["lockstep-top", "lockstep-one-cta", "free"])
def test_vocab_padding_has_one_writer_on_card(cuda_device, mode, helpers):
    """At a vocabulary of 200 (Vp 256) the padding columns are -1e30 in
    every mode: the product that owns them writes them, and nothing else
    does (with helpers, a second writer in the walker could land first)."""
    cfg, params, kv, tok, pos, ptok = _smoke(LLAMA.replace(vocab_size=200), cuda_device)
    assert cfg.padded_vocab == 256
    lg, _, rep = decode_step_unified(params, cfg, _caches(kv), tok, pos, mode=mode,
                                     helpers=helpers, prefill_tokens=ptok)
    lp, _, rp = plain_decode_step_unified(params, cfg, _caches(kv), tok, pos,
                                          prefill_tokens=ptok)
    for got, want in ((lg, lp), (rep.prefill_logits, rp.prefill_logits)):
        assert bool((got[..., 200:] == -1e30).all())
        assert _rel(got[..., :200], want[..., :200]) <= UNIFIED_RTOL


def _twin_fn():
    from repro_torch import _build
    from repro_torch.pallas_ws.kernel import RING_ARGTYPES

    lib = ctypes.CDLL(str(_build.build("lockstep_twins", _build.CSRC / "probes")))
    fn = lib.lockstep_twin_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + RING_ARGTYPES + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cfg", [LLAMA, KIMI], ids=["llama", "kimi"])
def test_owned_walk_matches_the_shared_walk_on_card(cuda_device, cfg, trace):
    """ws_unified's walker walks its queues with owned_lockstep, every other
    lockstep kernel with ws_lockstep's own loop: on fresh copies of one
    step's stage-gated queues (decode and a fold) the two leave every
    integer array and ring the same."""
    from repro_torch.pallas_ws.kernel import STEAL_POLICIES, launch_grid, queue_dims

    fn = _twin_fn()
    cfg, params, kv, tok, pos, ptok = _smoke(cfg, cuda_device)
    plan = plan_step(params, cfg, _caches(kv), tok, pos, prefill_tokens=ptok)
    runs = []
    for view in (0, 1):
        def launch(arrs, *, mode, rounds, steal, policy, compress, n_tasks, ring, run_cap,
                   view=view):
            assert mode == "lockstep" and not compress and run_cap == 1
            err = fn(view, *[arrs[n].data_ptr() for n in U._QUEUE_ARRAYS], *queue_dims(arrs),
                     n_tasks, rounds, int(steal), STEAL_POLICIES.index(policy), *ring,
                     torch.cuda.current_stream(cuda_device).cuda_stream)
            assert err == 0, err

        runs.append(launch_grid(plan.state, plan.bufs["logits"], walk=None, launch=launch,
                                plain=False, mode="lockstep", compress=False, steal=True,
                                steal_policy="cost", rounds=plan.rounds, mult=None,
                                stage_open=plan.stage_open, trace=trace))
    torch.cuda.synchronize()
    shared, owned = (_ints(r) for r in runs)
    for n in INTS:
        assert torch.equal(owned[n], shared[n]), n
    assert int(shared["mult"][:plan.g.n_tasks].min()) >= 1  # the walk claimed every task
    if trace:
        assert torch.equal(runs[1].ev_cursor, runs[0].ev_cursor)
        assert torch.equal(runs[1].events, runs[0].events)
        assert int(runs[0].ev_cursor.sum()) > 0
