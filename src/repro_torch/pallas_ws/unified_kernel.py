"""The C binding of ``csrc/ws_unified.cu``, the unified engine step's
megakernel (the TPU kernel ``execute`` in ``repro/models/unified.py``).

:func:`launch_cuda` is the ``launch`` half of a
:func:`~repro_torch.pallas_ws.kernel.launch_grid` call made by
:func:`repro_torch.models.unified.run_step`: it checks the step's tensors,
allocates the glue phases' scratch once per step, marshals every pointer and
size, launches on the current stream and counts the launch in
``launches["ws_unified"]``.  The plain version is
``repro_torch.models.unified._UnifiedWalk``.

A lockstep launch is a walker (CTA 0, the scheduler walk and everything but
the weight products) and ``H`` helpers (CTAs 1..H, the products' column
strips), launched cooperatively so that all are resident at once;
:func:`choose_helpers` picks ``H`` (one a remaining SM by default) and
refuses, before any launch, a grid the card cannot hold.  Walker and helpers
hand each other requests, X and Y as tagged 64-bit words (value and request
tag) in a per-device workspace that outlives the launch: its tags only grow,
each launch taking a span of them past the most requests it can make.  A
spin that passes its deadline, or meets a tag newer than it expects, writes
a fault code to pinned host memory and traps: the launch fails and the next
synchronising call raises (:func:`fault_word` reads the code).  Free mode
has no helpers.

The weights are passed in place, as the params hold them: a MoE model's
stacked experts (``we_g``/``we_u`` [L, E, d, fe], ``we_d`` [L, E, fe, d])
are neither stacked nor copied nor cast here, since at full width one more
copy of them does not fit on the card.  A MoE layer's shared experts take
the dense MLP's slots (``wg``/``wu``/``wd``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .kernel import MODES, NO_RING, RING_ARGTYPES, STEAL_POLICIES, launches, queue_dims

_QUEUE_ARRAYS = ("tasks", "tail", "head", "local_head", "taken", "remaining", "clock",
                 "work", "steals", "scanned", "mult", "stage_open")
_WEIGHTS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg", "wu", "wd", "router",
            "we_g", "we_u", "we_d")

SW = 32                 # columns of a product's strip (csrc/ws_unified.cu)
UTHREADS = 512          # threads of a CTA
SMEM_BYTES = 226 * 1024  # the most dynamic shared memory a CTA takes (MAX_SMEM)
DEADLINE_S = 5.0        # every spin's deadline: far past any fault plan's stall
# the request word's fields: rows 11 bits, layer 8, expert 9
MAX_ROWS, MAX_LAYERS, MAX_EXPERTS = 2047, 256, 512
BRANCH_DECODE, BRANCH_GENERIC = 0, 2
# the walker's counts, as csrc/ws_unified.cu's STAT_* order them
STATS = ("requests", "wait_ns", "walk_ns", "attention_ns", "expert_ns", "glue_ns",
         "helper_ns")


def _kernel_fn():
    """The C entry point of ``csrc/ws_unified.cu`` (built at first use)."""
    from .. import _build

    fn = _build.load("ws_unified").ws_unified_launch
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # mode; 12 int32 queue arrays (stage_open null in free mode); the
        # pointer, int and float tables; the hand-off (words, fault word,
        # sizes); 7 sizes and flags; the ring; stream
        fn.argtypes = ([i] + [ptr] * 12 + [ptr] * 3 + [ptr] * 3 + [i] * 7 + RING_ARGTYPES
                       + [ptr])
        fn.restype = i
    return fn


def choose_helpers(mode: str, helpers: Optional[int], sm_count: int) -> int:
    """The helper CTAs of a launch.  Lockstep: ``helpers`` (None: one a SM
    beside the walker's, ``sm_count - 1``), refused when ``1 + helpers``
    CTAs of one SM each cannot be resident at once.  Free mode runs every
    product in the claiming CTA and takes none."""
    if mode == "free":
        if helpers:
            raise ValueError("free mode runs every product in the CTA that claims it: "
                             f"helpers are for lockstep, got helpers={helpers}")
        return 0
    if helpers is None:
        return max(0, sm_count - 1)
    if not 0 <= helpers <= sm_count - 1:
        raise ValueError(f"a walker and {helpers} helpers are {1 + helpers} CTAs of "
                         f"{UTHREADS} threads and {SMEM_BYTES} B of shared memory, one an SM: "
                         f"they cannot all be resident on {sm_count} SMs")
    return int(helpers)


def expected_requests(g, mult, rl_by_layer) -> int:
    """The requests a lockstep step's walker posts (its stats' count): for
    each claim of a task, the products its body runs: a layer's pre glue 1
    (q|k|v), its post glue 3 (wo, gate|up, down; a MoE layer's wo and
    router), a MoE layer's combine 2 when it has shared experts, the logits
    1, a live expert tile 2.  ``mult`` [n_tasks] and ``rl_by_layer`` (each
    layer's live rows of its pool tiles; empty on a dense model) on the
    host."""
    per = []  # the glue tasks after GLUE_EMBED, in tid order
    for _ in range(g.L):
        per += [1, 2, 2 if g.f else 0] if g.E else [1, 3]
    per.append(1)
    n = sum(int(m) * c for m, c in zip(mult[1:1 + len(per)], per))
    for l, rl in enumerate(rl_by_layer):
        for base, pool, rows in ((g.exp_dec_base, g.pool_dec, rl[:g.pool_dec]),
                                 (g.exp_pre_base, g.pool_pre, rl[g.pool_dec:])):
            tiles = mult[base + l * pool:base + (l + 1) * pool]
            n += sum(2 * int(m) for m, r in zip(tiles, rows) if int(r))
    return n


def _sm_count(dev) -> int:
    """The card's SMs (a CPU device, which only a stand-in library sees:
    1, so the walker has no helpers)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 1


def request_span(rounds: int, n_programs: int) -> int:
    """Tags a lockstep launch may use: each of its at most rounds x P claims
    makes at most 3 requests (a dense layer's post-attention glue: wo,
    gate|up, down), then the exit."""
    return 3 * rounds * n_programs + 2


def hand_sizes(g) -> Dict[str, int]:
    """The hand-off's words for step geometry ``g``: X of a request (two
    buffers), Y of a request, and one done word a strip of the unembedding."""
    nq, nkv = g.H * g.hd, g.Hkv * g.hd
    rows = max(g.R, g.bt if g.E else 0)
    x = rows * max(g.d, nq, g.f, g.fe)
    y = max(g.R * max(nq + 2 * nkv, 2 * g.f, g.d, g.E), (g.bt * max(2 * g.fe, g.d)) if g.E else 0)
    return {"x": x, "y": y, "done": -(-g.Vp // SW)}


# per device: the hand-off's words, the next free tag, the fault word
_HANDS: Dict[torch.device, dict] = {}


def _key(dev) -> torch.device:
    """A device with its index (``cuda`` is the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _hand(dev, sizes, span):
    """The device's workspace (grown when a step needs more, its tags then
    restarting from 1) and this launch's first tag."""
    words = 1 + 2 * sizes["x"] + sizes["y"] + sizes["done"] + len(STATS)
    dev = _key(dev)
    h = _HANDS.get(dev)
    if h is None or h["ws"].numel() < words:
        h = _HANDS[dev] = dict(ws=torch.zeros(words, dtype=torch.int64, device=dev), next=1,
                               fault=torch.zeros(4, dtype=torch.int32,
                                                 pin_memory=dev.type == "cuda"))
    if h["next"] + span >= 1 << 32:  # tags would wrap: every word back to tag 0
        h["ws"].zero_()
        h["next"] = 1
    base = h["next"]
    h["next"] += span
    h["stats"] = h["ws"][words - len(STATS):words]
    return h, base


def fault_word(dev=None) -> list:
    """The fault a trapped launch wrote (host memory: readable after the
    trap): code (1 deadline, 2 newer tag, 3 span), CTA, tag seen, tag
    expected; zeros when none."""
    h = _HANDS.get(_key("cuda" if dev is None else dev))
    return [0, 0, 0, 0] if h is None else h["fault"].tolist()


def last_stats(dev) -> Dict[str, int]:
    """The last lockstep launch's walker counts (synchronises): delegated
    requests, ns the walker waited on them (post to the last word of Y), ns
    of its whole walk, ns in its attention, expert and glue bodies (the
    waits included; the rest of the walk is the scheduler's), ns helper 1
    spent on its strips, and the helpers it had."""
    h = _HANDS[_key(dev)]
    return {**dict(zip(STATS, h["stats"].tolist())), "helpers": h["H"]}


def _layer_weights(params):
    """The stacked layer weights by the kernel's names (absent ones left out)."""
    layers = params["layers"]
    w = {"attn_norm": layers["attn_norm"], "mlp_norm": layers["mlp_norm"], **layers["attn"]}
    moe = layers.get("moe")
    if moe is None:
        w.update(layers["mlp"])
        return w
    w.update(router=moe["router"], we_g=moe["we_g"], we_u=moe["we_u"], we_d=moe["we_d"])
    if "ws_g" in moe:
        w.update(wg=moe["ws_g"], wu=moe["ws_u"], wd=moe["ws_d"])
    return w


def _check(name, t, dev, *, align=True):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be contiguous float32 on {dev}: "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if align and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _unembed(params):
    """The [d, Vp] unembedding, contiguous (a tied embedding is transposed)."""
    w = params.get("unembed")
    return params["embed"].T.contiguous() if w is None else w


def decode_branch(g, kc) -> int:
    """The decode tiles' body: the GEMV (a) when the cache rows are 16-byte
    words (hd % 8 == 0, hd <= 256, an aligned cache), else the generic (c)."""
    ok = g.hd % 8 == 0 and g.hd <= 256 and kc.data_ptr() % 16 == 0
    return BRANCH_DECODE if ok else BRANCH_GENERIC


def launch_cuda(arrs, params, g, bufs, inputs, *, mode, rounds, steal, policy, compress,
                n_tasks, ring=NO_RING, run_cap=1, helpers=None, deadline_s=DEADLINE_S,
                mute_helpers=False) -> None:
    """Launch ``ws_unified`` over ``arrs`` (the launch's queue arrays) for the
    step of geometry ``g`` into ``bufs``.  ``helpers``: see
    :func:`choose_helpers`; ``deadline_s`` bounds every spin;
    ``mute_helpers`` (a drill) has the helpers return at once, so the
    walker's first request passes its deadline."""
    assert not compress, "the unified step walks every round"
    assert run_cap == 1, "the stage-gated step has no half-run walk"
    dev = bufs["logits"].device
    H = choose_helpers(mode, helpers, _sm_count(dev))
    if H and (g.R > MAX_ROWS or g.L > MAX_LAYERS or g.E > MAX_EXPERTS):
        raise ValueError(f"a request word holds at most {MAX_ROWS} rows, {MAX_LAYERS} layers "
                         f"and {MAX_EXPERTS} experts: R {g.R}, L {g.L}, E {g.E}")
    w = _layer_weights(params)
    un = inputs.get("unembed")
    if un is None:
        un = inputs["unembed"] = _unembed(params)
    for name, t in (("embed", params["embed"]), ("final_norm", params["final_norm"]),
                    ("unembed", un), *w.items()):
        _check(name, t, dev)
    for n in (g.H * g.hd, g.Hkv * g.hd, g.d, g.f, g.Vp, g.E, g.fe):
        if n % 4:
            raise ValueError(f"the kernel's products need widths that are multiples of 4: {n}")
    for name in ("kc", "vc", "h", "qd", "att", "logits", "qp", "attp", "kp", "vp"):
        if name in bufs:
            _check(name, bufs[name], dev, align=False)
    if "xn" not in bufs:
        R, f32 = g.R, torch.float32
        shapes = {"xn": g.d, "sq": g.H * g.hd, "sk": g.Hkv * g.hd, "sv": g.Hkv * g.hd,
                  "sa": g.d, "sh2": g.d, "sg": g.f, "su": g.f, "shm": g.f, "sm": g.d,
                  "sr": g.E, "sgv": g.top_k}
        for name, n in shapes.items():
            bufs[name] = torch.empty((R, n), dtype=f32, device=dev)
        for name in ("sidx", "prow"):
            bufs[name] = torch.empty((R, g.top_k), dtype=torch.int32, device=dev)
        # an expert tile's rows, one slot a program
        slots = queue_dims(arrs)[2] if g.E else 0
        for name, n in (("ex", g.d), ("eg", g.fe), ("eu", g.fe), ("ey", g.d)):
            bufs[name] = torch.empty((slots, g.bt, n), dtype=f32, device=dev)
        bufs["tok32"] = inputs["tokens"].to(torch.int32)
        bufs["pos32"] = inputs["pos"].to(torch.int32)
        if g.Lp:
            bufs["ptok32"] = inputs["ptok"].to(torch.int32)

    def p(name, src=bufs):
        t = src.get(name)
        return None if t is None else t.data_ptr()

    ptrs = [p("tok32"), p("pos32"), p("ptok32"), params["embed"].data_ptr(),
            params["final_norm"].data_ptr(), un.data_ptr(), *[p(n, w) for n in _WEIGHTS],
            *[p(n) for n in ("kc", "vc", "kp", "vp", "h", "qd", "qp", "att", "attp", "logits",
                             "xf", "tok", "gate", "e", "rl", "yr",
                             "xn", "sq", "sk", "sv", "sa", "sh2", "sg", "su", "shm", "sm",
                             "sr", "sidx", "sgv", "prow", "ex", "eg", "eu", "ey")]]
    dims = [g.B, g.Lp, g.L, g.d, g.H, g.Hkv, g.hd, g.f, g.vocab, g.Vp, g.cap, g.bk_d, g.bq_p,
            g.bk_p, g.nq_p, g.Lp_pad, g.n_flash_l, g.dec_att_base, g.pre_att_base,
            g.E, g.top_k, g.fe, g.bt, g.pool_dec, g.pool_pre, g.exp_dec_base, g.exp_pre_base,
            decode_branch(g, bufs["kc"])]
    ptr_tab = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dim_tab = (ctypes.c_int * len(dims))(*dims)
    f_tab = (ctypes.c_float * 4)(g.eps, g.theta, g.res_scale, g.hd ** -0.5)
    hand = fault = None
    hdims = [0] * 7
    if mode == "lockstep":
        sizes = hand_sizes(g)
        span = request_span(rounds, queue_dims(arrs)[2])
        h, base = _hand(dev, sizes, span)
        h["H"] = H
        hand, fault = h["ws"].data_ptr(), h["fault"].data_ptr()
        hdims = [base, span, H, sizes["x"], sizes["y"], int(deadline_s * 1e9),
                 int(bool(mute_helpers))]
    hdim_tab = (ctypes.c_longlong * 7)(*hdims)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        MODES.index(mode),
        *[arrs[n].data_ptr() if n in arrs else None for n in _QUEUE_ARRAYS],
        ctypes.cast(ptr_tab, ctypes.c_void_p), ctypes.cast(dim_tab, ctypes.c_void_p),
        ctypes.cast(f_tab, ctypes.c_void_p), hand, fault,
        ctypes.cast(hdim_tab, ctypes.c_void_p),
        *queue_dims(arrs), n_tasks, rounds, int(steal), STEAL_POLICIES.index(policy), *ring,
        stream,
    )
    launches["ws_unified"] += 1
    if err != 0:
        raise RuntimeError(f"ws_unified launch failed with CUDA error {err}"
                           + (" (the walker and its helpers cannot be resident at once)"
                              if err == 720 else ""))
