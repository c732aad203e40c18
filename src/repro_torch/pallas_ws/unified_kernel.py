"""The C binding of ``csrc/ws_unified.cu``, the unified engine step's
megakernel (the TPU kernel ``execute`` in ``repro/models/unified.py``).

:func:`launch_cuda` is the ``launch`` half of a
:func:`~repro_torch.pallas_ws.kernel.launch_grid` call made by
:func:`repro_torch.models.unified.run_step`: it checks the step's tensors,
allocates the glue phases' scratch once per step, marshals every pointer and
size, launches on the current stream and counts the launch in
``launches["ws_unified"]``.  The plain version is
``repro_torch.models.unified._UnifiedWalk``.

The weights are passed in place, as the params hold them: a MoE model's
stacked experts (``we_g``/``we_u`` [L, E, d, fe], ``we_d`` [L, E, fe, d])
are neither stacked nor copied nor cast here, since at full width one more
copy of them does not fit on the card.  A MoE layer's shared experts take
the dense MLP's slots (``wg``/``wu``/``wd``).
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import MODES, NO_RING, RING_ARGTYPES, STEAL_POLICIES, launches, queue_dims

_QUEUE_ARRAYS = ("tasks", "tail", "head", "local_head", "taken", "remaining", "clock",
                 "work", "steals", "scanned", "mult", "stage_open")
_WEIGHTS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg", "wu", "wd", "router",
            "we_g", "we_u", "we_d")


def _kernel_fn():
    """The C entry point of ``csrc/ws_unified.cu`` (built at first use)."""
    from .. import _build

    fn = _build.load("ws_unified").ws_unified_launch
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # mode; 12 int32 queue arrays (stage_open null in free mode); the
        # pointer, int and float tables; 7 sizes and flags; the ring; stream
        fn.argtypes = [i] + [ptr] * 12 + [ptr] * 3 + [i] * 7 + RING_ARGTYPES + [ptr]
        fn.restype = i
    return fn


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


def launch_cuda(arrs, params, g, bufs, inputs, *, mode, rounds, steal, policy, compress,
                n_tasks, ring=NO_RING, run_cap=1) -> None:
    """Launch ``ws_unified`` over ``arrs`` (the launch's queue arrays) for the
    step of geometry ``g`` into ``bufs``."""
    assert not compress, "the unified step walks every round"
    assert run_cap == 1, "the stage-gated step has no half-run walk"
    dev = bufs["logits"].device
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
                             "sr", "sidx", "sgv", "prow")]]
    dims = [g.B, g.Lp, g.L, g.d, g.H, g.Hkv, g.hd, g.f, g.vocab, g.Vp, g.cap, g.bk_d, g.bq_p,
            g.bk_p, g.nq_p, g.Lp_pad, g.n_flash_l, g.dec_att_base, g.pre_att_base,
            g.E, g.top_k, g.fe, g.bt, g.pool_dec, g.pool_pre, g.exp_dec_base, g.exp_pre_base]
    ptr_tab = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dim_tab = (ctypes.c_int * len(dims))(*dims)
    f_tab = (ctypes.c_float * 4)(g.eps, g.theta, g.res_scale, g.hd ** -0.5)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        MODES.index(mode),
        *[arrs[n].data_ptr() if n in arrs else None for n in _QUEUE_ARRAYS],
        ctypes.cast(ptr_tab, ctypes.c_void_p), ctypes.cast(dim_tab, ctypes.c_void_p),
        ctypes.cast(f_tab, ctypes.c_void_p),
        *queue_dims(arrs), n_tasks, rounds, int(steal), STEAL_POLICIES.index(policy), *ring,
        stream,
    )
    launches["ws_unified"] += 1
    if err != 0:
        raise RuntimeError(f"ws_unified launch failed with CUDA error {err}")
