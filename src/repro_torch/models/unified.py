"""One engine step as one launch: the unified mixed-mode step, dense half
(port of ``repro/models/unified.py``).

An engine step — one decode token for every live slot and, optionally, one
folded-in prompt's prefill — runs as ONE launch of the work-stealing
megakernel over stage-gated queues (:func:`make_staged_queue_state`) that
mix two task families:

* attention — decode tiles (one ``(b, h)`` query row over its live kv
  range) and causal prefill flash tiles, the records ``emit_decode_tasks``
  and ``emit_flash_tasks`` build;
* step glue — the phases between them (``GLUE_*`` below): embed; per layer
  norm, q/k/v, RoPE and the cache splice; the multiplicity-normalised
  combine, ``wo``, the residual, norm, SwiGLU MLP and residual; the final
  norm and unembedding.

Stage ``s``'s queues open at round ``stage_open[s]``, the prefix sums of the
stages' Graham bounds, so every task of a stage has finished before the next
stage's queues open: the dependencies are an input of the launch, not a wait
on the device.  The kernel is ``csrc/ws_unified.cu``
(:mod:`repro_torch.pallas_ws.unified_kernel`); :class:`_UnifiedWalk` is its
plain PyTorch version, taken for CPU tensors only.

Two modes.
* ``mode="lockstep"`` (the default) is the reference's launch: one CTA
  walks the ``(rounds, P)`` grid, the stage gate read each round, the whole
  step ONE launch; every integer array ends bit-equal to the plain walk.
  Attention tiles accumulate, and the glue divides them by ``mult``.
* ``mode="free"`` cannot be one launch: stage windows are counted in
  rounds, and free CTAs have none.  Making a consumer stage wait for its
  producer on the device would take acquire/release ordering, which the
  fence-free scheduler forbids.  So free mode runs one launch per stage (2
  + 3L launches a step, 86 for llama3.2-3b) of the same kernel over only
  that stage's queues; the kernel boundaries on the stream order the
  stages, and each launch carries the summed ``mult`` of the ones before.
  Tiles store whole tiles, so nothing is divided by ``mult``.

Free CTAs can claim one glue task several times at once, so a glue phase
never updates a buffer in place: the residual stream ping-pongs between
``h[0]`` and ``h[1]`` (layer ``l`` reads ``h[l % 2]`` and writes
``h[(l + 1) % 2]``), each layer's attention tiles write their own
``att[l]``, and every other write is a pure function of what earlier stages
wrote.  A duplicate then writes the bits the first execution wrote.

The KV cache is read in place: decode tiles read the ``[L, B, cap, Hkv,
hd]`` cache through strides (the reference copies it into padded transposed
buffers), and the splice writes only each slot's new row, in place, as the
port's split decode step does.  A folded prompt's k/v land in the report's
``prefill_kv`` ``[L, 1, cap, Hkv, hd]``.

Not ported here: the MoE half (the in-kernel router and pool Put, expert
tiles, ``GLUE_COMB``), which the next slice takes, and ``trace=True``, which
waits for the trace rings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..pallas_ws.kernel import (
    MODES,
    WSRunResult,
    _PlainWalk,
    attention_tile,
    launch_grid,
    scheduler_knobs,
)
from ..pallas_ws.queues import QueueState, make_staged_queue_state
from ..pallas_ws.ragged import _pad_to
from ..pallas_ws.tasks import (
    BOTTOM,
    F_LAYER,
    F_OP,
    F_PHASE,
    F_TID,
    OP_DECODE_TILE,
    OP_FLASH_TILE,
    OP_STEP_GLUE,
    StepGlueTask,
    emit_decode_tasks,
    emit_flash_tasks,
)
from . import attention as attn
from . import transformer as tf
from .common import apply_rope, rms_norm, swiglu
from .model import (
    Caches,
    _mask_pad_vocab,
    _pad_seq,
    _positions,
    _unembed_matrix,
    ws_decode_supported,
)

# Glue phase codes (F_PHASE of a step-glue record).  One glue task per
# (phase, layer) serves both segments: the decode batch and the folded prompt.
GLUE_EMBED = 0    # token embedding -> residual stream
GLUE_PRE = 1      # attn norm, q/k/v + RoPE, cache splice, tile inputs
GLUE_POST = 2     # attention combine (mult-normalised), wo, residual, mlp norm, MLP
GLUE_COMB = 3     # expert combine and shared experts (MoE half: not ported)
GLUE_LOGITS = 4   # final norm + unembed -> logits

GLUE_COST = 1  # glue phases are serial; the cost only sizes their stage window

SEG_DECODE = 0
SEG_PREFILL = 1

# Stage-assembly memo: the host Put is pure in its geometry (the decode
# length vector, the folded prompt's length, the tile and config knobs), so
# steps with the same key reuse the built QueueState; launches never mutate
# it (launch_grid copies every mutable array).  Cleared when it would
# exceed _STAGE_CACHE_MAX entries.
_STAGE_CACHE: Dict[tuple, tuple] = {}
_STAGE_CACHE_STATS = {"builds": 0, "hits": 0}
_STAGE_CACHE_MAX = 128


def stage_cache_stats() -> Dict[str, int]:
    """Copy of the stage-assembly cache counters: one ``builds`` per unique
    key, ``hits`` otherwise."""
    return dict(_STAGE_CACHE_STATS)


def clear_stage_cache() -> None:
    _STAGE_CACHE.clear()
    _STAGE_CACHE_STATS["builds"] = 0
    _STAGE_CACHE_STATS["hits"] = 0


def unified_step_supported(cfg) -> bool:
    """The reference's gate: full-attention GQA decoders in float32 (the
    decode half's parity contract with the split step), token-only prompts,
    and for MoE the ws expert dispatch."""
    return (
        ws_decode_supported(cfg)
        and cfg.family != "vlm"
        and cfg.dtype == "float32"
        and (not cfg.is_moe or cfg.moe_dispatch == "ws")
    )


def check_ported(cfg) -> None:
    """Raise for a supported config whose unified step the port lacks."""
    if not unified_step_supported(cfg):
        raise ValueError(f"unified step unsupported for config {cfg.name!r}")
    if cfg.is_moe:
        raise NotImplementedError(
            "the MoE half of the unified step (in-kernel router and pool Put, expert "
            "tiles, GLUE_COMB) is not ported yet: it is the next slice of the port")


@dataclass
class UnifiedStepReport:
    """Telemetry and prefill results of one unified step."""

    res: WSRunResult
    state: QueueState
    stage_open: np.ndarray
    rounds: int
    n_tasks: int
    prefill_logits: Optional[torch.Tensor] = None   # [1, Vp] when a prompt folded in
    prefill_kv: Optional[attn.KVCache] = None       # [L, 1, cap, Hkv, hd]
    tid_bases: Optional[Dict[str, int]] = None
    launches: int = 1                               # kernel launches of the step


def _check_drained(n_tasks: int, res: WSRunResult) -> None:
    mult = res.mult[:n_tasks]
    if n_tasks and not bool((mult >= 1).all()):
        missing = int((mult == 0).sum())
        raise RuntimeError(f"unified step under-provisioned: {missing}/{n_tasks} tasks "
                           "never executed (stage windows too small?)")


@dataclass(frozen=True)
class Geometry:
    """Shapes and tid layout of one step (everything the tile and glue
    bodies index with)."""

    B: int
    L: int
    H: int
    Hkv: int
    hd: int
    d: int
    f: int
    cap: int
    Vp: int
    vocab: int
    bk_d: int
    Lp: int
    bq_p: int
    bk_p: int
    nq_p: int
    Lp_pad: int
    n_flash_l: int
    dec_att_base: int
    pre_att_base: int
    n_tasks: int
    eps: float
    theta: float
    res_scale: float

    @property
    def R(self) -> int:
        """Rows of the residual stream: the decode batch, then the prompt."""
        return self.B + self.Lp

    def dec_layer(self, tid: int) -> int:
        return (tid - self.dec_att_base) // (self.B * self.H)

    def pre_layer(self, tid: int) -> int:
        return (tid - self.pre_att_base) // self.n_flash_l


def geometry(params, cfg, caches: Caches, B: int, Lp: int, *, bk: int, bq: int) -> Geometry:
    L = cfg.n_layers
    H, Hkv = cfg.eff_heads
    cap = caches.kv.k.shape[2]
    bk_d = min(bk, max(1, cap))
    if Lp:
        bq_p, bk_p = min(bq, Lp), min(bk, Lp)
        nq_p = -(-Lp // bq_p)
    else:
        bq_p = bk_p = 1
        nq_p = 0
    n_flash_l = H * nq_p
    n_glue = 2 + 2 * L
    dec_att_base = n_glue
    pre_att_base = dec_att_base + L * B * H
    return Geometry(
        B=B, L=L, H=H, Hkv=Hkv, hd=cfg.hd, d=cfg.d_model,
        f=params["layers"]["mlp"]["wg"].shape[-1], cap=cap,
        Vp=_unembed_matrix(params, cfg).shape[-1], vocab=cfg.vocab_size,
        bk_d=bk_d, Lp=Lp, bq_p=bq_p, bk_p=bk_p, nq_p=nq_p, Lp_pad=nq_p * bq_p,
        n_flash_l=n_flash_l, dec_att_base=dec_att_base, pre_att_base=pre_att_base,
        n_tasks=pre_att_base + L * n_flash_l, eps=cfg.norm_eps,
        theta=cfg.rope_theta, res_scale=tf._res_scale(cfg))


def tid_bases(g: Geometry) -> Dict[str, int]:
    """The reference's tid layout (the expert blocks are empty on a dense model)."""
    return {"glue": 0, "dec_att": g.dec_att_base, "pre_att": g.pre_att_base,
            "exp_dec": g.n_tasks, "exp_pre": g.n_tasks, "n_tasks": g.n_tasks}


def build_stages(g: Geometry, lengths, n_programs: int):
    """The reference's stage list: embed; per layer pre-glue, the attention
    tiles (decode, then the prompt's flash tiles), post-glue; logits.
    Returns ``(state, stage_open, rounds)``."""
    tid = [0]

    def glue(phase, layer):
        t = StepGlueTask(phase, layer, BOTTOM, tid[0], GLUE_COST)
        tid[0] += 1
        return t

    dec = emit_decode_tasks(lengths, g.H, g.bk_d)
    flash = emit_flash_tasks([g.Lp], g.H, g.bq_p, g.bk_p, causal=True) if g.Lp else []
    stages = [[glue(GLUE_EMBED, 0)]]
    for lyr in range(g.L):
        stages.append([glue(GLUE_PRE, lyr)])
        base = g.dec_att_base + lyr * g.B * g.H
        att = [dataclasses.replace(t, tid=base + t.tid) for t in dec]
        base = g.pre_att_base + lyr * g.n_flash_l
        att += [dataclasses.replace(t, tid=base + t.tid) for t in flash]
        stages.append(att)
        stages.append([glue(GLUE_POST, lyr)])
    stages.append([glue(GLUE_LOGITS, 0)])
    assert tid[0] == 2 + 2 * g.L, tid[0]
    return make_staged_queue_state(stages, n_programs, partition="owner")


def staged_queues(g: Geometry, lengths, n_programs: int):
    """:func:`build_stages`, memoised by the reference's key (its dense part)."""
    key = (tuple(int(x) for x in lengths), g.Lp, g.B, g.L, g.H, g.bk_d, g.bq_p, g.bk_p,
           n_programs)
    cached = _STAGE_CACHE.get(key)
    if cached is None:
        cached = build_stages(g, lengths, n_programs)
        _STAGE_CACHE_STATS["builds"] += 1
        if len(_STAGE_CACHE) >= _STAGE_CACHE_MAX:
            _STAGE_CACHE.clear()
        _STAGE_CACHE[key] = cached
    else:
        _STAGE_CACHE_STATS["hits"] += 1
    return cached


def stage_state(state: QueueState, s: int, q_s: int, n_tasks: int) -> QueueState:
    """Stage ``s``'s block of queues ``[s q_s, (s + 1) q_s)`` as a state of
    its own (tids stay global, so ``n_tasks`` sizes the mult carry)."""
    qs = slice(s * q_s, (s + 1) * q_s)
    return QueueState(
        tasks=state.tasks[qs], head=state.head[qs], tail=state.tail[qs],
        local_head=state.local_head[:, qs], taken=state.taken[qs], task_list=None,
        remaining=state.remaining[qs], n_tasks_hint=n_tasks)


def alloc_buffers(g: Geometry, caches: Caches, dev) -> Dict[str, torch.Tensor]:
    """The step's buffers.  ``kc``/``vc`` are the caller's caches (updated
    in place); the rest are fresh."""
    f32 = torch.float32

    def z(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    logits = z(g.B + 1, g.Vp)  # the decode rows, then the prompt's last row
    bufs = {
        "kc": caches.kv.k, "vc": caches.kv.v,
        "h": z(2, g.R, g.d),
        "qd": z(g.B, g.H, 1, g.hd),
        "att": z(g.L, g.B, g.H, 1, g.hd),
        "logits": logits[:g.B],
    }
    if g.Lp:
        bufs.update(
            qp=z(1, g.H, g.Lp_pad, g.hd),
            attp=z(g.L, 1, g.H, g.Lp_pad, g.hd),
            kp=z(g.L, 1, g.cap, g.Hkv, g.hd), vp=z(g.L, 1, g.cap, g.Hkv, g.hd),
            logp=logits[g.B:],
        )
    return bufs


# ---------------------------------------------------------------------------
# plain version


class _UnifiedWalk(_PlainWalk):
    """The plain version of ``csrc/ws_unified.cu``: the shared scheduler walk
    with the attention tile body (decode and flash) and the glue phases as
    torch ops on the buffers' device, in the same buffers and walk order."""

    def __init__(self, arrs, params, cfg, g: Geometry, bufs, inputs, *, steal, policy):
        super().__init__(arrs, steal=steal, policy=policy)
        self.params, self.cfg, self.g, self.b, self.inp = params, cfg, g, bufs, inputs

    def execute(self, fq, fs, *, store):
        rec = self.rec(fq, fs)
        op, g, b = rec[F_OP], self.g, self.b
        scale = g.hd ** -0.5
        if op == OP_DECODE_TILE:
            lyr = g.dec_layer(rec[F_TID])
            attention_tile(rec, b["qd"], b["kc"][lyr].permute(0, 2, 1, 3),
                           b["vc"][lyr].permute(0, 2, 1, 3), b["att"][lyr], bq=1, bk=g.bk_d,
                           causal=False, scale=scale, g=g.H // g.Hkv, store=store)
        elif op == OP_FLASH_TILE:
            lyr = g.pre_layer(rec[F_TID])
            attention_tile(rec, b["qp"], b["kp"][lyr, :, :g.Lp].permute(0, 2, 1, 3),
                           b["vp"][lyr, :, :g.Lp].permute(0, 2, 1, 3), b["attp"][lyr],
                           bq=g.bq_p, bk=g.bk_p, causal=True, scale=scale,
                           g=g.H // g.Hkv, store=store)
        elif op == OP_STEP_GLUE:
            phase, lyr = rec[F_PHASE], rec[F_LAYER]
            if phase == GLUE_EMBED:
                self.embed()
            elif phase == GLUE_PRE:
                self.pre(lyr)
            elif phase == GLUE_POST:
                self.post(lyr, divide=not store)
            elif phase == GLUE_LOGITS:
                self.logits()
            else:
                raise ValueError(f"glue phase {phase} is not in the dense unified step")
        else:
            raise ValueError(f"op {op} is not in the dense unified step")

    # -- glue phases: the reference's op sequence, read from the previous
    # stage's buffers, written to distinct ones -----------------------------
    def embed(self):
        g, b, emb = self.g, self.b, self.params["embed"]
        b["h"][0, :g.B] = emb[self.inp["tokens"]].float()
        if g.Lp:
            b["h"][0, g.B:] = emb[self.inp["ptok"]].float()

    def pre(self, lyr):
        g, b, cfg = self.g, self.b, self.cfg
        p = tf.layer_params(self.params, lyr)
        h = b["h"][lyr % 2]
        hn = rms_norm(h[:g.B].view(g.B, 1, g.d), p["attn_norm"], g.eps)
        q, _ = attn._decode_qkv(hn, p["attn"], cfg, attn.KVCache(b["kc"][lyr], b["vc"][lyr]),
                                self.inp["pos"])
        b["qd"][:] = q.reshape(g.B, g.H, g.hd)[:, :, None, :]
        if g.Lp:
            hnp = rms_norm(h[g.B:].view(1, g.Lp, g.d), p["attn_norm"], g.eps)
            k = torch.einsum("bsd,dhe->bshe", hnp, p["attn"]["wk"])
            v = torch.einsum("bsd,dhe->bshe", hnp, p["attn"]["wv"])
            k = apply_rope(k, self.inp["pos_p"], g.theta)
            b["kp"][lyr] = _pad_seq(k, g.cap)
            b["vp"][lyr] = _pad_seq(v, g.cap)
            qp = apply_rope(torch.einsum("bsd,dhe->bshe", hnp, p["attn"]["wq"]),
                            self.inp["pos_p"], g.theta)
            b["qp"][:] = _pad_to(qp.transpose(1, 2), 2, g.bq_p)

    def post(self, lyr, *, divide):
        g, b, s = self.g, self.b, self.g.res_scale
        p = tf.layer_params(self.params, lyr)
        h, h_out = b["h"][lyr % 2], b["h"][(lyr + 1) % 2]
        att = b["att"][lyr]
        if divide:
            base = g.dec_att_base + lyr * g.B * g.H
            mult = torch.tensor(self.mult[base:base + g.B * g.H], device=att.device)
            att = att / torch.clamp(mult, min=1).float().reshape(g.B, g.H, 1, 1)
        a = torch.einsum("bshe,hed->bsd", att[:, :, 0].reshape(g.B, 1, g.H, g.hd),
                         p["attn"]["wo"])
        h2 = h[:g.B].view(g.B, 1, g.d) + s * a
        hn2 = rms_norm(h2, p["mlp_norm"], g.eps)
        m = swiglu(hn2, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
        h_out[:g.B] = (h2 + s * m)[:, 0]
        if g.Lp:
            attp = b["attp"][lyr]
            if divide:
                base = g.pre_att_base + lyr * g.n_flash_l
                mult = torch.tensor(self.mult[base:base + g.n_flash_l], device=att.device)
                divf = torch.repeat_interleave(
                    torch.clamp(mult, min=1).float().reshape(g.H, g.nq_p), g.bq_p, dim=1)
                attp = attp / divf[None, :, :, None]
            of = attp.transpose(1, 2)[:, :g.Lp]
            ap = torch.einsum("bshe,hed->bsd", of, p["attn"]["wo"])
            hp2 = h[g.B:].view(1, g.Lp, g.d) + s * ap
            hnp2 = rms_norm(hp2, p["mlp_norm"], g.eps)
            mp = swiglu(hnp2, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
            h_out[g.B:] = (hp2 + s * mp)[0]

    def logits(self):
        g, b, cfg = self.g, self.b, self.cfg
        w_un = _unembed_matrix(self.params, cfg)
        h = b["h"][g.L % 2]
        hf = rms_norm(h[:g.B].view(g.B, 1, g.d), self.params["final_norm"], g.eps)
        lg = torch.einsum("bsd,dv->bsv", hf, w_un)[:, 0]
        b["logits"][:] = _mask_pad_vocab(lg.float(), cfg)
        if g.Lp:
            hpf = rms_norm(h[g.B:].view(1, g.Lp, g.d), self.params["final_norm"], g.eps)
            lp = torch.einsum("bd,dv->bv", hpf[:, -1], w_un)
            b["logp"][:] = _mask_pad_vocab(lp.float(), cfg)


# ---------------------------------------------------------------------------
# the step


def _check_inputs(params, caches: Caches, tokens, ptok, g: Geometry) -> None:
    dev = tokens.device
    for name, t in (("kc", caches.kv.k), ("vc", caches.kv.v)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev
                or tuple(t.shape) != (g.L, g.B, g.cap, g.Hkv, g.hd)):
            raise ValueError(f"{name} must be contiguous float32 {(g.L, g.B, g.cap, g.Hkv, g.hd)} "
                             f"on {dev}: {t.dtype} {tuple(t.shape)} on {t.device}")
    V = params["embed"].shape[0]
    for name, t in (("tokens", tokens), ("prefill_tokens", ptok)):
        if t is not None and t.numel() and (int(t.min()) < 0 or int(t.max()) >= V):
            raise ValueError(f"{name} out of range [0, {V})")


@dataclass
class StepPlan:
    """Everything one step's launches read: its geometry, buffers, inputs
    and the staged Put."""

    g: Geometry
    bufs: Dict[str, torch.Tensor]
    inputs: Dict[str, torch.Tensor]
    state: QueueState
    stage_open: np.ndarray
    rounds: int


def plan_step(params, cfg, caches: Caches, tokens, pos, *, prefill_tokens=None, bk: int = 64,
              bq: int = 32, n_programs: int = 8) -> StepPlan:
    """Check one step's inputs and build its buffers and stage-gated Put."""
    check_ported(cfg)
    dev = caches.kv.k.device
    tokens = torch.as_tensor(tokens).to(dev).reshape(-1).long()
    B = tokens.shape[0]
    pos_h = attn.host_lengths(pos, B) - 1
    ptok = None
    if prefill_tokens is not None:
        ptok = torch.as_tensor(prefill_tokens).to(dev)
        if ptok.ndim != 2 or ptok.shape[0] != 1:
            raise ValueError(f"prefill_tokens must be [1, Lp]: {tuple(ptok.shape)}")
        ptok = ptok[0].long()
    Lp = 0 if ptok is None else int(ptok.shape[0])
    g = geometry(params, cfg, caches, B, Lp, bk=bk, bq=bq)
    if not 0 <= Lp <= g.cap or int(pos_h.max(initial=0)) >= g.cap:
        raise ValueError(f"prompt length {Lp} or positions {pos_h.tolist()} do not fit "
                         f"capacity {g.cap}")
    _check_inputs(params, caches, tokens, ptok, g)
    state, stage_open, rounds = staged_queues(g, pos_h + 1, n_programs)
    assert state.n_tasks == g.n_tasks, (state.n_tasks, g.n_tasks)
    inputs = {"tokens": tokens, "pos": torch.as_tensor(pos_h, dtype=torch.int64, device=dev)}
    if Lp:
        inputs.update(ptok=ptok, pos_p=_positions(1, Lp, device=dev))
    return StepPlan(g, alloc_buffers(g, caches, dev), inputs, state, stage_open, rounds)


def decode_step_unified(params, cfg, caches: Caches, tokens, pos, *, prefill_tokens=None,
                        bk: int = 64, bq: int = 32, bt: int = 8, n_programs: int = 8,
                        steal: bool = True, steal_policy: str = "cost",
                        trace: bool = False, check: bool = True, mode: Optional[str] = None):
    """One engine step as one unified launch (lockstep, the default) or one
    launch per stage (``mode="free"``).

    ``tokens`` [B, 1] ints, ``pos`` scalar or [B] ints (host values: the Put
    needs the live lengths ``pos + 1``).  ``prefill_tokens`` [1, Lp] folds
    one prompt's prefill into the same step.  Returns ``(logits [B, Vp]
    fp32, caches, UnifiedStepReport)``; the caches are updated in place
    (the new row of every slot), and the report carries the prompt's
    last-token logits and its ``[L, 1, cap, Hkv, hd]`` k/v.  ``bt`` sizes the
    expert tiles of the MoE half and is unused here.

    CUDA tensors launch ``csrc/ws_unified.cu``; CPU tensors run the plain
    version.  There is no fallback between the two.
    """
    return _decode_step(params, cfg, caches, tokens, pos, prefill_tokens=prefill_tokens,
                        bk=bk, bq=bq, bt=bt, n_programs=n_programs, steal=steal,
                        steal_policy=steal_policy, trace=trace, check=check, mode=mode,
                        plain=caches.kv.k.device.type == "cpu")


def plain_decode_step_unified(params, cfg, caches: Caches, tokens, pos, **kw):
    """The plain PyTorch version of :func:`decode_step_unified` on any
    device: the scheduler walk on the host, the tiles and glue phases as
    torch ops on the tensors' device."""
    return _decode_step(params, cfg, caches, tokens, pos, plain=True, **kw)


def _decode_step(params, cfg, caches, tokens, pos, *, prefill_tokens=None, bk=64, bq=32,
                 bt=8, n_programs=8, steal=True, steal_policy="cost", trace=False, check=True,
                 mode=None, plain: bool):
    if trace:
        raise NotImplementedError("trace=True needs the trace rings, which are not ported "
                                  "yet (tracing and chaos slice)")
    mode = "lockstep" if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    scheduler_knobs(steal=steal, steal_policy=steal_policy, steal_run_cap=1, mode=mode,
                    compress_runs=False)
    plan = plan_step(params, cfg, caches, tokens, pos, prefill_tokens=prefill_tokens, bk=bk,
                     bq=bq, n_programs=n_programs)
    res, launches = run_step(params, cfg, plan, mode=mode, steal=steal,
                             steal_policy=steal_policy, n_programs=n_programs, plain=plain)
    g, bufs = plan.g, plan.bufs
    if check:
        _check_drained(g.n_tasks, res)
    report = UnifiedStepReport(
        res=res, state=plan.state, stage_open=plan.stage_open, rounds=plan.rounds,
        n_tasks=g.n_tasks, prefill_logits=bufs.get("logp"),
        prefill_kv=attn.KVCache(bufs["kp"], bufs["vp"]) if g.Lp else None,
        tid_bases=tid_bases(g), launches=launches)
    return bufs["logits"], caches, report


def run_step(params, cfg, plan: StepPlan, *, mode, steal, steal_policy, n_programs,
             stages=None, mult=None, plain=None):
    """Launch a planned step: one stage-gated launch in lockstep, one launch
    per stage in free mode (``stages`` picks which, ``mult`` is carried in;
    each launch copies the Put afresh, so relaunching a stage rewinds it).
    The kernel for CUDA buffers, the plain version for CPU buffers (or on
    any device with ``plain=True``).  Returns ``(WSRunResult, launches)``."""
    g, bufs = plan.g, plan.bufs
    out = bufs["logits"]
    plain = out.device.type == "cpu" if plain is None else plain

    def walk(arrs, **kw):
        return _UnifiedWalk(arrs, params, cfg, g, bufs, plan.inputs, **kw)

    def launch(arrs, **kw):
        from ..pallas_ws import unified_kernel

        unified_kernel.launch_cuda(arrs, params, g, bufs, plan.inputs, **kw)

    kw = dict(walk=walk, launch=launch, plain=plain, compress=False, steal=steal,
              steal_policy=steal_policy)
    if mode == "lockstep":
        res = launch_grid(plan.state, out, mode="lockstep", rounds=plan.rounds, mult=mult,
                          stage_open=plan.stage_open, **kw)
        return res, 1
    n_stages = plan.state.n_queues // n_programs
    runs = []
    for s in range(n_stages) if stages is None else stages:
        r = launch_grid(stage_state(plan.state, s, n_programs, g.n_tasks), out, mode="free",
                        rounds=None, mult=mult, **kw)
        mult = r.mult
        runs.append(r)
    return _merge(runs, out), len(runs)


def _merge(runs, out) -> WSRunResult:
    """One result of per-stage launches: queue arrays concatenated in stage
    order, per-program counters summed, the last carried ``mult``."""
    def cat(name, dim=0):
        return torch.cat([getattr(r, name) for r in runs], dim=dim)

    def add(name):
        return torch.stack([getattr(r, name) for r in runs]).sum(0, dtype=torch.int32)

    return WSRunResult(out=out, head=cat("head"), local_head=cat("local_head", 1),
                       taken=cat("taken"), remaining=cat("remaining"), clock=add("clock"),
                       work=add("work"), steals=add("steals"), scanned=add("scanned"),
                       mult=runs[-1].mult, mode="free")
