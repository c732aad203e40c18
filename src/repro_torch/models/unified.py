"""One engine step as one launch: the unified mixed-mode step (port of
``repro/models/unified.py``).

An engine step — one decode token for every live slot and, optionally, one
folded-in prompt's prefill — runs as ONE launch of the work-stealing
megakernel over stage-gated queues (:func:`make_staged_queue_state`) that
mix three task families:

* attention — decode tiles (one ``(b, h)`` query row over its live kv
  range) and causal prefill flash tiles, the records ``emit_decode_tasks``
  and ``emit_flash_tasks`` build;
* expert (MoE layers) — shared-pool expert-FFN tiles per layer and segment
  (decode batch, folded prompt).  A record ``(OP_EXPERT_TILE, layer, seg,
  j, ⊥, ⊥, tid, bt)`` names pool tile ``j``; its expert ``e[j]`` and live
  rows ``rl[j]`` are read from the routing buffers the post-attention glue
  wrote, and its rows are ``[j·bt, (j+1)·bt)`` of the segment's pool;
* step glue — the phases between them (``GLUE_*`` below): embed; per layer
  norm, q/k/v, RoPE and the cache splice; the multiplicity-normalised
  combine, ``wo``, the residual and norm, then the SwiGLU MLP and residual
  (dense) or the router and the shared-pool Put (MoE); the expert combine,
  shared experts and residual (MoE); the final norm and unembedding.

Stage ``s``'s queues open at round ``stage_open[s]``, the prefix sums of the
stages' Graham bounds, so every task of a stage has finished before the next
stage's queues open: the dependencies are an input of the launch, not a wait
on the device.  The kernel is ``csrc/ws_unified.cu``
(:mod:`repro_torch.pallas_ws.unified_kernel`); :class:`_UnifiedWalk` is its
plain PyTorch version, taken for CPU tensors only.

Two modes.
* ``mode="lockstep"`` (the default) is the reference's launch: one CTA,
  the walker, walks the ``(rounds, P)`` grid, the stage gate read each
  round, the whole step ONE launch; every integer array ends bit-equal to
  the plain walk.  Attention tiles accumulate, and the glue divides them by
  ``mult``.  The walker hands every weight product to ``helpers`` CTAs
  launched beside it (one an SM by default), each computing its own column
  strips, through tagged 64-bit words that carry their own validity: no
  fence, and the walk itself unchanged (``csrc/ws_unified.cu``).
* ``mode="free"`` cannot be one launch: stage windows are counted in
  rounds, and free CTAs have none: a stage is done only once every CTA's
  claims of it are, which no CTA can see without a count across CTAs (an
  atomic) or a wait on every other CTA.  So free mode runs one launch per
  stage (2 + 3L launches a step, 86 for llama3.2-3b; 2 + 5L on a MoE model)
  of the same kernel over only that stage's queues, every product computed
  in the CTA that claims it; the kernel boundaries on the stream order the
  stages, and each launch carries the summed ``mult`` of the ones before.
  Tiles store whole tiles, so nothing is divided by ``mult``.

Free CTAs can claim one glue task several times at once, so a glue phase
never updates a buffer in place: the residual stream ping-pongs between
``h[0]`` and ``h[1]`` (layer ``l`` reads ``h[l % 2]`` and writes
``h[(l + 1) % 2]``; a MoE layer's post-attention glue leaves its residual
in ``h2``, which only it writes, and the expert combine adds to that), each
layer's attention and expert tiles write their own ``att[l]`` and
``yr[l]``, and every other write is a pure function of what earlier stages
wrote.  A duplicate then writes the bits the first execution wrote.

A pool tile with no live rows (``rl == 0``: the pool has ``ceil(T·k/bt) +
E`` tiles for any routing, most of them dead at decode) returns at once.
The reference's computes expert 0 and adds zeros: the same bits, without
reading that expert's weights.

The KV cache is read in place: decode tiles read the ``[L, B, cap, Hkv,
hd]`` cache through strides (the reference copies it into padded transposed
buffers), and the splice writes only each slot's new row, in place, as the
port's split decode step does.  A folded prompt's k/v land in the report's
``prefill_kv`` ``[L, 1, cap, Hkv, hd]``.

``trace=True`` records the event rings of the step.  In lockstep that is
one launch's rings, one stream holding every family's ops (the reference's
launch-count witness).  In free mode each stage launch has its rings, and
``res.events`` holds each program's records of every stage, its queues
numbered as in the step's Put and its rounds continued across stages on the
program's own clock.  The report's ``trace_stream`` is the decoded stream,
in free mode stage by stage.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..moe_ws.dispatch import route_to_tasks_pool_torch
from ..moe_ws.layer import _router, _shared_experts
from ..pallas_ws.kernel import (
    MODES,
    WSRunResult,
    _PlainWalk,
    attention_tile,
    launch_grid,
    scheduler_knobs,
)
from ..pallas_ws.queues import QueueState, make_staged_queue_state, to_device
from ..pallas_ws.ragged import _pad_to
from ..wstrace.ring import EV_QUEUE, EV_ROUND, EVENT_WIDTH, decode_rings
from ..pallas_ws.tasks import (
    BOTTOM,
    F_COST,
    F_E,
    F_LAYER,
    F_OP,
    F_PHASE,
    F_RL,
    F_RS,
    F_TID,
    OP_DECODE_TILE,
    OP_EXPERT_TILE,
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
GLUE_POST = 2     # attention combine (mult-normalised), wo, residual, mlp norm,
                  # then the dense MLP or the MoE router Put
GLUE_COMB = 3     # expert combine (mult-normalised), shared experts, residual
GLUE_LOGITS = 4   # final norm + unembed -> logits

GLUE_COST = 1  # glue phases are serial; the cost only sizes their stage window

SEG_DECODE = 0
SEG_PREFILL = 1


@dataclass(frozen=True)
class _UTask:
    """A pre-encoded record (the unified expert tiles):
    :func:`make_staged_queue_state` needs only ``.cost``, ``.owner`` and
    ``.encode()``; the operands are read in the tile from the routing
    buffers."""

    fields: Tuple[int, ...]
    owner: int

    @property
    def cost(self) -> int:
        return int(self.fields[F_COST])

    def encode(self) -> np.ndarray:
        return np.asarray(self.fields, dtype=np.int32)


def _expert_pool_tiles(n_tokens: int, top_k: int, n_experts: int, bt: int) -> int:
    """The shared-pool tile count that holds any routing of ``n_tokens·top_k``
    pairs (``route_to_tasks_pool_torch``): ``ceil(T·k / bt) + E``."""
    return -(-(n_tokens * top_k) // bt) + n_experts


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
    """Raise for a config the unified step does not cover."""
    if not unified_step_supported(cfg):
        raise ValueError(f"unified step unsupported for config {cfg.name!r}")


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
    # trace=True: the step's event stream (free mode: the stage launches'
    # streams in stage order), [n_events, EVENT_WIDTH] int32
    trace_stream: Optional[np.ndarray] = None


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
    f: int          # the dense MLP's width, or the shared experts' (0 if none)
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
    # the MoE half (all 0 on a dense model)
    E: int = 0
    top_k: int = 0
    fe: int = 0          # an expert's hidden width
    bt: int = 8
    pool_dec: int = 0    # pool tiles of the decode segment
    pool_pre: int = 0    # and of the folded prompt
    exp_dec_base: int = 0
    exp_pre_base: int = 0

    @property
    def n_rows_dec(self) -> int:
        return self.pool_dec * self.bt

    @property
    def n_rows(self) -> int:
        """Routed rows of both segments: the decode pool's, then the prompt's."""
        return (self.pool_dec + self.pool_pre) * self.bt

    @property
    def R(self) -> int:
        """Rows of the residual stream: the decode batch, then the prompt."""
        return self.B + self.Lp

    def dec_layer(self, tid: int) -> int:
        return (tid - self.dec_att_base) // (self.B * self.H)

    def pre_layer(self, tid: int) -> int:
        return (tid - self.pre_att_base) // self.n_flash_l


def geometry(params, cfg, caches: Caches, B: int, Lp: int, *, bk: int, bq: int,
             bt: int = 8) -> Geometry:
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
    layers = params["layers"]
    if cfg.is_moe:
        E, k = cfg.n_experts, cfg.top_k
        f = layers["moe"]["ws_g"].shape[-1] if "ws_g" in layers["moe"] else 0
        fe = layers["moe"]["we_g"].shape[-1]
        pool_dec = _expert_pool_tiles(B, k, E, bt)
        pool_pre = _expert_pool_tiles(Lp, k, E, bt) if Lp else 0
    else:
        E = k = fe = pool_dec = pool_pre = 0
        f = layers["mlp"]["wg"].shape[-1]
    # tids: family-grouped blocks with a constant stride per layer
    dec_att_base = 2 + L * (3 if E else 2)
    pre_att_base = dec_att_base + L * B * H
    exp_dec_base = pre_att_base + L * n_flash_l
    exp_pre_base = exp_dec_base + L * pool_dec
    return Geometry(
        B=B, L=L, H=H, Hkv=Hkv, hd=cfg.hd, d=cfg.d_model, f=f, cap=cap,
        Vp=_unembed_matrix(params, cfg).shape[-1], vocab=cfg.vocab_size,
        bk_d=bk_d, Lp=Lp, bq_p=bq_p, bk_p=bk_p, nq_p=nq_p, Lp_pad=nq_p * bq_p,
        n_flash_l=n_flash_l, dec_att_base=dec_att_base, pre_att_base=pre_att_base,
        n_tasks=exp_pre_base + L * pool_pre, eps=cfg.norm_eps,
        theta=cfg.rope_theta, res_scale=tf._res_scale(cfg), E=E, top_k=k, fe=fe, bt=bt,
        pool_dec=pool_dec, pool_pre=pool_pre, exp_dec_base=exp_dec_base,
        exp_pre_base=exp_pre_base)


def tid_bases(g: Geometry) -> Dict[str, int]:
    """The reference's tid layout (the expert blocks are empty on a dense model)."""
    return {"glue": 0, "dec_att": g.dec_att_base, "pre_att": g.pre_att_base,
            "exp_dec": g.exp_dec_base, "exp_pre": g.exp_pre_base, "n_tasks": g.n_tasks}


def build_stages(g: Geometry, lengths, n_programs: int):
    """The reference's stage list: embed; per layer pre-glue, the attention
    tiles (decode, then the prompt's flash tiles), post-glue and, on a MoE
    model, the expert tiles (decode pool, then the prompt's) and the
    combine glue; logits.  Returns ``(state, stage_open, rounds)``."""
    tid = [0]

    def glue(phase, layer):
        t = StepGlueTask(phase, layer, BOTTOM, tid[0], GLUE_COST)
        tid[0] += 1
        return t

    def expert_tiles(lyr, seg, pool, base):
        base += lyr * pool
        return [_UTask((OP_EXPERT_TILE, lyr, seg, j, BOTTOM, BOTTOM, base + j, g.bt), owner=j)
                for j in range(pool)]

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
        if g.E:
            stages.append(expert_tiles(lyr, SEG_DECODE, g.pool_dec, g.exp_dec_base)
                          + expert_tiles(lyr, SEG_PREFILL, g.pool_pre, g.exp_pre_base))
            stages.append([glue(GLUE_COMB, lyr)])
    stages.append([glue(GLUE_LOGITS, 0)])
    assert tid[0] == g.dec_att_base, tid[0]  # the glue tids come first
    return make_staged_queue_state(stages, n_programs, partition="owner")


def staged_queues(g: Geometry, lengths, n_programs: int):
    """:func:`build_stages`, memoised by the reference's key."""
    key = (tuple(int(x) for x in lengths), g.Lp, g.B, g.L, g.H, g.bk_d, g.bq_p, g.bk_p,
           g.bt, n_programs, g.E, g.top_k, g.pool_dec, g.pool_pre)
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
    in place); the rest are fresh.  A MoE model adds the routing buffers of
    both segments, each the decode segment's then the prompt's: the MoE
    input ``xf`` [R, d], the residual ``h2`` [R, d] the post-attention glue
    leaves for the combine, the pool rows' segment-local token ``tok`` and
    gate ``gate`` [n_rows], each pool tile's expert ``e`` and live rows
    ``rl`` [pool], and the expert tiles' rows ``yr`` [L, n_rows, d]."""
    f32 = torch.float32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

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
    if g.E:
        pools = g.pool_dec + g.pool_pre
        bufs.update(xf=z(g.R, g.d), h2=z(g.R, g.d), tok=z(g.n_rows, dtype=torch.int32),
                    gate=z(g.n_rows), e=z(pools, dtype=torch.int32),
                    rl=z(pools, dtype=torch.int32), yr=z(g.L, g.n_rows, g.d))
    return bufs


# ---------------------------------------------------------------------------
# plain version


class _UnifiedWalk(_PlainWalk):
    """The plain version of ``csrc/ws_unified.cu``: the shared scheduler walk
    with the attention tile body (decode and flash), the expert tile and the
    glue phases as torch ops on the buffers' device, in the same buffers and
    walk order.  Its MoE ops are the split step's (``moe_ffn_ws``: the same
    router, expert tile, ``index_add_`` combine and shared experts), so on
    the CPU the two steps agree bit for bit."""

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
        elif op == OP_EXPERT_TILE:
            self.expert_tile(rec[F_E], rec[F_RS], rec[F_RL], store=store)
        elif op == OP_STEP_GLUE:
            phase, lyr = rec[F_PHASE], rec[F_LAYER]
            if phase == GLUE_EMBED:
                self.embed()
            elif phase == GLUE_PRE:
                self.pre(lyr)
            elif phase == GLUE_POST:
                self.post(lyr, divide=not store)
            elif phase == GLUE_COMB:
                self.comb(lyr, divide=not store)
            elif phase == GLUE_LOGITS:
                self.logits()
            else:
                raise ValueError(f"glue phase {phase} is not in this unified step")
        else:
            raise ValueError(f"op {op} is not in the unified step")

    # -- the MoE half: segment views, expert tile, Put and combine -------------
    def segment(self, seg):
        """``(token rows of xf/h, pool-tile slice, routed-row slice, tokens,
        pool tiles, first tid of layer 0)`` of a segment."""
        g = self.g
        if seg == SEG_DECODE:
            return (slice(0, g.B), slice(0, g.pool_dec), slice(0, g.n_rows_dec), g.B,
                    g.pool_dec, g.exp_dec_base)
        return (slice(g.B, g.R), slice(g.pool_dec, None), slice(g.n_rows_dec, None), g.Lp,
                g.pool_pre, g.exp_pre_base)

    def expert_tile(self, lyr, seg, j, *, store):
        """Pool tile ``j`` of the segment: ``moe_ws``'s expert tile on rows
        ``[j·bt, (j+1)·bt)`` with the expert and live rows the Put wrote.  A
        tile with no live rows returns at once (it would add zeros)."""
        g, b = self.g, self.b
        toks, tiles, rows, *_ = self.segment(seg)
        e, rl = int(b["e"][tiles][j]), int(b["rl"][tiles][j])
        if rl == 0:
            return
        moe = self.params["layers"]["moe"]
        rs = j * g.bt
        xt = b["xf"][toks][b["tok"][rows][rs:rs + g.bt].long()]
        h = F.silu(xt @ moe["we_g"][lyr, e].float()) * (xt @ moe["we_u"][lyr, e].float())
        y = h @ moe["we_d"][lyr, e].float()
        y[rl:] = 0.0
        out = b["yr"][lyr, rows][rs:rs + g.bt]
        if store:
            out[:] = y
        else:
            out += y

    def route_put(self, lyr, seg):
        """The router and the shared-pool Put of the segment's ``xf`` rows
        into its routing buffers (dead tiles get expert 0)."""
        g, b = self.g, self.b
        toks, tiles, rows, *_ = self.segment(seg)
        p = tf.layer_params(self.params, lyr)["moe"]
        _, gate_vals, idx, _ = _router(b["xf"][toks], p, self.cfg, 1024)
        records, _, _, routed = route_to_tasks_pool_torch(idx, gate_vals, g.E, bt=g.bt)
        b["tok"][rows] = routed.tok_idx
        b["gate"][rows] = routed.gates
        b["e"][tiles] = torch.clamp(records[:, F_E], 0, g.E - 1)
        b["rl"][tiles] = records[:, F_RL]

    def comb(self, lyr, *, divide):
        """The expert combine of both segments (``combine_routed`` on the pool
        layout: rows divided by their tile's mult in lockstep, then
        ``gate × row`` added into the tokens), the shared experts, and the
        residual onto ``h2`` -> ``h[(l + 1) % 2]``."""
        g, b, s = self.g, self.b, self.g.res_scale
        p = tf.layer_params(self.params, lyr)["moe"]
        h_out = b["h"][(lyr + 1) % 2]
        for seg in (SEG_DECODE, SEG_PREFILL) if g.Lp else (SEG_DECODE,):
            toks, _, rows, T, pool, base = self.segment(seg)
            yr = b["yr"][lyr, rows]
            if divide:
                base += lyr * pool
                mult = torch.tensor(self.mult[base:base + pool], device=yr.device)
                yr = yr / torch.repeat_interleave(torch.clamp(mult, min=1).float(),
                                                  g.bt)[:, None]
            y = torch.zeros((T, g.d), dtype=torch.float32, device=yr.device).index_add_(
                0, b["tok"][rows].long(), b["gate"][rows][:, None] * yr)
            if "ws_g" in p:
                y = y + _shared_experts(b["xf"][toks], p).float()
            h_out[toks] = b["h2"][toks] + s * y

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
        if g.E:
            b["xf"][:g.B] = hn2[:, 0]
            self.route_put(lyr, SEG_DECODE)
            b["h2"][:g.B] = h2[:, 0]
        else:
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
            if g.E:
                b["xf"][g.B:] = hnp2[0]
                self.route_put(lyr, SEG_PREFILL)
                b["h2"][g.B:] = hp2[0]
            else:
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
    and the staged Put (on a card also uploaded once, ``device_queues``: a
    lockstep launch then clones its arrays on the device and the host never
    waits on a copy)."""

    g: Geometry
    bufs: Dict[str, torch.Tensor]
    inputs: Dict[str, torch.Tensor]
    state: QueueState
    stage_open: np.ndarray
    rounds: int
    device_queues: Optional[Tuple[QueueState, torch.Tensor]] = None


def plan_step(params, cfg, caches: Caches, tokens, pos, *, prefill_tokens=None, bk: int = 64,
              bq: int = 32, bt: int = 8, n_programs: int = 8) -> StepPlan:
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
    g = geometry(params, cfg, caches, B, Lp, bk=bk, bq=bq, bt=bt)
    if not 0 <= Lp <= g.cap or int(pos_h.max(initial=0)) >= g.cap:
        raise ValueError(f"prompt length {Lp} or positions {pos_h.tolist()} do not fit "
                         f"capacity {g.cap}")
    _check_inputs(params, caches, tokens, ptok, g)
    state, stage_open, rounds = staged_queues(g, pos_h + 1, n_programs)
    assert state.n_tasks == g.n_tasks, (state.n_tasks, g.n_tasks)
    inputs = {"tokens": tokens, "pos": torch.as_tensor(pos_h, dtype=torch.int64, device=dev)}
    if Lp:
        inputs.update(ptok=ptok, pos_p=_positions(1, Lp, device=dev))
    device_queues = None
    if dev.type == "cuda":
        device_queues = (to_device(state, dev),
                         torch.as_tensor(stage_open, dtype=torch.int32, device=dev))
    return StepPlan(g, alloc_buffers(g, caches, dev), inputs, state, stage_open, rounds,
                    device_queues)


def decode_step_unified(params, cfg, caches: Caches, tokens, pos, *, prefill_tokens=None,
                        bk: int = 64, bq: int = 32, bt: int = 8, n_programs: int = 8,
                        steal: bool = True, steal_policy: str = "cost",
                        trace: bool = False, check: bool = True, mode: Optional[str] = None,
                        helpers: Optional[int] = None):
    """One engine step as one unified launch (lockstep, the default) or one
    launch per stage (``mode="free"``).

    ``tokens`` [B, 1] ints, ``pos`` scalar or [B] ints (host values: the Put
    needs the live lengths ``pos + 1``).  ``prefill_tokens`` [1, Lp] folds
    one prompt's prefill into the same step.  Returns ``(logits [B, Vp]
    fp32, caches, UnifiedStepReport)``; the caches are updated in place
    (the new row of every slot), and the report carries the prompt's
    last-token logits and its ``[L, 1, cap, Hkv, hd]`` k/v.  ``bt`` is the
    expert tiles' height (MoE models).  ``helpers`` is the lockstep
    launch's helper CTAs (None: one an SM beside the walker's; 0: one CTA
    runs every product), which the plain version does not have; free mode
    takes none (:func:`~repro_torch.pallas_ws.unified_kernel.choose_helpers`).

    CUDA tensors launch ``csrc/ws_unified.cu``; CPU tensors run the plain
    version.  There is no fallback between the two.
    """
    return _decode_step(params, cfg, caches, tokens, pos, prefill_tokens=prefill_tokens,
                        bk=bk, bq=bq, bt=bt, n_programs=n_programs, steal=steal,
                        steal_policy=steal_policy, trace=trace, check=check, mode=mode,
                        helpers=helpers, plain=caches.kv.k.device.type == "cpu")


def plain_decode_step_unified(params, cfg, caches: Caches, tokens, pos, **kw):
    """The plain PyTorch version of :func:`decode_step_unified` on any
    device: the scheduler walk on the host, the tiles and glue phases as
    torch ops on the tensors' device."""
    return _decode_step(params, cfg, caches, tokens, pos, plain=True, **kw)


def _decode_step(params, cfg, caches, tokens, pos, *, prefill_tokens=None, bk=64, bq=32,
                 bt=8, n_programs=8, steal=True, steal_policy="cost", trace=False, check=True,
                 mode=None, helpers=None, plain: bool):
    from ..pallas_ws.unified_kernel import choose_helpers

    mode = "lockstep" if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    if mode == "free":
        choose_helpers(mode, helpers, 0)
    scheduler_knobs(steal=steal, steal_policy=steal_policy, steal_run_cap=1, mode=mode,
                    compress_runs=False)
    plan = plan_step(params, cfg, caches, tokens, pos, prefill_tokens=prefill_tokens, bk=bk,
                     bq=bq, bt=bt, n_programs=n_programs)
    res, launches = run_step(params, cfg, plan, mode=mode, steal=steal,
                             steal_policy=steal_policy, n_programs=n_programs, plain=plain,
                             trace=trace, helpers=helpers)
    g, bufs = plan.g, plan.bufs
    if check:
        _check_drained(g.n_tasks, res)
    report = UnifiedStepReport(
        res=res, state=plan.state, stage_open=plan.stage_open, rounds=plan.rounds,
        n_tasks=g.n_tasks, prefill_logits=bufs.get("logp"),
        prefill_kv=attn.KVCache(bufs["kp"], bufs["vp"]) if g.Lp else None,
        tid_bases=tid_bases(g), launches=launches,
        trace_stream=_step_stream(res, n_programs) if trace else None)
    return bufs["logits"], caches, report


def _step_stream(res: WSRunResult, n_programs: int) -> np.ndarray:
    """A traced step's decoded stream; in free mode the stages' events in
    stage order (stage ``s`` holds queues ``[s P, (s + 1) P)``)."""
    stream = decode_rings(res.events, res.ev_cursor)[0]
    if res.mode == "free":
        stream = stream[np.argsort(stream[:, EV_QUEUE] // n_programs, kind="stable")]
    return stream


def run_step(params, cfg, plan: StepPlan, *, mode, steal, steal_policy, n_programs,
             stages=None, mult=None, plain=None, trace=False, helpers=None):
    """Launch a planned step: one stage-gated launch in lockstep, one launch
    per stage in free mode (``stages`` picks which, ``mult`` is carried in;
    each launch copies the Put afresh, so relaunching a stage rewinds it).
    The kernel for CUDA buffers, the plain version for CPU buffers (or on
    any device with ``plain=True``).  ``trace`` records every launch's
    rings (module docstring); ``helpers`` is the kernel's lockstep helper
    CTAs.  Returns ``(WSRunResult, launches)``."""
    g, bufs = plan.g, plan.bufs
    out = bufs["logits"]
    plain = out.device.type == "cpu" if plain is None else plain

    def walk(arrs, **kw):
        return _UnifiedWalk(arrs, params, cfg, g, bufs, plan.inputs, **kw)

    def launch(arrs, **kw):
        from ..pallas_ws import unified_kernel

        unified_kernel.launch_cuda(arrs, params, g, bufs, plan.inputs, helpers=helpers, **kw)

    kw = dict(walk=walk, launch=launch, plain=plain, compress=False, steal=steal,
              steal_policy=steal_policy, trace=trace)
    if mode == "lockstep":
        state, stage_open = plan.state, plan.stage_open
        if not plain and plan.device_queues is not None:
            state, stage_open = plan.device_queues
        res = launch_grid(state, out, mode="lockstep", rounds=plan.rounds, mult=mult,
                          stage_open=stage_open, **kw)
        return res, 1
    n_stages = plan.state.n_queues // n_programs
    runs = []
    stage_ids = range(n_stages) if stages is None else stages
    for s in stage_ids:
        r = launch_grid(stage_state(plan.state, s, n_programs, g.n_tasks), out, mode="free",
                        rounds=None, mult=mult, **kw)
        mult = r.mult
        runs.append(r)
    res = _merge(runs, out)
    if trace:
        _merge_rings(res, runs, [s * n_programs for s in stage_ids])
    return res, len(runs)


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


def _merge_rings(res: WSRunResult, runs, queue_base) -> None:
    """The rings of per-stage free launches as one result's: each stage's
    queues renumbered from its first queue in the step's Put, and each
    program's records in stage order with their rounds continued from its
    clock at the end of the stage before (so ``[round, round + cost)``
    stays within its merged clock).  The default ring capacity never drops
    a record, so every stage's rows are whole."""
    P = res.clock.shape[0]
    rows = [[] for _ in range(P)]
    start = np.zeros(P, dtype=np.int64)
    for r, base in zip(runs, queue_base):
        ev, cur = r.events.cpu().numpy().copy(), r.ev_cursor.cpu().numpy()
        ev[..., EV_QUEUE] += base
        for p in range(P):
            n = min(int(cur[p]), ev.shape[1])
            mine = ev[p, :n].copy()
            mine[:, EV_ROUND] += start[p]
            rows[p].append(mine)
        start += r.clock.cpu().numpy()
    rows = [np.concatenate(x) if x else np.zeros((0, EVENT_WIDTH), np.int32) for x in rows]
    cap = max(1, max(len(x) for x in rows))
    events = np.full((P, cap, EVENT_WIDTH), -1, dtype=np.int32)
    for p, x in enumerate(rows):
        events[p, :len(x)] = x
    dev = res.clock.device
    res.events = torch.from_numpy(events).to(dev)
    res.ev_cursor = torch.tensor([len(x) for x in rows], dtype=torch.int32, device=dev)
