"""Continuous-batching serving engine + work-stealing request frontend
(port of ``repro/serving/engine.py``).

* ContinuousBatcher — a fixed pool of B decode slots over stacked KV
  caches.  Admitting a request runs a batch-1 prefill and splices its caches
  into the slot; every engine step decodes all live slots in one decode
  step — by default :func:`decode_step_ws`, whose per-layer attention is one
  launch of the fence-free work-stealing megakernel over the slots' ragged
  lengths; ``use_ws=False`` runs the dense :func:`decode_step`.  With
  ``jit_ws=True`` the ws step is :func:`jit_decode_step_ws`, the stand-in
  for the reference's ``jax.jit``: every Put built on the device, the whole
  step captured once per (slot count, capacity) shape into a CUDA graph and
  replayed, the step's one drain read after the logits.  With
  ``unified_step=True`` (fp32 configs, dense or MoE with the ws dispatch) an
  engine step is ONE launch of the unified megakernel
  (:func:`decode_step_unified`), and admission defers
  a prompt's prefill into the next step's launch.  A watchdog guards that
  launch: a step whose logits come back non-finite is redone on the split
  path, and a step past ``step_deadline_s`` sends the next
  ``watchdog_cooldown`` steps straight to the split path;
  ``fault_plan`` (:class:`repro_torch.chaos.EngineFaultPlan`) poisons or
  slows chosen steps so both trips can be drilled.  MLA decoders
  (deepseek-v2) and the ssm and hybrid stacks decode on the dense step;
  every cache of the slot (kv or the MLA latent and rope key, SSM state and
  conv inputs, the hybrid's shared kv) is spliced on admission.  Prompts are
  tokens only, as in the reference: the encdec and vlm families, whose
  prefill needs frames or patches, raise ``NotImplementedError``.
* WorkStealingFrontend — per-replica request queues implemented with the
  literal WS-WMULT algorithm (paper Fig. 7).  Each replica Takes from its
  own queue and Steals from the others when idle; a request admitted twice
  under weak multiplicity is deduplicated on completion.  A
  :class:`repro_torch.chaos.ReplicaCrashPlan` kills replicas at chosen
  iterations: the dead replica's in-flight requests resume on the
  survivors (prompt plus the tokens already emitted, the remaining budget),
  and its queue stays stealable.

* :func:`ragged_slot_attention` — decode attention over a batcher's
  ragged slots (or a length vector) on the work-stealing megakernel.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import EMPTY, WSWMult
from repro_torch.models import (
    Caches,
    decode_step,
    decode_step_unified,
    decode_step_ws,
    init_caches,
    prefill,
    ws_decode_supported,
)
from repro_torch.models.model import cache_tensors
from repro_torch.models.unified import check_ported
from repro_torch.pallas_ws.kernel import DrainCounter
from repro_torch.wstrace.metrics import SchedulerMetrics


class CapturedWSStep:
    """The stand-in for the reference's ``jit(decode_step_ws)``: the whole
    ws decode step with its Puts built on the device
    (:func:`~repro_torch.models.decode_step_ws` with a tensor ``pos``), run
    as one CUDA graph.

    On CUDA the first call for a (slot count, caches, params) key runs the
    step eagerly from static buffers (it builds the kernels, and its logits
    are that call's answer), then captures the same step into a
    ``torch.cuda.CUDAGraph``; later calls copy ``tokens`` and ``pos`` into
    the static buffers (through pinned host buffers, so nothing waits) and
    replay.  The graph writes the caches it was captured on in place, so an
    admission spliced into them between replays is seen; other caches or
    params capture anew.  A capture that fails raises: the card never falls
    back to the eager step.  On the CPU every call runs the device-Put step
    eagerly.

    Each call leaves the step's drain counts on the device; the caller reads
    them once, after the logits, with :meth:`check_drained` (a call whose
    counts were not read reads them first).  Host launch counters advance
    at capture only, so each replay adds the launches the capture recorded.
    """

    def __init__(self, cfg, *, schedule: str = "ws", bk: int = 64, n_programs: int = 8,
                 mode=None):
        self.cfg = cfg
        self._kw = dict(schedule=schedule, bk=bk, n_programs=n_programs, mode=mode)
        self._key = None
        self._graph = None
        self._drain = None
        self._unread = False
        self._per_replay = []

    def __call__(self, params, caches, tokens, pos):
        """``tokens`` [B, 1], ``pos`` [B] or a scalar (numpy or tensors).
        Returns ``(logits [B, V] fp32, caches)``, the caches written in place."""
        if self._unread:
            self.check_drained()
        dev = caches.kv.k.device
        B = caches.kv.k.shape[1]
        if dev.type != "cuda":
            self._drain = DrainCounter(dev)
            logits, caches = decode_step_ws(
                params, self.cfg, caches, _staged(tokens, (B, 1)).to(dev),
                _staged(pos, (B,)).to(dev), drain=self._drain, **self._kw)
        else:
            key = (B, caches.kv.k.data_ptr(), caches.kv.v.data_ptr(), id(params))
            if key != self._key:
                logits = self._capture(params, caches, tokens, pos, key)
            else:
                self._load(tokens, pos)
                self._graph.replay()
                for counters, name, n in self._per_replay:
                    counters[name] += n
                logits = self._logits.clone()
        self._unread = True
        return logits, caches

    def check_drained(self) -> None:
        """The step's one drain read: raise ``RuntimeError`` if a live task
        of any of its launches never ran."""
        self._unread = False
        if self._drain is not None:
            self._drain.check()

    def _load(self, tokens, pos) -> None:
        for dst, host, src in ((self._tok, self._tok_host, tokens),
                               (self._pos, self._pos_host, pos)):
            src = _staged(src, tuple(dst.shape))
            if src.device.type == "cuda":
                dst.copy_(src)
            else:
                host.copy_(src)
                dst.copy_(host, non_blocking=True)

    def _capture(self, params, caches, tokens, pos, key):
        from repro_torch import kernels
        from repro_torch.pallas_ws import kernel

        dev = caches.kv.k.device
        B = key[0]
        self._graph = self._key = None  # release the last graph first
        self._tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._tok_host = torch.zeros((B, 1), dtype=torch.int64, pin_memory=True)
        self._pos_host = torch.zeros((B,), dtype=torch.int64, pin_memory=True)
        self._drain = DrainCounter(dev)
        self._load(tokens, pos)

        def step():
            self._drain.reset()
            return decode_step_ws(params, self.cfg, caches, self._tok, self._pos,
                                  drain=self._drain, **self._kw)[0]

        logits = step()  # builds the kernels; this call's answer
        counters = (kernel.launches, kernels.launches)
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._logits = step()
        # the capture launched nothing: count its launches at each replay
        self._per_replay = [(c, n, c[n] - b[n]) for c, b in zip(counters, before)
                            for n in c if c[n] != b[n]]
        for c, b in zip(counters, before):
            c.update(b)
        self._graph, self._key = graph, key
        return logits


def _staged(a, shape) -> torch.Tensor:
    """Host ints (numpy, a list, a scalar or a tensor) as an int64 tensor of
    ``shape``; a scalar or [1] ``pos`` is every slot's."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    t = t.to(torch.int64)
    return t.reshape(-1).expand(shape[0]).reshape(shape) if t.numel() == 1 else t.reshape(shape)


def jit_decode_step_ws(cfg, *, schedule: str = "ws", bk: int = 64, n_programs: int = 8,
                       mode=None):
    """The compiled ws decode step (the reference's ``jax.jit`` over
    ``decode_step_ws``, one compilation per (slot count, capacity) shape):
    a :class:`CapturedWSStep`, called as ``step(params, caches, tokens,
    pos)`` and read with ``step.check_drained()`` after the logits.
    ``mode`` is the kernels' (free by default, or ``"lockstep"``)."""
    return CapturedWSStep(cfg, schedule=schedule, bk=bk, n_programs=n_programs, mode=mode)


@dataclass
class Request:
    rid: int
    tokens: np.ndarray  # [T] int32 prompt
    max_new: int = 16
    out: List[int] = field(default_factory=list)


class ContinuousBatcher:
    def __init__(
        self,
        params,
        cfg,
        *,
        slots: int,
        capacity: int,
        greedy: bool = True,
        temperature: float = 1.0,
        sample_seed: int = 0,
        attn_schedule: str = "ws",
        use_ws: bool = True,
        jit_ws: bool = False,
        unified_step: bool = False,
        step_deadline_s: Optional[float] = None,
        watchdog_cooldown: int = 1,
        fault_plan=None,
    ):
        if cfg.family in ("encdec", "vlm"):
            # the reference's engine admits token-only prompts and its
            # prefill then fails on the missing batch key; say so up front
            need = "frames" if cfg.family == "encdec" else "patches"
            raise NotImplementedError(
                f"ContinuousBatcher admits token-only prompts, as the reference's engine "
                f"does: {cfg.name} ({cfg.family}) prefills with {need!r} beside the tokens; "
                f"call prefill and decode_step directly")
        if unified_step:
            check_ported(cfg)
        if attn_schedule not in ("ws", "static"):
            raise ValueError(f"attn_schedule must be 'ws' or 'static': {attn_schedule!r}")
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.B, self.cap = slots, capacity
        self.caches = init_caches(cfg, slots, capacity, device=self.device)
        self.live: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, dtype=np.int32)  # next write slot per seq
        self.budget = np.zeros(slots, dtype=np.int32)
        self.greedy = greedy
        self.temperature = float(temperature)
        self._rng = np.random.default_rng(sample_seed)
        self.attn_schedule = attn_schedule
        self.use_ws = bool(use_ws and ws_decode_supported(cfg))
        # jit_ws: the ws step captured on the card, its Puts on the device
        self._jit = (jit_decode_step_ws(cfg, schedule=attn_schedule)
                     if self.use_ws and jit_ws else None)
        self.metrics = SchedulerMetrics(slots=slots)
        # unified mode: admit() defers a prompt's prefill into the next step's
        # launch.  The watchdog: a step whose logits come back non-finite is
        # redone on the split path; a step past `step_deadline_s` sends the
        # next `watchdog_cooldown` steps to the split path; `fault_plan` (an
        # EngineFaultPlan) poisons or slows chosen steps.  degradations
        # records each trip.
        self.unified = bool(unified_step)
        self._pending = deque()          # (slot, Request) awaiting prefill
        self._pending_slots: set = set()
        self.step_deadline_s = step_deadline_s
        self.watchdog_cooldown = int(watchdog_cooldown)
        self.fault_plan = fault_plan
        self.degradations: List[dict] = []
        self._step_idx = 0
        self._degraded_until = -1

    def _decode_next(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step of every slot from host ``tokens`` [B, 1]: the next
        token of each row.  The jit step's drain counts are read once, after
        the logits."""
        pos = self.pos.copy()
        if self._jit is not None:
            logits, self.caches = self._jit(self.params, self.caches, tokens, pos)
        else:
            tok = torch.from_numpy(tokens).to(self.device)
            if self.use_ws:
                logits, self.caches = decode_step_ws(self.params, self.cfg, self.caches, tok,
                                                     pos, schedule=self.attn_schedule)
            else:
                logits, self.caches = decode_step(self.params, self.cfg, self.caches, tok, pos)
        nxt = self._select(logits)  # syncs the device step
        if self._jit is not None:
            self._jit.check_drained()
        return nxt

    # -- sampling --------------------------------------------------------------
    def _select(self, logits) -> np.ndarray:
        """Next token per row: argmax, or seeded temperature sampling."""
        lg = logits.float().cpu().numpy() if isinstance(logits, torch.Tensor) \
            else np.asarray(logits, dtype=np.float32)
        if self.greedy:
            return lg.argmax(axis=-1)
        z = lg / max(self.temperature, 1e-6)
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        return np.array(
            [self._rng.choice(p.shape[-1], p=row) for row in p], dtype=np.int64
        )

    # -- admission ------------------------------------------------------------
    def _splice_slot(self, slot: int, c1) -> None:
        """Copy batch-1 prefill caches into the slot's batch row: every
        tensor of the Caches (kv, SSM state and conv inputs, shared kv)."""
        for full, one in zip(cache_tensors(self.caches), cache_tensors(c1)):
            full[:, slot] = one[:, 0]

    def admit(self, req: Request) -> bool:
        # a prompt of capacity-1 tokens is the longest a slot can hold: the
        # splice needs len(tokens) rows plus one for the first generated token
        if not 0 < len(req.tokens) < self.cap:
            return False
        free = [i for i, r in enumerate(self.live)
                if r is None and i not in self._pending_slots]
        if not free:
            return False
        slot = free[0]
        if self.unified:
            # the prefill rides the next step's launch beside the decode tiles
            self.live[slot] = req
            self._pending.append((slot, req))
            self._pending_slots.add(slot)
            self.pos[slot] = 0
            self.budget[slot] = req.max_new
            self.metrics.record_admission()
            return True
        self._prefill_into(slot, req)
        self.live[slot] = req
        self.metrics.record_admission()
        return True

    def _prompt(self, req: Request):
        return torch.as_tensor(np.asarray(req.tokens), dtype=torch.int64,
                               device=self.device)[None, :]

    def _prefill_into(self, slot: int, req: Request) -> None:
        """Standalone batch-1 prefill of ``req`` spliced into ``slot``, and
        its first token."""
        logits, c1 = prefill(self.params, self.cfg, {"tokens": self._prompt(req)},
                             capacity=self.cap)
        self._first_token(slot, req, c1, logits)

    def _first_token(self, slot: int, req: Request, c1, logits) -> None:
        self._splice_slot(slot, c1)
        req.out.append(int(self._select(logits[:1])[0]))
        self.pos[slot] = len(req.tokens)
        self.budget[slot] = req.max_new - 1

    # -- one engine iteration ---------------------------------------------------
    def step(self) -> List[Request]:
        if not any(r is not None for r in self.live):
            return []
        if self.unified:
            return self._step_unified()
        n_live = self.n_live
        t0 = time.perf_counter()
        tokens = np.zeros((self.B, 1), dtype=np.int64)
        for i, r in enumerate(self.live):
            if r is not None:
                tokens[i, 0] = r.out[-1]
        nxt = self._decode_next(tokens)
        self.metrics.record_step(time.perf_counter() - t0, n_live)
        done: List[Request] = []
        self._advance([i for i, r in enumerate(self.live) if r is not None], nxt, done)
        if done:
            self.metrics.record_completion(len(done))
        return done

    def _advance(self, slots, nxt, done: List[Request]) -> None:
        """Append each slot's next token; retire finished requests into ``done``."""
        for i in slots:
            self.live[i].out.append(int(nxt[i]))
            self.pos[i] += 1
            self.budget[i] -= 1
            self._retire(i, done)

    def _retire(self, slot: int, done: List[Request]) -> None:
        if self.budget[slot] <= 0 or self.pos[slot] >= self.cap - 1:
            done.append(self.live[slot])
            self.live[slot] = None

    def _degrade(self, step_idx: int, kind: str, detail: str) -> None:
        self.degradations.append(dict(step=step_idx, kind=kind, detail=detail))
        self.metrics.record_degradation(kind)

    def _step_unified(self) -> List[Request]:
        """One engine step = one unified launch: the live slots' decode
        tiles plus at most one pending admission's prefill tiles.  The
        watchdog: a step whose logits come back non-finite is discarded and
        redone on the split path (standalone prefill + decode step); a step
        whose observed time passes ``step_deadline_s`` sends the next
        ``watchdog_cooldown`` steps to the split path with no unified
        launch.  Each trip is recorded in ``degradations``."""
        fold = self._pending.popleft() if self._pending else None
        n_live = self.n_live
        t0 = time.perf_counter()
        step_idx = self._step_idx
        self._step_idx += 1
        done = None
        if step_idx >= self._degraded_until:
            done = self._try_unified(fold, step_idx)
        if done is None:
            done = self._step_split_fallback(fold)
        elapsed = time.perf_counter() - t0
        observed = elapsed
        if self.fault_plan is not None and self.fault_plan.slows(step_idx):
            observed += self.fault_plan.added_latency_s
        if (self.step_deadline_s is not None and observed > self.step_deadline_s
                and step_idx >= self._degraded_until):
            self._degrade(step_idx, "deadline",
                          f"step took {observed:.4f}s > {self.step_deadline_s:.4f}s; next "
                          f"{self.watchdog_cooldown} step(s) on split path")
            self._degraded_until = step_idx + 1 + self.watchdog_cooldown
        self.metrics.record_step(elapsed, n_live)
        if done:
            self.metrics.record_completion(len(done))
        return done

    def _try_unified(self, fold, step_idx: int) -> Optional[List[Request]]:
        """The unified launch and its bookkeeping; None (no token appended,
        no prefill installed) when its logits are non-finite, or poisoned by
        the fault plan.  The launch writes the caches in place, so a
        discarded step has already written one row a layer for each slot,
        at the slot's ``pos``; the split redo's decode step writes those same
        rows again (and a folded prompt's rows are spliced whole from the
        redo's own prefill), so nothing of the discarded launch survives."""
        tokens = np.zeros((self.B, 1), dtype=np.int64)
        for i, r in enumerate(self.live):
            if r is not None and r.out:
                tokens[i, 0] = r.out[-1]
        ptok = self._prompt(fold[1]) if fold is not None else None
        logits, self.caches, rep = decode_step_unified(
            self.params, self.cfg, self.caches, torch.from_numpy(tokens).to(self.device),
            self.pos.copy(), prefill_tokens=ptok)
        lg = logits.float().cpu().numpy()  # syncs the device step
        plg = rep.prefill_logits.float().cpu().numpy() if fold is not None else None
        if self.fault_plan is not None and self.fault_plan.poisons(step_idx):
            lg = np.full_like(lg, np.nan)
        if not np.isfinite(lg).all() or (plg is not None and not np.isfinite(plg).all()):
            self._degrade(step_idx, "non-finite",
                          "unified logits non-finite; redoing the step on the split path")
            return None
        done: List[Request] = []
        folded_slot = -1
        if fold is not None:
            slot, req = fold
            self._pending_slots.discard(slot)
            folded_slot = slot
            self._first_token(slot, req, Caches(kv=rep.prefill_kv), plg)
            self._retire(slot, done)
        # slots still awaiting their fold, and the slot folded this step,
        # produced no decode token in this launch
        self._advance([i for i, r in enumerate(self.live)
                       if r is not None and i not in self._pending_slots and i != folded_slot],
                      self._select(lg), done)
        return done

    def _step_split_fallback(self, fold) -> List[Request]:
        """The same admission and decode work as split launches: the
        standalone prefill, then the decode step of every decodable slot."""
        done: List[Request] = []
        folded_slot = -1
        if fold is not None:
            slot, req = fold
            self._pending_slots.discard(slot)
            folded_slot = slot
            self._prefill_into(slot, req)
            self._retire(slot, done)
        decodable = [i for i, r in enumerate(self.live)
                     if r is not None and r.out and i not in self._pending_slots
                     and i != folded_slot]
        if decodable:
            tokens = np.zeros((self.B, 1), dtype=np.int64)
            for i in decodable:
                tokens[i, 0] = self.live[i].out[-1]
            self._advance(decodable, self._decode_next(tokens), done)
        return done

    def stats(self) -> dict:
        return self.metrics.snapshot()

    @property
    def n_live(self) -> int:
        return sum(r is not None for r in self.live)

    def live_lengths(self) -> np.ndarray:
        """Per-slot KV lengths (0 for free slots): the ragged shape the ws
        attention path schedules over."""
        live = np.array([r is not None for r in self.live])
        return np.where(live, self.pos, 0).astype(np.int64)


def ragged_slot_attention(q, k_cache, v_cache, batcher_or_lengths, *, schedule=None, bk=64):
    """Decode attention over a continuous batcher's ragged slots on the
    work-stealing megakernel.

    ``q``: [B, H, hd] one query row a slot; ``k_cache``/``v_cache``: [B,
    Hkv, S, hd]; ``batcher_or_lengths``: a :class:`ContinuousBatcher` (its
    :meth:`~ContinuousBatcher.live_lengths`) or a [B] length vector (a
    tensor takes the device Put).  ``schedule=None`` follows the batcher's
    ``attn_schedule`` ("ws" for a bare length vector)."""
    from repro_torch.pallas_ws.ragged import ragged_decode_attention

    if isinstance(batcher_or_lengths, ContinuousBatcher):
        lengths = batcher_or_lengths.live_lengths()
        schedule = batcher_or_lengths.attn_schedule if schedule is None else schedule
    else:
        lengths = batcher_or_lengths
        schedule = "ws" if schedule is None else schedule
    return ragged_decode_attention(q, k_cache, v_cache, lengths, schedule=schedule, bk=bk)


class WorkStealingFrontend:
    """N engine replicas fed by WS-WMULT queues; idle replicas steal."""

    def __init__(self, make_batcher, n_replicas: int = 2, steal: bool = True,
                 max_admission_retries: int = 8, crash_plan=None):
        self.queues = [WSWMult(storage="linked", node_len=32) for _ in range(n_replicas)]
        self.batchers = [make_batcher() for _ in range(n_replicas)]
        self.steal = steal
        self.completed: Dict[int, Request] = {}
        # requests a batcher refused for cause, surfaced instead of dropped
        self.rejected: Dict[int, Request] = {}
        self.counters = {
            "admitted": 0, "stolen": 0, "dup_completed": 0, "rejected": 0,
            "gave_up": 0, "readmitted": 0, "crashed": 0,
        }
        # transient refusals back off exponentially (retry n waits
        # 2^min(n,6) iterations), then surface in `rejected`
        self.max_admission_retries = int(max_admission_retries)
        self._iter = 0
        self._backoff: List[List] = [[] for _ in range(n_replicas)]
        self._retries: Dict[int, int] = {}
        # crash plan (ReplicaCrashPlan): `_orig[rid]` keeps each request's
        # original prompt and budget, so a resumed copy (prompt ++ tokens so
        # far, the remaining budget) reassembles into the full stream on
        # completion; no token is emitted twice
        self.crash_plan = crash_plan
        self.dead: set = set()
        self._orig: Dict[int, tuple] = {}
        self.per_replica = [
            {"submitted": 0, "admitted": 0, "stolen": 0, "completed": 0, "rejected": 0}
            for _ in range(n_replicas)
        ]
        # rotating victim cursor per replica, so steal pressure spreads over
        # every victim instead of draining the lowest index first
        self._victim_rr = [0] * n_replicas
        self._lock = threading.Lock()

    def submit(self, replica: int, req: Request):
        self._orig.setdefault(req.rid, (np.asarray(req.tokens), req.max_new))
        self.per_replica[replica]["submitted"] += 1
        self.queues[replica].put(req)

    def _reassemble(self, r: Request) -> Request:
        """A resumed request's full stream: its prompt is the original plus
        the pre-crash emission, which goes back in front of this output."""
        orig = self._orig.get(r.rid)
        if orig is None:
            return r
        toks, max_new = orig
        if len(r.tokens) > len(toks):
            prev = [int(t) for t in np.asarray(r.tokens)[len(toks):]]
            return Request(r.rid, toks, max_new, prev + list(r.out))
        return r

    def _crash(self, rep: int) -> None:
        """Kill replica ``rep``: its engine's slots, caches and pending folds
        are lost; its queue survives and stays stealable.  Each in-flight
        request is readmitted to a survivor, keyed by rid and the tokens
        emitted so far; one whose budget was already spent completes."""
        b = self.batchers[rep]
        self.dead.add(rep)
        self.counters["crashed"] += 1
        survivors = [i for i in range(len(self.batchers)) if i not in self.dead]
        inflight, seen = [], set()
        for r in b.live:
            # pending unified folds are in b.live too; dedup by identity
            if r is not None and id(r) not in seen:
                seen.add(id(r))
                inflight.append(r)
        k = 0
        for r in inflight:
            with self._lock:
                if r.rid in self.completed:
                    continue
            emitted = list(self._reassemble(r).out)
            toks, max_new = self._orig.get(r.rid, (np.asarray(r.tokens), r.max_new))
            remaining = max_new - len(emitted)
            if remaining <= 0:
                # the crash landed on the completion boundary: complete it
                with self._lock:
                    if r.rid in self.completed:
                        self.counters["dup_completed"] += 1
                    else:
                        self.completed[r.rid] = Request(r.rid, toks, max_new, emitted)
                continue
            toks = np.asarray(toks)
            resume_tokens = (np.concatenate([toks, np.asarray(emitted, dtype=toks.dtype)])
                             if emitted else toks)
            tgt = survivors[k % len(survivors)] if survivors else rep
            k += 1
            self.counters["readmitted"] += 1
            self.per_replica[tgt]["submitted"] += 1
            self.queues[tgt].put(Request(r.rid, resume_tokens, remaining))

    def _next_request(self, replica: int) -> Optional[Request]:
        req = self.queues[replica].take()
        if req is not EMPTY:
            return req
        if self.steal and len(self.queues) > 1:
            victims = [v for v in range(len(self.queues)) if v != replica]
            start = self._victim_rr[replica] % len(victims)
            for j in range(len(victims)):
                v = victims[(start + j) % len(victims)]
                got = self.queues[v].steal(pid=1 + replica)
                if got is not EMPTY:
                    self._victim_rr[replica] = (start + j + 1) % len(victims)
                    self.counters["stolen"] += 1
                    self.per_replica[replica]["stolen"] += 1
                    return got
            self._victim_rr[replica] = (start + 1) % len(victims)
        return None

    def _reject(self, rep: int, req: Request, gave_up: bool) -> None:
        with self._lock:
            if req.rid not in self.rejected:
                self.rejected[req.rid] = req
        self.counters["rejected"] += 1
        if gave_up:
            self.counters["gave_up"] += 1
        self.per_replica[rep]["rejected"] += 1

    def run_iteration(self) -> bool:
        """One round-robin pass: fill free slots from the queues, then step
        every busy batcher.  True if anything happened."""
        worked = False
        it = self._iter
        self._iter += 1
        if self.crash_plan is not None:
            for rep in self.crash_plan.due(it):
                if rep not in self.dead and rep < len(self.batchers):
                    self._crash(rep)
                    worked = True
        for rep, parked in enumerate(self._backoff):
            due = [e for e in parked if e[0] <= it]
            if due:
                self._backoff[rep] = [e for e in parked if e[0] > it]
                for _, req in due:
                    self.queues[rep].put(req)
        for rep, b in enumerate(self.batchers):
            if rep in self.dead:
                continue
            while b.n_live < b.B:
                req = self._next_request(rep)
                if req is None:
                    break
                # idempotent admission: a stolen duplicate re-runs prefill
                if not b.admit(Request(req.rid, req.tokens, req.max_new)):
                    cap = getattr(b, "cap", None)
                    if cap is not None and not 0 < len(req.tokens) < cap:
                        self._reject(rep, req, gave_up=False)  # can never fit
                        worked = True
                        continue
                    n = self._retries.get(req.rid, 0) + 1
                    self._retries[req.rid] = n
                    if n > self.max_admission_retries:
                        self._reject(rep, req, gave_up=True)
                        worked = True
                        continue
                    self._backoff[rep].append((it + (1 << min(n, 6)), req))
                    break
                self.counters["admitted"] += 1
                self.per_replica[rep]["admitted"] += 1
                worked = True
            if b.n_live:
                for r in b.step():
                    self.per_replica[rep]["completed"] += 1
                    r = self._reassemble(r)
                    with self._lock:
                        if r.rid in self.completed:
                            self.counters["dup_completed"] += 1  # weak multiplicity
                        else:
                            self.completed[r.rid] = r
                worked = True
        if any(self._backoff):
            worked = True
        return worked

    def run(self, max_iters: int = 10_000) -> Dict[int, Request]:
        """Drive all replicas round-robin until queues drain and slots empty."""
        for _ in range(max_iters):
            if not self.run_iteration():
                break
        return self.completed

    def stats(self) -> dict:
        out = {
            "totals": dict(self.counters),
            "per_replica": [dict(c) for c in self.per_replica],
        }
        snaps = []
        for b in self.batchers:
            snap = getattr(b, "stats", None)
            snaps.append(snap() if callable(snap) else None)
        out["batchers"] = snaps
        return out
