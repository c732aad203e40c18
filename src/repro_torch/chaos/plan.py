"""Seeded, deterministic fault plans for the fence-free scheduler stack
(copy of ``repro/chaos/plan.py``).

The paper's safety argument (arXiv:2008.04424 §7) is adversarial by
construction: a stale fence-free ``head`` write may rewind a queue and hand
one task to several programs, and WS-WMULT's answer is *bounded
multiplicity*, not prevention.  :class:`FaultPlan` turns the ad-hoc rewind
drills the test suites grew into one reproducible object: every fault —
program stalls, head-rewind storms, advisory corruption, kill-and-relaunch
— is derived from a single integer seed, so a failing storm replays
bit-for-bit from its plan.

Faults are injected as *data*, never as kernel code:

* **stalls** — per-program initial clock offsets: program ``p`` with stall
  ``k`` is "busy" until round ``k`` and extracts nothing before then.  The
  megakernel's lockstep clock already models busy programs, so a stall is
  just a nonzero initial value for ``clock[p]``.  A traced free-mode launch
  also holds the stalled CTA back before its first probe (the plain
  version: skips its first ``k`` turns).
* **advisory corruption** — garbage ``remaining[q]`` summaries (zeros /
  reversed / random), modeling arbitrarily stale or dropped plain-write
  advisory updates.  Selection quality only: the ``head < tail`` victim
  mask alone guarantees progress.
* **head-rewind storms** — between launch segments, drag ``head[q]`` back
  to drawn targets and wipe drawn ``local_head`` rows: the forced stale
  republish of §7, re-arming already-claimed slots for re-extraction.
* **kill-and-relaunch** — run a segment with a deliberately under-provisioned
  round budget (the "killed" partial launch), then resume a fresh launch
  from the surviving queue arrays.

Because every fault is an initial-array value or a host-side mutation
between launches, ``fault_plan=None`` and a zero plan launch the same
kernel with the same arrays: injection is free when off.

numpy only (the reference's tracer-aware branch has no counterpart: the
port builds every Put eagerly).  Arrays may be numpy or tensors on any
device; the helpers copy them to the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np

ADVISORY_MODES = ("exact", "zeros", "reversed", "random")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def corrupt_advisory(remaining, mode: str, seed: int = 0):
    """Return an adversarially stale copy of the ``remaining[q]`` advisory
    summaries: garbage the cost-aware victim selection must survive
    (selection quality only — never correctness, never progress).

    ``mode``: ``"exact"`` (unchanged), ``"zeros"``, ``"reversed"``, or
    ``"random"`` (seeded, bounded by twice the true maximum).
    """
    assert mode in ADVISORY_MODES, mode
    if mode == "exact":
        return remaining
    remaining = _host(remaining).astype(np.int32)
    if mode == "zeros":
        return np.zeros_like(remaining)
    if mode == "reversed":
        return remaining[::-1].copy()
    rng = np.random.RandomState(seed)
    hi = 1 + 2 * int(remaining.max(initial=1))
    return rng.randint(0, hi, size=remaining.shape).astype(np.int32)


def seed_advisory(state, mode: str, rng=None):
    """In-place advisory corruption of a host-built ``QueueState`` (the
    drill the steal-policy suite grew; ``rng`` may be a
    ``np.random.RandomState`` for the legacy call shape)."""
    from ..pallas_ws.queues import queue_costs

    true = np.asarray(queue_costs(state), dtype=np.int32)
    if mode == "random":
        rng = rng if rng is not None else np.random.RandomState(0)
        hi = 1 + 2 * int(true.max(initial=1))
        state.remaining = rng.randint(0, hi, size=true.shape).astype(np.int32)
    elif mode == "exact":
        state.remaining = true
    else:
        state.remaining = corrupt_advisory(true, mode)
    return state


@dataclass(frozen=True)
class RewindSpec:
    """One head-rewind storm: the forced stale republish of §7.

    ``head_targets[q]`` (present keys only) is the stale value republished
    to ``head[q]`` — must be ≤ the current head, exactly what a delayed
    plain write could legally contain.  ``wiped`` lists the programs whose
    persistent ``local_head`` rows are reset to 0 (fresh thieves with no
    local bound).  ``advisory`` optionally re-corrupts the cost summaries
    on top (the worst staleness for victim selection).
    """

    head_targets: Dict[int, int] = field(default_factory=dict)
    wiped: Tuple[int, ...] = ()
    advisory: str = "exact"
    advisory_seed: int = 0

    @classmethod
    def full(cls, state) -> "RewindSpec":
        """Every head dragged to 0, every local bound wiped — the maximal
        §7 staleness (the classic multiplicity-normalization drill)."""
        return cls(
            head_targets={q: 0 for q in range(state.n_queues)},
            wiped=tuple(range(state.n_programs)),
        )

    @classmethod
    def draw(cls, state, draw_int, draw_bool, *, heads=None,
             advisory_modes: Sequence[str] = ("exact",)) -> "RewindSpec":
        """Draw a storm from a ``draw_int``/``draw_bool`` source (hypothesis
        or a seeded rng): per-queue optional rewind to a target ≤ the
        current head (``heads`` overrides where to read current heads —
        conformance drills pass the *post-run* heads so the same spec is
        valid for two layout-parity states), per-program optional wipe,
        and an optional advisory corruption mode."""
        cur = _host(state.head if heads is None else heads)
        targets = {}
        for q in range(state.n_queues):
            if draw_bool():
                targets[q] = draw_int(0, max(0, int(cur[q])))
        wiped = tuple(p for p in range(state.n_programs) if draw_bool())
        mode = advisory_modes[draw_int(0, len(advisory_modes) - 1)] \
            if len(advisory_modes) > 1 else advisory_modes[0]
        return cls(head_targets=targets, wiped=wiped, advisory=mode,
                   advisory_seed=draw_int(0, 2**16))


def apply_rewind(state, spec: RewindSpec):
    """Apply one :class:`RewindSpec` to a host-built ``QueueState`` in
    place (numpy arrays or CPU tensors).  Returns the state for chaining.  The same spec
    can be applied to several layout-parity states — the mutation depends
    only on the spec, never on the state's contents."""
    head = _host(state.head)
    local = _host(state.local_head)
    for q, tgt in spec.head_targets.items():
        head[q] = tgt
    for p in spec.wiped:
        local[p] = 0
    state.head, state.local_head = head, local
    if spec.advisory != "exact":
        seed_advisory(state, spec.advisory,
                      np.random.RandomState(spec.advisory_seed))
    return state


@dataclass(frozen=True)
class FaultPlan:
    """A complete seeded fault schedule for one scheduler run.

    Scheduler-side fields (consumed by ``pallas_ws.kernel.launch_grid`` and
    :func:`repro_torch.chaos.inject.run_with_faults`):

    * ``stalls`` — per-program initial stall rounds (padded with 0 to P).
    * ``advisory`` — launch-time advisory corruption mode.
    * ``kills`` — round budgets of killed partial launches: each entry runs
      a segment with that many rounds, then a fresh launch resumes from the
      surviving queue state.
    * ``storms`` — number of head-rewind storms injected between segments
      (specs drawn deterministically from ``seed``).
    * ``full_first_storm`` — make storm 0 the maximal rewind (every head to
      0, every local wiped) so the classic mult==2 drill is a plan.

    Host-shim fields (consumed by
    :class:`repro_torch.pallas_ws.host.PallasWSHost`, counted in its
    ``faults_injected``):

    * ``drop_advisory_every`` — drop every n-th advisory update (a lost
      plain write).
    * ``stale_head_every`` — after every n-th successful claim, republish
      the *pre-claim* head value (a §7 stale write racing the claim).
    """

    seed: int = 0
    stalls: Tuple[int, ...] = ()
    advisory: str = "exact"
    kills: Tuple[int, ...] = ()
    storms: int = 0
    full_first_storm: bool = False
    drop_advisory_every: int = 0
    stale_head_every: int = 0

    def __post_init__(self):
        assert self.advisory in ADVISORY_MODES, self.advisory
        assert all(k >= 1 for k in self.kills), self.kills
        assert self.storms >= 0 and self.drop_advisory_every >= 0
        assert self.stale_head_every >= 0

    # -- deterministic derivation --------------------------------------
    def rng(self, salt: int = 0) -> np.random.RandomState:
        return np.random.RandomState((self.seed ^ (0x9E37 * (salt + 1))) % 2**31)

    @classmethod
    def from_seed(cls, seed: int, *, max_stall: int = 3, max_kills: int = 2,
                  max_storms: int = 2, n_programs: int = 4) -> "FaultPlan":
        """Draw a whole plan from one integer — the hypothesis-friendly
        constructor: any int32 names a reproducible storm."""
        rng = np.random.RandomState(seed % 2**31)
        stalls = tuple(int(v) for v in rng.randint(0, max_stall + 1,
                                                   size=n_programs))
        advisory = ADVISORY_MODES[rng.randint(0, len(ADVISORY_MODES))]
        kills = tuple(int(v) for v in
                      rng.randint(1, 4, size=rng.randint(0, max_kills + 1)))
        storms = int(rng.randint(0, max_storms + 1))
        return cls(seed=seed, stalls=stalls, advisory=advisory, kills=kills,
                   storms=storms, full_first_storm=bool(rng.randint(0, 2)))

    @property
    def is_off(self) -> bool:
        """True when the plan injects nothing — must behave exactly like
        ``fault_plan=None`` (the bit-parity contract)."""
        return (not any(self.stalls) and self.advisory == "exact"
                and not self.kills and self.storms == 0
                and self.drop_advisory_every == 0
                and self.stale_head_every == 0)

    @property
    def max_stall(self) -> int:
        return max(self.stalls, default=0)

    def stall_vector(self, n_programs: int) -> np.ndarray:
        """[n_programs] int32 initial clock values (stalls padded with 0)."""
        v = np.zeros((n_programs,), np.int32)
        s = np.asarray(self.stalls[:n_programs], np.int32)
        v[: s.shape[0]] = s
        return v

    def launch_remaining(self, remaining):
        """The advisory summaries the first launch segment starts from."""
        return corrupt_advisory(remaining, self.advisory, self.seed)

    def storm_specs(self, state) -> List[RewindSpec]:
        """The plan's rewind storms, drawn deterministically from the seed
        against the given state's shape (targets are drawn ≤ capacity and
        clamped to the live head at apply time by the injector)."""
        specs = []
        for i in range(self.storms):
            if i == 0 and self.full_first_storm:
                specs.append(RewindSpec.full(state))
                continue
            rng = self.rng(salt=100 + i)
            draw_int = lambda lo, hi: int(rng.randint(lo, hi + 1))  # noqa: E731
            draw_bool = lambda: bool(rng.randint(0, 2))  # noqa: E731
            specs.append(RewindSpec.draw(
                state, draw_int, draw_bool,
                advisory_modes=("exact", "zeros", "reversed", "random"),
            ))
        return specs

    def without_launch_faults(self) -> "FaultPlan":
        """The plan with the per-launch injections stripped (stalls and
        advisory corruption apply to segment 0 only — resumed segments
        start from the surviving arrays)."""
        return replace(self, stalls=(), advisory="exact")


def resume_state(state, res):
    """A launch-resume snapshot: the queue state a *fresh* launch continues
    from after a kill or a storm — surviving shared arrays (head, local
    bounds, announcements, advisory) copied out of the previous launch's
    result (tensors copied to the host), task arrays unchanged."""
    state.head = np.array(_host(res.head))
    state.local_head = np.array(_host(res.local_head))
    state.taken = np.array(_host(res.taken))
    state.remaining = np.array(_host(res.remaining))
    return state
