"""Chrome/Perfetto ``trace_event`` export of a :class:`WSTrace` (copy of
``repro/wstrace/perfetto.py``).

The exported JSON loads directly in https://ui.perfetto.dev (or
``chrome://tracing``).  Timeline mapping — the scheduler's virtual clock is
the lockstep *tile-slot round*, exported 1 round = 1 µs:

* **pid 0 "ws programs"** — one thread track per program; every extraction
  is a complete ("X") slice ``[EV_ROUND, EV_ROUND + EV_COST)`` named by its
  kind and queue, with slot/tid/multiplicity/victim in ``args``.
* **flow arrows** — each steal event emits a flow start ("s") on the victim
  program's track (or on the stolen queue's track under pid 1 when the
  queue has no owner program) and a flow finish ("f") on the thief's slice,
  so work migration renders as arrows.
* **pid 1 "ws queues"** — anchor slices for steals of unowned queues
  (expert layouts with more queues than programs).
* **counter tracks ("C")** — per-queue ``remaining[q]`` advisory
  reconstructed from the initial queue loads minus each claim's cost at its
  start round: round-aligned sawtooth counters next to the slices.
* **pid 2 "mesh devices"** — when the trace carries ``mesh_phases``
  (cross-device runs, ``repro_torch.mesh_ws.mesh_wstrace``): per-device phase slices (local
  drain / steal) plus advisory and collective-bytes counters.
* **pid 3 "ws task families"** — one thread track per task family
  (resolved from EV_OP): the same extraction intervals re-grouped by
  family, so a unified mixed-mode launch renders its decode / prefill /
  expert / glue phases as parallel per-family timelines.  Slices only — no
  extra counters or flows.

Everything is derived from the plain-store event rings — the export adds
zero cost to the traced run.
"""

from __future__ import annotations

import json

import numpy as np

from .ring import (
    EV_COST,
    EV_KIND,
    EV_MULT,
    EV_OP,
    EV_PROG,
    EV_QUEUE,
    EV_ROUND,
    EV_RUN,
    EV_SLOT,
    EV_TID,
    EV_VICTIM,
    KIND_NAMES,
    KIND_TAKE,
)
from .trace import _family_name

PID_PROGRAMS = 0
PID_QUEUES = 1
PID_MESH = 2
PID_FAMILIES = 3


def _meta(pid, name, tid=None, tname=None):
    ev = []
    if name is not None:
        ev.append({"ph": "M", "pid": pid, "name": "process_name",
                   "args": {"name": name}})
    if tid is not None:
        ev.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                   "args": {"name": tname}})
    return ev


def to_perfetto(trace) -> dict:
    """Render a :class:`~repro_torch.wstrace.trace.WSTrace` as a trace_event dict."""
    out = []
    out += _meta(PID_PROGRAMS, "ws programs")
    for p in range(trace.n_programs):
        out += _meta(PID_PROGRAMS, None, tid=p, tname=f"program {p}")

    queue_anchor_tracks = set()
    flow_id = 0
    for ev in np.asarray(trace.events):
        t0, p, q, slot, tid, cost, kind, victim, mult = (
            int(ev[EV_ROUND]), int(ev[EV_PROG]), int(ev[EV_QUEUE]),
            int(ev[EV_SLOT]), int(ev[EV_TID]), int(ev[EV_COST]),
            int(ev[EV_KIND]), int(ev[EV_VICTIM]), int(ev[EV_MULT]),
        )
        kname = KIND_NAMES[kind] if 0 <= kind < len(KIND_NAMES) else str(kind)
        out.append({
            "ph": "X", "pid": PID_PROGRAMS, "tid": p,
            "ts": t0, "dur": max(cost, 1),
            "name": f"{kname} q{q}", "cat": kname,
            "args": {"queue": q, "slot": slot, "task": tid,
                     "multiplicity": mult, "victim": victim,
                     "run": int(ev[EV_RUN])},
        })
        if kind == KIND_TAKE:
            continue
        # steal: arrow from the victim's track (owner program when the
        # queue has one, else the queue's own anchor track) to the thief
        flow_id += 1
        if victim >= 0:
            src = {"pid": PID_PROGRAMS, "tid": victim}
        else:
            src = {"pid": PID_QUEUES, "tid": q}
            if q not in queue_anchor_tracks:
                queue_anchor_tracks.add(q)
            out.append({
                "ph": "X", "pid": PID_QUEUES, "tid": q,
                "ts": t0, "dur": max(cost, 1),
                "name": f"stolen by p{p}", "cat": "steal-victim",
                "args": {"thief": p, "slot": slot, "task": tid},
            })
        out.append({"ph": "s", "id": flow_id, "cat": "steal",
                    "name": "steal", "ts": t0, **src})
        out.append({"ph": "f", "bp": "e", "id": flow_id, "cat": "steal",
                    "name": "steal", "ts": t0,
                    "pid": PID_PROGRAMS, "tid": p})
    if queue_anchor_tracks:
        out += _meta(PID_QUEUES, "ws queues")
        for q in sorted(queue_anchor_tracks):
            out += _meta(PID_QUEUES, None, tid=q, tname=f"queue {q}")

    # per-family timelines: the same extraction intervals keyed by EV_OP,
    # one thread track per family.  "X" slices ONLY — the pid-0 tracks stay
    # the canonical per-program view and keep all counters/flows.
    events = np.asarray(trace.events)
    if events.size:
        family_ops = sorted(int(op) for op in np.unique(events[:, EV_OP]))
        out += _meta(PID_FAMILIES, "ws task families")
        for op in family_ops:
            out += _meta(PID_FAMILIES, None, tid=op,
                         tname=f"{_family_name(op)} (op {op})")
        for ev in events:
            op = int(ev[EV_OP])
            out.append({
                "ph": "X", "pid": PID_FAMILIES, "tid": op,
                "ts": int(ev[EV_ROUND]), "dur": max(int(ev[EV_COST]), 1),
                "name": f"{_family_name(op)} t{int(ev[EV_TID])}",
                "cat": "family",
                "args": {"program": int(ev[EV_PROG]),
                         "queue": int(ev[EV_QUEUE]),
                         "task": int(ev[EV_TID]),
                         "multiplicity": int(ev[EV_MULT])},
            })

    # remaining[q] advisory counters: initial load at ts 0, then one sample
    # after each claim at the claim's start round
    if trace.queue_loads is not None:
        remaining = np.asarray(trace.queue_loads, np.int64).copy()
        for q in range(trace.n_queues):
            out.append({"ph": "C", "pid": PID_PROGRAMS, "ts": 0,
                        "name": f"remaining q{q}",
                        "args": {"tiles": int(remaining[q])}})
        for ev in np.asarray(trace.events):
            q = int(ev[EV_QUEUE])
            remaining[q] = max(int(remaining[q]) - int(ev[EV_COST]), 0)
            out.append({"ph": "C", "pid": PID_PROGRAMS,
                        "ts": int(ev[EV_ROUND]),
                        "name": f"remaining q{q}",
                        "args": {"tiles": int(remaining[q])}})

    if trace.mesh_phases:
        out += _meta(PID_MESH, "mesh devices")
        for d, ph in enumerate(trace.mesh_phases):
            out += _meta(PID_MESH, None, tid=d, tname=f"device {d}")
            c1 = int(ph.get("phase1_clock", 0))
            c2 = int(ph.get("phase2_clock", 0))
            cs = int(ph.get("steal_clock", 0))
            out.append({"ph": "X", "pid": PID_MESH, "tid": d, "ts": 0,
                        "dur": max(c1, 1), "name": "phase1 local drain",
                        "cat": "mesh", "args": {"clock": c1}})
            if cs or ph.get("stole"):
                out.append({
                    "ph": "X", "pid": PID_MESH, "tid": d, "ts": c1,
                    "dur": max(cs, 1), "name": "phase2 remote steal",
                    "cat": "mesh",
                    "args": {"victim": int(ph.get("victim", -1)),
                             "tiles": int(ph.get("take_tiles", 0))},
                })
                victim = int(ph.get("victim", -1))
                if victim >= 0:
                    flow_id += 1
                    out.append({"ph": "s", "id": flow_id, "cat": "steal",
                                "name": "remote-steal", "ts": c1,
                                "pid": PID_MESH, "tid": victim})
                    out.append({"ph": "f", "bp": "e", "id": flow_id,
                                "cat": "steal", "name": "remote-steal",
                                "ts": c1, "pid": PID_MESH, "tid": d})
            elif c2:
                out.append({"ph": "X", "pid": PID_MESH, "tid": d, "ts": c1,
                            "dur": max(c2, 1), "name": "phase2 idle",
                            "cat": "mesh", "args": {"clock": c2}})
            for cname, key in (("advisory tiles", "advisory"),
                               ("collective bytes", "collective_bytes")):
                if key in ph:
                    out.append({"ph": "C", "pid": PID_MESH, "ts": 0,
                                "name": f"{cname} d{d}",
                                "args": {"value": int(ph[key])}})

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"time_unit": "1 tile-slot round = 1 us"}}


def write_perfetto(trace, path) -> None:
    """Write the Perfetto JSON for ``trace`` to ``path``."""
    with open(path, "w") as f:
        json.dump(to_perfetto(trace), f, indent=1)
