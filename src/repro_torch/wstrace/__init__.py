"""Scheduler telemetry of the port (``repro.wstrace`` counterpart).

Device half: the per-program event rings the megakernels append to with
plain stores (schema in :mod:`.ring`); host half: :class:`~.trace.WSTrace`
analyses, the Perfetto export (:mod:`.perfetto`) and the serving-side
:class:`~.metrics.SchedulerMetrics` sink.  Exports load lazily (PEP 562),
as the reference's do.
"""

_EXPORTS = {
    "EVENT_WIDTH": ".ring",
    "EV_ROUND": ".ring",
    "EV_PROG": ".ring",
    "EV_QUEUE": ".ring",
    "EV_SLOT": ".ring",
    "EV_TID": ".ring",
    "EV_COST": ".ring",
    "EV_KIND": ".ring",
    "EV_VICTIM": ".ring",
    "EV_MULT": ".ring",
    "EV_OP": ".ring",
    "EV_RUN": ".ring",
    "KIND_TAKE": ".ring",
    "KIND_STEAL_SCAN": ".ring",
    "KIND_STEAL_COST": ".ring",
    "KIND_STEAL_REMOTE": ".ring",
    "KIND_NAMES": ".ring",
    "STEAL_KINDS": ".ring",
    "decode_rings": ".ring",
    "WSTrace": ".trace",
    "to_perfetto": ".perfetto",
    "write_perfetto": ".perfetto",
    "SchedulerMetrics": ".metrics",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
