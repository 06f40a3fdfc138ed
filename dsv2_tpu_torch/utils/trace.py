"""Per-stage wall timing of the port.

The accumulators are `dsv2_tpu.utils.trace`'s own: `stage`, `enable`
and the DSV2_TRACE report at exit behave as in the JAX package (its
DSV2_XPROF capture is a JAX profiler and the port never sets it).
`totals` and `reset` read and clear the per-stage seconds, for drivers
that time one run.
"""
from dsv2_tpu.utils import trace as _trace
from dsv2_tpu.utils.trace import enable, report, stage

__all__ = ["enable", "report", "reset", "stage", "totals"]


def totals():
    """Accumulated wall seconds per stage name since the last reset."""
    with _trace._lock:
        return dict(_trace._acc)


def reset():
    """Clear every stage's seconds and count."""
    with _trace._lock:
        _trace._acc.clear()
        _trace._cnt.clear()
