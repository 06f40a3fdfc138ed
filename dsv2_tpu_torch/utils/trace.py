"""Per-stage wall timing of the port.

`stage("name")` accumulates wall time per stage when DSV2_TRACE=1 (or
after `enable()`); `report()` prints the table, and does so at exit when
tracing is on. `totals` and `reset` read and clear the per-stage
seconds, for callers that time one run. (Counterpart of
`dsv2_tpu/utils/trace.py` without its JAX profiler capture: the port
profiles the card with torch.profiler, as tools/torch_profile.py does.)
"""
import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["enable", "report", "reset", "stage", "totals"]

_enabled = bool(int(os.environ.get("DSV2_TRACE", "0") or 0))
_lock = threading.Lock()
_acc = defaultdict(float)
_cnt = defaultdict(int)


def enable(flag=True):
    global _enabled
    _enabled = flag


@contextmanager
def stage(name):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _acc[name] += dt
            _cnt[name] += 1


def totals():
    """Accumulated wall seconds per stage name since the last reset."""
    with _lock:
        return dict(_acc)


def reset():
    """Clear every stage's seconds and count."""
    with _lock:
        _acc.clear()
        _cnt.clear()


def report(out=None):
    """Per-stage totals; printed at exit automatically when tracing."""
    out = out or sys.stderr
    with _lock:
        acc, cnt = dict(_acc), dict(_cnt)
    if not acc:
        return
    total = sum(acc.values())
    print("--- dsv2 stage timing ---", file=out)
    for name, t in sorted(acc.items(), key=lambda kv: -kv[1]):
        print("  %-28s %8.3fs  x%-6d (%4.1f%%)"
              % (name, t, cnt[name], 100 * t / max(total, 1e-9)), file=out)


def _shutdown():
    if _enabled:
        report()


atexit.register(_shutdown)
