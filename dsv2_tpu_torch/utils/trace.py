"""Per-stage wall timing and profiler capture of the port.

- `stage("name")` accumulates wall time per stage when DSV2_TRACE=1 (or
  after `enable()`); `report()` prints the table, and does so at exit
  when tracing is on. `totals` and `reset` read and clear the per-stage
  seconds, for callers that time one run.
- DSV2_XPROF=<dir> wraps the process in torch.profiler (CPU activity,
  and CUDA activity when the port runs on the card; the kernels are
  built before the capture starts, so no build is in it) and writes a
  Chrome trace into <dir> at exit (`chrome://tracing`, Perfetto).

Counterpart of `dsv2_tpu/utils/trace.py`, whose DSV2_XPROF captures a
JAX profiler trace.
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
_xprof = None    # (trace directory, torch.profiler.profile) when capturing


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


def _maybe_start_xprof():
    global _xprof
    d = os.environ.get("DSV2_XPROF")
    if not d:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .. import DEVICE_ENV
    acts = [ProfilerActivity.CPU]
    if ((os.environ.get(DEVICE_ENV) or "cuda") == "cuda"
            and torch.cuda.is_available()):
        from ..ops import _kernels
        _kernels.build_all()
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _xprof = (d, prof)


def _shutdown():
    if _xprof:
        d, prof = _xprof
        prof.stop()
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(d, "dsv2_torch.%d.trace.json" % os.getpid()))
    if _enabled:
        report()


_maybe_start_xprof()
atexit.register(_shutdown)
