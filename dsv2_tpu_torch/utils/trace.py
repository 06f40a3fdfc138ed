"""Spans, counters and profiler capture of the port.

With DSV2_TRACE=1 (or after `enable()`):

- `stage(name, **ids)` is a span: a record of its name, its start and end
  (`time.perf_counter_ns()`), its thread, its parent (the thread's
  innermost open span) and its ids (`lane`, `fnum`, `flush`; a thread's
  `set_ids` apply to all of its spans, `tag` adds ids to the innermost
  open span). A span adds to its name's sums when it closes (seconds,
  self seconds, count), whatever the buffer holds; closed spans also go
  into a buffer of CAP records for callers that walk the span tree;
  `dropped()` counts those that found it full, and `records()` then
  raises. `record(name, t0)` keeps a
  span whose ends are not one `with` block (`t0` from `mark()`), with no
  parent.
- `count(name, n)` adds to a process counter and to the innermost open
  span's own counts, so a flush's record carries its lanes. Inside
  `collect()` the calling thread's counts go to the dict it yields
  instead, tracing on or off: a CUDA graph's capture notes the launches
  of its body there, and each replay credits them (codec/devsteps).
- `table()` (per name: seconds, self seconds, i.e. less the time of its
  child spans, and count), `totals()`, `counters()`, `records()` read
  them; `report()` prints the per-name table and the counters, at exit
  too; `reset()` clears sums, records and counters.
- While a torch profiler runs (DSV2_XPROF, or a caller's), each `stage`
  span also enters `torch.profiler.record_function(name)`, so the spans
  sit on their threads' rows of the profiler's trace, on its clock (by
  name only: the ids stay in the records).

With tracing off, `stage` is one flag check and `count` two (`stage`
returns a shared no-op context); no span or counter reads a clock,
touches the profiler or the device. Nothing here ever waits for,
allocates on or launches on the device.

DSV2_XPROF=<dir> wraps the process in torch.profiler (CPU activity of
every thread, `all_threads()`, and CUDA activity when the port runs on the
card; the kernels are built before the capture starts, so no build is in
it) and writes a Chrome trace into <dir> at exit (`chrome://tracing`,
Perfetto).

Counterpart of `dsv2_tpu/utils/trace.py`, whose DSV2_XPROF captures a
JAX profiler trace.
"""
import atexit
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

__all__ = ["CAP", "Span", "all_threads", "collect", "count", "counters",
           "current", "dropped", "enable", "mark", "record", "records",
           "report", "reset", "set_ids", "stage", "table", "tag", "totals"]

CAP = 1 << 18          # records kept between resets
_enabled = bool(int(os.environ.get("DSV2_TRACE", "0") or 0))
_lock = threading.Lock()
_records = []
_dropped = 0
_sums = {}             # name -> [ns, self ns, count]
_counters = defaultdict(int)
_ids = itertools.count(1)
_collecting = 0        # threads inside collect()
_local = threading.local()     # .stack: open spans; .ids: set_ids
_NULL = nullcontext()
_profiling = None              # torch.autograd.profiler, once imported
_xprof = None    # (trace directory, torch.profiler.profile) when capturing


def enable(flag=True):
    global _enabled
    _enabled = flag


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _keep(rec, self_ns):
    global _dropped
    d = rec.t1 - rec.t0
    with _lock:
        tot = _sums.get(rec.name)
        if tot is None:
            tot = _sums[rec.name] = [0, 0, 0]
        tot[0] += d
        tot[1] += self_ns
        tot[2] += 1
        if len(_records) < CAP:
            _records.append(rec)
        else:
            _dropped += 1


def _profiler_on():
    """Whether a torch profiler runs, in any thread (torch's own flag for
    fast checks from Python)."""
    global _profiling
    if _profiling is None:
        import torch.autograd.profiler
        _profiling = torch.autograd.profiler
    return getattr(_profiling, "_is_profiler_enabled", False)


class Span:
    """One span: a context manager while open, a record once closed.
    Times in perf_counter nanoseconds; `thread` the native thread id (the
    profiler's tid); `counts` the counts made while it was the innermost
    open span of its thread (None where none were)."""
    __slots__ = ("id", "name", "t0", "t1", "thread", "parent", "ids",
                 "counts", "_rf", "_child")

    def __init__(self, name, ids):
        self.name, self.ids = name, ids
        self.parent = self.counts = self._rf = None
        self._child = 0      # ns of its closed child spans

    def __enter__(self):
        st = _stack()
        ctx = getattr(_local, "ids", None)
        if ctx:
            self.ids = {**ctx, **self.ids}
        self.id = next(_ids)
        if st:
            self.parent = st[-1].id
        self.thread = threading.get_native_id()
        if _profiler_on():
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        st = _local.stack
        st.pop()
        d = self.t1 - self.t0
        if st:
            st[-1]._child += d
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _keep(self, d - self._child)
        return False

    @property
    def seconds(self):
        return (self.t1 - self.t0) / 1e9


def stage(name, **ids):
    """A span named `name` with `ids` (see the module docstring)."""
    if not _enabled:
        return _NULL
    return Span(name, ids)


def count(name, n=1):
    """Add n to counter `name` and to the innermost open span's counts
    (inside `collect()`, to its dict alone)."""
    if _collecting:
        made = getattr(_local, "collect", None)
        if made is not None:
            made[name] = made.get(name, 0) + n
            return
    if not _enabled:
        return
    with _lock:
        _counters[name] += n
    st = getattr(_local, "stack", None)
    if st:
        sp = st[-1]
        if sp.counts is None:
            sp.counts = {}
        sp.counts[name] = sp.counts.get(name, 0) + n


@contextmanager
def collect():
    """Yield a dict that takes the calling thread's counts while the block
    runs, in place of the counters and spans, tracing on or off."""
    global _collecting
    prev = getattr(_local, "collect", None)
    made = _local.collect = {}
    with _lock:
        _collecting += 1
    try:
        yield made
    finally:
        _local.collect = prev
        with _lock:
            _collecting -= 1


def set_ids(**ids):
    """Ids every later span of the calling thread carries (a lane thread's
    `lane`)."""
    _local.ids = ids


def tag(**ids):
    """Add ids to the calling thread's innermost open span (a lane's step
    names the flush that served it)."""
    if not _enabled:
        return
    st = getattr(_local, "stack", None)
    if st:
        st[-1].ids.update(ids)


def current():
    """The calling thread's innermost open span, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def mark():
    """The clock for `record`: perf_counter_ns() when tracing, else None."""
    return time.perf_counter_ns() if _enabled else None


def record(name, t0, **ids):
    """Keep a span from t0 (a `mark()`) to now, with no parent; nothing
    when tracing is off or t0 is None."""
    if not _enabled or t0 is None:
        return
    sp = Span(name, ids)
    sp.id = next(_ids)
    sp.thread = threading.get_native_id()
    sp.t0 = t0
    sp.t1 = time.perf_counter_ns()
    _keep(sp, sp.t1 - t0)


def records():
    """The closed spans since the last reset, in the order they closed.
    Raises where the buffer dropped any: a tree read from part of a window
    would be wrong with no sign of it (`table()` still holds them all)."""
    with _lock:
        if _dropped:
            raise RuntimeError("%d spans not kept as records (CAP %d): "
                               "reset() sooner" % (_dropped, CAP))
        return list(_records)


def table():
    """{name: (seconds, self seconds, count)} of every span closed since
    the last reset, kept or dropped: self seconds are a span's less those
    of its child spans."""
    with _lock:
        return {k: (s / 1e9, self_s / 1e9, n)
                for k, (s, self_s, n) in _sums.items()}


def totals():
    """Wall seconds per span name since the last reset."""
    return {k: v[0] for k, v in table().items()}


def counters():
    """Every counter since the last reset."""
    with _lock:
        return dict(_counters)


def dropped():
    """Spans not kept since the last reset: the buffer was full."""
    return _dropped


def reset():
    """Clear every record and counter."""
    global _dropped
    with _lock:
        _records.clear()
        _sums.clear()
        _counters.clear()
        _dropped = 0


def report(out=None):
    """Per-name totals, then the counters; printed at exit automatically
    when tracing."""
    out = out or sys.stderr
    tab = table()
    if tab:
        total = sum(v[0] for v in tab.values())
        print("--- dsv2 stage timing%s ---"
              % (" (%d spans not kept as records)" % _dropped
                 if _dropped else ""), file=out)
        for name, (t, _, n) in sorted(tab.items(), key=lambda kv: -kv[1][0]):
            print("  %-28s %8.3fs  x%-6d (%4.1f%%)"
                  % (name, t, n, 100 * t / max(total, 1e-9)), file=out)
    cnt = counters()
    if cnt:
        print("--- dsv2 counters ---", file=out)
        for name, n in sorted(cnt.items()):
            print("  %-36s %d" % (name, n), file=out)


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
    prof = profile(activities=acts, **all_threads())
    prof.start()
    _xprof = (d, prof)


def all_threads():
    """torch.profiler.profile's arguments that record the CPU ops and
    spans of every thread (the lane threads too); by default a profiler
    records those of the thread that started it alone."""
    from torch._C._profiler import _ExperimentalConfig
    return {"experimental_config":
            _ExperimentalConfig(profile_all_threads=True)}


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
