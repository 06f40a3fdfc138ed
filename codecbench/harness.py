"""The benchmark's run: set-up, the measured window, the judgement of
what the window produced, and the one result line.

Everything that belongs to one configuration, traffic mix, entry point,
metric, kernel or cell is a file of its own under the benchmark's root,
found by the name `BENCHMARK.json` gives it:

- configs/<config>.json      picture format, rate settings, source
- traffic/<traffic>.json     the job: its entry point and parameters
- entries/<entry>.py         the driver of one entry point of the port
- limits/<cell>.json         each compared number's limit, per cell
- metrics/<metric>.py        read(obs) -> value, or None where the run
                             has nothing to read
- rooflines/<kernel>.py      the bytes a kernel's calls need
- peaks.json                 the card's published peaks, by device name

A run is one process: set-up (build or load the port's kernels, make the
seeded clip, one warm job), then jobs back to back in a closed loop
until `--seconds` have passed (the job that crosses the mark runs
whole), then the check. With `--trace 1` the window runs with the
port's stage spans on, and one more job after it runs under
torch.profiler (CPU and CUDA) with the kernels' launch wrappers
recording their calls; the per-layer metrics read both.
"""
import importlib.util
import json
import os
import re
import statistics
import sys
import time

# top-level module names that may not be loaded in a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "dsv2_tpu")


class BenchError(Exception):
    """A run that cannot give a result: no card, a name not found."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module in file `path` (loaded afresh, under `name`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark under `root` (the checkout): BENCHMARK.json and the
    files its names point to, in the benchmark's folder codecbench/."""

    def __init__(self, root):
        self.dir = os.path.join(root, "codecbench")
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(path):
            raise BenchError("no BENCHMARK.json in %s" % root)
        self.spec = load_json(path)

    def file(self, kind, name, ext):
        path = os.path.join(self.dir, kind, name + ext)
        if not os.path.exists(path):
            raise BenchError("no %s file for %r: %s" % (kind, name, path))
        return path

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise BenchError("no workload named %r in BENCHMARK.json" % name)

    def config(self, name):
        return load_json(self.file("configs", name, ".json"))

    def traffic(self, name):
        return load_json(self.file("traffic", name, ".json"))

    def limits(self, cell):
        return load_json(self.file("limits", cell, ".json"))

    def entry(self, name):
        return load_module(self.file("entries", name, ".py"),
                           "codecbench_entry_" + name)

    def metric(self, name):
        return load_module(self.file("metrics", name, ".py"),
                           "codecbench_metric_" + name.replace(".", "_"))

    def rooflines(self):
        d = os.path.join(self.dir, "rooflines")
        return {f[:-3]: load_module(os.path.join(d, f),
                                    "codecbench_roofline_" + f[:-3])
                for f in sorted(os.listdir(d))
                if f.endswith(".py") and not f.startswith("_")}

    def peaks(self, kind):
        return load_json(os.path.join(self.dir, "peaks.json")).get(kind)

    def metrics_of(self, cell, traced):
        """The metric entries a run of `cell` reports: its end-to-end
        metrics, or with `traced` its per-layer metrics."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if m["moves"] in names
                and cell in m.get("workloads", [cell])]


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is one the
    port's runs may not load."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def span_table():
    """{stage: (seconds, count)} of the port's stage spans since the last
    reset, read from its printed report (the count is only printed)."""
    import io
    from dsv2_tpu_torch.utils import trace
    buf = io.StringIO()
    trace.report(out=buf)
    out = {}
    for line in buf.getvalue().splitlines():
        m = re.match(r"\s+(\S+)\s+([0-9.]+)s\s+x(\d+)", line)
        if m:
            out[m.group(1)] = (float(m.group(2)), int(m.group(3)))
    # the report rounds to ms: take the seconds unrounded from totals()
    for k, v in trace.totals().items():
        if k in out:
            out[k] = (v, out[k][1])
    return out


def _wrap(mod, attr, sink, record):
    """Replace mod.attr by a wrapper that appends record(*a, **k) to sink
    before each call; returns the function that restores it."""
    fn = getattr(mod, attr)

    def wrapped(*a, **k):
        sink.append(record(*a, **k))
        return fn(*a, **k)
    setattr(mod, attr, wrapped)
    return lambda: setattr(mod, attr, fn)


def profile_jobs(drv, rooflines, njobs):
    """Run `njobs` jobs of `drv` under torch.profiler, recording the calls
    of every roofline's launch wrapper; returns (outputs,
    observations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    calls = {name: [] for name in rooflines}
    undo = []
    for name, rl in rooflines.items():
        mod = importlib.import_module(rl.TARGET[0])
        undo.append(_wrap(mod, rl.TARGET[1], calls[name], rl.record))
    acts = [ProfilerActivity.CPU]
    cuda = drv.device.type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            outs = [drv.job() for _ in range(njobs)]
            if cuda:
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    t0 = time.perf_counter()
    obs = read_profile(prof, window, cuda)
    obs["read_profile_s"] = time.perf_counter() - t0
    obs["profiled_frames"] = sum(drv.frames(o) for o in outs)
    obs["rooflines"] = {}
    for name, rl in rooflines.items():
        dev_s = sum(v for k, v in obs["kernel_s"].items()
                    if rl.KERNEL.search(k))
        if calls[name] and dev_s > 0:
            obs["rooflines"][name] = dict(
                bytes=sum(rl.nbytes(c) for c in calls[name]),
                device_s=dev_s, calls=len(calls[name]))
    return outs, obs


def read_profile(prof, window, cuda=True):
    """Observations of a profiled window: device busy seconds (the union
    of the intervals of every device event: kernels, copies, sets), the
    device seconds of each kernel name and of each host op's kernels, the
    window's length, and the longest idle gaps labelled by the innermost
    host op running when each began."""
    import torch
    cuda_t = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    dev, host = [], []
    kernel_s = {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda_t:
            dev.append((s, t))
            kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (t - s) / 1e6
        else:
            host.append((s, t, e.name))
    op_s = {}
    for a in prof.key_averages():
        v = getattr(a, "device_time_total", None)
        if v is None:
            v = getattr(a, "cuda_time_total", 0.0)
        if v:
            op_s[a.key] = v / 1e6
    busy, gaps, end = 0.0, [], None
    for s, t in sorted(dev):
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    gaps.sort(reverse=True)
    labelled = []
    for length, start in gaps[:10]:
        inner = [(t - s, n) for s, t, n in host if s <= start < t]
        labelled.append([min(inner)[1] if inner else "(no host op)",
                         length / 1e6])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    obs = dict(window_s=window, kernel_s=kernel_s, op_s=op_s,
               device_ops=[[k, v] for k, v in ops], idle_gaps=labelled)
    if cuda:     # a run without the card reads no device number
        obs["busy_s"] = busy / 1e6
    return obs


def run(argv, root, need_card=True, device=None, out=None, err=None,
        t_start=None):
    """One run of the cell named by --workload; prints the result line on
    `out` and returns the exit code. need_card=False (the CPU tests)
    skips the look for a card and runs the port on `device`."""
    import argparse
    out = out or sys.stdout
    err = err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="codecbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="run the cell's control: the program at the "
                         "configuration's control_qp (PERF.md: how "
                         "`correct` is decided)")
    args = ap.parse_args(argv)

    bench = Bench(root)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    entry = bench.entry(traffic["entry"])
    metrics = bench.metrics_of(cell["name"], bool(args.trace))

    import torch
    if need_card:
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False: this "
                             "benchmark measures the port on a GPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise BenchError("%d GPU(s) visible, the cell needs %d"
                             % (torch.cuda.device_count(), cell["chips"]))
        device = torch.device("cuda")
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"

    # set-up: the port's kernels, the seeded clip, one warm job
    drv = entry.Driver(cfg, traffic, args.seed, device,
                       control=bool(args.control))
    drv.warm()
    from dsv2_tpu_torch.utils import trace
    if args.trace:
        trace.enable(True)
        trace.reset()
    if cuda:
        torch.cuda.synchronize()

    # the window: whole jobs back to back, a closed loop
    outputs, job_s = [], []
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    while True:
        t0 = time.perf_counter()
        o = drv.job()
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        outputs.append(o)
        job_s.append(t1 - t0)
        if t1 - t_win >= args.seconds:
            break
    window_s = t1 - t_win
    frames = sum(drv.frames(o) for o in outputs)
    obs = dict(kind=entry.PRODUCES, setup_s=setup_s, window_s=window_s,
               frames=frames, jobs=len(outputs),
               job_frames=drv.frames(outputs[0]))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    prof_obs = None
    if args.trace:
        obs["spans"] = span_table()
        trace.enable(False)
        o, prof_obs = profile_jobs(drv, bench.rooflines(),
                                   traffic.get("profile_jobs", 1))
        outputs += o
        obs.update(prof_obs)
        obs["trace_window_s"] = obs.pop("window_s")
        obs["window_s"] = window_s
        peak = max(peak, torch.cuda.max_memory_allocated(device)
                   if cuda else 0)
    obs["peaks"] = bench.peaks(torch.cuda.get_device_name(device)
                               if cuda else "cpu")

    found = forbidden_modules()
    if found:
        raise BenchError("modules loaded that the port's runs may not "
                         "load: %s" % ", ".join(found))

    values = {}
    for m in metrics:
        v = bench.metric(m["name"]).read(obs)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the judgement, once the window has closed and the peak is read
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks, failed, info = drv.check(outputs, args.seed)
    info["check_s"] = time.perf_counter() - t0
    # the jobs' spread inside the window: least, quartiles, most
    info["job_s"] = [min(job_s)] + (statistics.quantiles(job_s, n=4)
                                    if len(job_s) > 1 else job_s) + [
        max(job_s)]
    if prof_obs is not None:
        info["read_profile_s"] = prof_obs["read_profile_s"]
    correct = failed == 0
    for name, value in checks.items():
        limit = limits[name]
        correct = correct and value <= limit
        checks[name] = {"value": value, "limit": limit}
    if not correct:
        failed = max(failed, 1)
    result = {"correct": bool(correct), "attempted": len(outputs),
              "failed": int(failed), "metrics": values,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": 1 if cuda else 0,
                         "memory_peak_bytes": int(peak)}}
    if prof_obs is not None:
        if "busy_s" in prof_obs:
            result["device"]["busy_s"] = prof_obs["busy_s"]
            result["device"]["window_s"] = obs["trace_window_s"]
        result["breakdown"] = {"device_ops": prof_obs["device_ops"],
                               "idle_gaps": prof_obs["idle_gaps"]}
    result["checks"] = checks
    for k, v in sorted(info.items()):
        print("info %s %s" % (k, v), file=err)
    for name, c in checks.items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def roofline_share(obs, kernel):
    """The share (%) of its bytes roofline that `kernel` reached in the
    profiled job, or None where it made no call or the card's peak is not
    in peaks.json."""
    rl = obs.get("rooflines", {}).get(kernel)
    peaks = obs.get("peaks")
    if not rl or not peaks:
        return None
    return 100.0 * rl["bytes"] / peaks["hbm_bytes_per_s"] / rl["device_s"]
