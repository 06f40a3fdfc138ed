"""torch port: the span tree and counters of dsv2_tpu_torch/utils/trace.py
(parents, self time, ids, counters credited to the innermost span, the
buffer's cap, the off path), the `report()` format the benchmark parses,
the lockstep cycle's gather and flush spans on a tiny CPU run, the single
stream's `encode.dispatch.<key>` spans (none under lockstep or the intra
batch), `collect()` taking a thread's counts (a CUDA graph's capture),
the spans on a torch profiler's trace only while tracing, and the
counted wait helper of parallel/xfer.py doing nothing on CPU tensors."""
import io
import threading
import time

import pytest
import torch

from torch_parity import REPO  # noqa: F401  (sys.path for the golden tool)
import torch_port_golden as golden
from dsv2_tpu_torch import cli
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.parallel import dynbatch, xfer
from dsv2_tpu_torch.utils import trace


@pytest.fixture
def traced():
    """Tracing on and empty for the test, off and empty after it."""
    trace.reset()
    trace.enable(True)
    yield
    trace.enable(False)
    trace.reset()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_parents_and_self_time(traced):
    with trace.stage("outer"):
        time.sleep(0.02)
        with trace.stage("inner"):
            time.sleep(0.03)
        with trace.stage("inner"):
            with trace.stage("leaf"):
                time.sleep(0.01)
    recs = _by_name(trace.records())
    outer, = recs["outer"]
    inner = recs["inner"]
    leaf, = recs["leaf"]
    assert outer.parent is None
    assert [r.parent for r in inner] == [outer.id, outer.id]
    assert leaf.parent == inner[1].id
    assert len({outer.thread, leaf.thread, threading.get_native_id()}) == 1
    assert outer.t0 <= inner[0].t0 <= inner[0].t1 <= inner[1].t0
    assert leaf.t1 <= inner[1].t1 <= outer.t1
    tab = trace.table()
    s, self_s, n = tab["outer"]
    assert n == 1 and s == pytest.approx(outer.seconds)
    assert self_s == pytest.approx(outer.seconds - sum(r.seconds
                                                       for r in inner))
    assert 0.015 < self_s < s
    assert tab["inner"][2] == 2
    assert tab["inner"][1] == pytest.approx(tab["inner"][0] - leaf.seconds)
    assert tab["leaf"][0] == tab["leaf"][1]
    assert trace.totals() == {k: v[0] for k, v in tab.items()}


def test_ids_on_records(traced):
    def lane(i):
        trace.set_ids(lane=i)
        with trace.stage("frame", fnum=10 + i):
            with trace.stage("step"):
                trace.tag(flush=100 + i)

    threads = [threading.Thread(target=lane, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = _by_name(trace.records())
    assert sorted((r.ids["lane"], r.ids["fnum"]) for r in recs["frame"]) \
        == [(0, 10), (1, 11), (2, 12)]
    assert sorted((r.ids["lane"], r.ids["flush"]) for r in recs["step"]) \
        == [(0, 100), (1, 101), (2, 102)]
    assert len({r.thread for r in recs["frame"]}) == 3
    trace.record("gap", trace.mark() - 1000, flush=7)
    gap, = _by_name(trace.records())["gap"]
    assert gap.parent is None and gap.ids == {"flush": 7}
    assert gap.t1 - gap.t0 >= 1000


def test_counters_gated_and_credited_to_innermost(traced):
    trace.count("launch.x")
    with trace.stage("flush"):
        trace.count("lanes", 3)
        with trace.stage("dispatch"):
            trace.count("launch.x")
            trace.count("launch.x", 2)
        with trace.stage("run"):
            pass
    trace.enable(False)
    trace.count("launch.x", 100)
    with trace.stage("flush"):
        trace.count("lanes")
    trace.enable(True)
    assert trace.counters() == {"launch.x": 4, "lanes": 3}
    recs = _by_name(trace.records())
    assert len(recs["flush"]) == 1
    assert recs["flush"][0].counts == {"lanes": 3}
    assert recs["dispatch"][0].counts == {"launch.x": 3}
    assert recs["run"][0].counts is None


@pytest.mark.parametrize("tracing", [False, True])
def test_collect_takes_the_threads_counts(tracing):
    """Inside collect() the calling thread's counts go to its dict alone,
    tracing on or off (a graph's capture); another thread's still count
    as before, and the thread's counts count again once it exits."""
    trace.reset()
    trace.enable(tracing)
    try:
        with trace.stage("outer"):
            with trace.collect() as made:
                trace.count("launch.x")
                trace.count("launch.x", 2)
                t = threading.Thread(target=trace.count, args=("sync",))
                t.start()
                t.join(timeout=60)
                assert not t.is_alive()
            trace.count("launch.y")
        assert made == {"launch.x": 3}
        if tracing:
            assert trace.counters() == {"sync": 1, "launch.y": 1}
            assert _by_name(trace.records())["outer"][0].counts == {
                "launch.y": 1}
        else:
            assert trace.counters() == {} and trace.records() == []
    finally:
        trace.enable(False)
        trace.reset()


def test_reset_clears_records_and_counters(traced):
    with trace.stage("a"):
        trace.count("c")
    assert trace.records() and trace.counters()
    trace.reset()
    assert trace.records() == [] and trace.counters() == {}
    assert trace.totals() == {} and trace.table() == {}
    assert trace.dropped() == 0


def test_buffer_cap_counts_dropped(traced, monkeypatch):
    """A full buffer drops records, not sums: `table()` and the report
    still hold every span, and `records()` refuses a partial tree."""
    monkeypatch.setattr(trace, "CAP", 5)
    with trace.stage("outer"):
        for _ in range(8):
            with trace.stage("s"):
                time.sleep(0.001)
    assert trace.dropped() == 4
    with pytest.raises(RuntimeError, match="4 spans not kept"):
        trace.records()
    tab = trace.table()
    assert tab["s"][2] == 8 and tab["s"][0] == tab["s"][1] >= 0.008
    assert tab["outer"][2] == 1
    assert tab["outer"][1] == pytest.approx(tab["outer"][0] - tab["s"][0])
    from codecbench import harness
    assert harness.span_table()["s"] == (tab["s"][0], 8)
    trace.reset()
    assert trace.dropped() == 0 and trace.records() == []


def test_off_path_reads_no_clock(monkeypatch):
    """Tracing off: `stage` hands out one shared no-op context and nothing
    reads a clock, records or counts."""
    trace.reset()
    trace.enable(False)

    def no_clock():
        raise AssertionError("a clock read with tracing off")
    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    a, b = trace.stage("x"), trace.stage("y", lane=1)
    assert a is b
    with a:
        trace.count("c")
        trace.tag(flush=1)
    assert trace.mark() is None
    trace.record("g", trace.mark())
    assert trace.records() == [] and trace.counters() == {}


def test_report_format_parsed_by_span_table(traced):
    from codecbench import harness
    for _ in range(3):
        with trace.stage("lockstep.dispatch.p_chain"):
            time.sleep(0.002)
    with trace.stage("batch.prep"):
        trace.count("launch.vk_chain", 5)
    buf = io.StringIO()
    trace.report(out=buf)
    assert "--- dsv2 counters ---" in buf.getvalue()
    assert "launch.vk_chain" in buf.getvalue()
    got = harness.span_table()
    tab = trace.table()
    assert got == {k: (v[0], v[2]) for k, v in tab.items()}
    assert got["lockstep.dispatch.p_chain"][1] == 3


def _lockstep_run(nlanes=2, nframes=3, gop=3, hme_backend="gang"):
    frames, meta = read_y4m(golden.input_path("tiny64x48_420_6f"))
    streams = [frames[i * nframes:(i + 1) * nframes] for i in range(nlanes)]

    def factory():
        enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=gop),
                               device="cpu")
        enc.hme_backend = hme_backend
        return enc
    return dynbatch.encode_streams_lockstep(streams, factory, width=nlanes)


def test_lockstep_gather_and_flush_cover_the_run(traced):
    """A tiny CPU lockstep run (2 lanes): one gather and one flush span
    per flush, counters per key matching the flushes, every lane's device
    step naming a flush that exists, gather + flush covering the run's
    wall time within 10%; no host-device wait on the CPU."""
    t0 = time.perf_counter()
    _lockstep_run()
    wall = time.perf_counter() - t0
    recs = _by_name(trace.records())
    flushes, gathers = recs["lockstep.flush"], recs["lockstep.gather"]
    fids = sorted(r.ids["flush"] for r in flushes)
    assert len(fids) == len(set(fids)) > 0
    assert sorted(r.ids["flush"] for r in gathers) == fids
    assert all(r.parent is None for r in gathers)
    steps = recs["encode.device_step"]
    assert len(steps) == 6
    assert {r.ids["lane"] for r in steps} == {0, 1}
    assert all(r.ids["flush"] in fids for r in steps)
    assert {r.ids["fnum"] for r in recs["encode_frame"]} == {0, 1, 2}
    cnt = trace.counters()
    keys = {}
    for r in flushes:
        assert r.ids["lanes"] == 2 and "+" not in r.ids["key"]
        keys[r.ids["key"]] = keys.get(r.ids["key"], 0) + 1
        assert r.counts == {"lockstep.flushes." + r.ids["key"]: 1,
                            "lockstep.lanes." + r.ids["key"]: 2}
    assert {"input_prep", "i_chain", "p_chain", "hme_gang"} <= set(keys)
    for k, n in keys.items():
        assert cnt["lockstep.flushes." + k] == n
        assert cnt["lockstep.lanes." + k] == 2 * n
    # the flush's children: the batcher's stack/dispatch/run spans
    byid = {r.id: r for rs in recs.values() for r in rs}
    for name in ("lockstep.stack.p_chain", "lockstep.dispatch.p_chain",
                 "lockstep.run.p_chain"):
        assert all(byid[r.parent].name == "lockstep.flush"
                   for r in recs[name])
    covered = sum(r.seconds for r in flushes + gathers)
    assert covered == pytest.approx(wall, rel=0.10)
    group, = recs["lockstep.group"]      # the calling thread's span
    assert group.ids == {"lanes": 2} and group.parent is None
    assert all(group.t0 <= r.t0 and r.t1 <= group.t1
               for r in flushes + gathers)
    assert "sync" not in recs and "sync" not in cnt
    assert not any(k.startswith("launch.") for k in cnt)


def _dispatch_spans():
    return [r for r in trace.records()
            if r.name.startswith("encode.dispatch.")]


def test_single_stream_dispatch_spans(traced):
    """A tiny CPU encode at -gop=4 frame by frame (I P P P I P): each
    one-frame step's call is a span `encode.dispatch.<key>` inside its
    frame's `encode_frame`, named by the frame's fnum: input_prep every
    frame, i_chain every intra frame, p_chain and hme every P frame."""
    frames, meta = read_y4m(golden.input_path("tiny64x48_420_6f"))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=4),
                           device="cpu")
    kinds = {}
    for fnum, planes in enumerate(frames):
        pic, = [p for p in enc.encode_frame(planes) if p[5] & 0x04]
        kinds[fnum] = "p" if pic[5] & 0x01 else "i"
    assert kinds == dict(enumerate("ipppip"))
    frame_of = {r.id: r.ids["fnum"] for r in trace.records()
                if r.name == "encode_frame"}
    byid = {r.id: r for r in trace.records()}
    got = {}
    for r in _dispatch_spans():
        got.setdefault(r.name[len("encode.dispatch."):], []).append(
            r.ids["fnum"])
        p = r.parent
        while p not in frame_of:
            p = byid[p].parent
        assert frame_of[p] == r.ids["fnum"]
    want_p = [k for k, v in kinds.items() if v == "p"]
    assert got == {"input_prep": list(range(6)), "i_chain": [0, 4],
                   "p_chain": want_p, "hme": want_p}


def test_no_dispatch_span_in_lockstep_or_intra_batch(traced):
    """The batched paths have their own spans: a lockstep run (either
    search backend) and an intra batch run record no `encode.dispatch.*`
    span."""
    from dsv2_tpu_torch.parallel import batch
    for backend in ("gang", "pallas"):
        _lockstep_run(hme_backend=backend)
        assert trace.records() and not _dispatch_spans()
        trace.reset()
    frames, meta = read_y4m(golden.input_path("tiny64x48_420_6f"))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=0),
                           device="cpu")
    batch.encode_intra_batch(enc, frames[:2], chunk=2)
    assert "batch.dispatch" in {r.name for r in trace.records()}
    assert not _dispatch_spans()


def _span_events(fn, tracing):
    """The names of the events of a CPU profile of fn() over every thread
    (trace.all_threads(), as DSV2_XPROF records)."""
    from torch.profiler import ProfilerActivity, profile
    trace.reset()
    trace.enable(tracing)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     **trace.all_threads()) as prof:
            fn()
    finally:
        trace.enable(False)
    return [e.name for e in prof.events()]


def test_spans_on_the_profiler_only_while_tracing():
    def work():
        trace.set_ids(lane=0)
        with trace.stage("port.outer", fnum=3):
            torch.ones(4).sum()
            with trace.stage("port.inner"):
                torch.zeros(2) + 1
    names = _span_events(work, False)
    assert not any(n.startswith("port.") for n in names)
    assert "aten::sum" in names
    names = _span_events(work, True)
    assert names.count("port.outer") == 1 and names.count("port.inner") == 1
    trace.reset()


def test_profiler_sees_every_lockstep_span():
    names = set(_span_events(lambda: _lockstep_run(nframes=2, gop=2),
                             True))
    spans = {r.name for r in trace.records() if r.name != "lockstep.gather"}
    assert spans and spans <= names
    assert "lockstep.gather" not in names   # recorded after the fact
    trace.reset()


def test_wait_helper_records_nothing_on_cpu(traced):
    t = torch.arange(6, dtype=torch.int32)
    assert xfer.host(t).tolist() == list(range(6))
    assert xfer.scalar(t[3:4]) == 3
    assert xfer.finish_d2h(xfer.start_d2h(t)).tolist() == list(range(6))
    assert xfer.put([1, 2], "cpu").tolist() == [1, 2]
    assert trace.records() == [] and trace.counters() == {}


def test_idle_by_span_reads_a_chrome_trace(tmp_path):
    """tools/torch_profile.idle_by_span on a synthetic trace: idle gaps
    inside the job's range, each named by the shortest port span covering
    it over every thread, per thread by that thread's own; the GPU-side
    copies of the spans are not device work."""
    import json
    import torch_profile

    def x(name, cat, ts, dur, tid, pid=1):
        return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid,
                    pid=pid)
    events = [
        x(torch_profile.IDLE_JOB, "user_annotation", 0, 10000, 1),
        x("encode_frame", "user_annotation", 0, 9000, 2),
        x("encode.serialize", "user_annotation", 1000, 1500, 2),
        x("lockstep.flush", "user_annotation", 5000, 3000, 3),
        x("encode.scd", "user_annotation", 4500, 1000, 2),
        x("k1", "kernel", 500, 500, 7, pid=0),       # busy 500-1000
        x("k2", "kernel", 2800, 1200, 7, pid=0),     # busy 2800-4000
        x("k3", "gpu_memcpy", 3500, 1000, 8, pid=0),  # busy to 4500
        x("encode_frame", "gpu_user_annotation", 0, 9000, 7, pid=0),
        x("k4", "kernel", 6000, 3500, 7, pid=0),     # busy 6000-9500
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = torch_profile.idle_by_span(str(path))
    assert got["window_s"] == pytest.approx(0.010)
    assert got["busy_s"] == pytest.approx(0.0057)
    # the head 0-500 and the tail 9500-10000 apart; gaps 1000-2800
    # (encode.serialize covers only 1000-2500: encode_frame) and
    # 4500-6000 (encode.scd ends at 5500, lockstep.flush starts at 5000:
    # encode_frame)
    assert got["head_s"] == pytest.approx(0.0005)
    assert got["tail_s"] == pytest.approx(0.0005)
    # the head (0-500) lies inside encode_frame, the tail (9500-10000)
    # after every port span
    assert got["head_span"] == "encode_frame"
    assert got["tail_span"] == "(no port span)"
    assert got["gaps"] == 2 and got["gap_s"] == pytest.approx(0.0033)
    assert dict(got["by_span"]) == pytest.approx({"encode_frame": 0.0033})
    assert got["gaps_over_1ms"] == 2 and got["gaps_over_1ms_in_no_span"] == 0
    assert set(got["by_thread"]) == {"thread0"}
    assert got["longest"][0] == (pytest.approx(0.0018), "encode_frame")
    # a gap no span covers (9500-12000, after encode_frame's end) is
    # listed by its start and length from the window's (ms)
    events[0] = x(torch_profile.IDLE_JOB, "user_annotation", 0, 20000, 1)
    events.append(x("k5", "kernel", 12000, 100, 7, pid=0))
    path.write_text(json.dumps({"traceEvents": events}))
    got = torch_profile.idle_by_span(str(path))
    assert got["gaps"] == 3 and got["gaps_over_1ms_in_no_span"] == 1
    assert got["bare_over_1ms"] == [(pytest.approx(9.5),
                                     pytest.approx(2.5))]
    assert got["tail_s"] == pytest.approx(0.0079)
