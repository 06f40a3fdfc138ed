"""The per-layer metrics that read the port's span tree and counters
(`lockstep.gather_ms`, `enqueue_ms`, `device_wait_ms`,
`host_syncs_per_frame`, `kernels.launches_per_frame`) on synthetic
observations and records: their values, and None where a run has
nothing to read (no card, or a port whose trace module keeps no records
or counters)."""
import collections

import pytest

from codecbench.harness import Bench
from conftest import REPO

from dsv2_tpu_torch.utils import trace

NEW = ("lockstep.gather_ms", "enqueue_ms", "device_wait_ms",
       "host_syncs_per_frame", "kernels.launches_per_frame")


def metric(name):
    return Bench(REPO).metric(name)


def span(sid, name, t0_ms, t1_ms, parent=None, **ids):
    s = trace.Span(name, ids)
    s.id, s.parent, s.thread = sid, parent, 1
    s.t0, s.t1 = int(t0_ms * 1e6), int(t1_ms * 1e6)
    return s


# a lockstep job of 10 frames: gather 0-40 ms, flush 40-100 ms holding a
# p_chain dispatch (40-90 ms) with two waits (50-60, 70-75) and a run
# span with one (90-98); a lane's fetch wait outside the flush (100-103)
LOCKSTEP = [
    span(1, "lockstep.gather", 0, 40, flush=1),
    span(3, "sync", 50, 60, parent=2),
    span(4, "sync", 70, 75, parent=2),
    span(2, "lockstep.dispatch.p_chain", 40, 90, parent=5),
    span(7, "sync", 90, 98, parent=6),
    span(6, "lockstep.run.p_chain", 90, 98, parent=5),
    span(5, "lockstep.flush", 40, 100, parent=8, flush=1, key="p_chain",
         lanes=8),
    span(8, "encode.device_step", 39, 101, lane=0, flush=1),
    span(9, "sync", 100, 103, parent=10),
    span(10, "encode.fetch", 100, 103, lane=1),
]
# an intra job of 4 frames in one thread: two dispatches with a wait each
INTRA = [
    span(2, "sync", 5, 7, parent=1),
    span(1, "batch.dispatch", 0, 10),
    span(4, "sync", 25, 26, parent=3),
    span(3, "batch.fetch", 20, 30),
    span(5, "batch.dispatch", 30, 34),
]
COUNTERS = {"sync": 12, "launch.vk_chain": 3, "launch.hme_gang_level0": 1,
            "launch.wavefront_filter.luma": 2, "lockstep.lanes.p_chain": 8}


def table_of(recs):
    """trace.table() of a window whose spans are `recs`."""
    child = collections.Counter()
    for r in recs:
        if r.parent is not None:
            child[r.parent] += r.t1 - r.t0
    out = collections.defaultdict(lambda: [0, 0, 0])
    for r in recs:
        tot = out[r.name]
        tot[0] += r.t1 - r.t0
        tot[1] += r.t1 - r.t0 - child[r.id]
        tot[2] += 1
    return {k: (s / 1e9, self_s / 1e9, n) for k, (s, self_s, n) in
            out.items()}


@pytest.fixture
def port(monkeypatch):
    """The trace module's accessors read the given records and counters
    (and `table` their sums)."""
    def use(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "table", lambda: table_of(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return use


def obs(frames, card=True, spans=None):
    o = dict(kind="encode", frames=frames, spans=spans or {})
    if card:
        o["busy_s"] = 0.5
    return o


def test_gather_ms_reads_the_gather_span():
    m = metric("lockstep.gather_ms")
    assert m.read(obs(10, spans={"lockstep.gather": (0.040, 1)})) == \
        pytest.approx(4.0)
    assert m.read(obs(10)) is None
    assert m.read(obs(0, spans={"lockstep.gather": (0.040, 1)})) is None


def test_enqueue_ms_is_dispatch_self_time(port):
    port(LOCKSTEP, COUNTERS)
    # the dispatch's 50 ms less its waits' 15 ms, over 10 frames
    assert metric("enqueue_ms").read(obs(10)) == pytest.approx(3.5)
    port(INTRA, COUNTERS)
    # (10 - 2) + 4 ms over 4 frames; batch.fetch is not an enqueue
    assert metric("enqueue_ms").read(obs(4)) == pytest.approx(3.0)
    port([], COUNTERS)
    assert metric("enqueue_ms").read(obs(4)) is None


def test_device_wait_ms_on_the_critical_path(port):
    port(LOCKSTEP, COUNTERS)
    # the three waits inside the flush (10 + 5 + 8 ms), not the lane's
    assert metric("device_wait_ms").read(obs(10)) == pytest.approx(2.3)
    port(INTRA, COUNTERS)
    # no flush: every wait (2 + 1 ms) over 4 frames
    assert metric("device_wait_ms").read(obs(4)) == pytest.approx(0.75)
    port([r for r in INTRA if r.name != "sync"], {})
    assert metric("device_wait_ms").read(obs(4)) == 0.0
    assert metric("device_wait_ms").read(obs(4, card=False)) is None


def test_counter_metrics(port):
    port(LOCKSTEP, COUNTERS)
    assert metric("host_syncs_per_frame").read(obs(4)) == 3.0
    assert metric("kernels.launches_per_frame").read(obs(4)) == 1.5
    port(LOCKSTEP, {})
    assert metric("host_syncs_per_frame").read(obs(4)) == 0.0
    assert metric("kernels.launches_per_frame").read(obs(4)) == 0.0
    for name in ("host_syncs_per_frame", "kernels.launches_per_frame"):
        assert metric(name).read(obs(4, card=False)) is None


def test_a_port_without_records_reads_none(monkeypatch):
    """The parent's trace module has no records, table or counters: every
    new metric that reads them gives None and raises nothing."""
    for attr in ("records", "table", "counters"):
        monkeypatch.delattr(trace, attr)
    for name in NEW[1:]:
        assert metric(name).read(obs(10)) is None


def test_entries_list_their_cells():
    b = Bench(REPO)
    got = {m["name"]: m for m in b.spec["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    assert got["lockstep.gather_ms"]["workloads"] == [
        "cif_lockstep_encode_x8"]
    for name in NEW:
        assert got[name]["moves"] == "encode_fps"
        assert "cif_lockstep_encode_x8" in got[name]["workloads"]
        assert name in {m["name"] for m in
                        b.metrics_of("cif_lockstep_encode_x8", True)}
