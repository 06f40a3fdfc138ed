"""The live single-stream cell (entries/live_encode.py) on the CPU at a
tiny size, built on the tiny benchmark of conftest.py by files alone: the
result line, the seed, a P picture altered or dropped and the control,
which the check must find; and the readers of its frame split
(frame_spans.py: `encode.dispatch_ms`, `encode.host_ms`) on synthetic
span records."""
import json
import os

import pytest

from codecbench import frame_spans
from codecbench.harness import Bench
from conftest import REPO, make_tiny_root, run_cell

from dsv2_tpu_torch.utils import trace

CELL = "tiny_live"
# 64x48 4:2:0, 6 frames at -gop=4: two GOPs, so an intra picture follows
# P pictures. Control at -qp=5 (the tiny configuration's control_qp). On
# the CPU, seeds 2^31 + 0..7: luma_mse_max 28.6-67.8 sound, 205.9-275.9
# control; the limit lies between, above their geometric mean (118.2)
TRAFFIC = dict(entry="live_encode", frames=6, gop=4, profile_jobs=1)
LIMITS = dict(stream_faults=0, jobs_differing=0, luma_mse_max=120.0)
SPAN_METRICS = {"encode.dispatch_ms", "encode.host_ms"}


@pytest.fixture(scope="module")
def live_root(tmp_path_factory):
    """The tiny benchmark with the live cell added as files and entries:
    its traffic, its limits, the cell, and the cell on every list of cells
    that encode_fps and its per-layer metrics keep."""
    os.environ["DSV2_TORCH_DEVICE"] = "cpu"
    root = make_tiny_root(tmp_path_factory.mktemp("live"))
    d = os.path.join(root, "codecbench")
    with open(os.path.join(d, "traffic", CELL + ".json"), "w") as f:
        json.dump(TRAFFIC, f)
    with open(os.path.join(d, "limits", CELL + ".json"), "w") as f:
        json.dump(LIMITS, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name=CELL, config="tiny420_qp60",
                                   traffic=CELL, chips=1,
                                   why="CPU test cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "encode_fps" or (m.get("moves") == "encode_fps"
                                         and "workloads" in m):
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return root


def test_the_cell_is_found(live_root):
    b = Bench(live_root)
    assert b.traffic(b.cell(CELL)["traffic"]) == TRAFFIC
    assert b.limits(CELL) == LIMITS
    assert SPAN_METRICS <= {m["name"] for m in b.metrics_of(CELL, True)}


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line(live_root, traced):
    rc, res, err = run_cell(live_root, CELL, trace=traced)
    assert rc == 0 and res["correct"] is True and res["failed"] == 0, err
    assert res["checks"]["stream_faults"]["value"] == 0
    assert {k: c["limit"] for k, c in res["checks"].items()} == LIMITS
    assert res["device"]["platform"] == "cpu"
    names = set(res["metrics"])
    if not traced:
        assert names == {"encode_fps", "setup_s"}
    else:
        # the frame split is read; no device number from a CPU run
        assert names == SPAN_METRICS
        assert "busy_s" not in res["device"]
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_same_seed_same_result_other_seed_other_clip(live_root):
    a = run_cell(live_root, CELL, seed=5)[1]["checks"]
    b = run_cell(live_root, CELL, seed=5)[1]["checks"]
    c = run_cell(live_root, CELL, seed=6)[1]["checks"]
    assert a == b and a["luma_mse_max"] != c["luma_mse_max"]


def is_p_picture(pkt):
    t = pkt[5]
    return bool(t & 0x04) and bool(t & 0x01) and not t & 0x10


def test_fault_altered_p_picture(live_root, monkeypatch):
    """One byte of every P picture's packet altered at 30% of its length:
    a token altered where it is produced."""
    from dsv2_tpu_torch.codec.encoder import Encoder
    real = Encoder.encode_frame

    def altered(self, planes):
        out = []
        for pkt in real(self, planes):
            if is_p_picture(pkt) and len(pkt) > 64:
                pkt = bytearray(pkt)
                pkt[len(pkt) * 3 // 10] ^= 0x5A
                pkt = bytes(pkt)
            out.append(pkt)
        return out
    monkeypatch.setattr(Encoder, "encode_frame", altered)
    rc, res, err = run_cell(live_root, CELL)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


def test_fault_p_picture_dropped(live_root, monkeypatch):
    """The packet of the stream's second P picture never made."""
    from dsv2_tpu_torch.codec.encoder import Encoder
    real = Encoder.encode_frame

    def dropped(self, planes):
        pkts = real(self, planes)
        return [p for p in pkts if not (is_p_picture(p)
                                        and self.next_fnum == 3)]
    monkeypatch.setattr(Encoder, "encode_frame", dropped)
    rc, res, err = run_cell(live_root, CELL)
    assert res["correct"] is False
    assert res["checks"]["stream_faults"]["value"] > 0


def test_control_is_not_correct(live_root):
    rc, res, err = run_cell(live_root, CELL, control=1)
    assert rc == 0 and res["correct"] is False, res["checks"]


# -- the frame split on synthetic records ------------------------------------

def span(sid, name, t0_ms, t1_ms, parent=None, **ids):
    s = trace.Span(name, ids)
    s.id, s.parent, s.thread = sid, parent, 1
    s.t0, s.t1 = int(t0_ms * 1e6), int(t1_ms * 1e6)
    return s


# two frames: an intra frame 0-40 ms (input prep 2-6 with no wait, the
# i_chain 10-30 holding a wait 20-25, a wait of its own 32-35) and a P
# frame 50-100 (input prep 50-52, the hme dispatch 55-65 holding a wait
# 60-62, a wait 66-68 outside any dispatch, the p_chain 70-90 holding
# waits 75-80 and 85-86); a wait outside any frame (110-115)
FRAMES = [
    span(2, "encode.dispatch.input_prep", 2, 6, parent=1, fnum=0),
    span(4, "sync", 20, 25, parent=3),
    span(3, "encode.dispatch.i_chain", 10, 30, parent=10, fnum=0),
    span(10, "encode.device_step", 8, 31, parent=1),
    span(5, "sync", 32, 35, parent=11),
    span(11, "encode.fetch", 31, 36, parent=1),
    span(1, "encode_frame", 0, 40, fnum=0),
    span(21, "encode.dispatch.input_prep", 50, 52, parent=20, fnum=1),
    span(23, "sync", 60, 62, parent=22),
    span(22, "encode.dispatch.hme", 55, 65, parent=29, fnum=1),
    span(29, "encode.motion_est", 54, 66, parent=20),
    span(24, "sync", 66, 68, parent=20),
    span(26, "sync", 75, 80, parent=25),
    span(27, "sync", 85, 86, parent=25),
    span(25, "encode.dispatch.p_chain", 70, 90, parent=20, fnum=1),
    span(20, "encode_frame", 50, 100, fnum=1),
    span(30, "sync", 110, 115),
]


def test_split_dispatch_less_its_waits_and_the_tiling():
    parts = frame_spans.split(FRAMES)
    # dispatch: (4 + 20 - 5) + (2 + 10 - 2 + 20 - 6) ms; every wait
    # inside a frame: 5 + 3 + 2 + 2 + 5 + 1; the frames: 40 + 50
    assert parts["dispatch"] == pytest.approx(0.043)
    assert parts["sync"] == pytest.approx(0.018)
    assert parts["frame"] == pytest.approx(0.090)
    assert parts["host"] == pytest.approx(0.029)
    assert parts["host"] + parts["dispatch"] + parts["sync"] == \
        pytest.approx(parts["frame"])


def test_split_none_without_a_dispatch_span():
    recs = [r for r in FRAMES if not r.name.startswith("encode.dispatch.")]
    assert frame_spans.split(recs) is None
    assert frame_spans.split([]) is None


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
    return use


def test_readers_per_frame(records):
    b = Bench(REPO)
    obs = dict(kind="encode", frames=2, spans={})
    records(FRAMES)
    assert b.metric("encode.dispatch_ms").read(obs) == pytest.approx(21.5)
    assert b.metric("encode.host_ms").read(obs) == pytest.approx(14.5)
    records([r for r in FRAMES
             if not r.name.startswith("encode.dispatch.")])
    for name in SPAN_METRICS:
        assert b.metric(name).read(obs) is None
        assert b.metric(name).read(dict(obs, frames=0)) is None


def test_readers_none_on_a_port_without_records(monkeypatch):
    monkeypatch.delattr(trace, "records")
    for name in SPAN_METRICS:
        assert Bench(REPO).metric(name).read(
            dict(kind="encode", frames=4)) is None
