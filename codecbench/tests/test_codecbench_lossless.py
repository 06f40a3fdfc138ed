"""The lossless intra cell (entries/lossless_intra_batch.py, reference/
lossless.py) on the CPU at a tiny size, built on the tiny benchmark of
conftest.py by files alone: the result line, traced and untraced, the
control, a chroma sample changed and a picture packet altered, which the
check must find; and the readers of the scan blob's host fallback."""
import json
import os

import pytest

from codecbench.harness import Bench
from conftest import REPO, make_tiny_root, run_cell

CELL = "tiny_lossless"
# 64x48 4:4:4 at -qp=100, 4 frames in chunks of 2; control at -qp=99
CONFIG = dict(name="tiny444_lossless", width=64, height=48, subsamp="444",
              fps_num=30, fps_den=1, qp=100, control_qp=99)
TRAFFIC = dict(entry="lossless_intra_batch", frames=4, gop=0, chunk=2,
               profile_jobs=1)
LIMITS = dict(stream_faults=0, jobs_differing=0, samples_differing=0)
FALLBACK_METRICS = {"fallback.fetch_ms", "fallback.code_ms",
                    "blob.fallbacks_per_frame"}
# the per-layer metrics BENCHMARK.json lists for the FHD lossless cell
with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELL_METRICS = {m["name"] for m in json.load(_f)["per_layer"]
                    if "fhd444_lossless_intra" in m.get("workloads", ())}


@pytest.fixture(scope="module")
def lossless_root(tmp_path_factory):
    """The tiny benchmark with the lossless cell added as files and
    entries: its configuration, traffic and limits, the cell, and the cell
    on encode_fps's list and on those of the per-layer metrics that list
    the FHD lossless cell."""
    os.environ["DSV2_TORCH_DEVICE"] = "cpu"
    root = make_tiny_root(tmp_path_factory.mktemp("lossless"))
    d = os.path.join(root, "codecbench")
    for kind, name, body in (("configs", CONFIG["name"], CONFIG),
                             ("traffic", CELL, TRAFFIC),
                             ("limits", CELL, LIMITS)):
        with open(os.path.join(d, kind, name + ".json"), "w") as f:
            json.dump(body, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name=CELL, config=CONFIG["name"],
                                   traffic=CELL, chips=1,
                                   why="CPU test cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "encode_fps" or m["name"] in CELL_METRICS:
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return root


def test_the_cell_is_found(lossless_root):
    b = Bench(lossless_root)
    assert b.traffic(b.cell(CELL)["traffic"]) == TRAFFIC
    assert b.limits(CELL) == LIMITS
    assert FALLBACK_METRICS < CELL_METRICS
    assert {m["name"] for m in b.metrics_of(CELL, True)} == CELL_METRICS


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line(lossless_root, traced):
    rc, res, err = run_cell(lossless_root, CELL, trace=traced)
    assert rc == 0 and res["correct"] is True and res["failed"] == 0, err
    assert {k: c["limit"] for k, c in res["checks"].items()} == LIMITS
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert "info luma_mse_max 0.0" in err
    names = set(res["metrics"])
    if not traced:
        assert names == {"encode_fps", "setup_s"}
    else:
        # the clip's luma planes leave the blob: the fallback is read,
        # beside the intra batch's host spans (the card's metrics read
        # nothing on the CPU)
        assert FALLBACK_METRICS | {"batch.host_ms", "enqueue_ms"} <= names
        assert names <= CELL_METRICS
        assert res["metrics"]["blob.fallbacks_per_frame"]["value"] > 0
    for m in res["metrics"].values():
        assert m["value"] >= 0 and m["unit"]
    for name in FALLBACK_METRICS - {"fallback.fetch_ms"}:
        assert name not in names or res["metrics"][name]["value"] > 0


def test_control_is_not_correct(lossless_root):
    rc, res, err = run_cell(lossless_root, CELL, control=1)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["samples_differing"]["value"] > 0
    assert res["checks"]["stream_faults"]["value"] == 0


def test_one_chroma_sample_changed(lossless_root, monkeypatch):
    """Frame 1 encoded with one U sample changed: its picture decodes to
    that frame, one sample away from its source."""
    from dsv2_tpu_torch.parallel import batch
    real = batch.encode_intra_batch

    def changed(enc, frames, chunk=16):
        frames = list(frames)
        y, u, v = frames[1]
        u = u.copy()
        u[5, 7] ^= 1
        frames[1] = (y, u, v)
        return real(enc, frames, chunk=chunk)
    monkeypatch.setattr(batch, "encode_intra_batch", changed)
    rc, res, err = run_cell(lossless_root, CELL)
    assert rc == 0 and res["correct"] is False
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert checks == dict(stream_faults=0, jobs_differing=0,
                          samples_differing=1)


def test_picture_packet_altered(lossless_root, monkeypatch):
    """One byte of every picture packet altered at 30% of its length."""
    from dsv2_tpu_torch.parallel import batch
    real = batch.encode_intra_batch

    def altered(enc, frames, chunk=16):
        out = []
        for pkt in real(enc, frames, chunk=chunk):
            if pkt[5] & 0x04 and not pkt[5] & 0x10 and len(pkt) > 64:
                pkt = bytearray(pkt)
                pkt[len(pkt) * 3 // 10] ^= 0x5A
                pkt = bytes(pkt)
            out.append(pkt)
        return out
    monkeypatch.setattr(batch, "encode_intra_batch", altered)
    rc, res, err = run_cell(lossless_root, CELL)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["stream_faults"]["value"] > 0


# -- the readers of the fallback ---------------------------------------------

def test_readers_per_frame(monkeypatch):
    """The fetch is read less its `sync` child (the wait and the copy),
    the coding whole."""
    from dsv2_tpu_torch.utils import trace
    b = Bench(REPO)
    obs = dict(kind="encode", frames=4,
               spans={"batch.fallback.fetch": (0.008, 4),
                      "batch.fallback.code": (0.060, 4)})
    monkeypatch.setattr(trace, "counters", lambda: {"blob.fallback": 4})
    monkeypatch.setattr(trace, "table", lambda: {
        "batch.fallback.fetch": (0.008, 0.002, 4),
        "sync": (0.006, 0.006, 4)})
    assert b.metric("fallback.fetch_ms").read(obs) == pytest.approx(0.5)
    assert b.metric("fallback.code_ms").read(obs) == pytest.approx(15.0)
    assert b.metric("blob.fallbacks_per_frame").read(obs) == 1.0


def test_readers_none_without_the_fallback(monkeypatch):
    """A port without the spans and the counter, or a run in which no
    plane fell back, reads nothing."""
    from dsv2_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "counters", lambda: {"sync": 3})
    monkeypatch.setattr(trace, "table", lambda: {"sync": (0.1, 0.1, 3)})
    b = Bench(REPO)
    for frames in (4, 0):
        obs = dict(kind="encode", frames=frames, spans={})
        for name in FALLBACK_METRICS:
            assert b.metric(name).read(obs) is None
    monkeypatch.delattr(trace, "counters")
    monkeypatch.delattr(trace, "table")
    for name in ("blob.fallbacks_per_frame", "fallback.fetch_ms"):
        assert b.metric(name).read(dict(kind="encode", frames=4)) is None
