"""Runs of the harness on the CPU at tiny sizes: the result line, the
refusals (no card, a directory with the benchmark alone), and the
timed path broken underneath, which the check must find."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, TINY, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_result_line(tiny_root, cell):
    rc, res, err = run_cell(tiny_root, cell)
    assert rc == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0, err
    e2e = TINY[cell][3]
    assert set(res["metrics"]) == {e2e, "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert res["device"]["platform"] == "cpu"
    # the numbers compared, each beside its limit, end standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line == "check %s %r limit %r" % (name, c["value"],
                                                 c["limit"])
        assert c["limit"] == TINY[cell][2][name]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_result_line(tiny_root, cell):
    rc, res, err = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and res["correct"] is True, err
    # the span metrics are read; no device number from a CPU run
    assert res["metrics"]
    for name in res["metrics"]:
        assert not name.startswith("device_idle")
        assert not name.endswith("_roofline")
    assert "busy_s" not in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_result_other_seed_other_clip(tiny_root):
    a = run_cell(tiny_root, "tiny_intra", seed=5)[1]["checks"]
    b = run_cell(tiny_root, "tiny_intra", seed=5)[1]["checks"]
    c = run_cell(tiny_root, "tiny_intra", seed=6)[1]["checks"]
    assert a == b and a["luma_mse_max"] != c["luma_mse_max"]


def flip_packets(chunks):
    """Every picture packet with one byte altered at 30% of its length:
    a token altered where it is produced."""
    out = []
    for c in chunks:
        c = bytearray(c)
        if len(c) > 64 and c[5] & 0x04 and not c[5] & 0x10:
            c[len(c) * 3 // 10] ^= 0x5A
        out.append(bytes(c))
    return out


def split_stream(stream):
    from codecbench.reference import check
    return [buf for _, buf in check.packets(stream)[0]]


def test_fault_altered_token_intra(tiny_root, monkeypatch):
    from dsv2_tpu_torch.parallel import batch
    real = batch.encode_intra_batch
    monkeypatch.setattr(batch, "encode_intra_batch",
                        lambda *a, **k: flip_packets(real(*a, **k)))
    rc, res, err = run_cell(tiny_root, "tiny_intra")
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


def test_fault_altered_token_lockstep(tiny_root, monkeypatch):
    from dsv2_tpu_torch.parallel import dynbatch
    real = dynbatch.encode_streams_lockstep
    monkeypatch.setattr(
        dynbatch, "encode_streams_lockstep",
        lambda *a, **k: [b"".join(flip_packets(split_stream(s)))
                         for s in real(*a, **k)])
    rc, res, err = run_cell(tiny_root, "tiny_lockstep")
    assert res["correct"] is False


def test_fault_lane_left_out(tiny_root, monkeypatch):
    """Half of the batch left out: the last lane's stream never made."""
    from dsv2_tpu_torch.parallel import dynbatch
    real = dynbatch.encode_streams_lockstep
    monkeypatch.setattr(dynbatch, "encode_streams_lockstep",
                        lambda *a, **k: real(*a, **k)[:-1])
    rc, res, err = run_cell(tiny_root, "tiny_lockstep")
    assert res["correct"] is False and res["checks"]["stream_faults"][
        "value"] > 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(tiny_root, cell):
    rc, res, err = run_cell(tiny_root, cell, control=1)
    assert rc == 0 and res["correct"] is False, res["checks"]


def test_no_card_no_result():
    """The run looks for a card and finds none here: it fails and
    prints no result, rather than falling back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "codecbench/run.py", "--workload",
                        "fhd_intra_encode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's
    folder: no port to run, no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "codecbench"),
                    tmp_path / "codecbench")
    p = subprocess.run([sys.executable, "codecbench/run.py", "--workload",
                        "cif_lockstep_encode_x8", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_unknown_workload_fails():
    p = subprocess.run([sys.executable, "codecbench/run.py", "--workload",
                        "no_such_cell", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
