"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny cells added as files alone (a 64x48 configuration, a traffic mix
per entry point, their limits), and the port on the CPU."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# cell -> (traffic, the traffic's parameters, limits, end-to-end metric)
TINY = {
    "tiny_intra": ("tiny_intra", dict(entry="intra_batch", frames=4, gop=0,
                                      chunk=2, profile_jobs=1),
                   dict(stream_faults=0, jobs_differing=0,
                        luma_mse_max=40.0), "encode_fps"),
    "tiny_lockstep": ("tiny_lockstep",
                      dict(entry="lockstep_encode", lanes=2,
                           frames_per_lane=3, gop=3, width=2, groups=1,
                           hme_backend="gang", profile_jobs=1),
                      dict(stream_faults=0, jobs_differing=0,
                           luma_mse_max=120.0), "encode_fps"),
}


def make_tiny_root(dest):
    """A checkout-like root at `dest`: BENCHMARK.json and codecbench/
    copied, and the TINY cells added as new files and entries."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "codecbench"),
                    os.path.join(dest, "codecbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    d = os.path.join(dest, "codecbench")
    with open(os.path.join(d, "configs", "cif420_qp60.json")) as f:
        cfg = json.load(f)
    # at 64x48 the quality -qp=30 sets lies inside the sound runs' spread
    # over a three-frame lane: the tiny cells' control runs at -qp=5 (on
    # the CPU, luma_mse_max 4.8-6.3 / 22.9-66.7 sound, 221-282 / 216-275
    # control, intra / lockstep; the limits above lie between)
    cfg.update(name="tiny420_qp60", width=64, height=48, control_qp=5)
    with open(os.path.join(d, "configs", "tiny420_qp60.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = json.load(f)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for cell, (tname, traffic, limits, e2e) in TINY.items():
        with open(os.path.join(d, "traffic", tname + ".json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(d, "limits", cell + ".json"), "w") as f:
            json.dump(limits, f)
        bench["workloads"].append(dict(name=cell, config="tiny420_qp60",
                                       traffic=tname, chips=1,
                                       why="CPU test cell"))
        for m in metrics.values():
            if m["name"] == e2e or (m.get("moves") == e2e
                                    and "workloads" in m):
                m.setdefault("workloads", [])
                m["workloads"].append(cell)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return str(dest)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    os.environ["DSV2_TORCH_DEVICE"] = "cpu"
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def run_cell(root, cell, seed=2 ** 31 + 11, trace=0, control=0,
             seconds=0.5):
    """One run of `cell` on the CPU (no look for a card): (exit code,
    result dict, standard error)."""
    import io
    from codecbench import harness
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace), "--control",
                      str(control)], root, need_card=False, device="cpu",
                     out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), err.getvalue()
