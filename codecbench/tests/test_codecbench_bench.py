"""BENCHMARK.json and the files its names point to: every name found by
its file, the contract's shapes, a cell added as files alone, and what
the harness and the reference import."""
import ast
import json
import os
import re
import sys

import pytest

from codecbench import harness
from codecbench.harness import Bench

from conftest import REPO, TINY

BENCH = os.path.join(REPO, "codecbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_loads_by_its_file():
    b = Bench(REPO)
    s = b.spec
    for w in s["workloads"]:
        cell = b.cell(w["name"])
        assert b.config(cell["config"])["name"] == cell["config"]
        traffic = b.traffic(cell["traffic"])
        entry = b.entry(traffic["entry"])
        assert entry.PRODUCES in ("encode", "decode")
        assert hasattr(entry, "Driver")
        assert isinstance(b.limits(w["name"]), dict)
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(b.metric(m["name"]).read)
    for c in s["configs"]:
        path = os.path.join(REPO, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] and cfg["assumed"]
    assert b.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12


def test_contract_shapes():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["codecbench"]
    assert 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in s["configs"]}
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in s["workloads"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in s["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    b = Bench(REPO)
    for w in s["workloads"]:
        reported = {m["name"] for m in b.metrics_of(w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert b.metrics_of(w["name"], True), w["name"]
        for m in b.metrics_of(w["name"], True):
            assert m["moves"] in reported


def test_a_cell_added_as_files_alone_is_found(tiny_root):
    b = Bench(tiny_root)
    for cell, (tname, traffic, limits, e2e) in TINY.items():
        assert b.cell(cell)["config"] == "tiny420_qp60"
        assert b.traffic(tname) == traffic and b.limits(cell) == limits
        assert e2e in {m["name"] for m in b.metrics_of(cell, False)}
    # a per-layer metric added as a file and an entry
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["per_layer"].append(dict(name="tiny.frames", unit="frames",
                               better="higher", source="program_counter",
                               layer="parallel", moves="encode_fps",
                               workloads=["tiny_intra"]))
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    with open(os.path.join(tiny_root, "codecbench", "metrics",
                           "tiny.frames.py"), "w") as f:
        f.write("def read(obs):\n    return obs['frames']\n")
    b = Bench(tiny_root)
    assert "tiny.frames" in {m["name"] for m in
                             b.metrics_of("tiny_intra", True)}
    assert b.metric("tiny.frames").read({"frames": 7}) == 7


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if os.sep + "tests" in d or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
    return out


def test_harness_imports_no_jax_and_no_jax_package():
    for path in sources():
        tops = imported_tops(path)
        assert not tops & set(harness.FORBIDDEN), (path, tops)
    for name, rl in Bench(REPO).rooflines().items():
        assert rl.TARGET[0].split(".")[0] == "dsv2_tpu_torch"


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert tops <= {"struct", "numpy", "os", "multiprocessing",
                        "concurrent", None}, (path, tops)
        assert "dsv2_tpu_torch" not in tops and "torch" not in tops


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "dsv2_tpu_torch_twin",
                        types.ModuleType("dsv2_tpu_torch_twin"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    monkeypatch.delitem(sys.modules, "dsv2_tpu", raising=False)
    for k in [k for k in sys.modules if k.split(".")[0] in
              harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dsv2_tpu.codec",
                        types.ModuleType("dsv2_tpu.codec"))
    assert harness.forbidden_modules() == ["dsv2_tpu"]
