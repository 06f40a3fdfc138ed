"""On the card: each cell's control at the cell's own size must come out
not correct, and a sound job of it correct. Skipped where no card is
visible (decided inside the fixture). Run on the card from the root of
a checkout:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda codecbench/tests/test_codecbench_card.py

(--noconftest keeps the CPU fixtures out; this file needs none.)
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")


def cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def readings(cell, seeds, control_seeds):
    p = subprocess.run([sys.executable, "codecbench/readings.py",
                        "--workload", cell, "--seeds",
                        ",".join(map(str, seeds)), "--control-seeds",
                        ",".join(map(str, control_seeds))],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return [json.loads(x) for x in p.stdout.strip().splitlines()
            if x.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_fails_sound_run_passes(card, cell):
    """The control (the program fed its input with one index fault) on
    three seeds at the cell's own size is not correct; a sound job is."""
    out = readings(cell, [2 ** 31 + 304],
                   [2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303])
    assert [r["control"] for r in out] == [False, True, True, True]
    assert out[0]["correct"] is True, out[0]
    for r in out[1:]:
        assert r["correct"] is False, r
