"""torch port end to end on the CPU: the port's CLI and its batched
encode_intra_batch must produce the golden `dsv2_tpu` streams
(tests/golden/torch_port_streams.json, tools/torch_port_golden.py) for
every fixture, the lossless contract-fallback case included; the two
smallest entries are re-derived live through dsv2_tpu; and both entry
points run with jax unimportable."""
import hashlib
import os
import subprocess
import sys

import pytest

from torch_parity import REPO
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m

GOLD = golden.load()
SMALL = [golden.key(n, q) for n, q in golden.cases()[:2]]
FIXTURE_CASES = [(n, q) for n, q in golden.cases() if n != golden.FHD]


def _check(key, data):
    want = GOLD[key]
    assert len(data) == want["length"], key
    assert hashlib.sha256(data).hexdigest() == want["sha256"], key


@pytest.mark.parametrize("name,qp", FIXTURE_CASES,
                         ids=[golden.key(n, q) for n, q in FIXTURE_CASES])
def test_cli_golden(name, qp, tmp_path):
    from dsv2_tpu_torch.cli import main
    out = tmp_path / "out.dsv"
    assert main(["e", "-y", "-y4m=1", "-qp=%d" % qp, "-gop=0",
                 "-inp=" + golden.input_path(name), "-out=%s" % out]) == 0
    _check(golden.key(name, qp), out.read_bytes())


@pytest.mark.parametrize("name,qp", FIXTURE_CASES,
                         ids=[golden.key(n, q) for n, q in FIXTURE_CASES])
def test_batch_golden(name, qp):
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames, meta, qp, batch=encode_intra_batch,
                         chunk=4, device="cpu")
    _check(golden.key(name, qp), data)


@pytest.mark.parametrize("key", SMALL)
def test_golden_live(key):
    """The golden file is what dsv2_tpu encodes today, and so is the port."""
    from dsv2_tpu import cli as jcli
    from dsv2_tpu_torch import cli
    name, qp = [(n, q) for n, q in golden.cases()
                if golden.key(n, q) == key][0]
    frames, meta = read_y4m(golden.input_path(name))
    want = golden.encode(jcli, frames, meta, qp)
    _check(key, want)
    assert golden.encode(cli, frames, meta, qp, device="cpu") == want


@pytest.mark.slow
def test_golden_live_fhd():
    from dsv2_tpu import cli as jcli
    frames, meta = read_y4m(golden.input_path(golden.FHD))
    _check(golden.key(golden.FHD, 60),
           golden.encode(jcli, frames, meta, 60))


def test_stage_totals():
    """The port's trace module reads and clears the batch stage times."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    from dsv2_tpu_torch.utils import trace
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    trace.reset()
    trace.enable(True)
    try:
        golden.encode(cli, frames, meta, 60, batch=encode_intra_batch,
                      device="cpu")
        got = trace.totals()
    finally:
        trace.enable(False)
    assert {"batch.prep", "batch.dispatch", "batch.fetch",
            "batch.serialize"} <= set(got)
    assert all(t > 0 for t in got.values())
    trace.reset()
    assert trace.totals() == {}


def test_p_frames_raise():
    from dsv2_tpu_torch import cli
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=8),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        enc.encode_frame(frames[0])
    with pytest.raises(NotImplementedError):
        cli.main(["d"])


def test_no_cuda_raises(monkeypatch):
    """DSV2_TORCH_DEVICE defaults to cuda and never falls back silently."""
    import torch
    from dsv2_tpu_torch import default_device
    monkeypatch.setenv("DSV2_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        default_device()
    monkeypatch.setenv("DSV2_TORCH_DEVICE", "cpu")
    assert default_device().type == "cpu"


JAX_FREE = r"""
import importlib.abc, sys
class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked in this process")
sys.meta_path.insert(0, NoJax())
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tools!r})
import torch_port_golden as golden
from dsv2_tpu_torch import cli
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.parallel.batch import encode_intra_batch
name = "nano48x32_420_4f"
assert cli.main(["e", "-y", "-v", "-y4m=1", "-qp=60", "-gop=0",
                 "-inp=" + golden.input_path(name), "-out=" + {out!r}]) == 0
frames, meta = read_y4m(golden.input_path(name))
data = golden.encode(cli, frames, meta, 60, batch=encode_intra_batch)
assert data == open({out!r}, "rb").read()
assert "jax" not in sys.modules and "jaxlib" not in sys.modules
print("JAXFREE", golden.digest(data)["sha256"])
"""


def test_jax_free_subprocess(tmp_path):
    """The GPU machine has no JAX: both entry points run with jax
    unimportable (a subprocess, since this one already imported jax)."""
    out = str(tmp_path / "nano.dsv")
    code = JAX_FREE.format(repo=REPO, tools=os.path.join(REPO, "tools"),
                           out=out)
    env = dict(os.environ, DSV2_TORCH_DEVICE="cpu")
    env.pop("DSV2_XPROF", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "encoded" in res.stderr          # the -v statistics dump
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JAXFREE")]
    assert line == ["JAXFREE " + GOLD[golden.key(
        "nano48x32_420_4f", 60)]["sha256"]]
